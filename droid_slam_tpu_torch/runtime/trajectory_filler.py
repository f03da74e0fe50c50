"""Non-keyframe pose recovery ("trajectory filling").

Non-keyframe frames are processed in batches; each gets an SE3 seed
interpolated between its bracketing keyframes, edges from both brackets,
and six motion-only update+BA rounds.  A stereo stream is filled from its
left images (the filled frames get no stereo edge).
"""

import numpy as np
import torch

from ..lie import se3
from ..models.droidnet import normalize_images
from .factor_graph import FactorGraph


class TrajectoryFiller:
    def __init__(self, net, video, cfg):
        self.net = net
        self.video = video
        self.cfg = cfg
        self.batch = cfg.filler_batch

    def _fill(self, tstamps, images, intrinsics):
        """Fill one batch; returns (M, 7) w2c poses."""
        video = self.video
        dev = video.device
        N = video.counter
        M = len(tstamps)
        st = video.state
        if N + M > st.poses.shape[0]:
            raise ValueError(
                f"trajectory filler needs {N + M} buffer slots (keyframes "
                f"{N} + batch {M}) but buffer={st.poses.shape[0]}; "
                f"increase SLAMConfig.buffer")

        ts = st.tstamp[:N].cpu().numpy()
        tt = np.asarray(tstamps, np.float64)
        t0 = np.asarray([max(int((ts <= t).sum()) - 1, 0) for t in tt],
                        np.int64)
        t1 = np.where(t0 < N - 1, t0 + 1, t0)
        dt = ts[t1] - ts[t0] + 1e-3
        alpha = (tt - ts[t0]) / dt

        Gs = se3.interp(
            st.poses[torch.as_tensor(t0, device=dev)],
            st.poses[torch.as_tensor(t1, device=dev)],
            torch.as_tensor(alpha, dtype=torch.float32, device=dev)[:, None])

        imgs = torch.stack([torch.as_tensor(np.asarray(im))
                            for im in images]).to(dev)
        if imgs.ndim == 5:
            imgs = imgs[:, 0]                     # left camera of a rig
        intr = torch.as_tensor(np.stack([np.asarray(i) for i in intrinsics]),
                               dtype=torch.float32, device=dev)
        fmaps = self.net.fnet(normalize_images(imgs))

        zeros = torch.zeros_like(st.nets[0])
        for k in range(M):
            video.append(float(tt[k]), Gs[k], 1.0, None,
                         intr[k] / 8.0, fmaps[k][None].to(torch.bfloat16),
                         zeros, zeros)

        # a bracketing keyframe can be the source of up to 2·batch edges
        graph = FactorGraph(
            video, self.net, max_factors=4 * self.batch,
            edge_cap=2 * self.batch, inac_cap=8,
            pose_cap=self.batch + 2, depth_cap=3 * self.batch + 4)
        new_ix = np.arange(N, N + M)
        graph.add_factors(t0, new_ix)
        graph.add_factors(t1, new_ix)
        for _ in range(6):
            graph.update(N, N + M, motion_only=True)

        # a copy: on the CPU .numpy() is a view of the slots the next batch
        # overwrites
        poses = st.poses[N:N + M].cpu().numpy().copy()
        video.counter = N
        return poses

    @torch.no_grad()
    def __call__(self, image_stream):
        """image_stream yields (tstamp, image, intrinsics); returns the
        full (w2c) trajectory as an (n, 7) array.  The last partial batch
        is padded with copies of its last frame (GraphAgg averages over
        all edges of a keyframe, so the padding is part of the result)."""
        pose_list = []
        tstamps, images, intrinsics = [], [], []
        for (tstamp, image, intr) in image_stream:
            tstamps.append(tstamp)
            images.append(image)
            intrinsics.append(intr)
            if len(tstamps) == self.batch:
                pose_list.append(self._fill(tstamps, images, intrinsics))
                tstamps, images, intrinsics = [], [], []

        if tstamps:
            n_real = len(tstamps)
            while len(tstamps) < self.batch:
                tstamps.append(tstamps[-1] + 1e-4)
                images.append(images[-1])
                intrinsics.append(intrinsics[-1])
            out = self._fill(tstamps, images, intrinsics)
            pose_list.append(out[:n_real])

        return np.concatenate(pose_list, axis=0)
