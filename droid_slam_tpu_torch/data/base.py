"""Training dataset base: covisibility-graph frame sampling.

The JAX package's `data/base.py` (`RGBDDataset`) without OpenCV: scene
indices are built once and cached as a pickle; a sample is a random walk
over the flow-covisibility graph bounded by [fmin, fmax], scale-normalised
(mean disparity -> 1).  Samples are numpy arrays: RGB images HWC, the
dataset's poses [t, q] as the scene files give them, disparities,
intrinsics.

Randomness comes from the generators passed in: the walk calls
`rng.choice` where the JAX code calls `np.random.choice`, so a
`np.random.RandomState(s)` here draws the frames that `np.random.seed(s)`
draws there.  The cache file's name holds a hash of the dataset root's
absolute path, so two roots never share one.
"""

import hashlib
import os
import os.path as osp
import pickle

import numpy as np

from .augmentation import augment_sample
from .image_io import imread_rgb
from .rgbd_utils import build_frame_graph_from_files

CACHE_DIR = osp.join(osp.dirname(osp.abspath(__file__)), "cache")


def sample_batches(dataset, batch_size, rng, shuffle=True):
    """Endless stacked batches of `dataset[i]`, in an order (and with
    walks and augmentation) drawn from `rng`."""
    order = np.arange(len(dataset))
    while True:
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            items = [dataset.__getitem__(int(i), rng)
                     for i in order[s:s + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


class RGBDDataset:
    def __init__(self, name, datapath, n_frames=4, crop_size=(384, 512),
                 fmin=8.0, fmax=75.0, do_aug=True, cache_dir=None,
                 device=None):
        self.name = name
        self.root = datapath
        self.n_frames = n_frames
        self.fmin = fmin
        self.fmax = fmax
        self.do_aug = do_aug
        self.crop_size = tuple(crop_size)
        self.device = device

        cache_dir = cache_dir or CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        key = hashlib.sha1(osp.abspath(datapath).encode()).hexdigest()[:16]
        cache_path = osp.join(cache_dir, f"{name}_{key}.pickle")
        if osp.isfile(cache_path):
            with open(cache_path, "rb") as f:
                scene_info = pickle.load(f)[0]
        else:
            scene_info = self._build_dataset()
            with open(cache_path, "wb") as f:
                pickle.dump((scene_info,), f)

        self.scene_info = scene_info
        self._build_dataset_index()

    # -- subclass hooks ----------------------------------------------------

    def _build_dataset(self):
        raise NotImplementedError

    @staticmethod
    def is_test_scene(scene):
        return False

    @staticmethod
    def image_read(image_file):
        return imread_rgb(image_file)

    @staticmethod
    def depth_read(depth_file):
        return np.load(depth_file)

    # ----------------------------------------------------------------------

    def build_frame_graph(self, poses, depths, intrinsics, f=16,
                          max_flow=256):
        """The scene's covisibility graph, its flows computed on the
        dataset's device (the CUDA card unless device="cpu")."""
        from ..runtime.slam import resolve_device

        return build_frame_graph_from_files(
            poses, depths, intrinsics, self.__class__.depth_read,
            f=f, max_flow=max_flow, device=resolve_device(self.device))

    def _build_dataset_index(self):
        self.dataset_index = []
        for scene in self.scene_info:
            if not self.__class__.is_test_scene(scene):
                graph = self.scene_info[scene]["graph"]
                for i in graph:
                    if len(graph[i][0]) > self.n_frames:
                        self.dataset_index.append((scene, i))

    def __len__(self):
        return len(self.dataset_index)

    def frame_indices(self, index, rng):
        """The scene and the frames of sample `index`: a walk from its
        frame to a later one in [fmin, fmax] of flow where there is one,
        else to any there, else staying on the current frame."""
        scene_id, ix = self.dataset_index[index % len(self.dataset_index)]
        graph = self.scene_info[scene_id]["graph"]
        inds = [ix]
        while len(inds) < self.n_frames:
            k = (graph[ix][1] > self.fmin) & (graph[ix][1] < self.fmax)
            frames = graph[ix][0][k]
            if np.count_nonzero(frames[frames > ix]):
                ix = rng.choice(frames[frames > ix])
            elif np.count_nonzero(frames):
                ix = rng.choice(frames)
            inds.append(ix)
        return scene_id, inds

    def __getitem__(self, index, rng=None):
        """dict(images (N, H, W, 3) f32 RGB, poses (N, 7), disps (N, H, W)
        f32, intrinsics (N, 4)); the walk and the augmentation draw from
        `rng` (a fresh unseeded generator without one)."""
        rng = np.random.default_rng() if rng is None else rng
        scene_id, inds = self.frame_indices(index, rng)
        info = self.scene_info[scene_id]

        images = np.stack(
            [self.__class__.image_read(info["images"][i]) for i in inds]
        ).astype(np.float32)
        depths = np.stack(
            [self.__class__.depth_read(info["depths"][i]) for i in inds]
        ).astype(np.float32)
        poses = np.stack([info["poses"][i] for i in inds]).astype(np.float32)
        intrinsics = np.stack(
            [info["intrinsics"][i] for i in inds]).astype(np.float32)

        disps = 1.0 / depths

        if self.do_aug:
            images, poses, disps, intrinsics = augment_sample(
                images, poses, disps, intrinsics, self.crop_size, rng)

        # scale normalisation: mean disparity 1
        valid = disps > 0.01
        if valid.any():
            s = disps[valid].mean()
            disps = disps / s
            poses = poses.copy()
            poses[..., :3] *= s

        return dict(images=images, poses=poses, disps=disps,
                    intrinsics=intrinsics)

    def sample_batches(self, batch_size, rng, shuffle=True):
        """Endless stacked batches drawn with `rng` (a np.random
        Generator or RandomState)."""
        return sample_batches(self, batch_size, rng, shuffle)
