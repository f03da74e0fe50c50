"""Map export: multi-view depth filtering, back-projection, PLY files.

The JAX package's `runtime/visualization.py` (`depth_filter`,
`iproj_points`, `export_point_cloud`) in plain PyTorch on the Droid's
device: each keyframe's inverse depths are checked against its six
temporal neighbours, the consistent pixels are back-projected to world
points (`filtered_map`, which the live viewer serves too), and the point
cloud is written as an ASCII PLY file coloured from the keyframes'
images.
"""

import torch

from ..geom import projective
from ..lie import se3, so3

# temporal neighbours a keyframe's depths are checked against
_OFFSETS = (-1, -2, -3, 1, 2, 3)


def depth_filter(poses, disps, intrinsics, inds, thresh):
    """Count the neighbour keyframes that agree with each pixel's depth.

    Each pixel of frame inds[k] is projected into the frames
    inds[k] + o, o in (-1, -2, -3, 1, 2, 3), that lie in the buffer; a
    neighbour agrees when any of the 4 target pixels around the projection
    has |1/d_proj - 1/d_neighbour| < thresh[k].

    Args:
      poses: (BUF, 7) w2c; disps: (BUF, h, w); intrinsics: (4,);
      inds: (K,) frame indices; thresh: (K,) per-frame thresholds.
    Returns (K, h, w) float32 agreement counts.
    """
    num, ht, wd = disps.shape
    inds = torch.as_tensor(inds, device=disps.device).long()
    thresh = torch.as_tensor(thresh, dtype=disps.dtype,
                             device=disps.device)[:, None, None]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    X0 = projective.iproj(disps[inds], intrinsics)           # (K, h, w, 4)
    counts = torch.zeros((len(inds), ht, wd), device=disps.device)
    for o in _OFFSETS:
        jx = inds + o
        valid = (jx >= 0) & (jx < num)
        jc = jx.clamp(0, num - 1)
        gij = se3.mul(poses[jc], se3.inv(poses[inds]))
        X1 = se3.act(gij[:, None, None], X0)
        uj = fx * (X1[..., 0] / X1[..., 2]) + cx
        vj = fy * (X1[..., 1] / X1[..., 2]) + cy
        dj = X1[..., 3] / X1[..., 2]
        # clamped before the integer conversion: far projections and
        # infinities stay out of bounds
        u0 = torch.floor(uj).clamp(-1e9, 1e9).long()
        v0 = torch.floor(vj).clamp(-1e9, 1e9).long()
        inb = (u0 >= 0) & (v0 >= 0) & (u0 < wd - 1) & (v0 < ht - 1)
        u0, v0 = u0.clamp(0, wd - 2), v0.clamp(0, ht - 2)
        dn = disps[jc].reshape(len(inds), -1)
        inv_dj = 1.0 / dj.clamp(min=1e-8)
        agree = torch.zeros_like(inb)
        for dv in (0, 1):
            for du in (0, 1):
                idx = ((v0 + dv) * wd + (u0 + du)).reshape(len(inds), -1)
                dc = torch.gather(dn, 1, idx).reshape(uj.shape)
                agree |= (inv_dj - 1.0 / dc.clamp(min=1e-8)).abs() < thresh
        counts += (agree & inb & valid[:, None, None]).float()
    return counts


def iproj_points(poses_c2w, disps, intrinsics):
    """Back-project keyframe pixels to world points: poses_c2w (K, 7),
    disps (K, h, w), intrinsics (4,) -> (K, h, w, 3)."""
    X0 = projective.iproj(disps, intrinsics.expand(disps.shape[0], 4))
    Xv = X0[..., :3] / torch.clamp(X0[..., 3:4], min=1e-8)
    g = poses_c2w[:, None, None]
    return so3.act(se3.q(g), Xv) + se3.t(g)


@torch.no_grad()
def filtered_map(video, filter_thresh=0.005, min_count=2):
    """The filtered keyframe map as numpy: world points (N, 3) f32, their
    colours (N, 3) uint8 and the keyframes' c2w poses (t, 7) f32.  A
    pixel is kept when at least `min_count` neighbours agree with it
    (threshold `filter_thresh` times the frame's mean disparity) and its
    disparity is above half the frame's mean."""
    t = video.counter
    st = video.state
    disps = st.disps[:t]
    mean = disps.mean(dim=(1, 2))
    count = depth_filter(st.poses, st.disps, st.intrinsics[0],
                         torch.arange(t, device=disps.device),
                         filter_thresh * mean)
    masks = (count >= min_count) & (disps > 0.5 * mean[:, None, None])
    poses_c2w = se3.inv(st.poses[:t])
    pts = iproj_points(poses_c2w, disps, st.intrinsics[0])
    return (pts[masks].float().cpu().numpy(),
            st.colors[:t][masks].cpu().numpy(),
            poses_c2w.float().cpu().numpy())


def export_point_cloud(video, path, filter_thresh=0.005, min_count=2):
    """Write the filtered keyframe map (`filtered_map`) as a coloured
    ASCII PLY file and return its point count."""
    pts_sel, clr_sel, _ = filtered_map(video, filter_thresh, min_count)

    lines = [f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
             f"{int(c[0])} {int(c[1])} {int(c[2])}\n"
             for p, c in zip(pts_sel, clr_sel)]
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts_sel)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        f.writelines(lines)
    return len(pts_sel)
