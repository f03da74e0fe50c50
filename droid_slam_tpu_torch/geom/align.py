"""Trajectory alignment and error metrics (numpy).

The evaluation metrics of the JAX package's `geom/align.py`, copied so
the port imports nothing of it: Umeyama similarity alignment, ATE after
alignment (with or without scale), RPE, the KITTI segment-drift metric,
and nearest-timestamp association.

All functions take trajectories as (N, 3) positions or (N, 7) pose
vectors [t, q] and run on the host in float64.
"""

import numpy as np


def _positions(traj):
    traj = np.asarray(traj, np.float64)
    if traj.ndim == 2 and traj.shape[1] >= 3:
        return traj[:, :3]
    raise ValueError(f"expected (N,>=3) trajectory, got {traj.shape}")


def umeyama(src, dst, with_scale=True):
    """Least-squares similarity transform: dst ≈ s·R·src + t.

    Returns (s, R, t).  Classic Umeyama (1991) closed form — the same
    alignment evo and the TartanAir evaluator perform.
    """
    src = _positions(src)
    dst = _positions(dst)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d

    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt

    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(S) @ D) / var_s)
    else:
        s = 1.0

    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(gt, est, correct_scale=True):
    """Absolute trajectory error RMSE after Umeyama alignment.

    Mirrors evo's APE with `align=True, correct_scale=` (test_tum.py:118)
    and tartanair_evaluator.transform_trajs.
    """
    gt_p = _positions(gt)
    est_p = _positions(est)
    assert len(gt_p) == len(est_p), (len(gt_p), len(est_p))
    if not np.isfinite(est_p).all():
        # a diverged run is a (bad) result, not a crash: report inf
        # rather than letting the alignment SVD blow up mid-benchmark
        return float("inf")
    s, R, t = umeyama(est_p, gt_p, with_scale=correct_scale)
    est_aligned = (s * (R @ est_p.T)).T + t
    err = np.linalg.norm(est_aligned - gt_p, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe(gt, est, delta=1):
    """Relative pose error over position deltas (translation part only).

    Returns (rmse_trans,) over frame pairs (i, i+delta).
    """
    gt_p = _positions(gt)
    est_p = _positions(est)
    dg = gt_p[delta:] - gt_p[:-delta]
    de = est_p[delta:] - est_p[:-delta]
    err = np.linalg.norm(dg - de, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def _quat_to_R(q):
    """(N,4) scalar-last quaternions -> (N,3,3) rotation matrices."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(q), 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def se3_matrices(traj):
    """(N,7) [t, q] pose vectors -> (N,4,4) homogeneous matrices."""
    traj = np.asarray(traj, np.float64)
    assert traj.ndim == 2 and traj.shape[1] == 7, traj.shape
    T = np.tile(np.eye(4), (len(traj), 1, 1))
    T[:, :3, :3] = _quat_to_R(traj[:, 3:7])
    T[:, :3, 3] = traj[:, :3]
    return T


def kitti_metric(gt, est, lengths=(5, 10, 15, 20, 25, 30, 35, 40),
                 align=True, correct_scale=True):
    """KITTI odometry segment-drift metric over (N,7) trajectories.

    For every start frame and every segment length L (meters of
    ground-truth path), find the first frame whose cumulative gt path
    length exceeds start+L, form the relative-pose error between the gt
    and estimated segment deltas, and normalize by L.  Per-length means
    are averaged into the headline pair.  Matches the TartanAir protocol
    evaluator (tartanair_evaluator.py:45-70, evaluate_kitti.py:45-107:
    step_size 1, strictly-greater segment end, arccos((tr(R)-1)/2)
    rotation angle),
    which runs the KITTI metric on the ATE-aligned estimate — `align`
    reproduces that with a Umeyama similarity fit (Sim3 when
    `correct_scale`, SE3 otherwise).

    Returns (rot_deg_per_meter, trans_per_meter).
    """
    gt = np.asarray(gt, np.float64)
    est = np.asarray(est, np.float64)
    assert gt.shape == est.shape and gt.shape[1] == 7, (gt.shape, est.shape)
    if not np.isfinite(est).all():
        return float("inf"), float("inf")

    T_gt = se3_matrices(gt)
    T_est = se3_matrices(est)
    if align:
        s, R, t = umeyama(est[:, :3], gt[:, :3], with_scale=correct_scale)
        T_est = T_est.copy()
        T_est[:, :3, 3] *= s
        A = np.eye(4)
        A[:3, :3] = R
        A[:3, 3] = t
        T_est = A[None] @ T_est

    # cumulative ground-truth path length (nondecreasing)
    seg = np.linalg.norm(np.diff(T_gt[:, :3, 3], axis=0), axis=1)
    dist = np.concatenate([[0.0], np.cumsum(seg)])

    inv_gt = np.linalg.inv(T_gt)
    inv_est = np.linalg.inv(T_est)

    rot_by_len, tra_by_len = [], []
    for L in lengths:
        # first index with dist > dist[first] + L, per start frame
        last = np.searchsorted(dist, dist + L, side="right")
        first = np.nonzero(last < len(dist))[0]
        if len(first) == 0:
            continue
        last = last[first]
        d_gt = inv_gt[first] @ T_gt[last]
        d_est = inv_est[first] @ T_est[last]
        err = np.linalg.inv(d_est) @ d_gt
        tr = np.clip((np.trace(err[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                     -1.0, 1.0)
        rot_by_len.append(np.arccos(tr).mean() / L)
        tra_by_len.append(np.linalg.norm(err[:, :3, 3], axis=1).mean() / L)

    if not rot_by_len:
        return float("nan"), float("nan")
    return (float(np.degrees(np.mean(rot_by_len))),
            float(np.mean(tra_by_len)))


def rpe_pose(gt, est, delta=1):
    """Relative pose error over (N,7) trajectories: mean rotation angle
    (rad) and mean translation norm of inv(d_est)·d_gt for frame pairs
    (i, i+delta) — the RPEEvaluator semantics (evaluator_base.py:61-78).
    """
    T_gt = se3_matrices(gt)
    T_est = se3_matrices(est)
    d_gt = np.linalg.inv(T_gt[:-delta]) @ T_gt[delta:]
    d_est = np.linalg.inv(T_est[:-delta]) @ T_est[delta:]
    err = np.linalg.inv(d_est) @ d_gt
    tr = np.clip((np.trace(err[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                 -1.0, 1.0)
    return (float(np.arccos(tr).mean()),
            float(np.linalg.norm(err[:, :3, 3], axis=1).mean()))


def associate(stamps_a, stamps_b, max_dt=0.02):
    """Greedy nearest-timestamp association (TUM rgbd tools semantics,
    reference data_readers/rgbd_utils.py:16-45).

    Returns list of (idx_a, idx_b) matches.
    """
    stamps_a = np.asarray(stamps_a, np.float64)
    stamps_b = np.asarray(stamps_b, np.float64)
    pairs = [
        (abs(a - b), i, j)
        for i, a in enumerate(stamps_a)
        for j, b in enumerate(stamps_b)
        if abs(a - b) < max_dt
    ]
    pairs.sort()
    used_a, used_b, out = set(), set(), []
    for _, i, j in pairs:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            out.append((i, j))
    out.sort()
    return out
