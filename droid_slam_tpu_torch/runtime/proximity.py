"""Proximity edge selection with Manhattan NMS (host, numpy).

The policy of the reference's factor graph (and of the JAX package's
native selector and fused frontend):

  * candidate pairs (i, j) with i ∈ [t0, t), j ∈ [t1, t);
  * pairs with i - rad < j, d > 100, or suppressed by existing edges are
    excluded;
  * temporal-radius pairs (and stereo self-pairs) are emitted first;
  * remaining pairs are taken greedily in ascending distance order (a
    stable sort, fixed before the loop) while d ≤ thresh and the emitted
    count has not exceeded the budget, each suppressing a Manhattan ball
    of radius min(|i-j|-2, nms) around it; both directions are emitted.

`max_steps` bounds how many entries of the sorted order are examined
(the fused frontend looks at a fixed number of them).
"""

import numpy as np


def _ball(I, J, i, j, nms):
    """Cells of the (I, J) grid inside edge (i, j)'s suppression ball;
    i, j may be arrays (one ball per edge, combined with any)."""
    i = np.asarray(i).reshape(-1, 1, 1)
    j = np.asarray(j).reshape(-1, 1, 1)
    r = np.clip(np.abs(i - j) - 2, 0, nms)
    return np.any(np.abs(I[None] - i) + np.abs(J[None] - j) <= r, axis=0)


def select_proximity_edges(dist, t0, t1, t, exist_ii, exist_jj, rad, nms,
                           thresh, max_factors, stereo=False,
                           max_steps=None):
    """dist: (t - t0, t - t1) float distances of the candidate grid.
    Returns (ii, jj) int64 arrays in emission order."""
    d = np.array(dist, np.float32)
    I = np.arange(t0, t)[:, None]
    J = np.arange(t1, t)[None, :]
    inf = np.float32(np.inf)
    with np.errstate(invalid="ignore"):
        d[(I - rad < J) | (d > 100.0)] = inf
    if len(exist_ii):
        d[_ball(I, J, exist_ii, exist_jj, nms)] = inf

    out = []
    for i in range(t0, t):
        if stereo:
            out.append((i, i))
            if t1 <= i:
                d[i - t0, i - t1] = inf
        for j in range(max(i - rad - 1, 0), i):
            out += [(i, j), (j, i)]
            if t1 <= j:
                d[i - t0, j - t1] = inf

    nj = d.shape[1]
    order = np.argsort(d, axis=None, kind="stable")
    if max_steps is not None:
        order = order[:max_steps]
    for k in order:
        r, c = divmod(int(k), nj)
        if not d[r, c] <= thresh:        # live value (NaN never taken)
            continue
        if len(out) > max_factors:
            break
        i, j = r + t0, c + t1
        out += [(i, j), (j, i)]
        d[_ball(I, J, i, j, nms)] = inf

    if not out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    e = np.asarray(out, np.int64)
    return e[:, 0], e[:, 1]
