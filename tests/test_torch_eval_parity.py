"""The port's evaluation CLI against the reference's scripts, protocol by
protocol (ROADMAP C9): `python -m droid_slam_tpu_torch.evaluate
{tum,euroc,eth3d,tartanair}` against `evaluation_scripts/test_tum.py`,
`test_euroc.py` (stereo and mono), `test_eth3d.py` and
`validate_tartanair.py`, run as subprocesses with JAX on the CPU, on the
same data with the same dry-run overrides (stride 1, 96x128, buffer 32,
warmup 5, filter 0, backend steps 2 2, the shipped weights).

Here both sides' Droid is replaced by a recorder that returns one seeded
trajectory, so only the protocol runs: the configuration each builds
(equal), the frames it tracks and fills (timestamps and intrinsics to
1e-6 of their value, images within 2 grey levels: OpenCV's fixed-point
resize and remaps against the port's float ones, twice for TUM's
undistort-resize-crop-resize), the depths (exact), and the printed error
lines, which must be identical: association, the EuRoC 1.10 position
scale, scale correction in each mode, the TartanAir NED permutation and
the metrics.  tests/test_torch_eval_live_*.py run the real trajectories.
"""

import numpy as np
import pytest
from torch_port_common import (eval_protocols, run_port_eval,
                               run_reference_eval)

MODES = ["tum", "euroc_stereo", "euroc_mono", "eth3d", "tartanair"]


@pytest.fixture(scope="module")
def protocols(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    return tmp, eval_protocols(tmp)


def _trajectory(n, seed):
    """A seeded camera walk: (n, 7) c2w poses [t, q], unit quaternions."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(0.05 * rng.standard_normal((n, 3)), axis=0)
    q = np.concatenate([0.05 * rng.standard_normal((n, 3)), np.ones((n, 1))],
                       axis=1)
    return np.concatenate([t, q / np.linalg.norm(q, axis=1, keepdims=True)],
                          axis=1)


def error_lines(lines):
    return [ln.strip() for ln in lines if "=" in ln]


@pytest.mark.parametrize("mode", MODES)
def test_protocol_matches_the_reference(protocols, mode):
    tmp, table = protocols
    script, ref_argv, preset, over, size, port_argv = table[mode]
    traj = _trajectory(64, seed=MODES.index(mode))
    ref_lines, ref = run_reference_eval(tmp, script, ref_argv, preset, over,
                                        replay=traj, stream_size=size)
    port_lines, port = run_port_eval(port_argv, replay=traj)

    for k, v in port["cfg"].items():
        assert tuple(np.atleast_1d(ref["cfg"][k])) == tuple(
            np.atleast_1d(v)), k

    assert len(port["track"]) == len(ref["track"]) > 0
    for (tp, ip, dp, kp), (tr, ir, dr, kr) in zip(port["track"],
                                                   ref["track"]):
        assert tp == tr
        np.testing.assert_allclose(kp, kr, rtol=1e-6)
        assert ip.shape == ir.shape and ip.dtype == ir.dtype
        assert np.abs(ip.astype(int) - ir).max() <= 2, (tp, mode)
        if dr is None:
            assert dp is None
        else:
            np.testing.assert_array_equal(dp, dr)
    assert [f[0] for f in port["fill"]] == [f[0] for f in ref["fill"]]
    for (_, kp), (_, kr) in zip(port["fill"], ref["fill"]):
        np.testing.assert_allclose(kp, kr, rtol=1e-6)

    assert error_lines(port_lines) == error_lines(ref_lines)
    assert len(error_lines(ref_lines)) == (2 if mode == "euroc_stereo"
                                           else 1)
