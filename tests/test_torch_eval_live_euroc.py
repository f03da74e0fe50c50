"""The EuRoC (mono) evaluation protocol run for real by both packages on the
same data with the same dry-run overrides (ROADMAP C9): the port's `python
-m droid_slam_tpu_torch.evaluate` against the reference's script in a
subprocess with JAX on the CPU.  Tolerance: C1's live bound, 0.05, on every
pose component and on every printed error; the same poses scored.  Stereo
runs only in the protocol check (tests/test_torch_eval_parity.py): the tiny
EuRoC set holds the same image for both cameras, so its stereo depth is
degenerate and the two packages' live runs part by up to 0.1 there.  One
file per protocol: each JAX run pays its own compiles, and the files run on
separate workers.
"""

from torch_port_common import check_live_eval


def test_euroc_live_matches_the_reference(tmp_path):
    check_live_eval(tmp_path, "euroc_mono")
