"""The TUM evaluation protocol run for real by both packages on the same data
with the same dry-run overrides (ROADMAP C9): the port's `python -m
droid_slam_tpu_torch.evaluate` against the reference's script in a
subprocess with JAX on the CPU.  Tolerance: C1's live bound, 0.05, on every
pose component and on every printed error; the same poses scored.  One file
per protocol: each JAX run pays its own compiles, and the files run on
separate workers.
"""

from torch_port_common import check_live_eval


def test_tum_live_matches_the_reference(tmp_path):
    check_live_eval(tmp_path, "tum")
