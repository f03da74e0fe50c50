"""The port's accuracy harness, `python -m droid_slam_tpu_torch.evaluate
synthetic`, against the reference's `evaluation_scripts/eval_synthetic.py`
(run as a subprocess with JAX on the CPU) on one held-out box scene at
64x96 with the shipped weights, f32 network on both sides: the same
scene (the printed trajectory span equal), the same keyframe count, the
ATE within C1's live bound (0.05), and the same printed lines but for
their numbers.
"""

import os
import os.path as osp
import re
import subprocess
import sys

import numpy as np
import torch
from torch_port_common import LIVE_POSE_TOL, ROOT, WEIGHTS

ARGS = ["--seeds", "11", "--size", "64", "96", "--dtype", "float32"]
SCENE_LINE = re.compile(r"seed (\d+): ATE = (\S+) m \(trajectory span (\S+) "
                        r"m, (\d+) keyframes\)")


def _shape(lines):
    return [re.sub(r"[-\d.]+", "#", ln) for ln in lines
            if "ATE" in ln or "median" in ln]


def test_synthetic_harness_matches_the_reference(tmp_path, capsys):
    from droid_slam_tpu_torch import evaluate

    res = subprocess.run(
        [sys.executable, osp.join(ROOT, "evaluation_scripts",
                                  "eval_synthetic.py"),
         "--ckpt", WEIGHTS, "--cpu", *ARGS], capture_output=True,
        text=True, timeout=900, cwd=str(tmp_path),
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    ref = res.stdout.strip().splitlines()

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        evaluate.main(["synthetic", "--weights", WEIGHTS, "--device", "cpu",
                       *ARGS])
    finally:
        torch.set_num_threads(n)
    got = capsys.readouterr().out.strip().splitlines()

    assert _shape(got) == _shape(ref)
    (g,), (r,) = ([SCENE_LINE.search(ln).groups() for ln in lines
                   if SCENE_LINE.search(ln)] for lines in (got, ref))
    assert g[0] == r[0] == "11"
    assert g[2] == r[2] and g[3] == r[3], (got, ref)
    assert np.isfinite(float(g[1]))
    assert abs(float(g[1]) - float(r[1])) <= LIVE_POSE_TOL, (got, ref)
