"""The port's command-line entry points on the CPU: the demo
(`python -m droid_slam_tpu_torch.demo`) and the evaluation
(`python -m droid_slam_tpu_torch.evaluate`).

The demo reads tests/fixtures/tiny_seq through its own PNG stream at its
stored 96x128 (`--target_area 12288`) and must write exactly the
trajectory that the port's `Droid` gives on the same frames read by
OpenCV, with the same configuration (tolerance 0: one thread, where every
run of the port is identical, and the PNG decode is exact).  The TUM
evaluation must print a finite ATE over tum_tiny's 10 poses.  Both refuse
to run without a card unless given `--device cpu`.
"""

import re

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch import demo, evaluate
from torch_port_common import FIX, ROOT, WEIGHTS, tiny_seq

TUM = f"{ROOT}/tests/fixtures/tum_tiny"
DEMO_ARGS = ["--imagedir", FIX, "--calib", f"{FIX}/calib.txt",
             "--target_area", "12288", "--weights", WEIGHTS,
             "--buffer", "32", "--warmup", "5", "--filter_thresh", "0",
             "--backend_steps", "2", "2"]


@pytest.fixture()
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_demo_writes_the_droid_trajectory(tmp_path, one_thread, capsys):
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.runtime.slam import Droid

    out = tmp_path / "traj.txt"
    ply = tmp_path / "map.ply"
    assert demo.main(DEMO_ARGS + ["--device", "cpu", "--output", str(out),
                                  "--export_ply", str(ply)]) == 0
    summary = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"keyframes"' in summary and '"device": "cpu"' in summary

    imgs, intr = tiny_seq()
    droid = Droid(SLAMConfig(image_size=(96, 128), buffer=32, warmup=5,
                             filter_thresh=0.0), weights_path=WEIGHTS,
                  device="cpu")
    for k, im in enumerate(imgs):
        droid.track(k, im, intrinsics=intr)
    traj = droid.terminate(((k, im, intr) for k, im in enumerate(imgs)),
                           backend_steps=(2, 2))
    want = tmp_path / "want.txt"
    np.savetxt(want, np.column_stack([np.arange(len(imgs)), traj]),
               fmt="%.6f")
    assert out.read_text() == want.read_text()
    got = np.loadtxt(out)
    assert got.shape == (12, 8)
    np.testing.assert_allclose(np.linalg.norm(got[:, 4:], axis=1), 1,
                               atol=1e-5)
    assert int(ply.read_text().splitlines()[2].split()[-1]) > 0


def test_evaluate_tum_prints_finite_ate(one_thread, capsys):
    evaluate.main(["tum", "--datapath", TUM, "--weights", WEIGHTS,
                   "--device", "cpu", "--stride", "1", "--image_size", "96",
                   "128", "--buffer", "32", "--warmup", "5",
                   "--filter_thresh", "0", "--backend_steps", "2", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.search(r"ATE RMSE \(Sim3-aligned\) = (\S+) m over (\d+) poses",
                  line)
    assert m, line
    assert np.isfinite(float(m.group(1))) and int(m.group(2)) == 10


def _write_dataset(root, protocol, n=8, H=96, W=128):
    """A tiny dataset in `protocol`'s layout from the port's box scene
    (PNG through the port's encoder); returns the extra CLI arguments."""
    from droid_slam_tpu_torch.data.image_io import write_png
    from droid_slam_tpu_torch.data.synthetic import render_box_scene

    sc = render_box_scene(n, H, W, seed=6, motion_scale=0.12)
    ts = 100.0 + 0.05 * np.arange(n)
    gt = np.column_stack([ts, sc["poses_c2w"]])
    if protocol == "eth3d":
        (root / "rgb").mkdir()
        (root / "depth").mkdir()
        with open(root / "rgb.txt", "w") as fr, \
                open(root / "depth.txt", "w") as fd:
            for k, t in enumerate(ts):
                write_png(str(root / f"rgb/{t:.6f}.png"), sc["images"][k])
                write_png(str(root / f"depth/{t:.6f}.png"),
                          (sc["depths"][k] * 5000).astype(np.uint16))
                fr.write(f"{t:.6f} rgb/{t:.6f}.png\n")
                fd.write(f"{t:.6f} depth/{t:.6f}.png\n")
        np.savetxt(root / "calibration.txt", sc["intrinsics"][0])
        np.savetxt(root / "groundtruth.txt", gt)
        return ["--stride", "1"]
    if protocol == "euroc":
        for cam in ("cam0", "cam1"):
            d = root / "mav0" / cam / "data"
            d.mkdir(parents=True)
            for k, t in enumerate(ts):
                write_png(str(d / f"{int(t * 1e9)}.png"), sc["images"][k])
        np.savetxt(root / "gt.txt", gt, delimiter=" ")
        return ["--gt", str(root / "gt.txt"), "--stereo", "--stride", "1",
                "--image_size", str(H), str(W)]
    (root / "image_left").mkdir()
    for k in range(n):
        write_png(str(root / f"image_left/{k:06d}.png"), sc["images"][k])
    ned = sc["poses_c2w"][:, [2, 0, 1, 5, 3, 4, 6]]   # inverse permutation
    np.savetxt(root / "pose_left.txt", ned, delimiter=" ")
    return ["--image_size", str(H), str(W)]


@pytest.mark.parametrize("protocol", ["euroc", "eth3d", "tartanair"])
def test_evaluate_other_protocols_print_finite_errors(tmp_path, one_thread,
                                                      capsys, protocol):
    """EuRoC stereo, ETH3D RGB-D and TartanAir on tiny datasets written in
    their layouts: each runs its stream, tracks, terminates and prints
    finite errors over every frame (the KITTI drift pair is NaN: the
    path is shorter than its shortest segment, 5 m)."""
    args = _write_dataset(tmp_path, protocol)
    evaluate.main([protocol, "--datapath", str(tmp_path), "--weights",
                   WEIGHTS, "--device", "cpu", "--buffer", "32",
                   "--warmup", "5", "--filter_thresh", "0",
                   "--backend_steps", "2", "2", *args])
    out = capsys.readouterr().out
    nums = [float(x) for x in re.findall(r"(?:ATE[^=]*|RPE\(t\)) = (\S+)",
                                         out)]
    assert len(nums) == (1 if protocol == "eth3d" else 2), out
    assert np.all(np.isfinite(nums)), out
    assert re.search(r"over 8 poses", out), out


def test_entry_points_need_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(DEMO_ARGS + ["--output", "/dev/null"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.main(["tum", "--datapath", TUM])
