"""The live map viewer of the PyTorch port (runtime/viewer.py) against the
JAX package's, and the port's instrumentation (utils/timers.py,
utils/mem.py) on the CPU.

The same keyframe state (the port's box scene, 4 of 8 buffer slots
written, perturbed inverse depths) goes to both packages' `map_snapshot`:
the points agree to 1e-5 (f32 back-projection in another order), the
colours and counts exactly.  The server serves the page and a `/map.bin`
that decodes to the port's snapshot (tests/test_visualization.py:73
holds the JAX one).
"""

import json
import time
import types
import urllib.request

import jax.numpy as jnp
import numpy as np
import torch

from droid_slam_tpu.runtime import viewer as jviewer
from droid_slam_tpu_torch.lie import se3 as tse3
from droid_slam_tpu_torch.runtime import viewer as tviewer
from droid_slam_tpu_torch.utils import mem, timers

BUF, N, H, W = 8, 4, 64, 96


def _videos():
    from droid_slam_tpu_torch.data.synthetic import render_box_scene

    sc = render_box_scene(N, H, W, seed=7, motion_scale=0.1)
    rng = np.random.default_rng(1)
    poses = np.tile(np.float32([0, 0, 0, 0, 0, 0, 1]), (BUF, 1))
    poses[:N] = tse3.inv(torch.from_numpy(sc["poses_c2w"])).numpy()
    disps = np.ones((BUF, H // 8, W // 8), np.float32)
    disps[:N] = 1.0 / sc["depths"][:, 3::8, 3::8]
    disps[:N] *= rng.uniform(0.99, 1.01, disps[:N].shape).astype(np.float32)
    intr = np.tile((sc["intrinsics"][0] / 8.0).astype(np.float32), (BUF, 1))
    images = np.zeros((BUF, H, W, 3), np.uint8)
    images[:N] = sc["images"]
    jvideo = types.SimpleNamespace(counter=N, state=types.SimpleNamespace(
        poses=jnp.asarray(poses), disps=jnp.asarray(disps),
        intrinsics=jnp.asarray(intr), images=jnp.asarray(images)))
    tvideo = types.SimpleNamespace(counter=N, state=types.SimpleNamespace(
        poses=torch.from_numpy(poses), disps=torch.from_numpy(disps),
        intrinsics=torch.from_numpy(intr),
        colors=torch.from_numpy(np.ascontiguousarray(images[:, 3::8,
                                                            3::8]))))
    return jvideo, tvideo


def test_map_snapshot_matches_jax():
    jvideo, tvideo = _videos()
    kw = dict(filter_thresh=0.02, min_count=1)
    jp, jc, jcam = jviewer.map_snapshot(jvideo, **kw)
    tp, tc, tcam = tviewer.map_snapshot(tvideo, **kw)
    assert 0 < len(tp) == len(jp) < N * (H // 8) * (W // 8)
    assert tp.dtype == np.float32 and tc.dtype == np.uint8
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tcam, jcam, atol=1e-6)
    empty = types.SimpleNamespace(counter=0, state=tvideo.state)
    assert [a.shape for a in tviewer.map_snapshot(empty)] == [
        (0, 3), (0, 3), (0, 7)]


def test_viewer_serves_page_and_map():
    _, tvideo = _videos()
    kw = dict(filter_thresh=0.02, min_count=1)
    viewer = tviewer.start_viewer(tvideo, port=0, **kw)
    try:
        base = f"http://127.0.0.1:{viewer.port}"
        page = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"<html" in page and b"map.bin" in page
        raw = urllib.request.urlopen(f"{base}/map.bin", timeout=30).read()
        pts, col, cams = tviewer.decode_map(raw)
        want = tviewer.map_snapshot(tvideo, **kw)
        assert len(cams) == N and len(pts) > 0
        for got, w in zip((pts, col, cams), want):
            np.testing.assert_array_equal(got, w)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats",
                                                  timeout=30).read())
        assert stats == {"points": len(pts), "keyframes": N}
    finally:
        viewer.close()
    assert not viewer.thread.is_alive()


def test_phase_timers():
    t = timers.PhaseTimers()
    for dt in (0.02, 0.001, 0.001, 0.001):
        with t.phase("a"):
            time.sleep(dt)
    with t.phase("b"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 4 and s["b"]["count"] == 1
    assert s["a"]["first_ms"] >= 20.0 and s["a"]["max_ms"] >= 20.0
    assert s["a"]["warm_ms"] < 15.0        # median: the first is an outlier
    assert abs(s["a"]["total_s"] - 1e-3 * s["a"]["mean_ms"] * 4) < 1e-9
    report = t.report()
    assert "not device time" in report and "\na " in report
    t.reset()
    assert t.summary() == {}


def test_device_mem_stats_on_the_cpu(monkeypatch, capsys):
    assert mem.device_mem_stats("cpu") == (None, None, None)
    monkeypatch.delenv("DROID_MEM_LOG", raising=False)
    mem.log_mem("quiet", "cpu")
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("DROID_MEM_LOG", "1")
    mem.log_mem("tag", "cpu")
    assert "[mem] tag: in_use=? GB" in capsys.readouterr().err


def test_torch_trace_writes_a_trace(tmp_path):
    with timers.torch_trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").is_file()
    assert len(prof.key_averages()) > 0
