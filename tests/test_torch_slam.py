"""`Droid` of the PyTorch port vs the JAX package's, live, end to end, on
tests/fixtures/tiny_seq (12 frames, 96×128, f32 network, warmup 5,
shipped weights), through track → terminate(stream, backend_steps=(2, 2)).

Keyframe count and timestamps must be equal.  Poses are bounded by how far
each package's own live run moves under f32-sized changes, measured on a
CPU by tests/torch_live_sensitivity.py (intrinsics scaled by 1 ± 1e-7 and
1 ± 1e-6, and dense BA run in float64; the port on one thread, as here):
  * keyframe poses after tracking: the JAX package moves by up to 0.0255,
    the port by up to 0.0094; bound 0.05, twice the larger spread, since
    each package's run can sit anywhere in its own spread (the two
    baselines differ by 0.0244).
  * the filled trajectory, every frame but 5: the JAX package moves by up
    to 0.0458, the port by up to 0.0354; bound 0.1, twice the larger
    spread (baselines: at most 0.0546 apart).
  * frame 5 (filled by motion-only BA between keyframes 3 and 8) has two
    outcomes about 0.42 apart, and each package flips between them under
    these changes (JAX 0.4215, port 0.4196); the port's baseline lands on
    the other one than the JAX package's.  Bound 0.5 (baselines: 0.406 apart).
The JAX filler, run on the port's own post-BA state, reproduces the
port's fill to 1e-4, which this test checks too.  Every stage started
from the JAX state agrees tightly: the boot rounds
(tests/test_torch_boot.py), each keyframe step, the global-BA passes and
the trajectory fill (tests/test_torch_runtime.py, staged parity).
The JAX one-hot lookup is patched to widen its bf16 volume to f32, which
is what the TPU kernel and the port compute.
"""

import numpy as np
import pytest
import torch
from torch_port_common import TINY, WEIGHTS, tiny_seq, widen_onehot

_FIELDS = ("tstamp", "poses", "disps", "disps_sens", "intrinsics", "fmaps",
           "nets", "inps", "damping")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU result depends on the thread count (reductions and
    MKL products split their sums by thread, and MKL may change its count
    at run time), and the live loop amplifies that to ~0.01.  On one
    thread every run of the port is identical."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keyframes(droid):
    """(count, timestamps, poses) of the keyframe map, copied to numpy
    (terminate later updates the port's buffers in place)."""
    n = droid.video.counter
    st = droid.video.state
    return n, np.array(st.tstamp[:n]), np.array(st.poses[:n])


def _stream(imgs, intr):
    return ((float(k), im, intr) for k, im in enumerate(imgs))


@pytest.fixture(scope="module")
def port_run():
    """The port tracked frame by frame and terminated.  Returns the
    keyframes after tracking, the trajectory, and the state the filler
    started from with the filler's own (w2c) output."""
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.runtime.slam import Droid

    imgs, intr = tiny_seq()
    d = Droid(SLAMConfig(**TINY), weights_path=WEIGHTS, device="cpu")
    for k, im in enumerate(imgs):
        d.track(float(k), im, intrinsics=intr)
    keyframes = _keyframes(d)

    filler, fill = d.traj_filler, {}

    def snapshot_and_fill(stream):
        fill["state"] = {f: getattr(d.video.state, f).float().numpy().copy()
                         for f in _FIELDS}
        fill["counter"] = d.video.counter
        fill["w2c"] = filler(stream)
        return fill["w2c"]

    d.traj_filler = snapshot_and_fill
    traj = d.terminate(_stream(imgs, intr), backend_steps=(2, 2))
    return keyframes, traj, fill


def test_droid_matches_jax(monkeypatch, port_run):
    widen_onehot(monkeypatch)
    import jax.numpy as jnp

    from droid_slam_tpu.config import SLAMConfig
    from droid_slam_tpu.runtime.slam import Droid

    imgs, intr = tiny_seq()
    jd = Droid(SLAMConfig(**TINY), weights_path=WEIGHTS)
    for k, im in enumerate(imgs):
        jd.track(float(k), im, intrinsics=intr)
    jd._sync()
    n, ts, kp = _keyframes(jd)
    want = jd.terminate(_stream(imgs, intr), backend_steps=(2, 2))
    (got_n, got_ts, got_kp), traj, fill = port_run

    assert got_n == n
    np.testing.assert_array_equal(got_ts, ts)
    np.testing.assert_allclose(got_kp, kp, atol=0.05)
    assert traj.shape == (12, 7) and np.all(np.isfinite(traj))
    np.testing.assert_allclose(np.linalg.norm(traj[:, 3:], axis=-1), 1.0,
                               atol=1e-4)
    err = np.abs(traj - want).max(axis=1)
    assert np.delete(err, 5).max() < 0.1 and err[5] < 0.5, err

    # the JAX filler on the port's post-BA state gives the port's fill
    st = jd.video.state
    jd.video.state = st.replace(**{
        f: jnp.asarray(a).astype(getattr(st, f).dtype)
        for f, a in fill["state"].items()})
    jd.video.counter = fill["counter"]
    np.testing.assert_allclose(jd.traj_filler(_stream(imgs, intr)),
                               fill["w2c"], atol=1e-4)


def test_droid_batch_matches_per_frame(port_run):
    """track_batch (encoders hoisted over the chunk) follows the same
    keyframe decisions as per-frame tracking."""
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.runtime.slam import Droid

    imgs, intr = tiny_seq()
    d = Droid(SLAMConfig(**TINY), weights_path=WEIGHTS, device="cpu")
    d.track_batch(list(range(6)), imgs[:6], intrinsics=intr)
    d.track_batch(list(range(6, 12)), imgs[6:], intrinsics=intr)
    n, ts, kp = _keyframes(d)
    want_n, want_ts, want_kp = port_run[0]
    assert n == want_n
    np.testing.assert_array_equal(ts, want_ts)
    np.testing.assert_allclose(kp, want_kp, atol=1e-3)


def test_unported_inputs_raise():
    """No input is left unported: `fused=False` builds the host-driven
    frontend (tests/test_torch_frontend.py), and stereo, upsampling and
    depth input run (tests/test_torch_stereo.py, tests/test_torch_rgbd.py)."""
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.runtime.frontend import Frontend
    from droid_slam_tpu_torch.runtime.slam import Droid

    small = dict(image_size=(32, 48), buffer=8, compute_dtype="float32")
    host = Droid(SLAMConfig(**small, fused=False), device="cpu")
    assert type(host.frontend) is Frontend
    for ok in (dict(stereo=True), dict(upsample=True)):
        d = Droid(SLAMConfig(**small, **ok), device="cpu")
        assert d.video.state.fmaps.shape[1] == (2 if ok.get("stereo") else 1)
        assert d.video.state.disps_up.shape[0] == (8 if ok.get("upsample")
                                                   else 1)
