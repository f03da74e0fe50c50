"""The port's evaluation streams (data/streams.py, data/factory.py) against
the JAX package's, on the same files.

Each layout is written with OpenCV as tests/test_streams.py writes it
(EuRoC adds gray 752x480 cam0/cam1 frames).  Every yield must have the
JAX stream's length, shapes, dtypes, intrinsics and timestamps exactly;
images within one grey level (the port resizes, undistorts and rectifies
in float32 where OpenCV uses fixed point, data/warp.py); depth maps
exactly.
"""

import os.path as osp

import cv2
import numpy as np
import pytest

from droid_slam_tpu.data import factory as jfactory
from droid_slam_tpu.data import streams as jstreams
from droid_slam_tpu_torch.data import factory as tfactory
from droid_slam_tpu_torch.data import rgbd_utils as trgbd
from droid_slam_tpu_torch.data import streams as tstreams


def _img(rng, h=480, w=640):
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)


def assert_same_yields(want, got):
    """Element by element: arrays of uint8 within one level, every other
    array and number exactly."""
    assert len(got) == len(want) > 0
    for tw, tg in zip(want, got):
        assert len(tw) == len(tg)
        for a, b in zip(tw, tg):
            if isinstance(a, np.ndarray):
                assert b.shape == a.shape and b.dtype == a.dtype
                if a.dtype == np.uint8:
                    d = np.abs(a.astype(np.int64) - b)
                    assert d.max() <= 1, d.max()
                else:
                    np.testing.assert_array_equal(b, a)
            else:
                assert b == a


def _both(name, *args, **kw):
    return (list(getattr(jstreams, name)(*args, **kw)),
            list(getattr(tstreams, name)(*args, **kw)))


@pytest.fixture()
def tum_dir(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "rgb").mkdir()
    for t in range(4):
        cv2.imwrite(str(tmp_path / "rgb" / f"{1000.0 + t * 0.1:.6f}.png"),
                    _img(rng))
    return str(tmp_path)


@pytest.fixture()
def euroc_dir(tmp_path):
    rng = np.random.default_rng(7)
    for cam in ("cam0", "cam1"):
        d = tmp_path / "mav0" / cam / "data"
        d.mkdir(parents=True)
        for t in range(3):
            cv2.imwrite(str(d / f"{1403636579763555584 + t * 50000000}.png"),
                        rng.integers(0, 255, (480, 752), dtype=np.uint8))
    return str(tmp_path)


@pytest.fixture()
def eth3d_dir(tmp_path):
    rng = np.random.default_rng(1)
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    with open(tmp_path / "rgb.txt", "w") as fr, \
            open(tmp_path / "depth.txt", "w") as fd:
        for t in range(4):
            ts = 10.0 + t * 0.05
            rp, dp = f"rgb/{ts:.6f}.png", f"depth/{ts + 0.001:.6f}.png"
            cv2.imwrite(str(tmp_path / rp), _img(rng, 130, 165))
            cv2.imwrite(str(tmp_path / dp), (rng.uniform(
                1, 3, (130, 165)) * 5000).astype(np.uint16))
            fr.write(f"{ts:.6f} {rp}\n")
            fd.write(f"{ts + 0.001:.6f} {dp}\n")
    np.savetxt(str(tmp_path / "calibration.txt"),
               np.asarray([100.0, 100.0, 80.0, 64.0]))
    return str(tmp_path)


@pytest.fixture()
def kitti_dir(tmp_path):
    rng = np.random.default_rng(5)
    for sub in ("image_2", "image_3"):
        (tmp_path / sub).mkdir()
        for t in range(3):
            cv2.imwrite(str(tmp_path / sub / f"{t:06d}.png"),
                        _img(rng, 124, 411))
    with open(tmp_path / "calib.txt", "w") as f:
        P = ("7.188560e+02 0 6.071928e+02 0 0 7.188560e+02 "
             "1.852157e+02 0 0 0 1 0")
        for k in ("P0", "P1", "P2", "P3"):
            f.write(f"{k}: {P}\n")
    return str(tmp_path)


@pytest.fixture()
def tartan_dir(tmp_path):
    rng = np.random.default_rng(6)
    (tmp_path / "image_left").mkdir()
    for t in range(3):
        cv2.imwrite(str(tmp_path / "image_left" / f"{t:06d}.png"),
                    _img(rng, 244, 322))
    return str(tmp_path)


def test_tum_stream(tum_dir):
    want, got = _both("tum_stream", tum_dir, stride=1)
    assert got[0][1].shape == (240, 320, 3)
    assert_same_yields(want, got)


@pytest.mark.parametrize("stereo", [False, True])
def test_euroc_stream(euroc_dir, stereo):
    want, got = _both("euroc_stream", euroc_dir, stereo=stereo,
                      image_size=(160, 256))
    assert got[0][1].shape == ((2,) if stereo else ()) + (160, 256, 3)
    assert_same_yields(want, got)


def test_eth3d_stream(eth3d_dir):
    want, got = _both("eth3d_stream", eth3d_dir)
    assert got[0][1].shape == (128, 160, 3)
    assert got[0][2].dtype == np.float32
    assert_same_yields(want, got)


def test_tartan_stream(tartan_dir):
    assert_same_yields(*_both("tartan_stream", tartan_dir))


@pytest.mark.parametrize("stereo", [False, True])
def test_kitti_stream(kitti_dir, stereo):
    assert_same_yields(*_both("kitti_stream", kitti_dir, stride=1,
                              stereo=stereo))


@pytest.mark.parametrize("dist", [(), (0.1, -0.2, 0.001, 0.002, 0.05)])
def test_directory_stream(tmp_path, dist):
    rng = np.random.default_rng(2)
    (tmp_path / "imgs").mkdir()
    for t in range(3):
        cv2.imwrite(str(tmp_path / "imgs" / f"{t:04d}.png"),
                    _img(rng, 240, 320))
    calib = str(tmp_path / "calib.txt")
    np.savetxt(calib, np.asarray([[260.0, 255.0, 160.0, 120.0, *dist]]))
    want, got = _both("directory_stream", str(tmp_path / "imgs"), calib,
                      target_area=200 * 280)
    assert_same_yields(want, got)
    # the demo's t0: frames t0, t0 + stride, ...
    later = list(tstreams.directory_stream(str(tmp_path / "imgs"), calib,
                                           stride=1, target_area=200 * 280,
                                           t0=1))
    assert len(later) == 2
    np.testing.assert_array_equal(later[0][1], got[1][1])


def test_stereo_directory_stream(tmp_path):
    rng = np.random.default_rng(3)
    for sub in ("image_left", "image_right"):
        (tmp_path / sub).mkdir()
        for t in range(3):
            cv2.imwrite(str(tmp_path / sub / f"{t:04d}.png"),
                        _img(rng, 240, 320))
    calib = str(tmp_path / "calib.txt")
    np.savetxt(calib, np.asarray([[260.0, 260.0, 160.0, 120.0, 0.05,
                                   -0.02, 0.0, 0.001]]))
    assert_same_yields(*_both("stereo_directory_stream", str(tmp_path),
                              calib, target_area=180 * 240))


def test_rgbd_directory_stream(tmp_path):
    rng = np.random.default_rng(4)
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    for t in range(3):
        cv2.imwrite(str(tmp_path / "rgb" / f"{t:04d}.png"),
                    _img(rng, 130, 165))
        cv2.imwrite(str(tmp_path / "depth" / f"{t:04d}.png"),
                    (rng.uniform(0.5, 4, (130, 165)) * 1000).astype(
                        np.uint16))
    calib = str(tmp_path / "calib.txt")
    np.savetxt(calib, np.asarray([[100.0, 100.0, 80.0, 64.0]]))
    want, got = _both("rgbd_directory_stream", str(tmp_path), calib)
    assert got[0][2].shape == (128, 160)
    assert_same_yields(want, got)


@pytest.mark.parametrize("layout", ["tum_dir", "euroc_dir", "eth3d_dir",
                                    "kitti_dir", "tartan_dir"])
def test_create_stream_dispatch(request, layout):
    """Same marker-file dispatch: the same stream, the same frames."""
    path = request.getfixturevalue(layout)
    assert_same_yields(list(jfactory.create_stream(path, stride=2)),
                       list(tfactory.create_stream(path, stride=2)))


def test_create_stream_unknown_layout(tmp_path):
    with pytest.raises(ValueError, match="unrecognized"):
        tfactory.create_stream(str(tmp_path))


def test_rgbd_utils_match_jax(tmp_path):
    from droid_slam_tpu.data import rgbd_utils as jrgbd

    rng = np.random.default_rng(8)
    ti = np.sort(rng.uniform(0, 5, 40))
    td = np.sort(ti + rng.normal(0, 0.05, 40))
    tp = np.sort(rng.uniform(0, 5, 60))
    for pose in (None, tp):
        assert (trgbd.associate_frames(ti, td, pose)
                == jrgbd.associate_frames(ti, td, pose))
    path = str(tmp_path / "list.txt")
    with open(path, "w") as f:
        f.write("# header\n")
        for t in ti[:5]:
            f.write(f"{t:.6f} rgb/{t:.6f}.png\n")
    np.testing.assert_array_equal(trgbd.parse_list(path, skiprows=1),
                                  jrgbd.parse_list(path, skiprows=1))
    assert osp.isfile(path)
