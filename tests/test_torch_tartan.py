"""The port's TartanAir training data against the JAX package's: the
scene writer, the reader and its covisibility graph, the random walk, the
augmentation (with OpenCV's 8-bit HSV and nearest resize written out in
numpy), the dataset factory, and the training CLI on a TartanAir root.

Tolerances: graph distances rtol 1e-4 (float32 flows summed in another
order); arrays read from the same files exact; the augmented images
within one grey level (bilinear resizes in float32, OpenCV against
torch), disparities and intrinsics exact; RGB->HSV exact against OpenCV
on every colour, HSV->RGB exact on rows OpenCV's vector path takes and
within one level where it takes its scalar path (the last pixels of a
row that do not fill a vector); the nearest resize exact.
"""

import json

import cv2
import numpy as np
import pytest

from droid_slam_tpu.data import augmentation as jaug
from droid_slam_tpu.data import factory as jfactory
from droid_slam_tpu.data import synthetic as jsyn
from droid_slam_tpu.data.tartan import TartanAir as JTartan
from droid_slam_tpu_torch.data import augmentation as taug
from droid_slam_tpu_torch.data import factory as tfactory
from droid_slam_tpu_torch.data import synthetic as tsyn
from droid_slam_tpu_torch.data.tartan import TartanAir as TTartan
from droid_slam_tpu_torch.data.warp import resize_nearest

N_FRAMES = 10
# a walk step admits flows in (15, 30) px: some neighbours of every
# frame, not all of them
WALK = dict(n_frames=4, fmin=15.0, fmax=30.0)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One TartanAir root written by each package (the same plane scene,
    seed 0, 96x128)."""
    base = tmp_path_factory.mktemp("tartan")
    out = {}
    for pkg, writer in (("jax", jsyn), ("port", tsyn)):
        root = str(base / pkg)
        data = writer.write_tartanair_scene(root, n_frames=N_FRAMES, H=96,
                                            W=128, seed=0)
        out[pkg] = (root, data)
    return out


def _readers(root, tmp_path, **kw):
    """Both packages' readers on `root`, each with its own cache."""
    kw = {**WALK, "do_aug": False, **kw}
    j = JTartan(root, cache_dir=str(tmp_path / "jcache"), **kw)
    t = TTartan(root, cache_dir=str(tmp_path / "tcache"), device="cpu",
                **kw)
    return j, t


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_readers_read_both_writers(roots, tmp_path, writer):
    root, data = roots[writer]
    j, t = _readers(root, tmp_path)
    assert len(j) == len(t) == N_FRAMES
    (sj,), (st,) = j.scene_info.values(), t.scene_info.values()
    assert sj["images"] == st["images"] and sj["depths"] == st["depths"]
    np.testing.assert_array_equal(sj["poses"], st["poses"])
    # the NED permutation and the depth scale undone
    np.testing.assert_allclose(st["poses"][:, 3:], data["poses_c2w"][:, 3:],
                               atol=1e-6)
    np.testing.assert_allclose(st["poses"][:, :3], data["poses_c2w"][:, :3],
                               atol=1e-5)
    np.testing.assert_array_equal(j.image_read(sj["images"][3]),
                                  t.image_read(st["images"][3]))
    np.testing.assert_array_equal(t.image_read(st["images"][3]),
                                  data["images"][3])
    np.testing.assert_allclose(t.depth_read(st["depths"][3]),
                               data["depths"][3], rtol=1e-6)
    for i in range(N_FRAMES):
        np.testing.assert_array_equal(sj["graph"][i][0], st["graph"][i][0])
        np.testing.assert_allclose(st["graph"][i][1], sj["graph"][i][1],
                                   rtol=1e-4)


def test_the_writers_render_the_same_scene(roots):
    (_, dj), (_, dt) = roots["jax"], roots["port"]
    assert np.abs(dj["images"].astype(int) - dt["images"]).max() <= 1
    np.testing.assert_allclose(dt["depths"], dj["depths"], rtol=1e-5)
    np.testing.assert_allclose(dt["poses_c2w"], dj["poses_c2w"], atol=1e-6)


def test_cache_is_keyed_by_the_root(roots, tmp_path):
    """Two roots under one cache directory keep two indices (the JAX
    reader keys its pickle by the dataset name alone)."""
    cache = str(tmp_path / "cache")
    a = TTartan(roots["jax"][0], cache_dir=cache, device="cpu", **WALK)
    b = TTartan(roots["port"][0], cache_dir=cache, device="cpu", **WALK)
    assert list(a.scene_info) != list(b.scene_info)
    again = TTartan(roots["port"][0], cache_dir=cache, device="cpu", **WALK)
    assert list(again.scene_info) == list(b.scene_info)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_getitem_matches_under_matched_seeds(roots, tmp_path, seed):
    j, t = _readers(roots["port"][0], tmp_path)
    for index in (0, 4, 7, 13):
        np.random.seed(seed + 10 * index)
        want = j[index]
        rs = np.random.RandomState(seed + 10 * index)
        scene, inds = t.frame_indices(index, np.random.RandomState(
            seed + 10 * index))
        got = t.__getitem__(index, rs)
        assert len(set(inds)) > 1
        for k in ("images", "poses", "disps", "intrinsics"):
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_degenerate_walk_repeats_the_frame(roots, tmp_path):
    """With no frame inside [fmin, fmax] the walk stays where it is."""
    _, t = _readers(roots["port"][0], tmp_path, fmin=1e4, fmax=2e4)
    _, inds = t.frame_indices(3, np.random.RandomState(0))
    assert inds == [3, 3, 3, 3]


@pytest.mark.parametrize("seed", range(6))
def test_augment_sample_matches(seed):
    """480x640 to the 384x512 crop: the colour jitter (drawn on half the
    seeds), the random scale, the resizes and the crop."""
    from droid_slam_tpu_torch.data.synthetic import render_box_scene

    sc = render_box_scene(2, 480, 640, seed=seed, motion_scale=0.12)
    images = sc["images"].astype(np.float32)
    disps = (1.0 / sc["depths"]).astype(np.float32)
    poses, intr = sc["poses_c2w"], sc["intrinsics"].astype(np.float32)
    want = jaug.augment_sample(images, poses, disps, intr, (384, 512),
                               rng=np.random.default_rng(seed))
    got = taug.augment_sample(images, poses, disps, intr, (384, 512),
                              np.random.default_rng(seed))
    assert got[0].shape == want[0].shape == (2, 384, 512, 3)
    assert np.abs(got[0] - want[0]).max() <= 1.0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("seed", range(4))
def test_color_jitter_matches(seed):
    rng = np.random.default_rng(100 + seed)
    images = rng.uniform(0, 255, (2, 48, 64, 3)).astype(np.float32)
    want = jaug._color_jitter(images, np.random.default_rng(seed))
    got = taug._color_jitter(images, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)


def test_hsv_matches_opencv():
    for r in range(0, 256, 64):                  # every colour, in blocks
        rgb = np.stack(np.meshgrid(np.arange(r, r + 64), np.arange(256),
                                   np.arange(256), indexing="ij"), -1)
        rgb = rgb.astype(np.uint8).reshape(-1, 256, 3)
        np.testing.assert_array_equal(taug.rgb_to_hsv8(rgb),
                                      cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 256, 3)
    np.testing.assert_array_equal(taug.hsv8_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    # rows of 7 pixels: OpenCV's scalar path rounds where its vector path
    # truncates
    odd = np.ascontiguousarray(
        hsv.reshape(-1, 3)[:7 * 20000].reshape(-1, 7, 3))
    d = np.abs(taug.hsv8_to_rgb(odd).astype(int)
               - cv2.cvtColor(odd, cv2.COLOR_HSV2RGB))
    assert d.max() <= 1


def test_resize_nearest_matches_opencv():
    """At every size the random scale gives 480x640 on the way to a
    384x512 crop (2^[-0.25, 0.25]), and at odd sizes."""
    rng = np.random.default_rng(0)
    a = rng.random((480, 640)).astype(np.float32)
    sizes = {(int(round(480 * s)), int(round(640 * s)))
             for s in 2 ** np.linspace(-0.25, 0.25, 161)}
    for H1, W1 in sorted(sizes):
        np.testing.assert_array_equal(
            resize_nearest(a, H1, W1),
            cv2.resize(a, (W1, H1), interpolation=cv2.INTER_NEAREST))
    b = rng.integers(0, 255, (7, 5, 3)).astype(np.uint8)
    for H1, W1 in ((3, 2), (11, 13), (7, 5), (1, 1)):
        np.testing.assert_array_equal(
            resize_nearest(b, H1, W1),
            cv2.resize(b, (W1, H1), interpolation=cv2.INTER_NEAREST))


def test_dataset_factory_and_concat_indexing(roots, tmp_path):
    kw = dict(WALK, do_aug=False)
    one_j = jfactory.dataset_factory(["tartan"], datapath=roots["port"][0],
                                     cache_dir=str(tmp_path / "j"), **kw)
    one_t = tfactory.dataset_factory(["tartan"], datapath=roots["port"][0],
                                     cache_dir=str(tmp_path / "t"),
                                     device="cpu", **kw)
    assert isinstance(one_t, TTartan) and len(one_t) == len(one_j)

    cj = jfactory.ConcatDataset([one_j, JTartan(
        roots["jax"][0], cache_dir=str(tmp_path / "j2"), **kw)])
    ct = tfactory.ConcatDataset([one_t, TTartan(
        roots["jax"][0], cache_dir=str(tmp_path / "t2"), device="cpu",
        **kw)])
    assert len(ct) == len(cj) == 2 * N_FRAMES
    np.testing.assert_array_equal(ct.offsets, cj.offsets)
    for index in (0, 9, 10, 19, 23):
        np.random.seed(index)
        want = cj[index]
        got = ct.__getitem__(index, np.random.RandomState(index))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sample_batches_draw_from_the_generator(roots, tmp_path):
    _, t = _readers(roots["port"][0], tmp_path)
    a = next(t.sample_batches(2, np.random.default_rng(5)))
    b = next(t.sample_batches(2, np.random.default_rng(5)))
    assert a["images"].shape == (2, 4, 96, 128, 3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_train_cli_on_a_tartanair_root(tmp_path, monkeypatch, capsys):
    """`python -m droid_slam_tpu_torch.train --datapath ROOT --device cpu`
    takes two steps at 96x128 (crops of a 120x160 scene, augmented) with a
    finite loss."""
    import torch

    from droid_slam_tpu_torch import train

    root = tmp_path / "root"
    tsyn.write_tartanair_scene(str(root), n_frames=12, H=120, W=160, seed=1)
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(4)
    rc = train.main(["--datapath", str(root), "--device", "cpu",
                     "--cache_dir", str(tmp_path / "cache"),
                     "--ckpt_dir", str(tmp_path / "ckpt"),
                     "--steps", "2", "--image_size", "96", "128",
                     "--n_frames", "4", "--iters", "2", "--edges", "8",
                     "--fmin", "15", "--fmax", "60", "--log_every", "1",
                     "--name", "tartan_cli"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and summary["samples"] == 12
    assert summary["device"] == "cpu"
    with open(tmp_path / "runs" / "tartan_cli" / "metrics.jsonl") as f:
        rec = [json.loads(line) for line in f]
    assert rec and all(np.isfinite(r["loss"]) for r in rec)
    assert (tmp_path / "ckpt" / "step_000002.pt").exists()
