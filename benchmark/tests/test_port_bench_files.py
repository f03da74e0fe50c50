"""The inputs of the TartanAir-files training cell (not in BENCHMARK.json:
its check does not separate yet, PERF.md §6) at the CPU's size, 3 scenes
of 6 frames written at 480×640: the generator writes TartanAir's layout,
the port's reader reads it back with the rendered poses and depths and
its fixed calibration, draws the trainer's batches from it, and the
files are gone once the dataset is."""

import gc
import glob
import os

import numpy as np
import pytest
import torch

from benchmark.generators import tartan_files
from benchmark.lib import loader

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def params():
    p = loader.load_json(os.path.join(loader.HERE, "traffic", "files.json"))
    return dict(p, scenes=3, scene_frames=6)


def test_layout_and_what_the_reader_reads_back(tmp_path, params):
    from droid_slam_tpu_torch.data.image_io import read_png
    from droid_slam_tpu_torch.data.tartan import TartanAir

    dirs = tartan_files.write_scenes(str(tmp_path), params, 5, CPU)
    assert len(dirs) == 3
    for d in dirs:
        rel = os.path.relpath(d, tmp_path).split(os.sep)
        assert rel[0] == rel[1] and rel[2] == "Easy" and rel[3][0] == "P"
        pngs = sorted(glob.glob(os.path.join(d, "image_left", "*.png")))
        npys = sorted(glob.glob(os.path.join(d, "depth_left", "*.npy")))
        assert len(pngs) == len(npys) == 6
        assert read_png(pngs[0]).shape == (480, 640, 3)
        assert np.loadtxt(os.path.join(d, "pose_left.txt")).shape == (6, 7)
    data = TartanAir(str(tmp_path), n_frames=4, crop_size=(64, 96),
                     cache_dir=str(tmp_path / "cache"), device="cpu")
    info = data.scene_info[dirs[0]]
    rng, gen = tartan_files.generators(5, CPU)
    scene = tartan_files._scene(0, rng, gen, params, 480, 640, CPU)
    np.testing.assert_allclose(info["poses"], scene["poses"], atol=1e-5)
    np.testing.assert_allclose(
        TartanAir.depth_read(info["depths"][2]), scene["depths"][2].numpy(),
        rtol=1e-6)
    np.testing.assert_array_equal(info["intrinsics"][0], [320, 320, 320, 240])


def test_make_gives_the_reader_batches_and_cleans_up(params):
    data = tartan_files.make(params, 64, 96, 7, CPU, 4)
    root = os.path.dirname(data.root)
    assert os.path.isdir(os.path.join(root, "cache"))
    batch = next(data.sample_batches(1, np.random.default_rng(3)))
    assert batch["images"].shape == (1, 4, 64, 96, 3)
    assert batch["disps"].shape == (1, 4, 64, 96)
    del data, batch
    gc.collect()
    assert not os.path.exists(root)
