"""The traffic generators: each repeats from its seed, and the reflected
walk keeps its speed inside its bounds."""

import numpy as np
import pytest
import torch

from benchmark.generators import box_walk, curriculum, scenes
from benchmark.lib import loader

CPU = torch.device("cpu")


def _traffic(name, **kw):
    return dict(loader.load_json(f"{loader.HERE}/traffic/{name}.json"), **kw)


@pytest.mark.parametrize("name", ["fast", "slow"])
def test_box_walk_repeats_from_its_seed(name):
    p = _traffic(name, frames=6)
    a = box_walk.make(p, 48, 64, 2 ** 31 + 3, CPU)
    b = box_walk.make(p, 48, 64, 2 ** 31 + 3, CPU)
    c = box_walk.make(p, 48, 64, 2 ** 31 + 4, CPU)
    assert torch.equal(a["images"], b["images"])
    assert np.array_equal(a["poses"], b["poses"])
    assert not torch.equal(a["images"], c["images"])
    assert a["images"].dtype == torch.uint8
    assert a["images"].float().std() > 20          # textured, not blank


def test_curriculum_repeats_from_its_seed():
    p = _traffic("synth", scenes=6, scene_frames=8)
    a = curriculum.make(p, 32, 48, 7, CPU, 4)
    b = curriculum.make(p, 32, 48, 7, CPU, 4)
    assert torch.equal(a.images, b.images)
    ba = next(a.sample_batches(1, np.random.default_rng(1)))
    bb = next(b.sample_batches(1, np.random.default_rng(1)))
    for k in ba:
        assert np.array_equal(ba[k], bb[k]), k
    assert ba["images"].shape == (1, 4, 32, 48, 3)
    assert np.all(ba["disps"] > 0)


def test_reflected_walk_keeps_its_speed():
    p = _traffic("fast")
    rng = np.random.default_rng(5)
    poses = scenes.reflected_walk(rng, 4000, p["step_std"], p["rot_ratio"],
                                  p["lo"], p["hi"], p["rot_bound"])
    rng = np.random.default_rng(5)
    steps = p["step_std"] * rng.standard_normal((4000, 6))
    steps[0] = 0.0
    t = poses[:, :3]
    assert np.all(t >= np.asarray(p["lo"]) - 1e-6)
    assert np.all(t <= np.asarray(p["hi"]) + 1e-6)
    # a step keeps its length along every axis unless it crosses a bound,
    # where the fold shortens it; the crossings are few
    moved, drawn = np.abs(np.diff(t, axis=0)), np.abs(steps[1:, :3])
    assert np.all(moved <= drawn + 1e-5)
    assert np.mean(np.isclose(moved, drawn, atol=1e-5)) > 0.9
    # the walk reaches the bounds many times, and its speed holds over
    # the first and the last quarter alike
    speed = np.linalg.norm(np.diff(t, axis=0), axis=1)
    q = len(speed) // 4
    assert abs(speed[:q].mean() / speed[-q:].mean() - 1) < 0.05


def test_rotations_match_the_ports_convention():
    from droid_slam_tpu_torch.lie import so3

    rng = np.random.default_rng(0)
    q = torch.as_tensor(scenes.quat_from_rotvec(rng.normal(size=(5, 3))),
                        dtype=torch.float32)
    v = torch.randn(5, 3)
    torch.testing.assert_close(
        torch.einsum("nab,nb->na", scenes.rot_from_quat(q), v),
        so3.act(q, v), atol=1e-5, rtol=1e-5)


def test_walk_seed_fixes_the_motion_across_seeds():
    p = _traffic("slow", frames=5)
    a = box_walk.make(p, 48, 64, 1, CPU)
    b = box_walk.make(p, 48, 64, 2, CPU)
    assert np.array_equal(a["poses"], b["poses"])
    assert not torch.equal(a["images"], b["images"])
    p.pop("walk_seed")
    c = box_walk.make(p, 48, 64, 2, CPU)
    assert not np.array_equal(b["poses"], c["poses"])


def test_the_check_samples_the_whole_window():
    """The tracking check's reservoir keeps `k` of a stream of unknown
    length, each item about equally often: late rounds and frames of a
    long window are drawn as often as early ones, and the draw repeats
    from its seed."""
    from benchmark.runners.track import Reservoir

    def draw(seed, n=1200, k=3):
        r = Reservoir(k, np.random.default_rng([seed, 2]))
        for i in range(n):
            slot = r.slot()
            if slot is not None:
                r.items[slot] = i
        return r.items

    assert draw(5) == draw(5)
    kept = np.concatenate([draw(s) for s in range(400)])
    assert len(set(draw(5))) == 3
    counts = np.histogram(kept, bins=4, range=(0, 1200))[0]
    assert counts.min() > 0.8 * counts.mean(), counts
