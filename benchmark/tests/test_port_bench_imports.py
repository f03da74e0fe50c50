"""Nothing the harness or the reference loads is JAX, Flax or the JAX
package (top-level names compared whole), and the reference loads
nothing of the port."""

import subprocess
import sys

from benchmark.lib import guard, loader


def test_guard_compares_whole_top_level_names():
    names = ["droid_slam_tpu_torch", "droid_slam_tpu_torch.ops",
             "jaxtyping", "flaxen", "numpy"]
    assert guard.forbidden_modules(names) == []
    assert guard.forbidden_modules(
        names + ["jax.numpy", "jaxlib", "flax", "droid_slam_tpu.ops"]) == [
        "droid_slam_tpu.ops", "flax", "jax.numpy", "jaxlib"]


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted(sys.modules)))"],
        cwd=loader.ROOT, capture_output=True, text=True, timeout=300,
        check=True)
    return out.stdout.split()


def test_the_reference_loads_neither_jax_nor_the_port():
    mods = _loaded_after(
        "import benchmark.reference.tracking, benchmark.reference.training,"
        " benchmark.reference.weights, benchmark.reference.precision")
    assert guard.forbidden_modules(mods) == []
    assert not [m for m in mods if m.split(".")[0] == "droid_slam_tpu_torch"]


def test_the_harness_loads_no_jax():
    mods = _loaded_after(
        "import benchmark.run, benchmark.runners.track,"
        " benchmark.runners.train, benchmark.generators.box_walk,"
        " benchmark.generators.curriculum\n"
        "from benchmark.lib import loader\n"
        "b = loader.benchmark()\n"
        "[loader.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "import droid_slam_tpu_torch.runtime.slam,"
        " droid_slam_tpu_torch.training.trainer")
    assert guard.forbidden_modules(mods) == []


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mono-tartanair.fast", "--seed", str(2 ** 31 + 11), "--seconds",
         "1", "--trace", "0"],
        cwd=loader.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": "/tmp"})
    assert out.returncode == 2
    assert out.stdout == ""
