"""The PyTorch port stands alone: no module of droid_slam_tpu_torch/, not
chip_smoke.py and not the port's tools (tools/torch_*.py) import jax,
flax, optax, orbax or the JAX package, no module of the package imports
OpenCV or PIL when it is imported (JPEG decoding imports them inside a
function), and entry points (`Droid`, `train`, the training CLI) default
to the CUDA card."""

import ast
import glob
import os.path as osp
import subprocess
import sys

import pytest

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "droid_slam_tpu")


def _package_files():
    return sorted(glob.glob(osp.join(ROOT, "droid_slam_tpu_torch", "**",
                                     "*.py"), recursive=True))


def _scanned_files():
    return (_package_files()
            + sorted(glob.glob(osp.join(ROOT, "tools", "torch_*.py")))
            + [osp.join(ROOT, "chip_smoke.py")])


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _scanned_files(),
                         ids=lambda p: osp.relpath(p, ROOT))
def test_no_jax_imports(path):
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


@pytest.mark.parametrize("path", _package_files(),
                         ids=lambda p: osp.relpath(p, ROOT))
def test_no_module_level_image_library_imports(path):
    """cv2 and PIL are optional: imported, if at all, inside a function."""
    tree = ast.parse(open(path).read(), path)
    for node in tree.body:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""]
                 if isinstance(node, ast.ImportFrom) else [])
        for mod in names:
            assert mod.split(".")[0] not in ("cv2", "PIL"), \
                f"{path} imports {mod} at module level"


def test_fresh_import_loads_no_jax():
    mods = sorted(
        "droid_slam_tpu_torch." + osp.relpath(p, osp.join(
            ROOT, "droid_slam_tpu_torch"))[:-3].replace(osp.sep, ".")
        for p in _package_files() if not p.endswith("__init__.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_droid_defaults_to_cuda():
    import torch

    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.runtime.slam import Droid

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Droid(SLAMConfig(image_size=(32, 48), buffer=4))


def _run_cli(args):
    code = ("import sys\n"
            "from droid_slam_tpu_torch import train\n"
            f"try:\n    train.main({args!r})\n"
            "finally:\n"
            "    bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "    assert not bad, bad\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_train_cli_parses_without_jax():
    """`python -m droid_slam_tpu_torch.train`: --help works, a run with
    neither --datapath nor --synthetic is refused, and neither loads any
    forbidden module."""
    r = _run_cli(["--help"])
    assert r.returncode == 0 and "--synthetic" in r.stdout, r.stderr[-2000:]
    r = _run_cli(["--steps", "1"])
    assert r.returncode == 2 and "--synthetic" in r.stderr, r.stderr[-2000:]


def test_train_cli_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run_cli(["--synthetic", "--scenes", "1", "--steps", "1",
                  "--n_frames", "3", "--image_size", "32", "48"])
    assert r.returncode == 1 and "no CUDA device" in r.stderr, \
        r.stderr[-2000:]
