"""Build and load the package's CUDA kernels.

A `csrc/<name>.cu` file is compiled by `nvcc` into its own shared library
with a plain C interface (no PyTorch headers: seconds to build) and
loaded with ctypes.  Builds go to `csrc/build/` (ignored by git) at first
use and are reused while they are newer than their source.  Nothing here
runs at import time.
"""

import ctypes
import os
import os.path as osp
import shutil
import subprocess
import tempfile
import threading

CSRC = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "csrc")
BUILD_DIR = osp.join(CSRC, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# compiler output (ptxas register and spill counts) of each build
BUILD_LOG = {}

_lock = threading.Lock()
_libs = {}


def nvcc_path():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([osp.join(cuda_home, "bin", "nvcc")] if cuda_home else []) \
            + [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and osp.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's compiler (set CUDA_HOME)")


def _build(src, lib):
    """Compile `src` into a temporary file, then rename it to `lib`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
    out = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{out.stdout}")
    os.replace(tmp, lib)
    return out.stdout


def load(name, force=False):
    """ctypes handle of kernel library `name`, built first when it is
    missing, older than its source, or `force` is set (before the first
    load of the process only)."""
    with _lock:
        if name in _libs and not force:
            return _libs[name]
        src = osp.join(CSRC, name + ".cu")
        lib = osp.join(BUILD_DIR, f"lib{name}.so")
        if force or not osp.isfile(lib) \
                or osp.getmtime(lib) < osp.getmtime(src):
            if name in _libs:
                raise RuntimeError(f"{name} is already loaded")
            BUILD_LOG[name] = _build(src, lib)
        _libs[name] = ctypes.CDLL(lib)
        return _libs[name]
