"""Build and load the package's CUDA kernels.

Every `csrc/<name>.cu` file is compiled by `nvcc` into its own shared
library with a plain C interface (no PyTorch headers: seconds to build)
and loaded with ctypes; `csrc/*.cuh` are headers the sources share.  Builds go to `csrc/build/` (ignored by git) at
first use: the first `load` compiles every source that is missing or
older than its source file or a header, one `nvcc` process per source, all started
together.  Nothing here runs at import time.
"""

import ctypes
import glob
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


def source_names():
    """Names of the kernel libraries: every csrc/<name>.cu."""
    return sorted(osp.basename(p)[:-3]
                  for p in glob.glob(osp.join(CSRC, "*.cu")))


def _paths(name):
    return (osp.join(CSRC, name + ".cu"),
            osp.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name):
    src, lib = _paths(name)
    deps = [src] + glob.glob(osp.join(CSRC, "*.cuh"))
    return (not osp.isfile(lib)
            or osp.getmtime(lib) < max(osp.getmtime(d) for d in deps))


def _build(names):
    """Compile the sources of `names` side by side, each into a temporary
    file that is renamed to its library when its `nvcc` succeeds."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in names:
        src, lib = _paths(name)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
        procs.append((name, src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {src}:\n{out}")
        else:
            os.replace(tmp, lib)
            BUILD_LOG[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all(force=False):
    """Build every kernel library that is missing or older than its source
    (all of them with `force`); libraries this process has already loaded
    are left alone.  Returns the names built."""
    with _lock:
        names = [n for n in source_names()
                 if n not in _libs and (force or _stale(n))]
        if names:
            _build(names)
        return names


def load(name):
    """ctypes handle of kernel library `name`; the first call builds every
    stale library (see `build_all`)."""
    with _lock:
        if name in _libs:
            return _libs[name]
    if not osp.isfile(_paths(name)[0]):
        raise ValueError(f"no kernel source csrc/{name}.cu")
    build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_paths(name)[1])
        return _libs[name]
