"""droid_slam_tpu_torch — the PyTorch/CUDA port of droid_slam_tpu.

Monocular deep visual SLAM (recurrent update operator, correlation-
pyramid lookups, dense Gauss-Newton bundle adjustment) and the training
of its network (training/, train.py) on PyTorch, with hand-written CUDA
kernels for Hopper (csrc/).  The JAX package beside it
is the reference this package is tested against; nothing here imports it.

Entry points run on the CUDA card unless the caller passes
device="cpu"; on CPU tensors every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level exports (keep `import droid_slam_tpu_torch` light)."""
    if name == "Droid":
        from .runtime.slam import Droid
        return Droid
    if name == "SLAMConfig":
        from .config import SLAMConfig
        return SLAMConfig
    if name == "PRESETS":
        from .config import PRESETS
        return PRESETS
    raise AttributeError(name)
