"""The benchmark measures the PyTorch port alone: no module of JAX, of
Flax or of the JAX package may be loaded.  Names are compared by their
top-level part whole, so `droid_slam_tpu_torch` (the port) passes and
`droid_slam_tpu` (the JAX package) does not."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "droid_slam_tpu")


def forbidden_modules(names=None):
    """Sorted forbidden module names among `names` (default: sys.modules)."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
