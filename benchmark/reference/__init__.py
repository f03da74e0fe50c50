"""The plain reference that decides `correct`.

Float32 PyTorch with no hand-written kernel, no volume cache and no
batching of its own.  The network, geometry, Lie-group, bundle-adjustment
and loss modules are frozen copies of the port's plain code as it stood
when the benchmark was written, with three changes: imports point here,
row sums use `index_add_` directly (scatter.py), and every correlation
lookup is the plain float32 bilinear gather of corr.py (the port rounds
volumes to bfloat16 and reads them with its CUDA kernels).  Nothing here
imports the port, the JAX package or JAX.
"""
