"""The benchmark of the PyTorch/CUDA port (`droid_slam_tpu_torch`).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on the CUDA card and
prints one JSON line.  Everything that belongs to one configuration,
traffic mix or per-layer metric sits in a file of its own that the
harness finds by the name BENCHMARK.json gives it.
"""
