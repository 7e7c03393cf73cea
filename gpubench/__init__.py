"""Benchmark of the PyTorch and CUDA port, lbzip2_tpu_torch, on NVIDIA GPUs.

    python3 gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

``BENCHMARK.json`` at the root of the repository names the cells; each
cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``), a mix may name a kind of data kept in a module
of its own (``classes/<name>.py``), and each per-layer metric has a
reader of its own (``metrics/<name>.py``).  The harness finds all of them
by name, so a cell, a configuration, a mix, a kind of data or a metric is
added by adding files.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``lbzip2_tpu``; only the system under test is imported from the port.
"""
