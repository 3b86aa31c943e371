"""The benchmark of ``grbaz_tpu_torch``, the PyTorch/CUDA port: one cell
a run (``python3 -m radiobench.run``), cells, configurations, traffic
mixes and per-layer metrics found by name from ``BENCHMARK.json``. It
imports neither JAX nor the JAX package."""
