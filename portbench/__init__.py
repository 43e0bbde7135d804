"""The benchmark of ``iffnerf_tpu_torch`` on an NVIDIA H100: one command
runs one cell (``python3 -m portbench.run --help``); ``BENCHMARK.json`` at
the root of the repository lists the cells and metrics."""
