"""The benchmark of nx_signal_tpu_torch (the PyTorch and CUDA port): one
command runs one cell of BENCHMARK.json once and prints one JSON line.
See portbench/README.md."""
