"""CUDA kernels of the port (sources in ``../csrc``), each beside its plain
PyTorch version in ``ref``.  Importing a module here builds and loads
nothing: a kernel is compiled on its first launch."""
