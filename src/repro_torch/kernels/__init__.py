"""Kernels of the port: hand-written CUDA C++ for Hopper (``csrc/``),
bound with ctypes, each beside its plain PyTorch version."""
