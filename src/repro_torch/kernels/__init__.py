"""Kernels of the port: CUDA C++ sources in csrc/, wrappers, plain versions."""
