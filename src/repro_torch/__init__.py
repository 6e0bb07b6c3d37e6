"""PyTorch/CUDA port of the GraNNite GNN serving stack for one NVIDIA H100.

Beside the JAX reference package `repro`, never importing it: host-side
graph preprocessing stays numpy, device operands are torch tensors, and the
Pallas kernels on the serving path are CUDA C++ kernels built for `sm_90a`
(`repro_torch/kernels/csrc/`). Every entry point takes `device=`; `None`
means the CUDA card and raises when there is none. The CPU runs only when a
caller passes `device="cpu"`, and then the kernels' plain PyTorch versions
execute.
"""
