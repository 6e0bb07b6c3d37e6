"""block_matmul: C = A @ B with fp32 accumulation — the StaGr backbone.

Port of the TPU kernel `block_matmul` (reference `kernels/block_matmul.py`)
as hand-written CUDA C++ for `sm_90a` (`csrc/block_matmul.cu`, tile in
`csrc/tc_gemm_tile.cuh`): a batched GEMM over `blockIdx.z` on the TF32
tensor cores as 3xTF32 (each fp32 operand split into a TF32 big and small
part, three products per product), which keeps fp32 accuracy but sums in
another order than cuBLAS, so the two are not bit-equal. A batch stride
of 0 broadcasts an operand (the weights of a combine).

`block_matmul` is the wrapper: CPU operands run `block_matmul_plain`, CUDA
operands launch the kernel or raise. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._launch import check_cuda, check_int32, launch, on_cpu

LAUNCHES = 0                      # kernel launches by `block_matmul`


def block_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version: the same product as one `torch.matmul`."""
    return torch.matmul(a, b).to(out_dtype or a.dtype)


def block_matmul(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B?, M, K) @ (B?, K, N) -> (B?, M, N), fp32 accumulation.

    A 2-D operand broadcasts over the other's batch. The kernel writes
    float32; another `out_dtype` is a cast of that result.
    """
    global LAUNCHES
    if on_cpu(a, b):
        return block_matmul_plain(a, b, out_dtype)
    device = check_cuda("block_matmul", a=a, b=b)
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError(f"block_matmul: operands must be 2-D or 3-D, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    batches = {t.shape[0] for t in (a, b) if t.dim() == 3}
    if k != k2 or len(batches) > 1:
        raise ValueError(f"block_matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not multiply")
    batch = batches.pop() if batches else 1
    lead = (batch,) if (a.dim() == 3 or b.dim() == 3) else ()
    out = torch.empty(*lead, m, n, dtype=torch.float32, device=device)
    if out.numel():
        stride_a = m * k if a.dim() == 3 else 0
        stride_b = k * n if b.dim() == 3 else 0
        check_int32("block_matmul", batch=batch, m=m, n=n, k=k,
                    stride_a=stride_a, stride_b=stride_b)
        launch("block_matmul", _build.load("block_matmul"), device,
               a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, n, k,
               stride_a, stride_b)
        LAUNCHES += 1
    return out if out_dtype in (None, torch.float32) else out.to(out_dtype)
