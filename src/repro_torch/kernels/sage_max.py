"""sage_max: GrAx3, the SAGE-max aggregation as a masked multiply and max,
out[i, f] = max(0, max_j mask[i, j] * h[j, f]).

Port of the TPU kernel `sage_max` (reference `kernels/sage_max.py`) as
hand-written CUDA C++ for `sm_90a` (`csrc/sage_max.cu`, row walk in
`csrc/sage_walk.cuh`). The TPU kernel forms the (rows, bk, bf) product of
every mask entry in VMEM slabs; the sample mask has at most
max_neighbors + 1 ones per real row, so the port scans each row once
(one warp per row, a ballot over 32 columns at a time), compacts its set
columns in ascending order into shared memory, and walks only those rows
of h, coalesced along F. Its bound is the mask's bytes. F is taken as it
is (1433 at layer 1), not padded to 128. A row with more set columns than
the warp's list holds is walked in chunks, so any 0/1 mask is taken.

For finite h the kernel equals the TPU kernel, whose accumulator starts
at 0 too, bit for bit and for any sign of h: a skipped column adds 0 * h,
which never changes such a max. It differs where h is not finite in a row
that the mask never selects: the plain version (and the TPU kernel)
multiply it by 0 and turn NaN, the kernel never reads it.

The mask may be rectangular, (M, N) against h's (N, F): a shard's row
block of a partitioned graph (`core.models.forward_grannite_sharded`)
against the whole graph's pooled features. The walk is the same; its
grid covers M rows.

`sage_max` is the wrapper: CPU operands run `sage_max_plain`, CUDA
operands launch the kernel or raise. `LAUNCHES` counts kernel launches.
`check_walk` holds the operand checks that `fused_sage` shares.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from ._launch import check_cuda, check_int32, launch, on_cpu

LAUNCHES = 0                      # kernel launches by `sage_max`
# largest (..., rows, N, F) product `sage_max_plain` forms at once
MAX_BLOCK_BYTES = 1 << 28


def sage_max_plain(mask01: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, the TPU kernel's arithmetic: the broadcast
    product over a block of rows at a time (at most MAX_BLOCK_BYTES), its
    max over the columns, and the accumulator's 0. mask01: (..., M, N);
    h: (..., N, F)."""
    n, cols = mask01.shape[-2:]
    per_row = 4 * cols * h.shape[-1] * math.prod(mask01.shape[:-2])
    rb = max(1, min(n, MAX_BLOCK_BYTES // max(per_row, 1)))
    out = h.new_empty((*mask01.shape[:-1], h.shape[-1]))
    for r0 in range(0, n, rb):
        prod = mask01[..., r0:r0 + rb, :, None] * h[..., None, :, :]
        out[..., r0:r0 + rb, :] = torch.clamp_min(prod.amax(dim=-2), 0.0)
    return out


def check_walk(kernel: str, mask: torch.Tensor,
               h: torch.Tensor) -> Tuple[int, int, int, int]:
    """Raise unless mask is (B, M, N) and h (B, N, F) with sizes the C
    entry points take; return (B, M, N, F)."""
    if mask.dim() != 3 or h.dim() != 3:
        raise ValueError(f"{kernel}: mask must be (B, M, N) and the "
                         f"features (B, N, F), got {tuple(mask.shape)}, "
                         f"{tuple(h.shape)}")
    batch, n, f = h.shape
    m = mask.shape[1]
    if tuple(mask.shape) != (batch, m, n):
        raise ValueError(f"{kernel}: shapes do not agree: mask "
                         f"{tuple(mask.shape)}, features {tuple(h.shape)}")
    check_int32(kernel, batch=batch, m=m, n=n, f=f)
    return batch, m, n, f


def sage_max(mask01: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """mask01: (B, M, N) 0/1 sampled adjacency (M = N for a graph, M < N
    for a shard's row block); h: (B, N, F), h >= 0 on the serving path.
    Returns (B, M, F) float32."""
    global LAUNCHES
    if on_cpu(mask01, h):
        return sage_max_plain(mask01, h)
    device = check_cuda("sage_max", mask01=mask01, h=h)
    batch, m, n, f = check_walk("sage_max", mask01, h)
    out = torch.empty(batch, m, f, dtype=torch.float32, device=device)
    if out.numel():
        launch("sage_max", _build.load("sage_max"), device,
               mask01.data_ptr(), h.data_ptr(), out.data_ptr(), batch, m, n,
               f)
        LAUNCHES += 1
    return out
