"""bitmap_spmm: the GraSp block-sparse aggregation Â @ H.

Port of the TPU kernel `bitmap_spmm` (reference `kernels/bitmap_spmm.py`)
as hand-written CUDA C++ for `sm_90a` (`csrc/bitmap_spmm.cu`, walk in
`csrc/bsr_tile.cuh`): each 64x64 output tile of a block row loops over
that row's real entries only, in list order, reading the counts and block
columns on the card. Each entry's product runs as 3xTF32 on the TF32
tensor cores (`mma_tile` of `csrc/tc_gemm_tile.cuh`), summed apart and
then added to the tile's total. Entries past `counts` are never loaded or
multiplied.

Operands (batched over a leading B; `kernels/ops.py` adds it for one
graph): blocks (B, rb*max_nnz, 128, 128) f32, block_cols (B, rb, max_nnz)
int32, counts (B, rb) int32, h (B, n_h, F) f32 with n_h a multiple of 128.
Returns (B, rb*128, F) float32.

`bitmap_spmm` is the wrapper: CPU operands run `bitmap_spmm_plain`, CUDA
operands launch the kernel or raise. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import check_cuda, check_int32, launch, on_cpu

LAUNCHES = 0                      # kernel launches by `bitmap_spmm`
BLOCK = 128                       # the kernel's block edge


def bitmap_spmm_plain(blocks: torch.Tensor, block_cols: torch.Tensor,
                      counts: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, the kernel's walk as whole-batch ops: for
    each list position k in order, every block row multiplies its entry k
    by the H rows it names, times a 0/1 mask of k < counts (so a padded
    entry is multiplied by 0, not skipped)."""
    batch, rb, max_nnz = block_cols.shape
    bs = blocks.shape[-1]
    f = h.shape[-1]
    hb = h.reshape(batch, -1, bs, f)
    blk = blocks.reshape(batch, rb, max_nnz, bs, bs)
    rows = torch.arange(batch, device=h.device)[:, None]
    acc = torch.zeros(batch, rb, bs, f, dtype=h.dtype, device=h.device)
    for k in range(max_nnz):
        hk = hb[rows, block_cols[:, :, k].long()]          # (B, rb, bs, F)
        live = (counts > k).to(h.dtype)[:, :, None, None]
        acc = acc + live * torch.matmul(blk[:, :, k], hk)
    return acc.reshape(batch, rb * bs, f)


def check_structure(kernel: str, blocks: torch.Tensor,
                    block_cols: torch.Tensor, counts: torch.Tensor) -> None:
    """Raise unless the compacted form has the kernel's batched shapes and
    its blocks start 16-byte aligned."""
    if block_cols.dim() != 3:
        raise ValueError(f"{kernel}: block_cols must be (B, rb, max_nnz), "
                         f"got {tuple(block_cols.shape)}")
    batch, rb, max_nnz = block_cols.shape
    if (tuple(blocks.shape) != (batch, rb * max_nnz, BLOCK, BLOCK)
            or tuple(counts.shape) != (batch, rb)):
        raise ValueError(
            f"{kernel}: the kernel takes {BLOCK}x{BLOCK} blocks of shape "
            f"(B, rb*max_nnz, {BLOCK}, {BLOCK}) and counts (B, rb); got "
            f"blocks {tuple(blocks.shape)}, block_cols "
            f"{tuple(block_cols.shape)}, counts {tuple(counts.shape)}")
    check_int32(kernel, batch=batch, rb=rb, max_nnz=max_nnz,
                blocks=blocks.numel())
    if blocks.data_ptr() % 16:
        raise ValueError(f"{kernel}: blocks must start 16-byte aligned (the "
                         "kernel copies them 16 bytes at a time)")


def bitmap_spmm(blocks: torch.Tensor, block_cols: torch.Tensor,
                counts: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(B, rb*128, F) = Â @ h over the compacted blocks (see module)."""
    global LAUNCHES
    if on_cpu(blocks, block_cols, counts, h):
        return bitmap_spmm_plain(blocks, block_cols, counts, h)
    device = check_cuda("bitmap_spmm", int32=("block_cols", "counts"),
                        blocks=blocks, block_cols=block_cols, counts=counts,
                        h=h)
    check_structure("bitmap_spmm", blocks, block_cols, counts)
    batch, rb, max_nnz = block_cols.shape
    if h.dim() != 3 or h.shape[0] != batch or h.shape[1] % BLOCK:
        raise ValueError(f"bitmap_spmm: h must be (B={batch}, n_h, F) with "
                         f"n_h a multiple of {BLOCK}, got {tuple(h.shape)}")
    n_h, f = h.shape[1:]
    out = torch.empty(batch, rb * BLOCK, f, dtype=torch.float32,
                      device=device)
    if out.numel():
        check_int32("bitmap_spmm", n_h=n_h, f=f)
        launch("bitmap_spmm", _build.load("bitmap_spmm"), device,
               blocks.data_ptr(), block_cols.data_ptr(), counts.data_ptr(),
               h.data_ptr(), out.data_ptr(), batch, rb, max_nnz, n_h, f)
        LAUNCHES += 1
    return out
