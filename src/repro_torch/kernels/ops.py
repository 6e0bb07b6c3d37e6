"""Public kernel entry points of the port: `matmul`, `int8_matmul`,
`bitmap_spmm` (with `bitmap_spmm_batched` and `bitmap_spmm_mode`) and
`fused_gcn_layer` (its dense, QuantGr and GraSp branches).

Routing follows the tensors' device (`kernels/_launch.py`): CPU tensors run
the kernels' plain versions, CUDA tensors the hand-written kernels or an
exception — no environment override and no fallback. Every entry pads its
operands to the 128 tile and strips the result, as the reference's
`ops._pad2` does (a no-op for NodePad'ded graph operands). Entries accept a
leading batch dimension, which stands in for the reference's `vmap`.

The other entries of the reference's `ops.py` (GAT, SAGE, flash
attention) are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import int8_matmul as _i8
from .bitmap_spmm import bitmap_spmm as _bitmap_spmm
from .block_matmul import block_matmul
from .fused_layers import fused_gcn_dense, fused_gcn_grasp, fused_gcn_int8

TILE = 128


def _pad2(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    """Zero-pad the last two dims up to multiples of (m0, m1); contiguous."""
    p0 = (-x.shape[-2]) % m0
    p1 = (-x.shape[-1]) % m1
    if p0 == 0 and p1 == 0:
        return x.contiguous()
    return F.pad(x, (0, p1, 0, p0))


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """StaGr aggregation backbone: C = A @ B through `block_matmul`."""
    m, n = a.shape[-2], b.shape[-1]
    out = block_matmul(_pad2(a, TILE, TILE), _pad2(b, TILE, TILE),
                       out_dtype=out_dtype or a.dtype)
    return out[..., :m, :n]


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor,
                x_scale: Union[float, torch.Tensor],
                w_scale: torch.Tensor) -> torch.Tensor:
    """QuantGr INT8 datapath through the `int8_matmul` kernel:
    (B?, M, K) s8 @ (B?, K, N) s8 * x_scale * w_scale[N] -> float32."""
    m, n = xq.shape[-2], wq.shape[-1]
    sp = F.pad(w_scale.reshape(-1), (0, (-n) % TILE))
    out = _i8.int8_matmul(_pad2(xq, TILE, TILE), _pad2(wq, TILE, TILE),
                          x_scale, sp)
    return out[..., :m, :n]


def bitmap_spmm_mode(device: torch.device) -> str:
    """Which form a GraSp dispatch takes on `device`: "kernel" (the CUDA
    block-skip walk) on a card, "ref" (the plain version, which multiplies
    padded entries by 0 instead of skipping them) on the CPU. GraphServe
    counts a grasp batch run in "ref" form in `backend_fallbacks`."""
    return "kernel" if torch.device(device).type == "cuda" else "ref"


def _structure(block_sparse, single: bool):
    leaves = (block_sparse.blocks, block_sparse.block_cols,
              block_sparse.counts)
    return tuple(t[None] for t in leaves) if single else leaves


def bitmap_spmm(block_sparse, h: torch.Tensor) -> torch.Tensor:
    """GraSp block-sparse aggregation Â @ h through the `bitmap_spmm`
    kernel. `block_sparse` is a `core.sparsity.BlockSparse` with tensor
    leaves, one graph's or stacked (`stack_block_sparse`) with h (B, N, F).
    h is padded to (block size, 128) and the result stripped to
    (B?, shape[0], F)."""
    single = h.dim() == 2
    if single:
        h = h[None]
    f = h.shape[-1]
    out = _bitmap_spmm(*_structure(block_sparse, single),
                       _pad2(h, block_sparse.block_size, TILE))
    out = out[:, :block_sparse.shape[0], :f]
    return out[0] if single else out


# The batched entry is the same function: a stacked structure and h with a
# leading B stand in for the reference's vmap.
bitmap_spmm_batched = bitmap_spmm


def fused_gcn_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    norm_adj: Optional[torch.Tensor] = None,
                    block_sparse=None,
                    quant: Optional[Tuple[torch.Tensor, ...]] = None,
                    activation: str = "none") -> torch.Tensor:
    """Fused GCN layer act(aggregate(combine(X)) + b), one kernel call.

    Dense: `norm_adj` (B?, N, N) through `fused_gcn_dense`. GraSp:
    `block_sparse` (a `BlockSparse`, batched like x) through
    `fused_gcn_grasp`. QuantGr: `quant` = (wq, w_scale, x_scale, h_scale,
    aq, a_scale) with aq (B?, N, N) s8 and a_scale (B?, N, 1), through
    `fused_gcn_int8`; the wrapper folds sw = x_scale * w_scale, as the
    reference does. x: (B?, N, Fin); w: (Fin, O); b: (O,) or (1, O).
    """
    single = x.dim() == 2
    if single:
        x = x[None]
    n = x.shape[-2]
    b2 = _pad2(b.reshape(1, -1), 1, TILE)
    if block_sparse is not None:
        o = w.shape[-1]
        out = fused_gcn_grasp(*_structure(block_sparse, single),
                              _pad2(x, block_sparse.block_size, TILE),
                              _pad2(w, TILE, TILE), b2, activation)
    elif quant is not None:
        wq, w_scale, x_scale, h_scale, aq, a_scale = quant
        if single:
            aq, a_scale = aq[None], a_scale[None]
        o = wq.shape[-1]
        sw = (x_scale * w_scale).reshape(1, -1)
        out = fused_gcn_int8(
            _pad2(x, TILE, TILE), _pad2(wq, TILE, TILE), _pad2(sw, 1, TILE),
            x_scale.reshape(1, 1), h_scale.reshape(1, 1),
            _pad2(aq, TILE, TILE), _pad2(a_scale.reshape(*aq.shape[:-1], 1),
                                         TILE, 1), b2, activation)
    else:
        if single:
            norm_adj = norm_adj[None]
        o = w.shape[-1]
        out = fused_gcn_dense(_pad2(norm_adj, TILE, TILE),
                              _pad2(x, TILE, TILE), _pad2(w, TILE, TILE), b2,
                              activation)
    out = out[:, :n, :o]
    return out[0] if single else out
