"""Public kernel entry points of the port: `matmul`, `int8_matmul`,
`bitmap_spmm` (with `bitmap_spmm_batched` and `bitmap_spmm_mode`),
`gat_attention`, `sage_max`, `fused_gcn_layer` (its dense, QuantGr and
GraSp branches), `fused_gat_layer` (fp32 and precombined),
`fused_sage_layer` (mean and max) and `flash_attention`.

Routing follows the tensors' device (`kernels/_launch.py`): CPU tensors run
the kernels' plain versions, CUDA tensors the hand-written kernels or an
exception — no environment override and no fallback. The GCN entries pad
their operands to the 128 tile and strip the result, as the reference's
`ops._pad2` does (a no-op for NodePad'ded graph operands). The GAT entries
take the head width F as it is: the reference pads F to its 128 lanes,
the CUDA kernels take any F up to 64, and the stripped result is the same.
`fused_gat_layer` pads the node dimension to 128 with -1e9 bias rows and
columns, as the reference does. The SAGE entries take N, F and Fin as they
are: the reference pads them with zeros to 128, which adds only zero
mask entries, zero features and zero weight rows, so the stripped result
is the same. Entries accept a leading batch dimension, which stands in
for the reference's `vmap`. `flash_attention` takes its shapes as they
are (the reference's kernel asserts tile multiples).

The GNN kernels have no backward (nor have the reference's Pallas
kernels), so every GNN entry refuses, with `NoBackward`, an operand that
requires grad while grad mode is on: its result would cut the gradient of
whatever lies upstream of that operand. Inside `record_grad_cuts()` the
entry records the operand instead and runs without a path back, on either
device; `train_node_classifier` uses it to name every parameter a forward
cuts. The guard (`_launch.no_backward`) sits on these entries.
`flash_attention`, which this module exports as it is, has a gradient: on
the card its hand-written backward kernel, on the CPU autograd through its
plain version (see its module).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import int8_matmul as _i8
from .bitmap_spmm import bitmap_spmm as _bitmap_spmm
from .block_matmul import block_matmul
from ._launch import (NoBackward, no_backward,  # noqa: F401
                      record_grad_cuts)
from .flash_attention import flash_attention
from .fused_layers import (fused_gat_full, fused_gat_precombined,
                           fused_gcn_dense, fused_gcn_grasp, fused_gcn_int8,
                           fused_sage)
from .gat_attention import gat_attention as _gat_attention
from .ref import NEG_INF
from .sage_max import sage_max as _sage_max

TILE = 128


def _pad2(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    """Zero-pad the last two dims up to multiples of (m0, m1); contiguous."""
    p0 = (-x.shape[-2]) % m0
    p1 = (-x.shape[-1]) % m1
    if p0 == 0 and p1 == 0:
        return x.contiguous()
    return F.pad(x, (0, p1, 0, p0))


@no_backward
def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """StaGr aggregation backbone: C = A @ B through `block_matmul`."""
    m, n = a.shape[-2], b.shape[-1]
    out = block_matmul(_pad2(a, TILE, TILE), _pad2(b, TILE, TILE),
                       out_dtype=out_dtype or a.dtype)
    return out[..., :m, :n]


@no_backward
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


@no_backward
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


@no_backward
def gat_attention(h: torch.Tensor, alpha_dst: torch.Tensor,
                  alpha_src: torch.Tensor,
                  bias_add: torch.Tensor) -> torch.Tensor:
    """Fused EffOp + GrAx1 + GrAx2 GAT attention through the
    `gat_attention` kernel. h: (B?, N, H, F); alpha_dst, alpha_src:
    (B?, N, H); bias_add: (B?, N, N). Returns h's shape."""
    single = h.dim() == 3
    args = [t[None] if single else t
            for t in (h, alpha_dst, alpha_src, bias_add)]
    out = _gat_attention(*(t.contiguous() for t in args))
    return out[0] if single else out


@no_backward
def sage_max(mask01: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """GrAx3 masked max aggregation through the `sage_max` kernel.
    mask01: (B?, M, N) 0/1 (M < N for a shard's row block); h: (B?, N, F)
    >= 0. Returns (B?, M, F)."""
    single = h.dim() == 2
    args = [t[None] if single else t for t in (mask01, h)]
    out = _sage_max(*(t.contiguous() for t in args))
    return out[0] if single else out


@no_backward
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


def _pad_nodes(t: torch.Tensor, npad: int, dim: int) -> torch.Tensor:
    """Append `npad` zero entries to dimension `dim` (negative) of t."""
    if not npad:
        return t.contiguous()
    pad = [0, 0] * (-dim)
    pad[-1] = npad
    return F.pad(t, pad)


@no_backward
def fused_gat_layer(x: Optional[torch.Tensor], w: Optional[torch.Tensor],
                    a_src: torch.Tensor, a_dst: torch.Tensor,
                    bias_add: torch.Tensor, b: torch.Tensor, *,
                    activation: str = "none",
                    precombined: Optional[Tuple[torch.Tensor, ...]] = None
                    ) -> torch.Tensor:
    """Fused GAT layer -> (B?, N, H, F), one kernel call.

    x: (B?, N, Fin); w: (Fin, H, F); a_src/a_dst: (H, F); bias_add:
    (B?, N, N); b: (H, F), through `fused_gat_full`. `precombined` = (h,
    alpha_dst, alpha_src) for the QuantGr tiers, through
    `fused_gat_precombined`: the int8 combine runs outside, attention and
    epilogue stay fused. The node dimension is padded to 128 with -1e9 bias
    rows and columns (padded columns never win a row's softmax; padded
    rows are stripped).
    """
    single = bias_add.dim() == 2
    if single:
        bias_add = bias_add[None]
    n = bias_add.shape[-1]
    npad = (-n) % TILE
    bias_p = F.pad(bias_add, (0, npad, 0, npad), value=NEG_INF)
    b = b.contiguous()
    if precombined is not None:
        h, alpha_dst, alpha_src = (t[None] if single else t
                                   for t in precombined)
        out = fused_gat_precombined(
            _pad_nodes(h, npad, -3), _pad_nodes(alpha_dst, npad, -2),
            _pad_nodes(alpha_src, npad, -2), bias_p, b, activation)
    else:
        out = fused_gat_full(_pad_nodes(x[None] if single else x, npad, -2),
                             w.contiguous(), a_src.contiguous(),
                             a_dst.contiguous(), bias_p, b, activation)
    out = out[:, :n]
    return out[0] if single else out


@no_backward
def fused_sage_layer(x: torch.Tensor, w_self: torch.Tensor,
                     w_neigh: torch.Tensor, b: torch.Tensor, *,
                     mean_mask: Optional[torch.Tensor] = None,
                     sample_mask: Optional[torch.Tensor] = None,
                     pooled: Optional[torch.Tensor] = None,
                     activation: str = "none") -> torch.Tensor:
    """Fused SAGE layer act(X @ Wself + AGG @ Wneigh + b), one kernel call
    (`fused_sage`).

    Mean aggregation: pass `mean_mask`; GrAx3 max aggregation: pass the
    0/1 `sample_mask` plus the non-negative `pooled` features. x, pooled:
    (B?, N, Fin); masks (B?, N, N); w_self, w_neigh: (Fin, O); b: (O,) or
    (1, O).
    """
    aggregator = "mean" if mean_mask is not None else "max"
    mask = mean_mask if mean_mask is not None else sample_mask
    xk = x if mean_mask is not None else pooled
    single = x.dim() == 2
    args = [t[None] if single else t for t in (mask, xk, x)]
    out = fused_sage(*(t.contiguous() for t in args), w_self.contiguous(),
                     w_neigh.contiguous(), b.contiguous(), aggregator,
                     activation)
    return out[0] if single else out

