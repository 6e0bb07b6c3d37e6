"""Public kernel entry points of the port: `matmul` and `fused_gcn_layer`.

Routing follows the tensors' device (`kernels/_launch.py`): CPU tensors run
the kernels' plain versions, CUDA tensors the hand-written kernels or an
exception — no environment override and no fallback. Every entry pads its
operands to the 128 tile and strips the result, as the reference's
`ops._pad2` does (a no-op for NodePad'ded graph operands). Entries accept a
leading batch dimension, which stands in for the reference's `vmap`.

The other entries of the reference's `ops.py` (int8, GraSp, GAT, SAGE,
flash attention) are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .block_matmul import block_matmul
from .fused_layers import fused_gcn_dense

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


def fused_gcn_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    norm_adj: torch.Tensor,
                    activation: str = "none") -> torch.Tensor:
    """Fused dense GCN layer act(Â @ (X @ W) + b) through `fused_gcn_dense`.

    x: (B?, N, Fin); norm_adj: (B?, N, N); w: (Fin, O); b: (O,) or (1, O).
    """
    single = x.dim() == 2
    if single:
        x, norm_adj = x[None], norm_adj[None]
    n, o = x.shape[-2], w.shape[-1]
    out = fused_gcn_dense(_pad2(norm_adj, TILE, TILE), _pad2(x, TILE, TILE),
                          _pad2(w, TILE, TILE),
                          _pad2(b.reshape(1, -1), 1, TILE), activation)
    out = out[:, :n, :o]
    return out[0] if single else out
