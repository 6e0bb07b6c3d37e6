"""Plain torch oracles for the ported kernels, twins of the reference's
`kernels/ref.py` (`matmul_ref`, and the dense branch of
`fused_gcn_layer_ref`).

They take the unpadded shapes the layers see, not the tile-padded ones the
kernels take, and are written independently of the kernels' plain
versions (ELU through `torch.nn.functional.elu`), so the parity tests hold
each path against a second formulation.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)


def _act_ref(z: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return F.relu(z)
    if activation == "elu":
        return F.elu(z)
    if activation == "none":
        return z
    raise ValueError(f"unknown activation {activation!r}")


def fused_gcn_layer_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                        norm_adj: torch.Tensor,
                        activation: str = "none") -> torch.Tensor:
    """act(Â @ (X @ W) + b) — dense GCN layer twin."""
    h = matmul_ref(x, w, out_dtype=torch.float32)
    return _act_ref(norm_adj @ h + b.reshape(1, -1), activation).to(x.dtype)
