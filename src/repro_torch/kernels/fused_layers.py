"""Fused per-layer GCN kernel: act(Â @ (X @ W) + b) in one wrapper call.

Port of the TPU kernel `fused_gcn_dense` (reference
`kernels/fused_layers.py`) as hand-written CUDA C++ for `sm_90a`
(`csrc/fused_gcn_dense.cu`). The TPU kernel kept H = X @ W in VMEM, filled
by row-block 0 and read by the later ones in grid order; a CUDA grid has no
order, so the port runs a combine launch into an H scratch tensor (L2
resident at serving widths) and an aggregate launch with bias and
activation fused into its store. Both launches run on the current stream
inside one call to `fused_gcn_dense`, which counts one in `LAUNCHES`.

The other fused kernels of the reference (int8, GraSp, GAT, SAGE) are not
ported yet.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import check_cuda_f32, check_int32, launch, on_cpu

LAUNCHES = 0                      # calls of `fused_gcn_dense` that launched
ACTIVATIONS = {"none": 0, "relu": 1, "elu": 2}   # the kernel's `act` codes


def _act(z: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.clamp_min(z, 0.0)
    if activation == "elu":
        return torch.where(z > 0, z, torch.expm1(z))
    if activation == "none":
        return z
    raise ValueError(f"unknown activation {activation!r}")


def fused_gcn_dense_plain(norm_adj: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, b: torch.Tensor,
                          activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version: combine, aggregate, bias and activation as
    separate ops."""
    h = torch.matmul(x, w)
    return _act(torch.matmul(norm_adj, h) + b.reshape(1, -1), activation)


def fused_gcn_dense(norm_adj: torch.Tensor, x: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor,
                    activation: str = "none") -> torch.Tensor:
    """act(Â @ (X @ W) + b) over a leading batch of graphs.

    norm_adj: (B, N, N); x: (B, N, Fin); w: (Fin, O); b: (O,) or (1, O).
    Returns (B, N, O) float32.
    """
    global LAUNCHES
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; pick from "
                         f"{sorted(ACTIVATIONS)}")
    if on_cpu(norm_adj, x, w, b):
        return fused_gcn_dense_plain(norm_adj, x, w, b, activation)
    device = check_cuda_f32("fused_gcn_dense", norm_adj=norm_adj, x=x, w=w,
                            b=b)
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"fused_gcn_dense: x must be (B, N, Fin) and w "
                         f"(Fin, O), got {tuple(x.shape)}, {tuple(w.shape)}")
    batch, n, fin = x.shape
    o = w.shape[1]
    if (tuple(norm_adj.shape) != (batch, n, n) or w.shape[0] != fin
            or b.numel() != o):
        raise ValueError(
            f"fused_gcn_dense: shapes do not agree: norm_adj "
            f"{tuple(norm_adj.shape)}, x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, b {tuple(b.shape)}")
    out = torch.empty(batch, n, o, dtype=torch.float32, device=device)
    if out.numel():
        check_int32("fused_gcn_dense", batch=batch, n=n, fin=fin, o=o)
        h = torch.empty_like(out)            # combine scratch, L2 resident
        launch("fused_gcn_dense", _build.load("fused_gcn_dense"), device,
               norm_adj.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
               h.data_ptr(), out.data_ptr(), batch, n, fin, o,
               ACTIVATIONS[activation])
        LAUNCHES += 1
    return out
