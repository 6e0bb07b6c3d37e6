"""GCN layers on the GraNNite dense path (StaGr / PreG), fp32.

Port of the GCN part of the reference's `core/layers.py`: `Techniques`
keeps every flag so plan keys compare like the reference's, and the layer
functions carry the fp32 dense branches only. QuantGr and GraSp inputs
raise until ROADMAP queue 2's int8 and GraSp kernels (queue 1 items 5-6)
are ported; the baseline edge-list layers, GAT and SAGE come later too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class Techniques:
    """Which GraNNite techniques are active (paper Fig. 7 suite)."""
    stagr: bool = False        # dense precomputed-mask aggregation
    grad_dynamic: bool = False  # masks as runtime inputs (vs baked constants)
    graphsplit: bool = False   # host-side preprocessing (PreG on CPU)
    grasp: bool = False        # block-sparse bitmap aggregation kernel
    quantgr: bool = False      # INT8 combine matmuls
    effop: bool = False        # dense masked attention / max instead of gather
    grax1: bool = False        # additive attention mask
    grax2: bool = False        # fused broadcast-add ordering
    grax3: bool = False        # SAGE-max as mask-mul + maxpool
    use_pallas: bool = False   # route matmuls through the block_matmul kernel
    # (name kept from the reference so plan keys line up)


def glorot(gen: torch.Generator, shape, *, device=None) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (u * (2.0 * lim) - lim).to(device)


def gcn_init(gen: torch.Generator, in_feats: int, out_feats: int, *,
             device=None) -> Dict[str, torch.Tensor]:
    return {"w": glorot(gen, (in_feats, out_feats), device=device),
            "b": torch.zeros(out_feats, dtype=torch.float32, device=device)}


def _dense_only(quant, block_sparse) -> None:
    if quant is not None:
        raise NotImplementedError(
            "QuantGr GCN layers are not ported yet (ROADMAP queue 1 item 5, "
            "queue 2 int8_matmul / fused_gcn_int8)")
    if block_sparse is not None:
        raise NotImplementedError(
            "GraSp aggregation is not ported yet (ROADMAP queue 1 item 6, "
            "queue 2 bitmap_spmm / fused_gcn_grasp)")


def gcn_grannite(params: Dict, x: torch.Tensor, norm_adj: torch.Tensor,
                 t: Techniques, *, quant=None,
                 block_sparse=None) -> torch.Tensor:
    """StaGr/PreG path: out = Â @ (X W) + b — two dense matmuls, through
    the `block_matmul` kernel when `t.use_pallas`, else plain matmuls.

    x: (B?, N, Fin); norm_adj: (B?, N, N).
    """
    _dense_only(quant, block_sparse)
    if t.use_pallas:
        h = kops.matmul(x, params["w"])
        agg = kops.matmul(norm_adj, h)
    else:
        agg = norm_adj @ (x @ params["w"])
    return agg + params["b"]


def gcn_grannite_fused(params: Dict, x: torch.Tensor, norm_adj: torch.Tensor,
                       t: Techniques, *, activation: str = "none",
                       quant=None, block_sparse=None) -> torch.Tensor:
    """Fused twin of `gcn_grannite`: one `fused_gcn_dense` call per layer,
    bias and activation in the kernel's epilogue."""
    _dense_only(quant, block_sparse)
    return kops.fused_gcn_layer(x, params["w"], params["b"],
                                norm_adj=norm_adj, activation=activation)
