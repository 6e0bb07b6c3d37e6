"""GCN layers on the GraNNite path (StaGr / PreG): fp32 dense, QuantGr and
GraSp.

Port of the GCN part of the reference's `core/layers.py`: `Techniques`
keeps every flag so plan keys compare like the reference's, and the layer
functions carry the fp32 dense branches, the QuantGr branches (int8
combine and int8 aggregation, through the `int8_matmul` and
`fused_gcn_int8` kernels on the card) and the GraSp branches (the
block-sparse aggregation, through `bitmap_spmm` and `fused_gcn_grasp`).
The baseline edge-list layers, GAT and SAGE come later.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .quant import (QuantizedAgg, QuantizedLinear, apply_quantized_agg,
                    apply_quantized_linear, quantize_agg_dynamic)


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
    use_pallas: bool = False   # route matmuls through the block_matmul /
    # int8_matmul kernels (name kept from the reference so plan keys line up)


def glorot(gen: torch.Generator, shape, *, device=None) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (u * (2.0 * lim) - lim).to(device)


def gcn_init(gen: torch.Generator, in_feats: int, out_feats: int, *,
             device=None) -> Dict[str, torch.Tensor]:
    return {"w": glorot(gen, (in_feats, out_feats), device=device),
            "b": torch.zeros(out_feats, dtype=torch.float32, device=device)}


def gcn_grannite(params: Dict, x: torch.Tensor, norm_adj: torch.Tensor,
                 t: Techniques, *, quant: Optional[QuantizedLinear] = None,
                 quant_agg: Optional[QuantizedAgg] = None,
                 agg_h_scale: Optional[torch.Tensor] = None,
                 tier_aq: Optional[torch.Tensor] = None,
                 tier_a_scale: Optional[torch.Tensor] = None,
                 block_sparse=None) -> torch.Tensor:
    """StaGr/PreG path: out = Â @ (X W) + b — two dense matmuls, through
    the `block_matmul` kernel when `t.use_pallas`, else plain matmuls.

    GraSp (`t.grasp` with `block_sparse`, a `core.sparsity.BlockSparse`
    batched like x) aggregates through the `bitmap_spmm` kernel; the
    QuantGr aggregation forms take precedence over it, as in the
    reference.

    QuantGr (`t.quantgr` with `quant`) makes the combine an int8 chain,
    and the aggregation has three QuantGr forms, identical for the same Â:
    `quant_agg` (offline QuantizedAgg of one graph); `agg_h_scale` with
    `tier_aq`/`tier_a_scale` (serving tiers: int8 Â derived once per
    structure version); or `agg_h_scale` alone (Â quantized in the
    forward, `quantize_agg_dynamic`). With `t.use_pallas` the int8
    products run through the `int8_matmul` kernel.

    x: (B?, N, Fin); norm_adj, tier_aq: (B?, N, N); tier_a_scale (B?, N, 1).
    """
    if t.quantgr and quant is not None:
        h = apply_quantized_linear(x, quant, use_kernel=t.use_pallas)
    elif t.use_pallas:
        h = kops.matmul(x, params["w"])
    else:
        h = x @ params["w"]

    if t.quantgr and quant_agg is not None:
        agg = apply_quantized_agg(quant_agg, h, use_kernel=t.use_pallas)
    elif t.quantgr and agg_h_scale is not None:
        if tier_aq is not None:
            qa = QuantizedAgg(aq=tier_aq, a_scale=tier_a_scale,
                              h_scale=agg_h_scale)
        else:
            qa = quantize_agg_dynamic(norm_adj, agg_h_scale)
        agg = apply_quantized_agg(qa, h, use_kernel=t.use_pallas)
    elif t.grasp and block_sparse is not None:
        agg = kops.bitmap_spmm(block_sparse, h)
    elif t.use_pallas:
        agg = kops.matmul(norm_adj, h)
    else:
        agg = norm_adj @ h
    return agg + params["b"]


def _apply_act(z: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return F.relu(z)
    if activation == "elu":
        return F.elu(z)
    if activation == "none":
        return z
    raise ValueError(f"unknown activation {activation!r}")


def gcn_grannite_fused(params: Dict, x: torch.Tensor, norm_adj: torch.Tensor,
                       t: Techniques, *, activation: str = "none",
                       quant: Optional[QuantizedLinear] = None,
                       quant_agg: Optional[QuantizedAgg] = None,
                       agg_h_scale: Optional[torch.Tensor] = None,
                       tier_aq: Optional[torch.Tensor] = None,
                       tier_a_scale: Optional[torch.Tensor] = None,
                       block_sparse=None) -> torch.Tensor:
    """Fused twin of `gcn_grannite`: one kernel call per layer, bias and
    activation in the kernel's epilogue — `fused_gcn_int8` for QuantGr
    (same aggregation forms and precedence), `fused_gcn_grasp` for GraSp
    (`t.grasp` with `block_sparse`), else `fused_gcn_dense`."""
    if t.quantgr and quant is not None:
        if quant_agg is not None:
            qa = quant_agg
        elif agg_h_scale is not None:
            if tier_aq is not None:
                qa = QuantizedAgg(aq=tier_aq, a_scale=tier_a_scale,
                                  h_scale=agg_h_scale)
            else:
                qa = quantize_agg_dynamic(norm_adj, agg_h_scale)
        else:
            # no aggregation scales: nothing past the combine can fuse —
            # the unfused tier math runs with the activation folded here
            return _apply_act(gcn_grannite(params, x, norm_adj, t,
                                           quant=quant), activation)
        qt = (quant.wq, quant.w_scale, quant.x_scale, qa.h_scale, qa.aq,
              qa.a_scale)
        return kops.fused_gcn_layer(x, params["w"], params["b"], quant=qt,
                                    activation=activation)
    if t.grasp and block_sparse is not None:
        return kops.fused_gcn_layer(x, params["w"], params["b"],
                                    block_sparse=block_sparse,
                                    activation=activation)
    return kops.fused_gcn_layer(x, params["w"], params["b"],
                                norm_adj=norm_adj, activation=activation)
