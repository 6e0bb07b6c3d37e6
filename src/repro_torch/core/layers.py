"""GCN, GAT and GraphSAGE layers on the GraNNite path (StaGr / PreG /
EffOp / GrAx).

Port of the GraNNite parts of the reference's `core/layers.py`:
`Techniques` keeps every flag so plan keys compare like the reference's.
The GCN functions carry the fp32 dense branches, the QuantGr branches
(int8 combine and int8 aggregation, through the `int8_matmul` and
`fused_gcn_int8` kernels on the card) and the GraSp branches (the
block-sparse aggregation, through `bitmap_spmm` and `fused_gcn_grasp`).
The GAT functions carry every branch of the reference's `gat_grannite`
(the `gat_attention` kernel with `use_pallas`, GrAx1 or exact masking,
GrAx2 or exact broadcast, the QuantGr int8 combine) and its fused twin
(`fused_gat_full`, or `fused_gat_precombined` after an int8 combine).
The SAGE functions carry every branch of the reference's `sage_grannite`
(mean through `block_matmul` and max through the `sage_max` kernel with
`use_pallas`, the exact and GrAx3 masked max, the QuantGr `self`, `neigh`
and `pool` combines through `int8_matmul`) and its fused twin
(`fused_sage`; QuantGr SAGE does not fuse). The baseline edge-list layers
come later.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from . import effop
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
    # int8_matmul kernels and GAT attention through gat_attention (name
    # kept from the reference so plan keys line up)

    @staticmethod
    def full_gat() -> "Techniques":
        return Techniques(stagr=True, graphsplit=True, effop=True,
                          grax1=True, grax2=True)

    @staticmethod
    def full_sage() -> "Techniques":
        return Techniques(stagr=True, graphsplit=True, effop=True, grax3=True)


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


# =========================================================================
# GAT (single layer, H heads)
# =========================================================================

def gat_init(gen: torch.Generator, in_feats: int, out_feats: int,
             heads: int, *, device=None) -> Dict[str, torch.Tensor]:
    return {"w": glorot(gen, (in_feats, heads * out_feats), device=device),
            "a_src": glorot(gen, (heads, out_feats), device=device),
            "a_dst": glorot(gen, (heads, out_feats), device=device),
            "b": torch.zeros(heads * out_feats, dtype=torch.float32,
                             device=device)}


def _gat_head_feats(params: Dict, x: torch.Tensor, heads: int,
                    out_feats: int) -> torch.Tensor:
    h = x @ params["w"]
    return h.reshape(*x.shape[:-1], heads, out_feats)


def _alphas(params: Dict, h: torch.Tensor):
    """The per-node score terms (alpha_src, alpha_dst), each (B?, N, H)."""
    return (torch.einsum("...nhf,hf->...nh", h, params["a_src"]),
            torch.einsum("...nhf,hf->...nh", h, params["a_dst"]))


def gat_grannite(params: Dict, x: torch.Tensor, mask_mult: torch.Tensor,
                 bias_add: torch.Tensor, t: Techniques, *, heads: int,
                 out_feats: int, concat: bool = True,
                 quant: Optional[QuantizedLinear] = None) -> torch.Tensor:
    """EffOp dense GAT: scores as a broadcast add, dense masked softmax,
    aggregation as a product. GrAx1 picks additive masking, GrAx2 the
    fused broadcast ordering; `t.use_pallas` runs the whole
    score -> softmax -> aggregate pipeline through the `gat_attention`
    kernel. QuantGr quantizes the combine X @ W (through `int8_matmul`
    with `use_pallas`); scores and softmax stay fp32.

    x: (B?, N, Fin); mask_mult, bias_add: (B?, N, N).
    """
    if t.quantgr and quant is not None:
        h = apply_quantized_linear(x, quant, use_kernel=t.use_pallas)
        h = h.reshape(*x.shape[:-1], heads, out_feats)
    else:
        h = _gat_head_feats(params, x, heads, out_feats)   # (B?, N, H, F)
    alpha_src, alpha_dst = _alphas(params, h)

    if t.use_pallas:
        out = kops.gat_attention(h, alpha_dst, alpha_src, bias_add)
    else:
        outs = []
        for hd in range(heads):            # heads unrolled; N x N per head
            e = effop.broadcast_add_scores(alpha_src[..., hd],
                                           alpha_dst[..., hd], grax2=t.grax2)
            e = F.leaky_relu(e, 0.2)
            if t.grax1:
                attn = effop.segment_softmax_dense(e, bias_add)
            else:
                e = effop.masked_select_exact(e, mask_mult)
                attn = torch.softmax(e, dim=-1)
            outs.append(attn @ h[..., hd, :])
        out = torch.stack(outs, dim=-2)                     # (B?, N, H, F)
    if concat:
        return out.reshape(*out.shape[:-2], heads * out_feats) + params["b"]
    return out.mean(dim=-2)


def gat_grannite_fused(params: Dict, x: torch.Tensor, bias_add: torch.Tensor,
                       t: Techniques, *, heads: int, out_feats: int,
                       activation: str = "none",
                       quant: Optional[QuantizedLinear] = None
                       ) -> torch.Tensor:
    """Fused twin of `gat_grannite` (concat form): the whole layer through
    `fused_gat_full` on fp32 tiers; QuantGr keeps the int8 combine outside
    and fuses attention, bias and activation (`fused_gat_precombined`)."""
    b = params["b"].reshape(heads, out_feats)
    if t.quantgr and quant is not None:
        h = apply_quantized_linear(x, quant, use_kernel=t.use_pallas)
        h = h.reshape(*x.shape[:-1], heads, out_feats)
        alpha_src, alpha_dst = _alphas(params, h)
        out = kops.fused_gat_layer(None, None, params["a_src"],
                                   params["a_dst"], bias_add, b,
                                   activation=activation,
                                   precombined=(h, alpha_dst, alpha_src))
    else:
        w3 = params["w"].reshape(x.shape[-1], heads, out_feats)
        out = kops.fused_gat_layer(x, w3, params["a_src"], params["a_dst"],
                                   bias_add, b, activation=activation)
    return out.reshape(*out.shape[:-2], heads * out_feats)


# =========================================================================
# GraphSAGE (mean / max aggregators)
# =========================================================================

def sage_init(gen: torch.Generator, in_feats: int, out_feats: int, *,
              aggregator: str, device=None) -> Dict[str, torch.Tensor]:
    """w_self, w_neigh (Fin, O) and b; max adds the pool combine w_pool
    (Fin, Fin) and b_pool."""
    p = {"w_self": glorot(gen, (in_feats, out_feats), device=device),
         "w_neigh": glorot(gen, (in_feats, out_feats), device=device),
         "b": torch.zeros(out_feats, dtype=torch.float32, device=device)}
    if aggregator == "max":
        p["w_pool"] = glorot(gen, (in_feats, in_feats), device=device)
        p["b_pool"] = torch.zeros(in_feats, dtype=torch.float32,
                                  device=device)
    return p


def _sage_lin(v: torch.Tensor, w: torch.Tensor,
              ql: Optional[QuantizedLinear], use_kernel: bool
              ) -> torch.Tensor:
    if ql is not None:
        return apply_quantized_linear(v, ql, use_kernel=use_kernel)
    return v @ w


def _sage_pooled(params: Dict, x: torch.Tensor,
                 ql: Optional[QuantizedLinear], use_kernel: bool
                 ) -> torch.Tensor:
    """The max aggregator's pool combine relu(x @ w_pool + b_pool)."""
    return F.relu(_sage_lin(x, params["w_pool"], ql, use_kernel)
                  + params["b_pool"])


def sage_grannite(params: Dict, x: torch.Tensor, sample_mask: torch.Tensor,
                  mean_mask: torch.Tensor, t: Techniques, *,
                  aggregator: str,
                  quant: Optional[Dict] = None) -> torch.Tensor:
    """StaGr sampled-adjacency SAGE: mean is the mask product (through
    `block_matmul` with `t.use_pallas`); max is the pool combine, then the
    masked max (the `sage_max` kernel with `t.use_pallas` and `t.grax3`,
    else `effop.masked_max_aggregate`, GrAx3 or exact by `t.grax3`).

    QuantGr quantizes the three combines (`self`, `neigh` and `pool` keys
    of `quant`, each a QuantizedLinear; through `int8_matmul` with
    `t.use_pallas`); the aggregation stays fp32.

    x: (B?, N, Fin); sample_mask, mean_mask: (B?, N, N).
    """
    q = quant if (t.quantgr and quant is not None) else {}
    if aggregator == "mean":
        agg = (kops.matmul(mean_mask, x) if t.use_pallas
               else mean_mask @ x)
    elif aggregator == "max":
        pooled = _sage_pooled(params, x, q.get("pool"), t.use_pallas)
        if t.use_pallas and t.grax3:
            agg = kops.sage_max(sample_mask, pooled)
        else:
            agg = effop.masked_max_aggregate(pooled, sample_mask,
                                             grax3=t.grax3)
    else:
        raise ValueError(aggregator)
    return (_sage_lin(x, params["w_self"], q.get("self"), t.use_pallas)
            + _sage_lin(agg, params["w_neigh"], q.get("neigh"), t.use_pallas)
            + params["b"])


def sage_grannite_fused(params: Dict, x: torch.Tensor,
                        sample_mask: torch.Tensor, mean_mask: torch.Tensor,
                        t: Techniques, *, aggregator: str,
                        activation: str = "none",
                        quant: Optional[Dict] = None) -> torch.Tensor:
    """Fused twin of `sage_grannite`: the mean or GrAx3 masked-max
    aggregation, both combines and the epilogue in one `fused_sage` call
    (max computes its pooled features first, as the reference does).
    QuantGr SAGE cannot fuse (the neighbour combine consumes the
    aggregation and all three combines are int8): the unfused tier math
    runs with the activation folded here."""
    if t.quantgr and quant is not None:
        return _apply_act(sage_grannite(params, x, sample_mask, mean_mask, t,
                                        aggregator=aggregator, quant=quant),
                          activation)
    if aggregator == "mean":
        return kops.fused_sage_layer(x, params["w_self"], params["w_neigh"],
                                     params["b"], mean_mask=mean_mask,
                                     activation=activation)
    pooled = _sage_pooled(params, x, None, False)
    return kops.fused_sage_layer(x, params["w_self"], params["w_neigh"],
                                 params["b"], sample_mask=sample_mask,
                                 pooled=pooled, activation=activation)
