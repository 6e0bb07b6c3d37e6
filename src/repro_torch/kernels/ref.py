"""Plain torch oracles for the ported kernels, twins of the reference's
`kernels/ref.py` (`matmul_ref`, `int8_matmul_ref`, `bitmap_spmm_ref`,
`bitmap_spmm_block_ref`, `gat_attention_ref`, `sage_max_ref`, the dense
and QuantGr branches of `fused_gcn_layer_ref`, `fused_gcn_grasp_layer_ref`,
`fused_gat_layer_ref`, `fused_sage_layer_ref` and
`flash_attention_ref`), and `flash_attention_bwd_ref`, the plain gradient
of `flash_attention_ref`, which the reference takes by autodiff.

They take the unpadded shapes the layers see, not the tile-padded ones the
kernels take, and are written independently of the kernels' plain
versions (ELU through `torch.nn.functional.elu`, the GAT softmax and the
SAGE masked max through `core.effop`), so the parity tests hold each path
against a second formulation. The GAT twins loop over heads, as the
reference's `fused_gat_layer_ref` does, so one (B?, N, N) score tensor is
alive at a time. Their one shared piece is the exact s8 x s8 -> s32
product `int8_matmul.int_matmul`, which every plain int8 product of the
port goes through.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import effop

from .int8_matmul import int_matmul

NEG_INF = effop.NEG_INF


def matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)


def int8_matmul_ref(xq: torch.Tensor, wq: torch.Tensor, x_scale,
                    w_scale) -> torch.Tensor:
    """INT8 x INT8 -> INT32 accumulate -> FP32 rescale."""
    return int_matmul(xq, wq).to(torch.float32) * (x_scale * w_scale)


def bitmap_spmm_ref(dense_a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """GraSp oracle: the block-compacted form must equal the dense matmul."""
    return (dense_a @ h).to(h.dtype)


def bitmap_spmm_block_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                          counts: torch.Tensor, h: torch.Tensor, *,
                          block_size: int) -> torch.Tensor:
    """GraSp on the compacted form of one graph: gather the H row blocks
    each entry names, and one einsum over the entries masked by
    k < counts."""
    rb, max_nnz = block_cols.shape
    bs = block_size
    f = h.shape[1]
    gathered = h.reshape(-1, bs, f)[block_cols.long()]   # (rb, max_nnz, bs, f)
    blk = blocks.reshape(rb, max_nnz, bs, bs)
    mask = (torch.arange(max_nnz)[None, :] < counts[:, None]).to(blocks.dtype)
    return torch.einsum("rk,rkij,rkjf->rif", mask, blk, gathered
                        ).reshape(rb * bs, f).to(h.dtype)


def gat_attention_ref(h: torch.Tensor, alpha_dst: torch.Tensor,
                      alpha_src: torch.Tensor, bias_add: torch.Tensor, *,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """Fused GAT oracle (EffOp + GrAx1 + GrAx2 dense formulation).

    h: (B?, N, H, F); alpha_dst/alpha_src: (B?, N, H); bias_add: (B?, N, N)
    of 0 / -1e9. out[i, hd] = sum_j softmax_j(leaky(ad[i,hd] + as[j,hd])
    + bias[i,j]) h[j, hd].
    """
    outs = []
    for hd in range(h.shape[-2]):
        e = F.leaky_relu(alpha_dst[..., :, None, hd]
                         + alpha_src[..., None, :, hd], negative_slope)
        e = e + bias_add
        e = e - torch.max(e, dim=-1, keepdim=True).values
        p = torch.exp(e)
        attn = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-12)
        outs.append(torch.einsum("...ij,...jf->...if", attn, h[..., hd, :]))
    return torch.stack(outs, dim=-2)


def sage_max_ref(mask01: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """GrAx3 oracle: out[i, f] = max_j mask[i, j] * h[j, f] (h >= 0;
    rows without a neighbour give 0). mask01: (B?, N, N); h: (B?, N, F)."""
    return effop.masked_max_aggregate(h, mask01, grax3=True)


def _act_ref(z: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return F.relu(z)
    if activation == "elu":
        return F.elu(z)
    if activation == "none":
        return z
    raise ValueError(f"unknown activation {activation!r}")


def fused_gcn_layer_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                        norm_adj: Optional[torch.Tensor] = None, quant=None,
                        activation: str = "none") -> torch.Tensor:
    """act(Â @ (X @ W) + b) — dense GCN layer twin.

    quant: optional (wq, w_scale, x_scale, h_scale, aq, a_scale) for the
    QuantGr tier: quantize X, s8 dot, dequantize, re-quantize H, then
    Âq @ Hq with the per-row dequant, inlined as in the reference twin.
    """
    if quant is not None:
        wq, w_scale, x_scale, h_scale, aq, a_scale = quant
        xq = torch.clamp(torch.round(x / x_scale), -127.0, 127.0
                         ).to(torch.int8)
        h = int8_matmul_ref(xq, wq, x_scale, w_scale)
        hq = torch.clamp(torch.round(h / h_scale), -127.0, 127.0
                         ).to(torch.int8)
        z = (int_matmul(aq, hq).to(torch.float32) * (a_scale * h_scale)
             + b.reshape(1, -1))
        return _act_ref(z, activation)
    h = matmul_ref(x, w, out_dtype=torch.float32)
    return _act_ref(norm_adj @ h + b.reshape(1, -1), activation).to(x.dtype)


def fused_gcn_grasp_layer_ref(blocks: torch.Tensor, block_cols: torch.Tensor,
                              counts: torch.Tensor, x: torch.Tensor,
                              w: torch.Tensor, b: torch.Tensor, *,
                              block_size: int,
                              activation: str = "none") -> torch.Tensor:
    """GraSp GCN layer twin: combine, then the compacted aggregation."""
    h = matmul_ref(x, w, out_dtype=torch.float32)
    agg = bitmap_spmm_block_ref(blocks, block_cols, counts, h,
                                block_size=block_size)
    return _act_ref(agg + b.reshape(1, -1), activation).to(x.dtype)


def fused_gat_layer_ref(x: Optional[torch.Tensor], w: Optional[torch.Tensor],
                        a_src: torch.Tensor, a_dst: torch.Tensor,
                        bias_add: torch.Tensor, b: torch.Tensor, *,
                        negative_slope: float = 0.2,
                        activation: str = "none",
                        precombined=None) -> torch.Tensor:
    """Whole-GAT-layer twin through the EffOp catalogue (GrAx1 + GrAx2).

    x: (B?, N, Fin); w: (Fin, H, F); a_src/a_dst: (H, F); b: (H, F) ->
    (B?, N, H, F). precombined: optional (h, alpha_dst, alpha_src), as the
    QuantGr tiers make them outside.
    """
    if precombined is not None:
        h, alpha_dst, alpha_src = precombined
    else:
        h = torch.einsum("...nf,fhd->...nhd", x, w)
        alpha_src = torch.einsum("...nhf,hf->...nh", h, a_src)
        alpha_dst = torch.einsum("...nhf,hf->...nh", h, a_dst)
    outs = []
    for hd in range(h.shape[-2]):
        e = effop.broadcast_add_scores(alpha_src[..., hd], alpha_dst[..., hd],
                                       grax2=True)
        e = F.leaky_relu(e, negative_slope)
        attn = effop.segment_softmax_dense(e, bias_add)      # GrAx1 mask
        outs.append(attn @ h[..., hd, :] + b[hd])
    return _act_ref(torch.stack(outs, dim=-2), activation)


def fused_sage_layer_ref(mask: torch.Tensor, xk: torch.Tensor,
                         x: torch.Tensor, w_self: torch.Tensor,
                         w_neigh: torch.Tensor, b: torch.Tensor, *,
                         aggregator: str = "mean",
                         activation: str = "none") -> torch.Tensor:
    """SAGE layer twin: mean (M @ X) or GrAx3 masked-max aggregation, both
    combines and the epilogue. xk is X (mean) or the pooled features >= 0
    (max)."""
    if aggregator == "mean":
        agg = mask @ xk
    else:
        agg = effop.masked_max_aggregate(xk, mask, grax3=True)
    return _act_ref(x @ w_self + agg @ w_neigh + b.reshape(1, -1),
                    activation)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Exact GQA attention, the plain version of `flash_attention`: the
    CPU path of the wrapper and the card checks' oracle.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H % KV == 0; query head h
    reads KV head h // (H // KV). `q_offset` is the absolute position of
    q[:, 0]; `window` keeps keys within `window` positions; `softcap` is
    gemma2's tanh capping. The arithmetic is the TPU kernel's: scores in
    float32 from the operands' exact products, times `scale` (default
    D^-1/2), capped, masked to -1e9 (a number, so a row that no key may
    reach averages every key uniformly), softmax in float32, the weights
    rounded to v's dtype, the product summed in float32, the result in q's
    dtype.
    """
    b, sq, hh, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = hh // kvh
    scale = scale if scale is not None else d ** -0.5
    kr = k.repeat_interleave(group, dim=2).float()
    vr = v.repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, NEG_INF)
    attn = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", attn, vr.float())
    return out.to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None,
                            q_offset: int = 0):
    """(dq, dk, dv) of `flash_attention_ref` for the output gradient
    `dout`: `torch.autograd.grad` through it, the plain version of
    `flash_attention_bwd` and the oracle of its checks. Its roundings are
    autograd's of the plain forward's casts: the weights' gradient
    rounded to v's dtype, and a GQA group's dk and dv summed in the
    operands' dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal, window=window,
                                  softcap=softcap, scale=scale,
                                  q_offset=q_offset)
        return torch.autograd.grad(out, leaves, dout)
