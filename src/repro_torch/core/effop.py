"""EffOp: control-heavy ops rewritten as data-parallel masked arithmetic.

Port of the GAT half of the reference's `core/effop.py` on tensors with
any leading batch dimensions:

  where(mask, x, -inf)      -> x + additive_bias          (GrAx1)
  a_src[i] + a_dst[j] edge  -> outer broadcast-add         (GrAx2 ordering)
  segment softmax           -> dense row softmax with an additive mask

The exact forms (`masked_select_exact`, `broadcast_add_scores(grax2=
False)`) keep the reference's Select and its transpose-then-add ordering.
`masked_max_aggregate` (GrAx3) and `one_hot_gather` come with the SAGE
kind and the baselines.
"""
from __future__ import annotations

import torch

NEG_INF = -1e9


def masked_select_add(scores: torch.Tensor,
                      additive_bias: torch.Tensor) -> torch.Tensor:
    """GrAx1: replace where(mask, scores, -inf) with scores + bias."""
    return scores + additive_bias


def masked_select_exact(scores: torch.Tensor,
                        mask01: torch.Tensor) -> torch.Tensor:
    """Exact (baseline) masking: multiplicative mask, then a Select."""
    return torch.where(mask01 > 0, scores * mask01,
                       torch.full_like(scores, NEG_INF))


def broadcast_add_scores(src_term: torch.Tensor, dst_term: torch.Tensor,
                         *, grax2: bool = True) -> torch.Tensor:
    """GAT edge logits e[..., i, j] = dst_term[..., i] + src_term[..., j].

    The exact path (grax2=False) materializes the dst broadcast and the
    transposed src broadcast, then adds; GrAx2 is one broadcast add. The
    results are equal."""
    if grax2:
        return dst_term[..., :, None] + src_term[..., None, :]
    n_dst, n_src = dst_term.shape[-1], src_term.shape[-1]
    lead = dst_term.shape[:-1]
    d = dst_term[..., :, None].expand(*lead, n_dst, n_src)
    s = src_term[..., :, None].expand(*lead, n_src, n_dst).transpose(-1, -2)
    return d + s


def segment_softmax_dense(logits: torch.Tensor,
                          additive_bias: torch.Tensor) -> torch.Tensor:
    """Dense row softmax with additive masking, EffOp's replacement for a
    per-destination segment softmax over edge lists."""
    z = logits + additive_bias
    z = z - z.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(z)
    return e / torch.clamp_min(e.sum(dim=-1, keepdim=True), 1e-12)
