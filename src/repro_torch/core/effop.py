"""EffOp: control-heavy ops rewritten as data-parallel masked arithmetic.

Port of the reference's `core/effop.py` on tensors with any leading batch
dimensions:

  where(mask, x, -inf)      -> x + additive_bias          (GrAx1)
  a_src[i] + a_dst[j] edge  -> outer broadcast-add         (GrAx2 ordering)
  segment softmax           -> dense row softmax with an additive mask
  segment_max(msg, dst)     -> max over mask * msg         (GrAx3)

The exact forms (`masked_select_exact`, `broadcast_add_scores(grax2=
False)`, `masked_max_aggregate(grax3=False)`) keep the reference's Select,
its transpose-then-add ordering and its -1e9-bias max. `one_hot_gather`
comes with the baselines.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e9
# largest (..., rows, cols, F) transient `masked_max_aggregate` forms at once
MAX_BLOCK_BYTES = 1 << 28


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


def masked_max_aggregate(h: torch.Tensor, mask01: torch.Tensor, *,
                         grax3: bool = True) -> torch.Tensor:
    """SAGE-max aggregation over a 0/1 sampled adjacency.

    GrAx3 (paper Fig. 18): the broadcast product mask * h, then a max over
    the columns; right whenever h >= 0 (after ReLU it is). The exact form
    adds a 0 / NEG_INF bias instead and gives 0 to rows without a
    neighbour, for any sign of h.

    h: (..., cols, F); mask01: (..., rows, cols), the same leading dims.
    The (..., rows, cols, F) transient is formed a block of rows at a time,
    at most MAX_BLOCK_BYTES each (the reference streams 128-row blocks; a
    max is exact, so any block size gives the same result).
    """
    n, cols = mask01.shape[-2:]
    per_row = 4 * cols * h.shape[-1] * math.prod(mask01.shape[:-2])
    rb = max(1, min(n, MAX_BLOCK_BYTES // max(per_row, 1)))
    out = h.new_empty((*mask01.shape[:-1], h.shape[-1]))
    for r0 in range(0, n, rb):
        mrows = mask01[..., r0:r0 + rb, :]
        if grax3:
            agg = (mrows[..., :, :, None] * h[..., None, :, :]).amax(dim=-2)
        else:
            bias = torch.where(mrows > 0, 0.0, NEG_INF)
            agg = (h[..., None, :, :] + bias[..., :, :, None]).amax(dim=-2)
            has_nbr = mrows.sum(dim=-1, keepdim=True) > 0
            agg = torch.where(has_nbr, agg, 0.0)
        out[..., r0:r0 + rb, :] = agg
    return out


def segment_softmax_dense(logits: torch.Tensor,
                          additive_bias: torch.Tensor) -> torch.Tensor:
    """Dense row softmax with additive masking, EffOp's replacement for a
    per-destination segment softmax over edge lists."""
    z = logits + additive_bias
    z = z - z.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(z)
    return e / torch.clamp_min(e.sum(dim=-1, keepdim=True), 1e-12)
