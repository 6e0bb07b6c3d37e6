"""GAT mask builders (StaGr / GrAd), numpy on the host.

Port of the GAT half of the reference's `core/masks.py`: the same arrays,
built the same way, so the port's operands equal the reference's. The
SAGE builders (`sage_sample_adjacency`, `mean_from_mask`,
`max_bias_from_mask`) come with the SAGE kind.
"""
from __future__ import annotations

import numpy as np

NEG_INF = -1e9  # GrAx1 additive mask (paper: "large negative number")


def attention_bias_multiplicative(adj_with_loops: np.ndarray) -> np.ndarray:
    """Exact GAT masking operand: 1 where edge, 0 elsewhere (the exact
    path's `where(mask, scores, NEG_INF)` reads it)."""
    return (adj_with_loops > 0).astype(np.float32)


def attention_bias_additive(adj_with_loops: np.ndarray) -> np.ndarray:
    """GrAx1: additive bias, 0 on edges and NEG_INF off edges, so
    scores + bias stands in for the masked scores with no Select."""
    return np.where(adj_with_loops > 0, 0.0, NEG_INF).astype(np.float32)


def adj_with_self_loops(adj: np.ndarray, num_nodes: int) -> np.ndarray:
    """A copy of `adj` with a self-loop on each of the first `num_nodes`
    nodes; NodePad's padded nodes get none."""
    out = adj.copy()
    idx = np.arange(num_nodes)
    out[idx, idx] = 1.0
    return out
