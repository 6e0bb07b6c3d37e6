"""GAT and SAGE mask builders (StaGr / GrAd), numpy on the host.

Port of the reference's `core/masks.py`: the same arrays, built the same
way, so the port's operands equal the reference's bit for bit — the SAGE
sample included, which draws from `np.random.default_rng(0)` on every
call unless the caller passes a generator.
"""
from __future__ import annotations

from typing import Optional

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


def sage_sample_adjacency(adj: np.ndarray, num_nodes: int, *,
                          max_neighbors: int,
                          rng: Optional[np.random.Generator] = None,
                          include_self: bool = True) -> np.ndarray:
    """StaGr for GraphSAGE: a precomputed *sampled* 0/1 (cap, cap) mask.

    Each of the first `num_nodes` rows keeps up to `max_neighbors` of its
    in-neighbours, uniformly without replacement: every edge draws one
    uniform key and the row keeps its smallest-keyed columns (one
    argpartition over the matrix). Self-loops go on the real nodes only,
    so NodePad's rows stay empty. Deterministic for a seeded `rng`
    (default: seed 0 on every call).
    """
    rng = rng or np.random.default_rng(0)
    cap = adj.shape[0]
    out = np.zeros_like(adj)
    if num_nodes > 0 and max_neighbors > 0:
        live = adj[:num_nodes] > 0
        keys = np.where(live, rng.random((num_nodes, cap)), np.inf)
        kth = min(max_neighbors, cap - 1)
        kept = np.argpartition(keys, kth, axis=1)[:, :max_neighbors]
        rows = np.repeat(np.arange(num_nodes), kept.shape[1])
        cols = kept.reshape(-1)
        picked = live[rows, cols]          # rows with < k neighbours: inf
        out[rows[picked], cols[picked]] = 1.0
    if include_self:
        idx = np.arange(num_nodes)
        out[idx, idx] = 1.0
    return out


def mean_from_mask(mask: np.ndarray) -> np.ndarray:
    """Row-normalize a 0/1 sampled mask: the mean-aggregation operand."""
    deg = mask.sum(axis=1, keepdims=True)
    return (mask / np.maximum(deg, 1.0)).astype(np.float32)


def max_bias_from_mask(mask: np.ndarray) -> np.ndarray:
    """Additive bias for the exact masked max: 0 on edges, NEG_INF off."""
    return np.where(mask > 0, 0.0, NEG_INF).astype(np.float32)
