"""Synthetic Planetoid-shaped graph datasets (no downloads) — numpy, seeded.

A copy of the reference package's generators: the same seed gives the
same arrays in both packages, which is what the parity tests rely on.

Generates graphs with the exact shape statistics of the paper's datasets
(Cora: 2708 nodes / 5429 edges / 1433 feats / 7 classes; Citeseer: 3327 /
4732 / 3703 / 6) and *learnable* class structure: a stochastic block model
whose communities correlate with both labels and sparse class-conditioned
features. 2-layer GNNs reach high accuracy on it, so QuantGr / GrAx quality
deltas are meaningful, which is what the paper's accuracy tables need.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.graph import Graph


def planetoid_like(*, num_nodes: int, num_edges: int, num_feats: int,
                   num_classes: int, seed: int = 0, homophily: float = 0.9,
                   feat_sparsity: float = 0.98, train_per_class: int = 20,
                   test_frac: float = 0.35) -> Graph:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)

    # --- edges: homophilous SBM, drawn without replacement ------------------
    src = rng.integers(0, num_nodes, size=num_edges * 3)
    same = rng.random(num_edges * 3) < homophily
    dst = np.where(
        same,
        _random_same_class(rng, labels, src, num_classes),
        rng.integers(0, num_nodes, size=src.shape[0]),
    )
    keep = src != dst
    edges = np.unique(np.stack([src[keep], dst[keep]]), axis=1)[:, :num_edges]
    # symmetrize (undirected, as Planetoid) and dedupe the directed set —
    # duplicate edges would double-count in segment-sum baselines
    edge_index = np.unique(np.concatenate([edges, edges[::-1]], axis=1),
                           axis=1).astype(np.int32)

    # --- features: sparse bag-of-words with class-specific vocabulary -------
    feats = np.zeros((num_nodes, num_feats), dtype=np.float32)
    words_per_class = num_feats // num_classes
    nnz_per_node = max(int(num_feats * (1.0 - feat_sparsity)), 4)
    for i in range(num_nodes):
        c = labels[i]
        lo = c * words_per_class
        own = rng.integers(lo, lo + words_per_class, size=nnz_per_node * 3 // 4)
        noise = rng.integers(0, num_feats, size=nnz_per_node // 4)
        feats[i, np.concatenate([own, noise])] = 1.0
    # row-normalize (standard Planetoid preprocessing)
    feats /= np.maximum(feats.sum(axis=1, keepdims=True), 1.0)

    # --- Planetoid-style split ----------------------------------------------
    train_mask = np.zeros(num_nodes, dtype=bool)
    for c in range(num_classes):
        idx = np.nonzero(labels == c)[0]
        train_mask[rng.choice(idx, size=min(train_per_class, len(idx)),
                              replace=False)] = True
    rest = np.nonzero(~train_mask)[0]
    test_idx = rng.choice(rest, size=int(num_nodes * test_frac), replace=False)
    test_mask = np.zeros(num_nodes, dtype=bool)
    test_mask[test_idx] = True

    return Graph(edge_index=edge_index, num_nodes=num_nodes, features=feats,
                 labels=labels, train_mask=train_mask, test_mask=test_mask)


def _random_same_class(rng, labels, src, num_classes):
    """For each src node pick a random node of the same class."""
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    starts = np.searchsorted(sorted_labels, np.arange(num_classes))
    ends = np.searchsorted(sorted_labels, np.arange(num_classes), side="right")
    c = labels[src]
    span = np.maximum(ends[c] - starts[c], 1)
    pick = starts[c] + (rng.integers(0, 1 << 30, size=src.shape[0]) % span)
    return order[pick].astype(src.dtype)


def clustered_like(*, num_nodes: int, num_feats: int, num_classes: int,
                   within_density: float = 0.05, cluster: int = 128,
                   cross_frac: float = 0.0, seed: int = 0,
                   train_per_class: int = 2,
                   test_frac: float = 0.35) -> Graph:
    """Community-clustered graph whose adjacency is block-structured at the
    MXU tile: nodes [k·cluster, (k+1)·cluster) form one community and edges
    stay inside it (plus a `cross_frac` fraction drawn uniformly across the
    whole graph), so after NodePad the Â block bitmap is (near-)
    block-diagonal — the workload GraSp's block-skip targets (DESIGN.md
    §10). `within_density` is the directed edge probability inside a
    community; labels follow communities, features are class-conditioned
    bag-of-words like `planetoid_like`, so the graphs are learnable enough
    for calibration/quality audits.
    """
    rng = np.random.default_rng(seed)
    comm = (np.arange(num_nodes) // cluster).astype(np.int64)
    labels = (comm % num_classes).astype(np.int32)
    srcs, dsts = [], []
    for k in range(int(comm.max()) + 1):
        lo, hi = k * cluster, min(num_nodes, (k + 1) * cluster)
        sz = hi - lo
        ne = int(within_density * sz * sz)
        if ne == 0:
            continue
        s = rng.integers(lo, hi, size=ne)
        d = rng.integers(lo, hi, size=ne)
        keep = s != d
        srcs.append(s[keep])
        dsts.append(d[keep])
    n_cross = int(cross_frac * sum(s.size for s in srcs)) if srcs else 0
    if n_cross:
        s = rng.integers(0, num_nodes, size=n_cross)
        d = rng.integers(0, num_nodes, size=n_cross)
        keep = s != d
        srcs.append(s[keep])
        dsts.append(d[keep])
    if srcs:
        edges = np.stack([np.concatenate(srcs), np.concatenate(dsts)])
        # symmetrize + dedupe (undirected, SymG/CacheG-compatible)
        edge_index = np.unique(np.concatenate([edges, edges[::-1]], axis=1),
                               axis=1).astype(np.int32)
    else:
        edge_index = np.zeros((2, 0), np.int32)

    feats = np.zeros((num_nodes, num_feats), dtype=np.float32)
    words_per_class = max(num_feats // num_classes, 1)
    nnz = max(num_feats // 16, 4)
    for i in range(num_nodes):
        lo = labels[i] * words_per_class
        own = rng.integers(lo, min(lo + words_per_class, num_feats),
                           size=nnz * 3 // 4)
        noise = rng.integers(0, num_feats, size=nnz // 4)
        feats[i, np.concatenate([own, noise])] = 1.0
    feats /= np.maximum(feats.sum(axis=1, keepdims=True), 1.0)

    train_mask = np.zeros(num_nodes, dtype=bool)
    for c in range(num_classes):
        idx = np.nonzero(labels == c)[0]
        if idx.size:
            train_mask[rng.choice(idx, size=min(train_per_class, idx.size),
                                  replace=False)] = True
    rest = np.nonzero(~train_mask)[0]
    test_mask = np.zeros(num_nodes, dtype=bool)
    if rest.size:
        test_mask[rng.choice(rest, size=int(num_nodes * test_frac),
                             replace=False)] = True
    return Graph(edge_index=edge_index, num_nodes=num_nodes, features=feats,
                 labels=labels, train_mask=train_mask, test_mask=test_mask)


def cora_like(seed: int = 0) -> Graph:
    return planetoid_like(num_nodes=2708, num_edges=5429, num_feats=1433,
                          num_classes=7, seed=seed)


def dynamic_graph_stream(base: Graph, *, steps: int, edges_per_step: int = 16,
                         nodes_per_step: int = 2, seed: int = 0,
                         feat_dim: Optional[int] = None
                         ) -> Iterator[Tuple[np.ndarray, int, np.ndarray]]:
    """GrAd/NodePad workload: an evolving graph (paper Fig. 10 knowledge
    graph).

    Yields (edge_index, num_nodes, features) snapshots with nodes and
    edges added over time, from the reference's generator draw for draw.
    The serving engine takes them without a new plan signature while
    num_nodes stays within the NodePad bucket.
    """
    rng = np.random.default_rng(seed)
    edge_index = base.edge_index.copy()
    feats = base.features.copy()
    n = base.num_nodes
    f = feat_dim or feats.shape[1]
    for _ in range(steps):
        new_feats = rng.random((nodes_per_step, f)).astype(np.float32) * 0.1
        feats = np.concatenate([feats, new_feats], axis=0)
        lo = n
        n += nodes_per_step
        src = rng.integers(0, n, size=edges_per_step)
        dst = np.concatenate([
            rng.integers(lo, n, size=edges_per_step // 2),
            rng.integers(0, n, size=edges_per_step - edges_per_step // 2)])
        edge_index = np.concatenate(
            [edge_index, np.stack([src, dst]).astype(np.int32)], axis=1)
        yield edge_index, n, feats
