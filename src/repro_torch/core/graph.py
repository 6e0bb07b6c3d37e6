"""Graph containers and structure preprocessing (StaGr / PreG / NodePad).

Host code, numpy only — a copy of the reference package's `core/graph.py`,
GrAd's edge-delta products included (`apply_edge_delta`, and
`EdgeDelta.boundary_rows` for a sharded graph). The SymG/CacheG packers give the reference's
bytes without its O(cap²) index constants: the triangle is read row slice
by row slice and the symmetry check compares tiles; the edge-key forms
(`adjacency_keys`, `patch_adjacency_keys`, `keys_neighbours`) give the
same products from the edge list. Tensors appear only where operands go
to the device (`repro_torch.core.models`).

The paper's Step-1 enablement: graphs are preprocessed on the *host*
(GraphSplit assigns control-heavy structure work to the CPU) into dense,
statically-shaped operands that the device consumes as plain matmuls.

NodePad: every graph is padded to a fixed *bucket* capacity (a multiple of
the 128 tile) so one execution plan serves every graph of that size —
the paper's "one precompiled blob", here one operand shape signature per
plan (`core.models.ExecutionPlan.trace_count`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np

MXU_TILE = 128  # NodePad tile (name kept from the reference); kernels pad to it.


@dataclasses.dataclass
class Graph:
    """A static graph snapshot. Host-side (numpy) until padded/uploaded."""

    edge_index: np.ndarray  # (2, E) int32, row 0 = src, row 1 = dst
    num_nodes: int
    features: np.ndarray  # (N, F) float32
    labels: Optional[np.ndarray] = None  # (N,) int32
    train_mask: Optional[np.ndarray] = None  # (N,) bool
    test_mask: Optional[np.ndarray] = None  # (N,) bool

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])


def required_capacity(num_nodes: int, slack: float = 0.0) -> int:
    """Single owner of the NodePad admission rule: nodes * (1 + slack).

    `slack` reserves headroom for dynamic node insertion (GrAd) without a
    recompile — the paper pads Cora 2708 -> 3000. Both the free-form
    `node_bucket` and the ladder's `bucket_for` round THIS number up, so the
    slack policy cannot drift between the two call sites.
    """
    return int(np.ceil(num_nodes * (1.0 + slack)))


def node_bucket(num_nodes: int, *, tile: int = MXU_TILE, slack: float = 0.0) -> int:
    """NodePad bucket: smallest tile multiple >= required_capacity.

    We pad to tile multiples so the same capacity needs no further padding
    in the kernel wrappers (`kernels.ops._pad2`).
    """
    want = required_capacity(num_nodes, slack)
    return int(-(-want // tile) * tile)


def add_self_loops(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    loops = np.arange(num_nodes, dtype=edge_index.dtype)
    return np.concatenate([edge_index, np.stack([loops, loops])], axis=1)


def dense_adjacency(edge_index: np.ndarray, capacity: int, *, self_loops: bool = True,
                    num_nodes: Optional[int] = None) -> np.ndarray:
    """(capacity, capacity) float32 0/1 adjacency; A[dst, src] = 1.

    Padded rows/cols stay zero — the paper's convention '0 = no edge' makes
    NodePad padding semantically inert.
    """
    a = np.zeros((capacity, capacity), dtype=np.float32)
    src, dst = edge_index
    a[dst, src] = 1.0
    if self_loops:
        n = capacity if num_nodes is None else num_nodes
        idx = np.arange(n)
        a[idx, idx] = 1.0
    return a


def gcn_norm_adjacency(edge_index: np.ndarray, num_nodes: int, capacity: int) -> np.ndarray:
    """PreG: Â = D^-1/2 (A + I) D^-1/2 precomputed on the host.

    The sqrt/recip ops (the NPU's slow-DSP work, TPU's non-MXU scalar work)
    happen exactly once, offline; the device only ever sees one dense matmul
    operand. Padded nodes have degree 0 -> their norm rows/cols are 0.
    """
    a = dense_adjacency(edge_index, capacity, self_loops=True, num_nodes=num_nodes)
    deg = a.sum(axis=1)
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    return (d_inv_sqrt[:, None] * a * d_inv_sqrt[None, :]).astype(np.float32)


def mean_adjacency(edge_index: np.ndarray, num_nodes: int, capacity: int,
                   *, self_loops: bool = True) -> np.ndarray:
    """Row-normalized adjacency (mean aggregation): D^-1 (A [+ I])."""
    a = dense_adjacency(edge_index, capacity, self_loops=self_loops, num_nodes=num_nodes)
    deg = a.sum(axis=1, keepdims=True)
    return (a / np.maximum(deg, 1.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# SymG — triangular packing of a symmetric matrix, and the CacheG compact
# transfer format (DESIGN.md §7): a 0/1 adjacency crosses the host→device
# link as PACKED BITS, 32× fewer bytes than float32, 64× when the graph is
# undirected and SymG keeps only the upper triangle. The dense operands are
# re-derived on the device (`core.models.materialize_operands`).
# ---------------------------------------------------------------------------

SYM_TILE = 256  # tile edge of `is_symmetric_adjacency`'s comparison


def _upper_rows(a: np.ndarray) -> np.ndarray:
    """The upper triangle (incl. diagonal) of a square matrix, row-major:
    the order of `np.triu_indices`, read as one slice per row."""
    n = a.shape[0]
    if n == 0:
        return a.reshape(0)
    return np.concatenate([a[i, i:] for i in range(n)])


def symg_pack(sym: np.ndarray) -> Tuple[np.ndarray, int]:
    """Pack a symmetric (N, N) matrix into its upper triangle (incl. diag)."""
    n = sym.shape[0]
    if not np.allclose(sym, sym.T, atol=1e-6):
        raise ValueError("symg_pack requires a symmetric matrix")
    return _upper_rows(sym).astype(sym.dtype), n


def symg_unpack(packed: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n, n), dtype=packed.dtype)
    off = 0
    for i in range(n):
        out[i, i:] = packed[off:off + n - i]
        off += n - i
    return out + np.triu(out, k=1).T


def triangular_nbits(n: int) -> int:
    """Bits in the upper triangle (incl. diagonal) of an (n, n) matrix."""
    return n * (n + 1) // 2


def is_symmetric_adjacency(adj: np.ndarray) -> bool:
    """True when the 0/1 adjacency is undirected (SymG-packable): exactly
    `np.array_equal(adj, adj.T)`, compared tile against transposed tile so
    no transposed copy of the whole matrix is made."""
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        return bool(np.array_equal(adj, adj.T))
    n, t = adj.shape[0], SYM_TILE
    for i in range(0, n, t):
        for j in range(i, n, t):
            if not np.array_equal(adj[i:i + t, j:j + t],
                                  adj[j:j + t, i:i + t].T):
                return False
    return True


def pack_adjacency_bits(adj: np.ndarray) -> np.ndarray:
    """Bit-pack a full 0/1 (cap, cap) adjacency row-major -> (cap²/8,) uint8."""
    return np.packbits((adj > 0).reshape(-1))


def symg_pack_adjacency_bits(adj: np.ndarray, *, check: bool = True
                             ) -> np.ndarray:
    """SymG + bit-pack: upper triangle (incl. diag) of an undirected 0/1
    adjacency -> (cap(cap+1)/2 / 8,) uint8. Raises on a directed matrix —
    callers fall back to `pack_adjacency_bits` (or the eager dense path).
    `check=False` skips the O(cap²) validation when the caller already ran
    `is_symmetric_adjacency` on this matrix.
    """
    if check and not is_symmetric_adjacency(adj):
        raise ValueError("symg_pack_adjacency_bits requires an undirected "
                         "(symmetric) adjacency")
    return np.packbits(_upper_rows(adj > 0))


# The same three host products from the edge list, in O(E) where the dense
# adjacency costs O(cap²): a graph's 0/1 adjacency is the set of its edges,
# so the engine, which holds each request's edge list, need not scan the
# (cap, cap) matrix to check, pack or count it.


def adjacency_keys(edge_index: np.ndarray, capacity: int) -> np.ndarray:
    """The nonzeros of `dense_adjacency(edge_index, capacity,
    self_loops=False)` as sorted unique row-major offsets dst * capacity +
    src (int64; a negative index wraps, as numpy's indexing does)."""
    src, dst = np.asarray(edge_index, np.int64) % capacity
    keys = np.sort(dst * capacity + src)
    first = np.ones(keys.shape, bool)
    first[1:] = keys[1:] != keys[:-1]
    return keys[first]


def keys_symmetric(keys: np.ndarray, capacity: int) -> bool:
    """`is_symmetric_adjacency` of the matrix `keys` describes."""
    row, col = np.divmod(keys, capacity)
    return bool(np.array_equal(keys, np.sort(col * capacity + row)))


def symg_pack_keys(keys: np.ndarray, capacity: int) -> np.ndarray:
    """`symg_pack_adjacency_bits(check=False)` of the matrix `keys`
    describes: the same bytes, one bit set per upper-triangle edge."""
    row, col = np.divmod(keys, capacity)
    upper = row <= col
    r, c = row[upper], col[upper]
    lin = r * (2 * capacity - r + 1) // 2 + (c - r)
    out = np.zeros(-(-triangular_nbits(capacity) // 8), np.uint8)
    np.bitwise_or.at(out, lin >> 3, (128 >> (lin & 7)).astype(np.uint8))
    return out


def pad_features(x: np.ndarray, capacity: int) -> np.ndarray:
    """NodePad: zero-pad node features to the bucket capacity."""
    n, f = x.shape
    if n > capacity:
        raise ValueError(f"graph ({n} nodes) exceeds NodePad capacity {capacity}")
    if n == capacity:
        return x.astype(np.float32)
    out = np.zeros((capacity, f), dtype=np.float32)
    out[:n] = x
    return out


def pad_labels(y: np.ndarray, capacity: int, *, fill: int = -1) -> np.ndarray:
    out = np.full((capacity,), fill, dtype=np.int32)
    out[: y.shape[0]] = y
    return out


class Deferred:
    """A value built on first read: `build(*args, **kwargs)`."""

    __slots__ = ("build",)

    def __init__(self, build, *args, **kwargs):
        self.build = functools.partial(build, *args, **kwargs)


class _BuiltOnRead:
    """Descriptor of a `PaddedGraph` field that may hold a `Deferred`: the
    first read builds it and keeps the value, so a path that never reads
    the field never pays for it. Other values are stored as given."""

    def __set_name__(self, owner, name):
        self.slot = "_" + name

    def __get__(self, obj, owner=None):
        if obj is None:                     # a required dataclass field
            raise AttributeError(self.slot[1:])
        v = obj.__dict__[self.slot]
        if isinstance(v, Deferred):
            v = obj.__dict__[self.slot] = v.build()
        return v

    def __set__(self, obj, value):
        obj.__dict__[self.slot] = value


@dataclasses.dataclass
class PaddedGraph:
    """Device-ready NodePad'ded graph: every array statically (cap, ·)-shaped.

    `norm_adj` is the GrAd *input* form — a runtime operand of the plan,
    never baked into it — so edge updates re-run only host preprocessing
    (the paper's recompile-free dynamic-graph path).

    `pad_graph` leaves `norm_adj` and `adj` to be built from the edge list
    on first read (`built` says whether they were): the CacheG path packs
    from the edge keys and never reads either (cap, cap) matrix. The
    fields are the reference's, so `dataclasses.asdict` gives its
    `PaddedGraph`'s arguments (building both).
    """

    capacity: int
    num_nodes: int
    features: np.ndarray      # (cap, F)
    norm_adj: np.ndarray = _BuiltOnRead()   # (cap, cap)  Â (PreG-normalized)
    adj: np.ndarray = _BuiltOnRead()        # (cap, cap)  raw 0/1 (no self loops) for GAT masks
    node_mask: np.ndarray     # (cap,) 1.0 for real nodes
    labels: Optional[np.ndarray] = None
    train_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None

    def built(self, name: str) -> bool:
        """Whether the field `name` holds its value (not a `Deferred`)."""
        return not isinstance(self.__dict__["_" + name], Deferred)


def _norm_adjacency(edge_index: np.ndarray, num_nodes: int, capacity: int,
                    norm: str) -> np.ndarray:
    if norm == "gcn":
        return gcn_norm_adjacency(edge_index, num_nodes, capacity)
    return mean_adjacency(edge_index, num_nodes, capacity)


def _deferred_structure(edge_index: np.ndarray, num_nodes: int,
                        capacity: int, norm: str) -> dict:
    """`norm_adj` and `adj` of a padded graph, built on first read from a
    copy of its edge list (a caller may reuse its array)."""
    if norm not in ("gcn", "mean"):
        raise ValueError(f"unknown norm {norm!r}")
    e = np.array(edge_index, copy=True)
    return {"norm_adj": Deferred(_norm_adjacency, e, num_nodes, capacity,
                                 norm),
            "adj": Deferred(dense_adjacency, e, capacity, self_loops=False)}


def pad_graph(g: Graph, *, capacity: Optional[int] = None, slack: float = 0.0,
              norm: str = "gcn") -> PaddedGraph:
    cap = capacity if capacity is not None else node_bucket(g.num_nodes, slack=slack)
    structure = _deferred_structure(g.edge_index, g.num_nodes, cap, norm)
    mask = np.zeros((cap,), dtype=np.float32)
    mask[: g.num_nodes] = 1.0

    def _pad_bool(m):
        if m is None:
            return None
        out = np.zeros((cap,), dtype=bool)
        out[: g.num_nodes] = m
        return out

    return PaddedGraph(
        capacity=cap,
        num_nodes=g.num_nodes,
        features=pad_features(g.features, cap),
        **structure,
        node_mask=mask,
        labels=None if g.labels is None else pad_labels(g.labels, cap),
        train_mask=_pad_bool(g.train_mask),
        test_mask=_pad_bool(g.test_mask),
    )


# ---------------------------------------------------------------------------
# BucketLadder — the multi-graph NodePad policy (DESIGN.md §3).
# One compiled blob per (model, bucket); a graph joins the smallest bucket
# that holds it, and a growing graph re-buckets (the one legitimate
# recompile) only when it outgrows its current capacity.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """A sorted set of NodePad capacities shared by many graphs.

    `slack` reserves growth headroom at admission: a graph is placed in the
    smallest bucket >= num_nodes * (1 + slack), so GrAd updates have room
    before the re-bucket policy has to move it up the ladder.
    """

    buckets: Tuple[int, ...] = (256, 512, 1024, 2048)
    slack: float = 0.0

    def __post_init__(self):
        bs = tuple(sorted(int(b) for b in self.buckets))
        if not bs:
            raise ValueError("BucketLadder needs at least one bucket")
        for b in bs:
            if b <= 0 or b % MXU_TILE:
                raise ValueError(
                    f"bucket {b} is not a positive multiple of the MXU tile "
                    f"{MXU_TILE} (NodePad buckets must tile-align)")
        object.__setattr__(self, "buckets", bs)

    def bucket_for(self, num_nodes: int) -> int:
        """Smallest bucket holding num_nodes (+ admission slack)."""
        want = required_capacity(num_nodes, self.slack)
        for b in self.buckets:
            if want <= b:
                return b
        # slack is headroom, not a hard requirement: a graph that fits the
        # top bucket without slack is still admissible there.
        if num_nodes <= self.buckets[-1]:
            return self.buckets[-1]
        raise ValueError(
            f"graph with {num_nodes} nodes exceeds the largest bucket "
            f"{self.buckets[-1]}")

    def pad(self, g: Graph, *, norm: str = "gcn") -> PaddedGraph:
        return pad_graph(g, capacity=self.bucket_for(g.num_nodes), norm=norm)

    def grow(self, pg: PaddedGraph, edge_index: np.ndarray, num_nodes: int,
             features: np.ndarray, *, norm: str = "gcn"
             ) -> Tuple[PaddedGraph, bool]:
        """GrAd update with re-bucket policy.

        Returns (updated graph, rebucketed). While the graph fits its
        current capacity this is a pure value update (zero recompiles); once
        it outgrows the bucket, the graph is re-padded into the next rung —
        the caller pays exactly one new (model, bucket) compile, which the
        serving engine counts as a rebucket event.
        """
        if num_nodes <= pg.capacity:
            upd = update_edges(pg, edge_index, num_nodes, norm=norm)
            # a fresh object: set in place, as `dataclasses.replace` would
            # build the deferred matrices to copy them
            upd.features = pad_features(features, pg.capacity)
            return upd, False
        # Re-bucket: carry the supervision arrays across the move. Nodes
        # beyond the old capacity are new and unlabeled (fill -1 / False) —
        # silently dropping labels/train_mask/test_mask here would strand an
        # attached graph's evaluation state the first time it climbs.
        old = pg.capacity

        def _grown(arr, fill, dtype):
            if arr is None:
                return None
            out = np.full((num_nodes,), fill, dtype=dtype)
            out[:old] = arr[:old]
            return out

        fresh = Graph(edge_index=edge_index, num_nodes=num_nodes,
                      features=features,
                      labels=_grown(pg.labels, -1, np.int32),
                      train_mask=_grown(pg.train_mask, False, bool),
                      test_mask=_grown(pg.test_mask, False, bool))
        cap = self.bucket_for(num_nodes)
        return pad_graph(fresh, capacity=cap, norm=norm), True


@dataclasses.dataclass
class BatchedGraphs:
    """Same-bucket PaddedGraphs stacked with a leading batch dimension."""

    capacity: int
    num_nodes: np.ndarray     # (B,) int32
    features: np.ndarray      # (B, cap, F)
    norm_adj: np.ndarray      # (B, cap, cap)
    adj: np.ndarray           # (B, cap, cap)
    node_mask: np.ndarray     # (B, cap)

    @property
    def batch(self) -> int:
        return int(self.features.shape[0])


def stack_padded(pgs: Sequence[PaddedGraph]) -> BatchedGraphs:
    """Stack PaddedGraphs of one bucket for vmapped batched execution."""
    if not pgs:
        raise ValueError("cannot stack an empty graph batch")
    caps = {pg.capacity for pg in pgs}
    if len(caps) != 1:
        raise ValueError(f"mixed NodePad buckets in one batch: {sorted(caps)}")
    return BatchedGraphs(
        capacity=pgs[0].capacity,
        num_nodes=np.asarray([pg.num_nodes for pg in pgs], np.int32),
        features=np.stack([pg.features for pg in pgs]),
        norm_adj=np.stack([pg.norm_adj for pg in pgs]),
        adj=np.stack([pg.adj for pg in pgs]),
        node_mask=np.stack([pg.node_mask for pg in pgs]),
    )



# ---------------------------------------------------------------------------
# GrAd edge deltas (DESIGN.md §13): the host side of an incremental
# structure update. `apply_edge_delta` patches the dense adjacency and Â
# with `gcn_norm_adjacency`'s exact expressions; `patch_adjacency_keys`
# applies the same flips to a graph's edge keys, which CacheG packs from.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EdgeDelta:
    """Host product of one EFFECTIVE GrAd edge delta.

    `norm_adj` is the patched Â with only the touched rows and columns
    renormalized, by `gcn_norm_adjacency`'s expression and association
    order, so it equals a full rebuild of the patched structure bit for
    bit. The flip and touched arrays are what the device patcher
    (`core.models.patch_operands`) needs to bring a cached operand entry
    to the same bits.
    """
    adj: np.ndarray                # (cap, cap) patched raw 0/1 adjacency
    norm_adj: np.ndarray           # (cap, cap) patched Â, rebuild-exact
    dis: np.ndarray                # (cap,) patched D^-1/2 (float32)
    flip_i: np.ndarray             # (P,) int32 canonical flip endpoints
    flip_j: np.ndarray             # (P,) int32   (i < j; the device
    flip_v: np.ndarray             # (P,) float32  writes both orientations)
    touched: np.ndarray            # (T,) int32 sorted flip endpoints: the
    #                                nodes whose rows/cols changed

    def boundary_rows(self, assignment: np.ndarray,
                      num_nodes: int) -> np.ndarray:
        """Touched nodes whose rows cross a shard boundary (DESIGN.md §15).

        Against a shard `assignment` (`core.partition.GraphShards.
        assignment`, original node ids): the sorted subset of `touched`
        with at least one neighbour on ANOTHER shard in the PATCHED
        adjacency, the only rows whose remote copies a sharded halo
        exchange must refresh. A delta inside one shard returns an empty
        set: nothing crosses between shards.
        """
        t = self.touched[self.touched < num_nodes]
        if t.size == 0:
            return t.astype(np.int32)
        sub = self.adj[t][:, :num_nodes] != 0
        diff = assignment[None, :num_nodes] != assignment[t][:, None]
        return t[(sub & diff).any(axis=1)].astype(np.int32)


def _delta_pairs(num_nodes: int, edges) -> np.ndarray:
    """(k, 2) node pairs -> sorted unique canonical (lo < hi) pairs,
    self-loop pairs dropped (the diagonal is forced, so they change no
    operand). A node outside [0, num_nodes) raises."""
    e = np.asarray(edges if edges is not None else [],
                   dtype=np.int64).reshape(-1, 2)
    if e.size and (e.min() < 0 or e.max() >= num_nodes):
        raise ValueError(
            f"edge delta references node outside [0, {num_nodes}) — "
            "node-set changes take the full update() path")
    e = e[e[:, 0] != e[:, 1]]
    if not len(e):
        return e.reshape(0, 2)
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    return np.unique(np.stack([lo, hi], axis=1), axis=0)


def apply_edge_delta(adj: np.ndarray, norm_adj: np.ndarray, num_nodes: int,
                     add_edges, remove_edges) -> Optional[EdgeDelta]:
    """GrAd incremental structure update on the host.

    `add_edges` / `remove_edges` are (k, 2) node-pair arrays (any order,
    both orientations equivalent — the graph is undirected). Ineffective
    flips (adding a present edge, removing an absent one) and self-loop
    pairs are skipped; returns None when NOTHING effective remains, so the
    caller can skip the version bump. Out-of-range nodes and a pair
    listed on both sides raise — those are caller bugs, not deltas.
    """
    adds = _delta_pairs(num_nodes, add_edges)
    removes = _delta_pairs(num_nodes, remove_edges)
    if len(adds) and len(removes):
        both = (set(map(tuple, adds.tolist()))
                & set(map(tuple, removes.tolist())))
        if both:
            raise ValueError(f"edge pair(s) {sorted(both)} listed as both "
                             "add and remove")
    if len(adds):
        adds = adds[adj[adds[:, 0], adds[:, 1]] == 0]
    if len(removes):
        removes = removes[adj[removes[:, 0], removes[:, 1]] != 0]
    if not len(adds) and not len(removes):
        return None
    flips = np.concatenate([adds, removes], axis=0)
    vals = np.concatenate([np.ones(len(adds), np.float32),
                           np.zeros(len(removes), np.float32)])
    new_adj = adj.copy()
    new_adj[flips[:, 0], flips[:, 1]] = vals
    new_adj[flips[:, 1], flips[:, 0]] = vals
    touched = np.unique(flips)

    # renorm the touched rows/cols with gcn_norm_adjacency's EXACT
    # expression — same forced diagonal, same 1e-12 clamp, same
    # left-associated products — so patched entries match a rebuild's bits
    awl = new_adj.copy()
    idx = np.arange(num_nodes)
    awl[idx, idx] = 1.0
    deg = awl.sum(axis=1)
    with np.errstate(divide="ignore"):
        dis = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    na = norm_adj.copy()
    na[touched, :] = dis[touched][:, None] * awl[touched, :] * dis[None, :]
    na[:, touched] = dis[:, None] * awl[:, touched] * dis[touched][None, :]
    return EdgeDelta(adj=new_adj, norm_adj=na, dis=dis.astype(np.float32),
                     flip_i=flips[:, 0].astype(np.int32),
                     flip_j=flips[:, 1].astype(np.int32),
                     flip_v=vals,
                     touched=touched.astype(np.int32))


def patch_adjacency_keys(keys: np.ndarray, capacity: int,
                         delta: EdgeDelta) -> np.ndarray:
    """`adjacency_keys` of `delta.adj`, from the graph's keys before the
    delta: each flip in both orientations, removed or inserted in place,
    O(E + P log P) for E keys and P flips."""
    i = delta.flip_i.astype(np.int64)
    j = delta.flip_j.astype(np.int64)
    flip = np.concatenate([i * capacity + j, j * capacity + i])
    add = np.concatenate([delta.flip_v, delta.flip_v]) > 0
    kept = np.delete(keys, np.searchsorted(keys, flip[~add]))
    ins = np.sort(flip[add])
    return np.insert(kept, np.searchsorted(kept, ins), ins)


def keys_neighbours(keys: np.ndarray, capacity: int,
                    nodes: np.ndarray) -> np.ndarray:
    """Sorted rows r with an edge into any of `nodes` (adj[r, t] set for a
    t in `nodes`) in the matrix `keys` describes: the reference's dense
    `adj[:, nodes].any(axis=1)`, from the edge list."""
    row, col = np.divmod(keys, capacity)
    return np.unique(row[np.isin(col, nodes)])


def edge_index_from_adjacency(adj: np.ndarray, num_nodes: int) -> np.ndarray:
    """Recover the (2, E) edge list from a dense adjacency (A[dst, src]=1)
    — the full-rebuild fallback's input when only the patched adjacency is
    on hand."""
    dst, src = np.nonzero(adj[:num_nodes, :num_nodes])
    return np.stack([src, dst]).astype(np.int32)


def update_edges(pg: PaddedGraph, edge_index: np.ndarray, num_nodes: int,
                 *, norm: str = "gcn") -> PaddedGraph:
    """GrAd: rebuild only the runtime mask inputs for an evolved graph.

    No recompilation: shapes are unchanged (same capacity), only array
    *values* change. Raises if the graph outgrew its bucket (the caller then
    re-buckets — the one legitimate recompile).
    """
    if num_nodes > pg.capacity:
        raise ValueError(
            f"graph grew to {num_nodes} nodes > capacity {pg.capacity}; re-bucket")
    structure = _deferred_structure(edge_index, num_nodes, pg.capacity,
                                    norm if norm == "gcn" else "mean")
    mask = np.zeros((pg.capacity,), dtype=np.float32)
    mask[:num_nodes] = 1.0
    return dataclasses.replace(pg, num_nodes=num_nodes, node_mask=mask,
                               **structure)
