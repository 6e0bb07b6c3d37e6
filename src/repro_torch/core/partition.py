"""GraphSplit: cost-model-driven host/device partitioning, and the N-way
device partitioner.

Port of the reference's `core/partition.py`, numpy on the host like it.

The host/device planner: the paper profiles each op on the CPU and the
accelerator during calibration, adds the transfer cost, and picks the
cut that minimizes end-to-end latency subject to RAW dependencies:

  * stage graph  = a linear pipeline of named stages (GNN preprocessing ->
    aggregation -> combination), each with measured or modelled host and
    device latencies;
  * transfer cost = `core.costs.transfer_cost` (the measured host link and
    a copy's fixed cost), charged where the pipeline crosses to the card;
  * optimal cut  = every cut position evaluated (the pipeline is linear,
    so the optimum is one prefix on the host).

The N-way device partitioner (DESIGN.md §12, §15): an edge cut that
splits a graph larger than the ladder's top bucket into bucket-admissible
row shards with their halo (boundary-node) sets, by the multilevel
method (heavy-edge-matching coarsening, a greedy weighted cut of the
coarsest graph, KL/FM refinement on the way back) or the greedy
streaming cut; and the modelled cost of serving it sharded (per-shard
compute plus the halo exchange over the card-to-card link).
`core.models.build_sharded_operands` builds the device operands from the
`GraphShards` this module emits. Every rule, order and tie-break is the
reference's, so both give the same partition of the same edge list.

The constants are `core.costs`'s H100 terms (`DENSE_RATE` where the
reference reads its `MXU_RATE`), read at call time, so a test may set
them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import costs
from .costs import transfer_cost  # noqa: F401  (the planners' wire cost)


@dataclasses.dataclass
class Stage:
    name: str
    host_latency_s: float          # modelled or measured CPU latency
    device_latency_s: float        # modelled or measured accelerator latency
    output_bytes: int              # bytes crossing a boundary after this stage
    control_heavy: bool = False    # diagnostic only
    host_fn: Optional[Callable] = None
    device_fn: Optional[Callable] = None


def profile_stage(fn: Callable, *args, repeats: int = 5) -> float:
    """Offline profiling: median wall-clock of fn(*args)."""
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        # wait for a card's results so we time compute, not the launch
        if isinstance(out, torch.Tensor) and out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@dataclasses.dataclass
class PartitionPlan:
    cut: int                       # stages[:cut] run on host, stages[cut:] on device
    total_latency_s: float
    per_cut_latency_s: List[float]

    def placement(self, stages: Sequence[Stage]) -> List[str]:
        return ["host" if i < self.cut else "device" for i in range(len(stages))]


def graphsplit(stages: Sequence[Stage]) -> PartitionPlan:
    """Pick the prefix cut minimizing latency = host work + 1 transfer + device work.

    A single host->device crossing is optimal for a linear pipeline whenever
    the device is faster on the suffix — the paper's RAW-dependency argument:
    bouncing back to the host pays `transfer_cost` twice and never wins unless
    the host op is dramatically faster, which the cost model captures by
    evaluating every cut position.
    """
    n = len(stages)
    costs = []
    for cut in range(n + 1):
        host = sum(s.host_latency_s for s in stages[:cut])
        dev = sum(s.device_latency_s for s in stages[cut:])
        xfer = 0.0
        if 0 < cut <= n:
            xfer = transfer_cost(stages[cut - 1].output_bytes)
        elif cut == 0 and n > 0:
            # inputs still have to reach the device
            xfer = transfer_cost(stages[0].output_bytes)
        costs.append(host + xfer + dev)
    best = int(np.argmin(costs))
    return PartitionPlan(cut=best, total_latency_s=costs[best], per_cut_latency_s=costs)


def default_gnn_stages(num_nodes: int, num_edges: int, in_feats: int,
                       out_feats: int, *, capacity: int) -> List[Stage]:
    """Modelled stage costs for a GNN layer, mirroring Fig. 4's breakdown.

    Host latencies model control-heavy degree/sqrt/scatter preprocessing as
    cheap on the CPU; device latencies model the same work as gathers and
    scatters (slow, bytes-bound) against dense products (fast, at
    `costs.DENSE_RATE`).
    """
    cap = capacity
    flops_combine = 2.0 * cap * in_feats * out_feats
    flops_aggregate = 2.0 * cap * cap * out_feats
    DENSE = costs.DENSE_RATE    # dense product rate (the 3xTF32 kernel)
    GATHER = costs.GATHER_BW    # gather/scatter effective bytes/s
    CPU = costs.CPU_RATE        # host scalar throughput (ops/s)
    return [
        Stage("build_adjacency", num_edges / CPU * 4, (num_edges * 8) / GATHER,
              output_bytes=cap * cap * 4, control_heavy=True),
        Stage("degree_norm (PreG)", cap / CPU * 8, (cap * 12) / GATHER,
              output_bytes=cap * cap * 4, control_heavy=True),
        Stage("combine XW", flops_combine / (2e9), flops_combine / DENSE,
              output_bytes=cap * out_feats * 4),
        Stage("aggregate ÂH (StaGr)", flops_aggregate / (2e9),
              flops_aggregate / DENSE,
              output_bytes=cap * out_feats * 4),
    ]


# ---------------------------------------------------------------------------
# N-way device partitioner (DESIGN.md §12) — GraphSplit beyond the host cut.
# An oversized graph (num_nodes > the ladder's top bucket) is split into
# `shards` row blocks; each shard owns a contiguous range of SLOTS in a
# permuted full-capacity layout, computes its own rows, and reads the
# hidden states of halo (boundary) nodes of the other shards from one
# exchange per layer (`core.models.halo_exchange`).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphShards:
    """Result of the greedy edge-cut: who owns which node, in slot layout.

    Slot layout: shard `s` owns slots [s*shard_cap, (s+1)*shard_cap);
    `perm[slot]` is the ORIGINAL padded-graph position living in that slot
    (real node id when < num_nodes, else a padding position). Permuting the
    full-capacity operands by `perm` on both axes yields the sharded layout;
    row block `s` of the permuted matrices is exactly shard s's operand.
    """

    shards: int
    shard_cap: int                 # slotted rows per shard (a NodePad bucket)
    num_nodes: int
    assignment: np.ndarray         # (num_nodes,) int32 owning shard per node
    perm: np.ndarray               # (shards*shard_cap,) slot -> original pos
    halo: Tuple[np.ndarray, ...]   # per-shard sorted remote in-neighbor ids
    loads: np.ndarray              # (shards,) real nodes per shard
    cut_edges: int                 # edges crossing a shard boundary

    @property
    def full_rows(self) -> int:
        return self.shards * self.shard_cap

    @property
    def halo_nodes(self) -> int:
        return int(sum(len(h) for h in self.halo))


PARTITION_METHODS = ("multilevel", "greedy")


def _greedy_assignment(edge_index: np.ndarray, num_nodes: int, shards: int,
                       cap: int) -> np.ndarray:
    """The original greedy streaming edge-cut (LDG-style): nodes stream in
    degree-descending order; each lands on the shard holding the most of
    its already-placed neighbors (ties: lightest load, then lowest shard
    id), under the hard per-shard load cap."""
    # undirected neighbor structure for placement affinity (CSR via sort)
    src, dst = edge_index
    both = np.concatenate([np.stack([src, dst]), np.stack([dst, src])], axis=1)
    both = both[:, both[0] < num_nodes]
    both = both[:, both[1] < num_nodes]
    order = np.argsort(both[0], kind="stable")
    nbr_flat = both[1][order]
    starts = np.searchsorted(both[0][order], np.arange(num_nodes + 1))
    degree = np.diff(starts)

    assignment = np.full((num_nodes,), -1, dtype=np.int32)
    loads = np.zeros((shards,), dtype=np.int64)
    # degree-descending, id-ascending within a degree tier (deterministic)
    stream = np.lexsort((np.arange(num_nodes), -degree))
    for u in stream:
        nbrs = nbr_flat[starts[u]: starts[u + 1]]
        placed = assignment[nbrs]
        affinity = np.bincount(placed[placed >= 0], minlength=shards)
        open_ = loads < cap
        if not open_.any():         # unreachable given the cap check above
            raise ValueError("no shard with free capacity")
        score = np.where(open_, affinity, -1)
        best = score.max()
        cand = np.flatnonzero(score == best)
        s = cand[np.argmin(loads[cand])]
        assignment[u] = s
        loads[s] += 1
    return assignment


def _finalize(edge_index: np.ndarray, num_nodes: int, shards: int,
              shard_cap: int, assignment: np.ndarray) -> GraphShards:
    """Assignment -> `GraphShards`: slot permutation (per-shard interleaved
    padding), per-shard halo (exact remote in-neighbor) sets, loads, cut."""
    src, dst = edge_index
    loads = np.bincount(assignment, minlength=shards).astype(np.int64)
    full = shards * shard_cap
    perm = np.empty((full,), dtype=np.int64)
    pad_pos = num_nodes
    for s in range(shards):
        own = np.flatnonzero(assignment == s)
        base = s * shard_cap
        perm[base: base + len(own)] = own
        n_pad = shard_cap - len(own)
        perm[base + len(own): base + shard_cap] = np.arange(
            pad_pos, pad_pos + n_pad)
        pad_pos += n_pad

    live = (src < num_nodes) & (dst < num_nodes)
    ls, ld = src[live], dst[live]
    cross = assignment[ls] != assignment[ld]
    halo = tuple(np.unique(ls[cross & (assignment[ld] == s)])
                 for s in range(shards))
    return GraphShards(shards=shards, shard_cap=shard_cap,
                       num_nodes=num_nodes,
                       assignment=assignment.astype(np.int32), perm=perm,
                       halo=halo, loads=loads, cut_edges=int(cross.sum()))


def partition_graph(edge_index: np.ndarray, num_nodes: int, shards: int,
                    *, shard_cap: int, max_load: Optional[int] = None,
                    method: str = "multilevel",
                    hierarchy: Optional["CoarseHierarchy"] = None
                    ) -> GraphShards:
    """N-way edge-cut over the graph (DESIGN.md §15).

    `method="multilevel"` (the default) runs the multilevel partitioner:
    heavy-edge-matching coarsening, a greedy weighted cut on the coarsest
    graph, then KL/FM boundary refinement on every uncoarsening step with
    the per-shard load cap as a hard constraint — measurably lower
    `cut_edges` (hence halo wire bytes) than the streaming cut on
    clustered graphs. `method="greedy"` keeps the original one-pass
    streaming LDG cut (the §12 baseline the `partition_quality` benchmark
    compares against). Both are deterministic for a given `edge_index` —
    the serving cache keys partitions by structure version. A prebuilt
    `hierarchy` (from `coarsen_graph`, with `max_shards >= shards`) skips
    the coarsening phase — `partition_for_ladder` coarsens once and
    re-cuts per candidate shard count through this.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if method not in PARTITION_METHODS:
        raise ValueError(f"unknown partition method {method!r}; "
                         f"pick from {PARTITION_METHODS}")
    cap = max_load if max_load is not None else -(-num_nodes // shards)
    if cap > shard_cap:
        raise ValueError(
            f"per-shard load cap {cap} exceeds the shard bucket {shard_cap}")
    if shards * cap < num_nodes:
        raise ValueError(
            f"{shards} shards x load cap {cap} cannot hold {num_nodes} nodes")
    if shards == 1:
        assignment = np.zeros((num_nodes,), np.int32)
    elif method == "greedy":
        assignment = _greedy_assignment(edge_index, num_nodes, shards, cap)
    else:
        hier = (hierarchy if hierarchy is not None
                else coarsen_graph(edge_index, num_nodes, max_shards=shards))
        assignment = _multilevel_assignment(hier, shards, cap)
    return _finalize(edge_index, num_nodes, shards, shard_cap, assignment)


# ---------------------------------------------------------------------------
# Multilevel partitioner (DESIGN.md §15): HEM coarsening -> greedy cut on
# the coarsest graph -> KL/FM boundary refinement per uncoarsening step.
# Host-side numpy, deterministic (every tie broken by id).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Level:
    """One level of the coarsening hierarchy: a weighted undirected graph.

    Edges are unique (u < v) pairs; `ew` counts the DIRECTED live edges
    collapsed into the pair (so a weighted cut at any level equals the
    directed `cut_edges` of the projected fine assignment). `nw[c]` is the
    number of original nodes contained in coarse node `c`. `parent` maps
    the next-FINER level's nodes onto this level (None at the finest)."""
    n: int
    eu: np.ndarray
    ev: np.ndarray
    ew: np.ndarray
    nw: np.ndarray
    parent: Optional[np.ndarray]

    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(starts, nbr, wgt) adjacency over the weighted pairs."""
        both_u = np.concatenate([self.eu, self.ev])
        both_v = np.concatenate([self.ev, self.eu])
        both_w = np.concatenate([self.ew, self.ew])
        order = np.argsort(both_u, kind="stable")
        starts = np.searchsorted(both_u[order], np.arange(self.n + 1))
        return starts, both_v[order], both_w[order]


@dataclasses.dataclass
class CoarseHierarchy:
    """Shard-count-independent coarsening of one graph (DESIGN.md §15).

    `levels[0]` is the finest (original, unit-weight) graph, `levels[-1]`
    the coarsest. Matching never merges past `w_max` original nodes per
    coarse node, so any shard count up to `max_shards` can cut this
    hierarchy under its balanced load cap — `partition_for_ladder` builds
    it ONCE and re-cuts per candidate count."""
    num_nodes: int
    max_shards: int
    levels: List[_Level]


def _pair_weights(edge_index: np.ndarray, num_nodes: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unique undirected (u < v) pairs weighted by directed multiplicity."""
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    live = (src < num_nodes) & (dst < num_nodes) & (src != dst)
    u = np.minimum(src[live], dst[live]).astype(np.int64)
    v = np.maximum(src[live], dst[live]).astype(np.int64)
    if u.size == 0:
        z = np.zeros((0,), np.int64)
        return z, z, np.zeros((0,), np.float64)
    key = u * num_nodes + v
    uniq, counts = np.unique(key, return_counts=True)
    return uniq // num_nodes, uniq % num_nodes, counts.astype(np.float64)


def _hem_match(level: _Level, w_max: int) -> np.ndarray:
    """Heavy-edge matching: visit nodes by descending incident weight (tie:
    ascending id); each unmatched node pairs with its heaviest unmatched
    neighbor (tie: lowest id) whose combined weight stays within `w_max`."""
    starts, nbr, wgt = level.csr()
    wdeg = np.zeros((level.n,), np.float64)
    np.add.at(wdeg, level.eu, level.ew)
    np.add.at(wdeg, level.ev, level.ew)
    match = np.full((level.n,), -1, np.int64)
    order = np.lexsort((np.arange(level.n), -wdeg))
    nw = level.nw
    for u in order:
        if match[u] >= 0:
            continue
        vs = nbr[starts[u]: starts[u + 1]]
        ws = wgt[starts[u]: starts[u + 1]]
        ok = (match[vs] < 0) & (vs != u) & (nw[u] + nw[vs] <= w_max)
        if not ok.any():
            continue
        vs, ws = vs[ok], ws[ok]
        best = ws.max()
        v = vs[ws == best].min()
        match[u], match[v] = v, u
    return match


def _contract(level: _Level, match: np.ndarray) -> _Level:
    """Collapse matched pairs into coarse nodes (ids in ascending order of
    each pair's smaller member), merging parallel edges and dropping the
    ones that became internal."""
    cid = np.full((level.n,), -1, np.int64)
    c = 0
    for u in range(level.n):
        if cid[u] >= 0:
            continue
        cid[u] = c
        if match[u] > u:
            cid[match[u]] = c
        c += 1
    nw = np.bincount(cid, weights=level.nw, minlength=c).astype(np.int64)
    cu, cv = cid[level.eu], cid[level.ev]
    keep = cu != cv
    a = np.minimum(cu[keep], cv[keep])
    b = np.maximum(cu[keep], cv[keep])
    if a.size:
        key = a * c + b
        uniq, inv = np.unique(key, return_inverse=True)
        ew = np.bincount(inv, weights=level.ew[keep])
        eu, ev = uniq // c, uniq % c
    else:
        eu = ev = np.zeros((0,), np.int64)
        ew = np.zeros((0,), np.float64)
    return _Level(n=c, eu=eu, ev=ev, ew=ew, nw=nw, parent=cid)


def coarsen_graph(edge_index: np.ndarray, num_nodes: int, *,
                  max_shards: int) -> CoarseHierarchy:
    """HEM coarsening down to a coarsest graph a greedy cut can see whole.

    Per-coarse-node weight is capped at ~half the TIGHTEST balanced load
    any count up to `max_shards` could impose (`ceil(n / (2*max_shards))`),
    so the weighted initial cut stays near-feasible for every candidate;
    stops at ~`max(32, 8*max_shards)` nodes or when a round shrinks the
    graph by less than 10% (matching has stalled — star graphs do this).
    """
    s_ref = max(int(max_shards), 2)
    w_max = max(1, -(-num_nodes // (2 * s_ref)))
    target = max(32, 8 * s_ref)
    eu, ev, ew = _pair_weights(edge_index, num_nodes)
    levels = [_Level(n=num_nodes, eu=eu, ev=ev, ew=ew,
                     nw=np.ones((num_nodes,), np.int64), parent=None)]
    while levels[-1].n > target:
        cur = levels[-1]
        match = _hem_match(cur, w_max)
        if match.max(initial=-1) < 0:
            break                           # nothing matched: stalled
        nxt = _contract(cur, match)
        if nxt.n > 0.9 * cur.n:
            break                           # < 10% shrink: stalled
        levels.append(nxt)
    return CoarseHierarchy(num_nodes=num_nodes, max_shards=s_ref,
                           levels=levels)


def _initial_cut(level: _Level, shards: int, cap: int) -> np.ndarray:
    """Greedy weighted cut of the coarsest graph: nodes stream heaviest
    first (ties: heaviest incident weight, then id) onto the
    highest-affinity shard with room (ties: lightest load, lowest id).
    When no shard has room — possible under a tight cap with weighted
    nodes — the lightest-loaded shard takes the node anyway; refinement's
    balance repair restores the hard cap on the way back down."""
    starts, nbr, wgt = level.csr()
    wdeg = np.zeros((level.n,), np.float64)
    np.add.at(wdeg, level.eu, level.ew)
    np.add.at(wdeg, level.ev, level.ew)
    assignment = np.full((level.n,), -1, np.int64)
    loads = np.zeros((shards,), np.int64)
    order = np.lexsort((np.arange(level.n), -wdeg, -level.nw))
    for u in order:
        vs = nbr[starts[u]: starts[u + 1]]
        ws = wgt[starts[u]: starts[u + 1]]
        placed = assignment[vs]
        aff = np.zeros((shards,), np.float64)
        np.add.at(aff, placed[placed >= 0], ws[placed >= 0])
        fits = loads + level.nw[u] <= cap
        if fits.any():
            score = np.where(fits, aff, -np.inf)
            best = score.max()
            cand = np.flatnonzero(score == best)
            s = cand[np.argmin(loads[cand])]
        else:
            s = int(np.argmin(loads))
        assignment[u] = s
        loads[s] += level.nw[u]
    return assignment


def _refine(level: _Level, assignment: np.ndarray, shards: int, cap: int,
            *, passes: int = 8) -> np.ndarray:
    """KL/FM boundary refinement at one level, cap as a hard constraint.

    Repairs any cap violation inherited from a coarser level first (moving
    the overloaded shard's best-gain node that fits elsewhere), then runs
    gain passes: nodes ordered by descending move gain, each re-checked
    against the CURRENT affinities and moved only when the gain is
    strictly positive and the target has room — every accepted move
    strictly lowers the weighted cut, so the loop cannot cycle; `passes`
    only bounds time. Affinities update incrementally per move."""
    n = level.n
    starts, nbr, wgt = level.csr()
    nw = level.nw
    loads = np.bincount(assignment, weights=nw, minlength=shards
                        ).astype(np.int64)
    aff = np.zeros((n, shards), np.float64)
    np.add.at(aff, (level.eu, assignment[level.ev]), level.ew)
    np.add.at(aff, (level.ev, assignment[level.eu]), level.ew)

    def move(u: int, a: int, b: int) -> None:
        assignment[u] = b
        loads[a] -= nw[u]
        loads[b] += nw[u]
        vs = nbr[starts[u]: starts[u + 1]]
        ws = wgt[starts[u]: starts[u + 1]]
        np.subtract.at(aff, (vs, np.full(vs.shape, a)), ws)
        np.add.at(aff, (vs, np.full(vs.shape, b)), ws)

    # balance repair: a coarse-level cut may overrun the cap (weighted
    # nodes); move the cheapest node out until every shard fits, or no
    # resident fits anywhere (deferred to the next finer level — always
    # resolvable at the finest, where weights are 1)
    while (loads > cap).any():
        a = int(np.argmax(loads))
        residents = np.flatnonzero(assignment == a)
        best = None                          # (-gain, id, u, target)
        for u in residents:
            fits = loads + nw[u] <= cap
            fits[a] = False
            if not fits.any():
                continue
            row = np.where(fits, aff[u], -np.inf)
            t = int(row.argmax())
            key = (aff[u, a] - row[t], u)
            if best is None or key < best[:2]:
                best = (*key, t)
        if best is None:
            break
        move(int(best[1]), a, int(best[2]))

    for _ in range(passes):
        own = aff[np.arange(n), assignment]
        masked = aff.copy()
        masked[np.arange(n), assignment] = -np.inf
        gain = masked.max(axis=1) - own
        order = np.lexsort((np.arange(n), -gain))
        moved = 0
        for u in order:
            if gain[u] <= 0:
                break                        # sorted: the rest were no
            a = int(assignment[u])           # better at pass start
            row = aff[u].copy()
            row[a] = -np.inf
            fits = loads + nw[u] <= cap
            fits[a] = False
            row = np.where(fits, row, -np.inf)
            t = int(row.argmax())
            if row[t] - aff[u, a] <= 0:
                continue
            move(u, a, t)
            moved += 1
        if moved == 0:
            break
    return assignment


def _multilevel_assignment(hier: CoarseHierarchy, shards: int, cap: int
                           ) -> np.ndarray:
    """Cut the coarsest level, then uncoarsen with refinement per level."""
    levels = hier.levels
    assignment = _initial_cut(levels[-1], shards, cap)
    assignment = _refine(levels[-1], assignment, shards, cap)
    for lvl in range(len(levels) - 2, -1, -1):
        assignment = assignment[levels[lvl + 1].parent]
        assignment = _refine(levels[lvl], assignment, shards, cap)
    if np.bincount(assignment, minlength=shards).max(initial=0) > cap:
        raise AssertionError("refinement left a shard over its load cap")
    return assignment.astype(np.int32)


def patch_halo(part: GraphShards, edge_index: np.ndarray) -> GraphShards:
    """GrAd delta on a partitioned graph (DESIGN.md §13): recompute the
    per-shard halo sets and the cut-edge count for an evolved edge list
    while KEEPING the node assignment and slot permutation. Edge-only
    deltas never move a node between shards — re-partitioning would (the
    greedy cut depends on the edges), which is exactly why the delta path
    must not: a fresh partition permutes the operand layout and the
    serving engine would owe a full slice rebuild. Same vectorized halo
    construction as `partition_graph`, O(E) host work."""
    src, dst = edge_index
    live = (src < part.num_nodes) & (dst < part.num_nodes)
    ls, ld = src[live], dst[live]
    cross = part.assignment[ls] != part.assignment[ld]
    halo = tuple(np.unique(ls[cross & (part.assignment[ld] == s)])
                 for s in range(part.shards))
    return dataclasses.replace(part, halo=halo, cut_edges=int(cross.sum()))


def partition_for_ladder(edge_index: np.ndarray, num_nodes: int, ladder,
                         shard_counts: Sequence[int],
                         method: str = "multilevel") -> GraphShards:
    """Bucket-aware shard-count selection: the smallest configured shard
    count whose balanced per-shard load admits into the ladder is chosen,
    and that load's bucket becomes the shard capacity. Raises ValueError
    when no configured count fits (mirroring `BucketLadder.bucket_for`).

    The coarsening hierarchy is shard-count-independent, so the multilevel
    path builds it ONCE (at the largest candidate count) and re-cuts per
    candidate — admission search stays linear in partitioner work instead
    of re-coarsening the whole graph for every rung."""
    counts = sorted(set(int(c) for c in shard_counts if int(c) >= 2))
    hier: Optional[CoarseHierarchy] = None
    if method == "multilevel" and counts:
        hier = coarsen_graph(edge_index, num_nodes, max_shards=max(counts))
    last_err: Optional[Exception] = None
    for s in counts:
        load = -(-num_nodes // s)
        try:
            bucket = ladder.bucket_for(load)
        except ValueError as e:      # even the balanced load is oversized
            last_err = e
            continue
        return partition_graph(edge_index, num_nodes, s, shard_cap=bucket,
                               method=method, hierarchy=hier)
    raise ValueError(
        f"graph with {num_nodes} nodes fits no configured shard count "
        f"{tuple(shard_counts)} on ladder buckets {ladder.buckets}"
    ) from last_err


def modelled_sharded_latency(part: GraphShards, *, in_feats: int, hidden: int,
                             classes: int, exchange_widths: Sequence[int],
                             compress: bool = True) -> float:
    """Modelled per-forward latency of the sharded plan (DESIGN.md §12):
    per-shard compute (the dominant O(C x full) aggregation scales ~1/S)
    plus one compressed-halo collective per exchanged layer width, charged
    at the DEVICE interconnect (the halo psum is device-to-device; it
    never crosses the host link). A 1-shard partition pays no wire at all
    — there is nobody to exchange with."""
    DENSE = costs.DENSE_RATE        # same dense rate as default_gnn_stages
    c, full = part.shard_cap, part.full_rows
    flops = 2.0 * c * (in_feats * hidden + hidden * classes)      # combine
    flops += 2.0 * c * full * (hidden + classes)                  # aggregate
    compute = flops / DENSE
    if part.shards == 1:
        return compute
    from repro_torch.dist.compress import ring_psum_nbytes
    bytes_per_elt = 1 if compress else 4
    wire = 0.0
    for w in exchange_widths:
        nbytes = ring_psum_nbytes(part.shards, full * w,
                                  bytes_per_elt=bytes_per_elt)
        wire += (costs.COLLECTIVE_LATENCY_S
                 + nbytes / costs.DEVICE_LINK_BYTES_PER_S)
    return compute + wire
