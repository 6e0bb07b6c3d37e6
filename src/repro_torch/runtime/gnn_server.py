"""GraphServe sync core: multi-graph, multi-bucket GCN, GAT and GraphSAGE
serving on one device.

Port of the synchronous serving path of the reference's
`runtime/gnn_server.py`:

  * NodePad / BucketLadder — every request's graph is padded into one rung
    of a shared bucket ladder, so each (model, bucket) runs one plan shape.
  * GraphSplit — padding and PreG normalization happen on the host at
    submit/query time; the device runs one dense forward per batch.
  * Batching — same-key requests stack along a leading batch dim at a FIXED
    width; partial batches repeat the last real request into the junk slots
    (outputs dropped), so the shapes never change. Batch selection is the
    reference's best-fill rule with its EDF tie-break (`edf_best_fill_key`).
  * Quality tiers (DESIGN.md §8) — a model registers `fp32` and QuantGr
    tiers (`int8`, `int8+grax`, which aliases `int8` for GCN). A QuantGr
    tier is calibrated once per (model, tier) (`calibrate()` or
    `attach(calibrate=True)`), its calibration rides the plan as a shared
    runtime argument, and each graph's int8 Â is derived once per
    structure version; an uncalibrated QuantGr tier serves through fp32,
    counted in `tier_fallbacks`.
  * Fused layers (DESIGN.md §11) — `fusion="layer"` runs each GCN layer
    through one CUDA kernel call (`fused_gcn_dense`, or `fused_gcn_int8`
    on a QuantGr tier); `fusion="none"` runs two matmuls per layer,
    through the `block_matmul` / `int8_matmul` kernels when the tier's
    Techniques set `use_pallas`. A GAT layer runs `fused_gat_full` (fp32
    tiers) or `fused_gat_precombined` after its int8 combine (QuantGr
    tiers) with `fusion="layer"`, and the `gat_attention` kernel with
    `fusion="none"` and `use_pallas` (its int8 combine through
    `int8_matmul`). A fp32 SAGE layer runs `fused_sage` with
    `fusion="layer"` (QuantGr SAGE does not fuse); with `fusion="none"`
    and `use_pallas` its mean aggregation runs `block_matmul`, its GrAx3
    max `sage_max`, and its int8 combines `int8_matmul`. Fusion joins the
    batch key and warmup runs both modes, as in the reference.
  * GraSp aggregation backend (DESIGN.md §10) — a model registered with
    `agg_backend="auto"` routes each graph by the density/cost rule
    (`core.sparsity.select_agg_backend`, H100 constants); `"grasp"` forces
    the block-sparse path where the graph's structure fits the bucket's
    `grasp_max_nnz` budget, and counts each ineligible request in
    `backend_fallbacks`. Grasp batches run `fused_gcn_grasp`
    (`fusion="layer"`) or `bitmap_spmm` (`fusion="none"`). QuantGr tiers
    always resolve dense. The backend joins the batch key and warmup runs
    both backends.
  * Zero-recompile — after `warmup()`, `assert_warm()` holds while requests
    stay within the ladder: plans count unseen argument signatures
    (`core.models.ExecutionPlan`), and so does the CacheG materializer.
  * CacheG (DESIGN.md §7, the default) — a request's structure crosses
    the link as bit-packed adjacency plus a degree vector
    (`core.models.prepare_host_operands`), SymG-triangular for undirected
    graphs, and the dense operands are materialized on the device
    (`realize_operands`). A directed GCN/GAT graph takes the eager dense
    upload, counted in `cacheg_fallbacks`. `use_cacheg=False` uploads
    every request's dense operands built on the host.

Attached graphs keep their device operands, their derived int8 Â and their
GraSp decision and structure (derived on the device from the cached Â by
`BlockCompactor`) in one byte-budgeted `runtime.cache.DeviceCacheManager`
keyed by (graph_id, structure_version) (DESIGN.md §13): a repeated query
moves no operand bytes, quantizes and compacts nothing. Under
`device_cache_budget_bytes` the manager evicts cost-aware LRU; an evicted
compact entry spills to pinned host memory and a later query re-uploads
only its compact bytes. `attach()` is the admission gate and `update()`
rebuilds a changed graph in full under a new version. A one-shot GraSp
request on the compact path decides and compacts on the device from the
materialized Â; on the eager path it builds its structure on the host
(`to_block_sparse`, padded to the budget) and counts its bytes in
`operand_bytes_h2d`.

GrAd edge deltas (DESIGN.md §13) — `update_delta(gid, add_edges,
remove_edges)` patches an attached undirected graph instead of rebuilding
it: the host patches its dense Â and adjacency (`apply_edge_delta`) and
its edge keys, and ships only the flips, the touched nodes and the
patched degree vector; the device patches the cached fp32 Â or GAT masks,
re-quantizes only the int8 Â rows that changed, and re-derives a GraSp
structure from the patched Â, each under the new version and equal bit
for bit to a rebuild. A delta past the warmed pad widths, a SAGE graph,
or `delta_pad_rows=0` falls back to `update()` (`delta_updates` against
`delta_fallbacks`).

Pipeline (DESIGN.md §9) — the sync path (`submit`/`query` + `run()`)
runs the host and device stages one after the other; `scheduler()`
attaches the two-stage pipeline of `runtime/scheduler.py`, whose host
worker threads run `prepare_submit`/`prepare_query` while one dispatcher
thread runs `_execute_batch`. On the card each host worker runs its stage
on its own CUDA stream, and the request's features are uploaded there
from a pinned copy. The request carries an event recorded at the end of
its host stage, and its device tensors carry `record_stream` for the
engine's dispatch stream, where `_execute_batch` waits on the events and
syncs only that stream. A device form goes into the cache only once its
stream has finished it, so another thread's stream never reads it half
written. One engine lock guards the uid and graph counters, `metrics`,
`finished`, the graph registry and the cache manager.

SLO serving (DESIGN.md §14) — `submit`/`query(deadline_ms=, tolerance=)`.
A request whose deadline passes before dispatch completes flagged with no
predictions (`deadline_misses`); one served late is delivered and
flagged. The `LatencyBank` keeps the measured span of every batch key,
seeded from `_modelled_batch_s`; the tolerance router picks the cheapest
calibrated tier whose accuracy delta fits, the backend rule takes the
measured dense/GraSp pair, and an optional `SLOGovernor` steps the
default tier down the ladder while the rolling p99 breaches its target.
Sharding (DESIGN.md §12, §15) — with `shard_counts`, a graph larger than
the top bucket attaches auto-sharded: `core.partition.partition_for_ladder`
(multilevel or greedy, `partition_method`) picks the smallest configured
shard count whose balanced load fits a bucket, and every query over it
runs a sharded plan (`core.models.build_sharded_plan`): each shard's rows
aggregated against the whole graph through its (shard_cap, full_rows)
operand row blocks, the halo exchange between layers (int8 on the wire
with `halo_compress`). One card holds every shard; the shard axis is a
leading tensor dimension, as the reference simulates it below its device
count. The shard count joins the batch key, a sharded key dispatches
`replica_groups` requests at once (one per replica row), the router and
the bank key it by the per-shard bucket, and warmup runs every (shard
count, bucket, tier), so mixed traffic replays warm. The cached unit is
the tuple of row blocks ("shard" in the cache manager), built from the
graph's materialized Â permuted into slot order on the device.
`update()` crosses the sharding boundary both ways; `update_delta`
patches the row blocks under the kept partition, bit-equal to a sharded
rebuild, and counts the boundary-dirty rows and the halo bytes a
distributed deployment would move (`delta_halo_bytes_*`).

On a mesh of ranks (`GraphServe(mesh=)`, `launch.mesh.make_shard_mesh`,
DESIGN.md §12, §15) the same engine runs SPMD, one process per (replica,
shard) cell: every rank makes the same calls in the same order (attach,
submit/query, run, update, update_delta, detach), with the same weights
and graphs. Each rank caches and serves only its own row block of every
sharded graph, runs its products through the same kernels, exchanges the
halo over the shard group (`build_sharded_plan(mesh=)`), and the logits
are gathered over the mesh. The rank at the mesh's origin (the lead)
takes every decision that reads a clock, the latency bank or its cache
(the expiry sweep, the batch, the tier the router or governor picked, and
attach()'s admission under a byte budget, which it broadcasts), and
broadcasts each sharded batch's uids and tier before its first
collective, so ranks whose clocks differ still run the same batches. It
alone serves unsharded requests: the other ranks give such a submit or
query its uid and skip it, as they skip the unsharded warmup. Partitions
are deterministic, and attach() and update() check that every rank's
equals the lead's. The lead's `summary()` equals a single-process
engine's on the same calls, apart from `cache_resident_bytes`, which
holds one row block of each sharded graph. The pipeline scheduler runs on
a mesh too (`scheduler()`, `runtime.scheduler`): the lead batches by its
own timing and tells the mesh each sharded batch, which the others run
in its order. On a mesh a scheduler's uids are bound at intake, in call
order, and a query reads its graph's version there, so every rank serves
the same request under the same uid whatever its host workers' timing.
While one is open, the caller's thread issues its collectives (attach()'s
admission, the partition check, the scheduler's intake and close) on a
gloo group of its own, made when the first scheduler opens, and the
dispatcher's thread alone uses the mesh's groups (the lead's messages,
the halo exchange, the gather of the logits).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import costs
from repro_torch.core.costs import transfer_cost
from repro_torch.core.graph import (BucketLadder, Graph, PaddedGraph,
                                    adjacency_keys, apply_edge_delta,
                                    edge_index_from_adjacency,
                                    keys_neighbours, pad_graph,
                                    patch_adjacency_keys)
from repro_torch.core.layers import Techniques
from repro_torch.core.models import (FUSION_MODES, OPERAND_FIELDS,
                                     AggQuantizer, BlockCompactor,
                                     DeltaPatcher, DeltaSpec,
                                     ExecutionPlan, GNNConfig,
                                     GranniteOperands, HostOperands,
                                     PlanKey, ShardSlice, TierOperands,
                                     build_operands, build_materializer,
                                     build_plan, build_sharded_operands,
                                     build_sharded_plan, calibrate_tier,
                                     compact_operands, forward_grannite,
                                     gcn_degree, init_params, is_symmetric,
                                     operand_nbytes, pinned_copy,
                                     prepare_host_operands, realize_operands,
                                     sharded_exchange_widths, stack_operands,
                                     stack_shard_slices, stack_tier_operands,
                                     unshard_logits)
from repro_torch.core.partition import (PARTITION_METHODS, GraphShards,
                                        partition_for_ladder, patch_halo)
from repro_torch.core.sparsity import (BlockSparse, block_stats,
                                       grasp_max_nnz, select_agg_backend)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.compress import ring_psum_nbytes
from repro_torch.dist.sharding import assemble
from repro_torch.runtime.cache import (CacheAdmissionError,
                                       DeviceCacheManager,
                                       estimate_dense_entry_bytes,
                                       estimate_shard_entry_bytes,
                                       tree_nbytes, tree_tensors)
from repro_torch.runtime.clock import WALL, Clock
from repro_torch.runtime.ewma import LatencyBank
from repro_torch.runtime.slo import SLOConfig, SLOGovernor

# Serving techniques for models registered without explicit Techniques.
DEFAULT_TECHNIQUES: Dict[str, Techniques] = {
    "gcn": Techniques(stagr=True, grad_dynamic=True, graphsplit=True),
    "gat": Techniques.full_gat(),
    "sage": Techniques.full_sage(),
}

# the standard quality tiers (`tier_techniques`), cheapest last
STANDARD_TIERS = ("fp32", "int8", "int8+grax")

# Aggregation-backend serving modes (register_model(agg_backend=...)):
# "dense" never dispatches GraSp, "auto" routes per graph by the modelled
# density/cost rule, "grasp" forces the sparse path where eligible.
AGG_BACKEND_MODES = ("dense", "auto", "grasp")

# (model, bucket, tier, agg backend, fusion mode, shard count — 0 unsharded)
BatchKey = Tuple[str, int, str, str, str, int]

# the lead's messages to the other ranks of a mesh (`GraphServe._tell`):
# the end of serving, a sharded batch, or no batch (the expiries alone;
# in the deterministic pipeline also the end of the lead's inline drive)
_DONE, _BATCH, _PAUSE = 0, 1, 2


def best_fill_key(stats: Dict[BatchKey, Tuple[int, int]], batch_slots: int,
                  last_dispatch: Optional[Dict[str, int]] = None,
                  *, replica_slots: int = 1) -> BatchKey:
    """Pick the batch key to dispatch next (DESIGN.md §9).

    `stats` maps each pending key to `(count, head_order)`. Selection
    order: best fill (most waiting requests, capped at the key's width),
    then per-model fairness (the model dispatched longest ago), then FIFO
    (oldest head request). Sharded keys (`key[5] > 0`) fill
    `replica_slots`; unsharded keys fill `batch_slots`.
    """
    last_dispatch = last_dispatch or {}

    def width(k: BatchKey) -> int:
        return replica_slots if k[5] else batch_slots

    return min(stats.items(),
               key=lambda kv: (-min(kv[1][0], width(kv[0])) / width(kv[0]),
                               last_dispatch.get(kv[0][0], -1),
                               kv[1][1]))[0]


def edf_best_fill_key(stats: Dict[BatchKey, Tuple[int, int, float]],
                      batch_slots: int,
                      last_dispatch: Optional[Dict[str, int]] = None,
                      *, replica_slots: int = 1) -> BatchKey:
    """Slack-aware variant of `best_fill_key` (DESIGN.md §14): `stats`
    values are `(count, head_order, min_slack)`; among equal fills the key
    whose most urgent request expires soonest goes first, then per-model
    fairness, then FIFO. Deadline-free traffic (slack +inf everywhere)
    batches exactly as `best_fill_key`."""
    last_dispatch = last_dispatch or {}

    def width(k: BatchKey) -> int:
        return replica_slots if k[5] else batch_slots

    return min(stats.items(),
               key=lambda kv: (-min(kv[1][0], width(kv[0])) / width(kv[0]),
                               kv[1][2],
                               last_dispatch.get(kv[0][0], -1),
                               kv[1][1]))[0]


def pending_stats(reqs: Sequence["GNNRequest"]
                  ) -> Dict[BatchKey, Tuple[int, int]]:
    """Fold a pending-request sequence into `best_fill_key` stats."""
    stats: Dict[BatchKey, Tuple[int, int]] = {}
    for i, r in enumerate(reqs):
        k = (r.model, r.bucket, r.tier, r.backend, r.fusion, r.shards)
        c = stats.get(k)
        stats[k] = (1, i) if c is None else (c[0] + 1, c[1])
    return stats


def edf_pending_stats(reqs: Sequence["GNNRequest"], now: float
                      ) -> Dict[BatchKey, Tuple[int, int, float]]:
    """Fold pending requests into `edf_best_fill_key` stats at time `now`."""
    stats: Dict[BatchKey, Tuple[int, int, float]] = {}
    for i, r in enumerate(reqs):
        k = (r.model, r.bucket, r.tier, r.backend, r.fusion, r.shards)
        slack = (r.deadline_s - now if r.deadline_s is not None
                 else float("inf"))
        c = stats.get(k)
        stats[k] = ((1, i, slack) if c is None
                    else (c[0] + 1, c[1], min(c[2], slack)))
    return stats


def tier_techniques(kind: str) -> Dict[str, Techniques]:
    """The standard quality-tier registry for one model kind (DESIGN.md §8).

    `fp32` is the exact dense serving path, the accuracy reference every
    other tier's delta is measured against. `int8` switches the combine
    matmuls (and, for GCN, the Â aggregation) to QuantGr. `int8+grax` adds
    the kind's GrAx approximations; GCN has none, so its `int8+grax`
    aliases the int8 Techniques and shares its plans.
    """
    fp32 = {"gcn": Techniques(stagr=True, grad_dynamic=True, graphsplit=True),
            "gat": Techniques(stagr=True, graphsplit=True, effop=True),
            "sage": Techniques(stagr=True, graphsplit=True, effop=True)}[kind]
    int8 = dataclasses.replace(fp32, quantgr=True)
    grax = {"gcn": int8,
            "gat": dataclasses.replace(int8, grax1=True, grax2=True),
            "sage": dataclasses.replace(int8, grax3=True)}[kind]
    return {"fp32": fp32, "int8": int8, "int8+grax": grax}


def _delta_points(base_logits, tier_logits, pg: PaddedGraph) -> float:
    """`accuracy_delta_vs_fp32` in percentage points, on the held-out batch.

    Labeled calibration graphs score top-1 accuracy on `test_mask` (the
    held-out split; all labeled nodes when no mask exists); unlabeled ones
    fall back to argmax agreement with the fp32 tier, shifted so 0.0 still
    reads "identical predictions" and negative "divergence".
    """
    n = pg.num_nodes
    bp = np.asarray(base_logits)[:n].argmax(-1)
    tp = np.asarray(tier_logits)[:n].argmax(-1)
    if pg.labels is not None:
        labels = np.asarray(pg.labels)[:n]
        mask = labels >= 0
        if pg.test_mask is not None and np.asarray(pg.test_mask)[:n].any():
            mask = mask & np.asarray(pg.test_mask)[:n]
        if mask.any():
            acc_b = float((bp[mask] == labels[mask]).mean())
            acc_t = float((tp[mask] == labels[mask]).mean())
            return (acc_t - acc_b) * 100.0
    return (float((tp == bp).mean()) - 1.0) * 100.0


@dataclasses.dataclass
class GNNRequest:
    uid: int
    model: str
    pg: PaddedGraph
    ops: GranniteOperands
    bucket: int
    submitted_s: float
    tier: str = "fp32"                     # resolved tier
    backend: str = "dense"                 # resolved agg backend (§10)
    fusion: str = "none"                   # resolved fusion mode (§11)
    tier_ops: Optional[TierOperands] = None  # derived int8 Â (QuantGr GCN)
    x: Optional[torch.Tensor] = None       # (cap, F) features on the device,
    # uploaded in the host stage
    ready: Optional["torch.cuda.Event"] = None  # CUDA: recorded on the host
    # stage's stream after its device work; the dispatch stream waits on it
    deadline_s: Optional[float] = None     # absolute clock deadline (§14);
    # None = no SLO: the request never expires and is never flagged late
    tolerance: Optional[float] = None      # most |accuracy_delta| (points)
    # the tier router may trade away (§14); None = no tolerance routing
    deadline_missed: bool = False          # §14: expired unserved (preds is
    # None) or finished past its deadline (preds still delivered)
    shards: int = 0                        # >0: a sharded dispatch (§12);
    # then `ops` holds the STACKED (S, C, full) operand row blocks (on a
    # mesh, this rank's (C, full) block) and the three fields below carry
    # the rest of the sharded calling convention
    part: Optional[GraphShards] = None     # the partition (unshard map)
    shard_x: Optional[torch.Tensor] = None  # (S, C, F) stacked features
    shard_mask: Optional[torch.Tensor] = None  # (S, C) real-row masks
    finished_s: float = 0.0
    done: bool = False
    preds: Optional[np.ndarray] = None     # (num_nodes,) argmax classes
    logits: Optional[np.ndarray] = None    # (num_nodes, C) if return_logits


@dataclasses.dataclass
class GraphServeConfig:
    ladder: BucketLadder = dataclasses.field(default_factory=BucketLadder)
    batch_slots: int = 4                   # fixed batch width per dispatch
    return_logits: bool = False
    use_cacheg: bool = True                # CacheG operand pipeline (§7);
    # False = eager host-built dense operands uploaded per request
    device_cache_budget_bytes: Optional[int] = None   # §13: byte budget the
    # operand caches share; None keeps them unbounded
    spill_to_host: bool = True             # §13: evicted compact primaries
    # keep a pinned host-RAM form, re-materialized on fault; False drops them
    admission: str = "evict"               # §13 attach() policy when a new
    # graph's projected operands overflow the budget: "evict" admits and
    # lets insert-time eviction make room, "reject" raises
    delta_pad_rows: int = 64               # §13 GrAd threshold: most touched
    # nodes update_delta() patches on the device (flips pad to twice this,
    # re-quantized int8 rows too); larger deltas, and 0, take update()
    shard_counts: Tuple[int, ...] = ()     # §12: shard counts attach() may
    # auto-shard a graph above the top bucket across; () disables sharding
    halo_compress: bool = True             # int8 QuantGr on the halo wire;
    # False exchanges exact fp32 (4x the collective bytes)
    replica_groups: int = 1                # §15: sharded dispatch width, R
    # sharded requests per plan call, each exchanging within itself
    partition_method: str = "multilevel"   # §15 partitioner of attach()'s
    # auto-sharding: "multilevel" (coarsen + KL/FM refine) or "greedy"


@dataclasses.dataclass
class _ModelEntry:
    cfg: GNNConfig
    params: Dict
    tiers: Dict[str, Techniques]           # tier name -> execution variant
    default_tier: str
    agg_backend: str = "dense"             # "dense" | "auto" | "grasp" (§10)
    default_fusion: str = "none"           # "none" | "layer" (§11)
    name: str = ""                         # registry name (the bank's key)
    # once per (model, tier): calibrate_tier results for QuantGr tiers, and
    # the measured accuracy_delta_vs_fp32 for every non-fp32 tier
    calibrations: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    accuracy_delta: Dict[str, float] = dataclasses.field(default_factory=dict)


class GraphServe:
    def __init__(self, sc: Optional[GraphServeConfig] = None, *, seed: int = 0,
                 clock: Optional[Clock] = None,
                 slo: Optional[SLOConfig] = None, device: DeviceLike = None,
                 mesh=None):
        self.sc = sc or GraphServeConfig()
        if self.sc.admission not in ("evict", "reject"):
            raise ValueError(f"unknown admission policy "
                             f"{self.sc.admission!r}; pick evict|reject")
        if self.sc.partition_method not in PARTITION_METHODS:
            raise ValueError(f"unknown partition method "
                             f"{self.sc.partition_method!r}; pick from "
                             f"{PARTITION_METHODS}")
        if self.sc.replica_groups < 1:
            raise ValueError(f"replica_groups must be >= 1, got "
                             f"{self.sc.replica_groups}")
        # the mesh of ranks this engine is one of (None: one process);
        # `device` defaults to the mesh's
        self.mesh = mesh
        if mesh is not None:
            self._check_mesh(mesh)
            device = device if device is not None else mesh.device
        self.device = resolve_device(device)
        self.seed = seed
        # every timestamp, deadline and latency sample reads this clock;
        # tests inject a fake one and drive the SLO loop in virtual time
        self.clock = clock if clock is not None else WALL
        # measured latency per batch key, seeded from the cost model: the
        # cost source of the backend rule and the tolerance router (§14)
        self.bank = LatencyBank()
        # the optional SLO governor; None serves without one
        self.governor = SLOGovernor(slo) if slo is not None else None
        # one lock guards the uid/gid counters, metrics, finished, the
        # graph registry, the bank and the cache manager: the scheduler's
        # host workers prepare requests while update()/detach() arrive
        # from the caller. Never call a lock-taking helper while holding it.
        self._lock = threading.Lock()
        # the stream every batch dispatches on (`_execute_batch`); host
        # stages hand their requests over to it (`_hand_over`)
        self._dispatch_stream = (torch.cuda.Stream(self.device)
                                 if self.device.type == "cuda" else None)
        # the host stages' streams, one per scheduler worker index, made
        # once and kept (`host_stream`)
        self._host_streams: List["torch.cuda.Stream"] = []
        self.models: Dict[str, _ModelEntry] = {}
        self.queue: List[GNNRequest] = []
        self.finished: List[GNNRequest] = []
        self.graphs: Dict[int, Tuple[str, PaddedGraph]] = {}
        self._graph_version: Dict[int, int] = {}
        # each attached graph's `adjacency_keys` (None without CacheG)
        self._graph_keys: Dict[int, Optional[np.ndarray]] = {}
        # the sharded registry (§12): graph_id -> (partition, source Graph)
        # of the graphs attach() or update() sharded past the top bucket
        self._sharded: Dict[int, Tuple[GraphShards, Graph]] = {}
        # the device-resident operand hierarchy of attached graphs, keyed
        # by (graph_id, version): the primary fp32 operands ("operand") and
        # their derived forms, GCN's int8 Â ("tier") and the GraSp
        # decision with its structure ("grasp"), or a sharded graph's
        # tuple of row blocks ("shard"), under one byte budget
        self._cache = DeviceCacheManager(
            budget_bytes=self.sc.device_cache_budget_bytes,
            spill_to_host=self.sc.spill_to_host)
        self._materializer = build_materializer(self.device)
        self._agg_quantizer = AggQuantizer()
        self._block_compactor = BlockCompactor()
        self._delta_patcher = DeltaPatcher()
        self._plans: Dict[PlanKey, ExecutionPlan] = {}
        self._warm_blobs: Optional[int] = None
        self._uid = 0
        self._gid = 0
        self._dispatch_serial = 0
        self._last_dispatch: Dict[str, int] = {}   # model -> dispatch serial
        # the lead's sharded uids expired since its last message (a mesh)
        self._expired_out: List[int] = []
        # on a mesh: the caller thread's own gloo group, made when the
        # first scheduler opens, and the scheduler open now
        self._caller_group = None
        self._open_scheduler = None
        self.metrics = {"batches": 0, "slots_filled": 0, "slots_total": 0,
                        "rebucket_events": 0, "latency_s": [],
                        "first_submit_s": None, "last_finish_s": None,
                        "device_busy_s": 0.0, "operand_bytes_h2d": 0,
                        "operand_cache_hits": 0, "operand_cache_misses": 0,
                        "cacheg_fallbacks": 0, "tier_fallbacks": 0,
                        "grasp_batches": 0, "backend_fallbacks": 0,
                        "cache_spill_hits": 0, "cache_admission_rejects": 0,
                        "delta_updates": 0, "delta_fallbacks": 0,
                        "delta_bytes_h2d": 0,
                        "deadline_misses": 0, "shed_requests": 0,
                        "sharded_batches": 0, "halo_bytes_exchanged": 0,
                        "collective_bytes_compressed": 0,
                        "collective_bytes_exact": 0,
                        # §15 halo-delta wire accounting: what the dirty
                        # boundary rows of sharded deltas would move, what
                        # a full halo re-exchange would, and the rows
                        "delta_halo_bytes_exchanged": 0,
                        "delta_halo_bytes_full": 0,
                        "delta_dirty_rows": 0}

    def _check_mesh(self, mesh) -> None:
        """Raise unless this config serves on `mesh`: its shape is
        (replica_groups x) shards, and the one shard count is the mesh's."""
        want = {"shard": mesh.shape.get("shard")}
        if self.sc.replica_groups > 1:
            want = {"replica": self.sc.replica_groups, **want}
        if dict(mesh.shape) != want:
            raise ValueError(f"replica_groups={self.sc.replica_groups} "
                             f"serves on a mesh of shape {want}, not "
                             f"{dict(mesh.shape)}")
        if tuple(self.sc.shard_counts) != (mesh.shape["shard"],):
            raise ValueError(f"on a mesh of {mesh.shape['shard']} shards, "
                             f"shard_counts must be ({mesh.shape['shard']},)"
                             f", not {tuple(self.sc.shard_counts)}: every "
                             f"sharded graph takes one rank per shard")

    @property
    def _lead(self) -> bool:
        """Whether this engine takes the decisions and serves unsharded
        requests: one process, or the mesh's origin rank."""
        return self.mesh is None or self.mesh.is_first

    def _mesh_group(self):
        """The process group of every rank of the mesh."""
        return self.mesh.group(*self.mesh.axis_names)

    def _row0(self, shard_cap: int) -> int:
        """This rank's first slot row of a sharded graph."""
        return self.mesh.coords["shard"] * shard_cap

    def _broadcast(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """The lead's `t` on every rank of the mesh (in place), over
        `group` (default the mesh's)."""
        dist.broadcast(t, src=self.mesh.first_rank,
                       group=group if group is not None
                       else self._mesh_group())
        return t

    def _caller_comm(self):
        """(group, device) of the collectives the caller's thread issues:
        the mesh's group and device, or, once a scheduler made it, the
        caller's own gloo group on the CPU (a scheduler's dispatcher
        thread holds the mesh's groups; gloo pairs a group's collectives
        by their order, so two threads never share one)."""
        if self._caller_group is None:
            return self._mesh_group(), self.device
        return self._caller_group, torch.device("cpu")

    def _agree_partition(self, part: GraphShards) -> None:
        """On a mesh: raise on every rank unless every rank's partition
        is the lead's (`partition_for_ladder` is deterministic, so they
        are; a rank that differed would exchange the wrong rows)."""
        if self.mesh is None:
            return
        group, dev = self._caller_comm()
        perm = torch.from_numpy(np.asarray(part.perm, np.int64)).to(dev)
        differs = (self._broadcast(perm.clone(), group) != perm).any()
        differs = differs.to(torch.int64).reshape(1)
        dist.all_reduce(differs, op=dist.ReduceOp.MAX, group=group)
        if differs.item():
            raise RuntimeError("the ranks of the mesh partitioned a graph "
                               "differently")

    def _agree_call(self, row: Sequence[int], decision: int) -> int:
        """On a mesh, from the caller's thread: every rank's `row` (what
        call it makes, and where) and the lead's `decision`, gathered;
        raises on every rank unless the rows are equal, else returns the
        lead's decision on every rank."""
        group, dev = self._caller_comm()
        mine = torch.tensor([*row, decision], dtype=torch.int64, device=dev)
        rows = [torch.empty_like(mine)
                for _ in range(dist.get_world_size(group))]
        dist.all_gather(rows, mine, group=group)
        calls = [tuple(r[:-1].tolist()) for r in rows]
        if len(set(calls)) > 1:
            raise RuntimeError(f"the ranks of the mesh made different calls"
                               f" (rank: call, uid, sharded): "
                               f"{dict(enumerate(calls))}")
        return int(rows[0][-1])

    def _agree_ready(self, ok: bool) -> bool:
        """From the dispatcher's thread, before a sharded batch's first
        collective: whether every rank of the mesh holds the batch."""
        t = torch.tensor([int(ok)], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._mesh_group())
        return bool(t.item())

    def _take_uid(self) -> int:
        """The next request uid."""
        with self._lock:
            uid = self._uid
            self._uid += 1
        return uid

    def _stamp(self, submitted_s: float, uid: Optional[int]) -> int:
        """The end of a host stage: the request's uid (`uid`, bound at
        intake, or the next one) and the first submit's time."""
        with self._lock:
            if uid is None:
                uid = self._uid
                self._uid += 1
            if self.metrics["first_submit_s"] is None:
                self.metrics["first_submit_s"] = submitted_s
        return uid

    def _count(self, name: str, delta=1) -> None:
        with self._lock:
            self.metrics[name] += delta

    # ------------------------------------------------------- streams
    def _settle(self) -> None:
        """Wait for the work queued on the calling thread's stream: a
        device form is complete before another thread may read it."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _hand_over(self, req: GNNRequest) -> GNNRequest:
        """End of a host stage on the card: the request's device tensors
        are marked as read on the dispatch stream (`record_stream`), and
        an event recorded on this thread's stream lets the dispatch
        stream wait for their device work (`_execute_batch`)."""
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            if stream != self._dispatch_stream:
                for t in tree_tensors((req.x, req.ops, req.tier_ops,
                                       req.shard_x, req.shard_mask)):
                    t.record_stream(self._dispatch_stream)
            req.ready = torch.cuda.Event()
            req.ready.record(stream)
        return req

    def host_stream(self, i: int) -> Optional["torch.cuda.Stream"]:
        """The stream of scheduler host worker `i` (None on the CPU). The
        engine keeps it, so a later scheduler's worker `i` reuses it and
        the caching allocator's pool for that stream, which a new stream
        would fill again with fresh device allocations."""
        if self.device.type != "cuda":
            return None
        with self._lock:
            while len(self._host_streams) <= i:
                self._host_streams.append(torch.cuda.Stream(self.device))
            return self._host_streams[i]

    def _dispatching(self):
        """The dispatch stream as the current stream (the CPU has none)."""
        if self._dispatch_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._dispatch_stream)

    def _upload_features(self, pg: PaddedGraph) -> torch.Tensor:
        """One request's (cap, F) features on the device: on the card a
        copy queued on the calling thread's stream from a pinned copy."""
        x = torch.from_numpy(pg.features)
        if self.device.type == "cuda":
            return pinned_copy(x).to(self.device, non_blocking=True)
        return x

    # ----------------------------------------------------- cache views
    # (snapshots of the cache manager as plain {key: value} dicts)
    @property
    def _operands(self) -> Dict[Tuple[int, int], GranniteOperands]:
        return self._cache.view("operand")

    @property
    def _tier_operands(self) -> Dict[Tuple[int, int], TierOperands]:
        return self._cache.view("tier")

    @property
    def _grasp(self) -> Dict[Tuple[int, int],
                             Tuple[str, Optional[BlockSparse]]]:
        return self._cache.view("grasp")

    @property
    def _shard_cache(self) -> Dict[Tuple[int, int], Tuple[ShardSlice, ...]]:
        return self._cache.view("shard")

    # ------------------------------------------------------------------ setup
    def register_model(self, name: str, cfg: GNNConfig,
                       params: Optional[Dict] = None, *,
                       techniques: Optional[Techniques] = None,
                       tiers: Union[None, Sequence[str],
                                    Dict[str, Techniques]] = None,
                       default_tier: str = "fp32",
                       agg_backend: str = "dense",
                       fusion: str = "none") -> None:
        """Register a GCN, GAT or SAGE under `name` with its quality-tier
        registry.

        `params` (nested dict of tensors on the engine's device, e.g. from
        `bridge.params_from_jax`) defaults to a seeded init. `tiers` may be
        None (the single tier {"fp32": techniques or the default}), a
        sequence of standard tier names (`tier_techniques`), or a full
        {name: Techniques} dict; it must hold a non-QuantGr "fp32" tier,
        the accuracy reference and the uncalibrated fallback.
        `agg_backend` is the model's GraSp mode (`AGG_BACKEND_MODES`):
        "dense", "auto" (per-graph density/cost rule) or "grasp" (forced
        where the structure fits the bucket budget; ineligible graphs
        serve dense, counted in `backend_fallbacks`). QuantGr tiers, GAT
        and SAGE (whose aggregations have no block-sparse form) always
        resolve dense, so a non-"dense" mode on them is a no-op, not an
        error.
        `fusion` is the model's default fused-layer mode; requests may
        override it per call.
        """
        if cfg.kind not in DEFAULT_TECHNIQUES:
            raise ValueError(f"unknown model kind {cfg.kind!r}; pick from "
                             f"{sorted(DEFAULT_TECHNIQUES)}")
        if tiers is None:
            registry = {"fp32": techniques if techniques is not None
                        else DEFAULT_TECHNIQUES[cfg.kind]}
        else:
            if techniques is not None:
                raise ValueError(
                    "pass per-tier Techniques inside `tiers`, not both "
                    "`techniques` and `tiers`")
            if isinstance(tiers, dict):
                registry = dict(tiers)
            else:
                std = tier_techniques(cfg.kind)
                unknown = [tn for tn in tiers if tn not in std]
                if unknown:
                    raise ValueError(
                        f"unknown standard tier name(s) {unknown}; pick "
                        f"from {sorted(std)} or pass a "
                        f"{{name: Techniques}} dict")
                registry = {tn: std[tn] for tn in tiers}
        if "fp32" not in registry:
            raise ValueError("tier registry must include 'fp32' (the "
                             "accuracy reference / calibration fallback)")
        if registry["fp32"].quantgr:
            raise ValueError("the 'fp32' tier cannot enable QuantGr — it "
                             "is the uncalibrated-fallback path; register "
                             "quantized variants under another tier name")
        if default_tier not in registry:
            raise ValueError(f"default tier {default_tier!r} not in "
                             f"{sorted(registry)}")
        if agg_backend not in AGG_BACKEND_MODES:
            raise ValueError(f"unknown agg_backend mode {agg_backend!r}; "
                             f"pick from {AGG_BACKEND_MODES}")
        if fusion not in FUSION_MODES:
            raise ValueError(f"unknown fusion mode {fusion!r}; "
                             f"pick from {FUSION_MODES}")
        if params is None:
            params = init_params(torch.Generator().manual_seed(self.seed),
                                 cfg, device=self.device)
        for layer in params.values():
            for k, v in layer.items():
                if v.device != self.device:
                    raise ValueError(f"parameter {k!r} lies on {v.device}, "
                                     f"the engine on {self.device}")
        self.models[name] = _ModelEntry(cfg=cfg, params=params,
                                        tiers=registry,
                                        default_tier=default_tier,
                                        agg_backend=agg_backend,
                                        default_fusion=fusion, name=name)

    def _modelled_batch_s(self, model: str, bucket: int, tier: str,
                          backend: str, shards: int = 0) -> float:
        """The latency bank's modelled seed (§14): seconds for one
        dispatch under this key. Per layer one dense (cap, cap) @ (cap,
        w) aggregation and the (cap, w_in) @ (w_in, w_out) combine, each
        the larger of its products at `costs.DENSE_RATE` (the measured
        rate of the 3xTF32 kernel) and its bytes at `costs.HBM_BW`, times
        the batch width. GraSp halves the aggregation; an int8 tier runs
        its combines at `costs.INT8_RATE` over a quarter of the bytes.
        The seed only orders cold keys: the first measured sample
        replaces it, and `ewma_vs_model` in `summary()` says how far off
        it was. A sharded key (`shards` > 0) prices its per-shard bucket
        times `replica_groups`, as the reference does. Reads the constants
        at call time (tests set the reference's)."""
        cfg = self.models[model].cfg
        widths = [cfg.in_feats, cfg.hidden, cfg.num_classes]
        cap = bucket
        quant = self.models[model].tiers[tier].quantgr
        total = 0.0
        for w_in, w_out in zip(widths[:-1], widths[1:]):
            agg_flops = 2.0 * cap * cap * w_in
            agg_bytes = 4.0 * (cap * cap + 2 * cap * w_in)
            agg = max(agg_flops / costs.DENSE_RATE, agg_bytes / costs.HBM_BW)
            if backend == "grasp":
                agg *= 0.5
            comb_flops = 2.0 * cap * w_in * w_out
            comb_bytes = 4.0 * cap * (w_in + w_out) + 4.0 * w_in * w_out
            rate, byte_scale = ((costs.INT8_RATE, 0.25) if quant
                                else (costs.DENSE_RATE, 1.0))
            comb = max(comb_flops / rate,
                       comb_bytes * byte_scale / costs.HBM_BW)
            total += agg + comb
        return total * (self.sc.replica_groups if shards
                        else self.sc.batch_slots)

    @staticmethod
    def _bank_key(model: str, bucket: int, tier: str, backend: str,
                  fusion: str, shards: int = 0) -> BatchKey:
        return (model, bucket, tier, backend, fusion, shards)

    def _seed_bank(self, model: str, bucket: int, tier: str, backend: str,
                   fusion: str, shards: int = 0) -> None:
        seed = self._modelled_batch_s(model, bucket, tier, backend, shards)
        with self._lock:
            self.bank.seed(self._bank_key(model, bucket, tier, backend,
                                          fusion, shards), seed)

    def plan_for(self, model: str, bucket: int, tier: Optional[str] = None,
                 backend: str = "dense", fusion: str = "none",
                 shards: int = 0) -> ExecutionPlan:
        # keyed by the plan's full identity, not the (model, tier) names:
        # params are runtime args, so models with identical (cfg,
        # techniques, backend, fusion, shards) share one plan per bucket
        e = self.models[model]
        tier_name = tier if tier is not None else e.default_tier
        t = e.tiers[tier_name]
        # every plan resolution (warmup's too) seeds the bank's modelled
        # figure for its batch key, so routing has a cost ordering before
        # the first measured sample
        if shards:
            # sharded plans (§12) are dense, unfused single-graph plans:
            # the shard axis takes the leading dim and `bucket` is the
            # PER-SHARD capacity
            self._seed_bank(model, bucket, tier_name, "dense", "none", shards)
            key: PlanKey = (e.cfg, bucket, 0, t, "dense", "none", shards)
            if key not in self._plans:
                self._plans[key] = build_sharded_plan(
                    e.cfg, bucket, shards, t, compress=self.sc.halo_compress,
                    replicas=self.sc.replica_groups, device=self.device,
                    mesh=self.mesh)
            return self._plans[key]
        self._seed_bank(model, bucket, tier_name, backend, fusion)
        key = (e.cfg, bucket, self.sc.batch_slots, t, backend, fusion, 0)
        if key not in self._plans:
            self._plans[key] = build_plan(e.cfg, bucket, t,
                                          batch_size=self.sc.batch_slots,
                                          backend=backend, fusion=fusion,
                                          device=self.device)
        return self._plans[key]

    @property
    def compiled_blobs(self) -> int:
        """Distinct argument signatures seen, summed over all plans, the
        CacheG materializer (one per (bucket, fieldset)), the tier-operand
        deriver (one per bucket with a QuantGr GCN tier), the GraSp
        block compactor (two per bucket with a grasp-capable model: the
        counts reduction and the gather) and the GrAd delta patcher (one
        per bucket and GCN/GAT fieldset, and one row re-quantization per
        bucket with a QuantGr GCN tier, when `delta_pad_rows > 0`)."""
        return (sum(p.trace_count for p in self._plans.values())
                + self._materializer.trace_count
                + self._agg_quantizer.trace_count
                + self._block_compactor.trace_count
                + self._delta_patcher.trace_count)

    def warmup(self, *, buckets: Optional[Tuple[int, ...]] = None) -> int:
        """Run every (model, bucket, tier, backend, fusion) plan once on
        placeholder inputs of the serving shapes — both fusion modes, as in
        the reference, so mixed fused/unfused traffic replays warm. On the
        card this also builds the CUDA kernels. With CacheG the placeholder
        operands come through the materializer, which warms its one trace
        per (bucket, fieldset). A grasp-capable model also
        warms both halves of the block compactor and its grasp plans
        (non-QuantGr tiers) on a placeholder structure at the bucket's
        `grasp_max_nnz` budget, so mixed dense/grasp traffic replays warm.

        QuantGr tiers not yet calibrated warm against a throwaway
        calibration of the placeholder graph: its shapes depend only on the
        model config, so the plan replays warm when the real calibration
        arrives; the placeholder is never stored. These calls also warm the
        tier-operand deriver. On CacheG a GCN or GAT model also warms the
        delta patcher (`_warm_delta`). With `shard_counts`, a last leg
        warms every sharded plan (shard count x bucket x tier) on
        placeholder row blocks, and the delta patcher at each full row
        count (`_warm_sharded`), so a graph that shards after warmup and
        mixed sharded/unsharded traffic replay warm. On a mesh every rank
        warms the sharded leg (its plans exchange, so all ranks call
        warmup() together) and only the lead the unsharded one. Returns
        `compiled_blobs`."""
        buckets = buckets if buckets is not None else self.sc.ladder.buckets
        b = self.sc.batch_slots
        warm_cal: Dict[Tuple[str, str], Dict] = {}
        warmed: set = set()
        for bucket in (buckets if self._lead else ()):
            empty = pad_graph(Graph(edge_index=np.zeros((2, 0), np.int32),
                                    num_nodes=1,
                                    features=np.zeros((1, 1), np.float32)),
                              capacity=bucket)
            for name, e in self.models.items():
                if self.sc.use_cacheg:
                    single = self._materializer(compact_operands(empty,
                                                                 e.cfg))
                else:
                    single = build_operands(empty, e.cfg, device=self.device)
                ops = stack_operands([single] * b)
                x = torch.zeros((b, bucket, e.cfg.in_feats),
                                dtype=torch.float32, device=self.device)
                ops_grasp = None
                if self._grasp_capable(e):
                    self._block_compactor.counts(single.norm_adj)
                    bsp, _ = self._block_compactor(
                        single.norm_adj, max_nnz=grasp_max_nnz(bucket))
                    ops_grasp = stack_operands(
                        [dataclasses.replace(single, block_sparse=bsp)] * b)
                for tier, t in e.tiers.items():
                    backends = ("dense",) if (ops_grasp is None or t.quantgr
                                              ) else ("dense", "grasp")
                    for backend, fusion in itertools.product(backends,
                                                             FUSION_MODES):
                        # alias tiers (GCN int8+grax == int8) share a plan
                        plan = self.plan_for(name, bucket, tier, backend,
                                             fusion)
                        if (name, plan.key) in warmed:
                            continue
                        warmed.add((name, plan.key))
                        quant = e.calibrations.get(tier)
                        if quant is None and t.quantgr:
                            if (name, tier) not in warm_cal:
                                warm_cal[(name, tier)] = calibrate_tier(
                                    e.params, e.cfg, x[0], single)
                            quant = warm_cal[(name, tier)]
                        tops = None
                        if self._needs_tier_ops(e, tier):
                            tops = stack_tier_operands(
                                [self._agg_quantizer(single.norm_adj)] * b)
                        plan(e.params, x,
                             ops_grasp if backend == "grasp" else ops,
                             quant, tops)
                self._warm_delta(e, bucket, single, warmed)
        for shards in sorted({int(n) for n in self.sc.shard_counts
                              if int(n) >= 2}):
            for bucket in buckets:
                for name, e in self.models.items():
                    self._warm_sharded(name, e, shards, bucket, warm_cal,
                                       warmed)
        self._sync()
        self._warm_blobs = self.compiled_blobs
        return self._warm_blobs

    def _warm_sharded(self, name: str, e: _ModelEntry, shards: int,
                      bucket: int, warm_cal: Dict, warmed: set) -> None:
        """Warm one model's sharded plans at (shards, bucket) on
        placeholder inputs of the sharded calling convention: (R?, S, C,
        F) features, (R?, S, C, S*C) row blocks for the kind's fields,
        all-padding node masks (R only with `replica_groups` > 1); on a
        mesh, this rank's (C, F), (C, S*C) and (C,) block. An uncalibrated
        QuantGr tier warms against the unsharded leg's throwaway
        calibration (made here where that leg did not run). A GCN or GAT
        model also warms the delta patcher at the (full, full) matrices a
        sharded delta patches (a rank's (C, full) row block)."""
        full = shards * bucket
        lead = ((self.sc.replica_groups, shards)
                if self.sc.replica_groups > 1 else (shards,))
        if self.mesh is not None:
            lead = ()                       # this rank's block alone
        dev = self.device
        fields = OPERAND_FIELDS[e.cfg.kind]
        x = torch.zeros((*lead, bucket, e.cfg.in_feats), device=dev)
        mask = torch.zeros((*lead, bucket), device=dev)
        ops = GranniteOperands(**{
            f: torch.zeros((*lead, bucket, full), device=dev)
            for f in fields})
        for tier, t in e.tiers.items():
            plan = self.plan_for(name, bucket, tier, shards=shards)
            if (name, plan.key) in warmed:
                continue
            warmed.add((name, plan.key))
            quant = e.calibrations.get(tier)
            if quant is None and t.quantgr:
                if (name, tier) not in warm_cal:
                    empty = pad_graph(Graph(
                        edge_index=np.zeros((2, 0), np.int32), num_nodes=1,
                        features=np.zeros((1, 1), np.float32)),
                        capacity=bucket)
                    warm_cal[(name, tier)] = calibrate_tier(
                        e.params, e.cfg, torch.zeros(
                            (bucket, e.cfg.in_feats), device=dev),
                        build_operands(empty, e.cfg, device=dev))
                quant = warm_cal[(name, tier)]
            plan(e.params, x, ops, quant, node_mask=mask)
        if (self.sc.delta_pad_rows > 0 and e.cfg.kind in ("gcn", "gat")
                and ("delta", full, fields) not in warmed):
            warmed.add(("delta", full, fields))
            kt, ke = self._delta_pads(full)
            zeros = np.zeros((ke,), np.int32)
            rows, row0 = ((full, 0) if self.mesh is None
                          else (bucket, self._row0(bucket)))
            self._delta_patcher(
                GranniteOperands(**{f: torch.zeros((rows, full), device=dev)
                                    for f in fields}),
                self._delta_spec(full, fields, zeros, zeros,
                                 zeros.astype(np.float32), zeros[:kt],
                                 np.zeros((full,), np.float32)), row0=row0)

    def _delta_pads(self, cap: int) -> Tuple[int, int]:
        """(touched, flip) pad widths of the delta patcher at one capacity:
        the delta-vs-rebuild threshold in shape form."""
        kt = min(self.sc.delta_pad_rows, cap)
        return kt, 2 * kt

    def _warm_delta(self, e: _ModelEntry, bucket: int,
                    single: GranniteOperands, warmed: set) -> None:
        """Warm the delta patcher for one (bucket, model) on a placeholder
        spec of the padded widths: the operand patch per fieldset, and the
        int8 row re-quantization when a QuantGr GCN tier keeps a derived
        int8 Â to patch."""
        if (self.sc.delta_pad_rows <= 0 or not self.sc.use_cacheg
                or e.cfg.kind not in ("gcn", "gat")):
            return
        fields = OPERAND_FIELDS[e.cfg.kind]
        kt, ke = self._delta_pads(bucket)
        zeros = np.zeros((ke,), np.int32)
        if ("delta", bucket, fields) not in warmed:
            warmed.add(("delta", bucket, fields))
            self._delta_patcher(single, self._delta_spec(
                bucket, fields, zeros, zeros, zeros.astype(np.float32),
                zeros[:kt], np.zeros((bucket,), np.float32)))
        if (any(self._needs_tier_ops(e, tn) for tn in e.tiers)
                and ("delta_tier", bucket) not in warmed):
            warmed.add(("delta_tier", bucket))
            self._delta_patcher.patch_tier(
                self._agg_quantizer(single.norm_adj), single.norm_adj,
                torch.zeros((min(2 * self.sc.delta_pad_rows, bucket),),
                            dtype=torch.int32, device=self.device))

    def assert_warm(self) -> None:
        """The zero-recompile contract: no plan saw a new signature since
        warmup."""
        if self._warm_blobs is None:
            raise AssertionError("call warmup() first")
        if self.compiled_blobs != self._warm_blobs:
            raise AssertionError(
                f"recompile after warmup: {self.compiled_blobs} traces vs "
                f"{self._warm_blobs} at warmup")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- calibration
    def calibrate(self, model: str, g: Graph, *,
                  force: bool = False) -> Dict[str, float]:
        """Per-(model, tier) QuantGr calibration and quality audit.

        One fp32 forward over `g` records each QuantGr tier's static scales
        (`core.models.calibrate_tier`), once per (model, tier): calling
        again with another graph changes nothing unless `force=True`.
        Every non-fp32 tier gets its `accuracy_delta_vs_fp32` measured
        against the fp32 tier on the held-out part of `g`, in percentage
        points. Adds no plan signature: `assert_warm()` still holds.
        """
        return self._calibrate(model, self.sc.ladder.pad(g), force=force)

    def _calibrate(self, model: str, pg: PaddedGraph, *,
                   force: bool = False) -> Dict[str, float]:
        e = self.models[model]
        x = torch.from_numpy(pg.features).to(self.device)
        ops = base = None
        # alias tiers (equal Techniques) share one calibration and audit
        done_cal: Dict[Techniques, Dict] = {}
        done_delta: Dict[Techniques, float] = {}
        for tier, t in e.tiers.items():
            if tier == "fp32" or (not force and tier in e.accuracy_delta
                                  and (not t.quantgr
                                       or tier in e.calibrations)):
                continue
            if t in done_delta:
                if t.quantgr:
                    e.calibrations[tier] = done_cal[t]
                e.accuracy_delta[tier] = done_delta[t]
                continue
            if ops is None:
                ops = build_operands(pg, e.cfg, device=self.device)
                base = forward_grannite(e.params, e.cfg, x, ops,
                                        e.tiers["fp32"]).cpu()
            if t.quantgr:
                if force or tier not in e.calibrations:
                    e.calibrations[tier] = calibrate_tier(e.params, e.cfg,
                                                          x, ops)
                done_cal[t] = e.calibrations[tier]
            out = forward_grannite(e.params, e.cfg, x, ops, t,
                                   quant=e.calibrations.get(tier)).cpu()
            done_delta[t] = _delta_points(base, out, pg)
            e.accuracy_delta[tier] = done_delta[t]
        return dict(e.accuracy_delta)

    # ------------------------------------------------------------------ intake
    def _resolve_tier(self, model: str, tier: Optional[str]) -> str:
        """Requested tier -> served tier: the model default when
        unspecified, and fp32 (counted in `tier_fallbacks`, never an error)
        for a QuantGr tier not yet calibrated."""
        e = self.models[model]
        tier = tier if tier is not None else e.default_tier
        if tier not in e.tiers:
            raise KeyError(f"model {model!r} has no tier {tier!r} "
                           f"(registered: {sorted(e.tiers)})")
        if e.tiers[tier].quantgr and tier not in e.calibrations:
            self._count("tier_fallbacks")
            return "fp32"
        return tier

    def _tier_for_tolerance(self, model: str, tolerance: float,
                            bucket: int) -> str:
        """Tolerance tier router (§14): the cheapest servable tier whose
        measured accuracy delta fits the request's tolerance (points
        against fp32). Candidates are fp32 (delta 0) and every tier with
        a measured delta within the tolerance that is servable now (a
        QuantGr tier only once calibrated, so the router never picks a
        tier `_resolve_tier` would send to fp32). Cost is the bank at this
        bucket: a tier's least measured latency over its keys when it has
        samples, else its least seed; an unpredictable tier ranks last,
        and fp32 leads the list, so a tie serves the exact path."""
        e = self.models[model]
        cands = ["fp32"]
        for tn in e.tiers:
            if tn == "fp32":
                continue
            delta = e.accuracy_delta.get(tn)
            if delta is None or abs(delta) > tolerance:
                continue
            if e.tiers[tn].quantgr and tn not in e.calibrations:
                continue
            cands.append(tn)

        def cost(tn: str) -> float:
            # measured latencies outrank seeds within a tier: once any of
            # the tier's keys has samples, a sibling key's optimistic seed
            # cannot hide a measured slowdown
            m_best, s_best = None, None
            for key in self.bank.keys():
                if key[0] != model or key[1] != bucket or key[2] != tn:
                    continue
                m = self.bank.measured(key)
                if m is not None:
                    m_best = m if m_best is None else min(m_best, m)
                else:
                    p = self.bank.predict(key)
                    if p is not None:
                        s_best = p if s_best is None else min(s_best, p)
            if m_best is not None:
                return m_best
            return s_best if s_best is not None else float("inf")

        with self._lock:
            costs_ = {tn: cost(tn) for tn in cands}
        return min(cands, key=lambda tn: (costs_[tn], cands.index(tn)))

    def _route_tier(self, model: str, tier: Optional[str],
                    tolerance: Optional[float], bucket: int) -> str:
        """Requested (tier, tolerance) -> served tier (§14). An explicit
        tier resolves as `_resolve_tier` does, and neither the tolerance
        nor the governor overrides it. A tolerance without a tier runs the
        tolerance router. Neither: the governor, when there is one, may
        step the model default down; its pick still goes through
        `_resolve_tier`, so an uncalibrated target serves fp32, counted."""
        if tier is None and tolerance is not None:
            tier = self._tier_for_tolerance(model, tolerance, bucket)
        elif tier is None and self.governor is not None:
            e = self.models[model]
            with self._lock:
                tier = self.governor.tier_override(e.default_tier,
                                                   list(e.tiers))
        return self._resolve_tier(model, tier)

    @staticmethod
    def _needs_tier_ops(e: _ModelEntry, tier: str) -> bool:
        """GCN QuantGr tiers read a per-graph derived operand (the int8 Â);
        every other tier passes None, consistently per plan."""
        return e.cfg.kind == "gcn" and e.tiers[tier].quantgr

    def _resolve_fusion(self, model: str, fusion: Optional[str]) -> str:
        fusion = (fusion if fusion is not None
                  else self.models[model].default_fusion)
        if fusion not in FUSION_MODES:
            raise ValueError(f"unknown fusion mode {fusion!r}; "
                             f"pick from {FUSION_MODES}")
        return fusion

    @staticmethod
    def _grasp_capable(e: _ModelEntry) -> bool:
        """Whether this model can ever dispatch the GraSp backend: a
        non-"dense" mode and a kind whose aggregation has a block-sparse
        form (GCN)."""
        return e.agg_backend != "dense" and e.cfg.kind == "gcn"

    def _measured_agg_pair(self, model: str, capacity: int
                           ) -> Tuple[Optional[float], Optional[float]]:
        """Least measured batch latency per aggregation backend at (model,
        bucket), from the latency bank (§14): the measured input of
        `select_agg_backend`. None on a side until that backend has
        served a batch here, which leaves the model to decide."""
        with self._lock:
            best = self.bank.measured_pair(
                match=lambda k: k[0] == model and k[1] == capacity,
                backend_of=lambda k: k[3])
        return best.get("dense"), best.get("grasp")

    def _backend_from_stats(self, e: _ModelEntry, capacity: int,
                            stats: Dict) -> str:
        """The density/cost rule (DESIGN.md §10) for one graph at one
        bucket, with the bank's measured pair (§14), which outranks the
        modelled costs where both backends have served here. A pure
        decision: fallbacks are counted per request where it is used."""
        mode = "grasp" if e.agg_backend == "grasp" else "auto"
        choice, _, _ = select_agg_backend(
            capacity, e.cfg.hidden, nnz_blocks=stats["nnz_blocks"],
            max_row_nnz=stats["max_row_nnz"], mode=mode,
            measured=self._measured_agg_pair(e.name, capacity))
        return choice

    def _count_forced_fallback(self, e: _ModelEntry, backend: str) -> None:
        """One request of a forced-grasp model resolved dense (its
        structure exceeds the bucket budget): count it, per request."""
        if e.agg_backend == "grasp" and backend == "dense":
            self._count("backend_fallbacks")

    def _derive_grasp(self, e: _ModelEntry, capacity: int,
                      norm_adj: torch.Tensor
                      ) -> Tuple[str, Optional[BlockSparse]]:
        """Counts-first device-side derivation for an attached graph: the
        block counts (one read of rb int32 from the card) feed the rule,
        and only a graph routed grasp pays the block gather."""
        ct = self._block_compactor.counts(norm_adj).cpu().numpy()
        stats = {"nnz_blocks": int(ct.sum()),
                 "max_row_nnz": int(ct.max()) if ct.size else 0}
        backend = self._backend_from_stats(e, capacity, stats)
        bsp = None
        if backend == "grasp":
            bsp, _ = self._block_compactor(norm_adj,
                                           max_nnz=grasp_max_nnz(capacity))
        return backend, bsp

    def _resolve_and_build(self, model: str, tier: str, pg: PaddedGraph,
                           keys: Optional[np.ndarray] = None
                           ) -> Tuple[str, GranniteOperands]:
        """One-shot intake: resolve the request's aggregation backend and
        build its device operands. QuantGr tiers resolve dense without a
        scan. On the CacheG path an undirected graph decides from the
        block counts of its MATERIALIZED Â on the device (no host O(cap²)
        scan, and eligibility is judged on the matrix the gather reads).
        Otherwise the rule reads the host `block_stats` of Â, whose bitmap
        the host structure build then reuses."""
        e = self.models[model]
        if not self._grasp_capable(e) or e.tiers[tier].quantgr:
            return "dense", self._device_operands(model, pg, keys=keys)
        if self.sc.use_cacheg and is_symmetric(pg, keys):
            ops = self._device_operands(model, pg, symmetric=True, keys=keys)
            backend, bsp = self._derive_grasp(e, pg.capacity, ops.norm_adj)
            self._count_forced_fallback(e, backend)
            if backend == "grasp":
                ops = dataclasses.replace(ops, block_sparse=bsp)
            return backend, ops
        stats = block_stats(pg.norm_adj)
        backend = self._backend_from_stats(e, pg.capacity, stats)
        self._count_forced_fallback(e, backend)
        return backend, self._device_operands(
            model, pg, backend=backend, grasp_bitmap=stats["bitmap"],
            symmetric=False if self.sc.use_cacheg else None)

    def _host_operands(self, model: str, pg: PaddedGraph, *,
                       backend: str = "dense",
                       grasp_bitmap: Optional[np.ndarray] = None,
                       symmetric: Optional[bool] = None,
                       keys: Optional[np.ndarray] = None) -> HostOperands:
        """HOST stage of one graph's operands (`prepare_host_operands`):
        the CacheG compact form, or the eager dense build uploaded to the
        device for `use_cacheg=False` and for directed GCN/GAT graphs
        (counted in `cacheg_fallbacks`). The bytes that cross the link
        count in `operand_bytes_h2d`: the compact form's, or the eager
        fields the kind reads plus a grasp request's host-built block
        structure (`to_block_sparse`, reusing the rule's bitmap, padded to
        the bucket budget). `keys`, the graph's `adjacency_keys`, let the
        compact path read its edge list instead of the (cap, cap) matrix."""
        ho = prepare_host_operands(
            pg, self.models[model].cfg, use_cacheg=self.sc.use_cacheg,
            grasp_max_nnz=(grasp_max_nnz(pg.capacity) if backend == "grasp"
                           else None),
            grasp_bitmap=grasp_bitmap, symmetric=symmetric, keys=keys,
            device=self.device)
        with self._lock:
            self.metrics["operand_bytes_h2d"] += ho.nbytes
            if ho.fallback:
                self.metrics["cacheg_fallbacks"] += 1
        return ho

    def _device_operands(self, model: str, pg: PaddedGraph, **kw
                         ) -> GranniteOperands:
        """One graph's device operands: the host stage (`_host_operands`)
        then the device stage (`realize_operands`: the materializer for a
        compact form)."""
        return realize_operands(self._host_operands(model, pg, **kw),
                                self._materializer)

    def _prepare(self, model: str, pg: PaddedGraph, tier: str,
                 ops: Optional[GranniteOperands] = None, *,
                 backend: str = "dense",
                 tier_ops: Optional[TierOperands] = None,
                 fusion: Optional[str] = None,
                 submitted_s: Optional[float] = None,
                 keys: Optional[np.ndarray] = None,
                 deadline_ms: Optional[float] = None,
                 tolerance: Optional[float] = None,
                 uid: Optional[int] = None) -> GNNRequest:
        """Host-stage tail shared by every intake path, for a resolved
        `tier`: resolve the fusion mode; when the caller passes no
        operands, resolve the aggregation backend and build them (from
        the graph's `keys` where given; and a QuantGr tier's int8 Â,
        uncached); upload the features; assign the uid; hand the request
        over to the dispatch stream. A caller that passes operands passes
        the `backend` they were derived for. `submitted_s` lets the
        scheduler date the request at intake, and `deadline_ms` counts
        from that instant, so queue wait spends it; on a mesh the
        scheduler binds `uid` there too. Returns the request without
        queueing it."""
        now = self.clock.now()
        submitted_s = submitted_s if submitted_s is not None else now
        fusion = self._resolve_fusion(model, fusion)
        if ops is None:
            backend, ops = self._resolve_and_build(model, tier, pg, keys)
        if tier_ops is None and self._needs_tier_ops(self.models[model], tier):
            # one-shot request: derive without caching (nothing to key on)
            tier_ops = self._agg_quantizer(ops.norm_adj)
        x = self._upload_features(pg)
        uid = self._stamp(submitted_s, uid)
        deadline_s = (submitted_s + deadline_ms * 1e-3
                      if deadline_ms is not None else None)
        return self._hand_over(GNNRequest(
            uid=uid, model=model, pg=pg, ops=ops, bucket=pg.capacity,
            submitted_s=submitted_s, tier=tier, backend=backend,
            fusion=fusion, tier_ops=tier_ops, x=x, deadline_s=deadline_s,
            tolerance=tolerance))

    def _keys_for(self, edge_index: np.ndarray, pg: PaddedGraph
                  ) -> Optional[np.ndarray]:
        """The graph's `adjacency_keys` at its bucket, which the CacheG
        host stage checks and packs in O(E); None for the eager path,
        which reads the dense matrices anyway."""
        if not self.sc.use_cacheg:
            return None
        return adjacency_keys(edge_index, pg.capacity)

    def _push(self, req: GNNRequest) -> int:
        self.queue.append(req)
        return req.uid

    def prepare_submit(self, g: Graph, *, model: str,
                       tier: Optional[str] = None,
                       fusion: Optional[str] = None,
                       submitted_s: Optional[float] = None,
                       deadline_ms: Optional[float] = None,
                       tolerance: Optional[float] = None,
                       uid: Optional[int] = None) -> GNNRequest:
        """HOST stage of a one-shot request: NodePad padding, the tier
        (router-aware, §14), operand build and upload (CacheG: packed from
        the edge list) and the feature upload. Callable from any
        scheduler worker thread."""
        pg = self.sc.ladder.pad(g)
        return self._prepare(
            model, pg, self._route_tier(model, tier, tolerance, pg.capacity),
            fusion=fusion, submitted_s=submitted_s,
            keys=self._keys_for(g.edge_index, pg), deadline_ms=deadline_ms,
            tolerance=tolerance, uid=uid)

    def submit(self, g: Graph, *, model: str, tier: Optional[str] = None,
               fusion: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               tolerance: Optional[float] = None) -> int:
        """One-shot inference request over a static graph. `deadline_ms`
        (from now) and `tolerance` (most accuracy points the tier router
        may trade) opt the request into the §14 SLO machinery. On a mesh
        only the lead serves it (the others take its uid)."""
        if not self._lead:
            # the lead alone serves it; its uid keeps the ranks' equal
            return self._take_uid()
        return self._push(self.prepare_submit(g, model=model, tier=tier,
                                              fusion=fusion,
                                              deadline_ms=deadline_ms,
                                              tolerance=tolerance))

    def attach(self, g: Graph, *, model: str, calibrate: bool = True) -> int:
        """Register a graph for repeated queries; returns its graph_id.
        Operands are built on the first `query()` and kept on the device
        until `update()` changes the structure, `detach()` releases them or
        the budget evicts them. The first attach to a model with
        uncalibrated non-fp32 tiers also calibrates them on this graph
        (`calibrate=False` defers to an explicit `calibrate()`).

        A graph above the top bucket auto-shards (§12) when `shard_counts`
        is configured: `partition_for_ladder` picks the smallest configured
        shard count whose balanced per-shard load fits a bucket, and every
        query over this graph_id runs the sharded plan. Without
        `shard_counts` such a graph raises.

        With `device_cache_budget_bytes` set, attach() is the admission
        gate (§13): a graph whose projected primary operand entry (the
        slice tuple for a sharded graph) can NEVER fit the budget raises
        `CacheAdmissionError`; under `admission="reject"` one that would
        overflow the CURRENT residency raises too, while
        `admission="evict"` admits it and lets insert-time eviction make
        room on first query. On a mesh every rank calls attach() and the
        lead's decision, on its own residency, holds for all of them."""
        if model not in self.models:
            raise KeyError(f"unknown model {model!r}")
        part = None
        try:
            pg = self.sc.ladder.pad(g)
        except ValueError:
            if not self.sc.shard_counts:
                raise
            part = self._partition(g)
            pg = pad_graph(g, capacity=part.full_rows)
        if self.sc.device_cache_budget_bytes is not None:
            projected = self._projected_primary_bytes(model, pg, part)
            with self._lock:
                reject = (not self._cache.fits(projected)
                          or (self.sc.admission == "reject"
                              and self._cache.would_overflow(projected)))
            if self.mesh is not None:
                # the lead's residency decides for every rank: the ranks
                # hold different bytes (the lead alone holds unsharded
                # graphs), and a rank that refused alone would number the
                # next graph apart from the others
                group, dev = self._caller_comm()
                reject = bool(self._broadcast(torch.tensor(
                    [int(reject)], dtype=torch.int64, device=dev),
                    group).item())
            if reject:
                with self._lock:
                    self.metrics["cache_admission_rejects"] += 1
                raise CacheAdmissionError(
                    f"graph with projected primary operand entry of "
                    f"{projected} bytes cannot be admitted under "
                    f"device_cache_budget_bytes="
                    f"{self.sc.device_cache_budget_bytes} "
                    f"(policy {self.sc.admission!r}, "
                    f"{self._cache.resident_bytes} resident)")
        if calibrate:
            self._calibrate(model, pg)      # no-op once (model, tier) is done
        keys = self._keys_for(g.edge_index, pg)
        with self._lock:
            gid = self._gid
            self._gid += 1
            self.graphs[gid] = (model, pg)
            self._graph_keys[gid] = keys
            self._graph_version[gid] = 0
            if part is not None:
                self._sharded[gid] = (part, g)
        return gid

    def _partition(self, g: Graph) -> GraphShards:
        """The configured N-way partition of a graph above the top bucket
        (`partition_for_ladder`; raises when no shard count fits), checked
        equal on every rank of a mesh."""
        part = partition_for_ladder(g.edge_index, g.num_nodes,
                                    self.sc.ladder, self.sc.shard_counts,
                                    method=self.sc.partition_method)
        self._agree_partition(part)
        return part

    def _projected_primary_bytes(self, model: str, pg: PaddedGraph,
                                 part: Optional[GraphShards] = None) -> int:
        """Projected device cost of the PRIMARY entry this graph pins on
        first query (the slice tuple of a sharded graph) — what attach()
        admission sizes against. Derived forms rank below the primary in
        eviction order and are not counted."""
        cfg = self.models[model].cfg
        nf = len(OPERAND_FIELDS[cfg.kind])
        if part is not None:
            # a rank of a mesh holds one row block
            return estimate_shard_entry_bytes(
                part.shards if self.mesh is None else 1, part.shard_cap,
                part.full_rows, nf, cfg.in_feats)
        return estimate_dense_entry_bytes(nf, pg.capacity)

    @staticmethod
    def _shard_entry_nbytes(slices: Tuple[ShardSlice, ...]) -> int:
        """Device bytes of a sharded slice-tuple entry in the reference's
        layout (an absent field counted as its (1, 1) placeholder)."""
        return sum(tree_nbytes((s.x, s.node_mask)) + operand_nbytes(s.ops)
                   for s in slices)

    def detach(self, graph_id: int) -> None:
        """Release an attached graph, its device operands and any spilled
        form. Lifecycle removal is not an eviction: no eviction or spill
        counter moves."""
        with self._lock:
            key = (graph_id, self._graph_version.pop(graph_id, -1))
            self._cache.invalidate(key)
            self._sharded.pop(graph_id, None)
            self.graphs.pop(graph_id, None)
            self._graph_keys.pop(graph_id, None)

    def update(self, graph_id: int, edge_index: np.ndarray, num_nodes: int,
               features: np.ndarray) -> bool:
        """GrAd update of an attached graph, rebuilt in full; True if it
        climbed the ladder (`BucketLadder.grow`, counted in
        `rebucket_events`). Bumps the structure version and invalidates
        the old version's entries, so the next `query()` builds exactly
        once. A request prepared before it keeps the snapshot it read.

        Sharded graphs (§12) re-partition on every update (the edge cut
        depends on the edges): an unchanged (shard count, shard bucket)
        pair is a value update as in the unsharded case, a changed one
        counts as a rebucket. A graph that shrinks back into the ladder
        leaves the sharded path; an unsharded graph that grows past the
        top bucket enters it (a rebucket either way); without
        `shard_counts` it raises."""
        with self._lock:
            model, pg = self.graphs[graph_id]
            sharded = self._sharded.get(graph_id)
        new_sharded = None
        if sharded is not None:
            part, g_old = sharded

            # carry supervision across the size change, as
            # BucketLadder.grow does: new nodes are unlabeled, a shrink
            # truncates
            def resized(arr, fill, dtype):
                if arr is None:
                    return None
                out = np.full((num_nodes,), fill, dtype=dtype)
                m = min(num_nodes, len(arr))
                out[:m] = arr[:m]
                return out

            g2 = Graph(edge_index=edge_index, num_nodes=num_nodes,
                       features=features,
                       labels=resized(g_old.labels, -1, np.int32),
                       train_mask=resized(g_old.train_mask, False, bool),
                       test_mask=resized(g_old.test_mask, False, bool))
            try:
                pg = self.sc.ladder.pad(g2)
                rebucketed = True           # shrank back into the ladder
            except ValueError:
                part2 = self._partition(g2)
                pg = pad_graph(g2, capacity=part2.full_rows)
                new_sharded = (part2, g2)
                rebucketed = ((part2.shards, part2.shard_cap)
                              != (part.shards, part.shard_cap))
        else:
            try:
                pg, rebucketed = self.sc.ladder.grow(pg, edge_index,
                                                     num_nodes, features)
            except ValueError:
                if not self.sc.shard_counts:
                    raise
                # grew off the top of the ladder: enter the sharded path
                g2 = Graph(edge_index=edge_index, num_nodes=num_nodes,
                           features=features)
                part2 = self._partition(g2)
                pg = pad_graph(g2, capacity=part2.full_rows)
                new_sharded = (part2, g2)
                rebucketed = True
        keys = self._keys_for(edge_index, pg)
        with self._lock:
            self.graphs[graph_id] = (model, pg)
            self._graph_keys[graph_id] = keys
            ver = self._graph_version[graph_id]
            # lifecycle invalidation, not eviction: no eviction counter
            self._cache.invalidate((graph_id, ver))
            if new_sharded is not None:
                self._sharded[graph_id] = new_sharded
            else:
                self._sharded.pop(graph_id, None)
            self._graph_version[graph_id] = ver + 1
            if rebucketed:
                self.metrics["rebucket_events"] += 1
        return rebucketed

    # ------------------------------------------------------ GrAd delta updates
    def _delta_spec(self, cap: int, fields: Tuple[str, ...], flip_i, flip_j,
                    flip_v, touched, degree) -> DeltaSpec:
        """One host-side edge delta padded to the patcher's static widths
        (flips to K_e, touched rows to K_t, by repeating the first entry,
        which changes nothing) and uploaded to the engine's device."""
        kt, ke = self._delta_pads(cap)

        def up(a, k=None, dtype=np.int32):
            a = np.asarray(a, dtype)
            if k is not None:
                a = np.concatenate([a, np.full((k - len(a),), a[0], dtype)])
            return torch.from_numpy(a).to(self.device)

        return DeltaSpec(flip_i=up(flip_i, ke), flip_j=up(flip_j, ke),
                         flip_v=up(flip_v, ke, np.float32),
                         touched=up(touched, kt),
                         degree=up(degree, dtype=np.float32), fields=fields)

    def _requant_rows(self, touched: np.ndarray, keys: np.ndarray,
                      cap: int) -> Optional[torch.Tensor]:
        """Rows of the int8 Â a delta re-quantizes: the touched rows and
        every row adjacent (patched structure) to a touched node, whose
        entries rescale with the touched D^-1/2. Padded to K_r by
        repeating the first; None when the set exceeds K_r (the caller
        then re-quantizes the whole matrix with `_agg_quantizer`)."""
        kr = min(2 * self.sc.delta_pad_rows, cap)
        rows = np.union1d(touched, keys_neighbours(keys, cap, touched))
        if len(rows) > kr:
            return None
        out = np.full((kr,), rows[0], np.int32)
        out[:len(rows)] = rows
        return torch.from_numpy(out).to(self.device)

    def _spill_producer(self, graph_id: int, ver: int, model: str):
        """Eviction-time producer of an operand entry's spilled form: the
        compact form packed from the graph's current edge keys (pinned on
        a CUDA engine), which also serves an entry a delta patched and no
        `HostOperands` built. Declines (the entry is dropped) when the
        graph moved past `ver` or was detached. The cache manager calls it
        under the engine lock, as the reference's does."""
        def spill():
            if (self._graph_version.get(graph_id) != ver
                    or graph_id in self._sharded):
                return None
            pg = self.graphs[graph_id][1]
            co = compact_operands(pg, self.models[model].cfg,
                                  check_symmetry=False,
                                  keys=self._graph_keys[graph_id])
            if self.device.type == "cuda":
                co = co.pin()
            return HostOperands(compact=co, nbytes=co.nbytes)
        return spill

    def update_delta(self, graph_id: int, add_edges=None,
                     remove_edges=None) -> bool:
        """GrAd incremental structure update of an attached graph: patch,
        don't rebuild.

        `add_edges` / `remove_edges` are (k, 2) arrays of UNDIRECTED node
        pairs (a directed graph raises: it takes `update()`). The host
        patches the dense Â and adjacency (`apply_edge_delta`) and the
        edge keys; each resident cached form is then patched on the device
        through the warm `DeltaPatcher` — Â's touched rows and columns
        renormalized, the GAT masks rescattered, the int8 Â rows whose
        fp32 values changed re-quantized (the whole matrix through
        `_agg_quantizer` past K_r rows), the GraSp decision and structure
        re-derived from the patched Â — and put under the NEW (graph_id,
        version + 1) key. Cached tensors are never written, so a request
        prepared before the delta answers with the old structure. A graph
        with no resident entry only moves to the new version.

        Falls back to `update()`, counted in `delta_fallbacks`, past the
        warmed widths (more than `delta_pad_rows` touched nodes or twice
        that many flips), for SAGE (its sampled mask cannot be patched)
        or with `delta_pad_rows=0`. An ineffective delta (every edge
        already present or absent) returns True and moves no version.

        Returns True when the structure was patched (or nothing changed),
        False when it fell back to `update()`.
        """
        with self._lock:
            model, pg = self.graphs[graph_id]
            ver = self._graph_version[graph_id]
            keys = self._graph_keys[graph_id]
            sharded = self._sharded.get(graph_id)
        e = self.models[model]
        if not is_symmetric(pg, keys):
            raise ValueError(
                "update_delta edits undirected edge pairs; directed "
                "graphs must take the full update() path")
        delta = apply_edge_delta(pg.adj, pg.norm_adj, pg.num_nodes,
                                 add_edges, remove_edges)
        if delta is None:
            return True          # nothing effective changed: caches stand
        kt, ke = self._delta_pads(pg.capacity)
        if not (self.sc.delta_pad_rows > 0 and e.cfg.kind in ("gcn", "gat")
                and len(delta.touched) <= kt and len(delta.flip_i) <= ke):
            self._count("delta_fallbacks")
            self.update(graph_id,
                        edge_index_from_adjacency(delta.adj, pg.num_nodes),
                        pg.num_nodes,
                        (sharded[1].features if sharded is not None
                         else pg.features[:pg.num_nodes]))
            return False
        pg2 = dataclasses.replace(pg, adj=delta.adj, norm_adj=delta.norm_adj)
        keys2 = (None if keys is None
                 else patch_adjacency_keys(keys, pg.capacity, delta))
        if sharded is not None:
            return self._update_delta_sharded(graph_id, ver, model, pg2,
                                              keys2, sharded, delta)
        old_key, new_key = (graph_id, ver), (graph_id, ver + 1)
        with self._lock:
            ops_old = self._cache.get("operand", old_key)
            tops_old = self._cache.get("tier", old_key)
            had_grasp = self._cache.get("grasp", old_key) is not None
        new_ops = new_tops = new_grasp = None
        delta_bytes = 0
        if self.sc.use_cacheg and ops_old is not None:
            spec = self._delta_spec(
                pg.capacity, OPERAND_FIELDS[e.cfg.kind], delta.flip_i,
                delta.flip_j, delta.flip_v, delta.touched,
                gcn_degree(pg2.adj, pg.num_nodes, keys2))
            delta_bytes += spec.nbytes
            new_ops = self._delta_patcher(ops_old, spec)
            if tops_old is not None:
                rows = self._requant_rows(delta.touched, keys2, pg.capacity)
                if rows is None:
                    new_tops = self._agg_quantizer(new_ops.norm_adj)
                else:
                    delta_bytes += rows.numel() * rows.element_size()
                    new_tops = self._delta_patcher.patch_tier(
                        tops_old, new_ops.norm_adj, rows)
            if had_grasp and self._grasp_capable(e):
                # a flip moves blocks in and out of the lists, so the
                # structure is derived again, from the patched Â on the
                # device: no host bytes, and warm
                new_grasp = self._derive_grasp(e, pg.capacity,
                                               new_ops.norm_adj)
            self._sync()        # the patched forms are complete when cached
        with self._lock:
            if self._graph_version.get(graph_id) != ver:
                return False              # a racing update or detach won
            self.graphs[graph_id] = (model, pg2)
            self._graph_keys[graph_id] = keys2
            self._cache.invalidate(old_key)
            self._graph_version[graph_id] = ver + 1
            if new_ops is not None:
                nb = operand_nbytes(new_ops)
                self._cache.put("operand", new_key, new_ops, nbytes=nb,
                                remat_s=transfer_cost(nb),
                                spill_fn=self._spill_producer(
                                    graph_id, ver + 1, model))
            if new_tops is not None:
                self._cache.put("tier", new_key, new_tops,
                                nbytes=tree_nbytes(new_tops))
            if new_grasp is not None:
                self._cache.put("grasp", new_key, new_grasp,
                                nbytes=tree_nbytes(new_grasp))
            self.metrics["delta_bytes_h2d"] += delta_bytes
            self.metrics["delta_updates"] += 1
        return True

    def _patch_shard_slices(self, e: _ModelEntry, part: GraphShards,
                            slices: Tuple[ShardSlice, ...], delta,
                            degree: np.ndarray
                            ) -> Tuple[Tuple[ShardSlice, ...], int]:
        """A sharded slice tuple patched on the device (§13): the row
        blocks viewed as the (full, full) permuted operand matrices, the
        warm patch run in SLOT coordinates (flip and touched indices
        through the inverse permutation, the patched degree vector
        permuted), and cut into row blocks again. Features and node masks
        are untouched: an edge delta moves no node, and the partition is
        deliberately KEPT (a fresh partition would reshuffle the slots and
        owe a full rebuild). On a mesh the rank patches its own row block
        alone (`patch_operands(row0=)`), equal to those rows of the whole
        patch. Returns the tuple and the spec's bytes."""
        full, c = part.full_rows, part.shard_cap
        invperm = np.empty((full,), np.int64)
        invperm[part.perm] = np.arange(full)
        fields = OPERAND_FIELDS[e.cfg.kind]
        spec = self._delta_spec(full, fields, invperm[delta.flip_i],
                                invperm[delta.flip_j], delta.flip_v,
                                np.sort(invperm[delta.touched]),
                                degree[part.perm])
        if self.mesh is not None:
            sl = slices[0]
            return (dataclasses.replace(sl, ops=self._delta_patcher(
                sl.ops, spec, row0=self._row0(c))),), spec.nbytes
        _, stacked, _ = stack_shard_slices(slices)
        patched = self._delta_patcher(
            GranniteOperands(**{f: getattr(stacked, f).reshape(full, full)
                                for f in fields}), spec)
        return tuple(
            dataclasses.replace(sl, ops=GranniteOperands(**{
                f: getattr(patched, f)[i * c:(i + 1) * c] for f in fields}))
            for i, sl in enumerate(slices)), spec.nbytes

    def _update_delta_sharded(self, graph_id: int, ver: int, model: str,
                              pg2: PaddedGraph, keys2: Optional[np.ndarray],
                              sharded: Tuple[GraphShards, Graph],
                              delta) -> bool:
        """`update_delta`'s sharded branch (§13, §15): the cached slice
        tuple patched under the KEPT partition (`_patch_shard_slices`), the
        halo sets and cut recomputed for the new edges (`patch_halo`), and
        the wire the exchange of the boundary-dirty rows would move
        (`EdgeDelta.boundary_rows`: touched rows with a neighbour on
        another shard) counted against a full halo re-exchange, both at
        the exact fp32 rate the bit-exact patch needs: each dirty row
        ships its operand rows and its D^-1/2 entry. A delta inside one
        shard moves nothing."""
        part, g = sharded
        e = self.models[model]
        n = pg2.num_nodes
        edge_index = edge_index_from_adjacency(delta.adj, n)
        g2 = dataclasses.replace(g, edge_index=edge_index)
        part2 = patch_halo(part, edge_index)
        dirty = delta.boundary_rows(part.assignment, n)
        nf, full = len(OPERAND_FIELDS[e.cfg.kind]), part.full_rows
        delta_bytes = int(ring_psum_nbytes(
            part.shards, len(dirty) * (full * nf + 1), bytes_per_elt=4))
        full_bytes = int(ring_psum_nbytes(
            part.shards, nf * full * full + full, bytes_per_elt=4))
        old_key, new_key = (graph_id, ver), (graph_id, ver + 1)
        with self._lock:
            slices = self._cache.get("shard", old_key)
        new_slices, spec_bytes = None, 0
        if slices is not None:
            new_slices, spec_bytes = self._patch_shard_slices(
                e, part, slices, delta, gcn_degree(pg2.adj, n, keys2))
            self._sync()        # the patched blocks are complete when cached
        with self._lock:
            if self._graph_version.get(graph_id) != ver:
                return False              # a racing update or detach won
            self.graphs[graph_id] = (model, pg2)
            self._graph_keys[graph_id] = keys2
            self._sharded[graph_id] = (part2, g2)
            self._cache.invalidate(old_key)
            self._graph_version[graph_id] = ver + 1
            if new_slices is not None:
                nb = self._shard_entry_nbytes(new_slices)
                self._cache.put("shard", new_key, new_slices, nbytes=nb,
                                remat_s=transfer_cost(nb))
            self.metrics["delta_bytes_h2d"] += spec_bytes
            self.metrics["delta_updates"] += 1
            self.metrics["delta_halo_bytes_exchanged"] += delta_bytes
            self.metrics["delta_halo_bytes_full"] += full_bytes
            self.metrics["delta_dirty_rows"] += len(dirty)
        return True

    def _publish(self, kind: str, graph_id: int, ver: int, value, **kw
                 ) -> None:
        """Cache a device form built outside the lock under (graph_id,
        ver): once this thread's stream has finished it (no other thread
        may read it half written), and only if the version is still
        current, so a build that raced an update never pins memory under
        a dead key. Two workers that missed the same key may both build;
        the values are equal and the last insert wins."""
        self._settle()
        with self._lock:
            if self._graph_version.get(graph_id) == ver:
                self._cache.put(kind, (graph_id, ver), value, **kw)

    def _primary_operands(self, graph_id: int, ver: int, model: str,
                          pg: PaddedGraph, keys: Optional[np.ndarray]
                          ) -> GranniteOperands:
        """The attached graph's fp32 operands from the cache manager: a
        hit moves nothing; a spill fault re-uploads only the spilled
        compact form (from pinned memory on the card) and is not a miss;
        a miss runs the host and device stages and inserts the entry, with
        a spill producer when the form is compact (`_spill_producer`; a
        directed graph's eager entry is dropped on eviction)."""
        key = (graph_id, ver)
        with self._lock:
            ops = self._cache.get("operand", key)
            if ops is not None:
                self.metrics["operand_cache_hits"] += 1
            else:
                ho = self._cache.spill_get("operand", key)
                if ho is not None:
                    self.metrics["cache_spill_hits"] += 1
                    self.metrics["operand_bytes_h2d"] += ho.nbytes
                else:
                    self.metrics["operand_cache_misses"] += 1
        if ops is not None:
            return ops
        if ho is None:
            ho = self._host_operands(model, pg, keys=keys)
        ops = realize_operands(ho, self._materializer)
        nb = operand_nbytes(ops)
        self._publish("operand", graph_id, ver, ops, nbytes=nb,
                      remat_s=transfer_cost(nb),
                      spill_fn=(self._spill_producer(graph_id, ver, model)
                                if ho.compact is not None else None))
        return ops

    def _snapshot(self, graph_id: int):
        """An attached graph as a query reads it: (model, padded graph,
        version, keys, (partition, Graph) or None when unsharded)."""
        with self._lock:
            model, pg = self.graphs[graph_id]
            return (model, pg, self._graph_version[graph_id],
                    self._graph_keys[graph_id], self._sharded.get(graph_id))

    def prepare_query(self, graph_id: int, *, tier: Optional[str] = None,
                      fusion: Optional[str] = None,
                      submitted_s: Optional[float] = None,
                      deadline_ms: Optional[float] = None,
                      tolerance: Optional[float] = None,
                      uid: Optional[int] = None,
                      snapshot=None) -> GNNRequest:
        """HOST stage of a query over an attached graph: device operands,
        a QuantGr tier's int8 Â, and a grasp-capable model's backend
        decision and block structure (derived on the card from the cached
        Â, zero extra bytes) come from the cache manager after the first
        query. A derived insert never evicts the primary it hangs off
        (the manager protects the inserted key).

        Thread discipline (scheduler workers call this while `update()`
        may arrive from the caller): the (model, graph, version, keys)
        snapshot is taken under the engine lock, forms are built outside
        it, and a built form is cached only while its version is current
        (`_publish`). A request racing an update serves the snapshot it
        read; on a mesh the scheduler reads it at intake (`snapshot`), so
        every rank serves the version of the same call."""
        model, pg, ver, keys, sharded = (snapshot if snapshot is not None
                                         else self._snapshot(graph_id))
        if sharded is not None:
            if fusion not in (None, "none"):
                raise ValueError(
                    "sharded graphs serve fusion='none' only: the shard "
                    "axis takes the plan dimension fused layers batch over "
                    "(DESIGN.md §12)")
            return self._prepare_sharded(
                graph_id, ver, model, pg, keys, sharded, tier=tier,
                submitted_s=submitted_s, deadline_ms=deadline_ms,
                tolerance=tolerance, uid=uid)
        key = (graph_id, ver)
        ops = self._primary_operands(graph_id, ver, model, pg, keys)
        resolved = self._route_tier(model, tier, tolerance, pg.capacity)
        e = self.models[model]
        tops = None
        if self._needs_tier_ops(e, resolved):
            with self._lock:
                tops = self._cache.get("tier", key)
            if tops is None:
                tops = self._agg_quantizer(ops.norm_adj)
                self._publish("tier", graph_id, ver, tops,
                              nbytes=tree_nbytes(tops))
        backend = "dense"
        if self._grasp_capable(e) and not e.tiers[resolved].quantgr:
            with self._lock:
                cached = self._cache.get("grasp", key)
            if cached is None:
                cached = self._derive_grasp(e, pg.capacity, ops.norm_adj)
                self._publish("grasp", graph_id, ver, cached,
                              nbytes=tree_nbytes(cached))
            backend, bsp = cached
            self._count_forced_fallback(e, backend)   # per request
            if backend == "grasp":
                ops = dataclasses.replace(ops, block_sparse=bsp)
        return self._prepare(model, pg, resolved, ops, backend=backend,
                             tier_ops=tops, fusion=fusion,
                             submitted_s=submitted_s,
                             deadline_ms=deadline_ms, tolerance=tolerance,
                             uid=uid)

    def _prepare_sharded(self, graph_id: int, ver: int, model: str,
                         pg: PaddedGraph, keys: Optional[np.ndarray],
                         sharded: Tuple[GraphShards, Graph], *,
                         tier: Optional[str],
                         submitted_s: Optional[float],
                         deadline_ms: Optional[float] = None,
                         tolerance: Optional[float] = None,
                         uid: Optional[int] = None) -> GNNRequest:
        """HOST stage of a query over an auto-sharded graph (§12).

        The cached unit is the tuple of per-shard `ShardSlice`s, built
        once per (graph_id, version) by `build_sharded_operands` (the
        materialized full-capacity operands permuted into slot order on
        the device and cut into row blocks) and counted in the operand
        cache hits and misses like the unsharded entry; it has no spill
        form (it rebuilds from the engine's own registry), and its bytes
        are not counted in `operand_bytes_h2d`, as in the reference. The
        tier resolves as for any query, at the per-shard bucket; the
        sharded GCN int8 path derives the int8 Â from its complete row
        blocks in the forward, so no sharded tier operand is cached.
        Backend is always dense and fusion "none": the batch key's shard
        element keeps these dispatches apart from unsharded ones. On a
        mesh the cached tuple holds this rank's row block alone, and the
        tier resolved here is replaced by the lead's at dispatch."""
        part, g = sharded
        e = self.models[model]
        resolved = self._route_tier(model, tier, tolerance, part.shard_cap)
        with self._lock:
            slices = self._cache.get("shard", (graph_id, ver))
            self.metrics["operand_cache_hits" if slices is not None
                         else "operand_cache_misses"] += 1
        if slices is None:
            slices = build_sharded_operands(
                g, part, e.cfg, pg=pg, keys=keys, device=self.device,
                shard=None if self.mesh is None
                else self.mesh.coords["shard"])
            nb = self._shard_entry_nbytes(slices)
            self._publish("shard", graph_id, ver, slices, nbytes=nb,
                          remat_s=transfer_cost(nb))
        if self.mesh is None:
            x, ops, mask = stack_shard_slices(slices)
        else:
            x, ops, mask = slices[0].x, slices[0].ops, slices[0].node_mask
        now = self.clock.now()
        submitted_s = submitted_s if submitted_s is not None else now
        uid = self._stamp(submitted_s, uid)
        deadline_s = (submitted_s + deadline_ms * 1e-3
                      if deadline_ms is not None else None)
        return self._hand_over(GNNRequest(
            uid=uid, model=model, pg=pg, ops=ops, bucket=part.shard_cap,
            submitted_s=submitted_s, tier=resolved, backend="dense",
            fusion="none", shards=part.shards, part=part, shard_x=x,
            shard_mask=mask, deadline_s=deadline_s, tolerance=tolerance))

    def query(self, graph_id: int, *, tier: Optional[str] = None,
              fusion: Optional[str] = None,
              deadline_ms: Optional[float] = None,
              tolerance: Optional[float] = None) -> int:
        """Enqueue inference over an attached graph (see `prepare_query`).
        On a mesh every rank prepares a query over a sharded graph (its
        own row block) and only the lead one over an unsharded graph."""
        if not self._lead:
            with self._lock:
                sharded = graph_id in self._sharded
            if not sharded:
                return self._take_uid()
        return self._push(self.prepare_query(graph_id, tier=tier,
                                             fusion=fusion,
                                             deadline_ms=deadline_ms,
                                             tolerance=tolerance))

    # --------------------------------------------------------------- execution
    def run(self) -> List[GNNRequest]:
        """Serve the queue. On a mesh every rank calls it together: the
        lead runs the batches and tells the others each sharded batch it
        picked (`_tell`), which they follow (`_follow`). Not on a mesh
        while a scheduler is open: its dispatcher holds the mesh's
        groups."""
        if self.mesh is not None and self._open_scheduler is not None:
            raise RuntimeError("run() on a mesh while a scheduler is open: "
                               "serve through the scheduler, or close it")
        if not self._lead:
            self._follow()
            return self.finished
        while self.queue:
            self._run_batch()
        if self.mesh is not None:
            self._tell(_DONE)
        return self.finished

    def _tell(self, op: int, batch: Sequence[GNNRequest] = ()) -> None:
        """The lead's message to the mesh: `op`, a sharded batch's uids
        and the tier it serves at, and the sharded requests expired since
        the last message. A header of 4 int64 then the uids, broadcast
        before the batch's first collective, from the thread that runs
        the batches (`run()`, or a scheduler's dispatcher)."""
        with self._lock:
            expired, self._expired_out = self._expired_out, []
        tier = (list(self.models[batch[0].model].tiers).index(batch[0].tier)
                if batch else 0)
        self._broadcast(torch.tensor([op, len(batch), len(expired), tier],
                                     dtype=torch.int64, device=self.device))
        if batch or expired:
            self._broadcast(torch.tensor([r.uid for r in batch] + expired,
                                         dtype=torch.int64,
                                         device=self.device))

    def _hear(self) -> Tuple[int, List[int], List[int], int]:
        """A non-lead rank's read of one `_tell`: (op, the batch's uids,
        the expired uids, the tier's index)."""
        op, nb, ne, tier = self._broadcast(torch.zeros(
            4, dtype=torch.int64, device=self.device)).tolist()
        uids = (self._broadcast(torch.zeros(
            nb + ne, dtype=torch.int64, device=self.device)).tolist()
            if nb + ne else [])
        return op, uids[:nb], uids[nb:], tier

    def _run_told(self, batch: List[GNNRequest], tier: int) -> None:
        """A non-lead rank runs the lead's sharded batch at its tier."""
        name = list(self.models[batch[0].model].tiers)[tier]
        for r in batch:
            r.tier = name
        self._execute_sharded(batch)

    def _follow(self) -> None:
        """A non-lead rank's `run()`: take the lead's messages in order,
        finish the requests it expired, and run each sharded batch it
        picked, at its tier, until it is done. The queue must then be
        empty: every rank queued the same sharded requests."""
        while True:
            op, uids, gone, tier = self._hear()
            gone = set(gone)
            if gone:
                self._complete_expired([r for r in self.queue
                                        if r.uid in gone], self.clock.now())
            by_uid = {r.uid: r for r in self.queue if r.uid not in gone}
            if op == _DONE:
                if by_uid:
                    raise RuntimeError(
                        f"rank {dist.get_rank()} still holds requests "
                        f"{sorted(by_uid)} the lead never dispatched")
                self.queue = []
                return
            missing = [u for u in uids if u not in by_uid]
            if missing:
                raise RuntimeError(f"rank {dist.get_rank()} has no request "
                                   f"{missing} of the lead's batch")
            taken = set(uids) | gone
            self.queue = [r for r in self.queue if r.uid not in taken]
            self._run_told([by_uid[u] for u in uids], tier)

    def _complete_expired(self, expired: List[GNNRequest],
                          now: float) -> None:
        """Finish requests whose deadline passed before dispatch (§14):
        done at once, `deadline_missed`, no predictions, so an answer the
        caller can no longer use takes no batch slot. Counted per request
        in `deadline_misses`; their submit-to-expiry latency still feeds
        the metrics and the governor, which exists to see that overload.
        On the card the dispatch stream waits on their host stages'
        events, so their memory is not reused while that work runs. The
        lead of a mesh keeps the sharded ones for its next message
        (`_tell`), whichever sweep expired them."""
        for r in expired:
            if r.ready is not None:
                self._dispatch_stream.wait_event(r.ready)
            r.done = True
            r.deadline_missed = True
            r.finished_s = now
        with self._lock:
            for r in expired:
                self.metrics["latency_s"].append(now - r.submitted_s)
                self.metrics["deadline_misses"] += 1
                self.finished.append(r)
                if self.governor is not None:
                    self.governor.observe(now - r.submitted_s)
            self.metrics["last_finish_s"] = now
            if self.mesh is not None and self._lead:
                self._expired_out.extend(r.uid for r in expired if r.shards)

    def _run_batch(self) -> None:
        # the expiry sweep first (§14): requests past their deadline
        # complete flagged instead of taking a dispatch
        now = self.clock.now()
        expired = [r for r in self.queue
                   if r.deadline_s is not None and r.deadline_s <= now]
        if expired:
            gone = {r.uid for r in expired}
            self.queue = [r for r in self.queue if r.uid not in gone]
            self._complete_expired(expired, now)
            if not self.queue:
                return
        # best-filling key first, with slack as the tie-break; tier, backend
        # and fusion mode are part of the key, so a batch never mixes plans
        key = edf_best_fill_key(edf_pending_stats(self.queue, now),
                                self.sc.batch_slots, self._last_dispatch,
                                replica_slots=self.sc.replica_groups)
        # a sharded key takes one request per replica row (§15)
        take = self.sc.replica_groups if key[5] else self.sc.batch_slots
        batch = [r for r in self.queue
                 if (r.model, r.bucket, r.tier, r.backend, r.fusion,
                     r.shards) == key][:take]
        taken = {r.uid for r in batch}
        self.queue = [r for r in self.queue if r.uid not in taken]
        if self.mesh is not None and key[5]:
            self._tell(_BATCH, batch)
        self._execute_batch(batch)

    def _execute_batch(self, batch: List[GNNRequest]) -> None:
        """DEVICE stage: one fixed-width dispatch of 1..batch_slots requests
        sharing one key, from one thread at a time (the sync `run()` loop
        or the scheduler's dispatcher). Junk slots repeat the last real
        request so the batch width never changes shape; their outputs are
        dropped. On the card it runs on the dispatch stream, which first
        waits on each request's host-stage event, and it syncs only that
        stream, not the host workers' uploads. `device_busy_s` accumulates
        the wall clock from the stack of the device-resident features and
        operands to the dispatch stream's completion; the feature upload
        is the host stage's. Every request of a grasp batch whose plan
        runs the plain form (`grasp_ref_fallback`, the CPU) counts in
        `backend_fallbacks`. A request finished past its deadline is
        delivered and flagged `deadline_missed` (§14). A sharded batch
        (shards > 0) runs `_execute_sharded` instead."""
        head = batch[0]
        if head.shards:
            self._execute_sharded(batch)
            return
        b = self.sc.batch_slots
        bkey = self._bank_key(head.model, head.bucket, head.tier,
                              head.backend, head.fusion, 0)
        t0 = self.clock.now()
        slots = batch + [batch[-1]] * (b - len(batch))
        e = self.models[head.model]
        with self._dispatching():
            if self._dispatch_stream is not None:
                for r in batch:
                    self._dispatch_stream.wait_event(r.ready)
            x = torch.stack([r.x for r in slots])
            ops = stack_operands([r.ops for r in slots])
            tops = (stack_tier_operands([r.tier_ops for r in slots])
                    if slots[0].tier_ops is not None else None)
            plan = self.plan_for(head.model, head.bucket, head.tier,
                                 head.backend, head.fusion)
            logits = plan(e.params, x, ops, e.calibrations.get(head.tier),
                          tops)
            if self._dispatch_stream is not None:
                self._dispatch_stream.synchronize()
            # a fake clock advances its scripted per-key latency here,
            # between the dispatch timestamps
            self.clock.on_batch(bkey)
            now = self.clock.now()
            host_logits = logits.cpu().numpy()
        for i, r in enumerate(batch):
            lg = host_logits[i, : r.pg.num_nodes]
            r.preds = lg.argmax(axis=-1).astype(np.int32)
            if self.sc.return_logits:
                r.logits = lg
            r.done = True
            r.finished_s = now
            if r.deadline_s is not None and now > r.deadline_s:
                # executed but late: delivered and flagged, unlike an
                # expiry before dispatch, whose preds stay None
                r.deadline_missed = True
        with self._lock:
            self.bank.observe(bkey, now - t0)
            for r in batch:
                lat = now - r.submitted_s
                self.metrics["latency_s"].append(lat)
                self.finished.append(r)
                if r.deadline_missed:
                    self.metrics["deadline_misses"] += 1
                if self.governor is not None:
                    self.governor.observe(lat)
            self.metrics["batches"] += 1
            self.metrics["slots_filled"] += len(batch)
            self.metrics["slots_total"] += b
            if head.backend == "grasp":
                self.metrics["grasp_batches"] += 1
                if plan.grasp_ref_fallback:
                    self.metrics["backend_fallbacks"] += len(batch)
            self.metrics["device_busy_s"] += now - t0
            self.metrics["last_finish_s"] = now
            self._last_dispatch[head.model] = self._dispatch_serial
            self._dispatch_serial += 1

    def _halo_bytes(self, cfg: GNNConfig, part: GraphShards
                    ) -> Tuple[int, int]:
        """(compressed, exact) collective bytes one sharded forward would
        move between cards: ring all-reduce traffic priced through
        `dist.compress.ring_psum_nbytes` (the one owner of the ring
        factor, which `core.partition.modelled_sharded_latency` uses too),
        1 byte an element on the int8 wire against 4 exact, over the
        kind's exchange schedule (`sharded_exchange_widths`)."""
        elems = sum(part.full_rows * w for w in sharded_exchange_widths(cfg))
        comp = ring_psum_nbytes(part.shards, elems, bytes_per_elt=1)
        return int(comp), int(4 * comp)

    def _execute_sharded(self, batch: List[GNNRequest]) -> None:
        """DEVICE stage of one sharded dispatch (§12, §15) on the dispatch
        stream: the plan runs every shard's aggregation and combine with
        the halo exchange between layers, and the slot-ordered logits go
        back to node order on the host (`unshard_logits`). With
        `replica_groups` R > 1 the batch carries up to R same-key
        requests, one per replica row; junk rows repeat the last real
        request and their outputs are dropped. Each replica exchanges
        within itself, so the collective bytes are counted per REAL
        request: what the int8 wire moves and what exact fp32 would. On a
        mesh the rank at (replica r, shard s) runs shard s of the batch's
        r-th request, and the (R, S, C, classes) logits are gathered over
        the mesh (`dist.sharding.assemble`), so every rank answers every
        request of the batch."""
        head = batch[0]
        r_width = self.sc.replica_groups
        bkey = self._bank_key(head.model, head.bucket, head.tier, "dense",
                              "none", head.shards)
        t0 = self.clock.now()
        e = self.models[head.model]
        with self._dispatching():
            if self._dispatch_stream is not None:
                for r in batch:
                    self._dispatch_stream.wait_event(r.ready)
            plan = self.plan_for(head.model, head.bucket, head.tier,
                                 shards=head.shards)
            quant = e.calibrations.get(head.tier)
            if self.mesh is not None:
                slots = batch + [batch[-1]] * (r_width - len(batch))
                mine = slots[self.mesh.coords.get("replica", 0)]
                block = plan(e.params, mine.shard_x, mine.ops, quant,
                             node_mask=mine.shard_mask)
                logits = (assemble(block[None, None], ("replica", "shard",
                                                       None, None),
                                   self.mesh) if r_width > 1 else
                          assemble(block[None], ("shard", None, None),
                                   self.mesh))
            elif r_width == 1:
                logits = plan(e.params, head.shard_x, head.ops, quant,
                              node_mask=head.shard_mask)
            else:
                slots = batch + [batch[-1]] * (r_width - len(batch))
                logits = plan(e.params,
                              torch.stack([r.shard_x for r in slots]),
                              stack_operands([r.ops for r in slots]), quant,
                              node_mask=torch.stack([r.shard_mask
                                                     for r in slots]))
            if self._dispatch_stream is not None:
                self._dispatch_stream.synchronize()
            self.clock.on_batch(bkey)
            now = self.clock.now()
            host_logits = logits.cpu().numpy()
        comp_total = exact_total = 0
        for i, r in enumerate(batch):
            lg = unshard_logits(host_logits[i] if r_width > 1
                                else host_logits, r.part)
            r.preds = lg.argmax(axis=-1).astype(np.int32)
            if self.sc.return_logits:
                r.logits = lg
            r.done = True
            r.finished_s = now
            if r.deadline_s is not None and now > r.deadline_s:
                r.deadline_missed = True
            comp, exact = self._halo_bytes(e.cfg, r.part)
            comp_total += comp
            exact_total += exact
        with self._lock:
            self.bank.observe(bkey, now - t0)
            for r in batch:
                lat = now - r.submitted_s
                self.metrics["latency_s"].append(lat)
                self.finished.append(r)
                if r.deadline_missed:
                    self.metrics["deadline_misses"] += 1
                if self.governor is not None:
                    self.governor.observe(lat)
            self.metrics["batches"] += 1
            self.metrics["slots_filled"] += len(batch)
            self.metrics["slots_total"] += r_width
            self.metrics["sharded_batches"] += 1
            self.metrics["halo_bytes_exchanged"] += (
                comp_total if self.sc.halo_compress else exact_total)
            self.metrics["collective_bytes_compressed"] += comp_total
            self.metrics["collective_bytes_exact"] += exact_total
            self.metrics["device_busy_s"] += now - t0
            self.metrics["last_finish_s"] = now
            self._last_dispatch[head.model] = self._dispatch_serial
            self._dispatch_serial += 1

    # -------------------------------------------------------------- pipeline
    def scheduler(self, pc=None):
        """Attach the two-stage pipeline scheduler (DESIGN.md §9): a
        `runtime.scheduler.PipelineScheduler` whose host workers run this
        engine's `prepare_submit`/`prepare_query` while its dispatcher
        runs `_execute_batch`. Use it as a context manager; the sync
        `submit`/`query` + `run()` path stays usable beside it. On a mesh
        every rank opens it together and makes the same calls on it: the
        lead batches, the others run the lead's sharded batches in its
        order (see the scheduler's module docstring); one scheduler at a
        time, and `run()` waits until it is closed. The first one makes
        the caller's gloo group (`dist.new_group`, a collective of the
        whole world)."""
        from repro_torch.runtime.scheduler import PipelineScheduler
        if self.mesh is not None:
            if self._open_scheduler is not None:
                raise RuntimeError("a scheduler is already open on this "
                                   "mesh engine: close it first")
            if self._caller_group is None:
                self._caller_group = dist.new_group(list(self.mesh.ranks),
                                                    backend="gloo")
        return PipelineScheduler(self, pc)

    # ---------------------------------------------------------------- metrics
    def tier_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-tier serving stats from the finished requests (each carries
        its RESOLVED tier, so fp32 fallbacks count as fp32 here and as
        `tier_fallbacks` in `summary()`)."""
        with self._lock:
            finished = list(self.finished)
        return self._tier_summary(finished)

    @staticmethod
    def _tier_summary(finished: List[GNNRequest]
                      ) -> Dict[str, Dict[str, float]]:
        by_tier: Dict[str, List[GNNRequest]] = {}
        for r in finished:
            by_tier.setdefault(r.tier, []).append(r)
        out: Dict[str, Dict[str, float]] = {}
        for tn, reqs in sorted(by_tier.items()):
            lat = np.asarray([r.finished_s - r.submitted_s for r in reqs])
            span = (max(r.finished_s for r in reqs)
                    - min(r.submitted_s for r in reqs))
            out[tn] = {
                "requests": len(reqs),
                "p50_latency_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_latency_ms": float(np.percentile(lat, 99) * 1e3),
                "throughput_rps": (len(reqs) / span) if span > 0 else 0.0,
            }
        return out

    def summary(self) -> Dict[str, object]:
        with self._lock:
            m = dict(self.metrics)
            finished = list(self.finished)
            lat = np.asarray(m["latency_s"], np.float64)
            cache = {"cache_resident_bytes": self._cache.resident_bytes,
                     "cache_evictions": self._cache.evictions,
                     "cache_spilled": self._cache.spilled,
                     "cache_dropped": self._cache.dropped,
                     "cache_spill_entries": self._cache.spill_entries}
            shard_counts = {gid: p.shards
                            for gid, (p, _) in self._sharded.items()}
            gov = self.governor
            slo = {"slo_downgrades": gov.downgrades if gov else 0,
                   "slo_upgrades": gov.upgrades if gov else 0,
                   "slo_level": gov.level if gov else 0,
                   "ewma_vs_model": self.bank.ewma_vs_model()}
        t0, t1 = m["first_submit_s"], m["last_finish_s"]
        span = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
        busy = m["device_busy_s"]
        return {
            "device": str(self.device),
            "requests": len(finished),
            "compiled_blobs": self.compiled_blobs,
            "batches": m["batches"],
            "batch_occupancy": (m["slots_filled"]
                                / max(m["slots_total"], 1)),
            # the dispatch's wall clock (stack, plan, sync); the feature
            # upload belongs to the host stage
            "device_busy_s": busy,
            "device_idle_fraction": (max(0.0, 1.0 - busy / span)
                                     if span > 0 else 0.0),
            "rebucket_events": m["rebucket_events"],
            "operand_bytes_h2d": m["operand_bytes_h2d"],
            "operand_cache_hits": m["operand_cache_hits"],
            "operand_cache_misses": m["operand_cache_misses"],
            "cacheg_fallbacks": m["cacheg_fallbacks"],
            "tier_fallbacks": m["tier_fallbacks"],
            # GraSp: each model's mode, the batches that took the sparse
            # path, and the requests with grasp intent that ran dense
            # (forced but ineligible, or the plain form on the CPU)
            "agg_backends": {name: e.agg_backend
                             for name, e in self.models.items()},
            "grasp_batches": m["grasp_batches"],
            "backend_fallbacks": m["backend_fallbacks"],
            # sharded serving (§12): which attached graphs run partitioned
            # (across how many shards), the sharded dispatches, and the
            # collective bytes: what the halo wire moves and both framings
            # (int8 and exact fp32)
            "shard_counts": shard_counts,
            "sharded_batches": m["sharded_batches"],
            "halo_bytes_exchanged": m["halo_bytes_exchanged"],
            "collective_bytes_compressed": m["collective_bytes_compressed"],
            "collective_bytes_exact": m["collective_bytes_exact"],
            # §13 bounded cache: residency vs budget, capacity evictions
            # split by outcome (evictions == spilled + dropped), faults
            # served from the spill store, admission rejections
            "cache_resident_bytes": cache["cache_resident_bytes"],
            "cache_budget_bytes": self.sc.device_cache_budget_bytes,
            "cache_evictions": cache["cache_evictions"],
            "cache_spilled": cache["cache_spilled"],
            "cache_dropped": cache["cache_dropped"],
            "cache_spill_entries": cache["cache_spill_entries"],
            "cache_spill_hits": m["cache_spill_hits"],
            "cache_admission_rejects": m["cache_admission_rejects"],
            # GrAd: deltas patched on the device, deltas that took update(),
            # and the bytes the patched ones shipped (spec and int8 rows)
            "delta_updates": m["delta_updates"],
            "delta_fallbacks": m["delta_fallbacks"],
            "delta_bytes_h2d": m["delta_bytes_h2d"],
            # §15 sharded deltas: the bytes the boundary-dirty rows would
            # move against a full halo re-exchange, and the rows
            "delta_halo_bytes_exchanged": m["delta_halo_bytes_exchanged"],
            "delta_halo_bytes_full": m["delta_halo_bytes_full"],
            "delta_dirty_rows": m["delta_dirty_rows"],
            # §14 SLO loop: deadline outcomes, the governor's decisions,
            # and the bank's mean measured/modelled ratio
            "deadline_misses": m["deadline_misses"],
            "shed_requests": m["shed_requests"],
            **slo,
            "tiers": self._tier_summary(finished),
            "accuracy_delta_vs_fp32": {
                name: dict(e.accuracy_delta)
                for name, e in self.models.items() if e.accuracy_delta},
            "throughput_rps": (len(finished) / span if span > 0 else 0.0),
            "p50_latency_ms": (float(np.percentile(lat, 50) * 1e3)
                               if lat.size else 0.0),
            "p99_latency_ms": (float(np.percentile(lat, 99) * 1e3)
                               if lat.size else 0.0),
            "mean_latency_s": float(lat.mean()) if lat.size else 0.0,
        }
