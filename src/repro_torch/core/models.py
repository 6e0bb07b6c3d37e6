"""The paper's 2-layer GCN, GAT and GraphSAGE: the edge-list baseline and
the GraNNite path, their QuantGr serving tiers and GCN's offline QuantGr
calibration, GCN's GraSp aggregation backend, execution plans, and
full-batch training and evaluation.

Port of the reference's `core/models.py`.
Operands are torch tensors on an explicit device; the reference's `vmap`
over graphs is an explicit leading batch dimension B.

Plan identity keeps the zero-recompile contract without a compiler: an
`ExecutionPlan` records the shape/dtype/device signature of every call
(parameters, features, operands, tier calibration and tier operands),
and counts one "trace" for each signature it has not seen — exactly the
calls that would retrace a `jax.jit` in the reference. The tier-operand
deriver `AggQuantizer` and the GraSp structure deriver `BlockCompactor`
count the same way, and so does CacheG's `OperandMaterializer`, which
expands the compact transfer form (`CompactOperands`: bit-packed
adjacency plus a degree vector) into the dense operands on the device.
`GraphServe` sums these counts into `compiled_blobs`, so `assert_warm()`
still says whether serving stayed on the shapes warmup saw. The pipeline
scheduler calls the derivers from several host threads at once, so each
count checks and adds under one lock (`_count_trace`).

Sharded execution (the end of the module): a graph partitioned across S
shards (`core.partition`) runs as S row blocks of its operands
(`build_sharded_operands`) through a sharded plan (`build_sharded_plan`,
`forward_grannite_sharded`), the halo exchange between layers
(`halo_exchange`). One card holds every shard: the shard axis is a
leading tensor dimension.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.compress import INV_INT8_MAX, quantize_wire
from repro_torch.kernels import ops as kops

from . import effop, layers, masks
from .graph import (PaddedGraph, adjacency_keys, is_symmetric_adjacency,
                    keys_symmetric, pack_adjacency_bits, pad_graph,
                    symg_pack_adjacency_bits, symg_pack_keys)
from .layers import Techniques
from .quant import (QuantizedAgg, apply_quantized_agg,
                    apply_quantized_linear, calibrate_absmax, quantize_agg,
                    quantize_linear, quantize_rowwise)
from .sparsity import (BlockSparse, block_counts, compact_block_sparse,
                       pad_block_sparse, stack_block_sparse, to_block_sparse,
                       upload_block_sparse)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    kind: str                  # "gcn" | "gat" | "sage"
    in_feats: int
    hidden: int = 64
    num_classes: int = 7
    heads: int = 8             # GAT only (hidden per-head = hidden // heads)
    aggregator: str = "mean"   # SAGE only: "mean" | "max"
    max_neighbors: int = 10    # SAGE sampling cap (paper: 10)


KINDS = ("gcn", "gat", "sage")


def _check_kind(cfg: GNNConfig) -> None:
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown model kind {cfg.kind!r}; pick from "
                         f"{KINDS}")


def init_params(gen: torch.Generator, cfg: GNNConfig, *,
                device: DeviceLike = None) -> Dict:
    """GCN, GAT or SAGE parameters from a seeded `torch.Generator` (the
    port's own init; parity tests bring the reference's weights through
    `bridge`). GAT: layer 1 has `heads` heads of hidden // heads, layer 2
    one head of num_classes. SAGE-max layers add the pool combine."""
    _check_kind(cfg)
    device = resolve_device(device)
    if cfg.kind == "gat":
        per_head = cfg.hidden // cfg.heads
        return {"l1": layers.gat_init(gen, cfg.in_feats, per_head,
                                      cfg.heads, device=device),
                "l2": layers.gat_init(gen, cfg.heads * per_head,
                                      cfg.num_classes, 1, device=device)}
    if cfg.kind == "sage":
        return {"l1": layers.sage_init(gen, cfg.in_feats, cfg.hidden,
                                       aggregator=cfg.aggregator,
                                       device=device),
                "l2": layers.sage_init(gen, cfg.hidden, cfg.num_classes,
                                       aggregator=cfg.aggregator,
                                       device=device)}
    return {"l1": layers.gcn_init(gen, cfg.in_feats, cfg.hidden,
                                  device=device),
            "l2": layers.gcn_init(gen, cfg.hidden, cfg.num_classes,
                                  device=device)}


def forward_baseline(params: Dict, cfg: GNNConfig, x: torch.Tensor,
                     edge_index, num_nodes: int) -> torch.Tensor:
    """The edge-list forward (`layers.*_baseline`), the same parameters as
    `forward_grannite`: x (num_nodes, F) -> (num_nodes, C). edge_index
    (2, E), src in row 0 and dst in row 1, as an array or a tensor; the
    GCN and GAT match the dense path when it carries the self-loops."""
    _check_kind(cfg)
    if cfg.kind == "gcn":
        h = torch.relu(layers.gcn_baseline(params["l1"], x, edge_index,
                                           num_nodes))
        return layers.gcn_baseline(params["l2"], h, edge_index, num_nodes)
    if cfg.kind == "gat":
        per_head = cfg.hidden // cfg.heads
        h = torch.nn.functional.elu(layers.gat_baseline(
            params["l1"], x, edge_index, num_nodes, heads=cfg.heads,
            out_feats=per_head))
        return layers.gat_baseline(params["l2"], h, edge_index, num_nodes,
                                   heads=1, out_feats=cfg.num_classes)
    h = torch.relu(layers.sage_baseline(params["l1"], x, edge_index,
                                        num_nodes, aggregator=cfg.aggregator))
    return layers.sage_baseline(params["l2"], h, edge_index, num_nodes,
                                aggregator=cfg.aggregator)


@dataclasses.dataclass
class GranniteOperands:
    """Host-precomputed (GraphSplit/PreG/StaGr) dense operands on a device.

    Only the fields the kind reads are built (`OPERAND_FIELDS`, the
    reference's lean build); the others stay None where the reference
    holds (1, 1) placeholders. `block_sparse` is the GraSp compacted Â
    (tensor leaves) that a grasp plan reads, None for a dense plan.
    `quant` is the per-graph offline QuantGr form (`calibrate_quant`):
    serving tiers carry their calibration beside the operands instead.
    """
    norm_adj: Optional[torch.Tensor] = None   # (B?, cap, cap) PreG Â (GCN)
    mask_mult: Optional[torch.Tensor] = None  # GAT exact 0/1 mask
    bias_add: Optional[torch.Tensor] = None   # GAT GrAx1 0 / -1e9 mask
    sample_mask: Optional[torch.Tensor] = None  # SAGE sampled 0/1 mask
    mean_mask: Optional[torch.Tensor] = None    # SAGE row-normalised mask
    block_sparse: Optional[BlockSparse] = None
    quant: Optional[Dict] = None


# Which operand fields each model kind actually reads.
OPERAND_FIELDS = {
    "gcn": ("norm_adj",),
    "gat": ("mask_mult", "bias_add"),
    "sage": ("sample_mask", "mean_mask"),
}
DENSE_FIELDS = ("norm_adj", "mask_mult", "bias_add", "sample_mask",
                "mean_mask")


def build_operands(pg: PaddedGraph, cfg: GNNConfig, *, grasp: bool = False,
                   max_nnz: Optional[int] = None,
                   bitmap: Optional[np.ndarray] = None,
                   device: DeviceLike = None) -> GranniteOperands:
    """Host side of GraphSplit for one padded graph, uploaded to `device`:
    GCN's Â, with its host-compacted block structure when `grasp`
    (`to_block_sparse`, reusing `bitmap` from the caller's `block_stats`
    when given; the lists are as wide as the graph's densest block row, or
    padded to the bucket budget `max_nnz` so that a batch can stack);
    GAT's two masks over the adjacency with self-loops on the real nodes;
    SAGE's sampled 0/1 mask (`max_neighbors` per row, drawn with seed 0
    on every call, as the reference does) and its row-normalised mean
    mask.

    Only the reference's lean build exists in the port: the fields
    `cfg.kind` reads (`OPERAND_FIELDS`); the others stay None.
    """
    _check_kind(cfg)
    dev = resolve_device(device)
    fields = OPERAND_FIELDS[cfg.kind]
    vals = {}
    if "norm_adj" in fields:
        vals["norm_adj"] = pg.norm_adj
    if "bias_add" in fields:
        awl = masks.adj_with_self_loops(pg.adj, pg.num_nodes)
        vals["mask_mult"] = masks.attention_bias_multiplicative(awl)
        vals["bias_add"] = masks.attention_bias_additive(awl)
    if "sample_mask" in fields:
        sample = masks.sage_sample_adjacency(
            pg.adj, pg.num_nodes, max_neighbors=cfg.max_neighbors)
        vals["sample_mask"] = sample
        vals["mean_mask"] = masks.mean_from_mask(sample)
    sp = None
    if grasp:
        sp = to_block_sparse(pg.norm_adj, bitmap=bitmap)
        if max_nnz is not None:
            sp = pad_block_sparse(sp, max_nnz)
        sp = upload_block_sparse(sp, dev)
    return GranniteOperands(
        **{k: torch.from_numpy(v).to(dev) for k, v in vals.items()},
        block_sparse=sp)


def stack_operands(ops: Sequence[GranniteOperands]) -> GranniteOperands:
    """Stack per-graph operands into one batched (B, ...) set on their
    device: each dense field that the sets carry (one model kind per
    batch, so all or none of them). GraSp structures stack too
    (`stack_block_sparse`, one budget), all or none per batch: a grasp
    plan's operands always carry one, a dense plan's never do."""
    if not ops:
        raise ValueError("cannot stack an empty operand batch")
    if any(o.quant is not None for o in ops):
        raise ValueError(
            "per-graph offline QuantGr operands (ops.quant, built by "
            "calibrate_quant) cannot be batched — their QuantizedAgg bakes "
            "one graph's Â; serve quantized tiers through the model-level "
            "calibrate_tier path instead")
    with_blocks = [o.block_sparse is not None for o in ops]
    if any(with_blocks) and not all(with_blocks):
        raise ValueError(
            "cannot batch a mix of GraSp and dense operand sets — resolve "
            "one aggregation backend per batch")
    dense = {f: [getattr(o, f) for o in ops] for f in DENSE_FIELDS}
    for f, ts in dense.items():
        if any(t is None for t in ts) and not all(t is None for t in ts):
            raise ValueError(f"cannot batch operand sets with and without "
                             f"{f!r} — one model kind per batch")
    return GranniteOperands(
        **{f: (torch.stack(ts) if ts[0] is not None else None)
           for f, ts in dense.items()},
        block_sparse=(stack_block_sparse([o.block_sparse for o in ops])
                      if all(with_blocks) else None))


# ---------------------------------------------------------------------------
# CacheG operand pipeline (DESIGN.md §7)
#
# The eager path above builds the O(cap²) float32 operands on the HOST and
# uploads them on every request. CacheG replaces that with (1) a compact
# transfer form — one bit-packed 0/1 adjacency plus a degree vector
# (`CompactOperands`), SymG-triangular when the graph is undirected — and
# (2) a materializer that re-derives the dense operands with tensor ops on
# the device, so the big arrays are created in device memory and never
# cross the link. GraphServe then caches the result per (graph_id,
# structure_version) (`runtime.cache.DeviceCacheManager`).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompactOperands:
    """Compact host→device transfer form of one graph's operand structure.

    `packed` is the bit-packed 0/1 adjacency: the SymG upper triangle for
    undirected GCN/GAT graphs (`triangular=True`), the full row-major
    matrix otherwise — for SAGE it packs the host-*sampled* adjacency
    (sampling stays on the host for seeded determinism). `degree` carries
    the row sums the materializer divides by (deg(A+I) for GCN, sample row
    sums for SAGE, zeros for GAT, which reads none), so host and device
    paths normalize with bit-identical denominators. The three tensors lie
    on the host (pinned when a spilled form waits for a CUDA fault) or,
    once `to()` has moved them, on the device.
    """
    packed: torch.Tensor      # (ceil(nbits / 8),) uint8
    degree: torch.Tensor      # (cap,) float32
    num_nodes: torch.Tensor   # () int32
    capacity: int
    fields: Tuple[str, ...]   # which GranniteOperands fields to materialize
    triangular: bool          # SymG triangular packing vs full row-major

    @property
    def nbytes(self) -> int:
        """Bytes this form moves host→device (the operand_bytes_h2d unit)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.degree, self.num_nodes))

    def to(self, device: torch.device) -> "CompactOperands":
        """The same form on `device`. A copy to the card is queued without
        the host waiting for the work already queued there: from pinned
        memory, a pageable host form staged through it first (the form
        never changes, and PyTorch keeps a pinned buffer until its copy
        is done). A form already on `device` stays where it is."""
        def move(t):
            if (device.type == "cuda" and t.device.type == "cpu"
                    and not t.is_pinned()):
                t = pinned_copy(t)
            return t.to(device, non_blocking=True)
        return dataclasses.replace(self, **{
            f: move(getattr(self, f))
            for f in ("packed", "degree", "num_nodes")})

    def pin(self) -> "CompactOperands":
        """The same form in pinned host memory, for an upload that the
        host does not wait on."""
        return dataclasses.replace(self, **{
            f: pinned_copy(getattr(self, f))
            for f in ("packed", "degree", "num_nodes")})


def pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A host tensor copied into pinned memory by the calling thread.
    `Tensor.pin_memory()` splits a copy this large over PyTorch's intra-op
    thread pool, whose workers then wait on cores that a busy host shares
    and spin on after the copy, slowing the request's other host work:
    with eight busy processes beside it on the H100's 8-core host, that
    made CacheG's intake slower than the eager upload it replaces
    (`chip_smoke.py [intake]`)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    np.copyto(out.numpy(), t.numpy())
    return out


def gcn_degree(adj: np.ndarray, num_nodes: int,
               keys: Optional[np.ndarray] = None) -> np.ndarray:
    """deg(A + I) with the self loops on the real nodes only: the row sums
    of `adj` plus one on each real row whose diagonal is empty — an
    explicit (i, i) edge counts once, as `masks.adj_with_self_loops` does,
    without building that (cap, cap) copy. With `keys`
    (`graph.adjacency_keys` of the 0/1 `adj`) it counts them instead."""
    cap = adj.shape[0]
    if keys is None:
        deg = adj.sum(axis=1, dtype=np.float32)
        diag = np.diagonal(adj)
    else:
        row, col = np.divmod(keys, cap)
        deg = np.bincount(row, minlength=cap).astype(np.float32)
        diag = np.zeros((cap,), np.float32)
        diag[row[row == col]] = 1.0
    deg[:num_nodes] += 1.0 - diag[:num_nodes]
    return deg


def is_symmetric(pg: PaddedGraph, keys: Optional[np.ndarray] = None) -> bool:
    """Whether the graph's adjacency is undirected, from its `keys` when
    the caller has them, else by `is_symmetric_adjacency`."""
    if keys is not None:
        return keys_symmetric(keys, pg.capacity)
    return is_symmetric_adjacency(pg.adj)


def compact_operands(pg: PaddedGraph, cfg: GNNConfig, *,
                     check_symmetry: bool = True,
                     keys: Optional[np.ndarray] = None) -> CompactOperands:
    """Host side of CacheG: pack one graph's structure into transfer form
    (host tensors).

    GCN/GAT pack the raw adjacency SymG-triangular, which requires an
    undirected graph (callers check `is_symmetric` and take the eager
    dense path for directed ones); `check_symmetry=False` skips the
    re-check for a caller that ran it. `keys`, the graph's
    `graph.adjacency_keys`, give the same bytes and degrees from the edge
    list without a pass over the (cap, cap) matrix. SAGE samples on the
    host (seed 0, as `build_operands`) and packs the sample, which is
    direction-biased, hence always full row-major.
    """
    _check_kind(cfg)
    fields = OPERAND_FIELDS[cfg.kind]
    cap = pg.capacity
    if cfg.kind == "sage":
        sample = masks.sage_sample_adjacency(
            pg.adj, pg.num_nodes, max_neighbors=cfg.max_neighbors)
        packed = pack_adjacency_bits(sample)
        degree = sample.sum(axis=1).astype(np.float32)
        triangular = False
    else:
        if check_symmetry and not is_symmetric(pg, keys):
            raise ValueError("CacheG's SymG packing requires an undirected "
                             "(symmetric) adjacency")
        packed = (symg_pack_adjacency_bits(pg.adj, check=False)
                  if keys is None else symg_pack_keys(keys, cap))
        degree = (gcn_degree(pg.adj, pg.num_nodes, keys)
                  if cfg.kind == "gcn" else np.zeros((cap,), np.float32))
        triangular = True
    return CompactOperands(
        packed=torch.from_numpy(packed), degree=torch.from_numpy(degree),
        num_nodes=torch.tensor(pg.num_nodes, dtype=torch.int32),
        capacity=cap, fields=fields, triangular=triangular)


def triangle_index(capacity: int, device: torch.device) -> torch.Tensor:
    """(cap * cap,) int32 (int64 past 32,767 nodes): where entry (i, j) of
    a symmetric matrix sits in its SymG bits — the upper-triangle offset
    of (min(i, j), max(i, j))."""
    cap = capacity
    i = torch.arange(cap, device=device, dtype=torch.int32
                     if 2 * cap * cap < 2 ** 31 else torch.int64)
    # row r's triangle starts at r*cap - r(r-1)/2, so (r, c >= r) sits at
    # start[r] + c, and (r, c < r) at the transposed offset
    start = (i * (2 * cap - i + 1)) // 2 - i
    upper = start[:, None] + i[None, :]
    return torch.where(i[:, None] <= i[None, :], upper, upper.T).reshape(-1)


def _unpack_adjacency(co: CompactOperands,
                      index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed bits -> dense (cap, cap) float32 0/1, on the form's device.
    Torch has no unpackbits: each byte's bits are shifted out (np.packbits'
    big-endian order); the triangular form then gathers the symmetric
    matrix in one pass through `index` (`triangle_index`, built here when
    the caller keeps none)."""
    cap = co.capacity
    dev = co.packed.device
    bits = co.packed[:, None] >> torch.arange(7, -1, -1, dtype=torch.uint8,
                                              device=dev)
    bits = bits.bitwise_and_(1).reshape(-1)
    if co.triangular:
        bits = bits.index_select(0, index if index is not None
                                 else triangle_index(cap, dev))
    return bits[:cap * cap].reshape(cap, cap).to(torch.float32)


def inv_sqrt_degree(degree: torch.Tensor) -> torch.Tensor:
    """D^-1/2 of GCN's normalization: 1/sqrt(deg) where deg > 0, else 0
    (padded nodes), computed as the host's `gcn_norm_adjacency` does —
    sqrt then a correctly rounded division, never rsqrt — so the device Â
    equals the host Â bit for bit. The one place the port forms it."""
    return torch.where(degree > 0,
                       1.0 / torch.sqrt(torch.clamp(degree, min=1e-12)), 0.0)


def materialize_operands(co: CompactOperands,
                         index: Optional[torch.Tensor] = None
                         ) -> GranniteOperands:
    """Device side of CacheG: expand the compact form into the dense
    operand set `co.fields` names, on the form's device; the other fields
    stay None, as `build_operands` leaves them. GCN: Â =
    D^-1/2 (A + I) D^-1/2 (`inv_sqrt_degree`); GAT: the 0/1 and 0/-1e9
    masks over A + I; SAGE: the sample and its row-normalised mean mask.
    Self loops go on the real nodes only. `index` is the triangular
    form's `triangle_index`, when the caller keeps one."""
    adj = _unpack_adjacency(co, index)
    vals = {}
    if "sample_mask" in co.fields:
        # packed IS the sampled adjacency (self loops already included)
        vals["sample_mask"] = adj
        vals["mean_mask"] = adj / torch.clamp(co.degree[:, None], min=1.0)
        return GranniteOperands(**vals)
    # A + I in place: a 1 on each real node's diagonal
    real = torch.arange(co.capacity, device=adj.device) < co.num_nodes
    diag = adj.diagonal()
    diag.copy_(torch.maximum(diag, real.to(adj.dtype)))
    if "norm_adj" in co.fields:
        # in place, in the host's order: (d_i * a_ij) * d_j
        dis = inv_sqrt_degree(co.degree)
        vals["norm_adj"] = adj.mul_(dis[:, None]).mul_(dis[None, :])
    if "bias_add" in co.fields:
        vals["mask_mult"] = adj                   # 0/1 already
        vals["bias_add"] = torch.where(adj > 0, 0.0, masks.NEG_INF)
    return GranniteOperands(**vals)


@dataclasses.dataclass
class OperandMaterializer:
    """The CacheG expander on one device, with ExecutionPlan's trace
    accounting: one trace per unseen (capacity, fields, triangular) and
    leaf signature, the structure a jit of `materialize_operands` would
    specialize on. GraphServe warms one per (bucket, fieldset) in
    `warmup()` and adds `trace_count` to `compiled_blobs`.

    Like a compiled program's constants, each bucket's `triangle_index`
    is built once and kept (cap² int32: 37.7 MB at 3072), so a call
    allocates only its outputs and one byte per entry: per-call index
    temporaries of that size churned the device allocator in a serving
    burst."""
    device: torch.device
    trace_count: int = 0
    _seen: Set = dataclasses.field(default_factory=set, repr=False)
    _index: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict,
                                                        repr=False)

    def __call__(self, co: CompactOperands) -> GranniteOperands:
        co = co.to(self.device)
        _count_trace(self, _sig(co))
        index = self._index.get(co.capacity) if co.triangular else None
        if co.triangular and index is None:
            with _TRACE_LOCK:
                index = self._index.get(co.capacity)
                if index is None:
                    index = triangle_index(co.capacity, self.device)
                    if self.device.type == "cuda":
                        # other threads read it on their own streams
                        torch.cuda.current_stream(self.device).synchronize()
                    self._index[co.capacity] = index
        return materialize_operands(co, index)


def build_materializer(device: DeviceLike = None) -> OperandMaterializer:
    """A materializer on `device` (the card unless the caller names
    another; raises without one, as `resolve_device` does)."""
    return OperandMaterializer(device=resolve_device(device))


@dataclasses.dataclass
class HostOperands:
    """Product of the pipeline's HOST stage for one request.

    Exactly one of `compact` / `eager` is set. `compact` is the CacheG
    transfer form on the host; `eager` is the dense build, already on the
    device (the eager path uploads as it builds), with a grasp request's
    host-built block structure attached. `nbytes` is the host→device
    operand traffic (`operand_bytes_h2d`); `fallback`
    marks a directed GCN/GAT graph that could not take the SymG compact
    path (counted as `cacheg_fallbacks`). On the compact path a GraSp
    structure is derived on the device from the materialized Â instead.
    """
    compact: Optional[CompactOperands] = None
    eager: Optional[GranniteOperands] = None
    nbytes: int = 0
    fallback: bool = False


def prepare_host_operands(pg: PaddedGraph, cfg: GNNConfig, *,
                          use_cacheg: bool = True,
                          grasp_max_nnz: Optional[int] = None,
                          grasp_bitmap: Optional[np.ndarray] = None,
                          symmetric: Optional[bool] = None,
                          keys: Optional[np.ndarray] = None,
                          device: DeviceLike = None) -> HostOperands:
    """HOST stage of the operand pipeline: pack (CacheG) or build (eager).

    Prefers the compact form; directed GCN/GAT graphs (SymG needs
    symmetry) and `use_cacheg=False` take the eager dense build, uploaded
    to `device`. `grasp_max_nnz` marks a GCN request resolved to the GraSp
    backend: the eager path then also compacts the block structure on the
    host (`to_block_sparse`, reusing `grasp_bitmap`, padded to the budget)
    and counts its bytes; the compact path ignores it. `symmetric` skips
    the symmetry check when the caller already ran it on this adjacency;
    `keys` (`graph.adjacency_keys`) let the check and the packing read
    the edge list instead of the (cap, cap) matrix.
    """
    if use_cacheg and (cfg.kind == "sage"
                       or (symmetric if symmetric is not None
                           else is_symmetric(pg, keys))):
        co = compact_operands(pg, cfg, check_symmetry=False, keys=keys)
        return HostOperands(compact=co, nbytes=co.nbytes)
    grasp = grasp_max_nnz is not None and cfg.kind == "gcn"
    ops = build_operands(pg, cfg, grasp=grasp, max_nnz=grasp_max_nnz,
                         bitmap=grasp_bitmap, device=device)
    nbytes = sum(getattr(ops, f).numel() * getattr(ops, f).element_size()
                 for f in OPERAND_FIELDS[cfg.kind])
    if grasp:
        nbytes += ops.block_sparse.nbytes
    return HostOperands(eager=ops, nbytes=nbytes, fallback=use_cacheg)


def realize_operands(ho: HostOperands,
                     materializer: OperandMaterializer) -> GranniteOperands:
    """DEVICE stage counterpart: the materializer's dense operand set for
    a compact form (uploaded first), the already uploaded set for the
    eager one."""
    if ho.compact is not None:
        return materializer(ho.compact)
    return ho.eager


# Device bytes the reference counts for each (1, 1) float32 placeholder it
# holds where the port holds None (ROADMAP queue 3: an accounting term).
PLACEHOLDER_BYTES = 4


def operand_nbytes(ops: GranniteOperands) -> int:
    """Device bytes of one operand set in the reference's layout: the five
    dense fields, an absent one counted as its (1, 1) float32 placeholder,
    so cache entry sizes and eviction decisions equal the reference's. A
    GraSp structure is sized where it is cached (the "grasp" entry)."""
    return sum(PLACEHOLDER_BYTES if t is None
               else t.numel() * t.element_size()
               for t in (getattr(ops, f) for f in DENSE_FIELDS))


@dataclasses.dataclass
class TierOperands:
    """Per-(graph, tier) DERIVED operands: GCN's int8 aggregation form, Â
    row-quantized once per structure version and kept on the device beside
    the fp32 operands it came from, so an int8 plan reads 1-byte Â rows
    instead of re-quantizing the 4-byte fp32 Â every query."""
    agg_aq: torch.Tensor        # (B?, cap, cap) int8 row-quantized Â
    agg_a_scale: torch.Tensor   # (B?, cap, 1) float32 per-row scales


def derive_tier_operands(norm_adj: torch.Tensor) -> TierOperands:
    """Row-quantize one fp32 Â (`quantize_rowwise`, the rounding rule of
    every QuantGr aggregation path)."""
    aq, a_scale = quantize_rowwise(norm_adj)
    return TierOperands(agg_aq=aq, agg_a_scale=a_scale)


def stack_tier_operands(tos: Sequence[TierOperands]) -> TierOperands:
    """Stack per-graph tier operands into one batched (B, ...) set."""
    return TierOperands(agg_aq=torch.stack([t.agg_aq for t in tos]),
                        agg_a_scale=torch.stack([t.agg_a_scale
                                                 for t in tos]))


_TRACE_LOCK = threading.Lock()


def _count_trace(owner, sig) -> None:
    """Count one trace on `owner` (its `_seen` set and `trace_count`) for
    a signature it has not seen. The check and the count happen under one
    lock: the scheduler's host workers and its dispatcher call the same
    derivers at once, and a count that raced would move `compiled_blobs`
    off what warmup recorded."""
    with _TRACE_LOCK:
        if sig not in owner._seen:
            owner._seen.add(sig)
            owner.trace_count += 1


def _sig(v):
    """Shape/dtype/device structure of a nested argument: what a jit trace
    would specialize on. Ints (and tuples of them) are static, as
    `BlockSparse.block_size` and `.shape` are for a trace, and so are
    strings (`CompactOperands.fields`)."""
    if v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), v.dtype, v.device)
    if isinstance(v, dict):
        return tuple((k, _sig(v[k])) for k in sorted(v))
    if isinstance(v, tuple):
        return tuple(_sig(e) for e in v)
    if dataclasses.is_dataclass(v):
        return (type(v).__name__,
                tuple(_sig(getattr(v, f.name))
                      for f in dataclasses.fields(v)))
    raise TypeError(f"unsupported plan argument {type(v).__name__}")


@dataclasses.dataclass
class AggQuantizer:
    """The tier-operand deriver (the reference's jitted
    `build_agg_quantizer`), with ExecutionPlan's trace accounting:
    `trace_count` counts the distinct Â signatures (one per bucket) —
    GraphServe warms them in `warmup()` and adds the count to
    `compiled_blobs`."""
    trace_count: int = 0
    _seen: Set = dataclasses.field(default_factory=set, repr=False)

    def __call__(self, norm_adj: torch.Tensor) -> TierOperands:
        _count_trace(self, _sig(norm_adj))
        return derive_tier_operands(norm_adj)


@dataclasses.dataclass
class BlockCompactor:
    """The GraSp structure deriver (the reference's jitted
    `build_block_compactor`), with ExecutionPlan's trace accounting: each
    half counts one trace per unseen Â signature — and, for the gather,
    per budget — which is one per bucket. GraphServe warms both halves in
    `warmup()` and adds `trace_count` to `compiled_blobs`.

    The structure is derived state: computed on the device from an
    attached graph's cached fp32 Â once per (graph_id, version). `counts`
    is the cheap half (one bitmap reduction), enough for the backend rule,
    so a graph routed dense never pays the gather of `__call__`.
    """
    trace_count: int = 0
    _seen: Set = dataclasses.field(default_factory=set, repr=False)

    def _trace(self, *sig) -> None:
        _count_trace(self, sig)

    def __call__(self, norm_adj: torch.Tensor, *, max_nnz: int
                 ) -> Tuple[BlockSparse, torch.Tensor]:
        self._trace("compact", _sig(norm_adj), max_nnz)
        return compact_block_sparse(norm_adj, max_nnz=max_nnz)

    def counts(self, norm_adj: torch.Tensor) -> torch.Tensor:
        self._trace("counts", _sig(norm_adj))
        return block_counts(norm_adj)


# ---------------------------------------------------------------------------
# GrAd edge-delta patching (DESIGN.md §13): the device side of an
# incremental structure update of a cached operand entry — scatter the
# flipped entries, renormalize the touched rows/cols of Â, re-quantize
# only the int8 rows whose fp32 values changed. D^-1/2 comes from the
# patched degree vector through `inv_sqrt_degree`, and every product
# keeps the materializer's order, so a patched entry equals the
# materializer's output for the patched compact form bit for bit. A patch
# never writes into the tensors it is given: a request prepared before
# the delta keeps answering with the old structure.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeltaSpec:
    """Device-side description of one symmetric edge delta.

    `flip_*` and `touched` are padded to the engine's static widths
    (K_e, K_t) by REPEATING their first entry: a scatter then writes the
    same value twice at one index and a row renorm computes one row twice
    to the same bits, so the pads change nothing and the signature count
    stays bounded. `degree` is the patched deg(A + I), the vector a
    rebuild's compact form carries (`gcn_degree`).
    """
    flip_i: torch.Tensor           # (K_e,) int32 flip endpoints (both
    flip_j: torch.Tensor           # (K_e,) int32  (i, j) and (j, i) write)
    flip_v: torch.Tensor           # (K_e,) float32 new A value (1 add, 0 rm)
    touched: torch.Tensor          # (K_t,) int32 nodes whose rows changed
    degree: torch.Tensor           # (cap,) float32 patched deg(A + I)
    fields: Tuple[str, ...] = ()   # which operand fields to patch

    @property
    def nbytes(self) -> int:
        """Bytes this spec moves host→device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.flip_i, self.flip_j, self.flip_v,
                             self.touched, self.degree))


def patch_operands(ops: GranniteOperands, d: DeltaSpec) -> GranniteOperands:
    """One graph's cached dense operands patched by a delta, as new
    tensors on their device.

    GCN: A + I is recovered from the cached Â (an entry is non-zero iff
    it is set: real rows have D^-1/2 > 0, padded rows are all zero), the
    flips scattered in, and only the touched rows and columns
    renormalized as (d_i * a_ij) * d_j, the materializer's order; the
    other entries keep their bits. GAT: the 0/1 mask is A + I, so the
    flips scatter straight in, and into the 0/-1e9 bias at the same
    places."""
    if "norm_adj" in d.fields:
        na = ops.norm_adj.clone()
        awl = (ops.norm_adj != 0).to(torch.float32)
        awl[d.flip_i, d.flip_j] = d.flip_v
        awl[d.flip_j, d.flip_i] = d.flip_v
        dis = inv_sqrt_degree(d.degree)
        t = d.touched
        dis_t = dis.index_select(0, t)
        na[t, :] = (dis_t[:, None] * awl.index_select(0, t)) * dis[None, :]
        na[:, t] = (dis[:, None] * awl.index_select(1, t)) * dis_t[None, :]
        ops = dataclasses.replace(ops, norm_adj=na)
    if "bias_add" in d.fields:
        m, bias = ops.mask_mult.clone(), ops.bias_add.clone()
        b = torch.where(d.flip_v > 0, 0.0, masks.NEG_INF)
        for i, j in ((d.flip_i, d.flip_j), (d.flip_j, d.flip_i)):
            m[i, j] = d.flip_v
            bias[i, j] = b
        ops = dataclasses.replace(ops, mask_mult=m, bias_add=bias)
    return ops


def patch_tier_operands(tops: TierOperands, norm_adj: torch.Tensor,
                        rows: torch.Tensor) -> TierOperands:
    """The cached int8 Â with only `rows` re-quantized from the patched
    fp32 Â, as new tensors. `quantize_rowwise` (the rule `AggQuantizer`
    runs) is row-local, so quantizing a gathered row block gives the same
    bits as those rows of a whole-matrix run."""
    aq, a_scale = quantize_rowwise(norm_adj.index_select(0, rows))
    out = TierOperands(agg_aq=tops.agg_aq.clone(),
                       agg_a_scale=tops.agg_a_scale.clone())
    out.agg_aq[rows] = aq
    out.agg_a_scale[rows] = a_scale
    return out


@dataclasses.dataclass
class DeltaPatcher:
    """The GrAd delta patchers (the reference's jitted
    `build_delta_patcher`), with ExecutionPlan's trace accounting: the
    operand patch counts one trace per unseen (capacity, fields, K_t,
    K_e) signature, the tier patch one per (capacity, K_r). GraphServe
    warms both per bucket in `warmup()` and adds `trace_count` to
    `compiled_blobs`."""
    trace_count: int = 0
    _seen: Set = dataclasses.field(default_factory=set, repr=False)

    def _trace(self, *sig) -> None:
        _count_trace(self, sig)

    def __call__(self, ops: GranniteOperands, d: DeltaSpec
                 ) -> GranniteOperands:
        self._trace("operands", _sig(ops), _sig(d))
        return patch_operands(ops, d)

    def patch_tier(self, tops: TierOperands, norm_adj: torch.Tensor,
                   rows: torch.Tensor) -> TierOperands:
        self._trace("tier", _sig(tops), _sig(norm_adj), _sig(rows))
        return patch_tier_operands(tops, norm_adj, rows)


def calibrate_tier(params: Dict, cfg: GNNConfig, x: torch.Tensor,
                   ops_: GranniteOperands) -> Dict:
    """Model-level QuantGr calibration for one serving tier.

    One fp32 forward over the calibration features records the static
    ranges: per-layer QuantizedLinear weights ("l1", "l2") plus, for GCN,
    the aggregation activation scales `agg1_h`/`agg2_h`. GAT's forward is
    the exact-mask unfused one (`Techniques(effop=True)`), as in the
    reference. SAGE calibrates nested `self`, `neigh` and (max) `pool`
    QuantizedLinears per layer; the `neigh` input is the exact
    aggregation (the -1e9-bias max for max). The result is model-shaped,
    so one calibration serves every graph of the model; GCN's per-graph
    int8 Â is the separate derived operand (`derive_tier_operands`).
    x: (cap, F); ops_ one graph's operands.
    """
    if cfg.kind == "sage":
        t0 = Techniques(effop=True)

        def _layer(p, xin):
            if cfg.aggregator == "max":
                pooled = torch.relu(xin @ p["w_pool"] + p["b_pool"])
                agg = effop.masked_max_aggregate(pooled, ops_.sample_mask,
                                                 grax3=False)
            else:
                agg = ops_.mean_mask @ xin
            ql = {"self": quantize_linear(p["w_self"], xin),
                  "neigh": quantize_linear(p["w_neigh"], agg)}
            if "w_pool" in p:
                ql["pool"] = quantize_linear(p["w_pool"], xin)
            return ql

        h1 = torch.relu(layers.sage_grannite(
            params["l1"], x, ops_.sample_mask, ops_.mean_mask, t0,
            aggregator=cfg.aggregator))
        return {"l1": _layer(params["l1"], x),
                "l2": _layer(params["l2"], h1)}
    if cfg.kind == "gat":
        per_head = cfg.hidden // cfg.heads
        h1 = torch.nn.functional.elu(layers.gat_grannite(
            params["l1"], x, ops_.mask_mult, ops_.bias_add,
            Techniques(effop=True), heads=cfg.heads, out_feats=per_head))
        return {"l1": quantize_linear(params["l1"]["w"], x),
                "l2": quantize_linear(params["l2"]["w"], h1)}
    pre1 = x @ params["l1"]["w"]
    h1 = torch.relu(layers.gcn_grannite(params["l1"], x, ops_.norm_adj,
                                        Techniques(stagr=True)))
    pre2 = h1 @ params["l2"]["w"]
    return {"l1": quantize_linear(params["l1"]["w"], x),
            "l2": quantize_linear(params["l2"]["w"], h1),
            "agg1_h": calibrate_absmax(pre1).scale,
            "agg2_h": calibrate_absmax(pre2).scale}


def calibrate_quant(params: Dict, cfg: GNNConfig, x: torch.Tensor,
                    ops_: GranniteOperands) -> Dict:
    """QuantGr offline calibration of one graph, the whole GCN datapath:
    the combines' QuantizedLinears ("l1", "l2") and the aggregations'
    QuantizedAgg ("agg1", "agg2": this graph's Â row-quantized, H's scale
    from the fp32 forward). Set it as `ops_.quant` and a QuantGr
    `forward_grannite` runs it; its operands cannot be batched
    (`stack_operands`). x: (cap, F); ops_ one graph's operands."""
    if cfg.kind != "gcn":
        raise NotImplementedError("QuantGr calibration wired for GCN "
                                  "(paper Fig. 20)")
    with torch.no_grad():
        pre1 = x @ params["l1"]["w"]
        h1 = torch.relu(layers.gcn_grannite(params["l1"], x, ops_.norm_adj,
                                            Techniques(stagr=True)))
        pre2 = h1 @ params["l2"]["w"]
        return {"l1": quantize_linear(params["l1"]["w"], x),
                "l2": quantize_linear(params["l2"]["w"], h1),
                "agg1": quantize_agg(ops_.norm_adj, pre1),
                "agg2": quantize_agg(ops_.norm_adj, pre2)}


# Fusion modes (DESIGN.md §11): how a plan executes each LAYER.
#   none  — aggregate and combine as separate matmuls (+ host-side act).
#   layer — one fused kernel call per layer (aggregate + combine + bias +
#           act). Same math, another execution schedule.
FUSION_MODES = ("none", "layer")

# Aggregation backends (DESIGN.md §10): how a plan executes Â @ H.
#   dense — one dense product over the full (cap, cap) operand.
#   grasp — the block-sparse walk over a compacted structure (the operands
#           MUST carry `block_sparse`, padded to the bucket's grasp_max_nnz
#           budget; dense plans must carry None).
AGG_BACKENDS = ("dense", "grasp")


def forward_grannite(params: Dict, cfg: GNNConfig, x: torch.Tensor,
                     ops_: GranniteOperands, t: Techniques,
                     quant: Optional[Dict] = None,
                     tier_ops: Optional[TierOperands] = None,
                     fusion: str = "none") -> torch.Tensor:
    """One dense GraNNite forward over x (B?, cap, F) -> (B?, cap, C).

    `quant` is the model-level tier calibration from `calibrate_tier`
    (read only when `t.quantgr`); `ops_.quant` is the per-graph offline
    form, which wins when both are present. `tier_ops` carries GCN's
    derived int8 Â; without it a QuantGr GCN forward quantizes Â itself.
    `fusion="layer"` runs each layer as one fused kernel call
    (`fused_gcn_dense`, `fused_gcn_int8` or `fused_gcn_grasp` for GCN,
    `fused_gat_full` or `fused_gat_precombined` for GAT, `fused_sage` for
    a fp32 SAGE tier) with the inter-layer activation (GCN and SAGE ReLU,
    GAT ELU) folded into its epilogue. GAT's layer 2 is one head of
    `num_classes`.
    """
    if fusion not in FUSION_MODES:
        raise ValueError(f"unknown fusion mode {fusion!r}; pick from "
                         f"{FUSION_MODES}")
    tq = (quant or {}) if t.quantgr else {}
    if cfg.kind == "sage":
        masks_ = (ops_.sample_mask, ops_.mean_mask)
        kw = dict(aggregator=cfg.aggregator)
        if fusion == "layer":
            h = layers.sage_grannite_fused(params["l1"], x, *masks_, t,
                                           activation="relu",
                                           quant=tq.get("l1"), **kw)
            return layers.sage_grannite_fused(params["l2"], h, *masks_, t,
                                              activation="none",
                                              quant=tq.get("l2"), **kw)
        h = torch.relu(layers.sage_grannite(params["l1"], x, *masks_, t,
                                            quant=tq.get("l1"), **kw))
        return layers.sage_grannite(params["l2"], h, *masks_, t,
                                    quant=tq.get("l2"), **kw)
    if cfg.kind == "gat":
        per_head = cfg.hidden // cfg.heads
        if fusion == "layer":
            h = layers.gat_grannite_fused(
                params["l1"], x, ops_.bias_add, t, heads=cfg.heads,
                out_feats=per_head, activation="elu", quant=tq.get("l1"))
            return layers.gat_grannite_fused(
                params["l2"], h, ops_.bias_add, t, heads=1,
                out_feats=cfg.num_classes, activation="none",
                quant=tq.get("l2"))
        h = torch.nn.functional.elu(layers.gat_grannite(
            params["l1"], x, ops_.mask_mult, ops_.bias_add, t,
            heads=cfg.heads, out_feats=per_head, quant=tq.get("l1")))
        return layers.gat_grannite(params["l2"], h, ops_.mask_mult,
                                   ops_.bias_add, t, heads=1,
                                   out_feats=cfg.num_classes,
                                   quant=tq.get("l2"))
    q = ops_.quant or {}
    taq = tier_ops.agg_aq if tier_ops is not None else None
    tas = tier_ops.agg_a_scale if tier_ops is not None else None
    l1_kw = dict(quant=q.get("l1") or tq.get("l1"), quant_agg=q.get("agg1"),
                 agg_h_scale=tq.get("agg1_h"), tier_aq=taq,
                 tier_a_scale=tas, block_sparse=ops_.block_sparse)
    l2_kw = dict(quant=q.get("l2") or tq.get("l2"), quant_agg=q.get("agg2"),
                 agg_h_scale=tq.get("agg2_h"), tier_aq=taq,
                 tier_a_scale=tas, block_sparse=ops_.block_sparse)
    if fusion == "layer":
        h = layers.gcn_grannite_fused(params["l1"], x, ops_.norm_adj, t,
                                      activation="relu", **l1_kw)
        return layers.gcn_grannite_fused(params["l2"], h, ops_.norm_adj, t,
                                         activation="none", **l2_kw)
    h = torch.relu(layers.gcn_grannite(params["l1"], x, ops_.norm_adj, t,
                                       **l1_kw))
    return layers.gcn_grannite(params["l2"], h, ops_.norm_adj, t, **l2_kw)


# (cfg, capacity, batch, techniques, backend, fusion, shards)
PlanKey = Tuple[GNNConfig, int, int, Techniques, str, str, int]


@dataclasses.dataclass
class ExecutionPlan:
    """One execution recipe: (model config, NodePad bucket, batch width,
    Techniques, aggregation backend, fusion mode).

    Operands, params, the tier calibration `quant` and the tier operands
    are runtime arguments, so every graph of a bucket reuses the plan.
    `trace_count` counts the distinct argument signatures the plan has
    been called with (what a `jax.jit` would have traced): after warmup, a
    steady serving loop adds none. A QuantGr plan is always called with a
    calibration (real or a warmup placeholder of the same shapes) and,
    for GCN, tier operands; a fp32 plan with None for both.
    `grasp_ref_fallback` is True for a grasp plan on the CPU, where the
    aggregation runs the plain version (padded entries multiplied by 0,
    not skipped); GraphServe counts its requests in `backend_fallbacks`.
    `shards` > 0 marks a SHARDED plan (DESIGN.md §12, `build_sharded_
    plan`): `capacity` is then the per-shard row bucket, the leading dims
    of x and the operands are the shard axis (after a replica axis when
    the plan has one), and the plan is called with the node masks —
    another plan per shard count, hence part of the key (0 = unsharded).
    """
    cfg: GNNConfig
    techniques: Techniques
    capacity: int
    batch_size: int = 0                       # 0 = single-graph plan
    backend: str = "dense"
    fusion: str = "none"
    shards: int = 0                           # 0 = unsharded plan
    fn: Callable = dataclasses.field(default=None, repr=False)
    trace_count: int = 0
    grasp_ref_fallback: bool = False
    _seen: Set = dataclasses.field(default_factory=set, repr=False)

    @property
    def key(self) -> PlanKey:
        return (self.cfg, self.capacity, self.batch_size, self.techniques,
                self.backend, self.fusion, self.shards)

    def __call__(self, params: Dict, x: torch.Tensor,
                 ops_: GranniteOperands, quant: Optional[Dict] = None,
                 tier_ops: Optional[TierOperands] = None,
                 node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.shards:
            _count_trace(self, _sig((params, x, ops_, quant, node_mask)))
            return self.fn(params, x, ops_, node_mask, quant)
        _count_trace(self, _sig((params, x, ops_, quant, tier_ops)))
        return self.fn(params, x, ops_, quant, tier_ops)


def build_plan(cfg: GNNConfig, capacity: int, t: Techniques, *,
               batch_size: int = 0, backend: str = "dense",
               fusion: str = "none",
               device: DeviceLike = None) -> ExecutionPlan:
    """Plan for (cfg.kind, capacity, t, backend, fusion) on `device`.

    batch_size > 0 is the batched executor: x is (B, cap, F) and the
    operands and tier operands carry the same leading B (see
    `stack_operands`, `stack_tier_operands`); params and the model-level
    calibration are shared across the batch. The plan checks that its
    arguments lie on its device.

    `backend="grasp"` executes the aggregation through the block-sparse
    path: the tier's Techniques identity (the plan key) is unchanged, the
    executed Techniques gain `grasp=True`.
    """
    if backend not in AGG_BACKENDS:
        raise ValueError(f"unknown aggregation backend {backend!r}; pick "
                         f"from {AGG_BACKENDS}")
    if fusion not in FUSION_MODES:
        raise ValueError(f"unknown fusion mode {fusion!r}; pick from "
                         f"{FUSION_MODES}")
    _check_kind(cfg)
    dev = resolve_device(device)
    exec_t = dataclasses.replace(t, grasp=True) if backend == "grasp" else t
    plan = ExecutionPlan(cfg=cfg, techniques=t, capacity=capacity,
                         batch_size=batch_size, backend=backend,
                         fusion=fusion,
                         grasp_ref_fallback=(backend == "grasp" and
                                             kops.bitmap_spmm_mode(dev)
                                             == "ref"))

    def _forward(params, x, ops_, quant, tier_ops):
        for name, v in [("x", x)] + [(f, getattr(ops_, f))
                                     for f in OPERAND_FIELDS[cfg.kind]]:
            if v.device != dev:
                raise ValueError(f"plan on {dev} called with {name} on "
                                 f"{v.device}")
        return forward_grannite(params, cfg, x, ops_, exec_t, quant=quant,
                                tier_ops=tier_ops, fusion=fusion)

    plan.fn = _forward
    return plan


# ---------------------------------------------------------------------------
# Sharded execution (DESIGN.md §12) — GraphSplit across N shards.
#
# A graph too large for the ladder's top bucket is row-partitioned
# (core.partition.partition_graph): shard s owns slot rows
# [s*shard_cap, (s+1)*shard_cap) of a permuted full-capacity layout. Each
# layer runs as: project OWN rows -> halo-exchange the projected rows into
# the full row space -> aggregate OWN rows against the FULL space through
# a rectangular (shard_cap, full_rows) operand row block. Row blocks keep
# complete Â rows, so per-row quantization scales, and hence the int8
# tiers, match the single-device path; the only sharding-induced error is
# the wire compression (<= scale/2 per element, none when `compress` is
# off). On one card the shard axis is a leading tensor dimension, as the
# reference simulates it with `vmap` below its device count; the
# multi-card placement is ROADMAP queue 1 item 16.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardSlice:
    """One shard's device operand slice: the CacheG unit of a sharded
    graph, cached per (graph_id, structure_version) as a tuple and
    stacked along a leading shard axis at dispatch (`stack_shard_slices`).
    """
    x: torch.Tensor              # (shard_cap, F) this shard's feature rows
    ops: GranniteOperands        # kind fields (shard_cap, full_rows)
    node_mask: torch.Tensor      # (shard_cap,) 1.0 real / 0.0 padding


def build_sharded_operands(g, part, cfg: GNNConfig, *,
                           pg: Optional[PaddedGraph] = None,
                           keys: Optional[np.ndarray] = None,
                           device: DeviceLike = None
                           ) -> Tuple[ShardSlice, ...]:
    """N-way GraphSplit's operand row blocks, on `device`.

    Builds the graph's full-capacity operands once, exactly as the
    unsharded path does (`pg`, the graph padded to `part.full_rows`, is
    made here unless given): CacheG's compact form materialized on the
    device (`materialize_operands`, its triangle index made for this call
    and not kept, and no trace counted: like the reference's host build,
    this is not a plan), or the eager host build for a directed GCN/GAT
    graph. Then rows AND columns are
    permuted into the slot layout on the device (two gathers, exact) and
    each shard's row block is a view of the permuted field. So the blocks
    hold the Â the port's delta patch reproduces (`inv_sqrt_degree`), and
    a patched slice equals a rebuild bit for bit. Padding is interleaved
    per shard; padded rows and columns are zero, hence inert. `keys`
    (`graph.adjacency_keys` at full_rows) let the compact path read the
    edge list."""
    _check_kind(cfg)
    dev = resolve_device(device)
    full, c = part.full_rows, part.shard_cap
    if pg is None:
        pg = pad_graph(g, capacity=full)
    if pg.capacity != full:
        raise ValueError(f"padded graph of capacity {pg.capacity} for a "
                         f"partition of {full} rows")
    if keys is None and cfg.kind != "sage":
        keys = adjacency_keys(g.edge_index, full)
    ho = prepare_host_operands(pg, cfg, keys=keys, device=dev)
    ops = (materialize_operands(ho.compact.to(dev))
           if ho.compact is not None else ho.eager)
    perm = torch.from_numpy(np.asarray(part.perm, np.int64)).to(dev)
    mats = {f: getattr(ops, f).index_select(0, perm).index_select(1, perm)
            for f in OPERAND_FIELDS[cfg.kind]}
    del ops
    feats = torch.from_numpy(pg.features[part.perm]).to(dev)
    mask = torch.from_numpy((part.perm < pg.num_nodes).astype(
        np.float32)).to(dev)
    return tuple(
        ShardSlice(x=feats[s * c:(s + 1) * c],
                   ops=GranniteOperands(**{f: m[s * c:(s + 1) * c]
                                           for f, m in mats.items()}),
                   node_mask=mask[s * c:(s + 1) * c])
        for s in range(part.shards))


def _stack_blocks(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack equal-shape tensors along a new leading dim: a view when they
    are consecutive contiguous blocks of one buffer (the row blocks of
    `build_sharded_operands`), else a copy."""
    t0 = ts[0]
    step = t0.numel()
    ptr = t0.untyped_storage().data_ptr()
    if all(t.is_contiguous() and t.untyped_storage().data_ptr() == ptr
           and t.storage_offset() == t0.storage_offset() + i * step
           for i, t in enumerate(ts)):
        return t0.as_strided((len(ts), *t0.shape), (step, *t0.stride()),
                             t0.storage_offset())
    return torch.stack(list(ts))


def stack_shard_slices(slices: Sequence[ShardSlice]
                       ) -> Tuple[torch.Tensor, GranniteOperands,
                                  torch.Tensor]:
    """Per-shard slices -> (x, ops, node_mask) with a leading shard axis,
    the sharded plan's calling convention. The slices of one
    `build_sharded_operands` call stack without a copy."""
    fields = [f for f in DENSE_FIELDS if getattr(slices[0].ops, f)
              is not None]
    return (_stack_blocks([s.x for s in slices]),
            GranniteOperands(**{f: _stack_blocks([getattr(s.ops, f)
                                                  for s in slices])
                                for f in fields}),
            _stack_blocks([s.node_mask for s in slices]))


def unshard_logits(stacked, part) -> np.ndarray:
    """(shards, shard_cap, classes) slot-ordered logits -> (num_nodes,
    classes) in the original node order (the inverse of `part.perm`), on
    the host."""
    if isinstance(stacked, torch.Tensor):
        stacked = stacked.cpu().numpy()
    flat = np.asarray(stacked).reshape(part.full_rows, -1)
    out = np.empty_like(flat)
    out[part.perm] = flat
    return out[: part.num_nodes]


def halo_exchange(h_own: torch.Tensor, node_mask: torch.Tensor, *,
                  compress: bool = True) -> torch.Tensor:
    """The full (full_rows, width) matrix from the shards' row blocks.

    h_own: (R, S, shard_cap, width), node_mask: (R, S, shard_cap) ->
    (R, S * shard_cap, width), one matrix per replica that all of its
    shards read. The reference writes each shard's masked rows into its
    slot range of a zeroed full-height buffer and sums the S buffers over
    the shard axis, through the int8 wire (`dist.compress.
    compressed_psum`) with `compress`. The blocks are disjoint and zeros
    quantize exactly, so that sum IS the masked rows laid end to end: the
    assembly here, one reshape, equals the reference's summed buffers bit
    for bit. With `compress` it is quantized against one scale per
    replica (its absmax / 127, the pmax of the shards') and dequantized:
    each element within scale/2 of the exact exchange. Without, the masked
    rows exactly. Padded rows are zeroed first, so softmax garbage in pad
    rows (GAT) never inflates the shared scale.
    """
    r, s, c, w = h_own.shape
    buf = (h_own * node_mask[..., None]).reshape(r, s * c, w)
    if compress:
        scale = torch.clamp_min(buf.abs().amax(dim=(1, 2), keepdim=True),
                                1e-12) * INV_INT8_MAX
        return quantize_wire(buf, scale) * scale
    # + 0.0: the reference's sum of a -0.0 with the other shards' zeros
    return buf + 0.0


def _head_scores(h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """GAT's per-node score term sum_f h[..., n, h, f] * a[h, f], summed in
    f order by elementwise ops, so a replica row gets the same bits
    whatever the number of rows beside it (`torch.einsum` picks its
    reduction by the whole shape)."""
    acc = h[..., 0] * a[:, 0]
    for k in range(1, h.shape[-1]):
        acc = acc + h[..., k] * a[:, k]
    return acc


def sharded_layer(params: Dict, cfg: GNNConfig, v_own: torch.Tensor,
                  ops_: GranniteOperands, node_mask: torch.Tensor,
                  t: Techniques, quant: Optional[Dict] = None, *,
                  layer: int, compress: bool = True) -> torch.Tensor:
    """Layer `layer` (1 or 2) of the sharded forward, before its
    activation: v_own (R, S, shard_cap, F) -> (R, S, shard_cap, w).
    `params` and `quant` are the model's (the layer picks its own);
    see `forward_grannite_sharded`."""
    r, s, c = node_mask.shape
    full = s * c
    tq = (quant or {}) if t.quantgr else {}
    p = params[f"l{layer}"]
    uk = t.use_pallas

    def per_shard(v):                  # (R, ...) -> (R*S, ...), each shard
        return v[:, None].expand(r, s, *v.shape[1:]).reshape(
            r * s, *v.shape[1:])

    def exchange(h_own):               # (R*S, C, w) -> (R, full, w)
        return halo_exchange(h_own.reshape(r, s, c, -1), node_mask,
                             compress=compress)

    def mm(a, b):
        return kops.matmul(a, b) if uk else a @ b

    def lin(v, w, ql):
        if ql is not None:
            return apply_quantized_linear(v, ql, use_kernel=uk)
        return mm(v, w)

    v_own = v_own.reshape(r * s, c, -1)
    fields = {f: getattr(ops_, f).reshape(r * s, c, full)
              for f in OPERAND_FIELDS[cfg.kind]}
    if cfg.kind == "gcn":
        h_full = per_shard(exchange(lin(v_own, p["w"], tq.get(f"l{layer}"))))
        h_scale = tq.get(f"agg{layer}_h")
        if h_scale is not None:
            aq, a_scale = quantize_rowwise(fields["norm_adj"])
            agg = apply_quantized_agg(
                QuantizedAgg(aq=aq, a_scale=a_scale, h_scale=h_scale),
                h_full, use_kernel=uk)
        else:
            agg = mm(fields["norm_adj"], h_full)
        out = agg + p["b"]
    elif cfg.kind == "gat":
        heads, f_out = ((cfg.heads, cfg.hidden // cfg.heads) if layer == 1
                        else (1, cfg.num_classes))
        h_own = lin(v_own, p["w"], tq.get(f"l{layer}"))
        h_full = exchange(h_own).reshape(r, full, heads, f_out)
        h_mine = h_own.reshape(r * s, c, heads, f_out)
        a_src = per_shard(_head_scores(h_full, p["a_src"]))  # (., full, H)
        a_dst = _head_scores(h_mine, p["a_dst"])             # (R*S, C, H)
        h_full = per_shard(h_full)
        outs = []
        for hd in range(heads):
            e = effop.broadcast_add_scores(a_src[..., hd], a_dst[..., hd],
                                           grax2=t.grax2)   # (R*S, C, full)
            e = torch.nn.functional.leaky_relu(e, 0.2)
            if t.grax1:
                attn = effop.segment_softmax_dense(e, fields["bias_add"])
            else:
                e = effop.masked_select_exact(e, fields["mask_mult"])
                attn = torch.softmax(e, dim=-1)
            outs.append(mm(attn, h_full[..., hd, :].contiguous()))
        out = torch.stack(outs, dim=-2).reshape(r * s, c, heads * f_out)
        out = out + p["b"]
    elif cfg.kind == "sage":
        q = tq.get(f"l{layer}") or {}
        v_full = exchange(v_own)
        if cfg.aggregator == "mean":
            agg = mm(fields["mean_mask"], per_shard(v_full))
        else:
            pooled = per_shard(torch.relu(
                lin(v_full, p["w_pool"], q.get("pool")) + p["b_pool"]))
            if uk and t.grax3:
                agg = kops.sage_max(fields["sample_mask"], pooled)
            else:
                agg = effop.masked_max_aggregate(
                    pooled, fields["sample_mask"], grax3=t.grax3)
        out = (lin(v_own, p["w_self"], q.get("self"))
               + lin(agg, p["w_neigh"], q.get("neigh")) + p["b"])
    else:
        raise ValueError(cfg.kind)
    return out.reshape(r, s, c, -1)


def forward_grannite_sharded(params: Dict, cfg: GNNConfig, x: torch.Tensor,
                             ops_: GranniteOperands, node_mask: torch.Tensor,
                             t: Techniques, quant: Optional[Dict] = None, *,
                             compress: bool = True) -> torch.Tensor:
    """The shards' sharded GraNNite forward (DESIGN.md §12), all at once.

    x: (R, S, shard_cap, F) feature rows; `ops_` fields (R, S, shard_cap,
    full_rows) rectangular operand row blocks; node_mask (R, S,
    shard_cap). Returns (R, S, shard_cap, classes) logits in slot order:
    `sharded_layer` 1, its activation (GCN and SAGE ReLU, GAT ELU), then
    `sharded_layer` 2. Exchange schedule per kind, as the reference's: GCN
    exchanges the projected hidden rows (widths hidden then classes); GAT
    the per-head projections; SAGE the aggregation INPUTS (raw features
    then layer-1 activations). QuantGr GCN derives the int8 Â from the row
    block in the forward: complete rows quantize to the single-device
    scales.

    With `t.use_pallas` every product runs through a kernel entry, the
    (R, S) dims flattened into its one batch dim: fp32 products through
    `kops.matmul` (`block_matmul`: X·W and the rectangular (shard_cap,
    full_rows) @ (full_rows, w) aggregations, GAT's attention product
    included), the QuantGr combines and the int8 aggregation through
    `kops.int8_matmul`, GrAx3's masked max through the rectangular
    `kops.sage_max`. Without it they are plain PyTorch, as in
    `core.layers`. Each replica exchanges within itself: no term crosses
    replicas. What every shard computes from the exchanged matrix alone
    (GAT's source scores, SAGE-max's pool combine) is computed once per
    replica and read by its shards: the reference computes the same
    values in every shard.
    """
    act = torch.nn.functional.elu if cfg.kind == "gat" else torch.relu
    kw = dict(t=t, quant=quant, compress=compress)
    h = act(sharded_layer(params, cfg, x, ops_, node_mask, layer=1, **kw))
    return sharded_layer(params, cfg, h, ops_, node_mask, layer=2, **kw)


def build_sharded_plan(cfg: GNNConfig, shard_cap: int, shards: int,
                       t: Techniques, *, compress: bool = True,
                       replicas: int = 1,
                       device: DeviceLike = None) -> ExecutionPlan:
    """Sharded ExecutionPlan on `device`: every shard's aggregate and
    combine, the halo exchange between layers (DESIGN.md §12).

    One card holds every shard: the shard axis is the leading dim of x,
    the operands and the node masks, as the reference simulates it below
    its device count. Sharded plans are dense, fusion="none" and
    single-graph (the shard axis takes the dim a batched plan would use);
    call with `plan(params, x, ops, quant, node_mask=mask)`.

    `replicas=R > 1` adds a replica axis ahead of the shard axis
    (DESIGN.md §15): the plan runs R independent sharded requests in one
    call, each exchanging within itself, so every replica row equals its
    single-replica dispatch bit for bit. `replicas=1` takes no replica
    dim.
    """
    _check_kind(cfg)
    dev = resolve_device(device)
    plan = ExecutionPlan(cfg=cfg, techniques=t, capacity=shard_cap,
                         batch_size=0, backend="dense", fusion="none",
                         shards=shards)
    fields = OPERAND_FIELDS[cfg.kind]

    def _forward(params, x, ops_, node_mask, quant):
        for name, v in [("x", x), ("node_mask", node_mask)] + [
                (f, getattr(ops_, f)) for f in fields]:
            if v.device != dev:
                raise ValueError(f"plan on {dev} called with {name} on "
                                 f"{v.device}")
        if replicas == 1:
            x, node_mask = x[None], node_mask[None]
            ops_ = GranniteOperands(**{f: getattr(ops_, f)[None]
                                       for f in fields})
        out = forward_grannite_sharded(params, cfg, x, ops_, node_mask, t,
                                       quant, compress=compress)
        return out[0] if replicas == 1 else out

    plan.fn = _forward
    return plan


def sharded_exchange_widths(cfg: GNNConfig) -> Tuple[int, ...]:
    """Per-layer halo widths `forward_grannite_sharded` exchanges: GCN the
    projected hidden rows then the class rows; GAT the concatenated
    per-head layer-1 projections then the single-head class rows; SAGE
    the aggregation INPUTS (raw features, then the layer-1 activations).
    The engine's collective byte counters and the modelled latency both
    read it."""
    if cfg.kind == "gcn":
        return (cfg.hidden, cfg.num_classes)
    if cfg.kind == "gat":
        return (cfg.heads * (cfg.hidden // cfg.heads), cfg.num_classes)
    return (cfg.in_feats, cfg.hidden)


# ---------------------------------------------------------------------------
# Training and evaluation (the paper's accuracy table)
# ---------------------------------------------------------------------------

def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows `mask` selects; a label of -1
    (padding) under a False mask reads class 0 and counts 0."""
    logp = torch.log_softmax(logits, dim=-1)
    safe = torch.clamp_min(labels, 0).long()
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / torch.clamp_min(m.sum(), 1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy over the rows `mask` selects, a float32 scalar."""
    ok = (logits.argmax(dim=-1) == labels) & mask
    return ok.sum() / torch.clamp_min(mask.sum(), 1)


def _leaf_name(path) -> str:
    """A dotted name ("l1.w") for a `tree_flatten_with_path` key path."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _graph_tensors(pg: PaddedGraph, dev: torch.device):
    return (torch.from_numpy(pg.features).to(dev),
            torch.from_numpy(np.asarray(pg.labels)).long().to(dev))


def train_node_classifier(gen: torch.Generator, cfg: GNNConfig,
                          pg: PaddedGraph,
                          forward: Callable[[Dict, torch.Tensor],
                                            torch.Tensor],
                          params: Optional[Dict] = None, *, lr: float = 0.01,
                          weight_decay: float = 5e-4, epochs: int = 100,
                          device: DeviceLike = None,
                          history: Optional[list] = None) -> Dict:
    """Full-batch AdamW training on `pg`'s train mask (the paper: lr 0.01,
    weight decay 5e-4, 100 epochs); returns the trained parameters,
    detached, on `device`.

    Eager: each epoch runs `forward(params, x)`, takes the gradients of
    the masked cross-entropy with `torch.autograd.grad` over every
    parameter leaf and updates them under `no_grad` (`optim.adamw`). The
    kernels have no backward, so a forward that reaches a kernel entry
    with an operand that requires grad (`use_pallas`, fusion="layer")
    would give every parameter upstream of that operand part of its
    gradient or none: such a forward raises, naming every parameter whose
    gradient is cut or missing, and nothing trains on part of a gradient.
    `params` defaults to `init_params(gen, cfg)`; `history`, when given,
    gets each epoch's loss appended as a 0-d tensor on the device.
    """
    from torch.utils import _pytree as pytree

    from repro_torch.optim.adamw import adamw_init, adamw_update

    dev = resolve_device(device)
    x, y = _graph_tensors(pg, dev)
    tm = torch.from_numpy(np.asarray(pg.train_mask)).to(dev)
    if params is None:
        params = init_params(gen, cfg, device=dev)
    flat, spec = pytree.tree_flatten_with_path(params)
    names = [_leaf_name(path) for path, _ in flat]
    leaves = [t.detach().clone().requires_grad_(True) for _, t in flat]
    opt = adamw_init(leaves)
    for epoch in range(epochs):
        with kops.record_grad_cuts() as cuts:
            loss = masked_cross_entropy(
                forward(pytree.tree_unflatten(leaves, spec), x), y, tm)
        cut = [False] * len(leaves)
        if cuts:
            operands = [t for _, t in cuts]
            cut = [g is not None for g in torch.autograd.grad(
                operands, leaves, [torch.ones_like(t) for t in operands],
                retain_graph=True, allow_unused=True)]
        grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
                 if loss.requires_grad else [None] * len(leaves))
        missing = [n for n, g, c in zip(names, grads, cut) if g is None or c]
        if missing:
            how = (f"the kernel entries {sorted({e for e, _ in cuts})} "
                   "have no backward and were given operands that depend on "
                   "them" if cuts else "the forward has no path back to "
                   "them")
            raise RuntimeError(
                f"train_node_classifier: epoch {epoch}: no full gradient "
                f"reached {', '.join(missing)}; {how}. Train on the plain "
                "forward and evaluate through the kernels")
        with torch.no_grad():
            leaves, opt = adamw_update(leaves, list(grads), opt, lr=lr,
                                       weight_decay=weight_decay)
        leaves = [t.requires_grad_(True) for t in leaves]
        if history is not None:
            history.append(loss.detach())
    return pytree.tree_unflatten([t.detach() for t in leaves], spec)


def evaluate(cfg: GNNConfig, params: Dict, pg: PaddedGraph,
             forward: Callable[[Dict, torch.Tensor], torch.Tensor], *,
             device: DeviceLike = None) -> float:
    """Top-1 accuracy of `forward(params, x)` on `pg`'s test mask."""
    dev = resolve_device(device)
    x, y = _graph_tensors(pg, dev)
    with torch.no_grad():
        logits = forward(params, x)
    return float(accuracy(logits, y,
                          torch.from_numpy(np.asarray(pg.test_mask)).to(dev)))
