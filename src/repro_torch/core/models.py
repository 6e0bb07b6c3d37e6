"""The paper's 2-layer GCN on the GraNNite dense path, and execution plans.

Port of the GCN part of the reference's `core/models.py`. Operands are
torch tensors on an explicit device; the reference's `vmap` over graphs is
an explicit leading batch dimension B.

Plan identity keeps the zero-recompile contract without a compiler: an
`ExecutionPlan` records the shape/dtype/device signature of every call,
and counts one "trace" for each signature it has not seen — exactly the
calls that would retrace a `jax.jit` in the reference. `GraphServe` sums
these counts into `compiled_blobs`, so `assert_warm()` still says whether
serving stayed on the shapes warmup saw.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

from . import layers
from .graph import PaddedGraph
from .layers import Techniques


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    kind: str                  # "gcn" | "gat" | "sage" (gcn in this port)
    in_feats: int
    hidden: int = 64
    num_classes: int = 7
    heads: int = 8             # GAT only (hidden per-head = hidden // heads)
    aggregator: str = "mean"   # SAGE only: "mean" | "max"
    max_neighbors: int = 10    # SAGE sampling cap (paper: 10)


def _gcn_only(cfg: GNNConfig) -> None:
    if cfg.kind != "gcn":
        raise NotImplementedError(
            f"model kind {cfg.kind!r} is not ported yet (ROADMAP queue 1 "
            "item 7); this port serves GCN")


def init_params(gen: torch.Generator, cfg: GNNConfig, *,
                device: DeviceLike = None) -> Dict:
    """GCN parameters from a seeded `torch.Generator` (the port's own init;
    parity tests bring the reference's weights through `bridge`)."""
    _gcn_only(cfg)
    device = resolve_device(device)
    return {"l1": layers.gcn_init(gen, cfg.in_feats, cfg.hidden,
                                  device=device),
            "l2": layers.gcn_init(gen, cfg.hidden, cfg.num_classes,
                                  device=device)}


@dataclasses.dataclass
class GranniteOperands:
    """Host-precomputed (GraphSplit/PreG/StaGr) dense operands on a device.

    Only GCN's `norm_adj` exists in this port; the other fields stay None
    until GAT/SAGE (masks), GraSp (`block_sparse`) and QuantGr (`quant`)
    are ported.
    """
    norm_adj: torch.Tensor                # (B?, cap, cap) PreG-normalized
    mask_mult: Optional[torch.Tensor] = None
    bias_add: Optional[torch.Tensor] = None
    sample_mask: Optional[torch.Tensor] = None
    mean_mask: Optional[torch.Tensor] = None
    block_sparse: Optional[object] = None
    quant: Optional[Dict] = None


# Which operand fields each model kind actually reads.
OPERAND_FIELDS = {
    "gcn": ("norm_adj",),
    "gat": ("mask_mult", "bias_add"),
    "sage": ("sample_mask", "mean_mask"),
}


def build_operands(pg: PaddedGraph, cfg: GNNConfig, *, lean: bool = True,
                   device: DeviceLike = None) -> GranniteOperands:
    """Host side of GraphSplit for one padded graph: Â uploaded to `device`.

    Only the lean build (the fields `cfg.kind` reads) exists in the port.
    """
    _gcn_only(cfg)
    if not lean:
        raise NotImplementedError(
            "the full operand build (GAT/SAGE masks) is not ported yet "
            "(ROADMAP queue 1 item 7)")
    return GranniteOperands(
        norm_adj=torch.from_numpy(pg.norm_adj).to(resolve_device(device)))


def stack_operands(ops: Sequence[GranniteOperands]) -> GranniteOperands:
    """Stack per-graph operands into one batched (B, ...) set on their
    device."""
    if not ops:
        raise ValueError("cannot stack an empty operand batch")
    return GranniteOperands(norm_adj=torch.stack([o.norm_adj for o in ops]))


# Fusion modes (DESIGN.md §11): how a plan executes each LAYER.
#   none  — aggregate and combine as separate matmuls (+ host-side act).
#   layer — one fused kernel call per layer (aggregate + combine + bias +
#           act). Same math, another execution schedule.
FUSION_MODES = ("none", "layer")

# Aggregation backends (DESIGN.md §10); only "dense" is ported.
AGG_BACKENDS = ("dense", "grasp")


def forward_grannite(params: Dict, cfg: GNNConfig, x: torch.Tensor,
                     ops_: GranniteOperands, t: Techniques,
                     fusion: str = "none") -> torch.Tensor:
    """One dense GraNNite GCN forward over x (B?, cap, F) -> (B?, cap, C).
    `fusion="layer"` runs each layer through `fused_gcn_dense` with the
    inter-layer ReLU folded into its epilogue."""
    if fusion not in FUSION_MODES:
        raise ValueError(f"unknown fusion mode {fusion!r}; pick from "
                         f"{FUSION_MODES}")
    _gcn_only(cfg)
    if fusion == "layer":
        h = layers.gcn_grannite_fused(params["l1"], x, ops_.norm_adj, t,
                                      activation="relu")
        return layers.gcn_grannite_fused(params["l2"], h, ops_.norm_adj, t,
                                         activation="none")
    h = torch.relu(layers.gcn_grannite(params["l1"], x, ops_.norm_adj, t))
    return layers.gcn_grannite(params["l2"], h, ops_.norm_adj, t)


# (cfg, capacity, batch, techniques, backend, fusion, shards)
PlanKey = Tuple[GNNConfig, int, int, Techniques, str, str, int]


def _signature(params: Dict, x: torch.Tensor, ops_: GranniteOperands):
    leaves = [params[layer][k] for layer in sorted(params)
              for k in sorted(params[layer])]
    return tuple((tuple(v.shape), v.dtype, v.device)
                 for v in (*leaves, x, ops_.norm_adj))


@dataclasses.dataclass
class ExecutionPlan:
    """One execution recipe: (model config, NodePad bucket, batch width,
    Techniques, aggregation backend, fusion mode).

    Operands and params are runtime arguments, so every graph of a bucket
    reuses the plan. `trace_count` counts the distinct argument signatures
    the plan has been called with (what a `jax.jit` would have traced):
    after warmup, a steady serving loop adds none.
    """
    cfg: GNNConfig
    techniques: Techniques
    capacity: int
    batch_size: int = 0                       # 0 = single-graph plan
    backend: str = "dense"
    fusion: str = "none"
    shards: int = 0                           # sharding is not ported
    fn: Callable = dataclasses.field(default=None, repr=False)
    trace_count: int = 0
    _seen: Set = dataclasses.field(default_factory=set, repr=False)

    @property
    def key(self) -> PlanKey:
        return (self.cfg, self.capacity, self.batch_size, self.techniques,
                self.backend, self.fusion, self.shards)

    def __call__(self, params: Dict, x: torch.Tensor,
                 ops_: GranniteOperands) -> torch.Tensor:
        sig = _signature(params, x, ops_)
        if sig not in self._seen:
            self._seen.add(sig)
            self.trace_count += 1
        return self.fn(params, x, ops_)


def build_plan(cfg: GNNConfig, capacity: int, t: Techniques, *,
               batch_size: int = 0, backend: str = "dense",
               fusion: str = "none",
               device: DeviceLike = None) -> ExecutionPlan:
    """Plan for (cfg.kind, capacity, t, backend, fusion) on `device`.

    batch_size > 0 is the batched executor: x is (B, cap, F) and the
    operands carry the same leading B (see `stack_operands`); params are
    shared. The plan checks that its arguments lie on its device.
    """
    if backend not in AGG_BACKENDS:
        raise ValueError(f"unknown aggregation backend {backend!r}; pick "
                         f"from {AGG_BACKENDS}")
    if backend != "dense":
        raise NotImplementedError(
            "the GraSp aggregation backend is not ported yet (ROADMAP "
            "queue 1 item 6)")
    if fusion not in FUSION_MODES:
        raise ValueError(f"unknown fusion mode {fusion!r}; pick from "
                         f"{FUSION_MODES}")
    _gcn_only(cfg)
    dev = resolve_device(device)
    plan = ExecutionPlan(cfg=cfg, techniques=t, capacity=capacity,
                         batch_size=batch_size, backend=backend,
                         fusion=fusion)

    def _forward(params, x, ops_):
        if x.device != dev or ops_.norm_adj.device != dev:
            raise ValueError(f"plan on {dev} called with x on {x.device} "
                             f"and norm_adj on {ops_.norm_adj.device}")
        return forward_grannite(params, cfg, x, ops_, t, fusion=fusion)

    plan.fn = _forward
    return plan
