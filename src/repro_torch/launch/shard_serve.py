"""Sharded GNN serving on a mesh of processes: the per-rank entry point.

One process per (replica, shard) cell of `launch.mesh.make_shard_mesh`,
each running `GraphServe(mesh=)` on the same calls (DESIGN.md §12, §15):

  PYTHONPATH=src python -m repro_torch.launch.shard_serve --rank R \\
      --world-size N --init-method file:///tmp/mesh/store \\
      --backend gloo --device cpu --shards N --kind gcn \\
      --nodes 200 --feats 12 --hidden 16 --classes 4 --ladder 128

started once for each rank R (or all together with `spawn_local`). Each
rank serves a seeded burst (`run_burst`: the graph above the top bucket
attached to every model of `--kind`, fp32 and int8 queries, with
`--delta` a cross-shard `update_delta`, with `--grow` an `update()` into
the sharded path and back), once with the halo's int8 wire off and once
on (`--wire`), and prints one JSON line: the answers' digests, the
summary's counters, the kernels' launches, its cache residency, and per
model one dispatch's CUDA-event ms with the all_reduce time apart from
the rest and the bytes handed to all_reduce (times only on a card; on the
CPU they read null, not measured). `--collectives` runs only the group
forms of `dist.compress` and the halo exchange against their stacked
forms (`collective_check`), the check of an NCCL world of one card.

The graph, the weights (made in numpy from `--seed`, replicated on every
rank as the reference's `P()` replicates them) and the calibration are
the same on every rank. `--device` is the rank's device (`cuda:0` for
every rank of a one-card machine, with gloo); none means `cuda:{rank}`.
`--backend` defaults to NCCL on a card and gloo on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.core import models as gmodels
from repro_torch.core.graph import BucketLadder
from repro_torch.core.models import GNNConfig
from repro_torch.core.partition import modelled_sharded_latency
from repro_torch.data.graphs import clustered_like
from repro_torch.dist import compress
from repro_torch.dist.compress import timed_all_reduces
from repro_torch.dist.sharding import assemble, local_block
from repro_torch.kernels import block_matmul, int8_matmul, sage_max
from repro_torch.launch.mesh import init_distributed, make_shard_mesh
from repro_torch.runtime.gnn_server import (GraphServe, GraphServeConfig,
                                            tier_techniques)

# model names of --kind -> (GNNConfig kind, its extra fields)
KINDS = {"gcn": ("gcn", {}), "gat": ("gat", {}),
         "sage-max": ("sage", {"aggregator": "max"}),
         "sage-mean": ("sage", {"aggregator": "mean"})}
# the kernels a rank's products run through under `use_pallas`
KERNELS = {"block_matmul": block_matmul, "int8_matmul": int8_matmul,
           "sage_max": sage_max}
# the summary counters a rank reports (the lead's equal a single-process
# engine's on the same calls, cache_resident_bytes apart)
COUNTERS = ("requests", "batches", "sharded_batches", "batch_occupancy",
            "halo_bytes_exchanged", "collective_bytes_compressed",
            "collective_bytes_exact", "operand_cache_hits",
            "operand_cache_misses", "rebucket_events", "delta_updates",
            "delta_fallbacks", "delta_halo_bytes_exchanged",
            "delta_halo_bytes_full", "delta_dirty_rows", "shard_counts",
            "compiled_blobs")
TIERS = ("fp32", "int8")
TIME_ITERS = 5                    # plan calls a dispatch's time averages
TIMEOUT_S = 300.0                 # a collective's longest wait


@dataclasses.dataclass(frozen=True)
class BurstSpec:
    """What a rank serves; equal on every rank."""
    kinds: Tuple[str, ...] = ("gcn",)
    nodes: int = 10000            # the sharded graph
    feats: int = 1433
    hidden: int = 64
    heads: int = 8
    classes: int = 7
    ladder: Tuple[int, ...] = (1024, 3072)
    shards: int = 2
    replicas: int = 1
    cal_nodes: int = 2708         # the calibration graph
    delta: bool = False           # a cross-shard update_delta (GCN, GAT)
    grow: Tuple[int, ...] = ()    # (small, mid): update() there and back
    slots: int = 4
    seed: int = 0


def model_config(kind: str, spec: BurstSpec) -> GNNConfig:
    base, kw = KINDS[kind]
    return GNNConfig(kind=base, in_feats=spec.feats, hidden=spec.hidden,
                     num_classes=spec.classes, heads=spec.heads, **kw)


def model_weights(cfg: GNNConfig, seed: int) -> Dict:
    """The model's weights as numpy arrays, made on the host from `seed`:
    the same on every rank and every run."""
    return params_to_numpy(gmodels.init_params(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))


def serving_tiers(kind: str):
    """fp32 and int8 tiers with `use_pallas` (SAGE with GrAx3), so every
    product of a rank runs through `block_matmul`, `int8_matmul` or the
    rectangular `sage_max`."""
    std = tier_techniques(kind)
    out = {}
    for tn in ("fp32", "int8"):
        t = dataclasses.replace(std[tn], use_pallas=True)
        if kind == "sage":
            t = dataclasses.replace(t, grax3=True)
        out[tn] = t
    return out


def make_graph(n: int, spec: BurstSpec):
    """The seeded community graph of n nodes (`clustered_like`, seed n)."""
    return clustered_like(num_nodes=n, num_feats=spec.feats,
                          num_classes=spec.classes, within_density=0.05,
                          cross_frac=0.1, seed=n)


def build_engine(spec: BurstSpec, *, compress_halo: bool, device=None,
                 mesh=None) -> GraphServe:
    """A warm engine with every model of the spec registered and
    calibrated; `mesh` None is the single-process engine."""
    sc = GraphServeConfig(ladder=BucketLadder(buckets=spec.ladder),
                          batch_slots=spec.slots, return_logits=True,
                          shard_counts=(spec.shards,),
                          halo_compress=compress_halo,
                          replica_groups=spec.replicas)
    eng = GraphServe(sc, seed=spec.seed, device=device, mesh=mesh)
    cal = make_graph(spec.cal_nodes, spec)
    for kind in spec.kinds:
        cfg = model_config(kind, spec)
        eng.register_model(kind, cfg, params_from_jax(
            model_weights(cfg, spec.seed), device=eng.device),
            tiers=serving_tiers(cfg.kind))
        eng.calibrate(kind, cal)
    eng.warmup()
    return eng


def digest(a: np.ndarray) -> str:
    """A logits array's digest; -0.0 counts as 0.0 (an assembly sums a
    -0.0 with zeros)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32) + np.float32(0.0))
    return hashlib.sha1(a.tobytes()).hexdigest()[:16]


def _serve(eng: GraphServe, labels: Dict[str, int], answers: Dict,
           log: List) -> None:
    """run(), then each label's logits (where this rank answers it) and
    the sharded batches this run dispatched, per (model, tier)."""
    before = len(eng.finished)
    eng.run()
    done = eng.finished[before:]
    by_uid = {r.uid: r for r in done}
    for label, uid in labels.items():
        if uid in by_uid:
            answers[label] = by_uid[uid].logits
    per_key: Dict[Tuple[str, str], int] = {}
    for r in done:
        if r.shards:
            per_key[(r.model, r.tier)] = per_key.get((r.model, r.tier),
                                                     0) + 1
    for (model, tier), n in sorted(per_key.items()):
        log.extend([[model, tier]] * -(-n // eng.sc.replica_groups))


def _cross_delta(g, part, seed: int):
    """A seeded edge delta across the shards: 2 edges removed, 4 added."""
    a, n = part.assignment, g.num_nodes
    src, dst = g.edge_index
    keys = set((src.astype(np.int64) * n + dst).tolist())
    cross = np.flatnonzero((src < dst) & (a[src] != a[dst]))
    rng = np.random.default_rng(seed)
    rm = [(int(src[k]), int(dst[k]))
          for k in rng.choice(cross, 2, replace=False)]
    add = []
    while len(add) < 4:
        u, v = (int(z) for z in rng.integers(0, n, 2))
        if a[u] != a[v] and u * n + v not in keys and (
                min(u, v), max(u, v)) not in add:
            add.append((min(u, v), max(u, v)))
    return add, rm


def _same_slices(got, want) -> bool:
    return all(torch.equal(a.x, b.x) and torch.equal(a.node_mask,
                                                     b.node_mask)
               and all(torch.equal(getattr(a.ops, f), getattr(b.ops, f))
                       for f in gmodels.DENSE_FIELDS
                       if getattr(b.ops, f) is not None)
               for a, b in zip(got, want, strict=True))


def run_burst(eng: GraphServe, spec: BurstSpec):
    """The burst every rank (and the single-process reference) serves:
    returns ({label: logits} of the requests this rank answers, the batch
    log [[model, tier], ...] of its sharded dispatches, {name: bool} of
    its own checks, {model: graph_id})."""
    answers: Dict[str, np.ndarray] = {}
    log: List = []
    checks: Dict[str, bool] = {}
    big = make_graph(spec.nodes, spec)
    gids = {k: eng.attach(big, model=k, calibrate=False)
            for k in spec.kinds}
    labels = {}
    for k, gid in gids.items():
        for tier in TIERS:
            labels[f"{k}/{tier}"] = eng.query(gid, tier=tier)
        if spec.replicas > 1:   # a second query, so a batch fills R rows
            labels[f"{k}/fp32/2"] = eng.query(gid, tier="fp32")
    _serve(eng, labels, answers, log)
    if spec.delta:
        labels = {}
        for k in [k for k in spec.kinds if KINDS[k][0] in ("gcn", "gat")]:
            gid = gids[k]
            part, g = eng._sharded[gid]
            add, rm = _cross_delta(g, part, spec.seed + 30)
            checks[f"{k}/delta_patched"] = eng.update_delta(
                gid, add_edges=add, remove_edges=rm)
            ver = eng._graph_version[gid]
            part2, g2 = eng._sharded[gid]
            rebuilt = gmodels.build_sharded_operands(
                g2, part2, eng.models[k].cfg, pg=eng.graphs[gid][1],
                keys=eng._graph_keys[gid], device=eng.device,
                shard=(None if eng.mesh is None
                       else eng.mesh.coords["shard"]))
            checks[f"{k}/delta_equals_rebuild"] = _same_slices(
                eng._shard_cache[(gid, ver)], rebuilt)
            for tier in TIERS:
                labels[f"{k}/{tier}/delta"] = eng.query(gid, tier=tier)
        _serve(eng, labels, answers, log)
    if spec.grow:
        small, mid = (make_graph(n, spec) for n in spec.grow)
        k = spec.kinds[0]
        gid = eng.attach(small, model=k, calibrate=False)
        checks["grow/into_sharded"] = eng.update(
            gid, mid.edge_index, mid.num_nodes, mid.features)
        labels = {"grow/sharded": eng.query(gid)}
        _serve(eng, labels, answers, log)
        checks["grow/back"] = eng.update(
            gid, small.edge_index, small.num_nodes, small.features)
        labels = {"grow/unsharded": eng.query(gid)}
        _serve(eng, labels, answers, log)
    return answers, log, checks, gids


def time_dispatches(eng: GraphServe, gids: Dict[str, int],
                    iters: int) -> Dict[str, Dict]:
    """Per model, one sharded fp32 dispatch of its graph's plan on this
    rank's block (every rank calls it together): the bytes handed to
    all_reduce and their ring price (`ring_psum_nbytes` on the wire's
    width), the modelled latency (`core.partition.
    modelled_sharded_latency`, a model of cards joined by a device link,
    not a measurement), and on a card the CUDA-event ms of the plan call,
    of its all_reduces, and of the rest (None on the CPU: not
    measured)."""
    out = {}
    for k, gid in gids.items():
        e = eng.models[k]
        ver = eng._graph_version[gid]
        part = eng._sharded[gid][0]
        slices = eng._shard_cache[(gid, ver)]
        if eng.mesh is None:
            x, ops, mask = gmodels.stack_shard_slices(slices)
        else:
            x, ops, mask = slices[0].x, slices[0].ops, slices[0].node_mask
        plan = gmodels.build_sharded_plan(
            e.cfg, part.shard_cap, part.shards, e.tiers["fp32"],
            compress=eng.sc.halo_compress,
            replicas=1 if eng.mesh is None else eng.sc.replica_groups,
            device=eng.device, mesh=eng.mesh)

        def call():
            return plan(e.params, x, ops, None, node_mask=mask)

        call()
        w0 = dict(compress.WIRE)
        call()
        row = {"wire_bytes": compress.WIRE["bytes"] - w0["bytes"],
               "wire_calls": compress.WIRE["calls"] - w0["calls"],
               "ring_price_bytes": sum(
                   compress.ring_psum_nbytes(
                       part.shards, part.full_rows * w,
                       bytes_per_elt=1 if eng.sc.halo_compress else 4)
                   for w in gmodels.sharded_exchange_widths(e.cfg)),
               "modelled_ms": 1e3 * modelled_sharded_latency(
                   part, in_feats=e.cfg.in_feats, hidden=e.cfg.hidden,
                   classes=e.cfg.num_classes,
                   exchange_widths=gmodels.sharded_exchange_widths(e.cfg),
                   compress=eng.sc.halo_compress),
               "dispatch_ms": None, "allreduce_ms": None, "rest_ms": None}
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
            spans = []
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with timed_all_reduces(spans):
                start.record()
                for _ in range(iters):
                    call()
                end.record()
                end.synchronize()
            total = start.elapsed_time(end) / iters
            ar = sum(a.elapsed_time(b) for a, b in spans) / iters
            row.update(dispatch_ms=total, allreduce_ms=ar,
                       rest_ms=total - ar)
        out[k] = row
    return out


def serve(spec: BurstSpec, *, wires: Sequence[bool], device=None,
          mesh=None) -> Dict:
    """The burst once per halo wire setting (False exact, True int8), each
    on a fresh engine: {"off"/"on": {answers (digests), the partitions'
    digests, logits, batch log, checks, launches, summary counters,
    dispatch times, and the host seconds of its stages: the engine's
    build (registration, calibration, warmup), the burst, the timing}}."""
    out = {}
    for wire in wires:
        t0 = time.perf_counter()
        eng = build_engine(spec, compress_halo=wire, device=device,
                           mesh=mesh)
        t1 = time.perf_counter()
        before = {n: m.LAUNCHES for n, m in KERNELS.items()}
        answers, log, checks, gids = run_burst(eng, spec)
        launches = {n: m.LAUNCHES - before[n] for n, m in KERNELS.items()}
        t2 = time.perf_counter()
        dispatch = time_dispatches(eng, gids, TIME_ITERS)
        s = eng.summary()
        stages = {"engine_s": t1 - t0, "burst_s": t2 - t1,
                  "timing_s": time.perf_counter() - t2}
        eng.assert_warm()
        out["on" if wire else "off"] = dict(
            answers={k: digest(v) for k, v in answers.items()},
            partitions={k: digest(eng._sharded[gid][0].perm)
                        for k, gid in gids.items()},
            logits=answers, batch_log=log, checks=checks,
            launches=launches, dispatch=dispatch,
            summary={k: s[k] for k in COUNTERS},
            cache_resident_bytes=s["cache_resident_bytes"],
            stages=stages)
        del eng
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def collective_check(mesh, seed: int = 0) -> Dict[str, float]:
    """The group forms against the stacked forms on seeded inputs, on
    every rank of the shard group: each rank's term is its slice of one
    stacked (S, ...) tensor, equal on every rank. Returns per form the
    largest |difference| (0.0 is bit for bit): psum, pmax, the compressed
    sum and mean, the halo delta (compressed and exact), the exact mean,
    the halo exchange (both wires) and `assemble`."""
    group = mesh.group("shard")
    s, idx = mesh.shape["shard"], mesh.coords["shard"]
    dev = mesh.device
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((s, 64, 48)).astype(
        np.float32) * 3).to(dev)
    rows = torch.from_numpy(rng.standard_normal((s, 16, 48)).astype(
        np.float32)).to(dev)
    owners = torch.from_numpy(rng.integers(0, s, 16)).to(dev)
    h = torch.from_numpy(rng.standard_normal((1, s, 32, 24)).astype(
        np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((1, s, 32)) < 0.8).astype(
        np.float32)).to(dev)

    def diff(a, b):
        return float((a.double() - b.double()).abs().max())

    out = {"psum": diff(compress.psum(g[idx], group), g.sum(0)),
           "pmax": diff(compress.pmax(g[idx], group), g.amax(0)),
           "compressed_psum": diff(compress.compressed_psum(
               g[idx], group=group)[0], compress.compressed_psum(g)[0][idx]),
           "compressed_psum_mean": diff(compress.compressed_psum_mean(
               g[idx], group=group)[0],
               compress.compressed_psum_mean(g)[0][idx]),
           "exact_psum_mean": diff(compress.exact_psum_mean(
               g[idx], group=group), compress.exact_psum_mean(g)[idx])}
    for c in (True, False):
        out[f"compressed_psum_delta/{c}"] = diff(
            compress.compressed_psum_delta(rows[idx], owners, compress=c,
                                           group=group),
            compress.compressed_psum_delta(rows, owners, compress=c)[idx])
        out[f"halo_exchange/{c}"] = diff(
            gmodels.halo_exchange(h[:, idx:idx + 1], mask[:, idx:idx + 1],
                                  compress=c, group=group),
            gmodels.halo_exchange(h, mask, compress=c))
    full = g.reshape(s * 64, 48)
    out["assemble"] = diff(assemble(local_block(full, ("shard", None),
                                                mesh), ("shard", None), mesh),
                           full)
    return out


def spawn_local(world: int, args: Sequence[str], timeout_s: float, *,
                program: Sequence[str] = ("-m",
                                          "repro_torch.launch.shard_serve"),
                env: Optional[Dict[str, str]] = None) -> List[str]:
    """Start `world` ranks of `program` (with `args`, then --rank,
    --world-size and a fresh file:// --init-method) as subprocesses on
    this host and wait for them; returns each rank's standard output. On
    any rank's failure, or when `timeout_s` passes first, every rank still
    running is killed and RuntimeError (TimeoutError) raised with the
    failed rank's last error lines, so a hung collective cannot hang the
    caller."""
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/store"
        procs, outs, errs = [], [], []
        try:
            for r in range(world):
                outs.append(open(f"{tmp}/out{r}", "w+"))
                errs.append(open(f"{tmp}/err{r}", "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, *program, *args, "--rank", str(r),
                     "--world-size", str(world), "--init-method", init],
                    stdout=outs[r], stderr=errs[r], env=env))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad or all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    alive = [r for r, c in enumerate(codes) if c is None]
                    raise TimeoutError(f"ranks {alive} of {world} still "
                                       f"running after {timeout_s} s; "
                                       f"killed")
                time.sleep(0.05)
            if bad:
                errs[bad[0]].seek(0)
                tail = errs[bad[0]].read()[-3000:]
                raise RuntimeError(f"rank {bad[0]} of {world} exited with "
                                   f"code {codes[bad[0]]}; every other rank "
                                   f"killed. Its stderr ends:\n{tail}")
            result = []
            for f in outs:
                f.seek(0)
                result.append(f.read())
            return result
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in outs + errs:
                f.close()


def last_json(text: str) -> Dict:
    """The last line of a rank's output, parsed."""
    return json.loads(text.strip().splitlines()[-1])


def burst_args(spec: BurstSpec, wire: str = "both") -> List[str]:
    """The command-line arguments that make a rank serve `spec`."""
    args = ["--shards", str(spec.shards), "--replicas", str(spec.replicas),
            "--kind", ",".join(spec.kinds), "--nodes", str(spec.nodes),
            "--feats", str(spec.feats), "--hidden", str(spec.hidden),
            "--heads", str(spec.heads), "--classes", str(spec.classes),
            "--ladder", ",".join(map(str, spec.ladder)), "--cal-nodes",
            str(spec.cal_nodes), "--slots", str(spec.slots), "--seed",
            str(spec.seed), "--wire", wire]
    if spec.delta:
        args.append("--delta")
    if spec.grow:
        args += ["--grow", ",".join(map(str, spec.grow))]
    return args


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default=None,
                    help="this rank's device (cuda, cuda:0, cpu); default "
                         "cuda:{rank}")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--kind", default="gcn",
                    help=f"comma-separated models of {sorted(KINDS)}")
    ap.add_argument("--nodes", type=int, default=10000)
    ap.add_argument("--feats", type=int, default=1433)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--classes", type=int, default=7)
    ap.add_argument("--ladder", default="1024,3072")
    ap.add_argument("--cal-nodes", type=int, default=2708)
    ap.add_argument("--wire", choices=("off", "on", "both"), default="both")
    ap.add_argument("--delta", action="store_true")
    ap.add_argument("--grow", default="",
                    help="small,mid node counts for update() there and back")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--collectives", action="store_true",
                    help="only the group forms against the stacked ones")
    ap.add_argument("--out", default=None,
                    help="a directory for each rank's logits (.npz)")
    args = ap.parse_args(argv)

    dev = init_distributed(backend=args.backend,
                           init_method=args.init_method, rank=args.rank,
                           world_size=args.world_size, device=args.device,
                           timeout_s=TIMEOUT_S)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        if args.world_size != args.shards * args.replicas:
            raise ValueError(f"{args.replicas} x {args.shards} mesh for a "
                             f"world of {args.world_size}")
        mesh = make_shard_mesh(args.shards, args.replicas, device=dev)
        res = {"rank": args.rank, "coords": mesh.coords,
               "mesh": mesh.shape, "device": str(dev),
               "backend": dist.get_backend()}
        if args.collectives:
            res["collectives"] = collective_check(mesh, args.seed)
        else:
            spec = BurstSpec(
                kinds=tuple(args.kind.split(",")), nodes=args.nodes,
                feats=args.feats, hidden=args.hidden, heads=args.heads,
                classes=args.classes,
                ladder=tuple(int(b) for b in args.ladder.split(",")),
                shards=args.shards, replicas=args.replicas,
                cal_nodes=args.cal_nodes, delta=args.delta,
                grow=tuple(int(n) for n in args.grow.split(",") if n),
                slots=args.slots, seed=args.seed)
            wires = {"off": (False,), "on": (True,),
                     "both": (False, True)}[args.wire]
            t0 = time.perf_counter()
            res["wires"] = serve(spec, wires=wires, device=dev, mesh=mesh)
            res["serve_s"] = time.perf_counter() - t0
            for wire, r in res["wires"].items():
                logits = r.pop("logits")
                if args.out:
                    np.savez(Path(args.out) / f"rank{args.rank}_{wire}.npz",
                             **{k.replace("/", "|"): v
                                for k, v in logits.items()})
        print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
