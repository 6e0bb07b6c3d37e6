"""One rank of the process-group checks of `tests/test_torch_mesh.py`.

Started by `repro_torch.launch.shard_serve.spawn_local` (gloo, the CPU,
one thread), as

  python tests/torch_mesh_rank.py --scenario S --out DIR \\
      --rank R --world-size N --init-method file://...

it runs scenario S on the mesh and writes its arrays to DIR/rankR.npz and
its facts to DIR/rankR.json. It imports neither JAX nor the reference
package; the test process computes the references and imports the
inputs made here (`plan_inputs`, `decisions_burst`) so that both sides
build them alike. Scenarios:

  plans      2 ranks: the mesh plan of every (kind, tier, wire) on the
             200-node graph, and with `use_pallas` (counting the kernel
             entries' calls); the group collectives;
  replicas   4 ranks: the 2 x 2 replica mesh (two graphs, one per
             replica row), the 1-D mesh of 4 on a 400-node graph, the
             host mesh, meshes larger than the world (a shard mesh, the
             production mesh);
  decisions  2 ranks whose fake clocks differ: tolerance routing, the SLO
             governor and deadlines through `GraphServe(mesh=)`, an fp32
             query through the deterministic pipeline on the mesh, and
             attach()'s admission under a byte budget that only the
             lead's residency overflows;
  pipeline   2 ranks: the pipeline scheduler on the mesh. The inline
             (deterministic) pipeline through `shard_serve.serve`
             (`PIPE_SPEC`), the threaded pipeline with 4 host workers and
             slowed followers against the sync run() of the same calls
             (`threaded_burst`, attach() while it is open), ranks whose
             fake clocks differ (`clocked_pipeline`: deadlines, the
             governor's tier and shed, `QueueFull` under "reject"), a
             follower whose host stage fails for a uid the lead names,
             and ranks that make different calls (`fault_bursts`);
  pipeline22 4 ranks: the inline and the threaded pipeline on the 2 x 2
             replica mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402
from repro_torch.core import partition as tp  # noqa: E402
from repro_torch.core.graph import BucketLadder, pad_graph  # noqa: E402
from repro_torch.data import graphs as tdata  # noqa: E402
from repro_torch.dist.sharding import assemble  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import shard_serve as ss  # noqa: E402
from repro_torch.launch.mesh import (init_distributed,  # noqa: E402
                                     make_host_mesh, make_production_mesh,
                                     make_shard_mesh)
from repro_torch.runtime.cache import (CacheAdmissionError,  # noqa: E402
                                       estimate_dense_entry_bytes,
                                       estimate_shard_entry_bytes)
from repro_torch.runtime.clock import Clock  # noqa: E402
from repro_torch.runtime.gnn_server import (GraphServe,  # noqa: E402
                                            GraphServeConfig,
                                            tier_techniques)
from repro_torch.runtime.scheduler import (PipelineConfig,  # noqa: E402
                                           QueueFull)
from repro_torch.runtime.slo import SLOConfig  # noqa: E402

IN_FEATS, HIDDEN, HEADS, CLASSES = 12, 16, 2, 4
BUCKET = 128
KINDS = {"gcn": ("gcn", {}), "gat": ("gat", {}),
         "sage_max": ("sage", {"aggregator": "max"}),
         "sage_mean": ("sage", {"aggregator": "mean"})}
PLAN_CASES = [(c, tier, w) for c in sorted(KINDS) for tier in ("fp32", "int8")
              for w in (False, True)]
PALLAS_CASES = [(c, tier) for c in sorted(KINDS) for tier in ("fp32", "int8")]
REPLICA_CASES = [("gcn", "fp32"), ("gcn", "int8"), ("gat", "fp32"),
                 ("sage_max", "fp32")]
WIDE_CASES = [("gcn", tier, w) for tier in ("fp32", "int8")
              for w in (False, True)]
KERNEL_ENTRIES = ("matmul", "int8_matmul", "sage_max")


def graph(n, seed):
    return tdata.clustered_like(num_nodes=n, num_feats=IN_FEATS,
                                num_classes=CLASSES, within_density=0.05,
                                cross_frac=0.1, seed=seed)


def config(case):
    kind, kw = KINDS[case]
    return tmodels.GNNConfig(kind=kind, in_feats=IN_FEATS, hidden=HIDDEN,
                             num_classes=CLASSES, heads=HEADS, **kw)


def plan_inputs(case, tier, *, n=200, seed=4, shards=2, pallas=False):
    """A case's graph, partition, numpy weights, Techniques and (int8)
    the port's calibration on the padded graph."""
    cfg = config(case)
    g = graph(n, seed)
    part = tp.partition_graph(g.edge_index, n, shards, shard_cap=BUCKET)
    w = ss.model_weights(cfg, 0)
    t = tier_techniques(cfg.kind)[tier]
    if pallas:
        t = dataclasses.replace(t, use_pallas=True,
                                grax3=t.grax3 or case == "sage_max")
    params = params_from_jax(w, device="cpu")
    cal = None
    if t.quantgr:
        pg = pad_graph(g, capacity=part.full_rows)
        cal = tmodels.calibrate_tier(
            params, cfg, torch.from_numpy(pg.features),
            tmodels.build_operands(pg, cfg, device="cpu"))
    return dict(cfg=cfg, g=g, part=part, w=w, t=t, params=params, cal=cal)


def mesh_block(d, mesh, compress, g=None, part=None, replicas=1):
    """This rank's (C, classes) logits of the mesh plan."""
    g, part = (g, part) if g is not None else (d["g"], d["part"])
    sl = tmodels.build_sharded_operands(g, part, d["cfg"], device="cpu",
                                        shard=mesh.coords["shard"])[0]
    plan = tmodels.build_sharded_plan(d["cfg"], BUCKET, part.shards, d["t"],
                                      compress=compress, replicas=replicas,
                                      device="cpu", mesh=mesh)
    out = plan(d["params"], sl.x, sl.ops, d["cal"], node_mask=sl.node_mask)
    assert plan.trace_count == 1
    return out


def scenario_plans(mesh, arrays, facts):
    for case, tier, compress in PLAN_CASES:
        d = plan_inputs(case, tier)
        block = mesh_block(d, mesh, compress)
        arrays[f"{case}|{tier}|{compress}"] = block.numpy()
        arrays[f"{case}|{tier}|{compress}|nodes"] = tmodels.unshard_logits(
            assemble(block, ("shard", None), mesh), d["part"])
    calls = {}
    for case, tier in PALLAS_CASES:
        d = plan_inputs(case, tier, pallas=True)
        n = dict.fromkeys(KERNEL_ENTRIES, 0)
        real = {k: getattr(kops, k) for k in KERNEL_ENTRIES}

        def counted(*a, _k, **kw):
            n[_k] += 1
            return real[_k](*a, **kw)
        try:
            for k in KERNEL_ENTRIES:
                setattr(kops, k, lambda *a, _k=k, **kw: counted(*a, _k=_k,
                                                                **kw))
            arrays[f"{case}|{tier}|pallas"] = mesh_block(d, mesh,
                                                         False).numpy()
        finally:
            for k, f in real.items():
                setattr(kops, k, f)
        calls[f"{case}|{tier}"] = n
    facts.update(calls=calls, collectives=ss.collective_check(mesh),
                 coords=mesh.coords, shape=mesh.shape,
                 group_size=torch.distributed.get_world_size(
                     mesh.group("shard")))


def scenario_replicas(mesh, arrays, facts):
    mesh22 = mesh
    mesh4 = make_shard_mesh(4, device="cpu")
    for name, make in (("too_small", lambda: make_shard_mesh(
            2, 3, device="cpu")), ("production", lambda:
            make_production_mesh(device="cpu"))):
        try:
            make()
            facts[name] = None
        except RuntimeError as exc:
            facts[name] = str(exc)
    facts["host"] = make_host_mesh(model=2, device="cpu").shape
    g2 = graph(190, 9)
    p2 = tp.partition_graph(g2.edge_index, 190, 2, shard_cap=BUCKET)
    for case, tier in REPLICA_CASES:
        d = plan_inputs(case, tier)
        g, part = [(d["g"], d["part"]), (g2, p2)][mesh22.coords["replica"]]
        block = mesh_block(d, mesh22, False, g=g, part=part, replicas=2)
        arrays[f"{case}|{tier}|replicas"] = assemble(
            block[None, None], ("replica", "shard", None, None),
            mesh22).numpy()
    for case, tier, compress in WIDE_CASES:
        d = plan_inputs(case, tier, n=400, shards=4)
        arrays[f"{case}|{tier}|{compress}|wide"] = mesh_block(
            d, mesh4, compress).numpy()
    facts.update(coords22=mesh22.coords, coords4=mesh4.coords,
                 collectives4=ss.collective_check(mesh4))


class SkewClock(Clock):
    """Virtual time that moves only by the batches: each batch of an
    int8 key costs `int8_s`, any other `other_s`; ranks are given
    different costs so that their latency banks, governors and deadlines
    would disagree if each decided alone."""

    def __init__(self, int8_s, other_s):
        self.t, self.int8_s, self.other_s = 100.0, int8_s, other_s

    def now(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds

    def on_batch(self, key, span=None):
        self.t += self.int8_s if key[2] == "int8" else self.other_s


# each rank's batch costs (int8, other), in seconds
CLOCKS = ((0.009, 0.002), (0.001, 0.005))


def decisions_engine(rank, mesh=None, **slo):
    """A 2-shard fp32/int8 GCN engine on rank `rank`'s skewed clock, with
    an SLO governor whose 3 ms p99 target the slower rank breaches (`slo`
    sets more of its fields)."""
    cfg = config("gcn")
    eng = GraphServe(GraphServeConfig(
        ladder=BucketLadder(buckets=(BUCKET,)), batch_slots=2,
        return_logits=True, shard_counts=(2,), halo_compress=False),
        clock=SkewClock(*CLOCKS[rank]),
        slo=SLOConfig(**{**dict(target_p99_ms=3.0, window=4, min_samples=1,
                                breach_checks=1, clear_checks=8), **slo}),
        device="cpu", mesh=mesh)
    eng.register_model("m", cfg, params_from_jax(ss.model_weights(cfg, 0),
                                                 device="cpu"),
                       tiers=("fp32", "int8"))
    eng.calibrate("m", graph(100, 77))
    eng.warmup()
    return eng


def decisions_burst(eng):
    """Queries over one sharded graph that the clock decides: explicit
    tiers first (both measured), then tolerance-routed and default-tier
    queries (the router and the governor), and deadline-bound ones, some
    of which expire. Returns per uid (tier served, expired, logits)."""
    gid = eng.attach(graph(200, 4), model="m", calibrate=False)
    uids = [eng.query(gid, tier="fp32"), eng.query(gid, tier="int8")]
    eng.run()
    for _ in range(3):
        uids.append(eng.query(gid, tolerance=100.0))
        uids.append(eng.query(gid))
        uids.append(eng.query(gid, deadline_ms=4.0))
        eng.run()
    by_uid = {r.uid: r for r in eng.finished}
    return {u: (by_uid[u].tier, by_uid[u].preds is None, by_uid[u].logits)
            for u in uids}


def admission_burst(mesh):
    """attach() under a byte budget with admission="reject": the lead
    alone holds an unsharded graph's entry, and that entry tips the
    budget for the next sharded graph on the lead only. Every rank then
    detaches the unsharded graph, attaches the sharded one again and
    queries it at fp32. Returns this rank's residency before the refused
    attach, whether it refused, the ids of the attaches and the query's
    logits."""
    cfg = config("gcn")
    small, big = graph(100, 77), graph(200, 4)
    ladder = BucketLadder(buckets=(BUCKET,))
    part = tp.partition_for_ladder(big.edge_index, big.num_nodes, ladder,
                                   (2,))
    nf = len(tmodels.OPERAND_FIELDS["gcn"])
    shard_b = estimate_shard_entry_bytes(1, part.shard_cap, part.full_rows,
                                         nf, IN_FEATS)
    budget = shard_b + estimate_dense_entry_bytes(nf, BUCKET) // 2
    eng = GraphServe(GraphServeConfig(
        ladder=ladder, batch_slots=2, return_logits=True, shard_counts=(2,),
        halo_compress=False, device_cache_budget_bytes=budget,
        admission="reject"), device="cpu", mesh=mesh)
    eng.register_model("m", cfg, params_from_jax(ss.model_weights(cfg, 0),
                                                 device="cpu"),
                       tiers=("fp32",))
    gids = [eng.attach(small, model="m", calibrate=False)]
    eng.query(gids[0])
    eng.run()
    resident = eng.summary()["cache_resident_bytes"]
    try:
        gids.append(eng.attach(big, model="m", calibrate=False))
        refused = False
    except CacheAdmissionError:
        refused = True
    eng.detach(gids[0])
    gids.append(eng.attach(big, model="m", calibrate=False))
    uid = eng.query(gids[-1])
    eng.run()
    (done,) = [r for r in eng.finished if r.uid == uid]
    return dict(budget=budget, shard_bytes=shard_b, resident=resident,
                refused=refused, gids=gids,
                rejects=eng.summary()["cache_admission_rejects"]), done.logits


def scenario_decisions(mesh, arrays, facts):
    eng = decisions_engine(mesh.coords["shard"], mesh)
    out = decisions_burst(eng)
    facts["served"] = {str(u): [tier, expired]
                       for u, (tier, expired, _) in out.items()}
    for u, (_, _, lg) in out.items():
        if lg is not None:
            arrays[str(u)] = lg
    facts["summary"] = {k: eng.summary()[k] for k in (
        "batches", "sharded_batches", "deadline_misses", "slo_downgrades")}
    gid = eng.attach(graph(200, 4), model="m", calibrate=False)
    with eng.scheduler(PipelineConfig(deterministic=True)) as sched:
        ticket = sched.query(gid, tier="fp32")
        sched.drain()
        arrays["pipeline"] = sched.request(ticket).logits
        facts["pipeline"] = sched.summary()["pipeline"]
    facts["fp32_uid"] = str(next(iter(out)))
    facts["admission"], arrays["admission"] = admission_burst(mesh)


# the inline pipeline's burst through `shard_serve.serve` on each mesh
PIPE_SPEC = ss.BurstSpec(kinds=("gcn", "sage-max"), nodes=200,
                         feats=IN_FEATS, hidden=HIDDEN, heads=HEADS,
                         classes=CLASSES, ladder=(BUCKET,), shards=2,
                         cal_nodes=100, delta=True, grow=(90, 200), slots=2,
                         pipeline=1, deterministic=True)
PIPE_SPEC22 = dataclasses.replace(PIPE_SPEC, kinds=("gcn",), replicas=2,
                                  delta=False, grow=())
TIERS = ("fp32", "int8")


def pipe_engine(mesh):
    """A warm fp32/int8 GCN engine ("m") on the mesh's shard count and
    replica rows, under a byte budget it never fills (so attach() runs its
    admission broadcast)."""
    cfg = config("gcn")
    eng = GraphServe(GraphServeConfig(
        ladder=BucketLadder(buckets=(BUCKET,)), batch_slots=2,
        return_logits=True, shard_counts=(mesh.shape["shard"],),
        halo_compress=False, replica_groups=mesh.shape.get("replica", 1),
        device_cache_budget_bytes=1 << 40), device="cpu", mesh=mesh)
    eng.register_model("m", cfg, params_from_jax(ss.model_weights(cfg, 0),
                                                 device="cpu"),
                       tiers=TIERS)
    eng.calibrate("m", graph(100, 77))
    eng.warmup()
    return eng


def slow_followers(eng, seed):
    """A follower's host stage of a sharded query sleeps 2-20 ms first, so
    its 4 workers finish out of order and behind the lead's."""
    if eng.mesh.is_first:
        return
    real, rng = eng._prepare_sharded, random.Random(seed)

    def slowed(*a, **kw):
        time.sleep(rng.uniform(0.002, 0.02))
        return real(*a, **kw)
    eng._prepare_sharded = slowed


def threaded_burst(mesh, arrays):
    """The same calls through the threaded pipeline (4 host workers, a
    2-deep ready buffer, the 2 ms window; an `update_delta` and a sharded
    graph attached while it is open; two queries with a 0.001 ms
    deadline, which the lead expires) and then through submit/query + run(): per label, the uid
    and, where this rank answers it, the logits of each path (arrays
    "pipe|label", "sync|label"), the expired labels, the pipeline's
    sharded batch log and counters."""
    eng = pipe_engine(mesh)
    slow_followers(eng, dist_rank())
    bigs, small = (graph(200, 4), graph(190, 9)), graph(100, 77)
    facts = {}
    for mode in ("pipe", "sync"):
        gids = [eng.attach(g, model="m", calibrate=False) for g in bigs]
        sgid = eng.attach(small, model="m", calibrate=False)
        sched = (eng.scheduler(PipelineConfig(host_workers=4, window_ms=2.0,
                                              max_ready=2))
                 if mode == "pipe" else None)
        query = eng.query if sched is None else sched.query
        submit = eng.submit if sched is None else sched.submit
        labels = {}
        for i in range(12):
            labels[f"q{i}"] = query(gids[i % 2], tier=TIERS[i // 2 % 2])
            if i % 4 == 3:
                labels[f"s{i}"] = submit(small, model="m")
                labels[f"u{i}"] = query(sgid)
        # a delta while those queries may still be in the host stage: each
        # serves the version of its call, as in run()
        part, g = eng._sharded[gids[0]]
        add, rm = ss._cross_delta(g, part, 5)
        eng.update_delta(gids[0], add_edges=add, remove_edges=rm)
        for tier in TIERS:
            labels[f"delta/{tier}"] = query(gids[0], tier=tier)
        late = eng.attach(graph(210, 11), model="m", calibrate=False)
        for tier in TIERS:
            labels[f"late/{tier}"] = query(late, tier=tier)
            labels[f"deadline/{tier}"] = query(gids[0], tier=tier,
                                               deadline_ms=0.001)
        if sched is not None:
            sched.drain(timeout=60)
            reqs = {k: sched.request(t) for k, t in labels.items()}
            facts["log"] = [e for e in sched.dispatch_log if e[3]]
            facts["counters"] = sched.summary()["pipeline"]
            sched.close()
        else:
            eng.run()
            by_uid = {r.uid: r for r in eng.finished}
            reqs = {k: by_uid.get(u) for k, u in labels.items()}
        facts[mode] = {k: None if r is None else r.uid
                       for k, r in reqs.items()}
        facts[f"{mode}_expired"] = sorted(
            k for k, r in reqs.items() if r is not None
            and r.deadline_missed and r.preds is None)
        for k, r in reqs.items():
            if r is not None and r.logits is not None:
                arrays[f"{mode}|{k}"] = r.logits
    eng.assert_warm()
    return facts


def clocked_pipeline(eng):
    """The inline pipeline on a rank's skewed clock (`SLOConfig` ladder
    fp32/int8, shedding at a queue depth of 3), `max_pending` 3 under
    "reject": a burst past the intake first (rejects), explicit tiers,
    tolerance-routed, default-tier and deadline-bound queries, then a
    burst with the governor at its floor (sheds). Returns per label
    "reject", "shed" or (tier served, expired, logits), and the counters.
    """
    gid = eng.attach(graph(200, 4), model="m", calibrate=False)
    out, tickets = {}, {}
    pc = PipelineConfig(deterministic=True, max_pending=3,
                        backpressure="reject")
    with eng.scheduler(pc) as sched:
        def ask(label, **kw):
            try:
                tickets[label] = sched.query(gid, **kw)
            except QueueFull as exc:
                out[label] = "shed" if "shedding" in str(exc) else "reject"

        for i in range(5):
            ask(f"burst{i}")
        sched.drain()
        ask("fp32", tier="fp32")
        ask("int8", tier="int8")
        sched.drain()
        for i in range(3):
            ask(f"tol{i}", tolerance=100.0)
            ask(f"default{i}")
            ask(f"deadline{i}", deadline_ms=4.0)
            sched.drain()
        for i in range(5):
            ask(f"floor{i}")
        sched.drain()
        for label, t in tickets.items():
            r = sched.request(t)
            out[label] = (r.tier, r.preds is None, r.logits)
        counters = sched.summary()["pipeline"]
    counters["shed_requests"] = eng.summary()["shed_requests"]
    return out, counters


def fault_bursts(mesh):
    """A follower whose host stage fails for the second of three queries,
    which the lead names in a batch: every rank raises at that batch
    (drain, then close). Then ranks that make different calls (the lead a
    sharded query, the others a one-shot submit): every rank raises at
    that intake, and closes. Returns each rank's messages."""
    eng = pipe_engine(mesh)
    gid = eng.attach(graph(200, 4), model="m", calibrate=False)
    bad = eng._uid + 1
    if not mesh.is_first:
        real = eng._prepare_sharded

        def failing(*a, uid=None, **kw):
            if uid == bad:
                raise RuntimeError(f"planted host-stage fault at uid {uid}")
            return real(*a, uid=uid, **kw)
        eng._prepare_sharded = failing
    out = {}
    t0 = time.perf_counter()
    sched = eng.scheduler(PipelineConfig(host_workers=2))
    for _ in range(3):
        sched.query(gid, tier="fp32")
    try:
        sched.drain(timeout=60)
        out["drain"] = None
    except RuntimeError as exc:
        out["drain"] = str(exc)
    try:
        sched.close()
        out["close"] = None
    except RuntimeError as exc:
        out["close"] = str(exc)
    out["fault_s"] = time.perf_counter() - t0
    with eng.scheduler(PipelineConfig(deterministic=True)) as sched:
        try:
            if mesh.is_first:
                sched.query(gid)
            else:
                sched.submit(graph(100, 77), model="m")
            out["differ"] = None
        except RuntimeError as exc:
            out["differ"] = str(exc)
    out["uid_after"] = eng._uid
    return out


def scenario_pipeline(mesh, arrays, facts):
    spec = PIPE_SPEC22 if "replica" in mesh.shape else PIPE_SPEC
    det = ss.serve(spec, wires=(False,), device="cpu", mesh=mesh)["off"]
    piped = det["pipeline"].pop("logits")
    arrays.update({f"det|{k}": v for k, v in piped.items()})
    facts["det"] = dict(det["pipeline"], sync=det["answers"],
                        answers={k: ss.digest(v) for k, v in piped.items()})
    facts["threads"] = threaded_burst(mesh, arrays)
    if "replica" in mesh.shape:
        return
    out, counters = clocked_pipeline(decisions_engine(
        mesh.coords["shard"], mesh, ladder=TIERS, max_queue_depth=3))
    facts["clocks"] = {k: v if isinstance(v, str) else list(v[:2])
                       for k, v in out.items()}
    facts["clock_counters"] = counters
    arrays.update({f"clock|{k}": v[2] for k, v in out.items()
                   if not isinstance(v, str) and v[2] is not None})
    facts["faults"] = fault_bursts(mesh)


def dist_rank():
    return torch.distributed.get_rank()


SCENARIOS = {"plans": ((2, 1), scenario_plans),
             "replicas": ((2, 2), scenario_replicas),
             "decisions": ((2, 1), scenario_decisions),
             "pipeline": ((2, 1), scenario_pipeline),
             "pipeline22": ((2, 2), scenario_pipeline)}



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    args = ap.parse_args()
    init_distributed(backend="gloo", init_method=args.init_method,
                     rank=args.rank, world_size=args.world_size,
                     device="cpu", timeout_s=60)
    torch.set_num_threads(1)
    try:
        (shards, replicas), fn = SCENARIOS[args.scenario]
        mesh = make_shard_mesh(shards, replicas, device="cpu")
        arrays, facts = {}, {}
        fn(mesh, arrays, facts)
        np.savez(Path(args.out) / f"rank{args.rank}.npz", **arrays)
        (Path(args.out) / f"rank{args.rank}.json").write_text(
            json.dumps(facts))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
