"""PyTorch port, the pipeline scheduler on a mesh of processes:
`GraphServe(mesh=).scheduler(pc)` on every rank of a 2-rank and a 2 x 2
("replica", "shard") mesh, held against the one-process port's pipeline,
the sync mesh `run()` of the same calls and the reference's pipeline.

The ranks run as subprocesses on gloo and the CPU, one thread each
(`tests/torch_mesh_rank.py`, scenarios "pipeline" and "pipeline22"),
started by `spawn_local` under a timeout that kills them all; each mesh
runs once per module and the parametrised cases read its results. The
rank processes import no JAX: the references run here.

Bars. The inline (deterministic) pipeline, halo wire off: the lead's
uids, tiers, batches, expiries and logits equal the one-process port's
inline pipeline on the same calls bit for bit (the mesh engine is
bit-equal to the stacked one), and every other rank answers its sharded
requests alike; against the reference's inline pipeline the batches,
uids, tiers and expiries are equal, fp32 logits within rtol = atol =
1e-5 with argmax equal, int8 ones within 0.05 with argmax equal on 99%
of rows (an int8 tie can round to the neighbouring step, as in
`tests/test_torch_mesh.py`). The threaded pipeline (4 host workers, the
followers' host stages slowed by sleeps, a 2-deep ready buffer, an
`update_delta` and a graph attached while it is open, two expiring
deadlines): every rank's answer to each call bit-equal to the sync mesh
run() of the same calls, every rank's batch log equal to the lead's,
`accepted == completed` on every rank. Ranks on fake
clocks that differ: every rank serves, expires, sheds and rejects as a
one-process inline pipeline on the lead's clock.
"""
import contextlib
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as rg
from repro.core import quant as rquant
from repro.core import models as rmodels
from repro.runtime import gnn_server as rserve
from repro.runtime.scheduler import PipelineConfig as RPC
from repro_torch.core import quant as tquant
from repro_torch.launch import shard_serve as ss

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_rank as mr  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
WIRE_ATOL = 0.05
SPAWN_TIMEOUT_S = 120
RANK_SCRIPT = str(Path(__file__).resolve().parent / "torch_mesh_rank.py")
MESHES = {"2": ("pipeline", mr.PIPE_SPEC),
          "2x2": ("pipeline22", mr.PIPE_SPEC22)}


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _spawn(name):
    (shards, replicas), _ = mr.SCENARIOS[name]
    world = shards * replicas
    with tempfile.TemporaryDirectory() as out:
        ss.spawn_local(world, ["--scenario", name, "--out", out],
                       SPAWN_TIMEOUT_S, program=(RANK_SCRIPT,))
        return [(dict(np.load(f"{out}/rank{r}.npz")),
                 json.loads(Path(f"{out}/rank{r}.json").read_text()))
                for r in range(world)]


@pytest.fixture(scope="module")
def meshes():
    """Each mesh's ranks' (arrays, facts), and the one-process port's
    `shard_serve.serve` of the same spec (sync and inline pipeline)."""
    out = {}
    for key, (name, spec) in MESHES.items():
        ranks = _spawn(name)
        with one_thread():
            single = ss.serve(spec, wires=(False,), device="cpu")["off"]
        out[key] = (ranks, single)
    return out


# -------------------------------------------- the inline (deterministic)

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("what", ["answers", "batches", "expiries"])
def test_inline_pipeline_equals_one_process_pipeline(meshes, mesh, what):
    """The lead's uids, tiers and batches (its batch log of sharded
    batches, uids included), its answers and its expiries equal the
    one-process port's inline pipeline on the same calls bit for bit; the
    other ranks answer the sharded requests alike and log the lead's
    batches; accepted == completed on every rank."""
    ranks, single = meshes[mesh]
    want = single["pipeline"]
    want_answers = {k: ss.digest(v) for k, v in want["logits"].items()}
    for r, (_, facts) in enumerate(ranks):
        got = facts["det"]
        c = got["counters"]
        assert c["accepted"] == c["completed"] and c["deterministic"]
        if what == "answers":
            assert got["answers"] and all(want_answers[k] == v
                                          for k, v in got["answers"].items())
            assert got["answers"] == {k: v for k, v in got["sync"].items()
                                      if k in got["answers"]}
            if r == 0:
                assert set(got["answers"]) == set(want_answers)
            assert got["checks"] == want["checks"]
        elif what == "batches":
            assert got["batch_log"] == want["batch_log"]
        else:
            assert got["expired"] == want["expired"] and all(
                got["expired"].values())
    if what == "answers":
        (_, lead), *others = ranks
        grow = {"grow/unsharded"} & set(lead["det"]["answers"])
        for _, facts in others:
            assert set(facts["det"]["answers"]) == set(
                lead["det"]["answers"]) - grow


def _ref_calibration(cal):
    if isinstance(cal, tquant.QuantizedLinear):
        return rquant.QuantizedLinear(**{f: jnp.asarray(getattr(cal, f)
                                                        .numpy())
                                         for f in ("wq", "w_scale",
                                                   "x_scale")})
    if isinstance(cal, dict):
        return {k: _ref_calibration(v) for k, v in cal.items()}
    return jnp.asarray(cal.numpy())


def _ref_engine(spec):
    """The reference engine on the spec's config and weights, with the
    one-process port engine's calibration."""
    ref = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=spec.ladder),
        batch_slots=spec.slots, return_logits=True,
        shard_counts=(spec.shards,), halo_compress=False,
        replica_groups=spec.replicas))
    with one_thread():
        port = ss.build_engine(spec, compress_halo=False, device="cpu")
    for kind in spec.kinds:
        cfg = ss.model_config(kind, spec)
        tiers = {tn: dataclasses.replace(t, use_pallas=False)
                 for tn, t in ss.serving_tiers(cfg.kind).items()}
        ref.register_model(kind, rmodels.GNNConfig(**dataclasses.asdict(
            cfg)), jax.tree_util.tree_map(
                jnp.asarray, ss.model_weights(cfg, spec.seed)), tiers=tiers)
        for tn, c in port.models[kind].calibrations.items():
            ref.models[kind].calibrations[tn] = _ref_calibration(c)
        ref.models[kind].accuracy_delta.update(
            port.models[kind].accuracy_delta)
    return ref


def _rgraph(g):
    return rg.Graph(**dataclasses.asdict(g))


def _ref_burst(ref, spec, sched=None):
    """`shard_serve.run_burst`'s calls on the reference engine, through
    run() or its scheduler: {label: request}."""
    out = {}
    ask = ref.query if sched is None else sched.query
    big = ss.make_graph(spec.nodes, spec)
    gids = {k: ref.attach(_rgraph(big), model=k, calibrate=False)
            for k in spec.kinds}

    def serve(labels):
        if sched is None:
            ref.run()
            done = {r.uid: r for r in ref.finished}
        else:
            done = dict(enumerate(sched.drain()))
        out.update({k: done[u] for k, u in labels.items()})

    labels = {}
    for k, gid in gids.items():
        for tier in ss.TIERS:
            labels[f"{k}/{tier}"] = ask(gid, tier=tier)
        if spec.replicas > 1:
            labels[f"{k}/fp32/2"] = ask(gid, tier="fp32")
    serve(labels)
    if spec.delta:
        labels = {}
        for k in [k for k in spec.kinds if ss.KINDS[k][0] in ("gcn", "gat")]:
            part = ref._sharded[gids[k]][0]
            add, rm = ss._cross_delta(big, part, spec.seed + 30)
            assert ref.update_delta(gids[k], add_edges=add, remove_edges=rm)
            for tier in ss.TIERS:
                labels[f"{k}/{tier}/delta"] = ask(gids[k], tier=tier)
        serve(labels)
    if spec.grow:
        small, mid = (ss.make_graph(n, spec) for n in spec.grow)
        gid = ref.attach(_rgraph(small), model=spec.kinds[0],
                         calibrate=False)
        ref.update(gid, mid.edge_index, mid.num_nodes, mid.features)
        serve({"grow/sharded": ask(gid)})
        ref.update(gid, small.edge_index, small.num_nodes, small.features)
        serve({"grow/unsharded": ask(gid)})
    return out, gids


@pytest.fixture(scope="module")
def references():
    """Per mesh: the reference's sync burst, then its inline pipeline on
    the same engine with the deadline burst, as `shard_serve.serve` makes
    them: ({label: request} of the pipeline, its sharded batches
    [[model, tier, uids], ...] in dispatch order, {label: expired})."""
    out = {}
    for key, (_, spec) in MESHES.items():
        ref = _ref_engine(spec)
        _ref_burst(ref, spec)
        first = len(ref.finished)
        with ref.scheduler(RPC(deterministic=True)) as sched:
            done, gids = _ref_burst(ref, spec, sched)
            dl = {f"{k}/{tier}/deadline": sched.query(gid, tier=tier,
                                                      deadline_ms=0.001)
                  for k, gid in gids.items() for tier in ss.TIERS}
            results = sched.drain()
        expired = {k: bool(results[t].deadline_missed
                           and results[t].preds is None)
                   for k, t in dl.items()}
        log = []
        for r in ref.finished[first:]:
            if not r.shards or r.preds is None:
                continue
            if log and log[-1][3] == r.finished_s:
                log[-1][2].append(r.uid)
            else:
                log.append([r.model, r.tier, [r.uid], r.finished_s])
        out[key] = (done, [e[:3] for e in log], expired)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_inline_pipeline_matches_reference_pipeline(meshes, references,
                                                    mesh):
    """The lead's inline pipeline against the reference's on the same
    calls: equal batches (uids, model, tier), equal expiries, each
    answer's uid and tier equal, logits at the module's bars."""
    ranks, _ = meshes[mesh]
    done, log, expired = references[mesh]
    arrays, lead = ranks[0]
    assert lead["det"]["batch_log"] == log
    assert lead["det"]["expired"] == expired
    got = {k[len("det|"):].replace("|", "/"): v for k, v in arrays.items()
           if k.startswith("det|")}
    assert set(got) == set(done)
    uids = {u for _, _, us in lead["det"]["batch_log"] for u in us}
    for label, lg in got.items():
        want = done[label]
        if want.shards:
            assert want.uid in uids
        want_lg = np.asarray(want.logits)
        if "int8" in label:
            np.testing.assert_allclose(lg, want_lg, atol=WIRE_ATOL, rtol=0)
            assert (lg.argmax(-1) == want_lg.argmax(-1)).mean() >= 0.99
        else:
            np.testing.assert_allclose(lg, want_lg, **TOL)
            np.testing.assert_array_equal(lg.argmax(-1), want_lg.argmax(-1))


# ------------------------------------------------------------ threaded

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("what", ["answers", "uids", "batches", "counts"])
def test_threaded_pipeline_equals_sync_mesh_run(meshes, mesh, what):
    """4 host workers, the followers' host stages slowed by sleeps, a
    2-deep ready buffer on the lead, an `update_delta` and a sharded
    graph attached while the scheduler is open: every rank's answer to each call is bit-equal to
    the sync mesh run() of the same calls, and the two 0.001 ms deadline
    queries expire on every rank in both; each call has one uid on every
    rank (bound at intake, whatever the workers' order); every rank ran
    the lead's batches in its order; every accepted request completed."""
    ranks, _ = meshes[mesh]
    _, lead = ranks[0]
    for r, (arrays, facts) in enumerate(ranks):
        t = facts["threads"]
        if what == "answers":
            labels = [k for k, u in t["pipe"].items() if u is not None]
            assert "late/fp32" in labels and "late/int8" in labels
            assert len(labels) == (24 if r == 0 else 18)
            expired = ["deadline/fp32", "deadline/int8"]
            assert t["pipe_expired"] == t["sync_expired"] == expired
            for k in set(labels) - set(expired):
                np.testing.assert_array_equal(arrays[f"pipe|{k}"],
                                              arrays[f"sync|{k}"])
        elif what == "uids":
            want = lead["threads"]["pipe"]
            assert {k: u for k, u in t["pipe"].items() if u is not None} \
                == {k: u for k, u in want.items()
                    if t["pipe"][k] is not None}
        elif what == "batches":
            assert t["log"] == lead["threads"]["log"]
            assert sorted(u for e in t["log"] for u in e[0]) == sorted(
                u for k, u in lead["threads"]["pipe"].items()
                if k.startswith(("q", "late", "delta")))
        else:
            c = t["counters"]
            assert c["accepted"] == c["completed"] == 24
            assert c["host_workers"] == 4 and not c["deterministic"]


# ----------------------------------------------- clocks and faults (2)

def _clocked(rank):
    with one_thread():
        return mr.clocked_pipeline(mr.decisions_engine(
            rank, ladder=mr.TIERS, max_queue_depth=3))


@pytest.mark.parametrize("what", ["outcomes", "logits", "counters"])
def test_ranks_follow_the_leads_deadlines_tiers_sheds_and_rejects(meshes,
                                                                   what):
    """Ranks whose fake clocks differ: every rank serves each query at the
    tier the lead's router or governor picked, expires what the lead
    expires, and raises `QueueFull` at the same calls, a reject or the
    governor's shed, as a one-process inline pipeline on the lead's
    clock; a rank on the other clock alone decides otherwise."""
    ranks, _ = meshes["2"]
    want, counters = _clocked(0)
    for arrays, facts in ranks:
        got = facts["clocks"]
        if what == "outcomes":
            assert got == {k: v if isinstance(v, str) else list(v[:2])
                           for k, v in want.items()}
        elif what == "logits":
            for k, v in want.items():
                if not isinstance(v, str) and v[2] is not None:
                    np.testing.assert_array_equal(arrays[f"clock|{k}"], v[2])
        else:
            c = facts["clock_counters"]
            assert c["accepted"] == c["completed"] == counters["accepted"]
            assert (c["rejected"], c["shed_requests"]) == (
                counters["rejected"], counters["shed_requests"])
    outcomes = list(want.values())
    assert "reject" in outcomes and "shed" in outcomes
    served = [v for v in outcomes if not isinstance(v, str)]
    assert {t for t, _, _ in served} == {"fp32", "int8"}
    assert any(e for _, e, _ in served) and any(not e for _, e, _ in served)
    other, _ = _clocked(1)
    assert [v if isinstance(v, str) else v[:2] for v in other.values()] != \
        [v if isinstance(v, str) else v[:2] for v in outcomes]


def test_a_follower_whose_host_stage_failed_raises_on_every_rank(meshes):
    """A follower told a uid whose request it never prepared (its host
    stage raised) does not wait for it: every rank raises at that batch,
    from drain() and from close(), within seconds."""
    ranks, _ = meshes["2"]
    (_, lead), (_, other) = ranks
    for key in ("drain", "close"):
        assert "cannot run the lead's batch of uids [1]" in lead["faults"][key]
        assert "planted host-stage fault at uid 1" in other["faults"][key]
    assert max(lead["faults"]["fault_s"], other["faults"]["fault_s"]) < 30


def test_ranks_that_make_different_calls_raise_together(meshes):
    """The lead queries a sharded graph where the other rank submits a
    graph: both raise at that intake (neither binds a uid), then close."""
    ranks, _ = meshes["2"]
    for _, facts in ranks:
        f = facts["faults"]
        assert "made different calls" in f["differ"]
        assert f["uid_after"] == ranks[0][1]["faults"]["uid_after"]
