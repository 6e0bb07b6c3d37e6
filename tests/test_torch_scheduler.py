"""PyTorch port, the two-stage pipeline: `repro_torch.runtime.scheduler`
against the reference's scheduler, and its threaded mode on the CPU.

The deterministic pipeline (one inline worker, no window) must hand the
same requests to the same dispatches as the reference's for GCN, GAT and
SAGE on the fp32 and int8 tiers: equal tickets, uids per dispatch, tiers,
backends and argmax, logits within rtol = atol = 1e-5 (XLA's and ATen's
CPU dots sum in different orders; the reference's calibration is carried
across). Backpressure counters must be equal too. The threaded mode runs
its workers and dispatcher on the CPU (no streams there): errors, close,
and a 60-operation interleave of attach, update, update_delta, query,
detach and submit with exactly-once completion, no recompile and
conserved counters. Every threaded test drains with a timeout, so a
deadlock fails its test instead of hanging the suite.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import graph as rg
from repro.core import models as rmodels
from repro.runtime import gnn_server as rserve
from repro.runtime import scheduler as rsched
from repro_torch import bridge
from repro_torch.core import graph as tg
from repro_torch.core import models as tmodels
from repro_torch.data.graphs import planetoid_like
from repro_torch.runtime import gnn_server as tserve
from repro_torch.runtime import scheduler as tsched

TOL = dict(rtol=1e-5, atol=1e-5)
IN_FEATS, HIDDEN, CLASSES, HEADS = 16, 16, 4, 4
BUCKETS = (128, 256)
DRAIN_S = 60.0


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


def _graph(n, seed, pkg="torch"):
    g = planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=IN_FEATS,
                       num_classes=CLASSES, seed=seed, train_per_class=2)
    return rg.Graph(**dataclasses.asdict(g)) if pkg == "jax" else g


def _cfg(pkg, kind):
    cls = rmodels.GNNConfig if pkg == "jax" else tmodels.GNNConfig
    return cls(kind=kind, in_feats=IN_FEATS, hidden=HIDDEN,
               num_classes=CLASSES, heads=HEADS)


def _weights(kind, seed):
    p = rmodels.init_params(jax.random.PRNGKey(seed), _cfg("jax", kind))
    return jax.tree_util.tree_map(np.asarray, p)


def _calibration_numpy(cal):
    """A reference calibration (nested dicts of QuantizedLinear) as the
    numpy dicts `bridge.calibration_from_jax` takes."""
    if isinstance(cal, dict):
        return {k: _calibration_numpy(v) for k, v in cal.items()}
    if hasattr(cal, "wq"):
        return {"wq": np.asarray(cal.wq), "w_scale": np.asarray(cal.w_scale),
                "x_scale": np.asarray(cal.x_scale)}
    return np.asarray(cal)


def _port_engine(*kinds, batch_slots=2, tiers=None):
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=batch_slots,
        return_logits=True), seed=0, device="cpu")
    for i, kind in enumerate(kinds):
        eng.register_model(kind, _cfg("torch", kind), bridge.params_from_jax(
            _weights(kind, i), device="cpu"), tiers=tiers)
    eng.warmup()
    return eng


_PAIRS = {}


def _pair(kind):
    """The reference's and the port's engine for one kind: a model "m"
    with fp32 and int8 tiers, warm, the port on the reference's
    calibration. Shared by the parity tests of the kind."""
    if kind in _PAIRS:
        return _PAIRS[kind]
    ref = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=BUCKETS), batch_slots=2,
        return_logits=True), seed=0)
    port = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=2,
        return_logits=True), seed=0, device="cpu")
    w = _weights(kind, 3)
    ref.register_model("m", _cfg("jax", kind),
                       jax.tree_util.tree_map(jax.numpy.asarray, w),
                       tiers=("fp32", "int8"))
    port.register_model("m", _cfg("torch", kind),
                        bridge.params_from_jax(w, device="cpu"),
                        tiers=("fp32", "int8"))
    ref.warmup()
    port.warmup()
    ref.calibrate("m", _graph(120, 77, "jax"))
    for tier, cal in ref.models["m"].calibrations.items():
        port.models["m"].calibrations[tier] = bridge.calibration_from_jax(
            _calibration_numpy(cal), device="cpu")
    port.models["m"].accuracy_delta.update(ref.models["m"].accuracy_delta)
    _PAIRS[kind] = (ref, port)
    return ref, port


def _pipelined(pkg, eng, tier):
    """One request script through the deterministic scheduler, with small
    queue bounds so inline backpressure interleaves host work and
    dispatches. Returns tickets, uids per dispatch, the drained requests
    and the scheduler's counters."""
    mod = rsched if pkg == "jax" else tsched
    batches = []
    execute = eng._execute_batch

    def record(batch):
        batches.append([r.uid for r in batch])
        execute(batch)
    eng._execute_batch = record
    try:
        gid = eng.attach(_graph(150, 5, pkg), model="m", calibrate=False)
        sched = mod.PipelineScheduler(eng, mod.PipelineConfig(
            deterministic=True, max_pending=3, max_ready=3))
        tickets = []
        for i, n in enumerate((40, 90, 130, 200, 60, 250, 110)):
            tickets.append(sched.submit(
                _graph(n, 10 + i, pkg), model="m", tier=tier,
                fusion="layer" if i % 2 else None))
            if i % 3 == 1:
                tickets.append(sched.query(gid, tier=tier,
                                           fusion="layer" if i > 3 else None))
        out = sched.drain()
        sched.close()
        eng.detach(gid)
    finally:
        del eng._execute_batch
    return tickets, batches, out, dict(sched.metrics)


@pytest.mark.parametrize("tier", ["fp32", "int8"])
@pytest.mark.parametrize("kind", ["gcn", "gat", "sage"])
def test_deterministic_pipeline_equals_reference(kind, tier):
    ref, port = _pair(kind)
    r_tickets, r_batches, r_out, r_m = _pipelined("jax", ref, tier)
    t_tickets, t_batches, t_out, t_m = _pipelined("torch", port, tier)
    assert t_tickets == r_tickets
    assert t_batches == r_batches
    assert any(len(b) < 2 for b in t_batches) and len(t_batches) > 3
    assert ({k: t_m[k] for k in ("accepted", "completed", "blocked")}
            == {k: r_m[k] for k in ("accepted", "completed", "blocked")})
    assert t_m["blocked"] > 0
    assert len(t_out) == len(r_out) == len(t_tickets)
    for got, want in zip(t_out, r_out):
        assert ((got.uid, got.model, got.bucket, got.tier, got.backend,
                 got.fusion) == (want.uid, want.model, want.bucket,
                                 want.tier, want.backend, want.fusion))
        assert got.tier == tier
        np.testing.assert_array_equal(got.preds, want.preds)
        np.testing.assert_allclose(got.logits, want.logits, **TOL)
    port.assert_warm()
    assert port.summary()["tier_fallbacks"] == 0


def _reject_script(pkg, eng):
    mod = rsched if pkg == "jax" else tsched
    sched = mod.PipelineScheduler(eng, mod.PipelineConfig(
        deterministic=True, max_pending=2, backpressure="reject"))
    sched.submit(_graph(40, 0, pkg), model="m")
    sched.submit(_graph(41, 1, pkg), model="m")
    with pytest.raises(mod.QueueFull):
        sched.submit(_graph(42, 2, pkg), model="m")
    out = sched.drain()
    sched.close()
    return dict(sched.metrics, host_busy_s=None), [r.uid for r in out]


def _block_script(pkg, eng):
    mod = rsched if pkg == "jax" else tsched
    sched = mod.PipelineScheduler(eng, mod.PipelineConfig(
        deterministic=True, max_pending=2, max_ready=2,
        backpressure="block"))
    for i in range(7):
        sched.submit(_graph(40 + i, i, pkg), model="m")
    blocked = sched.metrics["blocked"]
    out = sched.drain()
    sched.close()
    return blocked, dict(sched.metrics, host_busy_s=None), [r.uid
                                                             for r in out]


@pytest.mark.parametrize("script", [_reject_script, _block_script])
def test_backpressure_counters_equal_reference(script):
    ref, port = _pair("gcn")
    got, want = script("torch", port), script("jax", ref)
    assert got == want
    if script is _block_script:
        assert got[0] == 5                  # submits 3..7 hit the bound
    else:
        assert got[0]["rejected"] == 1 and got[0]["accepted"] == 2
    port.assert_warm()


# ------------------------------------------------------------ threaded mode


def test_drain_reraises_the_earliest_error_once():
    eng = _port_engine("gcn")
    sched = eng.scheduler(tsched.PipelineConfig(host_workers=2,
                                                window_ms=0.0))
    sched.submit(_graph(40, 0), model="gcn")
    sched.query(999)                        # no such graph: ticket 1
    sched.query(998)                        # ticket 2
    with pytest.raises(KeyError) as err:
        sched.drain(timeout=DRAIN_S)
    assert err.value.args == (999,)
    out = sched.drain(timeout=DRAIN_S)      # consumed: results are live
    sched.close()
    assert len(out) == 1 and out[0].done and out[0].preds is not None
    assert sched.metrics["completed"] == sched.metrics["accepted"] == 3


def test_close_is_idempotent_and_the_engine_survives():
    eng = _port_engine("gcn")
    sched = eng.scheduler(tsched.PipelineConfig(host_workers=1))
    sched.submit(_graph(40, 0), model="gcn")
    sched.drain(timeout=DRAIN_S)
    sched.close()
    sched.close()
    assert sched._threads == []
    with pytest.raises(RuntimeError):
        sched.submit(_graph(41, 1), model="gcn")
    eng.submit(_graph(42, 2), model="gcn")  # the sync path still serves
    eng.run()
    eng.assert_warm()
    assert len(eng.finished) == 2
    det = eng.scheduler(tsched.PipelineConfig(deterministic=True))
    det.close()
    det.close()


def test_threaded_pipeline_equals_sync_path():
    """Two workers and a window: the batches depend on thread timing, but
    every answer equals the sync path's for the same graph."""
    graphs = [_graph(30 + 23 * i, i) for i in range(10)]
    sync = _port_engine("gcn", "gat")
    uids = [sync.submit(g, model="gcn" if i % 2 else "gat")
            for i, g in enumerate(graphs)]
    want = {r.uid: r for r in sync.run()}
    eng = _port_engine("gcn", "gat")
    with eng.scheduler(tsched.PipelineConfig(host_workers=2, window_ms=1.0,
                                             max_pending=2,
                                             max_ready=2)) as sched:
        tickets = [sched.submit(g, model="gcn" if i % 2 else "gat")
                   for i, g in enumerate(graphs)]
        out = sched.drain(timeout=DRAIN_S)
    eng.assert_warm()
    assert len(out) == len(tickets) == 10
    assert sched.metrics["completed"] == sched.metrics["accepted"] == 10
    s = sched.summary()["pipeline"]
    assert s["host_workers"] == 2 and s["host_busy_s"] > 0
    by_graph = {i: r for i, r in zip(tickets, out)}
    for i, uid in enumerate(uids):
        got = by_graph[i]
        assert got.model == want[uid].model
        np.testing.assert_array_equal(got.preds, want[uid].preds)
        np.testing.assert_allclose(got.logits, want[uid].logits,
                                   rtol=1e-6, atol=1e-6)


def _edge_pairs(rng, n, k):
    i = rng.integers(0, n, size=k)
    j = rng.integers(0, n, size=k)
    keep = i != j
    return np.stack([i[keep], j[keep]], axis=1)


def test_soak_interleaved_lifecycle_under_threaded_scheduler():
    """60 interleaved operations over two models under the threaded
    scheduler: attach, update, update_delta, query, detach and submit.
    Every accepted request completes once, nothing recompiles, and the
    counters are conserved."""
    rng = np.random.default_rng(7)
    eng = _port_engine("gcn", "gat", tiers=("fp32", "int8", "int8+grax"))
    eng.calibrate("gcn", _graph(80, 100))
    eng.calibrate("gat", _graph(80, 101))
    sizes = {}

    def attach(model, n, seed):
        gid = eng.attach(_graph(n, seed), model=model, calibrate=False)
        sizes[gid] = n
        return gid

    gids = {"gcn": [attach("gcn", 60, 1)], "gat": [attach("gat", 70, 2)]}
    tiers = (None, "fp32", "int8", "int8+grax")
    trail, tickets, ops = [], [], []
    with eng.scheduler(tsched.PipelineConfig(host_workers=2, window_ms=1.0,
                                             max_pending=8,
                                             max_ready=8)) as sched:
        for step in range(60):
            model = "gcn" if rng.random() < 0.5 else "gat"
            op = str(rng.choice(["submit", "query", "query", "update",
                                 "delta", "cycle"]))
            ops.append(op)
            tier = tiers[rng.integers(len(tiers))]
            if op == "submit":
                tickets.append(sched.submit(
                    _graph(int(rng.integers(20, 180)), 1000 + step),
                    model=model, tier=tier))
            elif op == "query":
                # the long-lived graph (gid[0] is never detached): a query
                # racing a detach of its own graph is a host-stage error
                tickets.append(sched.query(gids[model][0], tier=tier))
            elif op == "update":
                n = int(rng.integers(20, 180))
                g = _graph(n, 2000 + step)
                eng.update(gids[model][0], g.edge_index, g.num_nodes,
                           g.features)
                sizes[gids[model][0]] = n
            elif op == "delta":
                n = sizes[gids[model][0]]
                eng.update_delta(gids[model][0],
                                 add_edges=_edge_pairs(rng, n, 4),
                                 remove_edges=_edge_pairs(rng, n, 2))
            else:                                # detach + reattach
                if len(gids[model]) > 1:
                    eng.detach(gids[model].pop())
                gids[model].append(attach(model, int(rng.integers(20, 180)),
                                          3000 + step))
            with eng._lock:
                trail.append((eng.metrics["operand_bytes_h2d"],
                              eng.metrics["operand_cache_hits"],
                              eng.metrics["operand_cache_misses"],
                              eng.metrics["delta_updates"]))
        out = sched.drain(timeout=DRAIN_S)
    eng.assert_warm()
    assert {"submit", "query", "update", "delta", "cycle"} <= set(ops)
    assert sched.metrics["completed"] == sched.metrics["accepted"]
    assert len(out) == len(tickets) == len(eng.finished)
    assert len({r.uid for r in out}) == len(out)
    assert all(r.done and r.preds is not None for r in out)
    assert all(r.preds.shape == (r.pg.num_nodes,) for r in out)
    m = eng.metrics
    assert m["slots_filled"] == len(out) <= m["slots_total"]
    assert m["slots_total"] == m["batches"] * eng.sc.batch_slots
    assert len(m["latency_s"]) == len(out)
    assert m["delta_updates"] + m["delta_fallbacks"] == ops.count("delta")
    for a, b in zip(trail, trail[1:]):            # never decrease
        assert all(y >= x for x, y in zip(a, b))
    assert {r.tier for r in out} >= {"fp32", "int8"}
    s = sched.summary()
    assert s["requests"] == len(out)
    assert s["pipeline"]["completed"] == s["pipeline"]["accepted"]
