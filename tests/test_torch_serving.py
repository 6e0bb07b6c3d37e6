"""PyTorch port, the slices as a whole: `repro_torch`'s GraphServe against
the reference GraphServe (`use_cacheg=False`) on the same graphs and
weights, in both fusion modes and with the `use_pallas` models, on the fp32
tier and on the QuantGr int8 tier (the reference's calibration carried
across by `bridge.calibration_from_jax`); plan parity; tier fallback and
calibration bookkeeping; the zero-recompile contract; the device rule.

Tolerance: rtol=atol=1e-5 on logits (XLA's and ATen's CPU dots sum in
different orders, and XLA's CPU jit contracts the int8 epilogue into an
FMA); batch composition, uids and argmax must be equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as rg
from repro.core import layers as rlayers
from repro.core import models as rmodels
from repro.runtime import gnn_server as rserve
from repro_torch import bridge
from repro_torch.core import graph as tg
from repro_torch.core import layers as tlayers
from repro_torch.core import models as tmodels
from repro_torch.data.graphs import planetoid_like
from repro_torch.runtime import gnn_server as tserve

TOL = dict(rtol=1e-5, atol=1e-5)
IN_FEATS, HIDDEN, CLASSES = 32, 16, 4
BUCKETS, SLOTS = (128, 256), 2
SIZES = (40, 90, 130, 200, 250, 60)
BASE = dict(stagr=True, grad_dynamic=True, graphsplit=True)
# (name, register kwargs minus techniques, Techniques flags)
MODELS = (("gcn", dict(fusion="layer"), BASE),
          ("gcn_none", dict(), BASE),
          ("gcn_mm", dict(), dict(BASE, use_pallas=True)))


def _weights(seed=0):
    rng = np.random.default_rng(seed)

    def lin(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)
                      ).astype(np.float32),
                "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
    return {"l1": lin(IN_FEATS, HIDDEN), "l2": lin(HIDDEN, CLASSES)}


def _graph(n, seed):
    return planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=IN_FEATS,
                          num_classes=CLASSES, seed=seed, train_per_class=2)


def _jax_params(w):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
            for k, v in w.items()}


def _serve(pkg, engine, weights):
    """Drive one engine through the same request script; returns the
    dispatched batches (uid lists) and the finished requests."""
    graph_cls = rg.Graph if pkg == "jax" else tg.Graph
    cfg_cls = rmodels.GNNConfig if pkg == "jax" else tmodels.GNNConfig
    tech_cls = rlayers.Techniques if pkg == "jax" else tlayers.Techniques
    cfg = cfg_cls(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                  num_classes=CLASSES)
    params = (_jax_params(weights) if pkg == "jax"
              else bridge.params_from_jax(weights, device="cpu"))
    for name, kw, flags in MODELS:
        engine.register_model(name, cfg, params, techniques=tech_cls(**flags),
                              **kw)
    batches = []
    execute = engine._execute_batch

    def record(batch):
        batches.append([r.uid for r in batch])
        execute(batch)
    engine._execute_batch = record
    for i, n in enumerate(SIZES):
        g = _graph(n, i)
        for name, _, _ in MODELS:
            engine.submit(graph_cls(**dataclasses.asdict(g)), model=name)
    gid = engine.attach(graph_cls(**dataclasses.asdict(_graph(110, 99))),
                        model="gcn")
    engine.query(gid)
    engine.query(gid, fusion="none")
    return batches, engine.run()


@pytest.fixture(params=["interpret", "ref"])
def kernel_mode(request, monkeypatch):
    if request.param == "ref":
        monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    else:
        monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)
        monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    return request.param


def test_graphserve_matches_reference(kernel_mode):
    weights = _weights()
    ref_eng = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True, use_cacheg=False))
    port = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True), device="cpu")
    ref_batches, ref_done = _serve("jax", ref_eng, weights)
    got_batches, got_done = _serve("torch", port, weights)
    assert got_batches == ref_batches
    assert len(got_batches) > len(SIZES)          # partial batches occurred
    assert [r.uid for r in got_done] == [r.uid for r in ref_done]
    for got, ref in zip(got_done, ref_done):
        assert (got.model, got.bucket, got.fusion) == (ref.model, ref.bucket,
                                                       ref.fusion)
        np.testing.assert_array_equal(got.preds, ref.preds)
        np.testing.assert_allclose(got.logits, ref.logits, **TOL)
    s = port.summary()
    assert s["requests"] == len(ref_done)
    assert s["batches"] == len(ref_batches)


@pytest.mark.parametrize("batch_size", [0, 2])
@pytest.mark.parametrize("fusion", ["none", "layer"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_plan_matches_reference(kernel_mode, batch_size, fusion, use_pallas):
    weights = _weights(1)
    graphs = [_graph(n, 10 + i) for i, n in enumerate((70, 128))]
    t_flags = dict(BASE, use_pallas=use_pallas)
    rcfg = rmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                             num_classes=CLASSES)
    tcfg = tmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                             num_classes=CLASSES)
    pgs = [tg.pad_graph(g, capacity=128) for g in graphs]
    if not batch_size:
        pgs = pgs[:1]
    r_ops = [rmodels.build_operands(rg.PaddedGraph(**dataclasses.asdict(p)),
                                    rcfg, lean=True) for p in pgs]
    t_ops = [tmodels.build_operands(p, tcfg, device="cpu") for p in pgs]
    x = np.stack([p.features for p in pgs])
    if batch_size:
        r_args = (jnp.asarray(x), rmodels.stack_operands(r_ops))
        t_args = (torch.from_numpy(x), tmodels.stack_operands(t_ops))
    else:
        r_args = (jnp.asarray(x[0]), r_ops[0])
        t_args = (torch.from_numpy(x[0]), t_ops[0])
    rplan = rmodels.build_plan(rcfg, 128, rlayers.Techniques(**t_flags),
                               batch_size=batch_size, fusion=fusion)
    tplan = tmodels.build_plan(tcfg, 128, tlayers.Techniques(**t_flags),
                               batch_size=batch_size, fusion=fusion,
                               device="cpu")
    want = np.asarray(rplan(_jax_params(weights), *r_args))
    got = tplan(bridge.params_from_jax(weights, device="cpu"), *t_args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tplan.key[1:3] == rplan.key[1:3] and tplan.key[4:] == rplan.key[4:]


def _port_engine(use_cacheg=True, **kw):
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        use_cacheg=use_cacheg), **kw)
    cfg = tmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                            num_classes=CLASSES)
    eng.register_model("gcn", cfg, fusion="layer")
    eng.register_model("gcn_mm", cfg, techniques=tlayers.Techniques(
        **BASE, use_pallas=True))
    return eng


def test_assert_warm_holds_after_warmup_and_catches_new_shapes():
    eng = _port_engine(device="cpu", use_cacheg=False)
    with pytest.raises(AssertionError, match="warmup"):
        eng.assert_warm()
    # per bucket: gcn_mm's two fusion modes plus gcn's two
    assert eng.warmup() == 2 * len(BUCKETS) * 2
    for i, n in enumerate((30, 100, 140, 255, 20)):
        eng.submit(_graph(n, i), model="gcn" if i % 2 else "gcn_mm")
    gid = eng.attach(_graph(60, 7), model="gcn_mm")
    for _ in range(3):
        eng.query(gid)
    done = eng.run()
    assert len(done) == 8 and all(r.done for r in done)
    eng.assert_warm()
    s = eng.summary()
    # one upload per submit plus one for the attached graph's first query
    assert s["operand_bytes_h2d"] == 4 * (128 ** 2 * 4 + 256 ** 2 * 2)
    assert s["batch_occupancy"] == 8 / (2 * s["batches"])
    # a plan called at a shape warmup never saw counts a new trace
    plan = eng.plan_for("gcn", 128, fusion="layer")
    ops = tmodels.stack_operands([tmodels.build_operands(
        tg.pad_graph(_graph(60, 7), capacity=128), eng.models["gcn"].cfg,
        device="cpu")] * 3)
    plan(eng.models["gcn"].params, torch.zeros(3, 128, IN_FEATS), ops)
    with pytest.raises(AssertionError, match="recompile"):
        eng.assert_warm()


def test_detach_drops_cached_operands():
    eng = _port_engine(device="cpu")
    gid = eng.attach(_graph(60, 1), model="gcn")
    eng.query(gid)
    eng.query(gid)
    assert len(eng._operands) == 1
    eng.detach(gid)
    assert not eng._operands and gid not in eng.graphs
    assert len(eng.run()) == 2


def test_graphserve_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.GraphServe()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.build_plan(tmodels.GNNConfig(kind="gcn", in_feats=8), 128,
                           tlayers.Techniques())


def test_unported_surfaces_raise():
    # CacheG is ported: the default engine constructs on it and serves
    cacheg = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=(128,)), batch_slots=SLOTS),
        device="cpu")
    assert cacheg.sc.use_cacheg and tserve.GraphServeConfig().use_cacheg
    cacheg.register_model("gcn", tmodels.GNNConfig(kind="gcn",
                                                   in_feats=IN_FEATS))
    cacheg.warmup()
    cacheg.submit(_graph(60, 1), model="gcn")
    assert cacheg.run()[0].preds.shape == (60,)
    assert cacheg.summary()["operand_bytes_h2d"] == (
        tg.triangular_nbits(128) // 8 + 128 * 4 + 4)
    cacheg.assert_warm()
    # GrAd deltas, the SLO arguments and sharding are ported
    assert callable(cacheg.update_delta)
    uid = cacheg.submit(_graph(60, 1), model="gcn", deadline_ms=5e6,
                        tolerance=1.0)
    late = cacheg.run()[-1]
    assert late.uid == uid and late.preds is not None
    assert not late.deadline_missed
    sharded = tserve.GraphServeConfig(shard_counts=(2,))
    assert sharded.shard_counts == (2,) and sharded.replica_groups == 1
    eng = tserve.GraphServe(device="cpu")
    cfg = tmodels.GNNConfig(kind="gcn", in_feats=8)
    eng.register_model("q", cfg, tiers=("fp32", "int8"))     # ported now
    with pytest.raises(ValueError, match="agg_backend"):
        eng.register_model("s", cfg, agg_backend="sparse")
    eng.register_model("a", tmodels.GNNConfig(kind="sage", in_feats=8))
    with pytest.raises(ValueError, match="unknown model kind"):
        eng.register_model("u", tmodels.GNNConfig(kind="gin", in_feats=8))
    eng.register_model("ok", cfg, tiers=("fp32",))
    assert list(eng.models) == ["q", "a", "ok"]
    assert set(eng.models["q"].tiers) == {"fp32", "int8"}


def test_batch_selection_rules_match_reference():
    rng = np.random.default_rng(5)
    for _ in range(200):
        keys = {(f"m{rng.integers(3)}", int(rng.choice(BUCKETS)), "fp32",
                 "dense", str(rng.choice(["none", "layer"])), 0)
                for _ in range(rng.integers(1, 6))}
        stats = {k: (int(rng.integers(1, 6)), int(rng.integers(0, 50)))
                 for k in keys}
        edf = {k: (*v, float(rng.choice([np.inf, rng.random()])))
               for k, v in stats.items()}
        last = {f"m{i}": int(rng.integers(0, 9)) for i in range(3)}
        assert (tserve.best_fill_key(stats, 4, last)
                == rserve.best_fill_key(stats, 4, last))
        assert (tserve.edf_best_fill_key(edf, 4, last)
                == rserve.edf_best_fill_key(edf, 4, last))


# ---------------------------------------------------------- QuantGr tiers
Q_MODELS = (  # (name, register kwargs, fp32 flags, int8 flags or None)
    ("gcn_q", dict(fusion="layer"), None),
    ("gcn_q_none", dict(), None),
    ("gcn_qmm", dict(), dict(BASE, use_pallas=True)))


def _register_quant(pkg, engine, weights):
    cfg_cls = rmodels.GNNConfig if pkg == "jax" else tmodels.GNNConfig
    tech_cls = rlayers.Techniques if pkg == "jax" else tlayers.Techniques
    cfg = cfg_cls(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                  num_classes=CLASSES)
    params = (_jax_params(weights) if pkg == "jax"
              else bridge.params_from_jax(weights, device="cpu"))
    for name, kw, flags in Q_MODELS:
        if flags is None:
            tiers = ("fp32", "int8", "int8+grax")
        else:
            tiers = {"fp32": tech_cls(**flags),
                     "int8": tech_cls(**flags, quantgr=True)}
        engine.register_model(name, cfg, params, tiers=tiers,
                              default_tier="int8", **kw)


def _calibration_numpy(cal):
    """The reference's calibrate_tier output as the numpy tree
    `bridge.calibration_from_jax` takes."""
    return {k: ({"wq": np.asarray(v.wq), "w_scale": np.asarray(v.w_scale),
                 "x_scale": np.asarray(v.x_scale)}
                if hasattr(v, "wq") else np.asarray(v))
            for k, v in cal.items()}


def _serve_quant(pkg, engine):
    """One mixed-tier request script; returns batches and finished."""
    graph_cls = rg.Graph if pkg == "jax" else tg.Graph
    batches = []
    execute = engine._execute_batch

    def record(batch):
        batches.append([r.uid for r in batch])
        execute(batch)
    engine._execute_batch = record
    for i, n in enumerate(SIZES):
        g = graph_cls(**dataclasses.asdict(_graph(n, 20 + i)))
        for name, _, _ in Q_MODELS:
            engine.submit(g, model=name)
        engine.submit(g, model="gcn_q", tier="fp32")
    gid = engine.attach(graph_cls(**dataclasses.asdict(_graph(110, 98))),
                        model="gcn_q")
    engine.query(gid)
    engine.query(gid, fusion="none")
    engine.query(gid, tier="int8+grax")
    return batches, engine.run()


def test_int8_tier_serving_matches_reference(kernel_mode):
    weights = _weights(2)
    cal_graph = _graph(230, 77)
    ref_eng = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True, use_cacheg=False))
    port = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True), device="cpu")
    _register_quant("jax", ref_eng, weights)
    _register_quant("torch", port, weights)
    for name, _, _ in Q_MODELS:
        ref_eng.calibrate(name, rg.Graph(**dataclasses.asdict(cal_graph)))
        for tier, cal in ref_eng.models[name].calibrations.items():
            port.models[name].calibrations[tier] = (
                bridge.calibration_from_jax(_calibration_numpy(cal),
                                            device="cpu"))
    ref_batches, ref_done = _serve_quant("jax", ref_eng)
    got_batches, got_done = _serve_quant("torch", port)
    assert got_batches == ref_batches
    assert [r.uid for r in got_done] == [r.uid for r in ref_done]
    tiers_seen = set()
    for got, ref in zip(got_done, ref_done):
        assert (got.model, got.bucket, got.tier, got.fusion) == (
            ref.model, ref.bucket, ref.tier, ref.fusion)
        tiers_seen.add(got.tier)
        np.testing.assert_array_equal(got.preds, ref.preds)
        np.testing.assert_allclose(got.logits, ref.logits, **TOL)
    assert tiers_seen == {"fp32", "int8", "int8+grax"}
    s, rs = port.summary(), ref_eng.summary()
    assert s["tier_fallbacks"] == rs["tier_fallbacks"] == 0
    assert ({k: v["requests"] for k, v in s["tiers"].items()}
            == {k: v["requests"] for k, v in rs["tiers"].items()})
    # the attached graph's int8 Â was derived once for its three queries
    assert len(port._tier_operands) == 1


@pytest.mark.parametrize("batch_size", [0, 2])
@pytest.mark.parametrize("fusion", ["none", "layer"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_quant_plan_matches_reference(kernel_mode, batch_size, fusion,
                                      use_pallas):
    weights = _weights(3)
    graphs = [_graph(n, 30 + i) for i, n in enumerate((90, 128))]
    t_flags = dict(BASE, quantgr=True, use_pallas=use_pallas)
    rcfg = rmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                             num_classes=CLASSES)
    tcfg = tmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                             num_classes=CLASSES)
    pgs = [tg.pad_graph(g, capacity=128) for g in graphs]
    if not batch_size:
        pgs = pgs[:1]
    r_ops = [rmodels.build_operands(rg.PaddedGraph(**dataclasses.asdict(p)),
                                    rcfg, lean=True) for p in pgs]
    t_ops = [tmodels.build_operands(p, tcfg, device="cpu") for p in pgs]
    cal = rmodels.calibrate_tier(_jax_params(weights), rcfg,
                                 jnp.asarray(pgs[0].features), r_ops[0])
    t_cal = bridge.calibration_from_jax(_calibration_numpy(cal),
                                        device="cpu")
    derive = rmodels.build_agg_quantizer()   # the engine's compiled deriver
    r_tops = [derive(o.norm_adj) for o in r_ops]
    t_tops = [tmodels.derive_tier_operands(o.norm_adj) for o in t_ops]
    for r, t in zip(r_tops, t_tops):
        np.testing.assert_array_equal(t.agg_aq.numpy(), np.asarray(r.agg_aq))
        np.testing.assert_array_equal(t.agg_a_scale.numpy(),
                                      np.asarray(r.agg_a_scale))
    x = np.stack([p.features for p in pgs])
    if batch_size:
        r_args = (jnp.asarray(x), rmodels.stack_operands(r_ops), cal,
                  rmodels.stack_tier_operands(r_tops))
        t_args = (torch.from_numpy(x), tmodels.stack_operands(t_ops), t_cal,
                  tmodels.stack_tier_operands(t_tops))
    else:
        r_args = (jnp.asarray(x[0]), r_ops[0], cal, r_tops[0])
        t_args = (torch.from_numpy(x[0]), t_ops[0], t_cal, t_tops[0])
    rplan = rmodels.build_plan(rcfg, 128, rlayers.Techniques(**t_flags),
                               batch_size=batch_size, fusion=fusion)
    tplan = tmodels.build_plan(tcfg, 128, tlayers.Techniques(**t_flags),
                               batch_size=batch_size, fusion=fusion,
                               device="cpu")
    want = np.asarray(rplan(_jax_params(weights), *r_args))
    got = tplan(bridge.params_from_jax(weights, device="cpu"), *t_args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got.numpy().argmax(-1).tolist() == want.argmax(-1).tolist()
    # without tier operands the forward quantizes Â itself: same answer
    no_tops = tplan(bridge.params_from_jax(weights, device="cpu"),
                    *t_args[:3])
    assert torch.equal(no_tops, got)
    assert tplan.trace_count == 2          # a new argument structure


def _quant_engine(**kw):
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True), device="cpu", **kw)
    _register_quant("torch", eng, _weights(4))
    return eng


def test_uncalibrated_quant_tier_falls_back_to_fp32_like_reference():
    weights = _weights(4)
    ref_eng = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True, use_cacheg=False))
    _register_quant("jax", ref_eng, weights)
    port = _quant_engine()
    served = {}
    for pkg, eng, graph_cls in (("jax", ref_eng, rg.Graph),
                                ("torch", port, tg.Graph)):
        g = graph_cls(**dataclasses.asdict(_graph(70, 5)))
        eng.submit(g, model="gcn_q")               # default int8: falls back
        eng.submit(g, model="gcn_qmm", tier="int8")
        eng.submit(g, model="gcn_q", tier="fp32")  # asked for: no fallback
        done = eng.run()
        served[pkg] = [(r.tier, r.preds.tolist()) for r in done]
        assert eng.summary()["tier_fallbacks"] == 2
        assert [r.tier for r in done] == ["fp32"] * 3
        eng.calibrate("gcn_q", graph_cls(**dataclasses.asdict(_graph(200,
                                                                      6))))
        eng.submit(g, model="gcn_q")
        assert eng.run()[-1].tier == "int8"
        assert eng.summary()["tier_fallbacks"] == 2
    assert served["torch"] == served["jax"]
    # the fallback answered exactly what the fp32 tier answers
    logits = [r.logits for r in port.finished[:3]]
    np.testing.assert_array_equal(logits[0], logits[2])


def test_calibration_runs_once_per_model_and_tier():
    eng = _quant_engine()
    assert eng.models["gcn_q"].calibrations == {}
    deltas = eng.calibrate("gcn_q", _graph(200, 1))
    assert set(deltas) == {"int8", "int8+grax"}
    e = eng.models["gcn_q"]
    cal = e.calibrations["int8"]
    assert e.calibrations["int8+grax"] is cal      # alias shares one
    assert set(cal) == {"l1", "l2", "agg1_h", "agg2_h"}
    assert cal["l1"].wq.dtype == torch.int8
    # another graph, or an attach, changes nothing ...
    assert eng.calibrate("gcn_q", _graph(90, 2)) == deltas
    eng.attach(_graph(120, 3), model="gcn_q")
    assert e.calibrations["int8"] is cal
    # ... unless forced
    eng.calibrate("gcn_q", _graph(90, 2), force=True)
    assert e.calibrations["int8"] is not cal
    assert not torch.equal(e.calibrations["int8"]["agg1_h"], cal["agg1_h"])
    # attach calibrates a model that nobody calibrated yet, unless told not
    eng.attach(_graph(120, 3), model="gcn_qmm", calibrate=False)
    assert eng.models["gcn_qmm"].calibrations == {}
    eng.attach(_graph(120, 3), model="gcn_qmm")
    assert set(eng.models["gcn_qmm"].calibrations) == {"int8"}
    s = eng.summary()["accuracy_delta_vs_fp32"]
    assert set(s) == {"gcn_q", "gcn_qmm"}


def test_int8_grax_shares_the_int8_plan():
    eng = _quant_engine()
    for fusion in ("none", "layer"):
        assert (eng.plan_for("gcn_q", 128, "int8+grax", fusion=fusion)
                is eng.plan_for("gcn_q", 128, "int8", fusion=fusion))
    assert (eng.plan_for("gcn_q", 128, "int8")
            is not eng.plan_for("gcn_q", 128, "fp32"))
    # gcn_q and gcn_q_none share every plan; gcn_qmm has its own two tiers:
    # (2 + 2) plans x 2 fusions x 2 buckets, plus one deriver trace, one
    # CacheG materializer trace and the delta patcher's two (the operand
    # patch and the int8 row re-quantization) per bucket
    assert eng.warmup() == 4 * 2 * 2 + 2 + 2 + 2 * 2
    assert len({p.key for p in eng._plans.values()}) == 8 * 2


def test_assert_warm_after_mixed_tier_traffic():
    eng = _quant_engine()
    blobs = eng.warmup()              # quant tiers warm on a placeholder
    assert eng.models["gcn_q"].calibrations == {}
    for name, _, _ in Q_MODELS:
        eng.calibrate(name, _graph(200, 1))
    gid = eng.attach(_graph(60, 2), model="gcn_qmm")
    for i, n in enumerate((30, 100, 140, 255)):
        g = _graph(n, 10 + i)
        eng.submit(g, model="gcn_q", tier=("fp32", "int8", "int8+grax")[i % 3])
        eng.submit(g, model="gcn_q_none", fusion="layer")
        eng.submit(g, model="gcn_qmm", tier="fp32" if i % 2 else None)
        eng.query(gid, tier="int8" if i % 2 else "fp32",
                  fusion="layer" if i < 2 else None)
    done = eng.run()
    assert len(done) == 16 and all(r.done for r in done)
    assert {r.tier for r in done} == {"fp32", "int8", "int8+grax"}
    eng.assert_warm()
    assert eng.compiled_blobs == blobs
    assert eng.summary()["tier_fallbacks"] == 0
    eng.detach(gid)
    assert not eng._tier_operands and not eng._operands
