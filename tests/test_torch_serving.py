"""PyTorch port, the slice as a whole: `repro_torch`'s GraphServe against the
reference GraphServe (`use_cacheg=False`) on the same graphs and weights,
in both fusion modes and with the `use_pallas` (block_matmul) model; plan
parity; the zero-recompile contract; the device rule.

Tolerance: fp32 rtol=atol=1e-5 on logits (XLA's and ATen's CPU dots sum in
different orders); batch composition, uids and argmax must be equal.
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


def _port_engine(**kw):
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS), **kw)
    cfg = tmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                            num_classes=CLASSES)
    eng.register_model("gcn", cfg, fusion="layer")
    eng.register_model("gcn_mm", cfg, techniques=tlayers.Techniques(
        **BASE, use_pallas=True))
    return eng


def test_assert_warm_holds_after_warmup_and_catches_new_shapes():
    eng = _port_engine(device="cpu")
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
    with pytest.raises(NotImplementedError, match="CacheG"):
        tserve.GraphServe(tserve.GraphServeConfig(use_cacheg=True),
                          device="cpu")
    eng = tserve.GraphServe(device="cpu")
    cfg = tmodels.GNNConfig(kind="gcn", in_feats=8)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        eng.register_model("q", cfg, tiers=("fp32", "int8"))
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        eng.register_model("s", cfg, agg_backend="grasp")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        eng.register_model("a", tmodels.GNNConfig(kind="gat", in_feats=8))
    eng.register_model("ok", cfg, tiers=("fp32",))
    assert list(eng.models) == ["ok"]


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
