"""PyTorch port, the GraSp slice: `repro_torch`'s block-sparse structure,
backend rule, kernel plain versions, plans and GraphServe against the
reference package on the same numpy inputs and weights
(`bridge.params_from_jax`, `bridge.block_sparse_from_jax`), with the
reference's kernels in interpret mode or as their jnp twins; then the
port's own GraSp serving lifecycle.

Tolerance: structure arrays and backend decisions are equal exactly;
logits and products within rtol=atol=1e-5 (XLA's and ATen's CPU dots sum
in different orders).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costs as rcosts
from repro.core import graph as rg
from repro.core import layers as rlayers
from repro.core import models as rmodels
from repro.core import sparsity as rsp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.runtime import gnn_server as rserve
from repro_torch import bridge
from repro_torch.core import costs as tcosts
from repro_torch.core import graph as tg
from repro_torch.core import layers as tlayers
from repro_torch.core import models as tmodels
from repro_torch.core import sparsity as tsp
from repro_torch.data.graphs import clustered_like, planetoid_like
from repro_torch.kernels import bitmap_spmm as bs_mod
from repro_torch.kernels import fused_layers as fl_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.runtime import gnn_server as tserve

TOL = dict(rtol=1e-5, atol=1e-5)
IN_FEATS, HIDDEN, CLASSES = 16, 8, 4
CAP, SLOTS = 1024, 2
ACTIVATIONS = ("none", "relu", "elu")
BASE = dict(stagr=True, grad_dynamic=True, graphsplit=True)


def _clustered(n, seed, cross_frac=0.0):
    return clustered_like(num_nodes=n, num_feats=IN_FEATS,
                          num_classes=CLASSES, within_density=0.05,
                          cross_frac=cross_frac, seed=seed)


def _scattered(n, seed):
    return planetoid_like(num_nodes=n, num_edges=40 * n, num_feats=IN_FEATS,
                          num_classes=CLASSES, seed=seed, train_per_class=2)


def _norm_adj(g, cap=CAP):
    return tg.pad_graph(g, capacity=cap).norm_adj


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _weights(seed=0):
    rng = np.random.default_rng(seed)

    def lin(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)
                      ).astype(np.float32),
                "b": (0.1 * rng.standard_normal(o)).astype(np.float32)}
    return {"l1": lin(IN_FEATS, HIDDEN), "l2": lin(HIDDEN, CLASSES)}


def _jax_params(w):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
            for k, v in w.items()}


@pytest.fixture(params=["interpret", "ref"])
def kernel_mode(request, monkeypatch):
    """The reference's kernel routing: its Pallas grids in interpret mode
    (conftest's default), or its jnp twins."""
    if request.param == "ref":
        monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    else:
        monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)
        monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    return request.param


# ------------------------------------------------------ structure, exactly

STRUCT_GRAPHS = {"clustered": lambda: _clustered(700, 1),
                 "clustered_cross": lambda: _clustered(900, 2, 0.02),
                 "planetoid": lambda: _scattered(600, 3)}


def _assert_same_structure(got, want):
    for f in tsp.LEAVES:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.block_size, tuple(got.shape)) == (want.block_size,
                                                  tuple(want.shape))


@pytest.mark.parametrize("graph", sorted(STRUCT_GRAPHS))
def test_host_structure_equals_reference(graph):
    a = _norm_adj(STRUCT_GRAPHS[graph]())
    got_stats, want_stats = tsp.block_stats(a), rsp.block_stats(a)
    assert got_stats.keys() == want_stats.keys()
    for k, v in want_stats.items():
        np.testing.assert_array_equal(got_stats[k], v, err_msg=k)
    got, want = tsp.to_block_sparse(a), rsp.to_block_sparse(a)
    _assert_same_structure(got, want)
    _assert_same_structure(tsp.to_block_sparse(a,
                                               bitmap=got_stats["bitmap"]),
                           want)
    np.testing.assert_array_equal(tsp.from_block_sparse(got),
                                  rsp.from_block_sparse(want))
    np.testing.assert_array_equal(tsp.from_block_sparse(got), a)
    budget = max(got.max_nnz, tsp.grasp_max_nnz(CAP))
    _assert_same_structure(tsp.pad_block_sparse(got, budget),
                           rsp.pad_block_sparse(want, budget))
    assert got.nbytes == want.nbytes and got.density == want.density
    assert tsp.sparsity_report(a) == rsp.sparsity_report(a)


def test_budget_zvc_and_reorder_equal_reference():
    for cap in (128, 256, 384, 1024, 2048, 3072, 4096):
        assert tsp.grasp_max_nnz(cap) == rsp.grasp_max_nnz(cap)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 29)).astype(np.float32)
    x[rng.random(x.shape) < 0.8] = 0.0
    for got, want in zip(tsp.zvc_pack(x), rsp.zvc_pack(x)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsp.zvc_unpack(*tsp.zvc_pack(x)), x)
    assert tsp.zvc_compressed_bytes(x) == rsp.zvc_compressed_bytes(x)
    for g in (_scattered(300, 5), _clustered(400, 6, 0.05)):
        pg = tg.pad_graph(g, capacity=512)
        perm = tsp.bfs_reorder(pg.adj, pg.num_nodes)
        np.testing.assert_array_equal(perm, rsp.bfs_reorder(pg.adj,
                                                            pg.num_nodes))
        np.testing.assert_array_equal(
            tsp.apply_reorder(pg.norm_adj, perm),
            rsp.apply_reorder(pg.norm_adj, perm))


@pytest.mark.parametrize("graph", sorted(STRUCT_GRAPHS))
@pytest.mark.parametrize("max_nnz", [2, 5])
def test_device_compaction_equals_reference(graph, max_nnz):
    a = _norm_adj(STRUCT_GRAPHS[graph]())
    got, got_true = tsp.compact_block_sparse(_t(a), max_nnz=max_nnz)
    want, want_true = rsp.compact_block_sparse(jnp.asarray(a),
                                               max_nnz=max_nnz)
    _assert_same_structure(got, want)           # padded columns included
    np.testing.assert_array_equal(got_true.numpy(), np.asarray(want_true))
    np.testing.assert_array_equal(tsp.block_counts(_t(a)).numpy(),
                                  np.asarray(rsp.block_counts(
                                      jnp.asarray(a))))
    assert got_true.dtype == torch.int32


def test_stack_block_sparse_rejects_mixed_budgets():
    a = _norm_adj(_clustered(700, 1))
    two, _ = tsp.compact_block_sparse(_t(a), max_nnz=2)
    three, _ = tsp.compact_block_sparse(_t(a), max_nnz=3)
    stacked = tsp.stack_block_sparse([two, two])
    assert stacked.blocks.shape == (2, 16, 128, 128) and stacked.max_nnz == 2
    with pytest.raises(ValueError, match="mixed block-sparse"):
        tsp.stack_block_sparse([two, three])
    with pytest.raises(ValueError, match="empty"):
        tsp.stack_block_sparse([])
    with pytest.raises(ValueError, match="budget"):
        tsp.pad_block_sparse(tsp.to_block_sparse(
            _norm_adj(_scattered(600, 3))), 2)


def test_block_sparse_from_jax_keeps_values_and_dtypes():
    want = rsp.pad_block_sparse(rsp.to_block_sparse(
        _norm_adj(_clustered(700, 1))), 3)
    got = bridge.block_sparse_from_jax(want, device="cpu")
    assert all(isinstance(getattr(got, f), torch.Tensor) for f in tsp.LEAVES)
    _assert_same_structure(got, want)


# ------------------------------------------------------------- cost rule

def _rule_inputs():
    for g in (_clustered(300, 1), _clustered(900, 2), _clustered(900, 4, 0.02),
              _scattered(900, 3), _clustered(200, 5)):
        for cap in (256, 1024, 3072):
            if g.num_nodes <= cap:
                stats = tsp.block_stats(_norm_adj(g, cap))
                yield cap, stats["nnz_blocks"], stats["max_row_nnz"]


def test_rule_with_reference_constants_equals_reference(monkeypatch):
    monkeypatch.setattr(tcosts, "DENSE_RATE", rcosts.MXU_RATE)
    monkeypatch.setattr(tcosts, "GRASP_RATE", rcosts.MXU_RATE)
    monkeypatch.setattr(tcosts, "HBM_BW", rcosts.HBM_BW)
    monkeypatch.setattr(tcosts, "GRASP_STEP_OVERHEAD_S",
                        rsp.GRASP_STEP_OVERHEAD_S)
    monkeypatch.setattr(tcosts, "AGG_CALL_S", 0.0)
    seen = set()
    for cap, nnz, mx in _rule_inputs():
        for feats in (8, 64, 256):
            for mode in ("auto", "grasp"):
                got = tsp.select_agg_backend(cap, feats, nnz_blocks=nnz,
                                             max_row_nnz=mx, mode=mode)
                want = rsp.select_agg_backend(cap, feats, nnz_blocks=nnz,
                                              max_row_nnz=mx, mode=mode)
                assert got[0] == want[0]
                np.testing.assert_allclose(got[1:], want[1:], rtol=1e-12)
                seen.add(got[0])
    assert seen == {"dense", "grasp"}


def test_rule_properties_with_h100_constants():
    """The properties of the reference's `test_select_backend_density_rule`
    and its budget and cost-monotonicity tests, under the port's own
    constants."""
    backend, dense_s, grasp_s = tsp.select_agg_backend(
        1024, 16, nnz_blocks=8, max_row_nnz=1)
    assert backend == "grasp" and grasp_s < dense_s
    cb = 1024 // 128
    assert tsp.select_agg_backend(1024, 16, nnz_blocks=cb * cb,
                                  max_row_nnz=cb)[0] == "dense"
    assert tsp.select_agg_backend(1024, 16, nnz_blocks=cb * cb,
                                  max_row_nnz=cb, mode="grasp")[0] == "dense"
    assert tsp.select_agg_backend(128, 16, nnz_blocks=1,
                                  max_row_nnz=1)[0] == "dense"
    # measured costs rank eligible graphs; they never make one eligible
    assert tsp.select_agg_backend(1024, 16, nnz_blocks=8, max_row_nnz=1,
                                  measured=(1e-6, 2e-6))[0] == "dense"
    assert tsp.select_agg_backend(1024, 16, nnz_blocks=cb * cb,
                                  max_row_nnz=cb,
                                  measured=(2e-6, 1e-6))[0] == "dense"
    with pytest.raises(ValueError, match="mode"):
        tsp.select_agg_backend(1024, 16, nnz_blocks=1, max_row_nnz=1,
                               mode="dense")
    prev = 0
    for cap in (128, 256, 384, 512, 1024, 2048, 4096):
        b = tsp.grasp_max_nnz(cap)
        assert b >= prev and 1 <= b <= max(cap // 128, 1)
        prev = b
    costs = [tsp.agg_cost_model(1024, 64, nnz_blocks=k, max_nnz=2)[1]
             for k in (1, 4, 16, 64)]
    assert costs == sorted(costs)
    # at the serving widths every eligible clustered graph goes grasp
    for cap in (1024, 3072):
        assert tsp.select_agg_backend(cap, 64, nnz_blocks=cap // 128,
                                      max_row_nnz=1)[0] == "grasp"


# ------------------------------------------------------------ kernel twins

def _structure_pair(n, seed, max_nnz, cap=CAP):
    """One graph's reference structure with a few cross-community blocks,
    padded to at least `max_nnz`, and the port's copy."""
    want = rsp.to_block_sparse(_norm_adj(_clustered(n, seed, 0.003), cap))
    want = rsp.pad_block_sparse(want, max(want.max_nnz, max_nnz))
    return want, bridge.block_sparse_from_jax(want, device="cpu")


@pytest.mark.parametrize("f", [8, 128, 200])
def test_bitmap_spmm_matches_reference(kernel_mode, f):
    rng = np.random.default_rng(f)
    want_sp, got_sp = _structure_pair(900, 1, 4)
    h = rng.standard_normal((CAP, f)).astype(np.float32)
    want = np.asarray(jops.bitmap_spmm(want_sp, jnp.asarray(h)))
    got = tops.bitmap_spmm(got_sp, _t(h))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tref.bitmap_spmm_block_ref(got_sp.blocks, got_sp.block_cols,
                                   got_sp.counts, _t(h),
                                   block_size=128).numpy(), want, **TOL)
    dense = rsp.from_block_sparse(want_sp)
    np.testing.assert_allclose(
        tref.bitmap_spmm_ref(_t(dense), _t(h)).numpy(),
        np.asarray(jref.bitmap_spmm_ref(jnp.asarray(dense), jnp.asarray(h))),
        **TOL)
    # the batched entry: a stacked structure and h with a leading B
    stacked = tsp.stack_block_sparse([got_sp, got_sp])
    both = tops.bitmap_spmm_batched(stacked, _t(np.stack([h, 2 * h])))
    np.testing.assert_allclose(both[1].numpy(), 2 * want, **TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_fused_gcn_grasp_matches_reference(kernel_mode, activation):
    rng = np.random.default_rng(7)
    want_sp, got_sp = _structure_pair(700, 3, 2)
    x = rng.standard_normal((CAP, IN_FEATS)).astype(np.float32)
    w = (rng.standard_normal((IN_FEATS, 24)) / 4).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = np.asarray(jops.fused_gcn_layer(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        block_sparse=want_sp, activation=activation))
    got = tops.fused_gcn_layer(_t(x), _t(w), _t(b), block_sparse=got_sp,
                               activation=activation)
    assert got.shape == want.shape == (CAP, 24)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    twin = tref.fused_gcn_grasp_layer_ref(
        got_sp.blocks, got_sp.block_cols, got_sp.counts, _t(x), _t(w),
        _t(b), block_size=128, activation=activation)
    np.testing.assert_allclose(twin.numpy(), want, **TOL)


def test_plain_versions_mask_the_tail_and_route_cpu_without_launching():
    bs_mod.LAUNCHES = fl_mod.GRASP_LAUNCHES = 0
    _, sp = _structure_pair(900, 1, 4)
    rng = np.random.default_rng(2)
    h = _t(rng.standard_normal((1, CAP, 128)).astype(np.float32))
    blocks, cols, counts = (t[None] for t in (sp.blocks, sp.block_cols,
                                              sp.counts))
    want = bs_mod.bitmap_spmm_plain(blocks, cols, counts, h)
    # garbage in the padded tail entries is multiplied by 0
    live = (torch.arange(sp.max_nnz)[None, :]
            < sp.counts[:, None]).reshape(-1)
    noisy = blocks.clone()
    noisy[0, ~live] = 7.0
    assert torch.equal(bs_mod.bitmap_spmm(noisy, cols, counts, h), want)
    np.testing.assert_allclose(
        want[0].numpy(), (_t(tsp.from_block_sparse(sp)) @ h[0]).numpy(),
        **TOL)
    x = _t(rng.standard_normal((1, CAP, 32)).astype(np.float32))
    w = _t(rng.standard_normal((32, 128)).astype(np.float32))
    b = torch.zeros(128)
    assert torch.equal(
        fl_mod.fused_gcn_grasp(blocks, cols, counts, x, w, b, "relu"),
        fl_mod.fused_gcn_grasp_plain(blocks, cols, counts, x, w, b, "relu"))
    assert bs_mod.LAUNCHES == 0 and fl_mod.GRASP_LAUNCHES == 0
    meta = torch.empty(1, CAP, 128, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bs_mod.bitmap_spmm(blocks, cols, counts, meta)
    with pytest.raises(ValueError, match="activation"):
        fl_mod.fused_gcn_grasp(blocks, cols, counts, x, w, b, "gelu")
    assert tops.bitmap_spmm_mode(torch.device("cpu")) == "ref"
    assert tops.bitmap_spmm_mode(torch.device("cuda", 0)) == "kernel"


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("batch_size", [0, 2])
@pytest.mark.parametrize("fusion", ["none", "layer"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_grasp_plan_matches_reference(kernel_mode, batch_size, fusion,
                                      use_pallas):
    weights = _weights(1)
    budget = tsp.grasp_max_nnz(CAP)
    graphs = [_clustered(n, 10 + i) for i, n in enumerate((700, 1000))]
    t_flags = dict(BASE, use_pallas=use_pallas)
    rcfg = rmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                             num_classes=CLASSES)
    tcfg = tmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                             num_classes=CLASSES)
    pgs = [tg.pad_graph(g, capacity=CAP) for g in graphs]
    if not batch_size:
        pgs = pgs[:1]
    r_ops, t_ops = [], []
    for p in pgs:
        rsparse = rsp.pad_block_sparse(rsp.to_block_sparse(p.norm_adj),
                                       budget)
        r_ops.append(dataclasses.replace(
            rmodels.build_operands(rg.PaddedGraph(**dataclasses.asdict(p)),
                                   rcfg, lean=True), block_sparse=rsparse))
        t_ops.append(dataclasses.replace(
            tmodels.build_operands(p, tcfg, device="cpu"),
            block_sparse=bridge.block_sparse_from_jax(rsparse,
                                                      device="cpu")))
    x = np.stack([p.features for p in pgs])
    if batch_size:
        r_args = (jnp.asarray(x), rmodels.stack_operands(r_ops))
        t_args = (torch.from_numpy(x), tmodels.stack_operands(t_ops))
    else:
        r_args = (jnp.asarray(x[0]), r_ops[0])
        t_args = (torch.from_numpy(x[0]), t_ops[0])
    rplan = rmodels.build_plan(rcfg, CAP, rlayers.Techniques(**t_flags),
                               batch_size=batch_size, backend="grasp",
                               fusion=fusion)
    tplan = tmodels.build_plan(tcfg, CAP, tlayers.Techniques(**t_flags),
                               batch_size=batch_size, backend="grasp",
                               fusion=fusion, device="cpu")
    want = np.asarray(rplan(_jax_params(weights), *r_args))
    got = tplan(bridge.params_from_jax(weights, device="cpu"), *t_args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tplan.key[1:3] == rplan.key[1:3] and tplan.key[4:] == rplan.key[4:]
    assert not tplan.techniques.grasp            # the key keeps the tier's
    assert tplan.grasp_ref_fallback              # the CPU runs the plain form
    assert rplan.grasp_ref_fallback == (kernel_mode == "ref")


def test_build_operands_grasp_and_stack_all_or_none():
    cfg = tmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS)
    pg = tg.pad_graph(_clustered(700, 1), capacity=CAP)
    ops = tmodels.build_operands(pg, cfg, grasp=True, device="cpu")
    want = rmodels.build_operands(rg.PaddedGraph(**dataclasses.asdict(pg)),
                                  rmodels.GNNConfig(kind="gcn",
                                                    in_feats=IN_FEATS),
                                  grasp=True, lean=True).block_sparse
    _assert_same_structure(ops.block_sparse, want)
    budget = tsp.grasp_max_nnz(CAP)
    padded = tmodels.build_operands(
        pg, cfg, grasp=True, max_nnz=budget,
        bitmap=tsp.block_stats(pg.norm_adj)["bitmap"], device="cpu")
    _assert_same_structure(padded.block_sparse,
                           rsp.pad_block_sparse(want, budget))
    dense = tmodels.build_operands(pg, cfg, device="cpu")
    assert dense.block_sparse is None
    with pytest.raises(ValueError, match="mix of GraSp and dense"):
        tmodels.stack_operands([ops, dense])
    assert tmodels.stack_operands([ops, ops]).block_sparse.blocks.dim() == 4


def test_plan_signature_covers_the_structure_budget():
    cfg = tmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                            num_classes=CLASSES)
    plan = tmodels.build_plan(cfg, CAP, tlayers.Techniques(**BASE),
                              batch_size=2, backend="grasp", device="cpu")
    params = tmodels.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    pg = tg.pad_graph(_clustered(700, 1), capacity=CAP)
    x = torch.from_numpy(np.stack([pg.features] * 2))
    base = tmodels.build_operands(pg, cfg, device="cpu")
    for max_nnz, traces in ((2, 1), (2, 1), (3, 2)):
        sp, _ = tsp.compact_block_sparse(base.norm_adj, max_nnz=max_nnz)
        plan(params, x, tmodels.stack_operands(
            [dataclasses.replace(base, block_sparse=sp)] * 2))
        assert plan.trace_count == traces


# ---------------------------------------------------------------- serving

GRASP_MODELS = (("sp", dict(fusion="layer"), BASE),
                ("sp_none", dict(), BASE),
                ("sp_mm", dict(), dict(BASE, use_pallas=True)))


def _serve(pkg, engine, weights, mode, models, graphs, attached):
    graph_cls = rg.Graph if pkg == "jax" else tg.Graph
    cfg_cls = rmodels.GNNConfig if pkg == "jax" else tmodels.GNNConfig
    tech_cls = rlayers.Techniques if pkg == "jax" else tlayers.Techniques
    cfg = cfg_cls(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                  num_classes=CLASSES)
    params = (_jax_params(weights) if pkg == "jax"
              else bridge.params_from_jax(weights, device="cpu"))
    for name, kw, flags in models:
        engine.register_model(name, cfg, params, techniques=tech_cls(**flags),
                              agg_backend=mode, **kw)
    batches = []
    execute = engine._execute_batch

    def record(batch):
        batches.append([r.uid for r in batch])
        execute(batch)
    engine._execute_batch = record
    for g in graphs:
        for name, _, _ in models:
            engine.submit(graph_cls(**dataclasses.asdict(g)), model=name)
    gid = engine.attach(graph_cls(**dataclasses.asdict(attached)),
                        model=models[0][0])
    engine.query(gid)
    engine.query(gid, fusion="none")
    return batches, engine.run()


def _engines(buckets=(CAP,)):
    ref_eng = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=buckets), batch_slots=SLOTS,
        return_logits=True, use_cacheg=False))
    port = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=buckets), batch_slots=SLOTS,
        return_logits=True), device="cpu")
    return ref_eng, port


def _assert_same_serving(got, want):
    (got_batches, got_done), (ref_batches, ref_done) = got, want
    assert got_batches == ref_batches
    assert [r.uid for r in got_done] == [r.uid for r in ref_done]
    for g, r in zip(got_done, ref_done):
        assert (g.model, g.bucket, g.backend, g.fusion) == (
            r.model, r.bucket, r.backend, r.fusion)
        np.testing.assert_array_equal(g.preds, r.preds)
        np.testing.assert_allclose(g.logits, r.logits, **TOL)


def test_grasp_serving_matches_reference(kernel_mode):
    weights = _weights(2)
    graphs = [_clustered(300, 1), _clustered(700, 2), _scattered(900, 3),
              _clustered(1000, 4)]
    ref_eng, port = _engines()
    want = _serve("jax", ref_eng, weights, "grasp", GRASP_MODELS, graphs,
                  _clustered(900, 9))
    got = _serve("torch", port, weights, "grasp", GRASP_MODELS, graphs,
                 _clustered(900, 9))
    _assert_same_serving(got, want)
    done = got[1]
    assert {r.backend for r in done} == {"grasp", "dense"}
    s, rs = port.summary(), ref_eng.summary()
    assert s["grasp_batches"] == rs["grasp_batches"] > 0
    assert s["agg_backends"] == rs["agg_backends"]
    n_grasp = sum(r.backend == "grasp" for r in done)
    # the scattered graph is ineligible: one fallback per model's request
    assert s["backend_fallbacks"] == len(GRASP_MODELS) + n_grasp
    if kernel_mode == "ref":                 # both run the plain form
        assert rs["backend_fallbacks"] == s["backend_fallbacks"]
    else:
        assert rs["backend_fallbacks"] == len(GRASP_MODELS)


def test_auto_mode_decisions_equal_reference(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    monkeypatch.setattr(tcosts, "DENSE_RATE", rcosts.MXU_RATE)
    monkeypatch.setattr(tcosts, "GRASP_RATE", rcosts.MXU_RATE)
    monkeypatch.setattr(tcosts, "HBM_BW", rcosts.HBM_BW)
    monkeypatch.setattr(tcosts, "GRASP_STEP_OVERHEAD_S",
                        rsp.GRASP_STEP_OVERHEAD_S)
    monkeypatch.setattr(tcosts, "AGG_CALL_S", 0.0)
    weights = _weights(3)
    graphs = [_clustered(200, 1), _clustered(700, 2), _scattered(600, 3),
              _clustered(1000, 4, 0.02)]
    ref_eng, port = _engines(buckets=(256, CAP))
    models = GRASP_MODELS[:2]
    want = _serve("jax", ref_eng, weights, "auto", models, graphs,
                  _clustered(900, 9))
    got = _serve("torch", port, weights, "auto", models, graphs,
                 _clustered(900, 9))
    _assert_same_serving(got, want)
    backends = {(r.bucket, r.backend) for r in got[1]}
    assert (256, "dense") in backends and (CAP, "grasp") in backends \
        and (CAP, "dense") in backends
    s, rs = port.summary(), ref_eng.summary()
    assert (s["grasp_batches"], s["backend_fallbacks"]) == (
        rs["grasp_batches"], rs["backend_fallbacks"])


# ---------------------------------------------------------------- lifecycle

def _port_engine(mode="grasp", tiers=None, use_cacheg=True):
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=(256, CAP)), batch_slots=SLOTS,
        return_logits=True, use_cacheg=use_cacheg), device="cpu")
    cfg = tmodels.GNNConfig(kind="gcn", in_feats=IN_FEATS, hidden=HIDDEN,
                            num_classes=CLASSES)
    eng.register_model("sp", cfg, agg_backend=mode, fusion="layer",
                       tiers=tiers)
    eng.register_model("dense", cfg)
    return eng


def test_structure_cache_derives_once_per_version_and_detach_releases():
    eng = _port_engine(use_cacheg=False)
    eng.warmup()
    traces = eng._block_compactor.trace_count
    calls = []
    derive = eng._derive_grasp

    def counted(*a):
        calls.append(a[1])
        return derive(*a)
    eng._derive_grasp = counted
    gid = eng.attach(_clustered(700, 1), model="sp")
    before = eng.metrics["operand_bytes_h2d"]
    for fusion in ("layer", "none", "layer"):
        eng.query(gid, fusion=fusion)
    # one dense Â upload; the structure was derived on the device once
    assert eng.metrics["operand_bytes_h2d"] - before == 4 * CAP * CAP
    assert calls == [CAP] and len(eng._grasp) == 1
    backend, sp = eng._grasp[(gid, 0)]
    assert backend == "grasp" and sp.max_nnz == tsp.grasp_max_nnz(CAP)
    assert eng._block_compactor.trace_count == traces
    done = eng.run()
    assert [r.backend for r in done] == ["grasp"] * 3
    eng.detach(gid)
    assert not eng._grasp and not eng._operands
    eng.assert_warm()


def test_one_shot_grasp_ships_its_host_structure():
    eng = _port_engine(use_cacheg=False)
    g = _clustered(700, 1)
    eng.submit(g, model="sp")
    req = eng.queue[0]
    host = tsp.pad_block_sparse(tsp.to_block_sparse(
        _norm_adj(g)), tsp.grasp_max_nnz(CAP))
    assert req.backend == "grasp"
    assert eng.metrics["operand_bytes_h2d"] == 4 * CAP * CAP + host.nbytes
    _assert_same_structure(req.ops.block_sparse, host)


def test_mixed_traffic_stays_warm_and_counts_forced_fallbacks():
    eng = _port_engine()
    blobs = eng.warmup()
    # per bucket: dense fp32 (2 fusions, shared) + grasp (2) + compactor (2)
    # + the CacheG materializer's GCN trace (1) + the delta patcher's (1)
    assert blobs == 2 * (2 + 2 + 2 + 1 + 1)
    dense_g = _scattered(900, 3)
    for g in (_clustered(200, 1), _clustered(700, 2), dense_g):
        eng.submit(g, model="sp")
        eng.submit(g, model="dense", fusion="layer")
    gid = eng.attach(dense_g, model="sp")
    eng.query(gid)
    eng.query(gid)
    done = eng.run()
    eng.assert_warm()
    s = eng.summary()
    by_model = {(r.model, r.pg.num_nodes): r.backend for r in done}
    assert by_model[("sp", 900)] == "dense" and by_model[("sp", 700)] \
        == "grasp" and by_model[("dense", 700)] == "dense"
    n_grasp = sum(r.backend == "grasp" for r in done)
    # 3 forced-but-ineligible requests (one submit, two queries) plus every
    # grasp request, which runs the plain form on the CPU
    assert s["backend_fallbacks"] == 3 + n_grasp
    assert s["grasp_batches"] == 2
    assert s["agg_backends"] == {"sp": "grasp", "dense": "dense"}
    lg = {(r.model, r.pg.num_nodes, r.uid): r.logits for r in done}
    for (m, n, _), v in lg.items():
        if m == "sp" and n != 900:
            other = [w for (m2, n2, _), w in lg.items()
                     if m2 == "dense" and n2 == n][0]
            np.testing.assert_allclose(v, other, **TOL)


def test_quant_tiers_resolve_dense():
    eng = _port_engine(tiers=("fp32", "int8"))
    g = _clustered(700, 1)
    eng.calibrate("sp", g)
    eng.warmup()
    gid = eng.attach(g, model="sp")
    eng.query(gid, tier="int8")
    eng.submit(g, model="sp", tier="int8")
    eng.query(gid, tier="fp32")
    done = eng.run()
    assert [(r.tier, r.backend) for r in sorted(done, key=lambda r: r.uid)] \
        == [("int8", "dense"), ("int8", "dense"), ("fp32", "grasp")]
    eng.assert_warm()
    # grasp plans exist for the fp32 tier only
    assert {p.techniques.quantgr for p in eng._plans.values()
            if p.backend == "grasp"} == {False}


def test_register_model_rejects_unknown_backend_mode():
    eng = tserve.GraphServe(device="cpu")
    cfg = tmodels.GNNConfig(kind="gcn", in_feats=8)
    with pytest.raises(ValueError, match="agg_backend"):
        eng.register_model("x", cfg, agg_backend="sparse")
    for mode in tserve.AGG_BACKEND_MODES:
        eng.register_model(mode, cfg, agg_backend=mode)
    assert eng.summary()["agg_backends"] == {m: m for m in
                                             tserve.AGG_BACKEND_MODES}
