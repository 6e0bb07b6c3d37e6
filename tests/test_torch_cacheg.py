"""PyTorch port, the CacheG slice: the SymG/CacheG packers, the compact
operand form and its device materializer, the byte-budgeted
`DeviceCacheManager` with its host spill, and GraphServe on the compact
pipeline (the default) with `update()`'s full rebuild — each against the
reference package on the same numpy inputs and weights.

Tolerance: packed bytes, degree vectors, masks, counters, batches, uids,
backends and argmax are equal exactly; the materialized Â within atol
1e-6 of the reference's (the reference's own bar; XLA may rewrite 1/sqrt
as rsqrt) and equal bit for bit to the port's eager Â; logits within
rtol=atol=1e-5 (XLA's and ATen's CPU dots sum in different orders).

One accounting term differs on purpose: the reference's eager operand set
holds a (1, 1) float32 placeholder for each field its kind does not read
and counts its 4 bytes in `operand_bytes_h2d`; the port ships nothing for
them. Cache entry sizes follow the reference's layout, so residency and
every eviction decision are equal; only a directed graph's eager upload
counts `PLACEHOLDER_BYTES` less per absent field in the port.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given
from hypothesis import strategies as st

from repro.core import costs as rcosts
from repro.core import graph as rg
from repro.core import models as rmodels
from repro.core import sparsity as rsp
from repro.runtime import cache as rcache
from repro.runtime import gnn_server as rserve
from repro_torch import bridge
from repro_torch.core import costs as tcosts
from repro_torch.core import graph as tg
from repro_torch.core import models as tmodels
from repro_torch.data.graphs import clustered_like, planetoid_like
from repro_torch.runtime import cache as tcache
from repro_torch.runtime import gnn_server as tserve

TOL = dict(rtol=1e-5, atol=1e-5)
IN_FEATS, HIDDEN, HEADS, CLASSES = 16, 16, 4, 4
BUCKETS, SLOTS = (128, 256), 2
KINDS = ("gcn", "gat", "sage")
COUNTERS = ("operand_bytes_h2d", "operand_cache_hits", "operand_cache_misses",
            "cacheg_fallbacks", "backend_fallbacks", "tier_fallbacks",
            "batches", "grasp_batches", "rebucket_events",
            "cache_resident_bytes", "cache_evictions", "cache_spilled",
            "cache_dropped", "cache_spill_entries", "cache_spill_hits",
            "cache_admission_rejects")


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    """The reference's kernels as their jnp twins (the port runs its plain
    versions on the CPU; the kernels are held against those elsewhere)."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


def _graph(n, seed, edges=3):
    return planetoid_like(num_nodes=n, num_edges=edges * n,
                          num_feats=IN_FEATS, num_classes=CLASSES, seed=seed,
                          train_per_class=2)


def _directed(n, seed):
    """A planetoid graph with one direction of a third of its edges cut."""
    g = _graph(n, seed)
    src, dst = g.edge_index
    keep = ~((src < dst) & (np.arange(src.size) % 3 == 0))
    return dataclasses.replace(g, edge_index=g.edge_index[:, keep])


def _clustered(n, seed, cross_frac=0.0):
    return clustered_like(num_nodes=n, num_feats=IN_FEATS,
                          num_classes=CLASSES, within_density=0.05,
                          cross_frac=cross_frac, seed=seed)


def _as(pkg, g):
    return (rg.Graph if pkg == "jax" else tg.Graph)(**dataclasses.asdict(g))


def _pads(n, cap, seed=1, self_loops=()):
    g = _graph(n, seed)
    if self_loops:
        loops = np.asarray([self_loops, self_loops], np.int32)
        g = dataclasses.replace(
            g, edge_index=np.concatenate([g.edge_index, loops], axis=1))
    pg = tg.pad_graph(g, capacity=cap)
    return pg, rg.PaddedGraph(**dataclasses.asdict(pg))


def _cfgs(kind, **kw):
    kw = dict(kind=kind, in_feats=IN_FEATS, hidden=HIDDEN,
              num_classes=CLASSES, heads=HEADS, **kw)
    return rmodels.GNNConfig(**kw), tmodels.GNNConfig(**kw)


# ------------------------------------------------------------------ packers

@pytest.mark.parametrize("cap", [128, 256])
def test_packed_bytes_equal_reference(cap):
    pg, _ = _pads(cap - 30, cap, self_loops=(0, 5, 17))
    assert pg.adj[5, 5] == 1.0                       # explicit self-loops
    got = tg.symg_pack_adjacency_bits(pg.adj)
    want = rg.symg_pack_adjacency_bits(pg.adj)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert got.nbytes == -(-tg.triangular_nbits(cap) // 8)
    assert np.array_equal(tg.pack_adjacency_bits(pg.adj),
                          rg.pack_adjacency_bits(pg.adj))
    assert tg.triangular_nbits(cap) == rg.triangular_nbits(cap)


def test_symg_pack_rejects_directed():
    adj = np.zeros((128, 128), np.float32)
    adj[3, 7] = 1.0                                  # no reverse edge
    with pytest.raises(ValueError, match="symmetric"):
        tg.symg_pack_adjacency_bits(adj)
    # check=False trusts the caller, as the reference does
    assert np.array_equal(tg.symg_pack_adjacency_bits(adj, check=False),
                          rg.symg_pack_adjacency_bits(adj, check=False))


@given(n=st.integers(1, 600), seed=st.integers(0, 2 ** 16),
       flip=st.booleans())
def test_is_symmetric_adjacency_agrees(n, seed, flip):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.05).astype(np.float32)
    a = np.maximum(a, a.T)
    if flip:
        i, j = rng.integers(0, n, 2)
        a[i, j] = 1.0 - a[i, j]                  # asymmetric unless i == j
    assert tg.is_symmetric_adjacency(a) == rg.is_symmetric_adjacency(a) \
        == bool(np.array_equal(a, a.T))


def test_symg_pack_roundtrip_equals_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 300)).astype(np.float32)
    x = x + x.T
    (got, n), (want, rn) = tg.symg_pack(x), rg.symg_pack(x)
    assert n == rn and np.array_equal(got, want)
    assert np.array_equal(tg.symg_unpack(got, n), rg.symg_unpack(want, n))
    with pytest.raises(ValueError):
        tg.symg_pack(x + np.triu(x))


def test_port_packers_build_no_triu_indices(monkeypatch):
    pg, _ = _pads(200, 256)

    def refuse(*a, **k):
        raise AssertionError("np.triu_indices called")
    monkeypatch.setattr(np, "triu_indices", refuse)
    tg.symg_pack_adjacency_bits(pg.adj)
    tg.symg_unpack(*tg.symg_pack(pg.norm_adj))
    for kind in KINDS:
        tmodels.compact_operands(pg, _cfgs(kind)[1])


# --------------------------------------------------- compact form, materializer

@pytest.mark.parametrize("cap", [128, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_materialized_operands_equal_reference(kind, cap):
    pg, rpg = _pads(cap - 40, cap, self_loops=(0, 9))
    rcfg, tcfg = _cfgs(kind)
    want_co = rmodels.compact_operands(rpg, rcfg)
    co = tmodels.compact_operands(pg, tcfg)
    assert (co.capacity, co.fields, co.triangular) == (
        want_co.capacity, want_co.fields, want_co.triangular)
    assert np.array_equal(co.packed.numpy(), np.asarray(want_co.packed))
    assert np.array_equal(co.degree.numpy(), np.asarray(want_co.degree))
    assert int(co.num_nodes) == int(want_co.num_nodes)
    assert co.nbytes == want_co.nbytes
    want = rmodels.materialize_operands(want_co)
    got = tmodels.build_materializer("cpu")(co)
    eager = tmodels.build_operands(pg, tcfg, device="cpu")
    for f in tmodels.DENSE_FIELDS:
        if f not in tmodels.OPERAND_FIELDS[kind]:
            assert getattr(got, f) is None and getattr(eager, f) is None
            continue
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape == (cap, cap)
        if f == "norm_adj":
            np.testing.assert_allclose(g, w, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)
        # against the port's own eager build: bit for bit
        np.testing.assert_array_equal(g, getattr(eager, f).numpy())


def test_compact_sizes_match_the_formula():
    for kind, cap in (("gcn", 128), ("gat", 256), ("sage", 256)):
        pg, _ = _pads(100, cap)
        co = tmodels.compact_operands(pg, _cfgs(kind)[1])
        bits = cap * cap if kind == "sage" else tg.triangular_nbits(cap)
        assert co.nbytes == -(-bits // 8) + 4 * cap + 4


def test_materializer_norm_comes_from_inv_sqrt_degree(monkeypatch):
    pg, _ = _pads(100, 128, self_loops=(3,))
    co = tmodels.compact_operands(pg, _cfgs("gcn")[1])
    seen = []
    real = tmodels.inv_sqrt_degree

    def spy(degree):
        seen.append(degree)
        return real(degree)
    monkeypatch.setattr(tmodels, "inv_sqrt_degree", spy)
    got = tmodels.materialize_operands(co).norm_adj
    assert len(seen) == 1 and torch.equal(seen[0], co.degree)
    dis = real(co.degree)
    awl = tmodels._unpack_adjacency(co)
    idx = torch.arange(pg.num_nodes)
    awl[idx, idx] = 1.0
    assert torch.equal(got, dis[:, None] * awl * dis[None, :])
    assert torch.equal(dis[pg.num_nodes:], torch.zeros(128 - pg.num_nodes))
    # the host's D^-1/2 of deg(A + I), bit for bit
    deg = pg.adj.sum(1) + (np.arange(128) < pg.num_nodes) * (
        1.0 - np.diagonal(pg.adj))
    host = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)),
                    0.0).astype(np.float32)
    assert np.array_equal(dis.numpy(), host)


def test_materializer_counts_one_trace_per_structure():
    mat = tmodels.build_materializer("cpu")
    for kind, cap in (("gcn", 128), ("gcn", 128), ("gat", 128),
                      ("gcn", 256), ("sage", 256), ("sage", 256)):
        pg, _ = _pads(90, cap, seed=cap)
        mat(tmodels.compact_operands(pg, _cfgs(kind)[1]))
    assert mat.trace_count == 4


def test_materializer_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.build_materializer()


def test_host_operands_fall_back_only_for_directed_gcn_gat():
    g = _directed(100, 3)
    pg = tg.pad_graph(g, capacity=128)
    assert not tg.is_symmetric_adjacency(pg.adj)
    for kind in KINDS:
        cfg = _cfgs(kind)[1]
        ho = tmodels.prepare_host_operands(pg, cfg, device="cpu")
        assert ho.fallback == (kind != "sage")
        assert (ho.compact is None) == ho.fallback
        eager = tmodels.prepare_host_operands(pg, cfg, use_cacheg=False,
                                              device="cpu")
        assert eager.compact is None and not eager.fallback
        assert eager.nbytes == len(tmodels.OPERAND_FIELDS[kind]) * 4 * 128 ** 2


# ------------------------------------------------------------------ serving

def _weights(kind, seed, aggregator="mean"):
    cfg = _cfgs(kind, aggregator=aggregator)[0]
    p = rmodels.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _calibration_numpy(cal):
    return {k: ({"wq": np.asarray(v.wq), "w_scale": np.asarray(v.w_scale),
                 "x_scale": np.asarray(v.x_scale)}
                if hasattr(v, "wq") else np.asarray(v))
            for k, v in cal.items()}


def _engines(buckets=BUCKETS, **sc):
    ref = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=buckets), batch_slots=SLOTS,
        return_logits=True, **sc))
    port = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=buckets), batch_slots=SLOTS,
        return_logits=True, **sc), device="cpu")
    assert ref.sc.use_cacheg and port.sc.use_cacheg
    return ref, port


def _register(ref, port, models):
    """models: (name, kind, cfg kwargs, register kwargs, weight seed)."""
    for name, kind, cfg_kw, kw, seed in models:
        w = _weights(kind, seed, **cfg_kw)
        rcfg, tcfg = _cfgs(kind, **cfg_kw)
        ref.register_model(name, rcfg, jax.tree_util.tree_map(
            jax.numpy.asarray, w), **kw)
        port.register_model(name, tcfg, bridge.params_from_jax(
            w, device="cpu"), **kw)


def _run_both(ref, port, script):
    """Warm both engines, drive the same script, return each engine's
    dispatched batches (uid lists) and finished requests."""
    out = []
    for pkg, eng in (("jax", ref), ("torch", port)):
        eng.warmup()
        batches = []
        execute = eng._execute_batch

        def record(batch, execute=execute, batches=batches):
            batches.append([r.uid for r in batch])
            execute(batch)
        eng._execute_batch = record
        script(pkg, eng)
        out.append((batches, eng.run()))
    port.assert_warm()
    ref.assert_warm()
    return out


def _assert_same(ref, port, out, skip=()):
    (ref_batches, ref_done), (got_batches, got_done) = out
    assert got_batches == ref_batches
    assert [r.uid for r in got_done] == [r.uid for r in ref_done]
    for g, r in zip(got_done, ref_done):
        assert (g.model, g.bucket, g.tier, g.backend, g.fusion) == (
            r.model, r.bucket, r.tier, r.backend, r.fusion)
        np.testing.assert_array_equal(g.preds, r.preds)
        np.testing.assert_allclose(g.logits, r.logits, **TOL)
    s, rs = port.summary(), ref.summary()
    for k in COUNTERS:
        if k not in skip:
            assert s[k] == rs[k], (k, s[k], rs[k])
    return s, rs


def _compact_bytes(kind, cap):
    bits = cap * cap if kind == "sage" else tg.triangular_nbits(cap)
    return -(-bits // 8) + 4 * cap + 4


SIZES = (40, 90, 130, 200, 250, 60)


def _one_shots_and_queries(models, sizes=SIZES, attached=110, tier=None):
    def script(pkg, eng):
        for i, n in enumerate(sizes):
            for name in models:
                eng.submit(_as(pkg, _graph(n, i)), model=name, tier=tier)
        gid = eng.attach(_as(pkg, _graph(attached, 99)), model=models[0])
        eng.query(gid, tier=tier)
        eng.query(gid, tier=tier, fusion="none")
    return script


def test_gcn_fp32_serving_on_cacheg_matches_reference():
    ref, port = _engines()
    _register(ref, port, (("gcn", "gcn", {}, dict(fusion="layer"), 0),
                          ("gcn_none", "gcn", {}, {}, 0)))
    out = _run_both(ref, port, _one_shots_and_queries(("gcn", "gcn_none")))
    s, _ = _assert_same(ref, port, out)
    caps = [128 if n <= 128 else 256 for n in SIZES]
    # every one-shot request and the attached graph's first query ship
    # their compact form; the second query is a hit and ships nothing
    assert s["operand_bytes_h2d"] == 2 * sum(
        _compact_bytes("gcn", c) for c in caps) + _compact_bytes("gcn", 128)
    assert (s["operand_cache_misses"], s["operand_cache_hits"]) == (1, 1)
    assert s["cacheg_fallbacks"] == 0
    assert s["cache_resident_bytes"] == tcache.estimate_dense_entry_bytes(
        1, 128)


def test_gcn_int8_serving_on_cacheg_matches_reference():
    ref, port = _engines()
    tiers = dict(tiers=("fp32", "int8"), default_tier="int8")
    _register(ref, port, (("gcn_q", "gcn", {}, dict(tiers, fusion="layer"),
                           2), ("gcn_q_none", "gcn", {}, tiers, 2)))
    cal_graph = _graph(230, 77)
    for name in ("gcn_q", "gcn_q_none"):
        ref.calibrate(name, _as("jax", cal_graph))
        port.models[name].calibrations["int8"] = bridge.calibration_from_jax(
            _calibration_numpy(ref.models[name].calibrations["int8"]),
            device="cpu")
    out = _run_both(ref, port, _one_shots_and_queries(("gcn_q", "gcn_q_none"),
                                                      tier="int8"))
    s, _ = _assert_same(ref, port, out)
    assert {r.tier for r in out[1][1]} == {"int8"}
    # the attached graph's int8 Â is derived once and cached beside Â
    assert len(port._tier_operands) == 1
    assert port._cache.entry_sizes() == ref._cache.entry_sizes()


def test_gcn_auto_backend_on_cacheg_matches_reference(monkeypatch):
    for name, value in (("DENSE_RATE", rcosts.MXU_RATE),
                        ("GRASP_RATE", rcosts.MXU_RATE),
                        ("HBM_BW", rcosts.HBM_BW),
                        ("GRASP_STEP_OVERHEAD_S",
                         rsp.GRASP_STEP_OVERHEAD_S),
                        ("AGG_CALL_S", 0.0)):
        monkeypatch.setattr(tcosts, name, value)
    ref, port = _engines(buckets=(256, 1024))
    _register(ref, port, (("sp", "gcn", {}, dict(agg_backend="auto",
                                                 fusion="layer"), 3),))
    graphs = [_clustered(200, 1), _clustered(700, 2), _graph(600, 3, 40),
              _clustered(1000, 4, 0.02)]

    def script(pkg, eng):
        for g in graphs:
            eng.submit(_as(pkg, g), model="sp")
        gid = eng.attach(_as(pkg, _clustered(900, 9)), model="sp")
        eng.query(gid)
        eng.query(gid, fusion="none")
    out = _run_both(ref, port, script)
    s, _ = _assert_same(ref, port, out)
    backends = {(r.bucket, r.backend) for r in out[1][1]}
    assert {(256, "dense"), (1024, "grasp"), (1024, "dense")} <= backends
    assert s["grasp_batches"] > 0
    # structures derived on the device: only compact bytes crossed
    assert s["operand_bytes_h2d"] == (
        _compact_bytes("gcn", 256) + 4 * _compact_bytes("gcn", 1024))
    assert port._cache.entry_sizes() == ref._cache.entry_sizes()


def test_gat_serving_on_cacheg_matches_reference():
    ref, port = _engines()
    _register(ref, port, (("gat", "gat", {}, dict(fusion="layer"), 4),
                          ("gat_none", "gat", {}, {}, 4)))
    out = _run_both(ref, port, _one_shots_and_queries(("gat", "gat_none")))
    s, _ = _assert_same(ref, port, out)
    assert s["cache_resident_bytes"] == tcache.estimate_dense_entry_bytes(
        2, 128)


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_sage_serving_on_cacheg_matches_reference(aggregator):
    ref, port = _engines()
    cfg = dict(aggregator=aggregator)
    _register(ref, port, (("sage", "sage", cfg, dict(fusion="layer"), 5),
                          ("sage_none", "sage", cfg, {}, 5)))
    out = _run_both(ref, port, _one_shots_and_queries(
        ("sage", "sage_none"), sizes=(40, 130, 250)))
    s, _ = _assert_same(ref, port, out)
    assert s["operand_bytes_h2d"] == 2 * (
        _compact_bytes("sage", 128) + 2 * _compact_bytes("sage", 256)) \
        + _compact_bytes("sage", 128)


def test_directed_graph_takes_the_eager_path_and_is_counted():
    ref, port = _engines()
    _register(ref, port, (("gcn", "gcn", {}, dict(fusion="layer"), 6),
                          ("gat", "gat", {}, {}, 6),
                          ("sage", "sage", {}, {}, 6)))
    directed, undirected = _directed(100, 3), _graph(150, 4)

    def script(pkg, eng):
        for name in ("gcn", "gat", "sage"):
            eng.submit(_as(pkg, directed), model=name)
            eng.submit(_as(pkg, undirected), model=name)
        gid = eng.attach(_as(pkg, directed), model="gcn")
        eng.query(gid)
        eng.query(gid)
    out = _run_both(ref, port, script)
    s, rs = _assert_same(ref, port, out, skip=("operand_bytes_h2d",))
    # one-shot GCN and GAT, and the attached GCN's first query
    assert s["cacheg_fallbacks"] == 3
    placeholders = tmodels.PLACEHOLDER_BYTES * (4 + 3 + 4)
    assert s["operand_bytes_h2d"] + placeholders == rs["operand_bytes_h2d"]
    assert s["operand_bytes_h2d"] == (
        4 * 128 ** 2 * (1 + 2 + 1) + _compact_bytes("sage", 128)
        + _compact_bytes("gcn", 256) + _compact_bytes("gat", 256)
        + _compact_bytes("sage", 256))


# --------------------------------------------------------- budget and spill

CACHE_BUCKET = 128
ENTRY = tcache.estimate_dense_entry_bytes(1, CACHE_BUCKET)
assert ENTRY == rcache.estimate_dense_entry_bytes(1, CACHE_BUCKET)


def _cache_graph(n, seed):
    return planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=IN_FEATS,
                          num_classes=CLASSES, seed=seed, train_per_class=1)


def _cache_engine(budget, *, spill=True, admission="evict", tiers=None,
                  pkg="torch"):
    mod, graph_mod = (rserve, rg) if pkg == "jax" else (tserve, tg)
    sc = mod.GraphServeConfig(
        ladder=graph_mod.BucketLadder(buckets=(CACHE_BUCKET,)),
        batch_slots=2, return_logits=True, device_cache_budget_bytes=budget,
        spill_to_host=spill, admission=admission)
    eng = (rserve.GraphServe(sc, seed=0) if pkg == "jax"
           else tserve.GraphServe(sc, seed=0, device="cpu"))
    rcfg, tcfg = _cfgs("gcn")
    w = _weights("gcn", 0)
    if pkg == "jax":
        eng.register_model("gcn", rcfg, jax.tree_util.tree_map(
            jax.numpy.asarray, w), tiers=tiers)
    else:
        eng.register_model("gcn", tcfg, bridge.params_from_jax(
            w, device="cpu"), tiers=tiers)
    eng.warmup()
    return eng


def _assert_invariants(eng):
    cm = eng._cache
    assert sum(cm.entry_sizes().values()) == cm.resident_bytes
    if eng.sc.device_cache_budget_bytes is not None:
        assert cm.resident_bytes <= eng.sc.device_cache_budget_bytes
    assert cm.evictions == cm.spilled + cm.dropped


CACHE_KEYS = ("cache_resident_bytes", "cache_evictions", "cache_spilled",
              "cache_dropped", "cache_spill_entries", "cache_spill_hits",
              "cache_admission_rejects", "operand_cache_hits",
              "operand_cache_misses", "operand_bytes_h2d")


def _both_caches(budget, steps, **kw):
    """Feed one step sequence to both packages' budgeted engines; after
    every step the invariants hold and the cache counters are equal."""
    engines = {pkg: _cache_engine(budget, pkg=pkg, **kw)
               for pkg in ("jax", "torch")}
    state = {pkg: {} for pkg in engines}
    for step in steps:
        for pkg, eng in engines.items():
            step(pkg, eng, state[pkg])
            _assert_invariants(eng)
        s, rs = engines["torch"].summary(), engines["jax"].summary()
        assert {k: s[k] for k in CACHE_KEYS} == {k: rs[k] for k in CACHE_KEYS}
        assert (engines["torch"]._cache.entry_sizes()
                == engines["jax"]._cache.entry_sizes())
    return engines, state


def test_churn_soak_respects_budget_at_every_step():
    """Attach/query/detach churn under a budget fitting ~8 graphs: the
    §13 invariants hold after every step in both packages, every cache
    counter and entry size is equal, and nothing traces."""
    budget = 8 * ENTRY + 8 * ENTRY // 4

    def cycle(i):
        def step(pkg, eng, st):
            if i == 0:
                eng.calibrate("gcn", _as(pkg, _cache_graph(64, 999)))
                st["blobs"], st["live"] = eng.compiled_blobs, []
            gid = eng.attach(_as(pkg, _cache_graph(20 + (i % 40), i)),
                             model="gcn")
            st["live"].append(gid)
            eng.query(gid, tier="int8" if i % 3 else "fp32")
            eng.run()
            if i % 5 == 4:
                eng.detach(st["live"].pop(0))
        return step
    engines, state = _both_caches(budget, [cycle(i) for i in range(200)],
                                  tiers=("fp32", "int8"))
    port = engines["torch"]
    assert port._cache.evictions > 0
    assert port.compiled_blobs == state["torch"]["blobs"]
    port.assert_warm()
    for gid in state["torch"]["live"]:
        port.detach(gid)
    _assert_invariants(port)
    assert port._cache.resident_bytes == 0


def test_evicted_graph_answers_bit_identically_via_spill():
    """Budget fits 2 graphs; 5 attach+query. Re-querying the evicted ones
    faults into the spill store and answers bit-identically, warm."""
    def first(i):
        def step(pkg, eng, st):
            gid = eng.attach(_as(pkg, _cache_graph(30 + i, 100 + i)),
                             model="gcn")
            eng.query(gid)
            st[gid] = np.asarray(eng.run()[-1].logits)
        return step

    def again(gid):
        def step(pkg, eng, st):
            eng.query(gid)
            np.testing.assert_array_equal(np.asarray(eng.run()[-1].logits),
                                          st[gid])
        return step
    engines, state = _both_caches(2 * ENTRY + ENTRY // 2,
                                  [first(i) for i in range(5)]
                                  + [again(g) for g in range(5)])
    port = engines["torch"]
    assert port._cache.evictions >= 3 and port._cache.spilled >= 3
    assert port.metrics["cache_spill_hits"] >= 3
    assert port.metrics["operand_cache_misses"] == 5
    for gid, lg in state["torch"].items():
        np.testing.assert_allclose(lg, state["jax"][gid], **TOL)
    # a fault moved only compact bytes: 5 misses and every spill hit
    s = port.summary()
    assert s["operand_bytes_h2d"] == (5 + s["cache_spill_hits"]) * \
        _compact_bytes("gcn", CACHE_BUCKET)
    port.assert_warm()


def test_spill_disabled_drops_and_rebuilds():
    def query(gid, n=None, seed=None):
        def step(pkg, eng, st):
            if n is not None:
                eng.attach(_as(pkg, _cache_graph(n, seed)), model="gcn")
            eng.query(gid)
            st.setdefault(gid, []).append(np.asarray(eng.run()[-1].logits))
        return step
    engines, state = _both_caches(ENTRY + ENTRY // 2,
                                  [query(0, 30, 1), query(1, 31, 2),
                                   query(0)], spill=False)
    port = engines["torch"]
    cm = port._cache
    assert cm.evictions == cm.dropped >= 1 and cm.spilled == 0
    assert cm.spill_entries == 0
    assert port.metrics["operand_cache_misses"] == 3
    assert port.metrics["cache_spill_hits"] == 0
    np.testing.assert_array_equal(*state["torch"][0])
    port.assert_warm()


@pytest.mark.parametrize("policy", ["evict", "reject"])
def test_admission_rejects_entry_that_can_never_fit(policy):
    for pkg, err in (("torch", tcache.CacheAdmissionError),
                     ("jax", rcache.CacheAdmissionError)):
        eng = _cache_engine(ENTRY // 2, admission=policy, pkg=pkg)
        with pytest.raises(err):
            eng.attach(_as(pkg, _cache_graph(30, 1)), model="gcn")
        assert eng.metrics["cache_admission_rejects"] == 1
        assert eng.graphs == {}


@pytest.mark.parametrize("policy", ["evict", "reject"])
def test_admission_policies_match_reference(policy):
    """"evict" admits and lets insert-time eviction make room; "reject"
    refuses an attach that would overflow the current residency."""
    def attach_query(n, seed, expect_reject=False):
        def step(pkg, eng, st):
            err = (tcache if pkg == "torch" else rcache).CacheAdmissionError
            if expect_reject and policy == "reject":
                with pytest.raises(err):
                    eng.attach(_as(pkg, _cache_graph(n, seed)), model="gcn")
                return
            gid = eng.attach(_as(pkg, _cache_graph(n, seed)), model="gcn")
            eng.query(gid)
            eng.run()
        return step

    def detach(gid):
        return lambda pkg, eng, st: eng.detach(gid)
    engines, _ = _both_caches(ENTRY + ENTRY // 2, [
        attach_query(30, 1), attach_query(31, 2, expect_reject=True),
        detach(0), attach_query(32, 3)], admission=policy)
    s = engines["torch"].summary()
    if policy == "reject":
        assert s["cache_admission_rejects"] == 1 and s["cache_evictions"] == 0
    else:
        assert s["cache_admission_rejects"] == 0 and s["cache_evictions"] >= 1


def test_unbudgeted_engine_never_evicts():
    eng = _cache_engine(None)
    for i in range(6):
        gid = eng.attach(_cache_graph(25 + i, i), model="gcn")
        eng.query(gid)
        eng.run()
    cm = eng._cache
    assert cm.evictions == 0 and cm.resident_bytes == 6 * ENTRY
    _assert_invariants(eng)


def test_manager_rejects_oversized_entry_without_breaking_budget():
    cm = tcache.DeviceCacheManager(budget_bytes=100)
    assert not cm.put("operand", (0, 0), "big", nbytes=101)
    assert cm.resident_bytes == 0
    assert cm.put("operand", (0, 0), "ok", nbytes=60)
    assert cm.put("operand", (1, 0), "ok2", nbytes=60)  # evicts (0, 0)
    assert cm.resident_bytes == 60
    assert cm.evictions == 1 and cm.dropped == 1        # no spill_fn
    assert cm.get("operand", (0, 0)) is None
    assert cm.get("operand", (1, 0)) == "ok2"


def test_manager_derived_evicts_before_primary_and_lru_groups():
    cm = tcache.DeviceCacheManager(budget_bytes=100)
    cm.put("operand", (0, 0), "p0", nbytes=40)
    cm.put("tier", (0, 0), "d0", nbytes=10)
    cm.put("operand", (1, 0), "p1", nbytes=40)
    cm.put("operand", (2, 0), "p2", nbytes=15)   # needs 5 bytes freed
    assert cm.get("tier", (0, 0)) is None
    assert cm.get("operand", (0, 0)) == "p0"
    assert cm.get("operand", (1, 0)) == "p1"
    cm.get("operand", (0, 0))
    cm.put("operand", (3, 0), "p3", nbytes=40)
    assert cm.get("operand", (1, 0)) is None
    assert cm.get("operand", (0, 0)) == "p0"


def test_manager_invalidate_is_not_an_eviction():
    cm = tcache.DeviceCacheManager(budget_bytes=100)
    cm.put("operand", (0, 0), "p", nbytes=40, spill_fn=lambda: "packed")
    cm.put("tier", (0, 0), "d", nbytes=10)
    assert cm.invalidate((0, 0)) == 2
    assert cm.resident_bytes == 0
    assert (cm.evictions, cm.spilled, cm.dropped) == (0, 0, 0)
    assert cm.invalidate((0, 0)) == 0


def test_manager_spill_roundtrip_and_conservation():
    cm = tcache.DeviceCacheManager(budget_bytes=50)
    cm.put("operand", (0, 0), "p0", nbytes=40, spill_fn=lambda: "packed0")
    cm.put("operand", (1, 0), "p1", nbytes=40)   # evicts+spills (0, 0)
    assert cm.spilled == 1 and cm.spill_entries == 1
    assert cm.spill_get("operand", (0, 0)) == "packed0"
    assert cm.spill_hits == 1
    cm.put("operand", (0, 0), "p0", nbytes=40, spill_fn=lambda: "packed0")
    cm.put("operand", (1, 0), "p1", nbytes=40)
    assert cm.evictions == cm.spilled + cm.dropped
    assert cm.spill_get("operand", (0, 0)) == "packed0"


def test_manager_budget_validation():
    for bad in (0, -5):
        with pytest.raises(ValueError):
            tcache.DeviceCacheManager(budget_bytes=bad)


def test_tree_nbytes_equals_reference_pytree_nbytes():
    pg, rpg = _pads(200, 256)
    t_ops = tmodels.build_operands(pg, _cfgs("gcn")[1], device="cpu")
    r_ops = rmodels.build_operands(rpg, _cfgs("gcn")[0], lean=True)
    assert tmodels.operand_nbytes(t_ops) == rcache.pytree_nbytes(r_ops)
    sp, _ = tmodels.BlockCompactor()(t_ops.norm_adj, max_nnz=2)
    rsp_, _ = rmodels.build_block_compactor()(r_ops.norm_adj, max_nnz=2)
    assert tcache.tree_nbytes(("grasp", sp)) == rcache.pytree_nbytes(
        ("grasp", rsp_))
    assert tcache.tree_nbytes(("dense", None)) == 0
    tops = tmodels.derive_tier_operands(t_ops.norm_adj)
    assert tcache.tree_nbytes(tops) == 256 * 256 + 256 * 4


# -------------------------------------------------------------- update()

def test_update_rebuilds_once_and_counts_rebucket_events():
    ref, port = _engines()
    _register(ref, port, (("gcn", "gcn", {}, dict(fusion="layer"), 7),))

    def script(pkg, eng):
        gid = eng.attach(_as(pkg, _graph(60, 1)), model="gcn")
        eng.query(gid)
        eng.query(gid)
        g2 = _graph(100, 2)                      # same bucket: no rebucket
        assert eng.update(gid, g2.edge_index, g2.num_nodes,
                          g2.features) is False
        eng.query(gid)
        eng.query(gid)
        g3 = _graph(200, 3)                      # climbs to 256
        assert eng.update(gid, g3.edge_index, g3.num_nodes,
                          g3.features) is True
        eng.query(gid)
        untouched = eng.attach(_as(pkg, _graph(50, 4)), model="gcn")
        g4 = _graph(70, 5)                       # update before any query
        eng.update(untouched, g4.edge_index, g4.num_nodes, g4.features)
        eng.query(untouched)
    out = _run_both(ref, port, script)
    s, _ = _assert_same(ref, port, out)
    assert (s["operand_cache_misses"], s["operand_cache_hits"]) == (4, 2)
    assert s["rebucket_events"] == 1
    assert (s["cache_evictions"], s["cache_spilled"],
            s["cache_dropped"]) == (0, 0, 0)
    assert sorted(r.bucket for r in out[1][1]) == [128] * 5 + [256]
    # the old versions' entries are gone; each graph keeps its newest
    assert sorted(port._operands) == [(0, 2), (1, 1)]


@given(n=st.integers(1, 300), e=st.integers(0, 900),
       seed=st.integers(0, 2 ** 16), undirected=st.booleans())
def test_edge_keys_give_the_dense_products(n, e, seed, undirected):
    """The engine's O(E) host path (`adjacency_keys`) checks, packs and
    counts exactly what the dense matrix gives: duplicate edges, explicit
    self-loops and directed graphs included."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    if undirected:
        ei = np.concatenate([ei, ei[::-1]], axis=1)
    cap = tg.node_bucket(n)
    adj = tg.dense_adjacency(ei, cap, self_loops=False)
    keys = tg.adjacency_keys(ei, cap)
    assert tg.keys_symmetric(keys, cap) == rg.is_symmetric_adjacency(adj)
    assert np.array_equal(tg.symg_pack_keys(keys, cap),
                          rg.symg_pack_adjacency_bits(adj, check=False))
    assert np.array_equal(tmodels.gcn_degree(adj, n, keys),
                          tmodels.gcn_degree(adj, n))
    pg = tg.PaddedGraph(capacity=cap, num_nodes=n,
                        features=np.zeros((cap, 1), np.float32),
                        norm_adj=adj, adj=adj,
                        node_mask=np.ones((cap,), np.float32))
    if undirected:
        for kind in ("gcn", "gat"):
            a = tmodels.compact_operands(pg, _cfgs(kind)[1], keys=keys)
            b = tmodels.compact_operands(pg, _cfgs(kind)[1])
            assert torch.equal(a.packed, b.packed)
            assert torch.equal(a.degree, b.degree)


# ------------------------------------------------- the lazy host structure

@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_cacheg_burst_never_builds_the_dense_structure(kind):
    """CacheG packs an undirected graph from its edge keys: after `run()`
    no request's padded graph, one-shot or attached, has built its dense
    Â or adjacency. The answers equal the reference's and the eager
    path's (which builds Â) at the 1e-5 bar."""
    models = ((kind, kind, {}, dict(fusion="layer"), 5),
              (f"{kind}_none", kind, {}, {}, 5))
    ref, port = _engines()
    _register(ref, port, models)
    script = _one_shots_and_queries((kind, f"{kind}_none"))
    out = _run_both(ref, port, script)
    _assert_same(ref, port, out)
    done = out[1][1]
    assert len(done) == 2 * len(SIZES) + 2
    for r in done:
        assert not r.pg.built("norm_adj") and not r.pg.built("adj"), r.uid
    assert not any(pg.built("norm_adj") or pg.built("adj")
                   for _, pg in port.graphs.values())
    eager = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True, use_cacheg=False), device="cpu")
    for name, k, cfg_kw, kw, seed in models:
        eager.register_model(name, _cfgs(k, **cfg_kw)[1],
                             bridge.params_from_jax(_weights(k, seed),
                                                    device="cpu"), **kw)
    eager.warmup()
    script("torch", eager)
    by_uid = {r.uid: r for r in eager.run()}
    assert sorted(by_uid) == sorted(r.uid for r in done)
    assert eager.summary()["operand_bytes_h2d"] > port.summary()[
        "operand_bytes_h2d"]
    for r in done:
        np.testing.assert_array_equal(r.preds, by_uid[r.uid].preds)
        np.testing.assert_allclose(r.logits, by_uid[r.uid].logits, **TOL)
    read = "norm_adj" if kind == "gcn" else "adj"     # the eager build's
    assert all(r.pg.built(read) for r in by_uid.values())


@pytest.mark.parametrize("norm", ["gcn", "mean"])
@pytest.mark.parametrize("n,cap,seed,directed", [
    (40, 128, 0, False), (128, 128, 1, True), (200, 256, 2, False),
    (1, 128, 3, True)])
def test_deferred_structure_equals_reference_pad_graph(n, cap, seed,
                                                       directed, norm):
    """`pad_graph` builds Â and the adjacency only when read, and then
    they equal the reference's `pad_graph` bit for bit: duplicate edges,
    explicit self-loops and directed graphs included. A caller that
    reuses its edge array after padding does not change them."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, 3 * n)).astype(np.int32)
    ei = np.concatenate([ei, np.asarray([[0, n - 1], [0, n - 1]], np.int32),
                         ei[:, :5]], axis=1)
    if not directed:
        ei = np.concatenate([ei, ei[::-1]], axis=1)
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    pg = tg.pad_graph(tg.Graph(edge_index=ei, num_nodes=n, features=feats),
                      capacity=cap, norm=norm)
    want = rg.pad_graph(rg.Graph(edge_index=ei.copy(), num_nodes=n,
                                 features=feats), capacity=cap, norm=norm)
    assert not pg.built("norm_adj") and not pg.built("adj")
    kept = ei.copy()
    ei[:] = 0                                   # the caller reuses its array
    for name in ("adj", "norm_adj"):
        got = getattr(pg, name)
        assert pg.built(name)
        assert got.dtype == getattr(want, name).dtype
        assert np.array_equal(got, getattr(want, name)), name
        assert getattr(pg, name) is got         # built once, then kept
    for name in ("features", "node_mask"):
        assert np.array_equal(getattr(pg, name), getattr(want, name))
    conv = rg.PaddedGraph(**dataclasses.asdict(tg.pad_graph(
        tg.Graph(edge_index=kept, num_nodes=n, features=feats),
        capacity=cap, norm=norm)))               # the tests' conversion
    assert np.array_equal(conv.norm_adj, want.norm_adj)
    assert np.array_equal(conv.adj, want.adj)


def test_deferred_structure_through_updates_and_unknown_norm():
    """`update_edges` and `BucketLadder.grow` keep the matrices deferred
    and give the reference's values when read; an unknown norm raises at
    `pad_graph`, as the reference's does."""
    g1, g2 = _graph(60, 1), _graph(100, 2)
    ladder_t, ladder_r = tg.BucketLadder(buckets=BUCKETS), rg.BucketLadder(
        buckets=BUCKETS)
    pt, pr = ladder_t.pad(g1), ladder_r.pad(_as("jax", g1))
    for norm in ("gcn", "mean"):
        ut = tg.update_edges(pt, g2.edge_index, g2.num_nodes, norm=norm)
        ur = rg.update_edges(pr, g2.edge_index, g2.num_nodes, norm=norm)
        assert not ut.built("norm_adj") and not ut.built("adj")
        assert np.array_equal(ut.norm_adj, ur.norm_adj)
        assert np.array_equal(ut.adj, ur.adj)
    for grown in (_graph(110, 3), _graph(200, 4)):
        (gt, bt), (gr, br) = (
            ladder_t.grow(pt, grown.edge_index, grown.num_nodes,
                          grown.features),
            ladder_r.grow(pr, grown.edge_index, grown.num_nodes,
                          grown.features))
        assert bt == br and gt.capacity == gr.capacity
        assert not gt.built("norm_adj") and not gt.built("adj")
        for name in ("features", "norm_adj", "adj", "node_mask", "labels"):
            assert np.array_equal(getattr(gt, name), getattr(gr, name)), name
    with pytest.raises(ValueError, match="unknown norm"):
        tg.pad_graph(g1, capacity=128, norm="sym")
