"""PyTorch port, the GrAd slice: edge deltas. The host products
(`apply_edge_delta`, the patched edge keys, `dynamic_graph_stream`), the
device patch (`patch_operands`, `patch_tier_operands`, `DeltaPatcher`) and
GraphServe's `update_delta`, each against the reference package on the
same numpy inputs and weights, and the port's own contract: a delta
followed by a query equals a fresh `attach` of the patched structure.

Tolerance: the host products, the edge keys, counters, batches and argmax
are equal exactly. The port's patched operands, int8 Â and logits equal a
rebuild of the patched structure bit for bit: the patch forms D^-1/2 from
the patched degree vector with `inv_sqrt_degree`, as the materializer
does. The reference's patch uses the host's D^-1/2 instead, which may sit
1 ulp from its materializer's (ROADMAP queue 3), so the port's patched Â
is held within 1e-7 of the reference's patch, and served logits within
rtol=atol=1e-5 of the reference engine's (XLA's and ATen's CPU dots sum
in different orders).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import costs as rcosts
from repro.core import graph as rg
from repro.core import models as rmodels
from repro.core import sparsity as rsp
from repro.data import graphs as rdata
from repro.runtime import gnn_server as rserve
from repro_torch import bridge
from repro_torch.core import costs as tcosts
from repro_torch.core import graph as tg
from repro_torch.core import models as tmodels
from repro_torch.data import graphs as tdata
from repro_torch.runtime import cache as tcache
from repro_torch.runtime import gnn_server as tserve
from repro_torch.runtime.clock import Clock

TOL = dict(rtol=1e-5, atol=1e-5)
IN_FEATS, HIDDEN, HEADS, CLASSES = 16, 16, 4, 4
SLOTS = 2
COUNTERS = ("delta_updates", "delta_fallbacks", "operand_cache_hits",
            "operand_cache_misses", "compiled_blobs", "operand_bytes_h2d",
            "rebucket_events", "batches", "grasp_batches",
            "cache_resident_bytes")
FEW = settings(max_examples=10, deadline=None)


@pytest.fixture(autouse=True)
def _ref_kernels(monkeypatch):
    """The reference's kernels as their jnp twins (the port runs its plain
    versions on the CPU; the kernels are held against those elsewhere)."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


def _graph(n, seed):
    return tdata.planetoid_like(num_nodes=n, num_edges=3 * n,
                                num_feats=IN_FEATS, num_classes=CLASSES,
                                seed=seed, train_per_class=1)


def _clustered(n, seed):
    return tdata.clustered_like(num_nodes=n, num_feats=IN_FEATS,
                                num_classes=CLASSES, within_density=0.05,
                                seed=seed)


def _as_ref(g):
    return rg.Graph(**dataclasses.asdict(g))


def _pick(adj, n, n_add, n_rm, rng):
    """`n_add` absent and `n_rm` present undirected pairs of the graph."""
    iu, ju = np.triu_indices(n, 1)
    on = adj[iu, ju] != 0
    out = []
    for pool, k in ((np.flatnonzero(~on), n_add), (np.flatnonzero(on), n_rm)):
        sel = rng.choice(pool, size=min(k, len(pool)), replace=False)
        out.append(np.stack([iu[sel], ju[sel]], axis=1).astype(np.int64))
    return out


def _cfg(kind, **kw):
    return tmodels.GNNConfig(kind=kind, in_feats=IN_FEATS, hidden=HIDDEN,
                             num_classes=CLASSES, heads=HEADS, **kw)


# ------------------------------------------------------------ host products

@given(n=st.integers(5, 120), seed=st.integers(0, 2 ** 16),
       n_add=st.integers(0, 6), n_rm=st.integers(0, 6),
       junk=st.booleans())
def test_apply_edge_delta_equals_reference(n, seed, n_add, n_rm, junk):
    """Every field bit for bit, None together; and the patched Â equals a
    rebuild of the patched structure."""
    rng = np.random.default_rng(seed)
    pg = tg.pad_graph(_graph(n, seed), capacity=128)
    add, rm = _pick(pg.adj, n, n_add + junk, n_rm + junk, rng)
    if junk:       # an ineffective flip and a self loop each way, a repeat
        add, rm = (np.concatenate([add[:-1], rm[-1:], [[1, 1]],
                                   add[:-1][:1, ::-1]]),
                   np.concatenate([rm[:-1], add[-1:], [[2, 2]]]))
    got = tg.apply_edge_delta(pg.adj, pg.norm_adj, n, add, rm)
    want = rg.apply_edge_delta(pg.adj, pg.norm_adj, n, add, rm)
    if not len(add) and not len(rm) or want is None:
        assert got is None and want is None
        return
    for f in ("adj", "norm_adj", "dis", "flip_i", "flip_j", "flip_v",
              "touched"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    edges = tg.edge_index_from_adjacency(got.adj, n)
    assert np.array_equal(edges, rg.edge_index_from_adjacency(got.adj, n))
    assert np.array_equal(got.norm_adj,
                          tg.gcn_norm_adjacency(edges, n, 128))


@pytest.mark.parametrize("seed,nodes,edges", [(0, 2, 16), (3, 5, 7)])
def test_dynamic_graph_stream_equals_reference(seed, nodes, edges):
    base = _graph(40, seed)
    got = tdata.dynamic_graph_stream(base, steps=4, edges_per_step=edges,
                                     nodes_per_step=nodes, seed=seed)
    want = rdata.dynamic_graph_stream(_as_ref(base), steps=4,
                                      edges_per_step=edges,
                                      nodes_per_step=nodes, seed=seed)
    for (e1, n1, f1), (e2, n2, f2) in zip(got, want, strict=True):
        assert n1 == n2 and e1.dtype == e2.dtype and f1.dtype == f2.dtype
        assert np.array_equal(e1, e2) and np.array_equal(f1, f2)


@given(n=st.integers(5, 120), seed=st.integers(0, 2 ** 16),
       n_add=st.integers(0, 8), n_rm=st.integers(0, 8))
def test_patched_keys_equal_keys_of_patched_adjacency(n, seed, n_add, n_rm):
    """`patch_adjacency_keys` gives the patched matrix's edge keys, and
    `keys_neighbours` its dense neighbour rows."""
    rng = np.random.default_rng(seed)
    g = _graph(n, seed)
    pg = tg.pad_graph(g, capacity=128)
    add, rm = _pick(pg.adj, n, n_add, n_rm, rng)
    delta = tg.apply_edge_delta(pg.adj, pg.norm_adj, n, add, rm)
    if delta is None:
        return
    keys = tg.patch_adjacency_keys(tg.adjacency_keys(g.edge_index, 128), 128,
                                   delta)
    edges = tg.edge_index_from_adjacency(delta.adj, n)
    assert np.array_equal(keys, tg.adjacency_keys(edges, 128))
    assert tg.keys_symmetric(keys, 128)
    assert np.array_equal(
        tg.keys_neighbours(keys, 128, delta.touched),
        np.flatnonzero(delta.adj[:, delta.touched].any(axis=1)))


@pytest.mark.parametrize("case", ["out of range", "negative", "both sides"])
def test_apply_edge_delta_rejects_caller_errors(case):
    pg = tg.pad_graph(_graph(30, 1), capacity=128)
    add, rm = {"out of range": ([[3, 30]], None),
               "negative": (None, [[-1, 4]]),
               "both sides": ([[3, 9], [4, 5]], [[9, 3]])}[case]
    for mod in (tg, rg):
        with pytest.raises(ValueError):
            mod.apply_edge_delta(pg.adj, pg.norm_adj, 30, add, rm)


def test_apply_edge_delta_skips_what_changes_nothing():
    pg = tg.pad_graph(_graph(30, 1), capacity=128)
    absent, present = (p[0] for p in _pick(pg.adj, 30, 1, 1,
                                           np.random.default_rng(0)))
    for add, rm in (([[4, 4]], None), ([present], None), (None, [absent]),
                    (None, None)):
        assert tg.apply_edge_delta(pg.adj, pg.norm_adj, 30, add, rm) is None


# ------------------------------------------------------------- device patch

def _patched_pair(kind, cap, n, seed, n_add=4, n_rm=4):
    """A graph's materialized operands, the delta, its spec, and the
    materializer's operands for the patched compact form."""
    cfg = _cfg(kind)
    g = _graph(n, seed)
    pg = tg.pad_graph(g, capacity=cap)
    keys = tg.adjacency_keys(g.edge_index, cap)
    mat = tmodels.build_materializer("cpu")
    ops = mat(tmodels.compact_operands(pg, cfg, keys=keys))
    add, rm = _pick(pg.adj, n, n_add, n_rm, np.random.default_rng(seed))
    delta = tg.apply_edge_delta(pg.adj, pg.norm_adj, n, add, rm)
    keys2 = tg.patch_adjacency_keys(keys, cap, delta)
    pg2 = dataclasses.replace(pg, adj=delta.adj, norm_adj=delta.norm_adj)
    kt = 64
    pad = lambda a, k, dt: torch.from_numpy(np.concatenate(  # noqa: E731
        [a, np.full((k - len(a),), a[0])]).astype(dt))
    spec = tmodels.DeltaSpec(
        flip_i=pad(delta.flip_i, 2 * kt, np.int32),
        flip_j=pad(delta.flip_j, 2 * kt, np.int32),
        flip_v=pad(delta.flip_v, 2 * kt, np.float32),
        touched=pad(delta.touched, kt, np.int32),
        degree=torch.from_numpy(tmodels.gcn_degree(pg2.adj, n, keys2)),
        fields=tmodels.OPERAND_FIELDS[kind])
    want = mat(tmodels.compact_operands(pg2, cfg, keys=keys2))
    return ops, delta, spec, want, keys2


@pytest.mark.parametrize("cap,n", [(128, 100), (256, 230)])
@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_patch_operands_equal_materializer(kind, cap, n):
    ops, delta, spec, want, _ = _patched_pair(kind, cap, n, seed=cap + n)
    before = {f: getattr(ops, f).clone()
              for f in tmodels.OPERAND_FIELDS[kind]}
    got = tmodels.patch_operands(ops, spec)
    for f in tmodels.OPERAND_FIELDS[kind]:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(getattr(ops, f), before[f]), f"{f} was written"
    # the reference's patch of the same entry, with its host D^-1/2
    jnp = jax.numpy
    rspec = rmodels.DeltaSpec(
        flip_i=jnp.asarray(spec.flip_i), flip_j=jnp.asarray(spec.flip_j),
        flip_v=jnp.asarray(spec.flip_v), touched=jnp.asarray(spec.touched),
        dirty=jnp.asarray(spec.touched), dis=jnp.asarray(delta.dis),
        fields=spec.fields)
    rops = rmodels.GranniteOperands(**{
        f: jnp.asarray(before[f].numpy() if f in before
                       else np.zeros((1, 1), np.float32))
        for f in ("norm_adj", "mask_mult", "bias_add", "sample_mask",
                  "mean_mask")})
    ref = rmodels.patch_operands(rops, rspec)
    for f in tmodels.OPERAND_FIELDS[kind]:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("cap,n", [(128, 100), (256, 230)])
def test_patch_tier_operands_equal_full_requant(cap, n):
    ops, delta, spec, want, keys2 = _patched_pair("gcn", cap, n, seed=n,
                                                  n_add=2, n_rm=2)
    tops = tmodels.derive_tier_operands(ops.norm_adj)
    na = tmodels.patch_operands(ops, spec).norm_adj
    rows = np.union1d(delta.touched,
                      tg.keys_neighbours(keys2, cap, delta.touched))
    assert len(rows) < 128
    rows = np.concatenate([rows, np.full((128 - len(rows),), rows[0])])
    got = tmodels.patch_tier_operands(tops, na,
                                      torch.from_numpy(rows.astype(np.int32)))
    full = tmodels.derive_tier_operands(want.norm_adj)
    assert torch.equal(got.agg_aq, full.agg_aq)
    assert torch.equal(got.agg_a_scale, full.agg_a_scale)
    assert not torch.equal(got.agg_aq, tops.agg_aq)   # a row did change
    assert torch.equal(tops.agg_aq,
                       tmodels.derive_tier_operands(ops.norm_adj).agg_aq)


def test_delta_patcher_counts_one_trace_per_signature():
    ops, _, spec, _, _ = _patched_pair("gcn", 128, 100, seed=5)
    p = tmodels.DeltaPatcher()
    for _ in range(3):
        p(ops, spec)
    assert p.trace_count == 1
    p(ops, dataclasses.replace(spec, touched=spec.touched[:32]))
    tops = tmodels.derive_tier_operands(ops.norm_adj)
    for _ in range(2):
        p.patch_tier(tops, ops.norm_adj, spec.touched)
    assert p.trace_count == 3


# ----------------------------------------------- the engine vs the reference

def _weights(kind, seed, **cfg_kw):
    cfg = rmodels.GNNConfig(kind=kind, in_feats=IN_FEATS, hidden=HIDDEN,
                            num_classes=CLASSES, heads=HEADS, **cfg_kw)
    p = rmodels.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, jax.tree_util.tree_map(np.asarray, p)


def _calibration_numpy(cal):
    return {k: ({"wq": np.asarray(v.wq), "w_scale": np.asarray(v.w_scale),
                 "x_scale": np.asarray(v.x_scale)}
                if hasattr(v, "wq") else np.asarray(v))
            for k, v in cal.items()}


def _pair(kind, buckets, register, calibrate=None, **sc):
    """A reference engine and a port engine with the same weights (and the
    reference's calibration), warm."""
    rcfg, w = _weights(kind, 7)
    ref = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=buckets), batch_slots=SLOTS,
        return_logits=True, **sc))
    port = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=buckets), batch_slots=SLOTS,
        return_logits=True, **sc), device="cpu")
    ref.register_model("m", rcfg, jax.tree_util.tree_map(jax.numpy.asarray,
                                                          w), **register)
    port.register_model("m", _cfg(kind), bridge.params_from_jax(
        w, device="cpu"), **register)
    for eng in (ref, port):
        eng.warmup()
    if calibrate is not None:
        ref.calibrate("m", _as_ref(calibrate))
        port.models["m"].calibrations["int8"] = bridge.calibration_from_jax(
            _calibration_numpy(ref.models["m"].calibrations["int8"]),
            device="cpu")
    return ref, port


ENGINE_CASES = {
    "gcn": ("gcn", (128,), dict(fusion="layer"), None),
    "gcn_int8": ("gcn", (128,), dict(tiers=("fp32", "int8"),
                                     default_tier="int8"), "calibrate"),
    "gcn_auto": ("gcn", (256, 1024), dict(agg_backend="auto",
                                          fusion="layer"), None),
    "gat": ("gat", (128,), dict(fusion="layer"), None),
    "gat_int8": ("gat", (128,), dict(tiers=("fp32", "int8"),
                                     default_tier="int8"), "calibrate"),
    "sage": ("sage", (128,), {}, None),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_update_delta_matches_reference(case, monkeypatch):
    """One attached graph through a query, three deltas (the second
    ineffective, the third past K_t, so it falls back), a query after each:
    the port's logits match the reference engine's, with equal counters."""
    kind, buckets, register, cal = ENGINE_CASES[case]
    if case == "gcn_auto":
        for name, value in (("DENSE_RATE", rcosts.MXU_RATE),
                            ("GRASP_RATE", rcosts.MXU_RATE),
                            ("HBM_BW", rcosts.HBM_BW),
                            ("GRASP_STEP_OVERHEAD_S",
                             rsp.GRASP_STEP_OVERHEAD_S),
                            ("AGG_CALL_S", 0.0)):
            monkeypatch.setattr(tcosts, name, value)
        g = _clustered(900, 9)
    else:
        g = _graph(100, 3)
    ref, port = _pair(kind, buckets, register,
                      calibrate=_graph(110, 77) if cal else None,
                      delta_pad_rows=16)
    n = g.num_nodes
    pg = tg.pad_graph(g, capacity=port.sc.ladder.bucket_for(n))
    rng = np.random.default_rng(1)
    # GraSp traffic keeps its flips inside one 128-node community
    local = 128 if case == "gcn_auto" else n
    add, rm = _pick(pg.adj, local, 4, 4, rng)
    big = _pick(pg.adj, n, 20, 0, rng)[0]
    out = {}
    for pkg, eng in (("jax", ref), ("torch", port)):
        gid = eng.attach(_as_ref(g) if pkg == "jax" else g, model="m")
        res = [eng.query(gid)]
        eng.run()
        res.append(eng.update_delta(gid, add_edges=add, remove_edges=rm))
        eng.query(gid)
        eng.run()
        res.append(eng.update_delta(gid, add_edges=add))     # no change
        res.append(eng.update_delta(gid, add_edges=big))     # past K_t
        eng.query(gid)
        done = eng.run()
        eng.assert_warm()
        out[pkg] = (res, [(r.backend, r.tier, r.preds, r.logits)
                          for r in done], eng.summary(), eng)
    (rres, rdone, rs, _), (tres, tdone, ts, _) = out["jax"], out["torch"]
    patched = kind != "sage"
    assert rres[1:] == tres[1:] == [patched, True, False]
    assert len(tdone) == len(rdone) == 3
    for (tb, tt, tp, tl), (rb, rt, rp, rl) in zip(tdone, rdone):
        assert (tb, tt) == (rb, rt)
        np.testing.assert_array_equal(tp, rp)
        np.testing.assert_allclose(tl, rl, **TOL)
    for k in COUNTERS:
        assert ts[k] == rs[k], (k, ts[k], rs[k])
    assert (ts["delta_updates"], ts["delta_fallbacks"]) == (
        (1, 1) if patched else (0, 2))
    if case == "gcn_auto":
        # the patched Â re-derived its GraSp structure on the device
        assert [b for b, *_ in tdone][:2] == ["grasp", "grasp"]
    if patched:
        assert ts["delta_bytes_h2d"] > 0


# ---------------------------------------- the port's delta == fresh attach

_ENGINES = {}


class _ModelOrderClock(Clock):
    """Virtual time in which a GraSp batch costs less than a dense one,
    the order the cost model gives the clustered graphs. The backend rule
    takes the latency bank's measured dense/GraSp pair once both have
    served at a bucket (the `auto` engine serves dense int8 batches too),
    so on the wall clock the routing would follow the CPU's timing."""

    def __init__(self):
        self._now = 0.0

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self._now += seconds

    def on_batch(self, key, span=None) -> None:
        self._now += 1e-3 if key[3] == "grasp" else 2e-3


def _engine(kind):
    """Warm module-scope port engines, one per kind (an `auto` GCN on a
    (256, 1024) ladder for the GraSp re-derive), each QuantGr tier
    calibrated once."""
    if kind not in _ENGINES:
        buckets = (256, 1024) if kind == "auto" else (128, 256)
        eng = tserve.GraphServe(tserve.GraphServeConfig(
            ladder=tg.BucketLadder(buckets=buckets), batch_slots=SLOTS,
            return_logits=True), clock=_ModelOrderClock(), device="cpu")
        base = "gcn" if kind == "auto" else kind
        eng.register_model(kind, _cfg(base), tiers=("fp32", "int8"),
                           agg_backend="auto" if kind == "auto" else "dense",
                           fusion="layer")
        eng.warmup()
        eng.calibrate(kind, _graph(110, 999))
        _ENGINES[kind] = eng
    return _ENGINES[kind]


@pytest.mark.parametrize("kind", ["gcn", "gat", "sage", "auto"])
@FEW
@given(tier=st.sampled_from(("fp32", "int8")),
       n=st.integers(20, 240), seed=st.integers(0, 2 ** 16),
       n_add=st.integers(0, 6), n_rm=st.integers(0, 6))
def test_delta_equals_fresh_attach(kind, tier, n, seed, n_add, n_rm):
    """After a random delta, the patched entry (operands, int8 Â, GraSp
    decision) and the served logits equal a FRESH attach of the patched
    structure bit for bit; SAGE falls back. `assert_warm()` holds."""
    eng = _engine(kind)
    g = _clustered(600 + n, seed) if kind == "auto" else _graph(n, seed)
    n = g.num_nodes
    gid = eng.attach(g, model=kind)
    gid2 = None
    try:
        eng.query(gid, tier=tier)
        eng.run()
        # GraSp traffic keeps its flips inside one 128-node community
        add, rm = _pick(eng.graphs[gid][1].adj, 128 if kind == "auto" else n,
                        n_add, n_rm, np.random.default_rng(seed))
        ver = eng._graph_version[gid]
        applied = eng.update_delta(gid, add_edges=add, remove_edges=rm)
        if not len(add) and not len(rm):
            assert applied is True and eng._graph_version[gid] == ver
            return
        assert applied is (kind != "sage")
        key = (gid, eng._graph_version[gid])
        patched = (eng._operands.get(key), eng._tier_operands.get(key),
                   eng._grasp.get(key))
        eng.query(gid, tier=tier)
        r1 = eng.run()[-1]
        pg1 = eng.graphs[gid][1]
        gid2 = eng.attach(dataclasses.replace(
            g, edge_index=tg.edge_index_from_adjacency(pg1.adj, n)),
            model=kind)
        eng.query(gid2, tier=tier)
        r2 = eng.run()[-1]
        eng.assert_warm()
        assert np.array_equal(eng._graph_keys[gid], eng._graph_keys[gid2])
        k2 = (gid2, 0)
        o1, o2 = eng._operands[key], eng._operands[k2]
        if kind != "sage":
            assert o1 is patched[0]         # served from the patched entry
        for f in tmodels.OPERAND_FIELDS[eng.models[kind].cfg.kind]:
            assert torch.equal(getattr(o1, f), getattr(o2, f)), f
        if tier == "int8" and kind in ("gcn", "auto"):
            t1, t2 = eng._tier_operands[key], eng._tier_operands[k2]
            assert torch.equal(t1.agg_aq, t2.agg_aq)
            assert torch.equal(t1.agg_a_scale, t2.agg_a_scale)
        if tier == "fp32" and kind == "auto":
            (b1, s1), (b2, s2) = eng._grasp[key], eng._grasp[k2]
            assert b1 == b2 == r1.backend == r2.backend == "grasp"
            assert all(torch.equal(getattr(s1, f), getattr(s2, f))
                       for f in ("blocks", "block_cols", "counts"))
        assert r1.backend == r2.backend
        np.testing.assert_array_equal(r1.logits, r2.logits)
    finally:
        eng.detach(gid)
        if gid2 is not None:
            eng.detach(gid2)


# -------------------------------------------------------------- behaviour

def _gcn_engine(**sc):
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=(128,)), batch_slots=SLOTS,
        return_logits=True, **sc), device="cpu")
    eng.register_model("gcn", _cfg("gcn"), tiers=("fp32", "int8"),
                       fusion="layer")
    eng.warmup()
    return eng


def test_query_prepared_before_a_delta_answers_the_old_structure():
    eng = _gcn_engine()
    g = _graph(100, 4)
    gid = eng.attach(g, model="gcn")
    for tier in ("fp32", "int8"):
        eng.query(gid, tier=tier)
    before = [r.logits for r in eng.run()]
    for tier in ("fp32", "int8"):
        eng.query(gid, tier=tier)             # prepared, not yet run
    add, rm = _pick(eng.graphs[gid][1].adj, 100, 5, 5,
                    np.random.default_rng(2))
    assert eng.update_delta(gid, add_edges=add, remove_edges=rm)
    queued = [r.logits for r in eng.run()]
    for tier in ("fp32", "int8"):
        eng.query(gid, tier=tier)
    after = [r.logits for r in eng.run()[-2:]]
    for b, q, a in zip(before, queued, after):
        np.testing.assert_array_equal(q, b)
        assert not np.array_equal(a, b)
    eng.assert_warm()


def test_patched_entry_spills_and_faults_back_bit_equal():
    """A patched entry has no HostOperands of its own: evicted, it spills
    the compact form packed from the current edge keys, and its fault
    answers bit for bit; after a newer delta the spill producer declines."""
    entry = tcache.estimate_dense_entry_bytes(1, 128)
    eng = _gcn_engine(device_cache_budget_bytes=entry + entry // 2)
    g, other = _graph(100, 5), _graph(90, 6)
    gid = eng.attach(g, model="gcn")
    eng.query(gid)
    eng.run()
    add, rm = _pick(eng.graphs[gid][1].adj, 100, 3, 3,
                    np.random.default_rng(3))
    assert eng.update_delta(gid, add_edges=add, remove_edges=rm)
    eng.query(gid)
    patched = eng.run()[-1].logits
    key = (gid, 1)
    producer = eng._cache._entries[("operand", key)].spill_fn
    oid = eng.attach(other, model="gcn")
    eng.query(oid)                            # evicts the patched entry
    eng.run()
    assert key not in eng._operands and eng._cache.spilled == 1
    spilled = eng._cache._spill[("operand", key)]
    keys = eng._graph_keys[gid]
    assert np.array_equal(spilled.compact.packed.numpy(),
                          tg.symg_pack_keys(keys, 128))
    h2d = eng.metrics["operand_bytes_h2d"]
    eng.query(gid)
    assert np.array_equal(eng.run()[-1].logits, patched)
    s = eng.summary()
    assert s["cache_spill_hits"] == 1 and s["operand_cache_misses"] == 2
    assert s["operand_bytes_h2d"] - h2d == spilled.nbytes
    assert eng.update_delta(gid, remove_edges=add[:1])
    assert producer() is None                 # the version moved on
    eng.assert_warm()


@pytest.mark.parametrize("case", ["directed", "out of range", "both sides"])
def test_update_delta_raises_on_caller_errors(case):
    eng = _gcn_engine()
    g = _graph(60, 7)
    if case == "directed":
        src, dst = g.edge_index
        keep = ~((src < dst) & (np.arange(src.size) % 3 == 0))
        g = dataclasses.replace(g, edge_index=g.edge_index[:, keep])
    gid = eng.attach(g, model="gcn")
    add, rm = {"directed": ([[0, 1]], None),
               "out of range": ([[0, 60]], None),
               "both sides": ([[0, 1]], [[1, 0]])}[case]
    with pytest.raises(ValueError):
        eng.update_delta(gid, add_edges=add, remove_edges=rm)
    assert eng._graph_version[gid] == 0
    assert eng.metrics["delta_updates"] == eng.metrics["delta_fallbacks"] == 0


@pytest.mark.parametrize("pad_rows", [0, 2])
def test_update_delta_falls_back_to_update(pad_rows):
    """`delta_pad_rows=0` disables the patch; a delta past K_t falls back."""
    eng = _gcn_engine(delta_pad_rows=pad_rows)
    g = _graph(80, 8)
    gid = eng.attach(g, model="gcn")
    eng.query(gid)
    eng.run()
    add, rm = _pick(eng.graphs[gid][1].adj, 80, 2, 2,
                    np.random.default_rng(4))
    assert eng.update_delta(gid, add_edges=add, remove_edges=rm) is False
    s = eng.summary()
    assert (s["delta_updates"], s["delta_fallbacks"]) == (0, 1)
    assert eng._graph_version[gid] == 1 and not eng._operands
    pg = eng.graphs[gid][1]
    want = tg.apply_edge_delta(tg.pad_graph(g, capacity=128).adj,
                               tg.pad_graph(g, capacity=128).norm_adj, 80,
                               add, rm)
    assert np.array_equal(pg.norm_adj, want.norm_adj)
    eng.query(gid)
    eng.run()
    eng.assert_warm()


def test_delta_on_a_graph_with_no_resident_entry_only_moves_the_version():
    eng = _gcn_engine()
    g = _graph(70, 9)
    gid = eng.attach(g, model="gcn")          # never queried
    add, rm = _pick(eng.graphs[gid][1].adj, 70, 2, 2,
                    np.random.default_rng(5))
    assert eng.update_delta(gid, add_edges=add, remove_edges=rm)
    assert eng._graph_version[gid] == 1 and not eng._operands
    s = eng.summary()
    assert (s["delta_updates"], s["delta_bytes_h2d"]) == (1, 0)
    eng.query(gid)
    got = eng.run()[-1].logits
    fresh = eng.attach(dataclasses.replace(
        g, edge_index=tg.edge_index_from_adjacency(eng.graphs[gid][1].adj,
                                                   70)), model="gcn")
    eng.query(fresh)
    np.testing.assert_array_equal(eng.run()[-1].logits, got)
