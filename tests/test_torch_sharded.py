"""PyTorch port, the multi-device GraphSplit slice: the sharded forward
and sharded serving. `build_sharded_operands`, `halo_exchange`,
`forward_grannite_sharded` through `build_sharded_plan` (with replica
rows) and GraphServe with `shard_counts` (auto-shard attach, mixed
traffic, `update()` across the sharding boundary, the sharded
`update_delta`, replica groups, the scheduler's sharded width), each
against the reference package on the same numpy inputs and weights, and
the port's own contract: a sharded delta equals a sharded rebuild under
the kept partition, bit for bit.

Tolerance: the partitions, the operand row blocks, batches and counters
are equal exactly, and so is the exchange fed the same rows (it is an
assembly). fp32 logits with compression off match at rtol=atol=1e-5
(XLA's and ATen's CPU dots sum in different orders); with the int8 wire
on, a projected row that the two sum in different orders can round to
the neighbouring int8 step at a tie, so the forward is held at the
reference's own 0.05 (`tests/test_sharded_serving.py`) with argmax equal
on at least 99% of rows. The int8 tiers quantize fp32 sums too (the
QuantGr combines' inputs: SAGE's aggregation, GAT's attention output,
every layer-1 output), so a tie moves a value one int8 step there as
well, and they are held the same way, compression on or off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as rg
from repro.core import models as rmodels
from repro.core import partition as rp
from repro.core import quant as rquant
from repro.runtime import gnn_server as rserve
from repro_torch import bridge
from repro_torch.core import graph as tg
from repro_torch.core import models as tmodels
from repro_torch.core import partition as tp
from repro_torch.core import quant as tquant
from repro_torch.data import graphs as tdata
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sage_max as sm
from repro_torch.runtime import cache as tcache
from repro_torch.runtime import gnn_server as tserve

TOL = dict(rtol=1e-5, atol=1e-5)
WIRE_ATOL = 0.05
IN_FEATS, HIDDEN, HEADS, CLASSES = 12, 16, 2, 4
BUCKET = 128
COUNTERS = ("batches", "sharded_batches", "halo_bytes_exchanged",
            "collective_bytes_compressed", "collective_bytes_exact",
            "operand_cache_hits", "operand_cache_misses", "rebucket_events",
            "delta_updates", "delta_fallbacks", "delta_halo_bytes_exchanged",
            "delta_halo_bytes_full", "delta_dirty_rows", "shard_counts",
            "batch_occupancy", "cache_resident_bytes")
KINDS = {"gcn": ("gcn", {}), "gat": ("gat", {}),
         "sage_max": ("sage", {"aggregator": "max"}),
         "sage_mean": ("sage", {"aggregator": "mean"})}


def _graph(n, seed):
    return tdata.clustered_like(num_nodes=n, num_feats=IN_FEATS,
                                num_classes=CLASSES, within_density=0.05,
                                cross_frac=0.1, seed=seed)


def _as_ref(g):
    return rg.Graph(**dataclasses.asdict(g))


def _cfgs(case):
    kind, kw = KINDS[case]
    base = dict(in_feats=IN_FEATS, hidden=HIDDEN, num_classes=CLASSES,
                heads=HEADS, **kw)
    return rmodels.GNNConfig(kind=kind, **base), tmodels.GNNConfig(
        kind=kind, **base)


def _weights(rcfg, seed):
    p = rmodels.init_params(jax.random.PRNGKey(seed), rcfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _tiers(kind):
    return rserve.tier_techniques(kind)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_wire_close(got, want, *, strict):
    """`strict`: rtol=atol=1e-5 everywhere. Otherwise the rule of the
    module docstring for a value that may sit at an int8 tie: within
    0.05, argmax equal on at least 99% of rows."""
    got, want = np.asarray(got), np.asarray(want)
    if strict:
        np.testing.assert_allclose(got, want, **TOL)
        return
    np.testing.assert_allclose(got, want, atol=WIRE_ATOL, rtol=0)
    assert (got.reshape(-1, got.shape[-1]).argmax(-1)
            == want.reshape(-1, want.shape[-1]).argmax(-1)).mean() >= 0.99


# ------------------------------------------------------------- operands

@pytest.mark.parametrize("case,n,shards", [(c, 200, 2) for c in sorted(KINDS)]
                         + [("gcn", 400, 4), ("gat", 400, 4)])
def test_sharded_operands_equal_reference(case, n, shards):
    """The row blocks, features and node masks of every shard equal the
    reference's bit for bit: the port's materialized Â equals the
    reference's host Â, and the permutation is a gather."""
    rcfg, tcfg = _cfgs(case)
    g = _graph(n, n)
    part = tp.partition_graph(g.edge_index, n, shards, shard_cap=BUCKET)
    got = tmodels.build_sharded_operands(g, part, tcfg, device="cpu")
    want = rmodels.build_sharded_operands(
        _as_ref(g), rp.GraphShards(**dataclasses.asdict(part)), rcfg)
    assert len(got) == len(want) == shards
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.x.numpy(), np.asarray(b.x))
        np.testing.assert_array_equal(a.node_mask.numpy(),
                                      np.asarray(b.node_mask))
        for f in tmodels.DENSE_FIELDS:
            if f in tmodels.OPERAND_FIELDS[tcfg.kind]:
                np.testing.assert_array_equal(getattr(a.ops, f).numpy(),
                                              np.asarray(getattr(b.ops, f)))
            else:
                assert getattr(a.ops, f) is None
    x, ops, mask = tmodels.stack_shard_slices(got)
    rx, rops, rmask = rmodels.stack_shard_slices(want)
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    # the slices of one build stack without a copy
    assert x.untyped_storage().data_ptr() == \
        got[0].x.untyped_storage().data_ptr()


def test_stack_shard_slices_copies_unrelated_slices():
    g = _graph(200, 3)
    part = tp.partition_graph(g.edge_index, 200, 2, shard_cap=BUCKET)
    _, cfg = _cfgs("gcn")
    sl = tmodels.build_sharded_operands(g, part, cfg, device="cpu")
    swapped = (sl[1], sl[0])
    x, ops, mask = tmodels.stack_shard_slices(swapped)
    np.testing.assert_array_equal(x[0].numpy(), sl[1].x.numpy())
    np.testing.assert_array_equal(ops.norm_adj[1].numpy(),
                                  sl[0].ops.norm_adj.numpy())


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("shards", [2, 3])
def test_halo_exchange_equals_reference(compress, shards):
    """The assembly equals the reference's summed zero-padded buffers bit
    for bit (a -0.0 row and an all-padding row included)."""
    rng = np.random.default_rng(shards)
    c, w = 32, 7
    h = rng.standard_normal((shards, c, w)).astype(np.float32) * 3
    h[0, 1] = -0.0
    mask = (rng.random((shards, c)) < 0.8).astype(np.float32)
    mask[-1, :] = 0.0
    want = jax.jit(jax.vmap(lambda a, m: rmodels.halo_exchange(
        a, m, shard_cap=c, full_rows=shards * c, axis_name="shard",
        compress=compress), axis_name="shard"))(h, mask)
    got = tmodels.halo_exchange(_t(h)[None], _t(mask)[None],
                                compress=compress)[0]
    for s in range(shards):
        assert np.array_equal(got.numpy().view(np.uint32),
                              np.asarray(want[s]).view(np.uint32))
    if not compress:
        np.testing.assert_array_equal(
            got.numpy(), (h * mask[..., None]).reshape(shards * c, w))


def test_rectangular_sage_max_plain_equals_reference_masked_max():
    """`sage_max`'s plain version over a shard's (M, N) row block equals
    the reference's GrAx3 masked max."""
    from repro.core import effop as reffop
    rng = np.random.default_rng(0)
    mask = (rng.random((3, 40, 96)) < 0.1).astype(np.float32)
    h = np.abs(rng.standard_normal((3, 96, 20))).astype(np.float32)
    want = np.stack([np.asarray(reffop.masked_max_aggregate(
        jnp.asarray(h[b]), jnp.asarray(mask[b]), grax3=True))
        for b in range(3)])
    np.testing.assert_array_equal(sm.sage_max_plain(_t(mask), _t(h)).numpy(),
                                  want)
    np.testing.assert_array_equal(kops.sage_max(_t(mask[0]), _t(h[0])).numpy(),
                                  want[0])
    with pytest.raises(ValueError, match="shapes do not agree"):
        sm.check_walk("sage_max", _t(mask), _t(h[:, :40]))
    assert sm.check_walk("sage_max", _t(mask), _t(h)) == (3, 40, 96, 20)


# ------------------------------------------------------------ the plans

def _plan_inputs(case, tier, n=200, seed=4):
    rcfg, tcfg = _cfgs(case)
    g = _graph(n, seed)
    part = tp.partition_graph(g.edge_index, n, 2, shard_cap=BUCKET)
    rpart = rp.GraphShards(**dataclasses.asdict(part))
    w = _weights(rcfg, 0)
    t = _tiers(rcfg.kind)[tier]
    rcal = tcal = None
    if t.quantgr:          # the port's calibration, shared by both sides
        pg = tg.pad_graph(g, capacity=part.full_rows)
        tcal = tmodels.calibrate_tier(
            bridge.params_from_jax(w, device="cpu"), tcfg, _t(pg.features),
            tmodels.build_operands(pg, tcfg, device="cpu"))
        rcal = _ref_calibration(tcal)
    return dict(rcfg=rcfg, tcfg=tcfg, g=g, part=part, rpart=rpart, w=w, t=t,
                rcal=rcal, tcal=tcal)


def _ref_plan_logits(d, graphs, compress):
    """The reference's sharded plan over one graph (replicas=1) or a list
    (one replica row each)."""
    stacks = []
    for g, part in graphs:
        sl = rmodels.build_sharded_operands(
            _as_ref(g), rp.GraphShards(**dataclasses.asdict(part)), d["rcfg"])
        stacks.append(rmodels.stack_shard_slices(sl))
    plan = rmodels.build_sharded_plan(d["rcfg"], BUCKET, 2, d["t"],
                                      compress=compress,
                                      replicas=len(graphs))
    params = jax.tree_util.tree_map(jnp.asarray, d["w"])
    if len(graphs) == 1:
        x, ops, mask = stacks[0]
    else:
        x = jnp.stack([s[0] for s in stacks])
        ops = rmodels.stack_operands([s[1] for s in stacks])
        mask = jnp.stack([s[2] for s in stacks])
    return np.asarray(plan(params, x, ops, d["rcal"], node_mask=mask))


def _port_plan_logits(d, graphs, compress, t=None):
    stacks = [tmodels.stack_shard_slices(tmodels.build_sharded_operands(
        g, part, d["tcfg"], device="cpu")) for g, part in graphs]
    plan = tmodels.build_sharded_plan(d["tcfg"], BUCKET, 2, t or d["t"],
                                      compress=compress,
                                      replicas=len(graphs), device="cpu")
    params = bridge.params_from_jax(d["w"], device="cpu")
    if len(graphs) == 1:
        x, ops, mask = stacks[0]
    else:
        x = torch.stack([s[0] for s in stacks])
        ops = tmodels.stack_operands([s[1] for s in stacks])
        mask = torch.stack([s[2] for s in stacks])
    out = plan(params, x, ops, d["tcal"], node_mask=mask)
    assert plan.trace_count == 1 and plan.shards == 2
    assert plan.key[-1] == 2 and plan.key[2] == 0
    return out.numpy()


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("tier", ["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(KINDS))
def test_sharded_plan_matches_reference(case, tier, compress):
    d = _plan_inputs(case, tier)
    got = _port_plan_logits(d, [(d["g"], d["part"])], compress)
    want = _ref_plan_logits(d, [(d["g"], d["part"])], compress)
    assert got.shape == want.shape == (2, BUCKET, CLASSES)
    _assert_wire_close(got, want, strict=(tier == "fp32" and not compress))
    # back in node order, the real rows only
    assert tmodels.unshard_logits(_t(got), d["part"]).shape == (200,
                                                                CLASSES)


@pytest.mark.parametrize("case,tier", [("gcn", "fp32"), ("gcn", "int8"),
                                       ("gat", "fp32"), ("sage_max", "fp32")])
def test_sharded_replicas_match_reference(case, tier):
    """replicas=2: two graphs of one partition shape in one call; each
    replica row equals its single-replica call bit for bit and the
    reference's two-replica plan at the module's tolerance."""
    d = _plan_inputs(case, tier)
    g2 = _graph(190, 9)
    p2 = tp.partition_graph(g2.edge_index, 190, 2, shard_cap=BUCKET)
    graphs = [(d["g"], d["part"]), (g2, p2)]
    got = _port_plan_logits(d, graphs, False)
    for i, gp in enumerate(graphs):
        np.testing.assert_array_equal(got[i],
                                      _port_plan_logits(d, [gp], False))
    want = _ref_plan_logits(d, graphs, False)
    _assert_wire_close(got, want, strict=(tier == "fp32"))


def test_sharded_plan_matches_single_device_forward():
    """Compression off, the sharded fp32 GCN equals the port's own plain
    forward at full_rows (rows permuted) at 1e-5."""
    d = _plan_inputs("gcn", "fp32")
    got = tmodels.unshard_logits(
        _t(_port_plan_logits(d, [(d["g"], d["part"])], False)), d["part"])
    pg = tg.pad_graph(d["g"], capacity=d["part"].full_rows)
    ops = tmodels.build_operands(pg, d["tcfg"], device="cpu")
    want = tmodels.forward_grannite(bridge.params_from_jax(d["w"],
                                                           device="cpu"),
                                    d["tcfg"], _t(pg.features), ops, d["t"])
    np.testing.assert_allclose(got, want.numpy()[:200], **TOL)


@pytest.mark.parametrize("tier", ["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(KINDS))
def test_use_pallas_routes_every_product_through_the_kernel_entries(
        case, tier, monkeypatch):
    """With `use_pallas` the sharded products call the kernel entries
    (`kops.matmul`, `kops.int8_matmul`, GrAx3's `kops.sage_max` on the
    rectangular row block), which run their plain versions on the CPU:
    the logits equal the plain plan's at 1e-5."""
    d = _plan_inputs(case, tier)
    calls = {"matmul": 0, "int8_matmul": 0, "sage_max": 0}
    for name in calls:
        real = getattr(kops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(kops, name, counted)
    t = dataclasses.replace(d["t"], use_pallas=True,
                            grax3=d["t"].grax3 or case == "sage_max")
    got = _port_plan_logits(d, [(d["g"], d["part"])], False, t=t)
    plain = dict(d, t=dataclasses.replace(t, use_pallas=False))
    np.testing.assert_allclose(
        got, _port_plan_logits(plain, [(d["g"], d["part"])], False), **TOL)
    if tier == "int8":
        assert calls["int8_matmul"] > 0
    else:
        assert calls["matmul"] > 0 and calls["int8_matmul"] == 0
    assert (calls["sage_max"] > 0) == (case == "sage_max")


def test_exchange_widths_equal_reference():
    for case in KINDS:
        rcfg, tcfg = _cfgs(case)
        assert tmodels.sharded_exchange_widths(tcfg) == \
            rmodels.sharded_exchange_widths(rcfg)


# ------------------------------------------------------------- serving

def _ref_calibration(cal):
    """A port tier calibration as the reference's (jnp leaves)."""
    if isinstance(cal, tquant.QuantizedLinear):
        return rquant.QuantizedLinear(**{f: jnp.asarray(getattr(cal, f)
                                                        .numpy())
                                         for f in ("wq", "w_scale",
                                                   "x_scale")})
    if isinstance(cal, dict):
        return {k: _ref_calibration(v) for k, v in cal.items()}
    return jnp.asarray(cal.numpy())


def _pair(case="gcn", *, tiers=("fp32", "int8"), replicas=1, slots=2,
          compress=False, buckets=(BUCKET,), **sc):
    """A reference engine and a port engine with the same weights, the
    same calibration (the port's, made on a small graph) and shard counts
    (2, 4). The port is warm; the reference compiles what it serves, as
    it goes (its warmup compiles every plan, which takes seconds)."""
    rcfg, tcfg = _cfgs(case)
    w = _weights(rcfg, 7)
    kw = dict(batch_slots=slots, return_logits=True, shard_counts=(2, 4),
              halo_compress=compress, replica_groups=replicas, **sc)
    ref = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=buckets), **kw))
    port = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=buckets), **kw), device="cpu")
    ref.register_model("m", rcfg, jax.tree_util.tree_map(jnp.asarray, w),
                       tiers=tiers)
    port.register_model("m", tcfg, bridge.params_from_jax(w, device="cpu"),
                        tiers=tiers)
    port.calibrate("m", _graph(100, 77))
    for tier, c in port.models["m"].calibrations.items():
        ref.models["m"].calibrations[tier] = _ref_calibration(c)
    ref.models["m"].accuracy_delta.update(port.models["m"].accuracy_delta)
    port.warmup()
    return ref, port


def _same_summary(ts, rs):
    for k in COUNTERS:
        assert ts[k] == rs[k], (k, ts[k], rs[k])


def _check_done(tdone, rdone, *, strict):
    assert len(tdone) == len(rdone)
    for a, b in zip(tdone, rdone):
        assert (a.uid, a.model, a.bucket, a.tier, a.shards, a.backend,
                a.fusion) == (b.uid, b.model, b.bucket, b.tier, b.shards,
                              b.backend, b.fusion)
        _assert_wire_close(a.logits, b.logits, strict=strict)
        if strict:
            np.testing.assert_array_equal(a.preds, b.preds)


@pytest.mark.parametrize("case,compress", [("gcn", False), ("gcn", True),
                                           ("gat", False),
                                           ("sage_max", False)])
def test_auto_shard_attach_and_query_matches_reference(case, compress):
    """A graph over the top bucket shards on attach; fp32 and int8 queries
    over it serve as the reference's, warm, with equal counters."""
    ref, port = _pair(case, compress=compress)
    g = _graph(200, 10)
    out = {}
    for pkg, eng in (("jax", ref), ("torch", port)):
        gid = eng.attach(_as_ref(g) if pkg == "jax" else g, model="m")
        eng.query(gid)
        eng.query(gid, tier="int8")
        eng.query(gid)
        done = list(eng.run())
        if pkg == "torch":
            eng.assert_warm()
        out[pkg] = (done, eng.summary(), eng._sharded[gid][0])
    (rdone, rs, rpart), (tdone, ts, tpart) = out["jax"], out["torch"]
    np.testing.assert_array_equal(tpart.perm, rpart.perm)
    assert (tpart.shards, tpart.shard_cap) == (2, BUCKET)
    _same_summary(ts, rs)
    assert ts["sharded_batches"] == 3 and ts["shard_counts"] == {0: 2}
    fp32 = [(a, b) for a, b in zip(tdone, rdone) if a.tier == "fp32"]
    _check_done(*zip(*fp32), strict=not compress)
    int8 = [(a, b) for a, b in zip(tdone, rdone) if a.tier == "int8"]
    _check_done(*zip(*int8), strict=False)


def test_mixed_traffic_soak_zero_recompile_matches_reference():
    """Sharded (4 x 128 and 2 x 128) and unsharded graphs, both tiers,
    interleaved: every batch replays a warm plan, the batches and every
    counter equal the reference's, the halo bytes equal their formula,
    and the slices serve from the cache after the first query."""
    ref, port = _pair("gcn", compress=True)
    graphs = [_graph(260, 11), _graph(60, 12), _graph(200, 13)]
    out = {}
    for pkg, eng in (("jax", ref), ("torch", port)):
        gids = [eng.attach(_as_ref(g) if pkg == "jax" else g, model="m")
                for g in graphs]
        for i in range(9):
            eng.query(gids[i % 3], tier="int8" if i % 2 else "fp32")
        done = list(eng.run())
        if pkg == "torch":
            eng.assert_warm()
        out[pkg] = (done, eng.summary(), eng)
    (rdone, rs, _), (tdone, ts, teng) = out["jax"], out["torch"]
    _same_summary(ts, rs)
    _check_done(tdone, rdone, strict=False)
    cfg = teng.models["m"].cfg
    expect = 0
    for gid in (0, 2):
        part = teng._sharded[gid][0]
        elems = sum(part.full_rows * w
                    for w in tmodels.sharded_exchange_widths(cfg))
        expect += 3 * int(2 * (part.shards - 1) / part.shards * elems)
    assert ts["halo_bytes_exchanged"] == expect
    assert ts["collective_bytes_exact"] == 4 * expect
    assert ts["sharded_batches"] == 6
    assert ts["operand_cache_hits"] > 0
    assert ts["shard_counts"] == {0: 4, 2: 2}


def test_sharded_query_refuses_fused_dispatch():
    ref, port = _pair("gcn", tiers=("fp32",))
    for eng, g in ((ref, _as_ref(_graph(200, 13))), (port, _graph(200, 13))):
        gid = eng.attach(g, model="m")
        with pytest.raises(ValueError, match="fusion='none'"):
            eng.query(gid, fusion="layer")
        eng.detach(gid)
        assert eng.summary()["shard_counts"] == {}


def test_update_crosses_the_sharding_boundary_both_ways():
    """Shrink back into the ladder, grow past it at another shard count,
    a value update at the same (shards, bucket): rebucket results,
    logits and counters equal the reference's; nothing recompiles."""
    ref, port = _pair("gcn", tiers=("fp32",), slots=1)
    g0, g1, g2, g3 = (_graph(200, 14), _graph(90, 15), _graph(300, 16),
                      _graph(290, 17))
    out = {}
    for pkg, eng in (("jax", ref), ("torch", port)):
        conv = _as_ref if pkg == "jax" else (lambda x: x)
        gid = eng.attach(conv(g0), model="m")
        blobs = eng.compiled_blobs
        res = [eng.update(gid, g1.edge_index, 90, g1.features)]
        res.append(eng.summary()["shard_counts"])
        eng.query(gid)
        res.append(eng.update(gid, g2.edge_index, 300, g2.features))
        res.append((eng._sharded[gid][0].shards,
                    eng._sharded[gid][0].shard_cap))
        eng.query(gid)
        res.append(eng.update(gid, g3.edge_index, 290, g3.features))
        eng.query(gid)
        done = list(eng.run())
        if pkg == "torch":
            eng.assert_warm()
            assert eng.compiled_blobs == blobs
        out[pkg] = (res, done, eng.summary())
    (rres, rdone, rs), (tres, tdone, ts) = out["jax"], out["torch"]
    assert tres == rres == [True, {}, True, (4, BUCKET), False]
    _same_summary(ts, rs)
    assert ts["rebucket_events"] == 2
    _check_done(tdone, rdone, strict=True)


def test_oversized_graph_without_shard_counts_raises():
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=(BUCKET,))), device="cpu")
    eng.register_model("m", _cfgs("gcn")[1])
    with pytest.raises(ValueError):
        eng.attach(_graph(200, 18), model="m")
    with pytest.raises(ValueError, match="partition method"):
        tserve.GraphServe(tserve.GraphServeConfig(partition_method="x"),
                          device="cpu")


@pytest.mark.parametrize("method", ["multilevel", "greedy"])
def test_partition_method_reaches_attach(method):
    g = _graph(260, 21)
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=(BUCKET,)), shard_counts=(2, 4),
        partition_method=method), device="cpu")
    eng.register_model("m", _cfgs("gcn")[1])
    gid = eng.attach(g, model="m", calibrate=False)
    want = rp.partition_for_ladder(g.edge_index, 260,
                                   rg.BucketLadder(buckets=(BUCKET,)),
                                   (2, 4), method=method)
    np.testing.assert_array_equal(eng._sharded[gid][0].assignment,
                                  want.assignment)
    assert eng._sharded[gid][0].cut_edges == want.cut_edges


def _cross_pair(eng, gid, part):
    adj = eng.graphs[gid][1].adj
    s0 = np.flatnonzero(part.assignment == 0)
    s1 = np.flatnonzero(part.assignment == 1)
    return next((int(u), int(v)) for u in s0[:20] for v in s1[:20]
                if adj[u, v] == 0)


@pytest.mark.parametrize("case", ["gcn", "gat", "sage_max"])
def test_sharded_delta_matches_reference(case):
    """A cross-shard delta, an interior one, an ineffective one, and one
    past the warmed widths (it falls back to update(), which
    re-partitions): results, counters (the delta-halo bytes and the dirty
    rows included) and logits equal the reference engine's."""
    ref, port = _pair(case, tiers=("fp32",), slots=1, delta_pad_rows=8)
    g = _graph(200, 22)
    out = {}
    for pkg, eng in (("jax", ref), ("torch", port)):
        gid = eng.attach(_as_ref(g) if pkg == "jax" else g, model="m")
        eng.query(gid)
        eng.run()
        part = eng._sharded[gid][0]
        pair = _cross_pair(eng, gid, part)
        res = [eng.update_delta(gid, add_edges=[pair])]
        eng.query(gid)
        a = part.assignment
        adj = eng.graphs[gid][1].adj
        inter = [u for u in np.flatnonzero(a == 0)
                 if not (adj[u, :200] != 0)[a != 0].any()]
        u, v = int(inter[0]), int(inter[1])
        before = eng.summary()["delta_halo_bytes_exchanged"]
        res.append(eng.update_delta(
            gid, add_edges=[(u, v)] if adj[u, v] == 0 else None,
            remove_edges=[(u, v)] if adj[u, v] != 0 else None))
        res.append(eng.summary()["delta_halo_bytes_exchanged"] - before)
        res.append(eng.update_delta(gid, add_edges=[pair]))   # no change
        eng.query(gid)
        big = [(int(x), int(y)) for x, y in zip(range(0, 40, 2),
                                                 range(101, 141, 2))]
        res.append(eng.update_delta(gid, add_edges=big))      # past K_t
        eng.query(gid)
        done = list(eng.run())
        if pkg == "torch":
            eng.assert_warm()
        out[pkg] = (res, done, eng.summary())
    (rres, rdone, rs), (tres, tdone, ts) = out["jax"], out["torch"]
    patched = case != "sage_max"
    assert tres == rres == [patched, patched, 0, True, False]
    _same_summary(ts, rs)
    if patched:
        assert ts["delta_dirty_rows"] >= 2
        assert 0 < ts["delta_halo_bytes_exchanged"] < \
            ts["delta_halo_bytes_full"]
    _check_done(tdone, rdone, strict=True)


@pytest.mark.parametrize("tier", ["fp32", "int8"])
@pytest.mark.parametrize("case", ["gcn", "gat"])
def test_sharded_delta_equals_sharded_rebuild(case, tier):
    """The port's patched slices equal a sharded build of the patched
    structure under the KEPT partition bit for bit, and so do the logits
    served from them."""
    _, port = _pair(case, slots=1, delta_pad_rows=8)
    g = _graph(260, 23)
    gid = port.attach(g, model="m")
    port.query(gid, tier=tier)
    port.run()
    part = port._sharded[gid][0]
    rng = np.random.default_rng(5)
    adj = port.graphs[gid][1].adj
    iu, ju = np.triu_indices(260, 1)
    off = np.flatnonzero(adj[iu, ju] == 0)
    on = np.flatnonzero(adj[iu, ju] != 0)
    add = [(iu[k], ju[k]) for k in rng.choice(off, 3, replace=False)]
    rm = [(iu[k], ju[k]) for k in rng.choice(on, 1, replace=False)]
    assert port.update_delta(gid, add_edges=add, remove_edges=rm) is True
    ver = port._graph_version[gid]
    patched = port._shard_cache[(gid, ver)]
    part2, g2 = port._sharded[gid]
    np.testing.assert_array_equal(part2.perm, part.perm)
    rebuilt = tmodels.build_sharded_operands(g2, part2, port.models["m"].cfg,
                                             device="cpu")
    for a, b in zip(patched, rebuilt):
        for f in tmodels.OPERAND_FIELDS[port.models["m"].cfg.kind]:
            assert torch.equal(getattr(a.ops, f), getattr(b.ops, f)), f
        assert torch.equal(a.x, b.x) and torch.equal(a.node_mask,
                                                     b.node_mask)
    uid = port.query(gid, tier=tier)
    done = {r.uid: r for r in port.run()}
    x, ops, mask = tmodels.stack_shard_slices(rebuilt)
    plan = port.plan_for("m", part.shard_cap, tier, shards=part.shards)
    want = tmodels.unshard_logits(plan(
        port.models["m"].params, x, ops,
        port.models["m"].calibrations.get(tier), node_mask=mask), part)
    np.testing.assert_array_equal(done[uid].logits, want)
    port.assert_warm()


def test_replica_groups_widen_the_sharded_dispatch():
    """replica_groups=2: five queries in ceil(5/2) sharded batches, each
    answer bit-equal to the width-1 engine's; batches and occupancy equal
    the reference's, logits too at the module's tolerance."""
    out = {}
    g = _graph(200, 20)
    for replicas in (1, 2):
        ref, port = _pair("gcn", tiers=("fp32",), replicas=replicas)
        for pkg, eng in (("jax", ref), ("torch", port)):
            gid = eng.attach(_as_ref(g) if pkg == "jax" else g, model="m")
            uids = [eng.query(gid) for _ in range(5)]
            done = {r.uid: r for r in eng.run()}
            if pkg == "torch":
                eng.assert_warm()
            out[(pkg, replicas)] = ([done[u].logits for u in uids],
                                    eng.summary())
    for replicas in (1, 2):
        (tl, ts), (rl, rs) = out[("torch", replicas)], out[("jax", replicas)]
        _same_summary(ts, rs)
        for a, b in zip(tl, rl):
            np.testing.assert_allclose(a, b, **TOL)
    assert out[("torch", 1)][1]["sharded_batches"] == 5
    assert out[("torch", 2)][1]["sharded_batches"] == 3
    assert out[("torch", 2)][1]["batch_occupancy"] == 5 / 6
    for a, b in zip(out[("torch", 1)][0], out[("torch", 2)][0]):
        np.testing.assert_array_equal(a, b)


def test_scheduler_fills_replica_rows_for_a_sharded_key():
    """The deterministic pipeline takes a sharded key's width from
    `replica_groups` and an unsharded key's from `batch_slots`: the
    batches equal the reference pipeline's, logits at the module's
    tolerance."""
    from repro.runtime.scheduler import PipelineConfig as RPC
    from repro_torch.runtime.scheduler import PipelineConfig as TPC
    ref, port = _pair("gcn", tiers=("fp32",), replicas=2, slots=2)
    big, small = _graph(200, 24), _graph(80, 25)
    out = {}
    for pkg, eng, pc in (("jax", ref, RPC(deterministic=True)),
                         ("torch", port, TPC(deterministic=True))):
        conv = _as_ref if pkg == "jax" else (lambda x: x)
        gb = eng.attach(conv(big), model="m")
        gs = eng.attach(conv(small), model="m")
        with eng.scheduler(pc) as sched:
            for gid in (gb, gs, gb, gb, gs):
                sched.query(gid)
            sched.drain()
        if pkg == "torch":
            eng.assert_warm()
        out[pkg] = (list(eng.finished), eng.summary())
    (rdone, rs), (tdone, ts) = out["jax"], out["torch"]
    _same_summary(ts, rs)
    assert ts["sharded_batches"] == 2 and ts["batches"] == 3
    _check_done(tdone, rdone, strict=True)


def test_sharded_admission_and_cache_entry_bytes():
    """attach() sizes a sharded graph's projected slice tuple as the
    reference does, refuses it under a budget it can never fit, and the
    cached entry's bytes equal the reference's."""
    ref, port = _pair("gcn", tiers=("fp32",))
    g = _graph(200, 26)
    gid = port.attach(g, model="m")
    rgid = ref.attach(_as_ref(g), model="m")
    for eng, gg in ((port, gid), (ref, rgid)):
        eng.query(gg)
        eng.run()
    part = port._sharded[gid][0]
    proj = tcache.estimate_shard_entry_bytes(part.shards, part.shard_cap,
                                             part.full_rows, 1, IN_FEATS)
    entry = port._shard_entry_nbytes(port._shard_cache[(gid, 0)])
    assert proj == entry == ref._shard_entry_nbytes(
        ref._shard_cache[(rgid, 0)])
    small = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=(BUCKET,)), shard_counts=(2,),
        device_cache_budget_bytes=proj - 1), device="cpu")
    small.register_model("m", _cfgs("gcn")[1])
    with pytest.raises(tcache.CacheAdmissionError):
        small.attach(g, model="m", calibrate=False)
    assert small.summary()["cache_admission_rejects"] == 1


def test_summary_exposes_shard_observability():
    _, port = _pair("gcn", tiers=("fp32",))
    s = port.summary()
    for k in ("shard_counts", "sharded_batches", "halo_bytes_exchanged",
              "collective_bytes_compressed", "collective_bytes_exact",
              "delta_halo_bytes_exchanged", "delta_halo_bytes_full",
              "delta_dirty_rows"):
        assert k in s, k


def test_bank_keys_a_sharded_request_by_its_shard_bucket():
    """The latency bank's key and seed of a sharded dispatch: the
    per-shard bucket and shard count, priced at `replica_groups`."""
    _, port = _pair("gcn", tiers=("fp32",), replicas=2, slots=4)
    key = ("m", BUCKET, "fp32", "dense", "none", 2)
    assert key in port.bank.keys()
    assert port.bank.predict(key) == port._modelled_batch_s(
        "m", BUCKET, "fp32", "dense", 2)
    assert port._modelled_batch_s("m", BUCKET, "fp32", "dense", 2) == \
        port._modelled_batch_s("m", BUCKET, "fp32", "dense", 0) / 2
