"""PyTorch port, the GraphSAGE slice: `repro_torch`'s SAGE masks, EffOp
masked max, the `sage_max` and `fused_sage` kernels' plain versions, `ops`
entries, layers, tier calibration, plans and GraphServe against the
reference package on the same numpy inputs and weights
(`bridge.params_from_jax`, `bridge.calibration_from_jax`). The reference's
kernels run in Pallas interpret mode (conftest's default) and through its
`ref` twins (`kernel_mode`). The kernels themselves are checked on a card
by `test_torch_cuda.py`.

Sizes: N 96-384, Fin <= 48, hidden 16, 5 classes, buckets 128 and 256.

Tolerance: fp32 rtol=atol=1e-5 (XLA's and ATen's CPU dots sum in
different orders). Masks are equal arrays; a masked max is exact, so
`masked_max_aggregate` and `sage_max_plain` are held equal; the
calibration's int8 weights are equal and its scales within 1 ulp.
Logits are compared over each graph's real rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import effop as reffop
from repro.core import graph as rg
from repro.core import layers as rlayers
from repro.core import masks as rmasks
from repro.core import models as rmodels
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_layers import fused_sage as jax_fused_sage
from repro.kernels.sage_max import sage_max as jax_sage_max
from repro.runtime import gnn_server as rserve
from repro_torch import bridge
from repro_torch.configs import gnn as tconfigs
from repro_torch.core import effop as teffop
from repro_torch.core import graph as tg
from repro_torch.core import layers as tlayers
from repro_torch.core import masks as tmasks
from repro_torch.core import models as tmodels
from repro_torch.data.graphs import planetoid_like
from repro_torch.kernels import fused_layers as fl_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sage_max as sm_mod
from repro_torch.runtime import gnn_server as tserve

TOL = dict(rtol=1e-5, atol=1e-5)
AGGREGATORS = ("mean", "max")
IN_FEATS, HIDDEN, CLASSES = 32, 16, 5
BUCKETS, SLOTS = (128, 256), 2


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _graph(n, seed, feats=IN_FEATS):
    return planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=feats,
                          num_classes=CLASSES, seed=seed, train_per_class=2)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _sample(rng, batch, n, n_real, max_neighbors=10, dense_row=None):
    """Sampled 0/1 masks of `batch` random graphs of n nodes (n_real real,
    so NodePad's rows and columns stay empty), optionally with one row
    whose every column is set."""
    out = []
    for _ in range(batch):
        adj = (rng.random((n, n)) < 0.08).astype(np.float32)
        adj[n_real:] = 0.0
        adj[:, n_real:] = 0.0
        m = tmasks.sage_sample_adjacency(adj, n_real,
                                         max_neighbors=max_neighbors)
        if dense_row is not None:
            m[dense_row] = 1.0
        out.append(m)
    return np.stack(out)


def _sage_weights(seed, fin=IN_FEATS, fout=HIDDEN, aggregator="max"):
    """numpy weights of one SAGE layer from the reference's init, with
    random biases (the init's are zero)."""
    p = rlayers.sage_init(jax.random.PRNGKey(seed), fin, fout,
                          aggregator=aggregator)
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    p["b"] = _arr(rng, fout, scale=0.1)
    if aggregator == "max":
        p["b_pool"] = _arr(rng, fin, scale=0.1)
    return p


def _model_weights(seed, aggregator):
    return {"l1": _sage_weights(seed, IN_FEATS, HIDDEN, aggregator),
            "l2": _sage_weights(seed + 1, HIDDEN, CLASSES, aggregator)}


def _calibration_numpy(cal):
    """A reference calibration (nested dicts of QuantizedLinear) as numpy
    dicts, the form `bridge.calibration_from_jax` takes."""
    if isinstance(cal, dict):
        return {k: _calibration_numpy(v) for k, v in cal.items()}
    if hasattr(cal, "wq"):
        return {"wq": np.asarray(cal.wq), "w_scale": np.asarray(cal.w_scale),
                "x_scale": np.asarray(cal.x_scale)}
    return np.asarray(cal)


def _cfgs(aggregator, in_feats=IN_FEATS):
    kw = dict(kind="sage", in_feats=in_feats, hidden=HIDDEN,
              num_classes=CLASSES, aggregator=aggregator)
    return rmodels.GNNConfig(**kw), tmodels.GNNConfig(**kw)


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


# ------------------------------------------------------ masks and EffOp

@pytest.mark.parametrize("n,cap,k", [(50, 128, 10), (128, 128, 3),
                                     (200, 256, 10), (90, 128, 1),
                                     (60, 128, 0)])
def test_sage_masks_equal_reference(n, cap, k):
    pg = tg.pad_graph(_graph(n, n + k), capacity=cap)
    for seed in (None, 7):        # the default seed-0 draw and a caller's rng
        def rng():
            return None if seed is None else np.random.default_rng(seed)
        got = tmasks.sage_sample_adjacency(pg.adj, pg.num_nodes,
                                           max_neighbors=k, rng=rng())
        want = rmasks.sage_sample_adjacency(pg.adj, pg.num_nodes,
                                            max_neighbors=k, rng=rng())
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        deg = got.sum(axis=1)
        assert (deg[n:] == 0).all()                   # NodePad rows empty
        assert (deg[:n] <= k + 1).all() and (deg[:n] >= 1).all()
        # rows with fewer neighbours than the cap keep all of them
        nbrs = (pg.adj[:n] > 0).sum(axis=1)
        assert (deg[:n][nbrs < k] == nbrs[nbrs < k] + 1).all()
        for port, ref in ((tmasks.mean_from_mask, rmasks.mean_from_mask),
                          (tmasks.max_bias_from_mask,
                           rmasks.max_bias_from_mask)):
            a, b = port(got), ref(want)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("grax3", [True, False])
def test_masked_max_aggregate_matches_reference(batch, grax3, monkeypatch):
    rng = np.random.default_rng(batch + grax3)
    n, f = 96, 24
    lead = (batch,) if batch else ()
    mask = _sample(rng, max(batch, 1), n, 80)
    mask = mask if batch else mask[0]
    h = _arr(rng, *lead, n, f)
    if grax3:
        h = np.abs(h)                 # GrAx3 holds for h >= 0
    got = teffop.masked_max_aggregate(_t(h), _t(mask), grax3=grax3).numpy()
    # a tiny block budget streams one row at a time: the same max
    monkeypatch.setattr(teffop, "MAX_BLOCK_BYTES", 1)
    streamed = teffop.masked_max_aggregate(_t(h), _t(mask),
                                           grax3=grax3).numpy()
    np.testing.assert_array_equal(streamed, got)
    for i in (range(batch) if batch else [None]):
        pick = (lambda a: a[i]) if batch else (lambda a: a)
        want = np.asarray(reffop.masked_max_aggregate(
            jnp.asarray(pick(h)), jnp.asarray(pick(mask)), grax3=grax3))
        np.testing.assert_array_equal(pick(got), want)
        assert (pick(got)[80:] == 0).all()            # no neighbour -> 0


# ----------------------------------------------- kernels' plain versions

@pytest.mark.parametrize("n,f", [(128, 100), (256, 128), (256, 48),
                                 (384, 256)])
def test_sage_max_plain_matches_pallas(n, f, monkeypatch):
    rng = np.random.default_rng(n + f)
    mask = _sample(rng, 2, n, n - 30, dense_row=3)
    h = np.abs(_arr(rng, 2, n, f))
    got = sm_mod.sage_max_plain(_t(mask), _t(h)).numpy()
    with monkeypatch.context() as m:    # one row at a time: the same max
        m.setattr(sm_mod, "MAX_BLOCK_BYTES", 1)
        np.testing.assert_array_equal(
            sm_mod.sage_max_plain(_t(mask), _t(h)).numpy(), got)
    for i in range(2):
        want = np.asarray(jax_sage_max(jnp.asarray(mask[i]),
                                       jnp.asarray(h[i]), interpret=True))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(
            tref.sage_max_ref(_t(mask[i]), _t(h[i])).numpy(),
            np.asarray(jref.sage_max_ref(jnp.asarray(mask[i]),
                                         jnp.asarray(h[i]))))
    # the TPU kernel's accumulator starts at 0, the plain version's too:
    # equal for any sign of h, the dense row included
    hn = _arr(rng, 2, n, f)
    got = sm_mod.sage_max_plain(_t(mask), _t(hn)).numpy()
    want = np.asarray(jax_sage_max(jnp.asarray(mask[0]), jnp.asarray(hn[0]),
                                   interpret=True))
    np.testing.assert_array_equal(got[0], want)
    assert (got >= 0).all()


@pytest.mark.parametrize("activation", ["none", "relu", "elu"])
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_fused_sage_plain_matches_pallas(aggregator, activation):
    rng = np.random.default_rng(len(aggregator) + len(activation))
    n, fin, o = 256, 40, 16
    sample = _sample(rng, 2, n, 220)
    mask = (sample if aggregator == "max"
            else np.stack([tmasks.mean_from_mask(m) for m in sample]))
    x = _arr(rng, 2, n, fin)
    xk = np.abs(_arr(rng, 2, n, fin)) if aggregator == "max" else x
    ws, wn = _arr(rng, fin, o, scale=0.2), _arr(rng, fin, o, scale=0.2)
    b = _arr(rng, 1, o, scale=0.1)
    got = fl_mod.fused_sage_plain(_t(mask), _t(xk), _t(x), _t(ws), _t(wn),
                                  _t(b), aggregator, activation).numpy()
    for i in range(2):
        want = np.asarray(jax_fused_sage(
            jnp.asarray(mask[i]), jnp.asarray(xk[i]), jnp.asarray(x[i]),
            jnp.asarray(ws), jnp.asarray(wn), jnp.asarray(b),
            aggregator=aggregator, activation=activation, interpret=True))
        np.testing.assert_allclose(got[i], want, **TOL)
        np.testing.assert_allclose(
            tref.fused_sage_layer_ref(
                _t(mask[i]), _t(xk[i]), _t(x[i]), _t(ws), _t(wn), _t(b),
                aggregator=aggregator, activation=activation).numpy(),
            np.asarray(jref.fused_sage_layer_ref(
                jnp.asarray(mask[i]), jnp.asarray(xk[i]), jnp.asarray(x[i]),
                jnp.asarray(ws), jnp.asarray(wn), jnp.asarray(b),
                aggregator=aggregator, activation=activation)), **TOL)


def test_sage_wrappers_route_cpu_without_launching():
    rng = np.random.default_rng(1)
    mask = _t(_sample(rng, 1, 128, 100))
    h = _t(np.abs(_arr(rng, 1, 128, 24)))
    ws = wn = torch.full((24, 8), 0.05)
    b = torch.zeros(8)
    before = (sm_mod.LAUNCHES, fl_mod.SAGE_LAUNCHES)
    assert torch.equal(sm_mod.sage_max(mask, h),
                       sm_mod.sage_max_plain(mask, h))
    for aggregator in AGGREGATORS:
        assert torch.equal(
            fl_mod.fused_sage(mask, h, h, ws, wn, b, aggregator, "relu"),
            fl_mod.fused_sage_plain(mask, h, h, ws, wn, b, aggregator,
                                    "relu"))
    assert (sm_mod.LAUNCHES, fl_mod.SAGE_LAUNCHES) == before
    with pytest.raises(ValueError, match="activation"):
        fl_mod.fused_sage(mask, h, h, ws, wn, b, "mean", "gelu")
    with pytest.raises(ValueError, match="aggregator"):
        fl_mod.fused_sage(mask, h, h, ws, wn, b, "sum")
    # one operand off the CPU: the wrapper takes the kernel's route and
    # refuses the CPU ones, it never runs the plain version
    with pytest.raises(ValueError, match="lies on cpu"):
        sm_mod.sage_max(mask, h.to("meta"))
    with pytest.raises(ValueError, match="mask lies on meta"):
        fl_mod.fused_sage(mask.to("meta"), h, h, ws, wn, b)


# ------------------------------------------------------------ ops entries

@pytest.mark.parametrize("batch", [0, 2])
def test_ops_sage_max_matches_reference(kernel_mode, batch):
    rng = np.random.default_rng(5 + batch)
    n, f = 256, 100                 # F no multiple of 128: the reference pads
    mask = _sample(rng, max(batch, 1), n, 230)
    h = np.abs(_arr(rng, max(batch, 1), n, f))
    pick = (lambda a: a) if batch else (lambda a: a[0])
    got = tops.sage_max(_t(pick(mask)), _t(pick(h))).numpy()
    assert got.shape == pick(h).shape
    for i in range(max(batch, 1)):
        want = np.asarray(jops.sage_max(jnp.asarray(mask[i]),
                                        jnp.asarray(h[i])))
        np.testing.assert_array_equal(got[i] if batch else got, want)


@pytest.mark.parametrize("activation", ["none", "relu"])
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_ops_fused_sage_layer_matches_reference(kernel_mode, aggregator,
                                                activation):
    # N = 200, Fin = 40 and O = 7 are no multiples of 128: the reference
    # pads them with zeros and strips, the port takes them as they are
    rng = np.random.default_rng(9 + len(aggregator))
    n, fin, o = 200, 40, 7
    sample = _sample(rng, 2, n, 170)
    mean = np.stack([tmasks.mean_from_mask(m) for m in sample])
    x = _arr(rng, 2, n, fin)
    pooled = np.abs(_arr(rng, 2, n, fin))
    ws, wn = _arr(rng, fin, o, scale=0.2), _arr(rng, fin, o, scale=0.2)
    b = _arr(rng, o, scale=0.1)

    def kw(i=None, conv=_t):
        sel = (lambda a: a) if i is None else (lambda a: a[i])
        if aggregator == "mean":
            return dict(mean_mask=conv(sel(mean)))
        return dict(sample_mask=conv(sel(sample)), pooled=conv(sel(pooled)))
    got = tops.fused_sage_layer(_t(x), _t(ws), _t(wn), _t(b), **kw(),
                                activation=activation).numpy()
    assert got.shape == (2, n, o)
    for i in range(2):
        want = np.asarray(jops.fused_sage_layer(
            jnp.asarray(x[i]), jnp.asarray(ws), jnp.asarray(wn),
            jnp.asarray(b), **kw(i, jnp.asarray), activation=activation))
        np.testing.assert_allclose(got[i], want, **TOL)
    one = tops.fused_sage_layer(_t(x[0]), _t(ws), _t(wn), _t(b), **kw(0),
                                activation=activation)
    np.testing.assert_allclose(one.numpy(), got[0], **TOL)


# ----------------------------------------------------------------- layers

BRANCHES = {  # Techniques flags of each sage_grannite branch
    "exact": dict(effop=True),
    "grax3": dict(effop=True, grax3=True),
    "pallas": dict(effop=True, use_pallas=True),
    "pallas_grax3": dict(effop=True, grax3=True, use_pallas=True),
    "quant": dict(effop=True, quantgr=True),
    "quant_grax3_pallas": dict(effop=True, quantgr=True, grax3=True,
                               use_pallas=True),
}


def _layer_case(seed, aggregator, batch=2, n=128):
    """One SAGE layer's weights, a batch of features and masks, and the
    reference's layer-1 calibration of it (from `calibrate_tier` on the
    first graph) with its port form."""
    rng = np.random.default_rng(seed)
    weights = _model_weights(seed, aggregator)
    x = _arr(rng, batch, n, IN_FEATS)
    sample = _sample(rng, batch, n, n - 20)
    mean = np.stack([tmasks.mean_from_mask(m) for m in sample])
    rcfg, _ = _cfgs(aggregator)
    r_ops = rmodels.GranniteOperands(
        norm_adj=jnp.zeros((1, 1)), mask_mult=jnp.zeros((1, 1)),
        bias_add=jnp.zeros((1, 1)), sample_mask=jnp.asarray(sample[0]),
        mean_mask=jnp.asarray(mean[0]))
    cal = rmodels.calibrate_tier(_jax_tree(weights), rcfg,
                                 jnp.asarray(x[0]), r_ops)["l1"]
    t_cal = bridge.calibration_from_jax(_calibration_numpy(cal),
                                        device="cpu")
    return weights["l1"], x, sample, mean, cal, t_cal


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sage_grannite_matches_reference(kernel_mode, aggregator, branch):
    p, x, sample, mean, ql, qt = _layer_case(3, aggregator)
    flags = BRANCHES[branch]
    quant = "quantgr" in flags
    got = tlayers.sage_grannite(
        bridge.params_from_jax(p, device="cpu"), _t(x), _t(sample),
        _t(mean), tlayers.Techniques(**flags), aggregator=aggregator,
        quant=qt if quant else None).numpy()
    for i in range(2):
        want = np.asarray(rlayers.sage_grannite(
            _jax_tree(p), jnp.asarray(x[i]), jnp.asarray(sample[i]),
            jnp.asarray(mean[i]), rlayers.Techniques(**flags),
            aggregator=aggregator, quant=ql if quant else None))
        np.testing.assert_allclose(got[i], want, **TOL)


@pytest.mark.parametrize("activation", ["none", "relu"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sage_grannite_fused_matches_reference(kernel_mode, aggregator,
                                               quant, activation):
    p, x, sample, mean, ql, qt = _layer_case(4, aggregator)
    flags = BRANCHES["quant_grax3_pallas" if quant else "grax3"]
    got = tlayers.sage_grannite_fused(
        bridge.params_from_jax(p, device="cpu"), _t(x), _t(sample),
        _t(mean), tlayers.Techniques(**flags), aggregator=aggregator,
        activation=activation, quant=qt if quant else None).numpy()
    for i in range(2):
        want = np.asarray(rlayers.sage_grannite_fused(
            _jax_tree(p), jnp.asarray(x[i]), jnp.asarray(sample[i]),
            jnp.asarray(mean[i]), rlayers.Techniques(**flags),
            aggregator=aggregator, activation=activation,
            quant=ql if quant else None))
        np.testing.assert_allclose(got[i], want, **TOL)


# ------------------------------------------------- models, plans, tiers

@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_calibrate_tier_sage_matches_reference(aggregator):
    rcfg, tcfg = _cfgs(aggregator)
    weights = _model_weights(5, aggregator)
    pg = tg.pad_graph(_graph(150, 5), capacity=256)
    r_ops = rmodels.build_operands(rg.PaddedGraph(**dataclasses.asdict(pg)),
                                   rcfg, lean=True)
    t_ops = tmodels.build_operands(pg, tcfg, device="cpu")
    for f in ("sample_mask", "mean_mask"):
        np.testing.assert_array_equal(getattr(t_ops, f).numpy(),
                                      np.asarray(getattr(r_ops, f)))
    assert t_ops.norm_adj is None and t_ops.bias_add is None
    want = rmodels.calibrate_tier(_jax_tree(weights), rcfg,
                                  jnp.asarray(pg.features), r_ops)
    got = tmodels.calibrate_tier(bridge.params_from_jax(weights,
                                                        device="cpu"),
                                 tcfg, _t(pg.features), t_ops)
    names = {"self", "neigh"} | ({"pool"} if aggregator == "max" else set())
    assert set(got) == set(want) == {"l1", "l2"}
    for k in ("l1", "l2"):
        assert set(got[k]) == set(want[k]) == names
        for name in names:
            g, w = got[k][name], want[k][name]
            np.testing.assert_array_equal(g.wq.numpy(), np.asarray(w.wq))
            for s in ("w_scale", "x_scale"):
                np.testing.assert_array_max_ulp(
                    getattr(g, s).numpy(), np.asarray(getattr(w, s)),
                    maxulp=1)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_bridge_carries_sage_calibration_exactly(aggregator):
    rcfg, _ = _cfgs(aggregator)
    weights = _model_weights(6, aggregator)
    pg = tg.pad_graph(_graph(100, 6), capacity=128)
    r_ops = rmodels.build_operands(rg.PaddedGraph(**dataclasses.asdict(pg)),
                                   rcfg, lean=True)
    cal = rmodels.calibrate_tier(_jax_tree(weights), rcfg,
                                 jnp.asarray(pg.features), r_ops)
    got = bridge.calibration_from_jax(_calibration_numpy(cal), device="cpu")
    for k, layer in cal.items():
        assert set(got[k]) == set(layer)
        for name, ql in layer.items():
            for f in ("wq", "w_scale", "x_scale"):
                want = np.asarray(getattr(ql, f))
                have = getattr(got[k][name], f).numpy()
                assert have.dtype == want.dtype
                np.testing.assert_array_equal(have, want)
    # the weights too, pool combine included
    tp = bridge.params_from_jax(weights, device="cpu")
    assert set(tp["l1"]) == set(weights["l1"])
    for k, v in weights["l1"].items():
        np.testing.assert_array_equal(tp["l1"][k].numpy(), v)


TIERS = {"fp32": dict(stagr=True, graphsplit=True, effop=True),
         "int8": dict(stagr=True, graphsplit=True, effop=True, quantgr=True),
         "int8+grax": dict(stagr=True, graphsplit=True, effop=True,
                           quantgr=True, grax3=True)}


@pytest.mark.parametrize("fusion", ["none", "layer"])
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sage_plan_matches_reference(kernel_mode, aggregator, fusion, tier,
                                     use_pallas):
    rcfg, tcfg = _cfgs(aggregator)
    weights = _model_weights(7, aggregator)
    pgs = [tg.pad_graph(_graph(n, 70 + n), capacity=128) for n in (70, 128)]
    r_ops = [rmodels.build_operands(rg.PaddedGraph(**dataclasses.asdict(p)),
                                    rcfg, lean=True) for p in pgs]
    t_ops = [tmodels.build_operands(p, tcfg, device="cpu") for p in pgs]
    flags = dict(TIERS[tier], use_pallas=use_pallas)
    cal = t_cal = None
    if flags.get("quantgr"):
        cal = rmodels.calibrate_tier(_jax_tree(weights), rcfg,
                                     jnp.asarray(pgs[0].features), r_ops[0])
        t_cal = bridge.calibration_from_jax(_calibration_numpy(cal),
                                            device="cpu")
    x = np.stack([p.features for p in pgs])
    rplan = rmodels.build_plan(rcfg, 128, rlayers.Techniques(**flags),
                               batch_size=2, fusion=fusion)
    tplan = tmodels.build_plan(tcfg, 128, tlayers.Techniques(**flags),
                               batch_size=2, fusion=fusion, device="cpu")
    want = np.asarray(rplan(_jax_tree(weights), jnp.asarray(x),
                            rmodels.stack_operands(r_ops), cal, None))
    got = tplan(bridge.params_from_jax(weights, device="cpu"), _t(x),
                tmodels.stack_operands(t_ops), t_cal, None).numpy()
    assert got.shape == (2, 128, CLASSES)
    for i, p in enumerate(pgs):
        np.testing.assert_allclose(got[i, :p.num_nodes],
                                   want[i, :p.num_nodes], **TOL)
        assert (got[i, :p.num_nodes].argmax(-1).tolist()
                == want[i, :p.num_nodes].argmax(-1).tolist())
    assert tplan.key[1:3] == rplan.key[1:3] and tplan.key[4:] == rplan.key[4:]


def test_sage_configs_operands_and_guards():
    for name, agg in (("sage-mean", "mean"), ("sage-max", "max")):
        cfg = tconfigs.GNN_MODELS[name]()
        assert (cfg.kind, cfg.in_feats, cfg.hidden, cfg.num_classes,
                cfg.aggregator, cfg.max_neighbors) == ("sage", 1433, 64, 7,
                                                       agg, 10)
        p = tmodels.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        shapes = {f"{k}.{kk}": tuple(v.shape) for k, layer in p.items()
                  for kk, v in layer.items()}
        ref = rmodels.init_params(jax.random.PRNGKey(0), rmodels.GNNConfig(
            kind="sage", in_feats=1433, hidden=64, num_classes=7,
            aggregator=agg))
        assert shapes == {f"{k}.{kk}": tuple(v.shape)
                          for k, layer in ref.items()
                          for kk, v in layer.items()}
    cfg = tconfigs.sage("cora", "max")
    pg = tg.pad_graph(_graph(40, 1), capacity=128)
    ops = tmodels.build_operands(pg, cfg, device="cpu")
    assert ops.norm_adj is None and ops.mask_mult is None
    # the same sample on every build (seed 0 each call), as the reference
    np.testing.assert_array_equal(
        tmodels.build_operands(pg, cfg, device="cpu").sample_mask.numpy(),
        ops.sample_mask.numpy())
    # one model kind per batch: SAGE and GAT operand sets do not stack
    gat_ops = tmodels.build_operands(pg, tconfigs.gat(), device="cpu")
    with pytest.raises(ValueError, match="one model kind"):
        tmodels.stack_operands([ops, gat_ops])
    stacked = tmodels.stack_operands([ops] * 3)
    assert (stacked.sample_mask.shape == stacked.mean_mask.shape
            == (3, 128, 128)) and stacked.bias_add is None
    # a plan on one device refuses SAGE operands from another
    plan = tmodels.build_plan(cfg, 128, tlayers.Techniques.full_sage(),
                              batch_size=3, device="cpu")
    for f in ("sample_mask", "mean_mask"):
        meta = dataclasses.replace(stacked,
                                   **{f: getattr(stacked, f).to("meta")})
        with pytest.raises(ValueError, match=f):
            plan(tmodels.init_params(torch.Generator(), cfg, device="cpu"),
                 torch.zeros(3, 128, 1433), meta)
    with pytest.raises(ValueError, match="unknown model kind"):
        tmodels.build_plan(tmodels.GNNConfig(kind="gin", in_feats=8), 128,
                           tlayers.Techniques(), device="cpu")


def test_paper_sage_serves_on_cpu_at_full_width():
    """GraphServe(device="cpu") registers and serves the paper's SAGE,
    both aggregators, at 1433 -> 64 -> 7 with max_neighbors=10."""
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=(128,)), batch_slots=2,
        return_logits=True, use_cacheg=False), device="cpu")
    for name in ("sage-mean", "sage-max"):
        eng.register_model(name, tconfigs.GNN_MODELS[name](),
                           tiers=("fp32", "int8+grax"), fusion="layer")
        assert (eng.models[name].tiers["fp32"]
                == tserve.tier_techniques("sage")["fp32"])
    eng.register_model("sage-default", tconfigs.sage("cora", "max"))
    assert (eng.models["sage-default"].tiers["fp32"]
            == tlayers.Techniques.full_sage()
            == tserve.DEFAULT_TECHNIQUES["sage"])
    g = planetoid_like(num_nodes=100, num_edges=300, num_feats=1433,
                       num_classes=7, seed=2, train_per_class=2)
    for name in ("sage-mean", "sage-max"):
        eng.calibrate(name, g)
        eng.submit(g, model=name)
        eng.submit(g, model=name, tier="int8+grax", fusion="none")
    eng.submit(g, model="sage-default")
    done = eng.run()
    assert len(done) == 5
    assert all(r.logits.shape == (100, 7) and np.isfinite(r.logits).all()
               for r in done)
    s = eng.summary()
    assert s["tier_fallbacks"] == 0
    # each request uploads SAGE's two (cap, cap) float32 masks
    assert s["operand_bytes_h2d"] == 5 * 2 * 4 * 128 ** 2


# ---------------------------------------------------------------- serving

def _register(pkg, engine, weights, aggregator):
    cfg_cls = rmodels.GNNConfig if pkg == "jax" else tmodels.GNNConfig
    tech_cls = rlayers.Techniques if pkg == "jax" else tlayers.Techniques
    cfg = cfg_cls(kind="sage", in_feats=IN_FEATS, hidden=HIDDEN,
                  num_classes=CLASSES, aggregator=aggregator)
    params = (_jax_tree(weights) if pkg == "jax"
              else bridge.params_from_jax(weights, device="cpu"))
    std = ("fp32", "int8", "int8+grax")
    engine.register_model("sage", cfg, params, tiers=std, default_tier="int8",
                          fusion="layer")
    engine.register_model("sage_none", cfg, params, tiers=std)
    engine.register_model("sage_mm", cfg, params, tiers={
        "fp32": tech_cls(**TIERS["fp32"], grax3=True, use_pallas=True),
        "int8+grax": tech_cls(**TIERS["int8+grax"], use_pallas=True)},
        default_tier="int8+grax")


def _serve(pkg, engine):
    graph_cls = rg.Graph if pkg == "jax" else tg.Graph
    batches = []
    execute = engine._execute_batch

    def record(batch):
        batches.append([r.uid for r in batch])
        execute(batch)
    engine._execute_batch = record
    for i, n in enumerate((40, 130, 90, 250)):
        g = graph_cls(**dataclasses.asdict(_graph(n, 30 + i)))
        engine.submit(g, model="sage")
        engine.submit(g, model="sage", tier=("fp32", "int8+grax")[i % 2])
        engine.submit(g, model="sage_none", tier=("int8", "fp32")[i % 2])
        engine.submit(g, model="sage_mm", tier=("fp32", "int8+grax")[i % 2])
    gid = engine.attach(graph_cls(**dataclasses.asdict(_graph(110, 99))),
                        model="sage")
    engine.query(gid)
    engine.query(gid, fusion="none", tier="int8+grax")
    return batches, engine.run()


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sage_serving_matches_reference(kernel_mode, aggregator):
    weights = _model_weights(8, aggregator)
    ref_eng = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True, use_cacheg=False))
    port = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True), device="cpu")
    _register("jax", ref_eng, weights, aggregator)
    _register("torch", port, weights, aggregator)
    cal_graph = _graph(200, 78)
    for name in ("sage", "sage_none", "sage_mm"):
        ref_eng.calibrate(name, rg.Graph(**dataclasses.asdict(cal_graph)))
        for tier, cal in ref_eng.models[name].calibrations.items():
            port.models[name].calibrations[tier] = (
                bridge.calibration_from_jax(_calibration_numpy(cal),
                                            device="cpu"))
        port.models[name].accuracy_delta.update(
            ref_eng.models[name].accuracy_delta)
    ref_batches, ref_done = _serve("jax", ref_eng)
    got_batches, got_done = _serve("torch", port)
    assert got_batches == ref_batches
    assert [r.uid for r in got_done] == [r.uid for r in ref_done]
    seen = set()
    for got, ref in zip(got_done, ref_done):
        assert (got.model, got.bucket, got.tier, got.fusion, got.backend) == (
            ref.model, ref.bucket, ref.tier, ref.fusion, ref.backend)
        seen.add((got.tier, got.fusion, got.model == "sage_mm"))
        np.testing.assert_array_equal(got.preds, ref.preds)
        np.testing.assert_allclose(got.logits, ref.logits, **TOL)
    assert {t for t, _, _ in seen} == {"fp32", "int8", "int8+grax"}
    assert {f for _, f, _ in seen} == {"none", "layer"}
    assert {(t, f) for t, f, mm in seen if mm} == {("fp32", "none"),
                                                   ("int8+grax", "none")}
    s = port.summary()
    assert s["tier_fallbacks"] == ref_eng.summary()["tier_fallbacks"] == 0
    assert s["grasp_batches"] == s["backend_fallbacks"] == 0


def test_sage_calibration_and_warmth_on_the_port():
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True, use_cacheg=False), device="cpu")
    _register("torch", eng, _model_weights(9, "max"), "max")
    assert not eng._needs_tier_ops(eng.models["sage"], "int8")
    assert not eng._grasp_capable(eng.models["sage"])
    blobs = eng.warmup()                # QuantGr tiers warm on placeholders
    assert eng.models["sage"].calibrations == {}
    gid = eng.attach(_graph(100, 3), model="sage")   # calibrates once
    cal = eng.models["sage"].calibrations["int8"]
    assert set(cal) == {"l1", "l2"}
    assert set(cal["l1"]) == {"self", "neigh", "pool"}
    assert cal["l1"]["pool"].wq.dtype == torch.int8
    assert set(eng.models["sage"].accuracy_delta) == {"int8", "int8+grax"}
    for i, n in enumerate((30, 140, 250)):
        g = _graph(n, 10 + i)
        eng.submit(g, model="sage", tier=("fp32", "int8", "int8+grax")[i])
        eng.submit(g, model="sage_none", fusion="layer")
        eng.query(gid, tier="int8" if i % 2 else "fp32",
                  fusion="none" if i else None)
    done = eng.run()
    assert len(done) == 9 and all(np.isfinite(r.logits).all() for r in done)
    eng.assert_warm()
    assert eng.compiled_blobs == blobs
    s = eng.summary()
    assert s["tier_fallbacks"] == 0 and not eng._tier_operands
    # each upload is SAGE's two (cap, cap) float32 masks: three one-shot
    # requests of each model and the attached graph's first query
    assert s["operand_bytes_h2d"] == 2 * 4 * (
        2 * (128 ** 2 + 256 ** 2 + 256 ** 2) + 128 ** 2)
    eng.detach(gid)
    assert not eng._operands
