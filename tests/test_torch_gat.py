"""PyTorch port, the GAT slice: `repro_torch`'s GAT masks, EffOp functions,
attention kernels' plain versions, `ops` entries, layers, forward, tier
calibration and GraphServe against the reference package on the same
numpy inputs and weights (`bridge.params_from_jax`). The reference's
kernels run in Pallas interpret mode (conftest's default) and through its
`ref` twins (`kernel_mode`). The kernels themselves are checked on a card
by `test_torch_cuda.py`.

Sizes: N 96-384, Fin <= 64, heads 1, 2 or 8 of widths 7 or 8.

Tolerance: fp32 rtol=atol=1e-5 (XLA's and ATen's CPU dots and reductions
sum in different orders). Masks are equal arrays; the calibration's int8
weights are equal and its scales within 1 ulp. Logits are compared over
each graph's real rows; padded rows only in the kernel checks. A QuantGr
GAT request is held layer by layer (`_check_int8_request`): its layer-2
int8 input rounds layer 1's fp32 output, and a value at a rounding tie
may land one step away when the two sides sum in different orders.
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
from repro.core import quant as rquant
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_layers import fused_gat_full as jax_fused_gat_full
from repro.kernels.fused_layers import \
    fused_gat_precombined as jax_fused_gat_pre
from repro.kernels.gat_attention import gat_attention as jax_gat_attention
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
from repro_torch.kernels import gat_attention as ga_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.runtime import gnn_server as tserve

TOL = dict(rtol=1e-5, atol=1e-5)
ACTIVATIONS = ("none", "relu", "elu")
IN_FEATS, HIDDEN, HEADS, CLASSES = 32, 64, 8, 7   # 8 heads of 8, then 1 of 7
BUCKETS, SLOTS = (128, 256), 2


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bias(rng, batch, n, n_real, p=0.05):
    """GrAx1 masks of `batch` graphs of n nodes, n_real of them real:
    self-loops on the real nodes only, so every padded row is all -1e9, and
    rows 64..95 have no edge in columns 0..63 (their first column tile is
    all -1e9)."""
    out = []
    for _ in range(batch):
        adj = (rng.random((n, n)) < p).astype(np.float32)
        adj[n_real:] = 0.0
        adj[:, n_real:] = 0.0
        adj[64:96, :64] = 0.0
        out.append(tmasks.attention_bias_additive(
            tmasks.adj_with_self_loops(adj, n_real)))
    return np.stack(out)


def _attention_inputs(seed, batch, n, heads, f, n_real=None):
    rng = np.random.default_rng(seed)
    bias = _bias(rng, batch, n, n_real or n - 20)
    return (_arr(rng, batch, n, heads, f), _arr(rng, batch, n, heads),
            _arr(rng, batch, n, heads), bias)


def _graph(n, seed, feats=IN_FEATS):
    return planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=feats,
                          num_classes=CLASSES, seed=seed, train_per_class=2)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _gat_weights(seed, fin=IN_FEATS, per_head=HIDDEN // HEADS, heads=HEADS):
    """numpy weights of one GAT layer from the reference's init, with a
    random bias (the init's is zero)."""
    p = rlayers.gat_init(jax.random.PRNGKey(seed), fin, per_head, heads)
    p = {k: np.asarray(v) for k, v in p.items()}
    p["b"] = _arr(np.random.default_rng(seed), heads * per_head, scale=0.1)
    return p


def _model_weights(seed):
    return {"l1": _gat_weights(seed),
            "l2": _gat_weights(seed + 1, HIDDEN, CLASSES, 1)}


def _calibration_numpy(cal):
    return {k: {"wq": np.asarray(v.wq), "w_scale": np.asarray(v.w_scale),
                "x_scale": np.asarray(v.x_scale)} for k, v in cal.items()}


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

@pytest.mark.parametrize("n,cap", [(50, 128), (128, 128), (200, 256)])
def test_masks_equal_reference(n, cap):
    pg = tg.pad_graph(_graph(n, n), capacity=cap)
    awl = tmasks.adj_with_self_loops(pg.adj, pg.num_nodes)
    want_awl = rmasks.adj_with_self_loops(pg.adj, pg.num_nodes)
    np.testing.assert_array_equal(awl, want_awl)
    for port, ref in ((tmasks.attention_bias_multiplicative,
                       rmasks.attention_bias_multiplicative),
                      (tmasks.attention_bias_additive,
                       rmasks.attention_bias_additive)):
        got, want = port(awl), ref(want_awl)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert tmasks.NEG_INF == rmasks.NEG_INF == teffop.NEG_INF
    # the padded nodes get no self-loop: their bias rows are all -1e9
    assert (tmasks.attention_bias_additive(awl)[n:] == tmasks.NEG_INF).all()


@pytest.mark.parametrize("batch", [0, 3])
def test_effop_functions_match_reference(batch):
    rng = np.random.default_rng(batch)
    lead = (batch,) if batch else ()
    n = 96
    src, dst = _arr(rng, *lead, n), _arr(rng, *lead, n)
    scores = _arr(rng, *lead, n, n)
    mask = (rng.random((*lead, n, n)) < 0.1).astype(np.float32)
    bias = np.where(mask > 0, 0.0, rmasks.NEG_INF).astype(np.float32)
    graphs = range(batch) if batch else [None]
    for i in graphs:
        pick = (lambda a: a[i]) if batch else (lambda a: a)
        for grax2 in (True, False):
            got = teffop.broadcast_add_scores(_t(src), _t(dst), grax2=grax2)
            np.testing.assert_array_equal(
                pick(got.numpy()), np.asarray(reffop.broadcast_add_scores(
                    jnp.asarray(pick(src)), jnp.asarray(pick(dst)),
                    grax2=grax2)))
        np.testing.assert_array_equal(
            pick(teffop.masked_select_add(_t(scores), _t(bias)).numpy()),
            np.asarray(reffop.masked_select_add(jnp.asarray(pick(scores)),
                                                jnp.asarray(pick(bias)))))
        np.testing.assert_array_equal(
            pick(teffop.masked_select_exact(_t(scores), _t(mask)).numpy()),
            np.asarray(reffop.masked_select_exact(jnp.asarray(pick(scores)),
                                                  jnp.asarray(pick(mask)))))
        np.testing.assert_allclose(
            pick(teffop.segment_softmax_dense(_t(scores), _t(bias)).numpy()),
            np.asarray(reffop.segment_softmax_dense(
                jnp.asarray(pick(scores)), jnp.asarray(pick(bias)))), **TOL)


# ----------------------------------------------- kernels' plain versions

@pytest.mark.parametrize("heads,f,n", [(8, 8, 256), (2, 7, 384),
                                       (1, 7, 128)])
def test_gat_attention_plain_matches_pallas(heads, f, n):
    h, ad, as_, bias = _attention_inputs(heads * f + n, 2, n, heads, f)
    got = ga_mod.gat_attention_plain(_t(h), _t(ad), _t(as_),
                                     _t(bias)).numpy()
    assert np.isfinite(got).all()
    for i in range(2):
        want = np.asarray(jax_gat_attention(
            jnp.asarray(h[i]), jnp.asarray(ad[i]), jnp.asarray(as_[i]),
            jnp.asarray(bias[i]), interpret=True))
        np.testing.assert_allclose(got[i], want, **TOL)
        np.testing.assert_allclose(
            tref.gat_attention_ref(_t(h[i]), _t(ad[i]), _t(as_[i]),
                                   _t(bias[i])).numpy(),
            np.asarray(jref.gat_attention_ref(
                jnp.asarray(h[i]), jnp.asarray(ad[i]), jnp.asarray(as_[i]),
                jnp.asarray(bias[i]))), **TOL)
    # a padded row (no self-loop) gets uniform weights: the mean of h
    np.testing.assert_allclose(got[0, -1], h[0].mean(axis=0), **TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("heads,f", [(8, 8), (1, 7)])
def test_fused_gat_full_plain_matches_pallas(activation, heads, f):
    rng = np.random.default_rng(heads + f)
    n, fin = 256, 48
    x, w = _arr(rng, 2, n, fin), _arr(rng, fin, heads, f, scale=0.2)
    a_src, a_dst = _arr(rng, heads, f), _arr(rng, heads, f)
    b = _arr(rng, heads, f, scale=0.1)
    bias = _bias(rng, 2, n, 230)
    got = fl_mod.fused_gat_full_plain(_t(x), _t(w), _t(a_src), _t(a_dst),
                                      _t(bias), _t(b), activation).numpy()
    for i in range(2):
        want = np.asarray(jax_fused_gat_full(
            jnp.asarray(x[i]), jnp.asarray(w), jnp.asarray(a_src),
            jnp.asarray(a_dst), jnp.asarray(bias[i]), jnp.asarray(b),
            activation=activation, interpret=True))
        np.testing.assert_allclose(got[i], want, **TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("heads,f", [(8, 8), (2, 7)])
def test_fused_gat_precombined_plain_matches_pallas(activation, heads, f):
    h, ad, as_, bias = _attention_inputs(7 * heads + f, 2, 256, heads, f)
    b = _arr(np.random.default_rng(f), heads, f, scale=0.1)
    got = fl_mod.fused_gat_precombined_plain(_t(h), _t(ad), _t(as_),
                                             _t(bias), _t(b),
                                             activation).numpy()
    for i in range(2):
        want = np.asarray(jax_fused_gat_pre(
            jnp.asarray(h[i]), jnp.asarray(ad[i]), jnp.asarray(as_[i]),
            jnp.asarray(bias[i]), jnp.asarray(b), activation=activation,
            interpret=True))
        np.testing.assert_allclose(got[i], want, **TOL)


def test_gat_wrappers_route_cpu_without_launching():
    h, ad, as_, bias = (_t(a) for a in _attention_inputs(1, 1, 128, 2, 7))
    b = torch.zeros(2, 7)
    before = (ga_mod.LAUNCHES, fl_mod.GAT_FULL_LAUNCHES,
              fl_mod.GAT_PRE_LAUNCHES)
    assert torch.equal(ga_mod.gat_attention(h, ad, as_, bias),
                       ga_mod.gat_attention_plain(h, ad, as_, bias))
    assert torch.equal(
        fl_mod.fused_gat_precombined(h, ad, as_, bias, b, "elu"),
        fl_mod.fused_gat_precombined_plain(h, ad, as_, bias, b, "elu"))
    x, w = torch.ones(1, 128, 16), torch.full((16, 2, 7), 0.01)
    assert torch.equal(
        fl_mod.fused_gat_full(x, w, b, b, bias, b, "relu"),
        fl_mod.fused_gat_full_plain(x, w, b, b, bias, b, "relu"))
    assert (ga_mod.LAUNCHES, fl_mod.GAT_FULL_LAUNCHES,
            fl_mod.GAT_PRE_LAUNCHES) == before
    with pytest.raises(ValueError, match="activation"):
        fl_mod.fused_gat_precombined(h, ad, as_, bias, b, "gelu")
    # one operand off the CPU: the wrapper takes the kernel's route and
    # refuses the CPU ones, it never runs the plain version
    with pytest.raises(ValueError, match="lies on cpu"):
        ga_mod.gat_attention(h, ad, as_, bias.to("meta"))


# ------------------------------------------------------------ ops entries

@pytest.mark.parametrize("batch", [0, 2])
def test_ops_gat_attention_matches_reference(kernel_mode, batch):
    h, ad, as_, bias = _attention_inputs(5, max(batch, 1), 100, 8, 8,
                                         n_real=90)
    graphs = range(batch) if batch else [0]
    pick = (lambda a: a) if batch else (lambda a: a[0])
    got = tops.gat_attention(_t(pick(h)), _t(pick(ad)), _t(pick(as_)),
                             _t(pick(bias))).numpy()
    assert got.shape == pick(h).shape
    for i in graphs:
        want = np.asarray(jops.gat_attention(
            jnp.asarray(h[i]), jnp.asarray(ad[i]), jnp.asarray(as_[i]),
            jnp.asarray(bias[i])))
        np.testing.assert_allclose(got[i] if batch else got, want, **TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("precombined", [False, True])
def test_ops_fused_gat_layer_matches_reference(kernel_mode, activation,
                                               precombined):
    # N = 200 is no multiple of 128: both sides pad it with -1e9 rows and
    # columns and strip the result
    rng = np.random.default_rng(11 + precombined)
    n, fin, heads, f = 200, 40, 2, 7
    x, w = _arr(rng, 2, n, fin), _arr(rng, fin, heads, f, scale=0.2)
    a_src, a_dst = _arr(rng, heads, f), _arr(rng, heads, f)
    b = _arr(rng, heads, f, scale=0.1)
    bias = _bias(rng, 2, n, 170)
    h, ad, as_ = (_arr(rng, 2, n, heads, f), _arr(rng, 2, n, heads),
                  _arr(rng, 2, n, heads))
    pre_t = (_t(h), _t(ad), _t(as_)) if precombined else None
    xt, wt = (None, None) if precombined else (_t(x), _t(w))
    got = tops.fused_gat_layer(xt, wt, _t(a_src), _t(a_dst), _t(bias), _t(b),
                               activation=activation,
                               precombined=pre_t).numpy()
    assert got.shape == (2, n, heads, f)
    for i in range(2):
        pre_j = ((jnp.asarray(h[i]), jnp.asarray(ad[i]), jnp.asarray(as_[i]))
                 if precombined else None)
        xj, wj = ((None, None) if precombined
                  else (jnp.asarray(x[i]), jnp.asarray(w)))
        args = (xj, wj, jnp.asarray(a_src), jnp.asarray(a_dst),
                jnp.asarray(bias[i]), jnp.asarray(b))
        want = np.asarray(jops.fused_gat_layer(*args, activation=activation,
                                               precombined=pre_j))
        # a row without edges averages over every column: over the padded
        # 256 where the reference pads too (its kernels), over the 200 in
        # its `ref` routing, so those rows compare in interpret mode only
        rows = n if kernel_mode == "interpret" else 170
        np.testing.assert_allclose(got[i, :rows], want[:rows], **TOL)
        twin = tref.fused_gat_layer_ref(
            *(None if a is None else _t(np.asarray(a)) for a in args),
            activation=activation,
            precombined=(None if pre_j is None
                         else tuple(_t(np.asarray(a)) for a in pre_j)))
        np.testing.assert_allclose(
            twin.numpy(), np.asarray(jref.fused_gat_layer_ref(
                *args, activation=activation, precombined=pre_j)), **TOL)
    # single-graph form
    one = tops.fused_gat_layer(
        None if xt is None else xt[0], wt, _t(a_src), _t(a_dst),
        _t(bias[0]), _t(b), activation=activation,
        precombined=None if pre_t is None else tuple(a[0] for a in pre_t))
    np.testing.assert_allclose(one.numpy(), got[0], **TOL)


# ----------------------------------------------------------------- layers

BRANCHES = {  # Techniques flags of each gat_grannite branch
    "exact": dict(effop=True),
    "grax1": dict(effop=True, grax1=True),
    "grax2": dict(effop=True, grax2=True),
    "grax12": dict(effop=True, grax1=True, grax2=True),
    "pallas": dict(effop=True, grax1=True, grax2=True, use_pallas=True),
    "quant": dict(effop=True, quantgr=True),
    "quant_pallas": dict(effop=True, quantgr=True, use_pallas=True),
}


def _layer_case(seed, batch=2, n=128):
    rng = np.random.default_rng(seed)
    p = _gat_weights(seed)
    x = _arr(rng, batch, n, IN_FEATS)
    bias = _bias(rng, batch, n, n - 20)
    mask = (bias == 0).astype(np.float32)
    ql = rquant.quantize_linear(jnp.asarray(p["w"]), jnp.asarray(x[0]))
    qt = bridge.calibration_from_jax(_calibration_numpy({"l1": ql}),
                                     device="cpu")["l1"]
    return p, x, mask, bias, ql, qt


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_gat_grannite_matches_reference(kernel_mode, branch):
    p, x, mask, bias, ql, qt = _layer_case(3)
    flags = BRANCHES[branch]
    quant = "quantgr" in flags
    tp = bridge.params_from_jax(p, device="cpu")
    for concat in (True, False):
        got = tlayers.gat_grannite(
            tp, _t(x), _t(mask), _t(bias), tlayers.Techniques(**flags),
            heads=HEADS, out_feats=HIDDEN // HEADS, concat=concat,
            quant=qt if quant else None).numpy()
        for i in range(2):
            want = np.asarray(rlayers.gat_grannite(
                _jax_tree(p), jnp.asarray(x[i]), jnp.asarray(mask[i]),
                jnp.asarray(bias[i]), rlayers.Techniques(**flags),
                heads=HEADS, out_feats=HIDDEN // HEADS, concat=concat,
                quant=ql if quant else None))
            np.testing.assert_allclose(got[i], want, **TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("quant", [False, True])
def test_gat_grannite_fused_matches_reference(kernel_mode, activation,
                                              quant):
    p, x, _, bias, ql, qt = _layer_case(4)
    flags = BRANCHES["quant_pallas" if quant else "grax12"]
    got = tlayers.gat_grannite_fused(
        bridge.params_from_jax(p, device="cpu"), _t(x), _t(bias),
        tlayers.Techniques(**flags), heads=HEADS, out_feats=HIDDEN // HEADS,
        activation=activation, quant=qt if quant else None).numpy()
    for i in range(2):
        want = np.asarray(rlayers.gat_grannite_fused(
            _jax_tree(p), jnp.asarray(x[i]), jnp.asarray(bias[i]),
            rlayers.Techniques(**flags), heads=HEADS,
            out_feats=HIDDEN // HEADS, activation=activation,
            quant=ql if quant else None))
        np.testing.assert_allclose(got[i], want, **TOL)


# ------------------------------------------------- models, plans, tiers

def _cfgs():
    return (rmodels.GNNConfig(kind="gat", in_feats=IN_FEATS, hidden=HIDDEN,
                              num_classes=CLASSES, heads=HEADS),
            tmodels.GNNConfig(kind="gat", in_feats=IN_FEATS, hidden=HIDDEN,
                              num_classes=CLASSES, heads=HEADS))


def test_calibrate_tier_gat_matches_reference():
    rcfg, tcfg = _cfgs()
    weights = _model_weights(5)
    pg = tg.pad_graph(_graph(150, 5), capacity=256)
    r_ops = rmodels.build_operands(rg.PaddedGraph(**dataclasses.asdict(pg)),
                                   rcfg, lean=True)
    t_ops = tmodels.build_operands(pg, tcfg, device="cpu")
    for f in ("mask_mult", "bias_add"):
        np.testing.assert_array_equal(getattr(t_ops, f).numpy(),
                                      np.asarray(getattr(r_ops, f)))
    assert t_ops.norm_adj is None
    want = rmodels.calibrate_tier(_jax_tree(weights), rcfg,
                                  jnp.asarray(pg.features), r_ops)
    got = tmodels.calibrate_tier(bridge.params_from_jax(weights,
                                                        device="cpu"),
                                 tcfg, _t(pg.features), t_ops)
    assert set(got) == set(want) == {"l1", "l2"}
    for k in ("l1", "l2"):
        np.testing.assert_array_equal(got[k].wq.numpy(),
                                      np.asarray(want[k].wq))
        for s in ("w_scale", "x_scale"):
            np.testing.assert_array_max_ulp(
                getattr(got[k], s).numpy(),
                np.asarray(getattr(want[k], s)), maxulp=1)


TIERS = {"fp32": dict(stagr=True, graphsplit=True, effop=True),
         "int8": dict(stagr=True, graphsplit=True, effop=True, quantgr=True),
         "int8+grax": dict(stagr=True, graphsplit=True, effop=True,
                           quantgr=True, grax1=True, grax2=True)}


@pytest.mark.parametrize("fusion", ["none", "layer"])
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_gat_plan_matches_reference(kernel_mode, fusion, tier, use_pallas):
    rcfg, tcfg = _cfgs()
    weights = _model_weights(6)
    pgs = [tg.pad_graph(_graph(n, 60 + n), capacity=128) for n in (70, 128)]
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


def test_gat_config_init_and_operand_guards():
    cfg = tconfigs.GNN_MODELS["gat"]()
    assert (cfg.kind, cfg.in_feats, cfg.hidden, cfg.num_classes,
            cfg.heads) == ("gat", 1433, 64, 7, 8)
    p = tmodels.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    shapes = {f"{k}.{kk}": tuple(v.shape) for k, layer in p.items()
              for kk, v in layer.items()}
    ref = rmodels.init_params(jax.random.PRNGKey(0), rmodels.GNNConfig(
        kind="gat", in_feats=1433, hidden=64, num_classes=7, heads=8))
    assert shapes == {f"{k}.{kk}": tuple(v.shape) for k, layer in ref.items()
                      for kk, v in layer.items()}
    # one model kind per batch: GAT and GCN operand sets do not stack
    pg = tg.pad_graph(_graph(40, 1), capacity=128)
    gat_ops = tmodels.build_operands(pg, cfg, device="cpu")
    gcn_ops = tmodels.build_operands(pg, tconfigs.gcn(), device="cpu")
    with pytest.raises(ValueError, match="one model kind"):
        tmodels.stack_operands([gat_ops, gcn_ops])
    stacked = tmodels.stack_operands([gat_ops] * 3)
    assert stacked.bias_add.shape == (3, 128, 128) and stacked.norm_adj is None
    # a plan on one device refuses GAT operands from another
    plan = tmodels.build_plan(cfg, 128, tlayers.Techniques.full_gat(),
                              batch_size=3, device="cpu")
    meta = dataclasses.replace(stacked, bias_add=stacked.bias_add.to("meta"))
    with pytest.raises(ValueError, match="bias_add"):
        plan(p, torch.zeros(3, 128, 1433), meta)
    # SAGE is ported: its params init; an unknown kind raises
    sage = tmodels.init_params(torch.Generator(), tmodels.GNNConfig(
        kind="sage", in_feats=8, aggregator="max"), device="cpu")
    assert set(sage["l1"]) == {"w_self", "w_neigh", "b", "w_pool", "b_pool"}
    with pytest.raises(ValueError, match="unknown model kind"):
        tmodels.init_params(torch.Generator(), tmodels.GNNConfig(
            kind="gin", in_feats=8), device="cpu")


# ---------------------------------------------------------------- serving

def _register(pkg, engine, weights):
    cfg_cls = rmodels.GNNConfig if pkg == "jax" else tmodels.GNNConfig
    tech_cls = rlayers.Techniques if pkg == "jax" else tlayers.Techniques
    cfg = cfg_cls(kind="gat", in_feats=IN_FEATS, hidden=HIDDEN,
                  num_classes=CLASSES, heads=HEADS)
    params = (_jax_tree(weights) if pkg == "jax"
              else bridge.params_from_jax(weights, device="cpu"))
    std = ("fp32", "int8", "int8+grax")
    engine.register_model("gat", cfg, params, tiers=std, default_tier="int8",
                          fusion="layer", agg_backend="grasp")
    engine.register_model("gat_none", cfg, params, tiers=std)
    engine.register_model("gat_mm", cfg, params, tiers={
        "fp32": tech_cls(**TIERS["fp32"], use_pallas=True),
        "int8": tech_cls(**TIERS["int8"], use_pallas=True)},
        default_tier="int8")


def _serve(pkg, engine):
    graph_cls = rg.Graph if pkg == "jax" else tg.Graph
    batches = []
    execute = engine._execute_batch

    def record(batch):
        batches.append([r.uid for r in batch])
        execute(batch)
    engine._execute_batch = record
    for i, n in enumerate((40, 130, 90, 250)):
        g = graph_cls(**dataclasses.asdict(_graph(n, 20 + i)))
        engine.submit(g, model="gat")
        engine.submit(g, model="gat", tier=("fp32", "int8+grax")[i % 2])
        engine.submit(g, model="gat_none", tier=("int8", "fp32")[i % 2])
        engine.submit(g, model="gat_mm", tier=("fp32", "int8")[i % 2])
    gid = engine.attach(graph_cls(**dataclasses.asdict(_graph(110, 98))),
                        model="gat")
    engine.query(gid)
    engine.query(gid, fusion="none", tier="int8+grax")
    return batches, engine.run()


def _layer1(pkg, e, pg, tier, fusion):
    """One request's layer-1 output (after ELU) on one side, (cap, hidden)."""
    lay, mods = (rlayers, rmodels) if pkg == "jax" else (tlayers, tmodels)
    if pkg == "jax":
        ops = mods.build_operands(rg.PaddedGraph(**dataclasses.asdict(pg)),
                                  e.cfg, lean=True)
        x = jnp.asarray(pg.features)
    else:
        ops = mods.build_operands(pg, e.cfg, device="cpu")
        x = _t(pg.features)
    kw = dict(heads=e.cfg.heads, out_feats=e.cfg.hidden // e.cfg.heads,
              quant=e.calibrations[tier]["l1"])
    t = e.tiers[tier]
    if fusion == "layer":
        return ops, lay.gat_grannite_fused(e.params["l1"], x, ops.bias_add, t,
                                           activation="elu", **kw)
    h = lay.gat_grannite(e.params["l1"], x, ops.mask_mult, ops.bias_add, t,
                         **kw)
    return ops, (jax.nn.elu(h) if pkg == "jax"
                 else torch.nn.functional.elu(h))


def _check_int8_request(port, ref_eng, got, ref):
    """A QuantGr GAT request, held layer by layer at TOL; returns the number
    of its layer-2 int8 inputs that round to another step than the
    reference's.

    Layer 2 quantizes layer 1's fp32 output (attention sums, whose order
    differs between XLA and ATen), so a value within an ulp of a rounding
    tie may land one int8 step away, and the logits then move by more than
    TOL. So: layer 1 equals the reference's at TOL; any step difference is
    exactly 1, at a value within 1e-4 steps of a tie; and layer 2 on the
    reference's layer-1 output equals the reference's logits at TOL, so
    nothing past the rounding differs. A request without such a tie is
    also held end to end at TOL.
    """
    n = got.pg.num_nodes
    e_t, e_r = port.models[got.model], ref_eng.models[ref.model]
    ops_t, h_t = _layer1("torch", e_t, got.pg, got.tier, got.fusion)
    _, h_r = _layer1("jax", e_r, got.pg, got.tier, got.fusion)
    h_r = np.asarray(h_r)
    np.testing.assert_allclose(h_t.numpy()[:n], h_r[:n], **TOL)
    cal = e_t.calibrations[got.tier]["l2"]
    steps_r = h_r / cal.x_scale.numpy()
    moved = (np.round(h_t.numpy() / cal.x_scale.numpy())
             != np.round(steps_r))
    assert (np.abs(np.abs(steps_r[moved] % 1.0) - 0.5) < 1e-4).all()
    kw = dict(heads=1, out_feats=CLASSES, quant=cal)
    t = e_t.tiers[got.tier]
    x2 = _t(h_r)
    if got.fusion == "layer":
        out = tlayers.gat_grannite_fused(e_t.params["l2"], x2,
                                         ops_t.bias_add, t, **kw)
    else:
        out = tlayers.gat_grannite(e_t.params["l2"], x2, ops_t.mask_mult,
                                   ops_t.bias_add, t, **kw)
    np.testing.assert_allclose(out.numpy()[:n], ref.logits, **TOL)
    if not moved.any():
        np.testing.assert_allclose(got.logits, ref.logits, **TOL)
    return int(moved.sum())


def test_gat_serving_matches_reference(kernel_mode):
    weights = _model_weights(7)
    ref_eng = rserve.GraphServe(rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True, use_cacheg=False))
    port = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True), device="cpu")
    _register("jax", ref_eng, weights)
    _register("torch", port, weights)
    cal_graph = _graph(200, 77)
    for name in ("gat", "gat_none", "gat_mm"):
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
    seen, flips = set(), 0
    for got, ref in zip(got_done, ref_done):
        assert (got.model, got.bucket, got.tier, got.fusion, got.backend) == (
            ref.model, ref.bucket, ref.tier, ref.fusion, ref.backend)
        seen.add((got.tier, got.fusion, got.model == "gat_mm"))
        np.testing.assert_array_equal(got.preds, ref.preds)
        if port.models[got.model].tiers[got.tier].quantgr:
            flips += _check_int8_request(port, ref_eng, got, ref)
        else:
            np.testing.assert_allclose(got.logits, ref.logits, **TOL)
    # the data holds one such tie (graph of 130 nodes, layer-2 input 48,21:
    # 16.499996 steps in the reference, 16.500002 in the port)
    assert flips <= 3
    assert {t for t, _, _ in seen} == {"fp32", "int8", "int8+grax"}
    assert {f for _, f, _ in seen} == {"none", "layer"}
    assert {(t, f) for t, f, mm in seen if mm} == {("fp32", "none"),
                                                   ("int8", "none")}
    s = port.summary()
    assert s["tier_fallbacks"] == ref_eng.summary()["tier_fallbacks"] == 0
    assert s["grasp_batches"] == s["backend_fallbacks"] == 0


def test_gat_calibration_and_warmth_on_the_port():
    eng = tserve.GraphServe(tserve.GraphServeConfig(
        ladder=tg.BucketLadder(buckets=BUCKETS), batch_slots=SLOTS,
        return_logits=True, use_cacheg=False), device="cpu")
    _register("torch", eng, _model_weights(8))
    cfg = eng.models["gat"].cfg
    eng.register_model("gat_default", cfg)
    assert (eng.models["gat_default"].tiers["fp32"]
            == tlayers.Techniques.full_gat()
            == tserve.DEFAULT_TECHNIQUES["gat"])
    assert not eng._needs_tier_ops(eng.models["gat"], "int8")
    assert not eng._grasp_capable(eng.models["gat"])    # "grasp": a no-op
    blobs = eng.warmup()                # QuantGr tiers warm on placeholders
    assert eng.models["gat"].calibrations == {}
    gid = eng.attach(_graph(100, 3), model="gat")   # calibrates once
    cal = eng.models["gat"].calibrations["int8"]
    assert set(cal) == {"l1", "l2"} and cal["l1"].wq.dtype == torch.int8
    assert set(eng.models["gat"].accuracy_delta) == {"int8", "int8+grax"}
    for i, n in enumerate((30, 140, 250)):
        g = _graph(n, 10 + i)
        eng.submit(g, model="gat", tier=("fp32", "int8", "int8+grax")[i])
        eng.submit(g, model="gat_default", fusion="layer")
        eng.query(gid, tier="int8" if i % 2 else "fp32",
                  fusion="none" if i else None)
    done = eng.run()
    assert len(done) == 9 and all(np.isfinite(r.logits).all() for r in done)
    eng.assert_warm()
    assert eng.compiled_blobs == blobs
    s = eng.summary()
    assert s["tier_fallbacks"] == 0 and not eng._tier_operands
    # each upload is the GAT masks, two (cap, cap) float32 arrays: three
    # one-shot requests of each model and the attached graph's first query
    assert s["operand_bytes_h2d"] == 2 * 4 * (
        2 * (128 ** 2 + 256 ** 2 + 256 ** 2) + 128 ** 2)
    eng.detach(gid)
    assert not eng._operands
