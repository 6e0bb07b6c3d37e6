"""PyTorch port, the baselines and training slice: `citeseer_like`,
`effop.one_hot_gather`, the edge-list baselines and `forward_baseline`,
`calibrate_quant`, `optim.adamw`, `masked_cross_entropy`, `accuracy`,
`train_node_classifier`, `evaluate` and `bridge.params_to_numpy` against
the reference package on the same numpy inputs and weights
(`bridge.params_from_jax`), and the two examples on the CPU. The kernels
that evaluate trained weights are checked on a card by
`test_torch_cuda.py` and `chip_smoke.py`'s `[train]`.

Sizes: Planetoid-like graphs of 200-220 nodes padded to 256, 32-48
features; training at most 20 epochs.

Tolerances, each with its reason:
- forwards against the reference: rtol=atol=1e-5 (XLA's and ATen's CPU
  dots and scatters sum in different orders);
- baseline against GraNNite inside the port: the reference's own bars
  (`tests/test_gnn_paths.py`): GCN rtol 1e-4 / atol 1e-5, GAT with exact
  masking rtol 5e-3 / atol 5e-4;
- gradients against `jax.grad`: rtol 1e-4 and atol 1e-5 * max|g|, the
  largest entry of the model's whole gradient (a backward sums more terms
  than the forward, in other orders);
- AdamW and the schedules: rtol 1e-6, atol 1e-7 (one ulp of float32 in
  XLA's and ATen's `pow`, `sqrt` and divides);
- `citeseer_like`, `one_hot_gather` and the accuracy: exact; the
  calibration's fields exactly, except the scales of its fp32 forward's
  activations on a graph where that forward rounds: 1 ulp.
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
from repro.core import models as rmodels
from repro.data import graphs as rdata
from repro.optim import adamw as radamw
from repro_torch import bridge
from repro_torch.core import effop as teffop
from repro_torch.core import graph as tg
from repro_torch.core import layers as tlayers
from repro_torch.core import models as tmodels
from repro_torch.core import sparsity as tsparsity
from repro_torch.core.layers import Techniques as TT
from repro_torch.data import graphs as tdata
from repro_torch.kernels import ops as tops
from repro_torch.optim import adamw as tadamw

RT = rlayers.Techniques
TOL = dict(rtol=1e-5, atol=1e-5)
GCN_BAR = dict(rtol=1e-4, atol=1e-5)
GAT_BAR = dict(rtol=5e-3, atol=5e-4)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
N, CAP, FEATS, CLASSES = 200, 256, 32, 5
KINDS = ("gcn", "gat", "sage-max", "sage-mean")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _graphs(n=N, seed=1, isolate=()):
    """The same Planetoid-like graph from each package's generator, with
    the nodes in `isolate` left without an edge."""
    kw = dict(num_nodes=n, num_edges=2 * n, num_feats=FEATS,
              num_classes=CLASSES, seed=seed, train_per_class=5)
    gs = [rdata.planetoid_like(**kw), tdata.planetoid_like(**kw)]
    if isolate:
        for g in gs:
            keep = ~np.isin(g.edge_index, isolate).any(axis=0)
            g.edge_index = g.edge_index[:, keep]
    return gs


def _cfg(kind):
    name, _, agg = kind.partition("-")
    extra = dict(heads=4, hidden=32) if name == "gat" else {}
    return (rmodels.GNNConfig(kind=name, in_feats=FEATS, num_classes=CLASSES,
                              aggregator=agg or "mean", **extra),
            tmodels.GNNConfig(kind=name, in_feats=FEATS, num_classes=CLASSES,
                              aggregator=agg or "mean", **extra))


def _params(rcfg, seed=0):
    """Reference weights as numpy, and the same on the CPU for the port;
    biases made non-zero so that they take part."""
    p = jax.tree_util.tree_map(
        np.asarray, rmodels.init_params(jax.random.PRNGKey(seed), rcfg))
    rng = np.random.default_rng(seed)
    for layer in p.values():
        for k in layer:
            if k.startswith("b"):
                layer[k] = (rng.standard_normal(layer[k].shape)
                            * 0.1).astype(np.float32)
    return p, bridge.params_from_jax(p, device="cpu")


def _training_forwards(kind, rcfg, tcfg, rpg, tpg, g):
    """`accuracy_table`'s training forward for `kind`, in each package: the
    dense GCN (StaGr) and GAT (EffOp, exact masks), and SAGE on the
    edge-list baseline over the graph's edges."""
    if kind.startswith("sage"):
        ei = g.edge_index
        return (lambda p, x: rmodels.forward_baseline(
                    p, rcfg, x, jnp.asarray(ei), rpg.capacity),
                lambda p, x: tmodels.forward_baseline(
                    p, tcfg, x, ei, tpg.capacity))
    t = dict(stagr=True) if kind == "gcn" else dict(effop=True)
    rops = rmodels.build_operands(rpg, rcfg)
    tops_ = tmodels.build_operands(tpg, tcfg, device="cpu")
    return (lambda p, x: rmodels.forward_grannite(p, rcfg, x, rops, RT(**t)),
            lambda p, x: tmodels.forward_grannite(p, tcfg, x, tops_,
                                                  TT(**t)))


# --------------------------------------------------------------- data


def test_citeseer_like_is_the_reference():
    r, t = rdata.citeseer_like(seed=0), tdata.citeseer_like(seed=0)
    assert (r.num_nodes, t.features.shape) == (3327, (3327, 3703))
    for f in ("edge_index", "features", "labels", "train_mask", "test_mask"):
        a, b = getattr(r, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert tg.pad_graph(t).capacity == 3328


def test_one_hot_gather_is_the_reference():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((37, 9)).astype(np.float32)
    idx = rng.integers(-2, 40, size=(5, 11)).astype(np.int32)
    want = np.asarray(reffop.one_hot_gather(jnp.asarray(h), jnp.asarray(idx)))
    got = teffop.one_hot_gather(_t(h), _t(idx))
    assert got.shape == (5, 11, 9)
    np.testing.assert_array_equal(_np(got), want)
    inside = (idx >= 0) & (idx < 37)
    np.testing.assert_array_equal(want[inside], h[idx[inside]])


# ---------------------------------------------------------- baselines


@pytest.mark.parametrize("isolate", [(), (0, 7)], ids=["planetoid",
                                                        "isolated-nodes"])
@pytest.mark.parametrize("kind", KINDS)
def test_baselines_match_reference(kind, isolate):
    """Each layer's baseline and `forward_baseline` at a padded capacity
    (rows 200..255 are empty segments), with and without isolated real
    nodes, with and without self-loops."""
    rgph, tgph = _graphs(isolate=isolate)
    rcfg, tcfg = _cfg(kind)
    pnp, pt = _params(rcfg)
    x = rg.pad_graph(rgph, capacity=CAP).features
    for ei in (rgph.edge_index, rg.add_self_loops(rgph.edge_index, N)):
        want = rmodels.forward_baseline(pnp, rcfg, jnp.asarray(x),
                                        jnp.asarray(ei), CAP)
        got = tmodels.forward_baseline(pt, tcfg, _t(x), ei, CAP)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    l1r, l1t = pnp["l1"], pt["l1"]
    ei = rgph.edge_index
    if tcfg.kind == "gcn":
        want = rlayers.gcn_baseline(l1r, jnp.asarray(x), jnp.asarray(ei), CAP)
        got = tlayers.gcn_baseline(l1t, _t(x), _t(ei), CAP)
    elif tcfg.kind == "gat":
        kw = dict(heads=tcfg.heads, out_feats=tcfg.hidden // tcfg.heads)
        for concat in (True, False):
            want = rlayers.gat_baseline(l1r, jnp.asarray(x), jnp.asarray(ei),
                                        CAP, concat=concat, **kw)
            got = tlayers.gat_baseline(l1t, _t(x), _t(ei), CAP,
                                       concat=concat, **kw)
            np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    else:
        want = rlayers.sage_baseline(l1r, jnp.asarray(x), jnp.asarray(ei),
                                     CAP, aggregator=tcfg.aggregator)
        got = tlayers.sage_baseline(l1t, _t(x), _t(ei), CAP,
                                    aggregator=tcfg.aggregator)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_baseline_equals_grannite_in_the_port(kind):
    """With self-loop edges, the edge-list forward equals the dense one at
    the reference's bars: GCN against StaGr, GAT against exact masking."""
    _, tgph = _graphs()
    rcfg, tcfg = _cfg(kind)
    _, pt = _params(rcfg)
    pg = tg.pad_graph(tgph, capacity=CAP)
    x = _t(pg.features)
    base = tmodels.forward_baseline(
        pt, tcfg, x, tg.add_self_loops(tgph.edge_index, N), CAP)
    ops_ = tmodels.build_operands(pg, tcfg, device="cpu")
    t, bar = ((TT(stagr=True), GCN_BAR) if kind == "gcn"
              else (TT(effop=True, grax1=False, grax2=True), GAT_BAR))
    dense = tmodels.forward_grannite(pt, tcfg, x, ops_, t)
    np.testing.assert_allclose(_np(base[:N]), _np(dense[:N]), **bar)


# ---------------------------------------------------------- gradients


def _grad_case(kind, forward, tied=False):
    rgph, tgph = _graphs(isolate=(3,))
    if tied:
        # nodes 11 and 12 get node 10's features and every in-neighbour
        # of 10 gets them as neighbours too: each max over such a
        # neighbourhood ties between equal pooled rows
        for g in (rgph, tgph):
            g.features[11] = g.features[12] = g.features[10]
            dsts = np.unique(g.edge_index[1][g.edge_index[0] == 10])
            extra = np.stack([np.repeat([11, 12], dsts.size),
                              np.tile(dsts, 2)]).astype(np.int32)
            g.edge_index = np.unique(np.concatenate([g.edge_index, extra],
                                                    axis=1), axis=1)
    rcfg, tcfg = _cfg(kind)
    pnp, pt = _params(rcfg)
    rpg, tpg = rg.pad_graph(rgph, capacity=CAP), tg.pad_graph(tgph,
                                                               capacity=CAP)
    if forward == "training":
        rf, tf = _training_forwards(kind, rcfg, tcfg, rpg, tpg, rgph)
    else:
        ei = rg.add_self_loops(rgph.edge_index, N)
        rf = lambda p, x: rmodels.forward_baseline(    # noqa: E731
            p, rcfg, x, jnp.asarray(ei), CAP)
        tf = lambda p, x: tmodels.forward_baseline(    # noqa: E731
            p, tcfg, x, ei, CAP)
    return rpg, tpg, pnp, pt, rf, tf


@pytest.mark.parametrize("case", [
    ("gcn", "training"), ("gat", "training"), ("sage-max", "training"),
    ("sage-mean", "training"), ("gcn", "baseline"), ("gat", "baseline"),
    ("sage-max", "tied"), ("sage-max", "baseline")],
    ids=lambda c: "-".join(c))
def test_gradients_match_jax_grad(case):
    kind, forward = case
    rpg, tpg, pnp, pt, rf, tf = _grad_case(
        kind, "training" if forward == "tied" else forward,
        tied=forward == "tied")
    x, y, tm = (jnp.asarray(rpg.features), jnp.asarray(rpg.labels),
                jnp.asarray(rpg.train_mask))
    want = jax.grad(lambda p: rmodels.masked_cross_entropy(
        rf(p, x), y, tm))(pnp)
    leaves = {k: {n: v.clone().requires_grad_(True) for n, v in l.items()}
              for k, l in pt.items()}
    loss = tmodels.masked_cross_entropy(
        tf(leaves, _t(tpg.features)), _t(tpg.labels).long(),
        _t(tpg.train_mask))
    flat = [(k, n, v) for k, l in leaves.items() for n, v in l.items()]
    grads = torch.autograd.grad(loss, [v for _, _, v in flat])
    # max|g| over the whole gradient: a leaf whose gradient is 0 in exact
    # arithmetic (the score term of GAT's one-head layer 2, a shift of
    # each row's softmax wherever leaky ReLU is linear on the row) holds
    # rounding noise of 1e-10 that neither side gets right
    gmax = max(np.abs(np.asarray(w)).max()
               for w in jax.tree_util.tree_leaves(want))
    assert gmax > 0
    for (k, n, _), g in zip(flat, grads):
        np.testing.assert_allclose(_np(g), np.asarray(want[k][n]), rtol=1e-4,
                                   atol=1e-5 * gmax,
                                   err_msg=f"{kind} {forward} {k}.{n}")


def test_segment_max_ties_share_the_gradient():
    """A max over equal values hands each an equal part of the gradient,
    as `jax.grad` of `segment_max` does; an empty segment stays -inf."""
    msgs = np.array([[1.0, 2.0], [1.0, 5.0], [0.5, 5.0], [3.0, 3.0]],
                    np.float32)
    dst = np.array([0, 0, 0, 2], np.int32)
    want_v = jax.ops.segment_max(jnp.asarray(msgs), jnp.asarray(dst),
                                 num_segments=4)
    want_g = jax.grad(lambda m: jnp.sum(jnp.where(
        jnp.isfinite(s := jax.ops.segment_max(m, jnp.asarray(dst),
                                              num_segments=4)), s, 0.0)
        * jnp.arange(1.0, 9.0).reshape(4, 2)))(jnp.asarray(msgs))
    m = _t(msgs).requires_grad_(True)
    s = tlayers._segment_max(m, _t(dst).long(), 4)
    np.testing.assert_array_equal(_np(s), np.asarray(want_v))
    (torch.where(torch.isfinite(s), s, 0.0)
     * torch.arange(1.0, 9.0).reshape(4, 2)).sum().backward()
    np.testing.assert_array_equal(_np(m.grad), np.asarray(want_g))


# -------------------------------------------------------------- AdamW


def _tree(rng):
    return {"l1": {"w": rng.standard_normal((6, 4)).astype(np.float32),
                   "b": rng.standard_normal(4).astype(np.float32)},
            "l2": {"w": rng.standard_normal((4, 3)).astype(np.float32)}}


def _host(v):
    return _np(v) if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, **tol):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(_host(g), _host(w), **tol),
        got, want)


@pytest.mark.parametrize("wd", [0.0, 5e-4])
def test_adamw_update_matches_reference(wd):
    rng = np.random.default_rng(0)
    p = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    grads[2]["l1"]["b"][:] = 0.0            # a zero gradient: m, v decay
    rp, ro = p, radamw.adamw_init(jax.tree_util.tree_map(jnp.asarray, p))
    tp = bridge.params_from_jax(p, device="cpu")
    to = tadamw.adamw_init(tp)
    assert to["count"].dtype == torch.int32
    for g in grads:
        rp, ro = radamw.adamw_update(rp, jax.tree_util.tree_map(
            jnp.asarray, g), ro, lr=0.01, weight_decay=wd)
        tp, to = tadamw.adamw_update(tp, bridge.params_from_jax(
            g, device="cpu"), to, lr=0.01, weight_decay=wd)
        _close(tp, rp, **OPT_TOL)
        _close({"m": to["m"], "v": to["v"]}, {"m": ro["m"], "v": ro["v"]},
               **OPT_TOL)
        assert int(to["count"]) == int(ro["count"])


def test_adamw_first_step_is_lr_times_sign():
    p = {"w": torch.tensor([1.0, -2.0, 0.5])}
    g = {"w": torch.tensor([3e-3, -7.0, 1e-5])}
    new, _ = tadamw.adamw_update(p, g, tadamw.adamw_init(p), lr=0.01)
    torch.testing.assert_close(new["w"] - p["w"],
                               torch.tensor([-0.01, 0.01, -0.01]),
                               rtol=1e-3, atol=1e-6)


def test_clip_and_schedules_match_reference():
    rng = np.random.default_rng(1)
    g = _tree(rng)
    for max_norm in (0.5, 1e6):
        rg_, rn = radamw.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        tg_, tn = tadamw.clip_by_global_norm(
            bridge.params_from_jax(g, device="cpu"), max_norm)
        _close(tg_, rg_, **OPT_TOL)
        np.testing.assert_allclose(float(tn), float(rn), **OPT_TOL)
    steps = np.arange(-3, 130, dtype=np.int32)
    kw = dict(base_lr=3e-4, total_steps=100, min_frac=0.1)
    np.testing.assert_allclose(
        _np(tadamw.cosine_schedule(_t(steps), **kw)),
        np.asarray(radamw.cosine_schedule(jnp.asarray(steps), **kw)),
        **OPT_TOL)
    kw = dict(base_lr=3e-4, warmup_steps=10, total_steps=100)
    np.testing.assert_allclose(
        _np(tadamw.linear_warmup_cosine(_t(steps), **kw)),
        np.asarray(radamw.linear_warmup_cosine(jnp.asarray(steps), **kw)),
        **OPT_TOL)
    assert float(tadamw.cosine_schedule(5, base_lr=1.0, total_steps=10)) \
        == pytest.approx(0.55)


# ------------------------------------------------- loss and accuracy


def test_masked_cross_entropy_and_accuracy_match_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, 40).astype(np.int32)
    mask = rng.random(40) < 0.5
    labels[~mask & (np.arange(40) % 2 == 0)] = -1   # padding under the mask
    logits[5] = logits[5, 0]                        # an argmax tie
    for m in (mask, np.zeros(40, bool)):
        want = rmodels.masked_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels),
                                            jnp.asarray(m))
        got = tmodels.masked_cross_entropy(_t(logits), _t(labels), _t(m))
        np.testing.assert_allclose(float(got), float(want), **OPT_TOL)
        want = rmodels.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(m))
        got = tmodels.accuracy(_t(logits), _t(labels), _t(m))
        assert got.dtype == torch.float32 and float(got) == float(want)


# ----------------------------------------------------------- training


def _ref_loop(rcfg, rpg, rf, p, epochs):
    """The reference's `train_node_classifier` step by step, recording
    each epoch's loss (the reference returns only the parameters)."""
    x, y, tm = (jnp.asarray(rpg.features), jnp.asarray(rpg.labels),
                jnp.asarray(rpg.train_mask))

    @jax.jit
    def step(p, o):
        loss, g = jax.value_and_grad(
            lambda q: rmodels.masked_cross_entropy(rf(q, x), y, tm))(p)
        p, o = radamw.adamw_update(p, g, o, lr=0.01, weight_decay=5e-4)
        return p, o, loss

    o, losses = radamw.adamw_init(p), []
    for _ in range(epochs):
        p, o, loss = step(p, o)
        losses.append(float(loss))
    return p, np.array(losses)


@pytest.mark.parametrize("kind", KINDS)
def test_train_node_classifier_matches_reference(kind):
    """Both packages start from the same weights and train 20 epochs; the
    loss is held at every epoch, relative to the reference's.

    GCN and SAGE at rtol 1e-5 (5.7e-7 seen): the summation orders differ
    by ulps and AdamW's normalised steps do not grow them. GAT at rtol
    1e-3 (1.2e-4 seen): the gradient of its one-head layer 2's `a_dst` is
    0 in exact arithmetic (see `test_gradients_match_jax_grad`), so each
    side's rounding noise (1e-10) picks its sign, and AdamW moves that
    weight by lr * sign(noise) each epoch, in each package its own way.
    The test accuracy is held within one test node; the port's trained
    weights through the reference's forward (`params_to_numpy`) give the
    port's own logits at the parity bar and its accuracy exactly."""
    epochs = 20
    rgph, tgph = _graphs()
    rcfg, tcfg = _cfg(kind)
    pnp, pt = _params(rcfg)
    rpg, tpg = rg.pad_graph(rgph, capacity=CAP), tg.pad_graph(tgph,
                                                               capacity=CAP)
    rf, tf = _training_forwards(kind, rcfg, tcfg, rpg, tpg, rgph)
    rp, rlosses = _ref_loop(rcfg, rpg, rf, pnp, epochs)
    rtrained = rmodels.train_node_classifier(None, rcfg, rpg, rf, pnp,
                                             epochs=epochs)
    _close(rtrained, rp, rtol=0, atol=0)     # the loop is the reference's
    history = []
    tp = tmodels.train_node_classifier(None, tcfg, tpg, tf, pt,
                                       epochs=epochs, device="cpu",
                                       history=history)
    tlosses = np.array([float(v) for v in history])
    np.testing.assert_allclose(tlosses, rlosses,
                               rtol=1e-3 if kind == "gat" else 1e-5)
    assert tlosses[-1] < tlosses[0]
    assert all(not v.requires_grad for l in tp.values() for v in l.values())
    racc = rmodels.evaluate(rcfg, rtrained, rpg, rf)
    tacc = tmodels.evaluate(tcfg, tp, tpg, tf, device="cpu")
    assert abs(tacc - racc) <= 1.0 / tpg.test_mask.sum() + 1e-6
    back = bridge.params_to_numpy(tp)
    x = jnp.asarray(rpg.features)
    np.testing.assert_allclose(
        np.asarray(rf(back, x))[:N],
        _np(tf(tp, _t(tpg.features)))[:N], **TOL)
    assert float(rmodels.evaluate(rcfg, back, rpg, rf)) == tacc


def test_params_to_numpy_inverts_params_from_jax():
    pnp, pt = _params(_cfg("sage-max")[0])
    back = bridge.params_to_numpy(pt)
    assert back.keys() == pnp.keys()
    for k in pnp:
        for n in pnp[k]:
            assert back[k][n].dtype == pnp[k][n].dtype
            np.testing.assert_array_equal(back[k][n], pnp[k][n])


def _detached(fn):
    """A stand-in for a kernel wrapper: the plain result without a path
    back to the operands, as a CUDA kernel's output has."""
    def run(*a, **kw):
        with torch.no_grad():
            return fn(*a, **kw)
    return run


@pytest.mark.parametrize("fusion", ["none", "layer"])
def test_training_through_a_kernel_wrapper_raises(monkeypatch, fusion):
    _, tgph = _graphs()
    _, tcfg = _cfg("gcn")
    _, pt = _params(_cfg("gcn")[0])
    pg = tg.pad_graph(tgph, capacity=CAP)
    ops_ = tmodels.build_operands(pg, tcfg, device="cpu")
    monkeypatch.setattr(tops, "matmul", _detached(tops.matmul))
    monkeypatch.setattr(tops, "fused_gcn_layer",
                        _detached(tops.fused_gcn_layer))
    t = TT(stagr=True, use_pallas=fusion == "none")

    def fwd(p, x):
        return tmodels.forward_grannite(p, tcfg, x, ops_, t, fusion=fusion)

    with pytest.raises(RuntimeError, match="epoch 0: no full gradient "
                                           r"reached ([a-z0-9.]+(, )?)+;") \
            as e:
        tmodels.train_node_classifier(None, tcfg, pg, fwd, pt, epochs=2,
                                      device="cpu")
    named = str(e.value).split("reached ")[1].split(";")[0].split(", ")
    # with use_pallas only l2's bias is added after the last kernel call;
    # a fused layer puts the bias in the kernel too
    assert sorted(named) == (["l1.b", "l1.w", "l2.w"] if fusion == "none"
                             else ["l1.b", "l1.w", "l2.b", "l2.w"])


# every kernel entry's inner kernel replaced by its result without a path
# back, as a CUDA kernel's is; the entries' guard must still name the cut
_KERNELS = ("block_matmul", "_gat_attention", "_sage_max", "fused_gcn_dense",
            "fused_gat_full", "fused_sage")


@pytest.mark.parametrize("kind,t,fusion,cut", [
    ("gcn", dict(stagr=True, use_pallas=True), "none",
     "l1.b l1.w l2.w"),
    ("gcn", dict(stagr=True), "layer", "l1.b l1.w l2.b l2.w"),
    ("sage-mean", dict(stagr=True, use_pallas=True), "none",
     "l1.b l1.w_neigh l1.w_self"),
    ("sage-max", dict(stagr=True, grax3=True, use_pallas=True), "none",
     "l1.b l1.b_pool l1.w_neigh l1.w_pool l1.w_self l2.b_pool l2.w_pool"),
    ("sage-max", dict(stagr=True, grax3=True), "layer",
     "l1.b l1.b_pool l1.w_neigh l1.w_pool l1.w_self l2.b l2.b_pool "
     "l2.w_neigh l2.w_pool l2.w_self"),
    ("gat", dict(effop=True, grax1=True, grax2=True, use_pallas=True), "none",
     "l1.a_dst l1.a_src l1.b l1.w l2.a_dst l2.a_src l2.w"),
    ("gat", dict(effop=True, grax1=True, grax2=True), "layer",
     "l1.a_dst l1.a_src l1.b l1.w l2.a_dst l2.a_src l2.b l2.w"),
], ids=["gcn-pallas", "gcn-layer", "sage-mean-pallas", "sage-max-pallas",
        "sage-max-layer", "gat-pallas", "gat-layer"])
def test_training_through_a_kernel_entry_names_every_cut(monkeypatch, kind, t,
                                                        fusion, cut):
    """A partial gradient (every parameter reached, some only in part, as
    SAGE-mean's l1 through layer 2's aggregation) raises too, naming
    exactly the parameters upstream of an operand given to a kernel."""
    for k in _KERNELS:
        monkeypatch.setattr(tops, k, _detached(getattr(tops, k)))
    _, tgph = _graphs()
    rcfg, tcfg = _cfg(kind)
    _, pt = _params(rcfg)
    pg = tg.pad_graph(tgph, capacity=CAP)
    ops_ = tmodels.build_operands(pg, tcfg, device="cpu")

    def fwd(p, x):
        return tmodels.forward_grannite(p, tcfg, x, ops_, TT(**t),
                                        fusion=fusion)

    with pytest.raises(RuntimeError, match="epoch 0: no full gradient "
                                           r"reached ([a-z0-9_.]+(, )?)+;") \
            as e:
        tmodels.train_node_classifier(None, tcfg, pg, fwd, pt, epochs=2,
                                      device="cpu")
    named = str(e.value).split("reached ")[1].split(";")[0].split(", ")
    assert sorted(named) == cut.split()


def _entry_calls():
    """Each kernel entry with small CPU operands; the float ones are made
    to require grad."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    adj = (r(16, 16) > 0.5).float()
    sp = tsparsity.upload_block_sparse(tsparsity.to_block_sparse(
        (np.random.default_rng(0).random((256, 256)) > 0.9
         ).astype(np.float32)), device="cpu")
    return {
        "matmul": (tops.matmul, (r(16, 8), r(8, 4)), {}),
        "int8_matmul": (tops.int8_matmul, (
            torch.randint(-127, 128, (4, 8), generator=g, dtype=torch.int8),
            torch.randint(-127, 128, (8, 4), generator=g, dtype=torch.int8),
            torch.tensor(0.1), r(4).abs()), {}),
        "bitmap_spmm": (tops.bitmap_spmm, (sp, r(256, 8)), {}),
        "gat_attention": (tops.gat_attention, (
            r(16, 2, 4), r(16, 2), r(16, 2), (adj - 1) * 1e9), {}),
        "sage_max": (tops.sage_max, (adj, r(16, 4).abs()), {}),
        "fused_gcn_layer": (tops.fused_gcn_layer, (r(16, 8), r(8, 4), r(4)),
                            {"norm_adj": adj / 4}),
        "fused_gat_layer": (tops.fused_gat_layer, (
            r(16, 8), r(8, 2, 4), r(2, 4), r(2, 4), (adj - 1) * 1e9,
            r(2, 4)), {}),
        "fused_sage_layer": (tops.fused_sage_layer, (
            r(16, 8), r(8, 4), r(8, 4), r(4)), {"mean_mask": adj / 4}),
        "flash_attention": (tops.flash_attention, (
            r(1, 8, 2, 32), r(1, 8, 2, 32), r(1, 8, 2, 32)), {}),
    }


@pytest.mark.parametrize("entry", list(_entry_calls()))
def test_kernel_entries_refuse_operands_that_require_grad(entry):
    fn, args, kwargs = _entry_calls()[entry]
    with torch.no_grad():
        want = fn(*args, **kwargs)
    graded = [a.requires_grad_(True) for a in args
              if isinstance(a, torch.Tensor) and a.is_floating_point()]
    assert graded
    if entry == "flash_attention":
        # the one entry with a gradient (its backward kernel on the card,
        # autograd through its plain version here): it refuses and cuts
        # nothing, and its result carries the path back
        with tops.record_grad_cuts() as cuts:
            got = fn(*args, **kwargs)
        assert cuts == [] and got.grad_fn is not None
        torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
        grads = torch.autograd.grad(got.sum(), graded)
        assert all(g.abs().sum() > 0 for g in grads)
        return
    with pytest.raises(tops.NoBackward, match=f"^{entry}: "):
        fn(*args, **kwargs)
    with tops.record_grad_cuts() as cuts:
        got = fn(*args, **kwargs)
    assert got.grad_fn is None and not got.requires_grad
    assert [e for e, _ in cuts] == [entry] * len(graded)
    assert all(any(t is a for a in graded) for _, t in cuts)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # outside the block the entries refuse again
    with pytest.raises(tops.NoBackward):
        fn(*args, **kwargs)


def test_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tgph = _graphs()
    _, tcfg = _cfg("gcn")
    pg = tg.pad_graph(tgph, capacity=CAP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.train_node_classifier(torch.Generator(), tcfg, pg,
                                      lambda p, x: x, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.evaluate(tcfg, {}, pg, lambda p, x: x)


def test_default_init_trains_on_the_cpu():
    _, tgph = _graphs()
    _, tcfg = _cfg("gcn")
    pg = tg.pad_graph(tgph, capacity=CAP)
    ops_ = tmodels.build_operands(pg, tcfg, device="cpu")

    def fwd(p, x):
        return tmodels.forward_grannite(p, tcfg, x, ops_, TT(stagr=True))

    history = []
    p = tmodels.train_node_classifier(torch.Generator().manual_seed(0), tcfg,
                                      pg, fwd, epochs=15, device="cpu",
                                      history=history)
    assert history[-1] < history[0] and len(history) == 15
    assert tmodels.evaluate(tcfg, p, pg, fwd, device="cpu") > 0.5


# ---------------------------------------------------- calibrate_quant


def _dyadic_case():
    """A 3-regular graph (a ring with chords to the opposite node) with
    features and weights on a coarse binary grid: every node has degree 4
    with its self-loop, so Â's entries are 1/4, and every product and sum
    of the GCN forward is exact in float32, in any order."""
    rng = np.random.default_rng(3)
    i = np.arange(N)
    src = np.concatenate([i, i, i])
    dst = np.concatenate([(i + 1) % N, (i - 1) % N, (i + N // 2) % N])
    feats = (rng.integers(-4, 5, (N, FEATS)) / 8).astype(np.float32)
    labels = rng.integers(0, CLASSES, N).astype(np.int32)
    mask = rng.random(N) < 0.5
    gs = [mod.Graph(edge_index=np.stack([src, dst]).astype(np.int32),
                    num_nodes=N, features=feats.copy(), labels=labels,
                    train_mask=mask, test_mask=~mask) for mod in (rg, tg)]
    rcfg, _ = _cfg("gcn")
    pnp = {"l1": {"w": rng.integers(-8, 9, (FEATS, 64)) / 16,
                  "b": rng.integers(-8, 9, 64) / 16},
           "l2": {"w": rng.integers(-8, 9, (64, CLASSES)) / 16,
                  "b": rng.integers(-8, 9, CLASSES) / 16}}
    pnp = jax.tree_util.tree_map(lambda a: a.astype(np.float32), pnp)
    return gs, pnp


@pytest.mark.parametrize("graph", ["planetoid", "dyadic"])
def test_calibrate_quant_matches_reference(graph):
    """Every field is held exactly where it depends on the inputs alone
    (the int8 weights, their scales, x's scale, Â's int8 rows and row
    scales). The scales of the forward's activations (l2's x_scale and the
    aggregations' h_scale) are an absmax over an fp32 forward, so on the
    Planetoid-like graph they are held within 1 ulp (the two packages sum
    Â @ H in different orders), and exactly on the dyadic graph, where the
    forward is exact in float32."""
    if graph == "dyadic":
        (rgph, tgph), pnp = _dyadic_case()
        pt = bridge.params_from_jax(pnp, device="cpu")
    else:
        rgph, tgph = _graphs()
        pnp, pt = _params(_cfg("gcn")[0])
    rcfg, tcfg = _cfg("gcn")
    rpg, tpg = rg.pad_graph(rgph, capacity=CAP), tg.pad_graph(tgph,
                                                               capacity=CAP)
    rops = rmodels.build_operands(rpg, rcfg)
    tops_ = tmodels.build_operands(tpg, tcfg, device="cpu")
    x = rpg.features
    want = rmodels.calibrate_quant(pnp, rcfg, jnp.asarray(x), rops)
    got = tmodels.calibrate_quant(pt, tcfg, _t(x), tops_)
    assert got.keys() == want.keys()
    activation_scales = {("l2", "x_scale"), ("agg1", "h_scale"),
                         ("agg2", "h_scale")}
    for k, fields in (("l1", ("wq", "w_scale", "x_scale")),
                      ("l2", ("wq", "w_scale", "x_scale")),
                      ("agg1", ("aq", "a_scale", "h_scale")),
                      ("agg2", ("aq", "a_scale", "h_scale"))):
        for f in fields:
            a, b = _np(getattr(got[k], f)), np.asarray(getattr(want[k], f))
            assert a.dtype == b.dtype and a.shape == b.shape, (k, f)
            if graph == "planetoid" and (k, f) in activation_scales:
                np.testing.assert_array_max_ulp(a, b, maxulp=1)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{k}.{f}")
    t = dict(stagr=True, quantgr=True)
    want_l = rmodels.forward_grannite(pnp, rcfg, jnp.asarray(x),
                                      dataclasses.replace(rops, quant=want),
                                      RT(**t))
    ops_q = dataclasses.replace(tops_, quant=got)
    for fusion in ("none", "layer"):
        got_l = tmodels.forward_grannite(pt, tcfg, _t(x), ops_q, TT(**t),
                                         fusion=fusion)
        np.testing.assert_allclose(_np(got_l)[:N], np.asarray(want_l)[:N],
                                   **TOL)
        assert np.array_equal(_np(got_l)[:N].argmax(-1),
                              np.asarray(want_l)[:N].argmax(-1))
    with pytest.raises(NotImplementedError):
        tmodels.calibrate_quant(pt, _cfg("gat")[1], _t(x), tops_)


def test_stack_operands_refuses_offline_quant_and_names_calibrate_quant():
    _, tgph = _graphs()
    _, tcfg = _cfg("gcn")
    _, pt = _params(_cfg("gcn")[0])
    pg = tg.pad_graph(tgph, capacity=CAP)
    ops_ = tmodels.build_operands(pg, tcfg, device="cpu")
    ops_q = dataclasses.replace(ops_, quant=tmodels.calibrate_quant(
        pt, tcfg, _t(pg.features), ops_))
    with pytest.raises(ValueError, match="calibrate_quant"):
        tmodels.stack_operands([ops_q, ops_])


# ----------------------------------------------------------- examples


def test_quickstart_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    quickstart.main(["--device", "cpu", "--epochs", "3", "--nodes", "220"])
    out = capsys.readouterr().out
    assert "test accuracy (fp32 dense path)" in out
    assert "QuantGr INT8" in out and "baseline (gather/scatter)" in out


def test_quality_tiers_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import quality_tiers
    quality_tiers.main(["--device", "cpu", "--epochs", "3", "--nodes",
                        "200"])
    out = capsys.readouterr().out
    assert "accuracy_delta_vs_fp32" in out and "int8+grax" in out
