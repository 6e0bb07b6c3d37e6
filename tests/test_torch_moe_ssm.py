"""PyTorch port, the MoE, SSM and hybrid LM families: `repro_torch`'s
`nn/moe.py`, `nn/ssm.py`, the stack with SSM and MoE layers, the LM
entry points and the server for olmoe-1b-7b, llama4-scout-17b-a16e,
mamba2-2.7b and jamba-v0.1-52b, against the reference package on the
same numpy inputs.

Weights: the reference's parameter tree (its shapes, from `jax.eval_shape`
of its `lm_init`) filled from numpy with a seed: matrices N(0, 1/fan_in),
the embedding N(0, 1), norm scales and the SSM skip 1 + 0.2 N(0, 1), the
conv bias 0.1 N(0, 1), A = -exp(a_log) with a_log = log U(1, 16) and the
dt bias the inverse softplus of a log-uniform dt in [1e-3, 1e-1] (the
Mamba2 defaults). They reach both packages, the port through
`bridge.lm_params_from_jax`.

Sizes: the reference's `reduced()` configs (2 layers, or two 8-layer
superblocks for jamba; d_model 128, 8 experts top-2 of width 128 in groups
of 64, SSM d_state 16, headdim 16, chunk 32, vocab 512, float32).

Tolerance:
  * exact: the routes' expert indices, the dispatch masks, the combine
    masks from the same gates and indices, `capacity`, the greedy tokens
    and the server's counters. The gates are held at rtol 1e-6 and atol
    1e-7 (a few float32 steps): XLA's CPU `exp` is not correctly rounded
    (9% of float32 results differ from the float64 exp rounded; ATen's
    1%), so no softmax of the port equals XLA's bit for bit.
  * rtol = atol = 1e-4, the LM bar (`PERF.md` §2): MoE outputs and aux,
    `ssd_scan`, `ssm_forward` and its cache, `ssm_decode` chains,
    `ssm_reference`, and prefill and decode logits and caches. XLA and
    ATen sum their dots in other orders.
  * one bf16 SSM layer: the largest difference at most 2e-2 of the
    largest |output|, as for the dense layer in `test_torch_lm.py`.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS
from repro.configs import reduced as rreduced
from repro.nn import lm as rlm
from repro.nn import moe as rmoe
from repro.nn import ssm as rssm
from repro.nn import transformer as rtfm
from repro.nn.common import Param
from repro.runtime import server as rserver
from repro_torch import bridge
from repro_torch import configs
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.nn import config as tconfig
from repro_torch.nn import layerwise
from repro_torch.nn import lm as tlm
from repro_torch.nn import moe as tmoe
from repro_torch.nn import ssm as tssm
from repro_torch.nn import transformer as ttfm
from repro_torch.runtime import server as tserver

TOL = dict(rtol=1e-4, atol=1e-4)
GATE_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_BAR = 2e-2
FAMILIES = ("olmoe-1b-7b", "llama4-scout-17b-a16e", "mamba2-2.7b",
            "jamba-v0.1-52b")


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _is_param(x):
    return isinstance(x, Param)


def _key_name(k):
    return getattr(k, "name", getattr(k, "key", None))


def _leaf(rng, name, shape):
    """One numpy leaf by the reference's field name; `shape` carries the
    leading num_superblocks axis for stacked leaves."""
    if name in ("scale", "q_norm", "k_norm", "norm", "d_skip"):
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    if name in ("bias", "conv_b"):
        return _arr(rng, *shape, scale=0.1)
    if name == "a_log":
        return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    if name == "dt_bias":
        dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), shape))
        return (dt0 + np.log(-np.expm1(-dt0))).astype(np.float32)
    if name == "embed":
        return _arr(rng, *shape)
    if name == "conv_w":
        return _arr(rng, *shape, scale=1.0 / shape[-2])
    fan_in = shape[-2] if name == "unembed" else shape[1]
    return _arr(rng, *shape, scale=fan_in ** -0.5)


def _numpy_params(rcfg, seed):
    """The reference's LMParams (Param leaves) filled from numpy, and the
    same tree as plain numpy containers for the bridge."""
    shapes = jax.eval_shape(lambda: rlm.lm_init(jax.random.PRNGKey(0), rcfg))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        shapes, is_leaf=_is_param)
    rng = np.random.default_rng(seed)
    vals = []
    for path, p in leaves:
        name = _key_name(path[-1])
        if name == "value":
            name = _key_name(path[-2])
        vals.append(Param(jnp.asarray(_leaf(rng, name, p.value.shape)),
                          p.axes))
    rparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes, is_leaf=_is_param), vals)
    return rparams, _numpy_tree(rparams)


def _numpy_tree(node):
    if node is None:
        return None
    if _is_param(node):
        return np.asarray(node.value)
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_numpy_tree(v) for v in node]
    if hasattr(node, "_asdict"):
        return {k: _numpy_tree(v) for k, v in node._asdict().items()}
    return np.asarray(node)


_WEIGHTS = {}


def _weights(name, seed=0, dtype="float32", **moe):
    """(reference config, port config, reference params, port params on
    the CPU, numpy tree); `moe` replaces fields of the MoE config."""
    key = (name, seed, dtype, tuple(sorted(moe.items())))
    if key not in _WEIGHTS:
        rcfg = dataclasses.replace(rreduced(RARCHS[name]),
                                   compute_dtype=dtype)
        tcfg = dataclasses.replace(reduced(get_config(name)),
                                   compute_dtype=dtype)
        if moe:
            rcfg = dataclasses.replace(
                rcfg, moe=dataclasses.replace(rcfg.moe, **moe))
            tcfg = dataclasses.replace(
                tcfg, moe=dataclasses.replace(tcfg.moe, **moe))
        rparams, tree = _numpy_params(rcfg, seed)
        tparams = bridge.lm_params_from_jax(tree, device="cpu")
        _WEIGHTS[key] = (rcfg, tcfg, rparams, tparams, tree)
    return _WEIGHTS[key]


def _jit(fn, **static):
    """The reference function jitted, its keyword arguments fixed: one
    compile, then fast calls (eager JAX dispatches every operation)."""
    return jax.jit(functools.partial(fn, **static))


def _layer(params, blk, pos):
    return rtfm.slice_block(params.stack, blk)[pos]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------- config

def test_reduced_configs_match_reference():
    for name in FAMILIES:
        r, t = rreduced(RARCHS[name]), reduced(get_config(name))
        assert (t.moe is None) == (r.moe is None)
        if t.moe is not None:
            assert dataclasses.asdict(t.moe) == dataclasses.asdict(r.moe)
        if t.ssm is not None:
            assert dataclasses.asdict(t.ssm) == dataclasses.asdict(r.ssm)
        assert (t.num_layers, t.d_model, t.num_heads, t.num_kv_heads,
                t.d_ff) == (r.num_layers, r.d_model, r.num_heads,
                            r.num_kv_heads, r.d_ff)
        assert t.superblock == r.superblock
        assert ([t.layer_uses_moe(i, k) for i, k in enumerate(t.superblock)]
                == [r.layer_uses_moe(i, k)
                    for i, k in enumerate(r.superblock)])
        assert (t.attention_free, t.sub_quadratic, t.is_encdec) == (
            r.attention_free, r.sub_quadratic, r.is_encdec)


def _port_config(rcfg):
    """The reference's config as the port's ArchConfig (its fields only),
    for the two architectures the port has no file for."""
    fields = {f.name for f in dataclasses.fields(tconfig.ArchConfig)}
    kw = {k: v for k, v in dataclasses.asdict(rcfg).items() if k in fields}
    for k, cls in (("moe", tconfig.MoEConfig), ("ssm", tconfig.SSMConfig),
                   ("encoder", tconfig.EncoderConfig)):
        if kw[k] is not None:
            kw[k] = cls(**kw[k])
    return tconfig.ArchConfig(**kw)


@pytest.mark.parametrize("name", sorted(RARCHS))
def test_param_counts_match_reference(name):
    rcfg = RARCHS[name]
    tcfg = ARCHS[name] if name in ARCHS else _port_config(rcfg)
    assert tcfg.param_count() == rcfg.param_count()
    assert tcfg.active_param_count() == rcfg.active_param_count()
    red = reduced(tcfg) if name in ARCHS else _port_config(rreduced(rcfg))
    assert red.param_count() == rreduced(rcfg).param_count()


def test_full_width_sizes():
    """The three models the card serves: OLMoE 6.92 B parameters (1.28 B
    active), Mamba2 2.70 B, Jamba's 8-layer superblock about 13.3 B."""
    olmoe = get_config("olmoe-1b-7b")
    assert round(olmoe.param_count() / 1e9, 2) == 6.92
    assert round(olmoe.active_param_count() / 1e9, 2) == 1.28
    assert round(get_config("mamba2-2.7b").param_count() / 1e9, 2) == 2.70
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8)
    assert 13.0e9 < jamba.param_count() < 13.6e9


# -------------------------------------------------------------------- MoE

def _moe_logits(rng, ng, g, e, scale=2.0):
    return _arr(rng, ng, g, e, scale=scale)


@pytest.mark.parametrize("cf", [4.0, 1.25, 0.5])
def test_route_and_masks_match_reference(cf):
    """Two groups of 64 tokens over 8 experts, top-2: expert indices and
    dispatch masks exact; at capacity factor 0.5 tokens drop (checked)."""
    _, tcfg, _, _, _ = _weights("olmoe-1b-7b")
    m = dataclasses.replace(tcfg.moe, capacity_factor=cf)
    rm = dataclasses.replace(rreduced(RARCHS["olmoe-1b-7b"]).moe,
                             capacity_factor=cf)
    cap = tmoe.capacity(m, 64)
    assert cap == rmoe.capacity(rm, 64)
    logits = _moe_logits(np.random.default_rng(1), 2, 64, m.num_experts)
    gates, idx, probs = tmoe._route(m, torch.from_numpy(logits))
    dispatch, combine = tmoe._dispatch_masks(m, gates, idx, cap)
    dropped = 0
    for n in range(2):
        rg, ri, rp = rmoe._route(rm, jnp.asarray(logits[n]))
        np.testing.assert_array_equal(idx[n].numpy(), np.asarray(ri))
        _close(gates[n], rg, GATE_TOL)
        _close(probs[n], rp, GATE_TOL)
        rd, rc = rmoe._dispatch_masks(rm, rg, ri, cap)
        np.testing.assert_array_equal(dispatch[n].numpy(), np.asarray(rd))
        _close(combine[n], rc, GATE_TOL)
        # the same gates and indices give the same combine, bit for bit
        _, same = tmoe._dispatch_masks(
            m, torch.from_numpy(np.asarray(rg))[None],
            torch.from_numpy(np.asarray(ri)).long()[None], cap)
        np.testing.assert_array_equal(same[0].numpy(), np.asarray(rc))
        dropped += 64 * m.top_k - int(np.asarray(rd).sum())
    assert (dropped > 0) == (cf == 0.5), dropped
    assert dispatch.sum(1).max() <= 1.0          # one token a slot


def test_route_breaks_ties_like_top_k():
    """Logits of few distinct values, so that probabilities tie: the
    lower expert index wins, as in `jax.lax.top_k`."""
    _, tcfg, _, _, _ = _weights("olmoe-1b-7b")
    m = dataclasses.replace(tcfg.moe, num_experts=64, top_k=8)
    rm = dataclasses.replace(rreduced(RARCHS["olmoe-1b-7b"]).moe,
                             num_experts=64, top_k=8)
    rng = np.random.default_rng(2)
    logits = rng.integers(0, 3, (1, 128, 64)).astype(np.float32)
    logits[0, 0] = 0.0                            # every expert tied
    _, idx, _ = tmoe._route(m, torch.from_numpy(logits))
    _, ridx, _ = rmoe._route(rm, jnp.asarray(logits[0]))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(idx[0, 0].numpy(), np.arange(8))


@pytest.mark.parametrize("name,cf", [("olmoe-1b-7b", 4.0),
                                     ("olmoe-1b-7b", 0.5),
                                     ("llama4-scout-17b-a16e", 4.0)])
def test_moe_forward_matches_reference(name, cf):
    """The MoE layer over 2 x 96 tokens (three groups of 64), llama4 with
    its shared expert; at capacity factor 0.5 tokens drop."""
    rcfg, tcfg, rp, tp, _ = _weights(name, capacity_factor=cf)
    x = _arr(np.random.default_rng(3), 2, 96, 128)
    want, waux = _jit(rmoe.moe_forward, cfg=rcfg)(_layer(rp, 1, 0)["mlp"],
                                                  x=jnp.asarray(x))
    got, aux = tmoe.moe_forward(ttfm.slice_block(tp.stack, 1)[0]["mlp"],
                                tcfg, torch.from_numpy(x))
    _close(got, want)
    _close(aux, waux)


# -------------------------------------------------------------------- SSM

def _ssd_inputs(rng, b, s, h, p, g, n):
    return (_arr(rng, b, s, h, p),
            np.log1p(np.exp(_arr(rng, b, s, h))).astype(np.float32),
            -np.exp(_arr(rng, h, scale=0.5)),
            _arr(rng, b, s, g, n), _arr(rng, b, s, g, n))


@pytest.mark.parametrize("s,chunk,init", [(64, 32, False), (70, 32, True),
                                          (48, 48, False)])
def test_ssd_scan_matches_reference(s, chunk, init):
    """Chunked SSD: whole chunks, a ragged last chunk (padded) with an
    initial state, one chunk; 8 heads in 2 groups."""
    rng = np.random.default_rng(4)
    args = _ssd_inputs(rng, 2, s, 8, 16, 2, 16)
    st = _arr(rng, 2, 8, 16, 16) if init else None
    want, wst = _jit(rssm.ssd_scan, chunk=chunk)(
        *(jnp.asarray(a) for a in args),
        init_state=None if st is None else jnp.asarray(st))
    got, gst = tssm.ssd_scan(*(torch.from_numpy(np.asarray(a))
                               for a in args), chunk=chunk,
                             init_state=None if st is None
                             else torch.from_numpy(st))
    _close(got, want)
    _close(gst, wst)


def _ssm_layer(name="mamba2-2.7b", pos=0):
    rcfg, tcfg, rp, tp, _ = _weights(name)
    return (rcfg, tcfg, _layer(rp, 1, pos)["mixer"],
            ttfm.slice_block(tp.stack, 1)[pos]["mixer"])


def test_ssm_forward_and_state_match_reference():
    rcfg, tcfg, rmix, tmix = _ssm_layer()
    x = _arr(np.random.default_rng(5), 2, 72, 128)
    want, wc = _jit(rssm.ssm_forward, cfg=rcfg, return_state=True)(
        rmix, x=jnp.asarray(x))
    got, gc = tssm.ssm_forward(tmix, tcfg, torch.from_numpy(x),
                               return_state=True)
    _close(got, want)
    _close(gc.conv, wc.conv)
    _close(gc.state, wc.state)


def test_ssm_decode_chain_matches_reference():
    """A 40-token prefill state, then five ssm_decode steps, each against
    the reference's step on the reference's cache."""
    rcfg, tcfg, rmix, tmix = _ssm_layer("jamba-v0.1-52b", 0)
    x = _arr(np.random.default_rng(6), 3, 45, 128)
    _, rc = _jit(rssm.ssm_forward, cfg=rcfg, return_state=True)(
        rmix, x=jnp.asarray(x[:, :40]))
    _, tc = tssm.ssm_forward(tmix, tcfg, torch.from_numpy(x[:, :40]),
                             return_state=True)
    decode = _jit(rssm.ssm_decode, cfg=rcfg)
    for t in range(40, 45):
        want, rc = decode(rmix, x=jnp.asarray(x[:, t:t + 1]), cache=rc)
        got, tc = tssm.ssm_decode(tmix, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                  tc)
        _close(got, want)
        _close(tc.state, rc.state)
        _close(tc.conv, rc.conv)


def test_ssm_reference_matches_reference_and_ssd():
    """The sequential oracle against the reference's oracle, and the
    port's chunked SSD against its own oracle."""
    rcfg, tcfg, rmix, tmix = _ssm_layer()
    x = _arr(np.random.default_rng(7), 2, 64, 128)
    want = _jit(rssm.ssm_reference, cfg=rcfg)(rmix, x=jnp.asarray(x))
    oracle = tssm.ssm_reference(tmix, tcfg, torch.from_numpy(x))
    _close(oracle, want)
    chunked = tssm.ssm_forward(tmix, tcfg, torch.from_numpy(x))
    torch.testing.assert_close(chunked, oracle, **TOL)


def test_one_bf16_ssm_layer_matches_reference():
    rcfg, tcfg, _, tp, _ = _weights("mamba2-2.7b", dtype="bfloat16")
    _, _, rp, _, _ = _weights("mamba2-2.7b", dtype="bfloat16")
    x = _arr(np.random.default_rng(8), 2, 40, 128)
    want, _ = _jit(rtfm._layer_forward, cfg=rcfg, kind="ssm")(
        _layer(rp, 0, 0), x=jnp.asarray(x, jnp.bfloat16),
        positions=jnp.arange(40))
    got, _ = ttfm._layer_forward(ttfm.slice_block(tp.stack, 0)[0], tcfg,
                                 torch.from_numpy(x).to(torch.bfloat16),
                                 kind="ssm", positions=torch.arange(40))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_BAR, err


def test_softplus_is_jax_softplus():
    """log(1 + e^x) = logaddexp(x, 0) at every x, on both sides of
    `F.softplus`'s threshold of 20."""
    x = np.array([-30.0, -3.0, 0.0, 5.0, 19.0, 20.5, 21.0, 50.0, 100.0],
                 np.float32)
    got = tssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(
        jnp.asarray(x))), rtol=1e-6, atol=0)


def test_segsum_decay_keeps_the_upper_triangle_zero():
    """Differences above the diagonal overflow exp to inf; the select
    drops them (a multiply by 0 would give NaN)."""
    cum = torch.tensor([[0.0, -50.0, -100.0, -200.0]])
    got = tssm._segsum_decay(cum)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(rssm._segsum_decay(jnp.asarray(cum.numpy()))),
        **TOL)


# ---------------------------------------------------------- whole model

_RUNS = {}


def _reference_run(name):
    """The reference's prefill (B 2, S 32, max_len 40), three decode steps
    at per-slot cursors, lm_hidden, and greedy_generate's loop (prefill,
    argmax, four decode steps from the prompt's end) on the same jitted
    prefill and decode, run once per arch."""
    if name not in _RUNS:
        rcfg, _, rp, _, _ = _weights(name)
        toks = np.random.default_rng(9).integers(0, 512, (2, 32)).astype(
            np.int32)
        prefill = _jit(rlm.lm_prefill, cfg=rcfg, max_len=40)
        decode = _jit(rlm.lm_decode_step, cfg=rcfg)
        logits, state = prefill(rp, tokens=jnp.asarray(toks))
        out = {"toks": toks, "prefill": np.asarray(logits),
               "caches": jax.tree_util.tree_map(np.asarray, state.caches)}
        state = state._replace(pos=jnp.asarray([32, 25], jnp.int32))
        steps = []
        for _ in range(3):
            tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
            logits, state = decode(rp, token=jnp.asarray(tok), state=state)
            steps.append((tok, np.asarray(logits)))
        out["steps"] = steps
        out["last_caches"] = jax.tree_util.tree_map(np.asarray, state.caches)
        h, aux, _ = _jit(rlm.lm_hidden, cfg=rcfg)(rp,
                                                  tokens=jnp.asarray(toks))
        out["hidden"], out["aux"] = np.asarray(h), np.asarray(aux)
        logits, state = prefill(rp, tokens=jnp.asarray(toks))
        state = state._replace(pos=jnp.full((2,), 32, jnp.int32))
        greedy = [jnp.argmax(logits, -1).astype(jnp.int32)]
        for _ in range(4):
            logits, state = decode(rp, token=greedy[-1], state=state)
            greedy.append(jnp.argmax(logits, -1).astype(jnp.int32))
        out["greedy"] = np.stack([np.asarray(t) for t in greedy], axis=1)
        _RUNS[name] = out
    return _RUNS[name]


def _close_caches(got, want):
    for g, w in zip(got, want):
        if isinstance(g, dict):
            _close(g["k"], w["k"])
            _close(g["v"], w["v"])
        else:
            assert isinstance(g, tssm.SSMCache)
            _close(g.conv, w.conv)
            _close(g.state, w.state)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_reference(name):
    """lm_prefill's logits and caches (KV and SSM), three lm_decode_steps
    with per-slot cursors and the caches after them, and lm_hidden with
    the summed MoE aux."""
    _, tcfg, _, tp, _ = _weights(name)
    ref = _reference_run(name)
    toks = torch.from_numpy(ref["toks"]).long()
    got, state = tlm.lm_prefill(tp, tcfg, toks, max_len=40)
    _close(got, ref["prefill"])
    _close_caches(state.caches, ref["caches"])
    state = state._replace(pos=torch.tensor([32, 25], dtype=torch.int32))
    for tok, want in ref["steps"]:
        got, state = tlm.lm_decode_step(tp, tcfg, torch.from_numpy(tok),
                                        state)
        _close(got, want)
    _close_caches(state.caches, ref["last_caches"])
    h, aux, plen = tlm.lm_hidden(tp, tcfg, toks)
    assert plen == 0
    _close(h, ref["hidden"])
    _close(aux, ref["aux"])
    assert (float(aux) > 0) == (tcfg.moe is not None)


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_generate_matches_reference(name):
    _, tcfg, _, tp, _ = _weights(name)
    ref = _reference_run(name)
    got = tlm.greedy_generate(tp, tcfg, torch.from_numpy(ref["toks"]).long(),
                              steps=4, max_len=40)
    np.testing.assert_array_equal(got.numpy(), ref["greedy"])


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "llama4-scout-17b-a16e"])
def test_compute_dtype_weights_give_bit_identical_results(name):
    """`to_compute_dtype` rounds the attention, SSM, MLP, router and expert
    matrices once, and only those: bf16 prefill logits, caches and two
    decode steps equal those of the float32 weights bit for bit (one
    jamba superblock, the port's own float32 init)."""
    tcfg = dataclasses.replace(reduced(get_config(name), layers=8),
                               compute_dtype="bfloat16")
    tp = tlm.lm_init(tcfg, seed=2, device="cpu")
    cast = tlm.to_compute_dtype(tp, tcfg)
    for node in cast.stack:
        mix = node["mixer"]
        if isinstance(mix, tssm.SSMParams):
            for f in ("w_zx", "w_bc", "w_dt", "w_out"):
                assert getattr(mix, f).dtype == torch.bfloat16, f
            for f in ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
                      "norm"):
                assert getattr(mix, f).dtype == torch.float32, f
        if isinstance(node.get("mlp"), tmoe.MoEParams):
            moe = node["mlp"]
            assert {t.dtype for t in (moe.w_router, moe.w_in, moe.w_up,
                                      moe.w_out)} == {torch.bfloat16}
            if moe.shared is not None:
                assert moe.shared.w_out.dtype == torch.bfloat16
        assert node["pre_norm"]["scale"].dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, 512, (2, 20))).long()
    outs = []
    for p in (tp, cast):
        logits, state = tlm.lm_prefill(p, tcfg, toks, max_len=24)
        run = [logits, *(t for c in state.caches
                         for t in (c.values() if isinstance(c, dict) else c))]
        for _ in range(2):
            logits, state = tlm.lm_decode_step(
                p, tcfg, logits.argmax(-1).to(torch.int32), state)
            run.append(logits)
        outs.append(run)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_lm_init_in_the_compute_dtype():
    """`lm_init(dtype=...)`: the matrices come rounded, the float32 leaves
    stay float32, and `to_compute_dtype` then copies nothing."""
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")),
                              compute_dtype="bfloat16")
    p = tlm.lm_init(cfg, seed=1, device="cpu", dtype=cfg.dtype)
    assert p.embed.dtype == p.unembed.dtype == torch.bfloat16
    cast = tlm.to_compute_dtype(p, cfg)
    for a, b in zip(p.stack, cast.stack):
        for f in a["mixer"]._fields:
            x, y = getattr(a["mixer"], f), getattr(b["mixer"], f)
            assert x is y or x is None
    ssm = p.stack[0]["mixer"]
    assert ssm.w_zx.dtype == torch.bfloat16 and ssm.a_log.dtype == (
        torch.float32)
    moe = p.stack[1]["mlp"]
    assert isinstance(moe, tmoe.MoEParams) and moe.w_in.dtype == (
        torch.bfloat16)
    assert isinstance(p.stack[0]["mlp"], tmoe.MLPParams)
    assert "mlp" not in tlm.lm_init(
        reduced(get_config("mamba2-2.7b")), device="cpu").stack[0]
    logits, _ = tlm.lm_prefill(cast, cfg, torch.zeros(2, 8, dtype=torch.long),
                               max_len=8)
    assert torch.isfinite(logits).all()


# ------------------------------------------------------------------ bridge

@pytest.mark.parametrize("name", FAMILIES)
def test_bridge_round_trip(name):
    """params_from_jax -> params_to_numpy gives the numpy tree back, leaf
    for leaf, with the reference's layer fields; mixers and MLPs become
    the port's named tuples by their fields."""
    _, tcfg, rp, tp, tree = _weights(name)
    back = bridge.params_to_numpy(tp)

    def same(a, b):
        if a is None or b is None:
            assert a is None and b is None
        elif isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    same({k: tree[k] for k in ("embed", "stack", "final_norm", "unembed")},
         back)
    for pos, kind in enumerate(tcfg.superblock):
        mix = tp.stack[pos]["mixer"]
        assert isinstance(mix, tssm.SSMParams) == (kind == "ssm")
        mlp = tp.stack[pos].get("mlp")
        assert isinstance(mlp, tmoe.MoEParams) == tcfg.layer_uses_moe(
            pos, kind)
    assert tlm.lm_prefill(bridge.lm_params_from_jax(back, device="cpu"),
                          tcfg, torch.zeros(2, 4, dtype=torch.long),
                          max_len=4)[0].shape == (2, 512)


# ------------------------------------------------------------------ server

PROMPT_LENS = (7, 30, 19, 12, 25, 31, 9)


@pytest.mark.parametrize("name,mode", [("mamba2-2.7b", "continuous"),
                                       ("jamba-v0.1-52b", "wave"),
                                       ("olmoe-1b-7b", "continuous"),
                                       ("olmoe-1b-7b", "wave")])
def test_server_tokens_and_counters_match_reference(name, mode):
    """Seven prompts in waves of 4 (a wave's tokens fill whole MoE groups
    of 64), buckets (16, 32): the SSM and hybrid servers run in waves
    whatever was asked, as the reference's do."""
    rcfg, tcfg, rp, tp, _ = _weights(name)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in PROMPT_LENS]
    news = [int(rng.integers(2, 6)) for _ in PROMPT_LENS]
    kw = dict(buckets=(16, 32), max_len=40, batch_slots=4, mode=mode)
    ref = rserver.Server(rcfg, rserver.ServeConfig(**kw), params=rp)
    port = tserver.Server(tcfg, tserver.ServeConfig(**kw), params=tp,
                          device="cpu")
    assert port.sc.mode == ref.sc.mode == (
        "wave" if tcfg.sub_quadratic else mode)
    for server in (ref, port):
        for p, n in zip(prompts, news):
            server.submit(p, max_new_tokens=n)
    want = {r.uid: r.output for r in ref.run()}
    got = {r.uid: r.output for r in port.run()}
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    counters = ("requests", "compiled_blobs", "prefills", "decode_steps",
                "tokens_out")
    assert ({k: port.summary()[k] for k in counters}
            == {k: ref.summary()[k] for k in counters})
    assert port.compile_count <= len(kw["buckets"]) + 1


def test_ssm_serving_equals_greedy_generate():
    """Prompts of bucket length (the state integrates no padding): each
    served request's tokens are `greedy_generate`'s for its prompt."""
    _, tcfg, _, tp, _ = _weights("mamba2-2.7b")
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, 512, (4, 16)).astype(np.int32)
    server = tserver.Server(tcfg, tserver.ServeConfig(
        buckets=(16,), max_len=24, batch_slots=2), params=tp, device="cpu")
    for p in prompts:
        server.submit(p, max_new_tokens=5)
    done = {r.uid: r.output for r in server.run()}
    want = tlm.greedy_generate(tp, tcfg, torch.from_numpy(prompts).long(),
                               steps=4, max_len=24).numpy()
    for uid in range(4):
        np.testing.assert_array_equal(done[uid], want[uid])


def test_ssm_layer_pattern_serves():
    """A dense config switched to the "ssm" layer pattern, with an SSM
    config, now serves (in waves) instead of raising."""
    cfg = dataclasses.replace(
        reduced(get_config("smollm-135m")), layer_pattern="ssm",
        ssm=tconfig.SSMConfig(d_state=16, headdim=16, chunk=32))
    server = tserver.Server(cfg, tserver.ServeConfig(buckets=(8,),
                                                     max_len=12),
                            device="cpu")
    assert server.sc.mode == "wave"
    server.submit(np.arange(6), max_new_tokens=3)
    (req,) = server.run()
    assert req.output.shape == (3,) and req.output.max() < cfg.vocab_size
    assert isinstance(server.params.stack[0]["mixer"], tssm.SSMParams)


def test_only_vision_and_audio_stay_unported():
    """The vision and audio architectures are ported now too: the registry
    holds every reference architecture, and `UNPORTED` is gone."""
    assert set(ARCHS) == set(RARCHS)
    assert not hasattr(configs, "UNPORTED")
    for name in FAMILIES + ("phi-3-vision-4.2b", "whisper-base"):
        assert get_config(name) == ARCHS[name]


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_layerwise_comparison_reads_each_attention_layer(name, monkeypatch):
    """`compare_attention_paths` with a stand-in for the kernel that
    scales the plain attention by 1.01: each layer runs from the same
    input on both paths, so only attention layers differ (an SSM layer
    shows 0); the routes, the control's routes and the diffs are reported
    per layer. With the plain version itself every diff is 0 and every
    route agrees."""
    _, tcfg, _, tp, _ = _weights(name)
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, 512, (2, 32))).long()
    same = layerwise.compare_attention_paths(tp, tcfg, toks)
    assert [d.layer for d in same] == list(range(tcfg.num_layers))
    assert all(d.max_abs_diff == d.mixer_diff == 0
               and d.routes_agree == d.kept_agree == d.tokens == 64
               for d in same)

    def scaled(*args, **kw):
        return kref.flash_attention_ref(*args, **kw) * 1.01
    monkeypatch.setattr(kops, "flash_attention", scaled)
    diffs = layerwise.compare_attention_paths(tp, tcfg, toks)
    for d in diffs:
        assert (d.mixer_diff > 0) == d.kind.startswith("attn"), d
        assert (d.max_abs_diff > 0) == d.kind.startswith("attn"), d
        assert d.moe == tcfg.layer_uses_moe(d.layer % len(tcfg.superblock),
                                            d.kind)
        assert 0 <= d.kept_agree <= d.routes_agree <= d.tokens
        # in float32 the exact path is the plain one
        assert d.control_agree == d.tokens
