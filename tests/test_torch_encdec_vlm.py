"""PyTorch port, the encoder-decoder and vision-prefix LM families:
`repro_torch`'s `nn/encdec.py`, `nn/multimodal.py`, the cross-attention
branch of `nn/attention.py` and `nn/transformer.py`, the prefix and the
encoder in `nn/lm.py`, the bridge's encoder and cross fields, the server
for whisper-base and phi-3-vision-4.2b, and `flash_attention`'s plain
version at head dim 96 and over more keys than queries, against the
reference package on the same numpy inputs.

Weights: the reference's parameter tree (its shapes, from `jax.eval_shape`
of its `lm_init`) filled from numpy with a seed: matrices N(0, 1/fan_in),
the embedding N(0, 1), norm scales 1 + 0.2 N(0, 1), layernorm biases
0.1 N(0, 1). They reach the port through `bridge.lm_params_from_jax`. The
stub patch and frame embeddings are numpy draws too, fed to both packages
(the port's stubs draw from a `torch.Generator`, the reference's from
`jax.random`).

Sizes: the reference's `reduced()` configs (2 decoder layers, d_model 128,
4 query heads over 2 KV heads of 32, vocab 512, float32; whisper with a
2-layer encoder over 64 frames, phi-3-vision with 16 patches).

Tolerance: rtol = atol = 1e-4, the LM bar (`PERF.md` §2), for hidden
states, logits, caches and cross K/V; `flash_attention_ref` alone at
rtol = atol = 2e-5; greedy tokens, positions and the server's counters
equal.
"""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS
from repro.configs import reduced as rreduced
from repro.kernels import ref as rref
from repro.nn import attention as rattn
from repro.nn import encdec as rencdec
from repro.nn import lm as rlm
from repro.nn import multimodal as rmm
from repro.nn.common import Param
from repro.runtime import server as rserver
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.nn import attention as tattn
from repro_torch.nn import encdec as tencdec
from repro_torch.nn import lm as tlm
from repro_torch.nn import multimodal as tmm
from repro_torch.nn import transformer as ttfm
from repro_torch.runtime import server as tserver

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
WHISPER, PHI3V = "whisper-base", "phi-3-vision-4.2b"
ARCH_NAMES = (WHISPER, PHI3V)


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _is_param(x):
    return isinstance(x, Param)


def _key_name(k):
    return getattr(k, "name", getattr(k, "key", None))


def _leaf(rng, name, shape):
    """One numpy leaf by the reference's field name; stacked leaves carry
    the leading num_superblocks axis."""
    if name in ("scale", "q_norm", "k_norm"):
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    if name == "bias":
        return _arr(rng, *shape, scale=0.1)
    if name == "embed":
        return _arr(rng, *shape)
    fan_in = shape[-2] if name == "unembed" else shape[1]
    return _arr(rng, *shape, scale=fan_in ** -0.5)


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


def _weights(name, seed=0):
    """(reference config, port config, reference params, port params on
    the CPU, numpy tree) of the reduced `name`."""
    if (name, seed) not in _WEIGHTS:
        rcfg, tcfg = rreduced(RARCHS[name]), reduced(get_config(name))
        shapes = jax.eval_shape(
            lambda: rlm.lm_init(jax.random.PRNGKey(0), rcfg))
        leaves, _ = jax.tree_util.tree_flatten_with_path(shapes,
                                                         is_leaf=_is_param)
        rng = np.random.default_rng(seed)
        vals = []
        for path, p in leaves:
            leaf = _key_name(path[-1])
            if leaf == "value":
                leaf = _key_name(path[-2])
            vals.append(Param(jnp.asarray(_leaf(rng, leaf, p.value.shape)),
                              p.axes))
        rparams = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(shapes, is_leaf=_is_param), vals)
        tree = _numpy_tree(rparams)
        _WEIGHTS[(name, seed)] = (rcfg, tcfg, rparams,
                                  bridge.lm_params_from_jax(tree,
                                                            device="cpu"),
                                  tree)
    return _WEIGHTS[(name, seed)]


def _stubs(cfg, b, seed=5):
    """numpy stub embeddings for `cfg`: {"prefix_embeds": patches} or
    {"enc_embeds": frames}."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision_stub":
        return {"prefix_embeds": _arr(rng, b, cfg.num_patches, cfg.d_model,
                                      scale=cfg.d_model ** -0.5)}
    return {"enc_embeds": _arr(rng, b, cfg.encoder.frames, cfg.d_model,
                               scale=cfg.d_model ** -0.5)}


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


# ----------------------------------------------------------------- configs

def test_published_dimensions():
    w, p = get_config(WHISPER), get_config(PHI3V)
    assert (w.num_layers, w.d_model, w.num_heads, w.num_kv_heads, w.head_dim_,
            w.d_ff, w.vocab_size) == (6, 512, 8, 8, 64, 2048, 51865)
    assert (w.encoder.num_layers, w.encoder.frames) == (6, 1500)
    assert (w.norm, w.act, w.gated_mlp, w.tie_embeddings, w.frontend) == (
        "layernorm", "gelu", False, True, "audio_stub")
    assert w.is_encdec and not p.is_encdec
    assert (p.num_layers, p.d_model, p.num_heads, p.num_kv_heads, p.head_dim_,
            p.d_ff, p.vocab_size, p.num_patches) == (32, 3072, 32, 32, 96,
                                                     8192, 32064, 1024)
    assert (p.frontend, p.tie_embeddings, p.gated_mlp) == ("vision_stub",
                                                            False, True)
    # the backbone sizes the card serves: about 71 M and 3.8 B parameters
    assert round(w.param_count() / 1e6) == 71
    assert round(p.param_count() / 1e9, 1) == 3.8


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_match_reference(name):
    """Every field the port keeps equals the reference's, full and
    reduced; the registry holds every reference architecture."""
    assert set(ARCHS) == set(RARCHS)
    for t, r in ((get_config(name), RARCHS[name]),
                 (reduced(get_config(name)), rreduced(RARCHS[name]))):
        rd = dataclasses.asdict(r)
        for k, v in dataclasses.asdict(t).items():
            assert v == rd[k], k
        assert t.param_count() == r.param_count()
        assert (t.is_encdec, t.superblock) == (r.is_encdec, r.superblock)


def test_reduced_encoder():
    cfg = reduced(get_config(WHISPER))
    assert (cfg.encoder.num_layers, cfg.encoder.frames) == (2, 64)
    ecfg = tencdec.encoder_cfg(cfg)
    assert (ecfg.num_layers, ecfg.superblock, ecfg.encoder, ecfg.moe) == (
        2, ("attn",), None, None)


# ---------------------------------------------------------------- encoder

def test_encoder_forward_matches_reference():
    rcfg, tcfg, rp, tp, _ = _weights(WHISPER)
    frames = _stubs(tcfg, 2)["enc_embeds"]
    want = _jit(rencdec.encoder_forward, cfg=rcfg)(rp.encoder,
                                                   frame_embeds=frames)
    got = tencdec.encoder_forward(tp.encoder, tcfg, _t(frames))
    _close(got, want)


def test_cross_kv_matches_reference():
    rcfg, tcfg, rp, tp, _ = _weights(WHISPER)
    enc = _arr(np.random.default_rng(6), 2, 64, 128)
    wk, wv = _jit(rencdec.cross_kv, cfg=rcfg)(rp.stack, enc_out=enc)
    gk, gv = tencdec.cross_kv(tp.stack, tcfg, _t(enc))
    assert gk.shape == (tcfg.num_superblocks, 2, 64, tcfg.num_kv_heads,
                        tcfg.head_dim_) and gk.is_contiguous()
    _close(gk, wk)
    _close(gv, wv)


def _cross_layer(blk=1):
    rcfg, tcfg, rp, tp, _ = _weights(WHISPER)
    rlayer = jax.tree_util.tree_map(lambda p: Param(p.value[blk], p.axes[1:]),
                                    rp.stack, is_leaf=_is_param)[0]
    return rcfg, tcfg, rlayer["cross"], ttfm.slice_block(tp.stack,
                                                         blk)[0]["cross"]


@pytest.mark.parametrize("sq", [8, 33])
def test_cross_attention_forward_matches_reference(sq):
    """attn_forward's cross branch: q projection, no rope, non-causal
    attention over 64 encoder positions, through `kops.flash_attention`
    (its plain version on the CPU)."""
    rcfg, tcfg, rx, tx = _cross_layer()
    rng = np.random.default_rng(7)
    x = _arr(rng, 2, sq, 128)
    k, v = _arr(rng, 2, 64, 2, 32), _arr(rng, 2, 64, 2, 32)
    pos = jnp.arange(sq)
    want = _jit(rattn.attn_forward, cfg=rcfg, kind="attn")(
        rx, x=jnp.asarray(x), positions=pos,
        cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    seen = []

    def spy(*args, **kw):
        seen.append(kw)
        return kref.flash_attention_ref(*args, **kw)
    got, gk, gv = tattn.attn_forward(tx, tcfg, _t(x), kind="attn",
                                     positions=torch.arange(sq),
                                     attention=spy, cross_kv=(_t(k), _t(v)))
    _close(got, want)
    assert seen == [{"causal": False}]
    assert torch.equal(gk, _t(k)) and torch.equal(gv, _t(v))


def test_cross_attention_decode_matches_reference():
    rcfg, tcfg, rx, tx = _cross_layer()
    rng = np.random.default_rng(8)
    x = _arr(rng, 2, 1, 128)
    k, v = _arr(rng, 2, 64, 2, 32), _arr(rng, 2, 64, 2, 32)
    want, _, _ = _jit(rattn.attn_decode, cfg=rcfg, kind="attn", cross=True)(
        rx, x=jnp.asarray(x), k_cache=jnp.asarray(k),
        v_cache=jnp.asarray(v), pos=jnp.asarray(3, jnp.int32))
    tk, tv = _t(k), _t(v)
    got, gk, gv = tattn.attn_decode(tx, tcfg, _t(x), tk, tv,
                                    torch.tensor(3, dtype=torch.int32),
                                    kind="attn", cross=True)
    _close(got, want)
    assert gk is tk and gv is tv and torch.equal(tk, _t(k))


# ------------------------------------------------------------ whole model

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_lm_hidden_matches_reference(name):
    """lm_hidden with the prefix (phi-3-vision: hidden over P + S
    positions, prefix_len P) and with frames (whisper)."""
    rcfg, tcfg, rp, tp, _ = _weights(name)
    toks = np.random.default_rng(9).integers(0, 512, (2, 24)).astype(
        np.int32)
    kw = _stubs(tcfg, 2)
    h, aux, plen = _jit(rlm.lm_hidden, cfg=rcfg)(rp, tokens=toks, **_j(kw))
    got, gaux, gplen = tlm.lm_hidden(tp, tcfg, _t(toks).long(),
                                     **{k: _t(v) for k, v in kw.items()})
    assert gplen == plen == (16 if name == PHI3V else 0)
    assert got.shape == (2, 24 + gplen, 128)
    _close(got, h)
    assert float(gaux) == float(aux) == 0.0


_RUNS = {}


def _reference_run(name):
    """The reference's prefill (B 2, S 24, max_len P + 32) with the stubs,
    three decode steps, and a greedy loop of five tokens, run once per
    arch."""
    if name not in _RUNS:
        rcfg, tcfg, rp, _, _ = _weights(name)
        toks = np.random.default_rng(10).integers(0, 512, (2, 24)).astype(
            np.int32)
        kw = _stubs(tcfg, 2)
        max_len = 24 + 8 + (tcfg.num_patches if name == PHI3V else 0)
        prefill = _jit(rlm.lm_prefill, cfg=rcfg, max_len=max_len)
        decode = _jit(rlm.lm_decode_step, cfg=rcfg)
        logits, state = prefill(rp, tokens=toks, **_j(kw))
        out = {"toks": toks, "kw": kw, "max_len": max_len,
               "prefill": np.asarray(logits), "pos": int(state.pos),
               "caches": jax.tree_util.tree_map(np.asarray, state.caches),
               "enc_kv": (None if state.enc_kv is None else
                          tuple(np.asarray(t) for t in state.enc_kv))}
        greedy = [np.asarray(jnp.argmax(logits, -1)).astype(np.int32)]
        steps = []
        for _ in range(4):
            logits, state = decode(rp, token=jnp.asarray(greedy[-1]),
                                   state=state)
            steps.append(np.asarray(logits))
            greedy.append(np.asarray(jnp.argmax(logits, -1)).astype(
                np.int32))
        out["steps"], out["greedy"] = steps, np.stack(greedy, axis=1)
        out["last_caches"] = jax.tree_util.tree_map(np.asarray, state.caches)
        out["last_pos"] = int(state.pos)
        _RUNS[name] = out
    return _RUNS[name]


def _close_caches(got, want):
    for g, w in zip(got, want):
        _close(g["k"], w["k"])
        _close(g["v"], w["v"])


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_reference(name):
    """lm_prefill with patches or frames: logits, KV caches, pos = P + S,
    the cross K/V it carries; four greedy lm_decode_steps: logits, tokens,
    the caches after them and the position."""
    _, tcfg, _, tp, _ = _weights(name)
    ref = _reference_run(name)
    kw = {k: _t(v) for k, v in ref["kw"].items()}
    got, state = tlm.lm_prefill(tp, tcfg, _t(ref["toks"]).long(),
                                max_len=ref["max_len"], **kw)
    _close(got, ref["prefill"])
    _close_caches(state.caches, ref["caches"])
    assert int(state.pos) == ref["pos"] == 24 + (16 if name == PHI3V else 0)
    if name == WHISPER:
        for g, w in zip(state.enc_kv, ref["enc_kv"]):
            _close(g, w)
    else:
        assert state.enc_kv is None and ref["enc_kv"] is None
    toks = [got.argmax(-1).to(torch.int32)]
    for want in ref["steps"]:
        got, state = tlm.lm_decode_step(tp, tcfg, toks[-1], state)
        _close(got, want)
        toks.append(got.argmax(-1).to(torch.int32))
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                  ref["greedy"])
    _close_caches(state.caches, ref["last_caches"])
    assert int(state.pos) == ref["last_pos"]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_decode_matches_forward(name):
    """The reference's own property (`tests/test_archs_smoke.py`) on the
    port: a decode step after a prefill of S - 1 tokens gives the full
    forward's last logits, the cache covering the prefix too."""
    _, tcfg, _, tp, _ = _weights(name)
    b, s = 2, 32
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (b, s))).long()
    kw = {k: _t(v) for k, v in _stubs(tcfg, b).items()}
    h, _, plen = tlm.lm_hidden(tp, tcfg, tok, **kw)
    full = tlm.hidden_to_logits(tp, tcfg, h[:, -1])
    _, state = tlm.lm_prefill(tp, tcfg, tok[:, :s - 1],
                              max_len=s + plen + 8, **kw)
    dec, _ = tlm.lm_decode_step(tp, tcfg, tok[:, s - 1], state)
    torch.testing.assert_close(dec, full, **TOL)


def test_whisper_needs_its_frames():
    """Without frames a cross layer has no K and V: the port raises (the
    reference runs the layer as causal self-attention in a prefill and
    fails at decode)."""
    _, tcfg, _, tp, _ = _weights(WHISPER)
    toks = torch.zeros(2, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="enc_embeds"):
        tlm.lm_hidden(tp, tcfg, toks)
    with pytest.raises(ValueError, match="enc_embeds"):
        tlm.lm_prefill(tp, tcfg, toks, max_len=8)
    kw = {k: _t(v) for k, v in _stubs(tcfg, 2).items()}
    _, state = tlm.lm_prefill(tp, tcfg, toks, max_len=12, **kw)
    with pytest.raises(ValueError, match="enc_kv"):
        tlm.lm_decode_step(tp, tcfg, toks[:, 0], state._replace(enc_kv=None))


def test_encoder_and_cross_go_through_the_kernel_wrapper(monkeypatch):
    """A whisper prefill calls `kops.flash_attention` once per encoder,
    decoder and cross layer (2 + 2 + 2 here): non-causal over the frames
    in the encoder and the cross layers, causal in the decoder."""
    _, tcfg, _, tp, _ = _weights(WHISPER)
    calls = []

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal", True)))
        return kref.flash_attention_ref(q, k, v, **kw)
    monkeypatch.setattr(kops, "flash_attention", counting)
    kw = {k: _t(v) for k, v in _stubs(tcfg, 2).items()}
    tlm.lm_prefill(tp, tcfg, torch.zeros(2, 16, dtype=torch.long),
                   max_len=20, **kw)
    assert sorted(calls) == sorted([(64, 64, False)] * 2
                                   + [(16, 16, True)] * 2
                                   + [(16, 64, False)] * 2)


def test_compute_dtype_rounds_cross_and_encoder():
    """`to_compute_dtype` rounds the cross projections and the encoder's
    matrices too: a bf16 whisper prefill and decode step on the rounded
    weights equal those of the float32 weights bit for bit."""
    tcfg = dataclasses.replace(reduced(get_config(WHISPER)),
                               compute_dtype="bfloat16")
    tp = tlm.lm_init(tcfg, seed=2, device="cpu")
    cast = tlm.to_compute_dtype(tp, tcfg)
    for node in cast.stack + cast.encoder["stack"]:
        assert {t.dtype for t in node["mixer"][:4]} == {torch.bfloat16}
        assert node["pre_norm"]["bias"].dtype == torch.float32
    assert {t.dtype for t in cast.stack[0]["cross"][:4]} == {torch.bfloat16}
    assert "cross" not in cast.encoder["stack"][0]
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, 512, (2, 12))).long()
    frames = tmm.audio_frame_embeddings(tcfg, 2, 64, device="cpu")
    outs = []
    for p in (tp, cast):
        logits, state = tlm.lm_prefill(p, tcfg, toks, max_len=16,
                                       enc_embeds=frames)
        step, _ = tlm.lm_decode_step(p, tcfg, logits.argmax(-1), state)
        outs.append((logits, *state.enc_kv, step))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_lm_init_draws_encoder_and_cross():
    cfg = reduced(get_config(WHISPER))
    p = tlm.lm_init(cfg, seed=1, device="cpu")
    nsb, d = cfg.num_superblocks, cfg.d_model
    assert p.stack[0]["cross"].wq.shape == (nsb, d, 4, 32)
    assert set(p.stack[0]) == {"pre_norm", "mixer", "pre_cross_norm",
                               "cross", "pre_mlp_norm", "mlp"}
    assert p.encoder["stack"][0]["mixer"].wk.shape == (2, d, 2, 32)
    assert set(p.encoder["final_norm"]) == {"scale", "bias"}
    assert tlm.lm_init(reduced(get_config(PHI3V)), device="cpu").encoder is None


# ---------------------------------------------------------------- bridge

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_bridge_round_trip(name):
    """lm_params_from_jax -> params_to_numpy gives the numpy tree back,
    leaf for leaf, with `pre_cross_norm`, `cross` and the `encoder`
    subtree for whisper."""
    _, tcfg, _, tp, tree = _weights(name)
    back = bridge.params_to_numpy(tp)
    keys = ("embed", "stack", "final_norm", "unembed") + (
        ("encoder",) if name == WHISPER else ())
    assert set(back) == set(keys)

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
    same({k: tree[k] for k in keys}, back)
    if name == WHISPER:
        assert isinstance(tp.stack[0]["cross"], tattn.AttnParams)
        assert set(back["encoder"]) == {"stack", "final_norm"}
    again = bridge.lm_params_from_jax(back, device="cpu")
    kw = {k: _t(v) for k, v in _stubs(tcfg, 2).items()}
    a, _ = tlm.lm_prefill(again, tcfg, torch.zeros(2, 4, dtype=torch.long),
                          max_len=24, **kw)
    b, _ = tlm.lm_prefill(tp, tcfg, torch.zeros(2, 4, dtype=torch.long),
                          max_len=24, **kw)
    assert torch.equal(a, b)


# ------------------------------------------------------------------ stubs

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stubs_shapes_dtypes_and_scale(dtype):
    """(B, num_patches, d) and (B, frames, d) in the compute dtype, unit
    normal over sqrt(d); seeded (frames from seed + 1, as the
    reference's), and the same shapes as the reference's stubs."""
    cfg = dataclasses.replace(reduced(get_config(PHI3V)),
                              compute_dtype=dtype)
    x = tmm.vision_patch_embeddings(cfg, 3, seed=4, device="cpu")
    y = tmm.audio_frame_embeddings(cfg, 2, 40, seed=4, device="cpu")
    rcfg = dataclasses.replace(rreduced(RARCHS[PHI3V]), compute_dtype=dtype)
    assert x.shape == tuple(rmm.vision_patch_embeddings(rcfg, 3).shape) == (
        3, 16, 128)
    assert y.shape == tuple(rmm.audio_frame_embeddings(rcfg, 2, 40).shape)
    assert x.dtype == y.dtype == cfg.dtype
    for t in (x, y):
        std = float(t.float().std() * cfg.d_model ** 0.5)
        assert 0.9 < std < 1.1 and abs(float(t.float().mean())) < 0.02
    assert torch.equal(x, tmm.vision_patch_embeddings(cfg, 3, seed=4,
                                                      device="cpu"))
    assert not torch.equal(x, tmm.vision_patch_embeddings(cfg, 3, seed=5,
                                                          device="cpu"))
    # frames draw from seed + 1: the patches of seed 5 lead the frames of 4
    z = tmm.audio_frame_embeddings(cfg, 3, 16, seed=4, device="cpu")
    assert torch.equal(z, tmm.vision_patch_embeddings(cfg, 3, seed=5,
                                                      device="cpu"))


# ------------------------------------------------------------------ server

def test_vlm_server_matches_reference():
    """phi-3-vision served on its text backbone, without patches, as the
    reference's server serves it: seven prompts in waves of 4, buckets
    (16, 32); tokens and counters equal."""
    rcfg, tcfg, rp, tp, _ = _weights(PHI3V)
    rng = np.random.default_rng(11)
    lens = (7, 30, 19, 12, 25, 31, 9)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    news = [int(rng.integers(2, 6)) for _ in lens]
    kw = dict(buckets=(16, 32), max_len=40, batch_slots=4)
    ref = rserver.Server(rcfg, rserver.ServeConfig(**kw), params=rp)
    port = tserver.Server(tcfg, tserver.ServeConfig(**kw), params=tp,
                          device="cpu")
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


def test_whisper_server_refuses():
    """The Server takes no frames, so it refuses an encoder-decoder (the
    reference's fails at its first decode step instead)."""
    cfg = reduced(get_config(WHISPER))
    with pytest.raises(ValueError, match="encoder-decoder"):
        tserver.Server(cfg, tserver.ServeConfig(), device="cpu")


def _serve(arch):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--requests", "3", "--max-new",
         "3"], capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_serve_launcher():
    """`python -m repro_torch.launch.serve --arch phi-3-vision-4.2b
    --reduced --device cpu` serves; `--arch whisper-base` raises the
    Server's error."""
    ok = _serve(PHI3V)
    assert ok.returncode == 0, ok.stderr
    assert '"requests": 3' in ok.stdout and '"tokens_out": 9' in ok.stdout
    bad = _serve(WHISPER)
    assert bad.returncode != 0 and "encoder-decoder" in bad.stderr


# --------------------------------------------------------- flash (plain)

FLASH_CASES = {
    # (B, Sq, Skv, H, KV, D, causal)
    "d96_causal": (2, 40, 40, 4, 4, 96, True),
    "d96_gqa_ragged": (1, 65, 65, 4, 2, 96, True),
    "d96_noncausal_65x129": (2, 65, 129, 4, 2, 96, False),
    "cross_24x100": (2, 24, 100, 4, 4, 64, False),
    "encoder_bidir_100": (1, 100, 100, 2, 2, 64, False),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_ref_matches_reference(case):
    """The plain version (the wrapper's CPU path) at head dim 96 and over
    more keys than queries, non-causal, against the reference's oracle."""
    b, sq, skv, h, kv, d, causal = FLASH_CASES[case]
    rng = np.random.default_rng(13)
    q, k, v = (_arr(rng, b, sq, h, d), _arr(rng, b, skv, kv, d),
               _arr(rng, b, skv, kv, d))
    want = rref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    got = kops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    _close(got, want, FLASH_TOL)
