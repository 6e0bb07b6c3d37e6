"""PyTorch port, the LM slice: `repro_torch`'s dense-family serving path
(`nn/common.py`, `nn/mlp.py`, `nn/attention.py`, `nn/transformer.py`,
`nn/lm.py`, `runtime/server.py`) and the plain version of the
`flash_attention` kernel against the reference package on the same numpy
inputs. Weights are the reference's `lm_init` draws, their norm scales
perturbed in numpy so that every scale matters, and reach the port through
`bridge.lm_params_from_jax`. The reference's `flash_attention` runs as its
Pallas kernel in interpret mode and as its `ref` twin (`kernel_mode`).
The CUDA kernel itself is checked on a card by `test_torch_cuda.py`.

Sizes: the reference's `reduced()` configs (2 layers, d_model 128, 4 or 2
query heads of 32, vocab 512, float32), prompts of 7-72 tokens.

Tolerance:
  * fp32, rtol=atol=1e-4: XLA's and ATen's CPU dots sum in other orders,
    and the port's prefill attention scales the float32 scores where the
    reference's `chunked_attention` scales q first (at head_dim 32 the
    scale is not a power of two); over two layers and a 512-wide vocab
    product that stays below 1e-4.
  * `flash_attention` alone, fp32: rtol=atol=2e-5.
  * one bf16 layer: the largest difference at most 2e-2 of the largest
    |output| (0.7e-2 measured): PyTorch rounds every bf16 operation, XLA's
    CPU compiler fuses elementwise chains in float32 and rounds once, so
    the two differ by a few bf16 steps (2^-8 each).
  * greedy tokens and the server's counters: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS
from repro.configs import reduced as rreduced
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.nn import attention as rattn
from repro.nn import common as rcommon
from repro.nn import lm as rlm
from repro.nn import mlp as rmlp
from repro.nn import transformer as rtfm
from repro.nn.common import Param
from repro.runtime import server as rserver
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops as tops
from repro_torch.nn import attention as tattn
from repro_torch.nn import common as tcommon
from repro_torch.nn import config as tconfig
from repro_torch.nn import lm as tlm
from repro_torch.nn import mlp as tmlp
from repro_torch.nn import transformer as ttfm
from repro_torch.runtime import server as tserver

TOL = dict(rtol=1e-4, atol=1e-4)
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_BAR = 2e-2
DENSE = ("smollm-135m", "qwen3-4b", "gemma2-27b", "chatglm3-6b")


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(params=["interpret", "ref"])
def kernel_mode(request, monkeypatch):
    """The reference's kernel routing: its Pallas grid in interpret mode
    (conftest's default), or its jnp twin."""
    if request.param == "ref":
        monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    else:
        monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)
        monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    return request.param


# --------------------------------------------------------------- weights

def _is_param(x):
    return isinstance(x, Param)


def _numpy_tree(node):
    """The reference's LMParams with numpy leaves: each Param's value,
    named tuples as dicts, None kept."""
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


def _weights(name, seed=0, dtype="float32"):
    """(reduced config for both packages, reference params, port params on
    the CPU): the reference's init, every all-ones scale replaced by
    1 + 0.2 N(0, 1) from numpy."""
    key = (name, seed, dtype)
    if key not in _WEIGHTS:
        rcfg = dataclasses.replace(rreduced(RARCHS[name]),
                                   compute_dtype=dtype)
        tcfg = dataclasses.replace(reduced(get_config(name)),
                                   compute_dtype=dtype)
        rng = np.random.default_rng(seed)
        leaves, treedef = jax.tree_util.tree_flatten(
            rlm.lm_init(jax.random.PRNGKey(seed), rcfg), is_leaf=_is_param)
        new = []
        for p in leaves:
            v = np.asarray(p.value)
            if np.all(v == 1.0):
                v = (1.0 + 0.2 * rng.standard_normal(v.shape)
                     ).astype(np.float32)
            new.append(Param(jnp.asarray(v), p.axes))
        rparams = treedef.unflatten(new)
        tparams = bridge.lm_params_from_jax(_numpy_tree(rparams),
                                            device="cpu")
        _WEIGHTS[key] = (rcfg, tcfg, rparams, tparams)
    return _WEIGHTS[key]


def _layer(params, blk, pos):
    """One layer's reference params (Param leaves) at superblock `blk`."""
    return rtfm.slice_block(params.stack, blk)[pos]


def test_bridge_keeps_the_stacked_layout():
    rcfg, tcfg, rp, tp = _weights("gemma2-27b")
    assert len(tp.stack) == len(rcfg.superblock) == 2
    np.testing.assert_array_equal(
        tp.stack[1]["mixer"].wq.numpy(),
        np.asarray(rp.stack[1]["mixer"].wq.value))
    assert tp.stack[0]["mixer"].wq.shape[0] == rcfg.num_superblocks
    assert tp.stack[0]["mixer"].q_norm is None
    assert set(tp.stack[0]) == set(rp.stack[0])
    _, _, rp, tp = _weights("chatglm3-6b")
    np.testing.assert_array_equal(tp.unembed.numpy(),
                                  np.asarray(rp.unembed.value))


# ------------------------------------------------------ flash_attention

FLASH_CASES = {
    # name: (B, Sq, Skv, H, KV, D, causal, window, softcap, q_offset)
    "causal_gqa3": (2, 64, 64, 6, 2, 32, True, None, None, 0),
    "noncausal_mha": (1, 48, 48, 4, 4, 32, False, None, None, 0),
    "window_softcap_gqa4": (1, 96, 96, 8, 2, 32, True, 24, 5.0, 0),
    "q_offset_gqa4": (2, 32, 96, 4, 1, 64, True, None, None, 64),
    "ragged_200": (1, 200, 200, 3, 1, 32, True, None, None, 0),
    # rows from q position 111 on can reach no key: compared in ref mode
    "window_past_keys": (1, 32, 96, 4, 2, 32, True, 16, None, 100),
    # the full-width head layouts served on the card: chatglm3's group of
    # 16 (32/2) and Llama-4-Scout's group of 5 (40/8) at head dim 128, and
    # gemma2's heads (32/16) with a window that masks keys and softcap 50
    "chatglm3_32_2_d128_s65": (1, 65, 65, 32, 2, 128, True, None, None, 0),
    "chatglm3_32_2_d128_s129": (1, 129, 129, 32, 2, 128, True, None, None,
                                0),
    "llama4_40_8_d128_s65": (1, 65, 65, 40, 8, 128, True, None, None, 0),
    "llama4_40_8_d128_s129": (1, 129, 129, 40, 8, 128, True, None, None, 0),
    "gemma2_window_softcap50_d128": (1, 129, 129, 32, 16, 128, True, 48,
                                     50.0, 0),
}
# the TPU kernel's tiles where S is no multiple of min(128, S) and not 200
FLASH_TILES = {"chatglm3_32_2_d128_s129": 43, "llama4_40_8_d128_s129": 43,
               "gemma2_window_softcap50_d128": 43}


def _flash_inputs(case, seed=0):
    b, sq, skv, h, kv, d = FLASH_CASES[case][:6]
    rng = np.random.default_rng(seed)
    return (_arr(rng, b, sq, h, d), _arr(rng, b, skv, kv, d),
            _arr(rng, b, skv, kv, d))


def _reachable_rows(sq, skv, causal, window, q_offset):
    qpos = np.arange(sq) + q_offset
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    return lo <= hi


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_plain_matches_reference(kernel_mode, case):
    _, sq, skv, _, _, _, causal, window, cap, off = FLASH_CASES[case]
    q, k, v = _flash_inputs(case)
    opts = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **opts).numpy()
    rows = np.ones(sq, bool)
    if kernel_mode == "ref":
        want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **opts)
    else:
        # the TPU kernel asserts tile multiples: 40-row tiles for S = 200;
        # it averages the keys of the blocks it visits for a row that no
        # key may reach, so those rows are compared in ref mode only
        tile = FLASH_TILES.get(case, 40)
        tiles = dict(bq=tile, bk=tile) if sq % min(128, sq) else {}
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         interpret=True, **tiles, **opts)
        rows = _reachable_rows(sq, skv, causal, window, off)
    np.testing.assert_allclose(got[:, rows], np.asarray(want)[:, rows],
                               **FLASH_TOL)


def test_flash_attention_unreachable_rows_average_every_key():
    _, sq, skv, h, kv, _, causal, window, cap, off = FLASH_CASES[
        "window_past_keys"]
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs("window_past_keys"))
    out = fa_mod.flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=off)
    rows = _reachable_rows(sq, skv, causal, window, off)
    assert rows.any() and not rows.all()
    uniform = v.mean(dim=1).repeat_interleave(h // kv, dim=1)  # (B, H, D)
    torch.testing.assert_close(
        out[:, ~rows], uniform[:, None].expand(-1, int((~rows).sum()), -1,
                                               -1), **FLASH_TOL)


def test_flash_attention_wrapper_checks_operands():
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs("causal_gqa3"))
    before = fa_mod.LAUNCHES
    for bad in (dict(window=0), dict(softcap=0.0), dict(q_offset=-1)):
        with pytest.raises(ValueError):
            fa_mod.flash_attention(q, k, v, **bad)
    with pytest.raises(ValueError, match="H % KV"):
        fa_mod.flash_attention(q[:, :, :5], k, v)
    with pytest.raises(ValueError, match="Skv"):
        fa_mod.flash_attention(q, k[:, :0], v[:, :0])
    assert fa_mod.LAUNCHES == before          # the CPU runs the plain version
    assert tops.flash_attention is fa_mod.flash_attention


# ------------------------------------------------------ building blocks

@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm_matches_reference(zero_centered):
    rng = np.random.default_rng(1)
    x, g = _arr(rng, 2, 5, 64, scale=3.0), _arr(rng, 64)
    want = rcommon.rms_norm(jnp.asarray(x), jnp.asarray(g),
                            zero_centered=zero_centered)
    got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(g),
                           zero_centered=zero_centered)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(2)
    x, g, b = _arr(rng, 3, 64, scale=2.0), _arr(rng, 64), _arr(rng, 64)
    want = rcommon.layer_norm(*(jnp.asarray(a) for a in (x, g, b)))
    got = tcommon.layer_norm(*(torch.from_numpy(a) for a in (x, g, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("per_slot", [False, True])
def test_apply_rope_matches_reference(fraction, per_slot):
    rng = np.random.default_rng(3)
    x = _arr(rng, 3, 6, 4, 32)
    pos = (rng.integers(0, 500, (3, 6)) if per_slot
           else np.arange(6) + 17).astype(np.int32)
    want = rcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              theta=10000.0, fraction=fraction)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta=10000.0, fraction=fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh", "relu"])
def test_activations_match_reference(act):
    x = _arr(np.random.default_rng(4), 256, scale=3.0)
    np.testing.assert_allclose(
        tcommon.activation(act)(torch.from_numpy(x)).numpy(),
        np.asarray(rcommon.activation(act)(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("name,gated", [("smollm-135m", True),
                                        ("gemma2-27b", True),
                                        ("smollm-135m", False)])
def test_mlp_forward_matches_reference(name, gated):
    rng = np.random.default_rng(5)
    rcfg = dataclasses.replace(rreduced(RARCHS[name]), gated_mlp=gated,
                               act="gelu" if not gated else
                               RARCHS[name].act)
    tcfg = dataclasses.replace(reduced(get_config(name)), gated_mlp=gated,
                               act=rcfg.act)
    w = {"w_in": _arr(rng, 128, 256, scale=0.1),
         "w_up": _arr(rng, 128, 256, scale=0.1) if gated else None,
         "w_out": _arr(rng, 256, 128, scale=0.1)}
    x = _arr(rng, 2, 5, 128)
    rp = rmlp.MLPParams(**{k: None if a is None else Param(jnp.asarray(a),
                                                           ())
                           for k, a in w.items()})
    tp = tmlp.MLPParams(**{k: None if a is None else torch.from_numpy(a)
                           for k, a in w.items()})
    np.testing.assert_allclose(
        tmlp.mlp_forward(tp, tcfg, torch.from_numpy(x)).numpy(),
        np.asarray(rmlp.mlp_forward(rp, rcfg, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("name,pos", [(n, 0) for n in DENSE]
                         + [("gemma2-27b", 1)])
def test_attn_forward_matches_reference(name, pos):
    """Prefill attention of one layer, and the rope'd k, v it returns for
    the caches against the reference's `attn_prefill_kv`; gemma2's
    position 0 is its local (window 64) layer, so S = 72 masks keys on
    both sides."""
    rcfg, tcfg, rp, tp = _weights(name)
    x = _arr(np.random.default_rng(6), 2, 72, 128)
    kind = rcfg.superblock[pos]
    positions = np.arange(72)
    rmix = _layer(rp, 1, pos)["mixer"]
    want = rattn.attn_forward(rmix, rcfg, jnp.asarray(x), kind=kind,
                              positions=jnp.asarray(positions))
    want_k, want_v = rattn.attn_prefill_kv(rmix, rcfg, jnp.asarray(x),
                                           jnp.asarray(positions))
    got, k, v = tattn.attn_forward(
        ttfm.slice_block(tp.stack, 1)[pos]["mixer"], tcfg,
        torch.from_numpy(x), kind=kind,
        positions=torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(want_k), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), **TOL)


@pytest.mark.parametrize("name", DENSE)
def test_attn_decode_per_slot_matches_reference(name):
    rcfg, tcfg, rp, tp = _weights(name)
    rng = np.random.default_rng(7)
    kind = rcfg.superblock[0]
    x = _arr(rng, 3, 1, 128)
    kc, vc = (_arr(rng, 3, 96, rcfg.num_kv_heads, 32) for _ in range(2))
    pos = np.array([5, 70, 95], np.int32)
    want, wk, wv = rattn.attn_decode(
        _layer(rp, 0, 0)["mixer"], rcfg, jnp.asarray(x), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(pos), kind=kind)
    got, gk, gv = tattn.attn_decode(
        ttfm.slice_block(tp.stack, 0)[0]["mixer"], tcfg, torch.from_numpy(x),
        torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(pos),
        kind=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)


# ------------------------------------------------------- the whole model

@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_reference(name):
    """lm_prefill's logits and caches, then three lm_decode_steps with
    per-slot cursors, and lm_hidden."""
    rcfg, tcfg, rp, tp = _weights(name)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 512, (2, 40)).astype(np.int32)
    want, rstate = rlm.lm_prefill(rp, rcfg, jnp.asarray(toks), max_len=48)
    got, tstate = tlm.lm_prefill(tp, tcfg, torch.from_numpy(toks).long(),
                                 max_len=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for rc, tc in zip(rstate.caches, tstate.caches):
        for f in ("k", "v"):
            np.testing.assert_allclose(tc[f].numpy(), np.asarray(rc[f]),
                                       **TOL)
    assert int(tstate.pos) == int(rstate.pos) == 40
    pos = np.array([40, 33], np.int32)           # per-slot cursors
    rstate = rstate._replace(pos=jnp.asarray(pos))
    tstate = tstate._replace(pos=torch.from_numpy(pos))
    for _ in range(3):
        tok = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
        want, rstate = rlm.lm_decode_step(rp, rcfg, jnp.asarray(tok), rstate)
        got, tstate = tlm.lm_decode_step(tp, tcfg, torch.from_numpy(tok),
                                         tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tstate.pos.numpy(), np.asarray(rstate.pos))
    h, _, plen = rlm.lm_hidden(rp, rcfg, jnp.asarray(toks))
    th, _, tplen = tlm.lm_hidden(tp, tcfg, torch.from_numpy(toks).long())
    assert plen == tplen == 0
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)


def test_greedy_generate_matches_reference():
    rcfg, tcfg, rp, tp = _weights("qwen3-4b")
    toks = np.random.default_rng(9).integers(0, 512, (2, 12)).astype(
        np.int32)
    want = rlm.greedy_generate(rp, rcfg, jnp.asarray(toks), steps=4,
                               max_len=24)
    got = tlm.greedy_generate(tp, tcfg, torch.from_numpy(toks).long(),
                              steps=4, max_len=24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_one_bf16_layer_matches_reference():
    rcfg, tcfg, rp, tp = _weights("smollm-135m", dtype="bfloat16")
    x = _arr(np.random.default_rng(10), 2, 40, 128)
    positions = np.arange(40)
    want, _ = rtfm._layer_forward(
        _layer(rp, 0, 0), rcfg, jnp.asarray(x, jnp.bfloat16), kind="attn",
        positions=jnp.asarray(positions))
    got, _ = ttfm._layer_forward(
        ttfm.slice_block(tp.stack, 0)[0], tcfg,
        torch.from_numpy(x).to(torch.bfloat16), kind="attn",
        positions=torch.from_numpy(positions))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_BAR, err


@pytest.mark.parametrize("name", ["gemma2-27b", "chatglm3-6b"])
def test_compute_dtype_weights_give_bit_identical_results(name):
    """`to_compute_dtype` (the server's weights) rounds once what every
    call rounded: bf16 prefill logits, caches and two decode steps equal
    those of the float32 weights bit for bit, with tied (gemma2) and
    separate (chatglm3) output embeddings."""
    _, tcfg, _, tp = _weights(name, dtype="bfloat16")
    cast = tlm.to_compute_dtype(tp, tcfg)
    layer = ttfm.slice_block(cast.stack, 0)[0]
    assert cast.embed.dtype == layer["mixer"].wq.dtype == torch.bfloat16
    assert layer["mlp"].w_out.dtype == torch.bfloat16
    assert layer["pre_norm"]["scale"].dtype == torch.float32
    assert cast.logits_w.dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, 512, (2, 20))).long()
    outs = []
    for p in (tp, cast):
        logits, state = tlm.lm_prefill(p, tcfg, toks, max_len=24)
        run = [logits, *(c[f] for c in state.caches for f in ("k", "v"))]
        for _ in range(2):
            logits, state = tlm.lm_decode_step(
                p, tcfg, logits.argmax(-1).to(torch.int32), state)
            run.append(logits)
        outs.append(run)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_init_entry_points_default_to_the_card(monkeypatch):
    """device=None means the card: with none, every init entry point and
    the server raise rather than build on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("smollm-135m"))
    calls = (lambda: tlm.lm_init(cfg),
             lambda: ttfm.stack_init(cfg, torch.Generator()),
             lambda: ttfm.init_caches(cfg, 2, 8),
             lambda: tcommon.dense_param((4, 4), torch.Generator()),
             lambda: tserver.Server(cfg, tserver.ServeConfig()))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------- server

PROMPT_LENS = (7, 30, 19, 12, 25, 31, 9)


@pytest.mark.parametrize("name,mode", [("smollm-135m", "continuous"),
                                       ("smollm-135m", "wave"),
                                       ("gemma2-27b", "continuous")])
def test_server_tokens_and_counters_match_reference(name, mode):
    rcfg, tcfg, rp, tp = _weights(name)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in PROMPT_LENS]
    news = [int(rng.integers(2, 6)) for _ in PROMPT_LENS]
    kw = dict(buckets=(16, 32), max_len=40, batch_slots=3, mode=mode)
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
    assert port.compile_count <= len(kw["buckets"]) + 1
    assert [b for b, _ in port.metrics["ttft_s"]] == [
        port.bucket_for(max(PROMPT_LENS[i:i + 3])) for i in (0, 3, 6)]


def test_unported_archs_and_layers_raise():
    """No architecture stays unported: the vision and audio ones serve
    too, and a config with an encoder or a frontend builds where it
    raised before (the encoder and the cross layers are drawn; the
    refusal `_refuse_cross` is gone). What still raises: an unknown arch,
    a Server for an encoder-decoder (it takes no frames), a prompt past
    the largest bucket."""
    for name in ("phi-3-vision-4.2b", "whisper-base", "mamba2-2.7b",
                 "olmoe-1b-7b", "jamba-v0.1-52b", "llama4-scout-17b-a16e"):
        assert get_config(name).name == name
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-5")
    cfg = reduced(get_config("smollm-135m"))
    whisper = dataclasses.replace(
        cfg, encoder=tconfig.EncoderConfig(num_layers=2, frames=64))
    with pytest.raises(ValueError, match="encoder-decoder"):
        tserver.Server(whisper, tserver.ServeConfig(), device="cpu")
    p = tlm.lm_init(whisper, device="cpu")
    assert "cross" in p.stack[0] and len(p.encoder["stack"]) == 1
    vision = dataclasses.replace(cfg, frontend="vision_stub")
    assert tlm.lm_init(vision, device="cpu").encoder is None
    assert not hasattr(ttfm, "_refuse_cross")
    server = tserver.Server(cfg, tserver.ServeConfig(buckets=(8,)),
                            device="cpu")
    with pytest.raises(ValueError, match="largest bucket"):
        server.bucket_for(9)
