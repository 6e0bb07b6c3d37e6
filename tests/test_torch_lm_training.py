"""PyTorch port, LM training: `repro_torch`'s `data/synthetic.py`,
`nn/lm.py`'s `chunked_xent` and `lm_loss`, the rematerialised superblocks
of `nn/transformer.py` and `nn/encdec.py`, `flash_attention`'s gradient
(`kernels/flash_attention.py`, `kernels/ref.py`), `ckpt/checkpoint.py`,
`runtime/trainer.py`, `launch/train.py` and `examples/train_lm.py`,
against the reference package on the same numpy inputs.

Weights: the reference's parameter tree (its shapes, from `jax.eval_shape`
of its `lm_init`) filled from numpy with a seed (matrices N(0, 1/fan_in),
the embedding N(0, 1), norm scales 1 + 0.2 N(0, 1), the SSM's leaves in
their ranges), reaching the port through `bridge.lm_params_from_jax`; the
stub patch and frame embeddings and the token batches are numpy draws fed
to both packages.

Sizes: the reference's `reduced()` configs (2 decoder layers, d_model 128,
4 or 2 query heads of 32, vocab 512, float32), batches of 2 x 32 tokens
(one MoE group of 64 tokens), the loss in chunks of 8 or 32 positions.

Tolerances (each named where it is used):
  * LOSS_TOL, rtol = atol = 1e-4: the LM bar of `test_torch_lm.py` (XLA's
    and ATen's CPU dots sum in other orders; the port scales the float32
    scores where the reference's `chunked_attention` scales q first).
  * GRAD_BAR = 1e-4: every gradient leaf within 1e-4 of its largest
    |entry| (the same causes; a relative bar per leaf, since a leaf's
    entries span decades).
  * FLASH_TOL, rtol = atol = 2e-5: `flash_attention_ref`'s bar in fp32,
    here for its gradient against `jax.vjp` of `chunked_attention`.
  * MICRO_TOL, rtol = 2e-3, atol = 2e-5: the reference's own bar for
    microbatched against one-batch training (`tests/test_runtime.py`).
  * TRAIN_TOL: the losses of 5 trainer steps within 1e-4 of the
    reference's, and the parameters after them within 2e-5 + 1e-3 of
    their size: AdamW divides each gradient entry by its own root mean
    square, so an entry near 0 moves by up to lr a step whatever its
    rounding.
  * Bit for bit: the token stream, remat on against off, a restart
    against an uninterrupted run, and checkpoints.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as rckpt
from repro.configs import ARCHS as RARCHS
from repro.configs import reduced as rreduced
from repro.data.synthetic import TokenStream as RTokenStream
from repro.nn import attention as rattn
from repro.nn import lm as rlm
from repro.nn.common import Param
from repro.runtime import trainer as rtrainer
from repro_torch import bridge
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.ckpt import tree_items
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data.synthetic import TokenStream, lm_batch_iterator
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.nn import lm as tlm
from repro_torch.runtime import trainer as ttrainer

ROOT = Path(__file__).resolve().parent.parent
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_BAR = 1e-4
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
MICRO_TOL = dict(rtol=2e-3, atol=2e-5)
B, S = 2, 32
GRAD_ARCHS = ("smollm-135m", "gemma2-27b", "olmoe-1b-7b", "mamba2-2.7b",
              "whisper-base", "phi-3-vision-4.2b")


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _is_param(x):
    return isinstance(x, Param)


def _key_name(k):
    return getattr(k, "name", getattr(k, "key", None))


def _leaf(rng, name, shape):
    """One numpy leaf by the reference's field name; stacked leaves carry
    the leading num_superblocks axis."""
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


def _numpy_tree(node):
    """A reference tree with numpy leaves: each Param's value, named
    tuples as dicts, None kept."""
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


def _weights(name, seed=0, **changes):
    """(reference config, port config, reference params, numpy tree) of
    the reduced `name` with `changes` to both configs."""
    key = (name, seed, tuple(sorted(changes.items())))
    if key not in _WEIGHTS:
        rcfg = dataclasses.replace(rreduced(RARCHS[name]), **changes)
        tcfg = dataclasses.replace(reduced(get_config(name)), **changes)
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
        _WEIGHTS[key] = (rcfg, tcfg, rparams, _numpy_tree(rparams))
    rcfg, tcfg, rparams, tree = _WEIGHTS[key]
    return rcfg, tcfg, rparams, bridge.lm_params_from_jax(tree, device="cpu")


def _batch(cfg, seed=3, ragged=False):
    """A numpy batch for `cfg`: tokens, labels and mask (B, S), with
    stub patches (vlm) or frames (audio); `ragged` zeroes a random tenth
    of the mask and sets the labels there to -1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy(),
             "mask": np.ones((B, S), np.int32)}
    if ragged:
        drop = rng.random((B, S)) < 0.1
        batch["mask"][drop] = 0
        batch["labels"][drop] = -1
    if cfg.frontend == "vision_stub":
        batch["patches"] = _arr(rng, B, cfg.num_patches, cfg.d_model,
                                scale=cfg.d_model ** -0.5)
    if cfg.encoder is not None:
        batch["frames"] = _arr(rng, B, cfg.encoder.frames, cfg.d_model,
                               scale=cfg.d_model ** -0.5)
    return batch


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_grads(params, cfg, batch):
    """(loss, metrics, {key: gradient}) of the port's lm_loss."""
    keys = [k for k, _ in tree_items(params)]
    leaves = [t.detach().clone().requires_grad_(True)
              for _, t in tree_items(params)]
    p = tckpt.tree_replace(params, dict(zip(keys, leaves)))
    loss, metrics = tlm.lm_loss(p, cfg, _t(batch))
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, dict(zip(keys, grads))


# -------------------------------------------------------------- the stream

@pytest.mark.parametrize("seed,step,hosts,host", [
    (0, 0, 1, 0), (3, 5, 1, 0), (7, 123, 2, 1), (11, 2 ** 20, 4, 3)])
def test_token_stream_matches_reference(seed, step, hosts, host):
    kw = dict(vocab_size=49152, seq_len=64, global_batch=8, seed=seed,
              num_hosts=hosts, host_id=host)
    got, want = TokenStream(**kw).batch_at(step), RTokenStream(
        **kw).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (8 // hosts,
                                                                 64)
        np.testing.assert_array_equal(got[k], want[k])
    it = lm_batch_iterator(TokenStream(**kw), start_step=step)
    np.testing.assert_array_equal(next(it)["tokens"], want["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"], RTokenStream(
        **kw).batch_at(step + 1)["tokens"])


def test_token_stream_refuses_an_uneven_host_split():
    with pytest.raises(ValueError, match="does not divide"):
        TokenStream(vocab_size=8, seq_len=4, global_batch=6,
                    num_hosts=4).batch_at(0)


# ------------------------------------------------------------------ the loss

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_lm_loss_matches_reference(name):
    """Every architecture, reduced, float32: the loss, its cross-entropy
    and the MoE aux loss (LOSS_TOL); vlm with stub patches before the
    tokens, audio with stub frames for the encoder."""
    rcfg, tcfg, rp, tp = _weights(name, loss_chunk=8)
    batch = _batch(tcfg)
    want, wm = jax.jit(functools.partial(rlm.lm_loss, cfg=rcfg))(
        rp, batch=_j(batch))
    with torch.no_grad():
        got, gm = tlm.lm_loss(tp, tcfg, _t(batch))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(gm["ce"].item(), float(wm["ce"]), **LOSS_TOL)
    np.testing.assert_allclose(gm["moe_aux"].item(), float(wm["moe_aux"]),
                               **LOSS_TOL)
    assert (gm["moe_aux"].item() > 0) == (tcfg.moe is not None)


@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_xent_with_a_ragged_mask(chunk):
    """Chunks of 8 and one of 32 positions, a tenth of the mask zero and
    their labels -1: the masked mean, as the reference computes it."""
    rcfg, tcfg, rp, tp = _weights("smollm-135m", loss_chunk=chunk)
    batch = _batch(tcfg, seed=4, ragged=True)
    assert 0 < batch["mask"].sum() < B * S
    want, _ = jax.jit(functools.partial(rlm.lm_loss, cfg=rcfg))(
        rp, batch=_j(batch))
    with torch.no_grad():
        got, _ = tlm.lm_loss(tp, tcfg, _t(batch))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)


def test_chunked_xent_refuses_a_ragged_chunk():
    _, tcfg, _, tp = _weights("smollm-135m", loss_chunk=12)
    with pytest.raises(ValueError, match="multiple of loss_chunk"):
        tlm.lm_loss(tp, tcfg, _t(_batch(tcfg)))


def test_loss_ignores_the_serving_copy_of_the_unembedding():
    """`to_compute_dtype` makes `logits_w` for serving; the loss reads the
    embedding itself, so the tied embedding gets the unembedding's
    gradient."""
    _, tcfg, _, tp = _weights("smollm-135m")
    batch = _batch(tcfg)
    served = tp._replace(logits_w=torch.zeros_like(tp.embed.T))
    with torch.no_grad():
        a, _ = tlm.lm_loss(tp, tcfg, _t(batch))
        b, _ = tlm.lm_loss(served, tcfg, _t(batch))
    assert a.item() == b.item()


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_lm_loss_gradients_match_jax_grad(name):
    """The gradient of every parameter leaf against `jax.grad` of the
    reference's lm_loss: within GRAD_BAR of the leaf's largest |entry|.
    gemma2 runs its window and softcap, olmoe its aux loss, whisper its
    encoder and cross-attention, phi-3-vision its patch prefix."""
    rcfg, tcfg, rp, tp = _weights(name, loss_chunk=8)
    batch = _batch(tcfg)
    rg = jax.jit(jax.grad(lambda p, b: rlm.lm_loss(p, rcfg, b)[0]))(
        rp, _j(batch))
    want = dict(tree_items(_numpy_tree(rg)))
    _, _, got = _port_grads(tp, tcfg, batch)
    assert got.keys() == want.keys()
    for key, g in got.items():
        w = want[key]
        scale = np.abs(w).max()
        assert scale > 0, key
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_BAR * scale, (key, err, scale)


@pytest.mark.parametrize("name", ["smollm-135m", "whisper-base"])
def test_remat_is_bit_equal(name):
    """remat on (torch.utils.checkpoint around each superblock, the
    encoder's too) and off give the same loss and gradients bit for bit
    on the CPU."""
    _, cfg, _, tp = _weights(name)
    on_cfg, off_cfg = (dataclasses.replace(cfg, remat=r) for r in (True,
                                                                  False))
    assert get_config(name).remat and not cfg.remat      # the defaults
    batch = _batch(on_cfg)
    l_on, _, g_on = _port_grads(tp, on_cfg, batch)
    l_off, _, g_off = _port_grads(tp, off_cfg, batch)
    assert l_on.item() == l_off.item()
    for key in g_on:
        assert torch.equal(g_on[key], g_off[key]), key


def test_remat_recomputes_each_superblock(monkeypatch):
    """Under remat the attention of each layer runs twice (forward and the
    backward's recompute), without it once."""
    _, cfg, _, tp = _weights("smollm-135m")
    calls = []
    plain = kops.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)
    monkeypatch.setattr(kops, "flash_attention", counting)
    for remat, want in ((True, 2), (False, 1)):
        calls.clear()
        _port_grads(tp, dataclasses.replace(cfg, remat=remat), _batch(cfg))
        assert len(calls) == want * cfg.num_layers


# ------------------------------------------------- flash_attention's gradient

FLASH_GRID = {
    "causal": ((2, 24, 24, 4, 2, 32), dict(causal=True)),
    "non-causal": ((2, 24, 24, 4, 2, 32), dict(causal=False)),
    "window": ((1, 40, 40, 4, 2, 32), dict(causal=True, window=8)),
    "softcap": ((1, 24, 24, 4, 4, 32), dict(causal=True, softcap=5.0)),
    "window and softcap": ((1, 40, 40, 4, 2, 32),
                           dict(causal=True, window=8, softcap=5.0)),
    "q_offset": ((1, 8, 24, 4, 2, 32), dict(causal=True, q_offset=16)),
    "cross Sq != Skv": ((2, 12, 40, 4, 2, 32), dict(causal=False)),
    "gqa 4": ((1, 16, 16, 8, 2, 64), dict(causal=True)),
    "head dim 96": ((1, 16, 16, 2, 2, 96), dict(causal=True)),
    "head dim 128": ((1, 16, 16, 2, 1, 128), dict(causal=True)),
}


def _qkv(shape, seed=0, dtype=np.float32):
    b, sq, skv, h, kv, d = shape
    rng = np.random.default_rng(seed)
    return (_arr(rng, b, sq, h, d), _arr(rng, b, skv, kv, d),
            _arr(rng, b, skv, kv, d), _arr(rng, b, sq, h, d))


@pytest.mark.parametrize("case", list(FLASH_GRID))
def test_flash_attention_bwd_ref_matches_jax_vjp(case):
    """The plain backward against `jax.vjp` of the reference's
    `chunked_attention` over the option grid, fp32 (FLASH_TOL)."""
    shape, opts = FLASH_GRID[case]
    q, k, v, do = _qkv(shape)
    ropts = {("attn_softcap" if n == "softcap" else n): x
             for n, x in opts.items()}
    _, vjp = jax.vjp(lambda a, b_, c: rattn.chunked_attention(
        a, b_, c, **ropts), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = kref.flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v, do)),
                                       **opts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FLASH_TOL)


def test_cpu_entry_gives_the_plain_gradient():
    """On the CPU `flash_attention` runs `flash_attention_ref` under
    autograd, and `flash_attention_bwd` is `flash_attention_bwd_ref`."""
    q, k, v, do = map(torch.from_numpy, _qkv((1, 24, 24, 4, 2, 32)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = kops.flash_attention(*leaves, window=8, softcap=5.0)
    got = torch.autograd.grad(out, leaves, do)
    want = kref.flash_attention_bwd_ref(q, k, v, do, window=8, softcap=5.0)
    entry = fa_mod.flash_attention_bwd(q, k, v, do, window=8, softcap=5.0)
    for g, w, e in zip(got, want, entry):
        assert torch.equal(g, w) and torch.equal(e, w)
    with pytest.raises(ValueError, match="not q's shape"):
        fa_mod.flash_attention_bwd(q, k, v, do[:, :-1])


def test_cuda_routing_launches_the_backward_kernel(monkeypatch):
    """With the operands taken for CUDA ones and stand-ins for the two
    launchers, a forward under grad goes through `FlashAttention`: the
    forward launcher once, the backward launcher once in the backward,
    never `flash_attention_ref`, and the gradient is the plain one."""
    q, k, v, do = map(torch.from_numpy, _qkv((2, 12, 40, 4, 2, 32)))
    opts = dict(causal=False, softcap=5.0, q_offset=3)
    calls = []

    def fwd(q_, k_, v_, **o):
        calls.append(("fwd", o))
        with torch.no_grad():
            return kref.flash_attention_ref(q_, k_, v_, **o)

    def bwd(q_, k_, v_, dout, **o):
        calls.append(("bwd", o))
        return kref.flash_attention_bwd_ref(q_, k_, v_, dout, **o)

    def refuse(*a, **k):
        raise AssertionError("flash_attention_ref on the kernel route")
    monkeypatch.setattr(fa_mod, "on_cpu", lambda *t: False)
    monkeypatch.setattr(fa_mod, "_launch_forward", fwd)
    monkeypatch.setattr(fa_mod, "_launch_backward", bwd)
    monkeypatch.setattr(fa_mod, "flash_attention_ref", refuse)
    monkeypatch.setattr(fa_mod, "flash_attention_bwd_ref", refuse)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = kops.flash_attention(*leaves, **opts)
    assert out.grad_fn is not None and [c for c, _ in calls] == ["fwd"]
    got = torch.autograd.grad(out, leaves, do)
    full = dict(opts, window=None, scale=None)
    assert calls == [("fwd", full), ("bwd", full)]
    want = kref.flash_attention_bwd_ref(q, k, v, do, **opts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # without grad the forward launches alone, with no autograd node
    calls.clear()
    with torch.no_grad():
        assert kops.flash_attention(*leaves, **opts).grad_fn is None
    assert [c for c, _ in calls] == ["fwd"]


def test_gnn_entries_still_refuse_gradients():
    """The GNN kernels keep their guard: an operand that requires grad
    raises NoBackward, or is recorded inside `record_grad_cuts`."""
    a = torch.randn(8, 4, requires_grad=True)
    with pytest.raises(kops.NoBackward, match="^matmul: "):
        kops.matmul(a, torch.randn(4, 3))
    with kops.record_grad_cuts() as cuts:
        kops.matmul(a, torch.randn(4, 3))
    assert [e for e, _ in cuts] == ["matmul"]


# ----------------------------------------------------------------- trainer

def _tc(**kw):
    base = dict(steps=5, seq_len=32, global_batch=4, seed=0)
    base.update(kw)
    return ttrainer.TrainConfig(**base)


def test_train_config_matches_reference():
    assert (dataclasses.asdict(ttrainer.TrainConfig())
            == dataclasses.asdict(rtrainer.TrainConfig()))


def test_trainer_matches_reference():
    """The same numpy weights through both trainers, 5 steps: the losses
    and the parameters after them (TRAIN_TOL, see the module text)."""
    rcfg, tcfg, rp, tp = _weights("smollm-135m")
    kw = dict(steps=5, seq_len=32, global_batch=4, lr=1e-3, warmup_steps=2)
    rt = rtrainer.Trainer(rcfg, rtrainer.TrainConfig(**kw), params=rp)
    rt.run()
    tt = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(**kw), params=tp,
                          device="cpu")
    tt.run()
    np.testing.assert_allclose([r.loss for r in tt.history],
                               [r.loss for r in rt.history], **LOSS_TOL)
    want = dict(tree_items(_numpy_tree(rt.params)))
    got = dict(tree_items(bridge.params_to_numpy(tt.params)))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                   atol=2e-5, err_msg=key)
    assert int(tt.opt["count"]) == 5 and tt.summary()["steps"] == 5


def test_trainer_microbatch_equivalence():
    """Four microbatches against one batch, the reference test's bar."""
    _, cfg, _, tp = _weights("smollm-135m")
    runs = []
    for n in (1, 4):
        tr = ttrainer.Trainer(cfg, _tc(steps=1, microbatches=n,
                                       clip_norm=1e9), params=tp,
                              device="cpu")
        tr.run()
        runs.append(bridge.params_to_numpy(tr.params))
    for (k, a), (_, b) in zip(tree_items(runs[0]), tree_items(runs[1])):
        np.testing.assert_allclose(a, b, err_msg=k, **MICRO_TOL)


def test_microbatches_must_divide_the_batch():
    _, cfg, _, tp = _weights("smollm-135m")
    tr = ttrainer.Trainer(cfg, _tc(global_batch=4, microbatches=3),
                          params=tp, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        tr.run(max_failures=0)


def test_restart_losses_equal_an_uninterrupted_run(tmp_path):
    """Chaos drill: a crash at step 5 restores the step-4 checkpoint; the
    losses from there on equal an uninterrupted run's bit for bit (the
    stream is a function of the step, the checkpoint exact)."""
    _, cfg, _, tp = _weights("smollm-135m")
    clean = ttrainer.Trainer(cfg, _tc(steps=8), params=tp, device="cpu")
    clean.run()
    crashed = []

    def injector(step):
        if step == 5 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected node failure")
    tr = ttrainer.Trainer(cfg, _tc(steps=8, ckpt_dir=str(tmp_path),
                                   ckpt_every=2), params=tp,
                          failure_injector=injector, device="cpu")
    tr.run()
    assert tr.restarts == 1 and tr.step == 8 and crashed == [5]
    assert [r.step for r in tr.history] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    by_step = {r.step: r.loss for r in tr.history}
    assert [by_step[s] for s in range(8)] == [r.loss for r in clean.history]
    assert tr.history[4].loss == tr.history[5].loss
    assert tckpt.latest_step(str(tmp_path)) == 8


def test_restart_without_a_checkpoint_starts_over(tmp_path):
    """A crash before the first save restarts from step 0 with the seed's
    init; the rerun's losses equal the first attempt's."""
    cfg = reduced(get_config("smollm-135m"))
    crashed = []

    def injector(step):
        if step == 1 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected node failure")
    tr = ttrainer.Trainer(cfg, _tc(steps=2, ckpt_dir=str(tmp_path),
                                   ckpt_every=5), failure_injector=injector,
                          device="cpu")
    tr.run()
    assert tr.restarts == 1
    assert [r.step for r in tr.history] == [0, 0, 1]
    assert tr.history[0].loss == tr.history[1].loss


def test_trainer_gives_up_after_max_failures(tmp_path):
    cfg = reduced(get_config("smollm-135m"))
    seen = []

    def injector(step):
        seen.append(step)
        raise RuntimeError("persistent failure")
    tr = ttrainer.Trainer(cfg, _tc(steps=4, ckpt_dir=str(tmp_path),
                                   ckpt_every=1), failure_injector=injector,
                          device="cpu")
    with pytest.raises(RuntimeError, match="persistent failure"):
        tr.run(max_failures=2)
    assert len(seen) == 3 and tr.restarts == 2
    # without a checkpoint directory the first failure is the last
    tr = ttrainer.Trainer(cfg, _tc(steps=4), failure_injector=injector,
                          device="cpu")
    with pytest.raises(RuntimeError, match="persistent failure"):
        tr.run()


def test_straggler_detection():
    cfg = reduced(get_config("smollm-135m"))
    tr = ttrainer.Trainer(cfg, _tc(steps=6, global_batch=2,
                                   straggler_factor=2.0), device="cpu")
    orig, calls = tr.train_step, []

    def slow_step(*a, **k):
        calls.append(1)
        if len(calls) == 5:
            time.sleep(max(0.2, 4.0 * (tr._straggler.baseline or 0.0)))
        return orig(*a, **k)
    tr.train_step = slow_step
    tr.run()
    assert [r.straggler for r in tr.history][4]
    assert tr.summary()["stragglers"] >= 1


def test_trainer_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(reduced(get_config("smollm-135m")), _tc())


# -------------------------------------------------------------- checkpoints

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    sym = torch.randn(300, 300, generator=g)
    return {"params": tlm.LMParams(
                embed=torch.randn(16, 8, generator=g),
                stack=[{"w": torch.randn(3, 4, generator=g),
                        "none": None}],
                final_norm={"scale": torch.ones(8)}),
            "adj": (sym + sym.T) / 2,
            "half": torch.randn(5, 7, generator=g).bfloat16(),
            "count": torch.tensor(3, dtype=torch.int32)}


def _zeros_like(tree):
    keys = [k for k, _ in tree_items(tree)]
    return tckpt.tree_replace(tree, {k: torch.zeros_like(t) for k, (_, t)
                                     in zip(keys, tree_items(tree))})


def _assert_equal_trees(a, b):
    ia, ib = list(tree_items(a)), list(tree_items(b))
    assert [k for k, _ in ia] == [k for k, _ in ib]
    for (k, x), (_, y) in zip(ia, ib):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_checkpoint_round_trip_keep_k_and_symg(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        tckpt.save_checkpoint(d, step, _state(step), keep=2)
    assert sorted(os.listdir(d)) == ["step_0000000003", "step_0000000004"]
    assert tckpt.latest_step(d) == 4
    step, got = tckpt.restore_checkpoint(d, _zeros_like(_state()))
    assert step == 4
    _assert_equal_trees(got, _state(4))
    assert isinstance(got["params"], tlm.LMParams)
    assert got["params"].stack[0]["none"] is None
    _, older = tckpt.restore_checkpoint(d, _zeros_like(_state()), step=3)
    _assert_equal_trees(older, _state(3))
    # SymG: the symmetric (300, 300) float32 leaf is stored as its triangle
    path = Path(d) / "step_0000000004"
    manifest = json.loads((path / "manifest.json").read_text())
    keys = {k: (name, shape, dt) for k, name, shape, dt in manifest["keys"]}
    name = keys["adj"][0]
    assert manifest["symg"] == [[name, 300]]
    with np.load(path / "arrays.npz") as z:
        assert z[name].shape == (300 * 301 // 2,)
    # the bf16 leaf: its bits, restored exactly
    assert keys["half"][2] == "bfloat16"
    with pytest.raises(KeyError, match="missing key"):
        tckpt.restore_checkpoint(d, {"other": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "nowhere"), _state())


def test_checkpoint_publish_is_atomic(tmp_path):
    """A writer's tmp directory is never a restore target; a fresh one is
    left alone by cleanup, an abandoned one (an hour old) is removed."""
    d = tmp_path
    tckpt.save_checkpoint(str(d), 1, _state(1))
    fresh, stale = d / "tmp.2.999", d / "tmp.3.999"
    for t in (fresh, stale):
        t.mkdir()
        (t / "arrays.npz").write_bytes(b"partial")
    old = time.time() - 7200
    os.utime(stale, (old, old))
    assert tckpt.latest_step(str(d)) == 1
    _, got = tckpt.restore_checkpoint(str(d), _zeros_like(_state()))
    _assert_equal_trees(got, _state(1))
    tckpt.save_checkpoint(str(d), 2, _state(2))
    assert fresh.exists() and not stale.exists()
    assert tckpt.latest_step(str(d)) == 2


def test_checkpoint_manager_saves_async_every_k(tmp_path):
    m = tckpt.CheckpointManager(str(tmp_path), keep=2, every=2)
    saved = [m.maybe_save(s, _state(s)) for s in range(5)]
    assert saved == [True, False, True, False, True]
    assert m.maybe_save(5, _state(5), force=True)
    m.wait()
    assert m.saved_steps == [0, 2, 4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000004",
                                            "step_0000000005"]
    step, got = m.restore_latest(_zeros_like(_state()))
    assert step == 5
    _assert_equal_trees(got, _state(5))
    empty = tckpt.CheckpointManager(str(tmp_path / "empty"))
    tree = _state()
    assert empty.restore_latest(tree) == (None, tree)


def test_dict_checkpoints_cross_between_packages(tmp_path):
    """A dict-of-arrays checkpoint written by either package restores in
    the other, values and dtypes exact (SymG packing included)."""
    rng = np.random.default_rng(8)
    sym = _arr(rng, 256, 256)
    tree = {"a": _arr(rng, 3, 5), "b": {"c": rng.integers(
        0, 9, (4,)).astype(np.int32), "sym": (sym + sym.T) / 2}}
    rckpt.save_checkpoint(str(tmp_path / "ref"), 7, tree)
    step, got = tckpt.restore_checkpoint(str(tmp_path / "ref"), {
        "a": torch.zeros(3, 5), "b": {"c": torch.zeros(4, dtype=torch.int32),
                                      "sym": torch.zeros(256, 256)}})
    assert step == 7
    for (k, x), (_, y) in zip(tree_items(got), tree_items(tree)):
        assert x.dtype == torch.from_numpy(y).dtype, k
        np.testing.assert_array_equal(x.numpy(), y)
    tckpt.save_checkpoint(str(tmp_path / "port"), 9,
                          {k: (torch.from_numpy(v) if k == "a" else
                               {n: torch.from_numpy(u) for n, u in v.items()})
                           for k, v in tree.items()})
    step, back = rckpt.restore_checkpoint(
        str(tmp_path / "port"), jax.tree_util.tree_map(np.zeros_like, tree))
    assert step == 9
    for (k, x), (_, y) in zip(tree_items(back), tree_items(tree)):
        assert np.asarray(x).dtype == y.dtype, k
        np.testing.assert_array_equal(np.asarray(x), y)


# -------------------------------------------------------------- entry points

def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_launcher_on_the_cpu():
    r = _run("repro_torch.launch.train", "--arch", "smollm-135m", "--reduced",
             "--device", "cpu", "--steps", "3", "--batch", "4", "--seq",
             "32", "--microbatches", "2")
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout[r.stdout.index("{"):])
    assert summary["steps"] == 3 and summary["restarts"] == 0
    assert "device=cpu" in r.stdout


def test_train_lm_example_on_the_cpu():
    r = _run("repro_torch.examples.train_lm", "--steps", "3", "--device",
             "cpu")
    assert r.returncode == 0, r.stderr
    assert "loss:" in r.stdout and "over 3 steps" in r.stdout
