"""Top-level language model of every family: embeddings, the superblock
stack, logits, and the serving pair prefill / decode step.

  vlm (phi-3-vision)  — optional `prefix_embeds` (stub patch embeddings,
                        (B, P, d)) go in front of the token embeddings;
                        positions and the caches then count P + S.
  audio (whisper)     — optional `enc_embeds` (stub frame embeddings, (B,
                        frames, d)) run the real encoder (`encdec`); every
                        decoder layer cross-attends over its K and V,
                        which `ServeState.enc_kv` carries to the decode
                        steps.

Training: `lm_loss` is the reference's loss over token positions (after
a vision prefix) plus the MoE aux loss; `chunked_xent` computes its
cross-entropy over `cfg.loss_chunk` positions at a time, each chunk under
`torch.utils.checkpoint`, so (B, S, V) logits never exist. Training
differentiates float32 parameters (from `lm_init(dtype=None)` or the
bridge), cast to the compute dtype at use; it reads no `logits_w`, the
serving copy that `to_compute_dtype` makes, which would cut the tied
embedding's gradient.

Placement on a mesh of ranks: `lm_axes` gives the logical axes of every
leaf of `lm_init`'s tree (the reference's, in a tree of their own), and
`lm_loss`, `lm_prefill`, `lm_decode_step` and `greedy_generate` take a
`place=` (`dist.sharding.Placement`) when the parameters they are given
are this rank's blocks. The embedding, the unembedding and the final
norms are then gathered once per call (outside `chunked_xent`'s
checkpointed chunks, so the loss chunks do not gather again), the stack
one superblock at a time inside its remat region
(`transformer.stack_forward`), the encoder likewise, and the decoder's
cross K and V projections once for `encdec.cross_kv`. In `lm_loss` the
batch is this rank's rows: its cross-entropy is divided by the mask's
count over the data group and its MoE aux loss by the group's size, so
the shares of the data group sum to the loss of the whole batch. With no
`place` nothing changes.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device

from . import encdec, transformer as tfm
from .attention import AttnParams
from .common import dense_param, draw_generator, softcap, take_embedding
from .config import ArchConfig
from .mlp import MLPParams
from .moe import MoEParams
from .ssm import SSMParams


class LMParams(NamedTuple):
    embed: torch.Tensor                      # (V, d)
    stack: List[Dict[str, Any]]
    final_norm: Dict[str, torch.Tensor]
    unembed: Optional[torch.Tensor] = None   # (d, V) when not tied
    # the encoder of an encoder-decoder: {"stack", "final_norm"}
    encoder: Optional[Dict[str, Any]] = None
    # (d, V) float32 copy of the compute-dtype unembedding, made once by
    # `to_compute_dtype`; None: `hidden_to_logits` rounds on every call
    logits_w: Optional[torch.Tensor] = None


def lm_init(cfg: ArchConfig, *, seed: int = 0, device: DeviceLike = None,
            dtype: Optional[torch.dtype] = None) -> LMParams:
    """Random weights from a `torch.Generator` (the port's own init; the
    reference's `jax.random` draws differ) on `device`, the card when
    None.

    dtype None: every leaf float32, drawn by a generator on the host, so
    every device gets the same draws. A dtype (the compute dtype, for a
    model at full width): the draws are made by a generator on `device`
    and each projection matrix and the embedding are rounded to `dtype`
    as they are made, so no float32 copy of the model is ever whole; the
    leaves the reference reads in float32 (norm scales, the SSM's conv,
    dt, A and skip) stay float32, and `to_compute_dtype` then changes
    nothing. An encoder-decoder draws its decoder's cross-attention with
    each layer and its encoder last. On the `meta` device nothing is
    drawn: the leaves have their shapes and dtypes only."""
    device = resolve_device(device)
    g = draw_generator(device, on_host=dtype is None)
    if g is not None:
        g.manual_seed(seed)
    wdt = dtype if dtype is not None else torch.float32
    embed = dense_param((cfg.vocab_size, cfg.d_model), g, scale=1.0,
                        device=device, dtype=wdt)
    stack = tfm.stack_init(cfg, g, device=device, dtype=wdt,
                           cross=cfg.is_encdec)
    unembed = (None if cfg.tie_embeddings else
               dense_param((cfg.d_model, cfg.vocab_size), g, device=device,
                           dtype=wdt))
    return LMParams(
        embed=embed, stack=stack,
        final_norm=tfm.norm_init(cfg, device=device), unembed=unembed,
        encoder=(encdec.encoder_init(cfg, g, device=device, dtype=wdt)
                 if cfg.is_encdec else None))


def lm_axes(cfg: ArchConfig) -> LMParams:
    """The logical axes of `lm_init`'s tree: its structure (`tree_items`
    keys equal) with the reference's tuple of axis names in place of each
    tensor, the stacked leaves led by "layers"."""
    return LMParams(
        embed=("vocab", "embed"),
        stack=tfm.stack_axes(cfg, cross=cfg.is_encdec),
        final_norm=tfm.norm_axes(cfg),
        unembed=None if cfg.tie_embeddings else ("embed", "vocab"),
        encoder=encdec.encoder_axes(cfg) if cfg.is_encdec else None)


def _head(p: LMParams, place) -> LMParams:
    """On a mesh (`place`): the parameters with the embedding, the
    unembedding and the final norms (the encoder's too) gathered, and no
    `logits_w`, whose rounding `hidden_to_logits` then repeats; the
    stacks stay this rank's blocks. `p` itself without a placement."""
    if place is None:
        return p
    s = place.specs
    encoder = p.encoder
    if encoder is not None:
        encoder = dict(encoder, final_norm=place.gather(
            encoder["final_norm"], s.encoder["final_norm"]))
    return p._replace(
        embed=place.gather(p.embed, s.embed),
        unembed=place.gather(p.unembed, s.unembed),
        final_norm=place.gather(p.final_norm, s.final_norm),
        encoder=encoder, logits_w=None)


def _stack_gather(p: LMParams, place):
    """`transformer.stack_forward`'s gather for the decoder stack, or
    None."""
    if place is None:
        return None
    return place.block_gather(p.stack, place.specs.stack)


def embed_tokens(p: LMParams, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = take_embedding(p.embed, tokens).to(cfg.dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    return x


def hidden_to_logits(p: LMParams, cfg: ArchConfig,
                     h: torch.Tensor) -> torch.Tensor:
    """float32 logits from compute-dtype operands: the operands are rounded
    to the compute dtype, then multiplied and summed in float32, as the
    reference's preferred_element_type=float32 does."""
    w = p.logits_w
    if w is None:
        w = (p.embed.T if p.unembed is None else p.unembed
             ).to(cfg.dtype).float()
    return softcap(h.float() @ w, cfg.final_softcap)


def _round_layer(node: Dict[str, Any], dt: torch.dtype) -> Dict[str, Any]:
    """One stacked position with its projection matrices in `dt`: the
    leaves the reference rounds at use, and no other."""
    def cast(w):
        return None if w is None else w.to(dt)

    def mlp(m: MLPParams) -> MLPParams:
        return MLPParams(*(cast(w) for w in m))

    def attn(a: AttnParams) -> AttnParams:
        return a._replace(wq=cast(a.wq), wk=cast(a.wk), wv=cast(a.wv),
                          wo=cast(a.wo))
    out = dict(node)
    m = node["mixer"]
    if isinstance(m, SSMParams):
        out["mixer"] = m._replace(w_zx=cast(m.w_zx), w_bc=cast(m.w_bc),
                                  w_dt=cast(m.w_dt), w_out=cast(m.w_out))
    else:
        out["mixer"] = attn(m)
    if "cross" in node:
        out["cross"] = attn(node["cross"])
    if isinstance(node.get("mlp"), MoEParams):
        e = node["mlp"]
        out["mlp"] = MoEParams(
            w_router=cast(e.w_router), w_in=cast(e.w_in), w_up=cast(e.w_up),
            w_out=cast(e.w_out),
            shared=None if e.shared is None else mlp(e.shared))
    elif "mlp" in node:
        out["mlp"] = mlp(node["mlp"])
    return out


def to_compute_dtype(p: LMParams, cfg: ArchConfig) -> LMParams:
    """The same parameters with the embedding and every projection matrix
    (attention and cross-attention, SSM in/out projections, MLP, router
    and experts, the encoder's too) rounded to the compute dtype once,
    and `logits_w` made, so that a prefill or decode step converts no
    weight. Every call rounded them the same way,
    so the results are bit for bit those of `p`. Norm scales and the
    SSM's conv, dt, A and skip leaves stay float32, as the reference
    reads them."""
    dt = cfg.dtype
    unembed = p.embed.T if p.unembed is None else p.unembed
    encoder = None
    if p.encoder is not None:
        encoder = dict(p.encoder,
                       stack=[_round_layer(n, dt) for n in p.encoder["stack"]])
    return p._replace(embed=p.embed.to(dt),
                      stack=[_round_layer(n, dt) for n in p.stack],
                      encoder=encoder, logits_w=unembed.to(dt).float())


def _encode(p: LMParams, cfg: ArchConfig, enc_embeds: torch.Tensor,
            place=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder over the stub frames, then the decoder's cross K and V
    (each (nsb, B, frames, KV, hd)); on a mesh the encoder's superblocks
    and the cross projections gathered."""
    gather, stack = None, p.stack
    if place is not None:
        s = place.specs
        gather = place.block_gather(p.encoder["stack"], s.encoder["stack"])
        stack = [dict(p.stack[0], cross=place.gather(
            p.stack[0]["cross"], s.stack[0]["cross"]))]
    enc_out = encdec.encoder_forward(p.encoder, cfg, enc_embeds.to(cfg.dtype),
                                     gather=gather)
    return encdec.cross_kv(stack, cfg, enc_out)


def _inputs(p: LMParams, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor],
            enc_embeds: Optional[torch.Tensor], place=None):
    """(the embedded prefix and tokens (B, P + S, d), their positions, the
    encoder's cross K and V or None, P). `p` has its head gathered
    (`_head`)."""
    x = embed_tokens(p, cfg, tokens)
    plen = 0
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.dtype), x], dim=1)
        plen = prefix_embeds.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)
    enc_kv = (_encode(p, cfg, enc_embeds, place) if enc_embeds is not None
              else None)
    return x, positions, enc_kv, plen


def lm_hidden(p: LMParams, cfg: ArchConfig, tokens: torch.Tensor, *,
              prefix_embeds: Optional[torch.Tensor] = None,
              enc_embeds: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (final-normed hidden (B, P + S, d), moe_aux, prefix_len
    P), P = 0 without `prefix_embeds`."""
    return _hidden(p, cfg, tokens, prefix_embeds, enc_embeds, None)


def _hidden(p, cfg, tokens, prefix_embeds, enc_embeds, place):
    x, positions, enc_kv, plen = _inputs(p, cfg, tokens, prefix_embeds,
                                         enc_embeds, place)
    h, aux = tfm.stack_forward(p.stack, cfg, x, positions=positions,
                               enc_kv_stacked=enc_kv,
                               gather=_stack_gather(p, place))
    return tfm.apply_norm(p.final_norm, cfg, h), aux, plen


def _chunk_nll(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, final_softcap: Optional[float]
               ) -> torch.Tensor:
    """The summed masked negative log-likelihood of one chunk: float32
    logits from the compute-dtype hidden states, as `hidden_to_logits`
    makes them, less the gold logit (a label < 0 reads class 0)."""
    logits = softcap(h.float() @ w, final_softcap)
    gold = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])
    return ((torch.logsumexp(logits, dim=-1) - gold[..., 0]) * mask).sum()


def chunked_xent(p: LMParams, cfg: ArchConfig, h: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor, *,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over the positions where `mask` is set. h: (B,
    S, d) final-normed hidden states; labels, mask: (B, S). The logits
    are made `cfg.loss_chunk` positions at a time (S must be a multiple
    of the chunk, as in the reference), each chunk under
    `torch.utils.checkpoint` when grad mode is on, so at most one chunk's
    (B, chunk, V) float32 logits exist, in the forward or the backward.
    `count` (on a mesh: the mask's count over the data group) replaces
    the mask's own count as the divisor."""
    s = h.shape[1]
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"chunked_xent: sequence {s} is not a multiple of "
                         f"loss_chunk {c}")
    w = (p.embed.T if p.unembed is None else p.unembed).to(cfg.dtype).float()
    maskf = mask.to(torch.float32)
    total = torch.zeros((), device=h.device)
    for i in range(0, s, c):
        args = (h[:, i:i + c], w, labels[:, i:i + c], maskf[:, i:i + c],
                cfg.final_softcap)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _chunk_nll(*args)
    if count is None:
        count = maskf.sum()
    return total / torch.clamp_min(count, 1.0)


def lm_loss(p: LMParams, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, place=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens, labels and mask (B, S), and for vlm `patches` (B, P,
    d) or for audio `frames` (B, frames, d). The cross-entropy is over the
    token positions only (a vision prefix is left out). Returns (ce +
    moe_aux, {"ce", "moe_aux"}). With `place`: this rank's share of the
    data group's loss over this rank's rows (see the module
    docstring)."""
    p = _head(p, place)
    h, aux, plen = _hidden(p, cfg, batch["tokens"], batch.get("patches"),
                           batch.get("frames"), place)
    count = None
    if place is not None:
        count = place.data_sum(batch["mask"].to(torch.float32).sum())
        aux = aux * (1.0 / place.data_size)
    ce = chunked_xent(p, cfg, h[:, plen:], batch["labels"], batch["mask"],
                      count=count)
    return ce + aux, {"ce": ce, "moe_aux": aux}


class ServeState(NamedTuple):
    caches: List[Any]                        # KV dicts and SSMCaches
    pos: torch.Tensor                        # int32 scalar or (B,)
    enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # whisper


def lm_prefill(p: LMParams, cfg: ArchConfig, tokens: torch.Tensor, *,
               max_len: int, prefix_embeds: Optional[torch.Tensor] = None,
               enc_embeds: Optional[torch.Tensor] = None, place=None
               ) -> Tuple[torch.Tensor, ServeState]:
    """Run the prompt, build the caches. Returns (logits of the last
    position (B, V), state). With `prefix_embeds` (B, P, d) the prompt
    is P + S positions long, so `max_len` must hold them; with
    `enc_embeds` the state carries the encoder's cross K and V. With
    `place`, `p` is this rank's blocks."""
    p = _head(p, place)
    x, positions, enc_kv, _ = _inputs(p, cfg, tokens, prefix_embeds,
                                      enc_embeds, place)
    h, caches = tfm.stack_prefill(p.stack, cfg, x, positions=positions,
                                  max_len=max_len, enc_kv_stacked=enc_kv,
                                  gather=_stack_gather(p, place))
    h = tfm.apply_norm(p.final_norm, cfg, h[:, -1:])
    logits = hidden_to_logits(p, cfg, h)
    return logits[:, 0], ServeState(
        caches=caches, pos=torch.full((), x.shape[1], dtype=torch.int32,
                                      device=x.device), enc_kv=enc_kv)


def lm_decode_step(p: LMParams, cfg: ArchConfig, token: torch.Tensor,
                   state: ServeState, *, place=None
                   ) -> Tuple[torch.Tensor, ServeState]:
    """token: (B,) int. One step; the caches are written in place at
    state.pos. With `place`, `p` is this rank's blocks."""
    p = _head(p, place)
    x = embed_tokens(p, cfg, token[:, None])
    h, caches = tfm.stack_decode(p.stack, cfg, x, state.caches, state.pos,
                                 enc_kv_stacked=state.enc_kv,
                                 gather=_stack_gather(p, place))
    h = tfm.apply_norm(p.final_norm, cfg, h)
    logits = hidden_to_logits(p, cfg, h)[:, 0]
    return logits, ServeState(caches=caches, pos=state.pos + 1,
                              enc_kv=state.enc_kv)


def greedy_generate(p: LMParams, cfg: ArchConfig, prompt: torch.Tensor, *,
                    steps: int, max_len: int, place=None) -> torch.Tensor:
    """Prefill and `steps` greedy tokens: (B, steps + 1) int32."""
    logits, state = lm_prefill(p, cfg, prompt, max_len=max_len, place=place)
    tok = logits.argmax(-1).to(torch.int32)
    toks = [tok]
    for _ in range(steps):
        logits, state = lm_decode_step(p, cfg, tok, state, place=place)
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1)
