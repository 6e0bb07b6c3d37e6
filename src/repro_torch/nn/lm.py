"""Top-level language model of the dense family: embeddings, the
superblock stack, logits, and the serving pair prefill / decode step.

The vision prefix (`prefix_embeds`), the audio encoder (`enc_embeds`) and
the training loss (`chunked_xent`, `lm_loss`) wait for ROADMAP queue 1
items 14 and 13.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

from . import transformer as tfm
from .common import dense_param, softcap, take_embedding
from .config import ArchConfig, require_ported
from .mlp import MLPParams


class LMParams(NamedTuple):
    embed: torch.Tensor                      # (V, d)
    stack: List[Dict[str, Any]]
    final_norm: Dict[str, torch.Tensor]
    unembed: Optional[torch.Tensor] = None   # (d, V) when not tied
    # (d, V) float32 copy of the compute-dtype unembedding, made once by
    # `to_compute_dtype`; None: `hidden_to_logits` rounds on every call
    logits_w: Optional[torch.Tensor] = None


def lm_init(cfg: ArchConfig, *, seed: int = 0,
            device: DeviceLike = None) -> LMParams:
    """Random float32 weights from a `torch.Generator` (the port's own
    init; the reference's `jax.random` draws differ) on `device`, the card
    when None."""
    require_ported(cfg)
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    embed = dense_param((cfg.vocab_size, cfg.d_model), g, scale=1.0,
                        device=device)
    return LMParams(
        embed=embed, stack=tfm.stack_init(cfg, g, device=device),
        final_norm=tfm.norm_init(cfg, device=device),
        unembed=(None if cfg.tie_embeddings else
                 dense_param((cfg.d_model, cfg.vocab_size), g,
                             device=device)))


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


def to_compute_dtype(p: LMParams, cfg: ArchConfig) -> LMParams:
    """The same parameters with the embedding and every projection matrix
    rounded to the compute dtype once, and `logits_w` made, so that a
    prefill or decode step converts no weight. Every call rounded them the
    same way, so the results are bit for bit those of `p`. Norm scales
    stay float32."""
    dt = cfg.dtype

    def layer(node: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(node)
        m = node["mixer"]
        out["mixer"] = m._replace(wq=m.wq.to(dt), wk=m.wk.to(dt),
                                  wv=m.wv.to(dt), wo=m.wo.to(dt))
        if "mlp" in node:
            out["mlp"] = MLPParams(*(None if w is None else w.to(dt)
                                     for w in node["mlp"]))
        return out
    unembed = p.embed.T if p.unembed is None else p.unembed
    return p._replace(embed=p.embed.to(dt),
                      stack=[layer(n) for n in p.stack],
                      logits_w=unembed.to(dt).float())


def lm_hidden(p: LMParams, cfg: ArchConfig, tokens: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (final-normed hidden (B, S, d), moe_aux, prefix_len 0)."""
    x = embed_tokens(p, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    h, aux = tfm.stack_forward(p.stack, cfg, x, positions=positions)
    return tfm.apply_norm(p.final_norm, cfg, h), aux, 0


class ServeState(NamedTuple):
    caches: List[Dict[str, torch.Tensor]]
    pos: torch.Tensor                        # int32 scalar or (B,)


def lm_prefill(p: LMParams, cfg: ArchConfig, tokens: torch.Tensor, *,
               max_len: int) -> Tuple[torch.Tensor, ServeState]:
    """Run the prompt, build the caches. Returns (logits of the last
    position (B, V), state)."""
    x = embed_tokens(p, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    h, caches = tfm.stack_prefill(p.stack, cfg, x, positions=positions,
                                  max_len=max_len)
    h = tfm.apply_norm(p.final_norm, cfg, h[:, -1:])
    logits = hidden_to_logits(p, cfg, h)
    return logits[:, 0], ServeState(
        caches=caches, pos=torch.full((), x.shape[1], dtype=torch.int32,
                                      device=x.device))


def lm_decode_step(p: LMParams, cfg: ArchConfig, token: torch.Tensor,
                   state: ServeState) -> Tuple[torch.Tensor, ServeState]:
    """token: (B,) int. One step; the caches are written in place at
    state.pos."""
    x = embed_tokens(p, cfg, token[:, None])
    h, caches = tfm.stack_decode(p.stack, cfg, x, state.caches, state.pos)
    h = tfm.apply_norm(p.final_norm, cfg, h)
    logits = hidden_to_logits(p, cfg, h)[:, 0]
    return logits, ServeState(caches=caches, pos=state.pos + 1)


def greedy_generate(p: LMParams, cfg: ArchConfig, prompt: torch.Tensor, *,
                    steps: int, max_len: int) -> torch.Tensor:
    """Prefill and `steps` greedy tokens: (B, steps + 1) int32."""
    logits, state = lm_prefill(p, cfg, prompt, max_len=max_len)
    tok = logits.argmax(-1).to(torch.int32)
    toks = [tok]
    for _ in range(steps):
        logits, state = lm_decode_step(p, cfg, tok, state)
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1)
