"""GQA attention for the LM substrate.

Prefill (`attn_forward`) runs its attention through
`kernels.ops.flash_attention`: the hand-written CUDA kernel for CUDA
tensors, its plain version `flash_attention_ref` for CPU tensors. The
reference computes the same math through its pure-JAX `chunked_attention`
and names its Pallas `flash_attention` as the TPU route; this port takes
the kernel route on the card. One difference of rounding: the reference's
`chunked_attention` multiplies q by `scale` in the compute dtype before
the product, the kernel (as the TPU kernel) scales the float32 scores
after it. At head_dim 64 the scale is 0.125, exact in bf16; at 32 and 128
the two differ by rounding (ROADMAP queue 3). Under grad (training) the
same entry carries the gradient: on the card its backward kernel
`flash_attention_bwd`, on the CPU autograd through the plain version.

Decode (`decode_attention`, Sq == 1) is a plain einsum and softmax over
the cache, as in the reference, which runs it outside any Pallas kernel.

Cross-attention (whisper's decoder over its encoder, `cross_kv=` and
`cross=True`) projects only q, with no rope, and attends over the
encoder's K and V, non-causal: in a prefill through the same
`kops.flash_attention` as self-attention (Sq the decoder's length, Skv
the encoder's frames), in a decode step through `decode_attention` over
every frame.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops

from . import common
from .common import dense_param
from .config import ArchConfig

NEG_INF = -1e9


class AttnParams(NamedTuple):
    wq: torch.Tensor                      # (d, H, hd)
    wk: torch.Tensor                      # (d, KV, hd)
    wv: torch.Tensor                      # (d, KV, hd)
    wo: torch.Tensor                      # (H, hd, d)
    q_norm: Optional[torch.Tensor] = None  # (hd,) qwen3 qk-norm
    k_norm: Optional[torch.Tensor] = None


def attn_init(cfg: ArchConfig, generator: torch.Generator, *,
              device: DeviceLike = None,
              dtype: torch.dtype = torch.float32) -> AttnParams:
    """Projections in `dtype`; the qk-norm scales float32."""
    device = resolve_device(device)
    d, hh, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim_)

    def ones():
        return torch.ones(hd, device=device) if cfg.qk_norm else None

    def dense(*shape):
        return dense_param(shape, generator, device=device, dtype=dtype)
    return AttnParams(wq=dense(d, hh, hd), wk=dense(d, kv, hd),
                      wv=dense(d, kv, hd), wo=dense(hh, hd, d),
                      q_norm=ones(), k_norm=ones())


def attn_axes(cfg: ArchConfig) -> AttnParams:
    """The logical axes of `attn_init`'s tensors, the reference's."""
    norm = (None,) if cfg.qk_norm else None
    return AttnParams(wq=("embed", "heads", None), wk=("embed", "kv", None),
                      wv=("embed", "kv", None), wo=("heads", None, "embed"),
                      q_norm=norm, k_norm=norm)


def _proj(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") in the compute dtype."""
    d, h, k = w.shape
    return (x @ w.to(dt).reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(out: torch.Tensor, wo: torch.Tensor,
              dt: torch.dtype) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") in the compute dtype."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.to(dt).reshape(h * k, d)


def _project_qkv(p: AttnParams, cfg: ArchConfig, x: torch.Tensor):
    dt = cfg.dtype
    q, k, v = _proj(x, p.wq, dt), _proj(x, p.wk, dt), _proj(x, p.wv, dt)
    if p.q_norm is not None:
        q = common.rms_norm(q, p.q_norm)
        k = common.rms_norm(k, p.k_norm)
    return q, k, v


def _window(cfg: ArchConfig, kind: str) -> Optional[int]:
    return cfg.local_window if kind == "attn_local" else None


def attn_forward(p: AttnParams, cfg: ArchConfig, x: torch.Tensor, *,
                 kind: str, positions: torch.Tensor,
                 attention: Optional[Callable] = None,
                 cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Prefill attention. x: (B, S, d) in the compute dtype. Returns
    (out (B, S, d), rope'd k, v (B, S, KV, hd)): the prefill writes the
    decode caches from the k and v it attended over. `attention` replaces
    `kops.flash_attention` (None), for example by its plain version, to
    compare the two on the same layer.

    `cross_kv` (k, v), each (B, enc_len, KV, hd): cross-attention over
    them instead (no rope, non-causal; `kind` and `positions` unused),
    returning them as the k and v."""
    attention = attention or kops.flash_attention
    if cross_kv is not None:
        k, v = cross_kv
        q = _proj(x, p.wq, cfg.dtype)
        if p.q_norm is not None:
            q = common.rms_norm(q, p.q_norm)
        out = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=False)
        return _out_proj(out, p.wo, cfg.dtype), k, v
    q, k, v = _project_qkv(p, cfg, x)
    q = common.apply_rope(q, positions, theta=cfg.rope_theta,
                          fraction=cfg.rope_fraction)
    k = common.apply_rope(k, positions, theta=cfg.rope_theta,
                          fraction=cfg.rope_fraction)
    out = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                    causal=kind != "attn_bidir", window=_window(cfg, kind),
                    softcap=cfg.attn_softcap)
    return _out_proj(out, p.wo, cfg.dtype), k, v


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, window: Optional[int],
                     attn_softcap: Optional[float], pos: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One token over a padded cache. q: (B, 1, H, D); caches (B, S, KV, D);
    pos: a scalar position or (B,) per-slot positions. Slots past pos (or
    outside the window) get an additive -1e9. The products take the
    compute-dtype operands and sum in float32."""
    b, _, hh, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    group = hh // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kvh, group, d) * scale
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    logits = common.softcap(logits, attn_softcap)
    k_pos = torch.arange(s, device=q.device)
    posb = pos.expand(b) if pos.dim() == 0 else pos
    valid = k_pos[None, :] <= posb[:, None]
    if window is not None:
        valid &= k_pos[None, :] > posb[:, None] - window
    bias = torch.where(valid, 0.0, NEG_INF).float()
    attn = torch.softmax(logits + bias[:, None, None, :], dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", attn.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, hh, d).to(q.dtype)


def attn_decode(p: AttnParams, cfg: ArchConfig, x: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: torch.Tensor, *, kind: str, cross: bool = False):
    """One-token decode. x: (B, 1, d); pos: scalar or (B,) write cursors.
    Writes this token's K and V into the caches IN PLACE at pos (the
    reference returns updated copies; its jitted step donates them) and
    returns (out, k_cache, v_cache).

    `cross`: the caches are the encoder's K and V; the token attends over
    every frame (no rope, nothing written, `pos` unused)."""
    if cross:
        q = _proj(x, p.wq, cfg.dtype)
        if p.q_norm is not None:
            q = common.rms_norm(q, p.q_norm)
        last = torch.tensor(k_cache.shape[1] - 1, device=x.device)
        out = decode_attention(q, k_cache, v_cache, window=None,
                               attn_softcap=None, pos=last)
        return _out_proj(out, p.wo, cfg.dtype), k_cache, v_cache
    q, k, v = _project_qkv(p, cfg, x)
    b = x.shape[0]
    posv = pos[None] if pos.dim() == 0 else pos[:, None]     # (1,) or (B, 1)
    q = common.apply_rope(q, posv, theta=cfg.rope_theta,
                          fraction=cfg.rope_fraction)
    k = common.apply_rope(k, posv, theta=cfg.rope_theta,
                          fraction=cfg.rope_fraction)
    # dynamic_update_slice clamps the cursor into the cache
    at = pos.expand(b).clamp(0, k_cache.shape[1] - 1)
    slots = torch.arange(b, device=x.device)
    k_cache[slots, at] = k[:, 0].to(k_cache.dtype)
    v_cache[slots, at] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, window=_window(cfg, kind),
                           attn_softcap=cfg.attn_softcap, pos=pos)
    return _out_proj(out, p.wo, cfg.dtype), k_cache, v_cache
