"""Shared building blocks of the LM substrate: norms, activations, rotary
embeddings, soft-capping and the embedding lookup.

Norms compute in float32 and cast back to the input's dtype, as the
reference does. The reference's logical-axis `Param` machinery is multi-card
placement (ROADMAP queue 1 item 16): here a parameter is a plain tensor.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device


def dense_param(shape: Sequence[int], generator: torch.Generator, *,
                scale: Optional[float] = None, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init on `device` (None: the
    card): the port's own init; it does not reproduce `jax.random`. The
    draws are float32, made on the generator's device, and rounded to
    `dtype` at once."""
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(resolve_device(device), dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    g = scale.float()
    y = y * (1.0 + g) if zero_centered else y * g
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# `gelu` is `jax.nn.gelu`, whose default is the tanh approximation
ACTIVATIONS = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu,
               "gelu_tanh": _gelu_tanh}


def activation(name: str):
    return ACTIVATIONS[name]


def rope_frequencies(head_dim: int, *, theta: float, fraction: float = 1.0,
                     device: Optional[torch.device] = None):
    """(inverse frequencies (rot/2,) float32, rotated width rot)."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S) absolute positions.

    Rotates the first `fraction * D` dims (chatglm: 0.5), NeoX half-split
    layout. cos and sin are cast to x's dtype before they multiply, as in
    the reference, so a bf16 x stays bf16."""
    d = x.shape[-1]
    inv, rot = rope_frequencies(d, theta=theta, fraction=fraction,
                                device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., :rot // 2], x_rot[..., rot // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x_pass],
                     dim=-1)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def take_embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup, a gather (the reference's note: a one-hot
    product would cost B*S*V*d operations)."""
    return table[tokens]
