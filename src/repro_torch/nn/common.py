"""Shared building blocks of the LM substrate: norms, activations, rotary
embeddings, soft-capping and the embedding lookup.

Norms compute in float32 and cast back to the input's dtype, as the
reference does.

A parameter is a plain tensor. Its logical axis names, which the
reference keeps beside the value in a `Param`, live in a tree of their
own: each init has an `*_axes` twin (`attention.attn_axes`, `mlp.
mlp_axes`, ... up to `lm.lm_axes`) whose tree has the init's structure
with a tuple of names in place of each tensor, the stacked leaves led by
"layers" (`lead_layers`). `dist.sharding.param_specs` maps the names onto
a mesh and `dist.sharding.Placement` gathers a rank's blocks where the
model reads them. On the `meta` device an init draws nothing and makes
shapes only (`launch.specs.abstract_params`).
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
    device = resolve_device(device)
    if device.type == "meta":            # shapes only: nothing is drawn
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(device, dtype)


def draw_generator(device: torch.device, on_host: bool
                   ) -> Optional[torch.Generator]:
    """The generator an init draws from: on the host (`on_host`) or on
    `device`; None on the `meta` device, where nothing is drawn."""
    if device.type == "meta":
        return None
    return torch.Generator(device="cpu" if on_host else device)


def is_axes(node) -> bool:
    """Whether `node` is one leaf of an axes tree: a plain tuple of
    logical names (named tuples are containers)."""
    return type(node) is tuple


def map_axes(fn, tree):
    """`tree` (dicts, lists, named tuples, None) with fn applied to each
    axes leaf."""
    if tree is None:
        return None
    if is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_axes(fn, v) for v in tree]
    return type(tree)(*(map_axes(fn, v) for v in tree))


def lead_layers(tree):
    """The axes of a stacked tree: a leading "layers" axis on each leaf,
    as the reference's `stack_params` gives its Params."""
    return map_axes(lambda axes: ("layers",) + axes, tree)


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
