"""Dense MLP blocks (gated SwiGLU/GeGLU or plain), in the compute dtype."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

from .common import activation, dense_param
from .config import ArchConfig


class MLPParams(NamedTuple):
    w_in: torch.Tensor                  # (d, ff): the gate when gated
    w_up: Optional[torch.Tensor]        # (d, ff): gated only
    w_out: torch.Tensor                 # (ff, d)


def mlp_init(cfg: ArchConfig, generator: torch.Generator, *,
             device: DeviceLike = None, d_ff: Optional[int] = None,
             dtype: torch.dtype = torch.float32) -> MLPParams:
    """Width `d_ff` (default `cfg.d_ff`; a MoE's shared expert passes its
    own), the matrices in `dtype`."""
    device = resolve_device(device)
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff

    def dense(*shape):
        return dense_param(shape, generator, device=device, dtype=dtype)
    return MLPParams(w_in=dense(d, ff),
                     w_up=dense(d, ff) if cfg.gated_mlp else None,
                     w_out=dense(ff, d))


def mlp_axes(cfg: ArchConfig) -> MLPParams:
    """The logical axes of `mlp_init`'s tensors, the reference's."""
    return MLPParams(w_in=("embed", "ff"),
                     w_up=("embed", "ff") if cfg.gated_mlp else None,
                     w_out=("ff", "embed"))


def mlp_forward(p: MLPParams, cfg: ArchConfig, x: torch.Tensor
                ) -> torch.Tensor:
    dt = cfg.dtype
    act = activation(cfg.act)
    h = act(x @ p.w_in.to(dt))
    if p.w_up is not None:
        h = h * (x @ p.w_up.to(dt))
    return h @ p.w_out.to(dt)
