"""AdamW, learning-rate schedules and global-norm clipping as plain
functions on trees of tensors.

Port of the reference's `optim/adamw.py`. A tree is a tensor or a nested
dict, list or tuple of them; the state mirrors the parameters' tree
(`m`, `v`) beside an int32 step `count`. The update keeps the
reference's order of operations, `p - lr * (step + weight_decay * p)`
with the bias corrections from a float32 count, so its rounding is the
reference's; `torch.optim.AdamW` decays first and rounds otherwise.
Call `adamw_update` under `torch.no_grad()` when the parameters require
gradients.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

Tree = Any
OptState = Dict[str, Any]
Scalar = Union[float, torch.Tensor]


def adamw_init(params: Tree) -> OptState:
    device = tree_leaves(params)[0].device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params: Tree, grads: Tree, state: OptState, *,
                 lr: Scalar = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0
                 ) -> Tuple[Tree, OptState]:
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)

    def upd(p, g, m, v):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        return p - lr * (step + weight_decay * p), m, v

    flat, spec = tree_flatten(params)
    out = [upd(*a) for a in zip(flat, *(tree_leaves(t) for t in (
        grads, state["m"], state["v"])))]
    new_p, new_m, new_v = (tree_unflatten([o[i] for o in out], spec)
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "count": count}


def clip_by_global_norm(grads: Tree, max_norm: float, *,
                        gnorm: Optional[torch.Tensor] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """grads scaled so that their global norm is at most `max_norm`, and
    the norm. `gnorm` given (on a mesh: the norm over every rank's
    blocks) replaces the norm of `grads` themselves."""
    if gnorm is None:
        gnorm = torch.sqrt(sum_of_squares(tree_leaves(grads)))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def sum_of_squares(leaves) -> torch.Tensor:
    """The float32 sum of every entry's square over `leaves`."""
    return sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves)


def cosine_schedule(step: Union[int, torch.Tensor], *, base_lr: float,
                    total_steps: int, min_frac: float = 0.1
                    ) -> torch.Tensor:
    step = torch.as_tensor(step)
    t = torch.clamp(step.to(torch.float32) / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return base_lr * (min_frac + (1.0 - min_frac) * cos)


def linear_warmup_cosine(step: Union[int, torch.Tensor], *, base_lr: float,
                         warmup_steps: int, total_steps: int,
                         min_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step)
    warm = base_lr * (step.to(torch.float32) + 1.0) / max(warmup_steps, 1)
    decay = cosine_schedule(step - warmup_steps, base_lr=base_lr,
                            total_steps=max(total_steps - warmup_steps, 1),
                            min_frac=min_frac)
    return torch.where(step < warmup_steps, warm, decay)
