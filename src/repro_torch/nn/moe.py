"""Mixture-of-Experts with dense one-hot dispatch and a fixed capacity.

Routing tokens to experts is a gather/scatter problem, the control-heavy
kind of operation GraNNite rewrites (EffOp). Here dispatch and combine
are dense masked products, as in the reference:

  * dispatch = a one-hot (position in the expert's queue) mask, and
    combine its gate-weighted twin: no gather, no scatter, no sort of
    the tokens;
  * every expert buffer holds a fixed capacity C = ceil8(G * top_k *
    capacity_factor / E) per token group; tokens past it drop, empty
    slots stay zero (NodePad's "0 = no edge");
  * the masks are tensors made from the router's output at run time.

Tokens go in groups of `group_size` G, so the dispatch costs T*G*k*cf*d
operations rather than T^2*k*cf*d. The groups are one batched einsum over
their leading axis (the reference's `vmap`). The reference computes all
of it as plain einsums outside any Pallas kernel; the port does the same
with `torch.einsum`. On a mesh of ranks the experts are placed by
their logical axes (`moe_axes`: "experts" over the axis
`dist.sharding.set_expert_axis` names) and gathered a superblock at a
time (`dist.sharding.Placement`), so every rank computes its rows
through every expert; the reference's sharding constraint on the groups
has no counterpart.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device

from .common import activation, dense_param
from .config import ArchConfig, MoEConfig
from .mlp import MLPParams, mlp_axes, mlp_forward, mlp_init


class MoEParams(NamedTuple):
    w_router: torch.Tensor           # (d, E)
    w_in: torch.Tensor               # (E, d, ff)
    w_up: Optional[torch.Tensor]     # (E, d, ff): gated only
    w_out: torch.Tensor              # (E, ff, d)
    shared: Optional[MLPParams]      # llama4's always-on shared expert


def moe_init(cfg: ArchConfig, generator: torch.Generator, *,
             device: DeviceLike = None,
             dtype: torch.dtype = torch.float32) -> MoEParams:
    """The port's own init, every matrix in `dtype`. As in the
    reference, an expert tensor's fan-in is its leading axis (E)."""
    device = resolve_device(device)
    m = cfg.moe
    d, e, ff = cfg.d_model, m.num_experts, m.d_ff_expert

    def dense(*shape):
        return dense_param(shape, generator, device=device, dtype=dtype)
    return MoEParams(
        w_router=dense(d, e), w_in=dense(e, d, ff),
        w_up=dense(e, d, ff) if cfg.gated_mlp else None,
        w_out=dense(e, ff, d),
        shared=(mlp_init(cfg, generator, device=device,
                         d_ff=m.shared_expert_ff, dtype=dtype)
                if m.shared_expert_ff else None))


def moe_axes(cfg: ArchConfig) -> MoEParams:
    """The logical axes of `moe_init`'s tensors, the reference's."""
    m = cfg.moe
    expert = ("experts", "embed", "ff")
    return MoEParams(
        w_router=("embed", None), w_in=expert,
        w_up=expert if cfg.gated_mlp else None,
        w_out=("experts", "ff", "embed"),
        shared=mlp_axes(cfg) if m.shared_expert_ff else None)


def capacity(m: MoEConfig, group: int) -> int:
    """Slots per expert and group, padded to a multiple of 8."""
    c = int(group * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def _route(m: MoEConfig, logits: torch.Tensor):
    """logits (..., G, E) -> (gates (..., G, k), idx (..., G, k), probs
    (..., G, E)). Among equal probabilities the lower expert index wins,
    as `jax.lax.top_k` picks it: a stable descending sort, where
    `torch.topk` promises no order."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :m.top_k], idx[..., :m.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


def _dispatch_masks(m: MoEConfig, gates: torch.Tensor, idx: torch.Tensor,
                    cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """gates, idx (NG, G, k) -> dispatch 0/1 and gate-weighted combine
    masks (NG, G, E, C), float32. A (token, slot)'s place in its expert's
    queue counts the earlier assignments, slot-major, then in token
    order; places at or past `cap` drop."""
    ng, g, k = idx.shape
    e = m.num_experts
    sel = F.one_hot(idx, e).float()                           # (NG,G,k,E)
    flat = sel.transpose(1, 2).reshape(ng, k * g, e)          # slot-major
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(
        ng, k, g, e).transpose(1, 2)                          # (NG,G,k,E)
    within = (pos < cap).float() * sel
    pos_cap = (pos * within).sum(-1)                          # (NG,G,k)
    slot_oh = F.one_hot(pos_cap.long(), cap).float()          # (NG,G,k,C)
    keep = within.sum(-1)                                     # (NG,G,k)
    dispatch = torch.einsum("ngke,ngkc->ngec", within, slot_oh)
    combine = torch.einsum("ngke,ngkc,ngk->ngec", within, slot_oh,
                           gates * keep)
    return dispatch, combine


def _aux_losses(m: MoEConfig, probs: torch.Tensor, idx: torch.Tensor,
                logits: torch.Tensor) -> torch.Tensor:
    """Load-balance and router-z losses per group: (NG,)."""
    e = m.num_experts
    density = F.one_hot(idx, e).float().mean(dim=(1, 2))      # routed share
    density_probs = probs.mean(dim=1)                         # router mass
    lb = e * (density * density_probs).sum(-1)
    z = torch.logsumexp(logits.float(), dim=-1).square().mean(-1)
    return m.router_aux_weight * lb + m.router_z_weight * z


def _groups(m: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> the token groups (NG, G, d), G = min(group_size,
    B*S)."""
    b, s, d = x.shape
    t = b * s
    g = min(m.group_size, t)
    assert t % g == 0, (t, g)
    return x.reshape(t // g, g, d)


def routes(p: MoEParams, cfg: ArchConfig, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where `moe_forward` sends each token of x (B, S, d): its experts,
    best first (B*S, top_k), and which experts kept it within their
    capacity, 0/1 (B*S, E). Inspection only: it lets a caller compare the
    routes of two computations of the same layer."""
    m = cfg.moe
    xg = _groups(m, x)
    gates, idx, _ = _route(m, xg @ p.w_router.to(cfg.dtype))
    dispatch, _ = _dispatch_masks(m, gates, idx, capacity(m, xg.shape[1]))
    return idx.flatten(0, 1), dispatch.sum(-1).flatten(0, 1)


def moe_forward(p: MoEParams, cfg: ArchConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux loss), grouped dense dispatch."""
    m = cfg.moe
    dt = cfg.dtype
    act = activation(cfg.act)
    b, s, d = x.shape
    xg = _groups(m, x)
    cap = capacity(m, xg.shape[1])
    logits = xg @ p.w_router.to(dt)                           # (NG,G,E)
    gates, idx, probs = _route(m, logits)
    dispatch, combine = _dispatch_masks(m, gates, idx, cap)
    # dispatch: (G,E,C)^T @ (G,d) -> (E,C,d), a product, per group
    buf = torch.einsum("ngec,ngd->necd", dispatch.to(dt), xg)
    h = torch.einsum("necd,edf->necf", buf, p.w_in.to(dt))
    if p.w_up is not None:
        h = act(h) * torch.einsum("necd,edf->necf", buf, p.w_up.to(dt))
    else:
        h = act(h)
    out = torch.einsum("necf,efd->necd", h, p.w_out.to(dt))
    # combine: the gate-weighted transpose of the same mask
    y = torch.einsum("ngec,necd->ngd", combine.to(dt), out).reshape(b, s, d)
    if p.shared is not None:
        y = y + mlp_forward(p.shared, cfg, x)
    return y, _aux_losses(m, probs, idx, logits).mean()
