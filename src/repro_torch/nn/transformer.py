"""Decoder stack over superblocks, the dense family's layers.

Parameters are built per superblock *position* and stacked along a leading
`num_superblocks` axis, as in the reference, so the reference's stacked
trees map onto the port's one index for one index; the forward is a Python
loop over superblocks where the reference scans. Decode caches are
(num_superblocks, B, S_max, KV, hd) per attention position, written in
place at each slot's cursor.

The port covers the 'attn' and 'attn_local' layer kinds with the MLP,
sandwich `post_norms` and `zero_centered_norm`. An SSM layer, a MoE layer
or cross-attention raises NotImplementedError (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

from . import attention as attn_mod
from .common import layer_norm, rms_norm
from .config import ArchConfig, require_ported
from .mlp import MLPParams, mlp_forward, mlp_init


def norm_init(cfg: ArchConfig, *, device: DeviceLike = None
              ) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    p = {"scale": torch.ones(cfg.d_model, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, device=device)
    return p


def apply_norm(p: Dict[str, torch.Tensor], cfg: ArchConfig,
               x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"], zero_centered=cfg.zero_centered_norm)


def layer_init(cfg: ArchConfig, pos: int, generator: torch.Generator, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """One layer at superblock position `pos`: attention, MLP and norms."""
    require_ported(cfg)
    device = resolve_device(device)
    p: Dict[str, Any] = {"pre_norm": norm_init(cfg, device=device),
                         "mixer": attn_mod.attn_init(cfg, generator,
                                                     device=device)}
    if cfg.post_norms:
        p["post_norm"] = norm_init(cfg, device=device)
    if cfg.d_ff > 0:
        p["pre_mlp_norm"] = norm_init(cfg, device=device)
        p["mlp"] = mlp_init(cfg, generator, device=device)
        if cfg.post_norms:
            p["post_mlp_norm"] = norm_init(cfg, device=device)
    return p


def _stack(trees: List[Any]) -> Any:
    """Stack per-layer trees (dicts, NamedTuples, tensors, None) along a
    new leading axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return type(first)(*(_stack(list(f)) for f in zip(*trees)))


def slice_block(tree: Any, blk: int) -> Any:
    """One superblock's parameters (or caches) out of the stacked tree:
    views, no copies."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[blk]
    if isinstance(tree, dict):
        return {k: slice_block(v, blk) for k, v in tree.items()}
    if isinstance(tree, list):
        return [slice_block(v, blk) for v in tree]
    return type(tree)(*(slice_block(v, blk) for v in tree))


def stack_init(cfg: ArchConfig, generator: torch.Generator, *,
               device: DeviceLike = None) -> List[Dict[str, Any]]:
    """A list over superblock positions; each leaf has a leading
    num_superblocks axis. Layers are drawn in block-major order."""
    device = resolve_device(device)
    sb = len(cfg.superblock)
    layers = [[layer_init(cfg, pos, generator, device=device)
               for pos in range(sb)] for _ in range(cfg.num_superblocks)]
    return [_stack([blk[pos] for blk in layers]) for pos in range(sb)]


def _mlp_residual(p: Dict[str, Any], cfg: ArchConfig,
                  x: torch.Tensor) -> torch.Tensor:
    if "mlp" not in p:
        return x
    if not isinstance(p["mlp"], MLPParams):
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP "
                                  "queue 1 item 14)")
    h = mlp_forward(p["mlp"], cfg, apply_norm(p["pre_mlp_norm"], cfg, x))
    if cfg.post_norms:
        h = apply_norm(p["post_mlp_norm"], cfg, h)
    return x + h


def _check_kind(p: Dict[str, Any], kind: str) -> None:
    if not kind.startswith("attn") or "cross" in p:
        raise NotImplementedError(
            f"layer kind {kind!r} and cross-attention layers are not ported "
            "yet (ROADMAP queue 1 item 14)")


def _layer_forward(p: Dict[str, Any], cfg: ArchConfig, x: torch.Tensor, *,
                   kind: str, positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual layer. Returns (x, moe_aux), aux 0 here."""
    _check_kind(p, kind)
    h, _, _ = attn_mod.attn_forward(p["mixer"], cfg,
                                    apply_norm(p["pre_norm"], cfg, x),
                                    kind=kind, positions=positions)
    if cfg.post_norms:
        h = apply_norm(p["post_norm"], cfg, h)
    x = _mlp_residual(p, cfg, x + h)
    return x, torch.zeros((), device=x.device)


def stack_forward(stacked: List[Dict[str, Any]], cfg: ArchConfig,
                  x: torch.Tensor, *, positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (hidden, moe_aux_sum)."""
    aux = torch.zeros((), device=x.device)
    for blk in range(cfg.num_superblocks):
        params = slice_block(stacked, blk)
        for pos, kind in enumerate(cfg.superblock):
            x, a = _layer_forward(params[pos], cfg, x, kind=kind,
                                  positions=positions)
            aux = aux + a
    return x, aux


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                device: DeviceLike = None
                ) -> List[Dict[str, torch.Tensor]]:
    """Per superblock position: K and V caches (nsb, B, S_max, KV, hd)."""
    require_ported(cfg)
    device = resolve_device(device)
    shape = (cfg.num_superblocks, batch, max_len, cfg.num_kv_heads,
             cfg.head_dim_)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in cfg.superblock]


def stack_prefill(stacked: List[Dict[str, Any]], cfg: ArchConfig,
                  x: torch.Tensor, *, positions: torch.Tensor, max_len: int
                  ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Prefill: forward and the decode caches. x: (B, S, d); cache rows
    [S, max_len) stay zero."""
    b, s, _ = x.shape
    assert max_len >= s, f"cache capacity {max_len} < prompt length {s}"
    caches = init_caches(cfg, b, max_len, device=x.device)
    for blk in range(cfg.num_superblocks):
        params = slice_block(stacked, blk)
        for pos, kind in enumerate(cfg.superblock):
            p = params[pos]
            _check_kind(p, kind)
            hn, k, v = attn_mod.attn_forward(
                p["mixer"], cfg, apply_norm(p["pre_norm"], cfg, x),
                kind=kind, positions=positions)
            caches[pos]["k"][blk, :, :s] = k
            caches[pos]["v"][blk, :, :s] = v
            if cfg.post_norms:
                hn = apply_norm(p["post_norm"], cfg, hn)
            x = _mlp_residual(p, cfg, x + hn)
    return x, caches


def stack_decode(stacked: List[Dict[str, Any]], cfg: ArchConfig,
                 x: torch.Tensor, caches: List[Dict[str, torch.Tensor]],
                 pos: torch.Tensor
                 ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One-token decode. x: (B, 1, d); pos: scalar or (B,) write cursors.
    The caches are updated in place and returned."""
    for blk in range(cfg.num_superblocks):
        params = slice_block(stacked, blk)
        for i, kind in enumerate(cfg.superblock):
            p = params[i]
            _check_kind(p, kind)
            hn = apply_norm(p["pre_norm"], cfg, x)
            hn, _, _ = attn_mod.attn_decode(
                p["mixer"], cfg, hn, caches[i]["k"][blk],
                caches[i]["v"][blk], pos, kind=kind)
            if cfg.post_norms:
                hn = apply_norm(p["post_norm"], cfg, hn)
            x = _mlp_residual(p, cfg, x + hn)
    return x, caches
