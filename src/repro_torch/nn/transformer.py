"""Decoder stack over superblocks of attention and SSM layers.

Parameters are built per superblock *position* and stacked along a leading
`num_superblocks` axis, as in the reference, so the reference's stacked
trees map onto the port's one index for one index; the forward is a Python
loop over superblocks where the reference scans, each superblock under
`torch.utils.checkpoint` in training when `cfg.remat` (the reference's
`jax.checkpoint` of its scan body). Decode caches are stacked
the same way: (num_superblocks, B, S_max, KV, hd) K and V per attention
position, an `SSMCache` (conv window and float32 state) per SSM position,
written in place.

The port covers the 'attn', 'attn_local' and 'ssm' layer kinds (and
'attn_bidir', the encoder's), each followed by the dense MLP or a MoE
(`cfg.layer_uses_moe`), or by nothing (Mamba2), with sandwich
`post_norms` and `zero_centered_norm`. An encoder-decoder's decoder
layers (`cross=True`) put a cross-attention step between the mixer and
the MLP, over the encoder's K and V of their superblock
(`enc_kv_stacked`: (k, v), each (nsb, B, enc_len, KV, hd), from
`encdec.cross_kv`).

On a mesh of ranks each rank holds its blocks of the stacked leaves
(`dist.sharding.Placement`): `stack_forward`, `stack_prefill` and
`stack_decode` then take a `gather`, which turns one superblock's blocks
into its full parameters. It runs inside the superblock's remat region,
so the backward gathers again rather than keeping the whole model, and
only one superblock's full weights exist at a time. With no `gather`
the stack reads its parameters as they are.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import layer_norm, lead_layers, rms_norm
from .config import ArchConfig
from .mlp import mlp_axes, mlp_forward, mlp_init


def norm_init(cfg: ArchConfig, *, device: DeviceLike = None
              ) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    p = {"scale": torch.ones(cfg.d_model, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, device=device)
    return p


def norm_axes(cfg: ArchConfig) -> Dict[str, tuple]:
    p = {"scale": (None,)}
    if cfg.norm == "layernorm":
        p["bias"] = (None,)
    return p


def apply_norm(p: Dict[str, torch.Tensor], cfg: ArchConfig,
               x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"], zero_centered=cfg.zero_centered_norm)


def layer_init(cfg: ArchConfig, pos: int, generator: torch.Generator, *,
               device: DeviceLike = None, dtype: torch.dtype = torch.float32,
               cross: bool = False) -> Dict[str, Any]:
    """One layer at superblock position `pos`: its mixer (attention or
    SSM), with `cross` a cross-attention, then the MLP, a MoE or nothing,
    and the norms; the projection matrices in `dtype`."""
    device = resolve_device(device)
    kind = cfg.superblock[pos]
    init = attn_mod.attn_init if kind.startswith("attn") else ssm_mod.ssm_init
    p: Dict[str, Any] = {"pre_norm": norm_init(cfg, device=device),
                         "mixer": init(cfg, generator, device=device,
                                       dtype=dtype)}
    if cfg.post_norms:
        p["post_norm"] = norm_init(cfg, device=device)
    if cross:
        p["pre_cross_norm"] = norm_init(cfg, device=device)
        p["cross"] = attn_mod.attn_init(cfg, generator, device=device,
                                        dtype=dtype)
    if cfg.layer_uses_moe(pos, kind):
        p["pre_mlp_norm"] = norm_init(cfg, device=device)
        p["mlp"] = moe_mod.moe_init(cfg, generator, device=device,
                                    dtype=dtype)
    elif cfg.d_ff > 0:
        p["pre_mlp_norm"] = norm_init(cfg, device=device)
        p["mlp"] = mlp_init(cfg, generator, device=device, dtype=dtype)
    if cfg.post_norms and "mlp" in p:
        p["post_mlp_norm"] = norm_init(cfg, device=device)
    return p


def layer_axes(cfg: ArchConfig, pos: int, *, cross: bool = False
               ) -> Dict[str, Any]:
    """The logical axes of `layer_init`'s tree, the reference's."""
    kind = cfg.superblock[pos]
    p: Dict[str, Any] = {"pre_norm": norm_axes(cfg),
                         "mixer": (attn_mod.attn_axes(cfg)
                                   if kind.startswith("attn")
                                   else ssm_mod.ssm_axes(cfg))}
    if cfg.post_norms:
        p["post_norm"] = norm_axes(cfg)
    if cross:
        p["pre_cross_norm"] = norm_axes(cfg)
        p["cross"] = attn_mod.attn_axes(cfg)
    if cfg.layer_uses_moe(pos, kind):
        p["pre_mlp_norm"] = norm_axes(cfg)
        p["mlp"] = moe_mod.moe_axes(cfg)
    elif cfg.d_ff > 0:
        p["pre_mlp_norm"] = norm_axes(cfg)
        p["mlp"] = mlp_axes(cfg)
    if cfg.post_norms and "mlp" in p:
        p["post_mlp_norm"] = norm_axes(cfg)
    return p


def stack_axes(cfg: ArchConfig, *, cross: bool = False) -> List[Any]:
    """The logical axes of `stack_init`'s tree: each position's layer
    axes behind a leading "layers" axis."""
    return [lead_layers(layer_axes(cfg, pos, cross=cross))
            for pos in range(len(cfg.superblock))]


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


def unstack_blocks(tree: Any, n: int) -> List[Any]:
    """The n superblocks' trees out of the stacked tree, each leaf split
    by one `torch.unbind`: views, as `slice_block`'s, but under autograd
    the n gradients are stacked once, where n slices would each add a
    stack-sized gradient (n^2 stack rows written in a backward)."""
    if tree is None:
        return [None] * n
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree))
    if isinstance(tree, dict):
        parts = {k: unstack_blocks(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    parts = [unstack_blocks(v, n) for v in tree]
    if type(tree) in (list, tuple):
        return [type(tree)(v[i] for v in parts) for i in range(n)]
    return [type(tree)(*(v[i] for v in parts)) for i in range(n)]


def stack_init(cfg: ArchConfig, generator: torch.Generator, *,
               device: DeviceLike = None, dtype: torch.dtype = torch.float32,
               cross: bool = False) -> List[Dict[str, Any]]:
    """A list over superblock positions; each leaf has a leading
    num_superblocks axis. Layers are drawn in block-major order, each
    copied into its slot of the stacked leaves as it is drawn, so the
    model is never held twice (a gemma2-27b in bf16 is 54 GB)."""
    device = resolve_device(device)
    sb, nsb = len(cfg.superblock), cfg.num_superblocks
    stacked: List[Any] = [None] * sb
    for blk in range(nsb):
        for pos in range(sb):
            layer = layer_init(cfg, pos, generator, device=device,
                               dtype=dtype, cross=cross)
            if blk == 0:
                stacked[pos] = _empty_stack(layer, nsb)
            _put_layer(stacked[pos], blk, layer)
    return stacked


def _empty_stack(tree: Any, n: int) -> Any:
    """Uninitialised leaves of `tree`'s shapes with a leading axis of n."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.new_empty((n, *tree.shape))
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n) for k, v in tree.items()}
    return type(tree)(*(_empty_stack(v, n) for v in tree))


def _put_layer(stacked: Any, i: int, tree: Any) -> None:
    """Copy one layer's `tree` into slot i of `stacked` (`_empty_stack`)."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        stacked[i].copy_(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _put_layer(stacked[k], i, v)
    else:
        for dst, v in zip(stacked, tree):
            _put_layer(dst, i, v)


def _block_kv(enc_kv_stacked: Optional[Tuple[torch.Tensor, torch.Tensor]],
              blk: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Superblock `blk`'s cross-attention K and V (views)."""
    if enc_kv_stacked is None:
        return None
    return enc_kv_stacked[0][blk], enc_kv_stacked[1][blk]


def mixer_residual(p: Dict[str, Any], cfg: ArchConfig, x: torch.Tensor, *,
                   kind: str, positions: torch.Tensor,
                   attention: Optional[Callable] = None) -> torch.Tensor:
    """x plus the layer's mixer branch (attention or SSM), the input of
    its cross-attention, MLP or MoE branch; `attention` as in
    `attn_forward`."""
    h = apply_norm(p["pre_norm"], cfg, x)
    if kind.startswith("attn"):
        h, _, _ = attn_mod.attn_forward(p["mixer"], cfg, h, kind=kind,
                                        positions=positions,
                                        attention=attention)
    else:
        h = ssm_mod.ssm_forward(p["mixer"], cfg, h)
    if cfg.post_norms:
        h = apply_norm(p["post_norm"], cfg, h)
    return x + h


def cross_residual(p: Dict[str, Any], cfg: ArchConfig, x: torch.Tensor,
                   enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]]
                   ) -> torch.Tensor:
    """x plus the layer's cross-attention branch over the encoder's
    (k, v) of its superblock; x itself for a layer without one. The
    reference runs a cross layer as causal self-attention when no frames
    were given; the port raises."""
    if "cross" not in p:
        return x
    if enc_kv is None:
        raise ValueError("a cross-attention layer needs the encoder's K and "
                         "V: pass enc_embeds (the stub frame embeddings)")
    h = apply_norm(p["pre_cross_norm"], cfg, x)
    h, _, _ = attn_mod.attn_forward(p["cross"], cfg, h, kind="attn",
                                    positions=None, cross_kv=enc_kv)
    return x + h


def mlp_residual(p: Dict[str, Any], cfg: ArchConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x plus the layer's MLP or MoE branch: (x, the MoE's aux loss or
    None)."""
    if "mlp" not in p:
        return x, None
    h = apply_norm(p["pre_mlp_norm"], cfg, x)
    aux = None
    if isinstance(p["mlp"], moe_mod.MoEParams):
        h, aux = moe_mod.moe_forward(p["mlp"], cfg, h)
    else:
        h = mlp_forward(p["mlp"], cfg, h)
    if cfg.post_norms:
        h = apply_norm(p["post_mlp_norm"], cfg, h)
    return x + h, aux


def _layer_forward(p: Dict[str, Any], cfg: ArchConfig, x: torch.Tensor, *,
                   kind: str, positions: torch.Tensor,
                   enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual layer. Returns (x, moe_aux), aux 0 without a
    MoE."""
    x = mixer_residual(p, cfg, x, kind=kind, positions=positions)
    x, aux = mlp_residual(p, cfg, cross_residual(p, cfg, x, enc_kv))
    return x, (torch.zeros((), device=x.device) if aux is None else aux)


def superblock_forward(params: List[Dict[str, Any]], cfg: ArchConfig,
                       x: torch.Tensor, aux: torch.Tensor,
                       positions: torch.Tensor,
                       enc_kv: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                       kinds: Optional[Tuple[str, ...]] = None,
                       gather: Optional[Callable] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One superblock's layers (`kinds`, default `cfg.superblock`) on x,
    adding each layer's MoE aux loss to `aux`, as the reference's scan
    body does. Under `cfg.remat` and grad mode, `torch.utils.checkpoint`
    (non-reentrant) keeps only the superblock's inputs and recomputes its
    activations in the backward, the counterpart of the reference's
    `jax.checkpoint`; either way the arithmetic is the same. `gather`
    (on a mesh) turns `params`, this rank's blocks, into the full
    parameters inside that region."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(_superblock, params, cfg, x, aux, positions, enc_kv,
                          kinds, gather, use_reentrant=False,
                          preserve_rng_state=False)
    return _superblock(params, cfg, x, aux, positions, enc_kv, kinds, gather)


def _superblock(params, cfg, x, aux, positions, enc_kv, kinds, gather):
    if gather is not None:
        params = gather(params)
    for pos, kind in enumerate(kinds or cfg.superblock):
        x, a = _layer_forward(params[pos], cfg, x, kind=kind,
                              positions=positions, enc_kv=enc_kv)
        aux = aux + a
    return x, aux


def stack_forward(stacked: List[Dict[str, Any]], cfg: ArchConfig,
                  x: torch.Tensor, *, positions: torch.Tensor,
                  enc_kv_stacked: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                  gather: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (hidden, moe_aux_sum); each superblock
    rematerialised, and gathered on a mesh, as `superblock_forward`
    says."""
    aux = torch.zeros((), device=x.device)
    nsb = cfg.num_superblocks
    for params, kv in zip(unstack_blocks(stacked, nsb),
                          unstack_blocks(enc_kv_stacked, nsb)):
        x, aux = superblock_forward(params, cfg, x, aux, positions, kv,
                                    gather=gather)
    return x, aux


def _gathered(params: Any, gather: Optional[Callable]) -> Any:
    return params if gather is None else gather(params)


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                device: DeviceLike = None) -> List[Any]:
    """Per superblock position: K and V caches (nsb, B, S_max, KV, hd), or
    an SSMCache whose leaves carry the leading nsb axis."""
    device = resolve_device(device)
    nsb = cfg.num_superblocks
    shape = (nsb, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    out: List[Any] = []
    for kind in cfg.superblock:
        if kind.startswith("attn"):
            out.append({"k": torch.zeros(shape, dtype=cfg.dtype,
                                         device=device),
                        "v": torch.zeros(shape, dtype=cfg.dtype,
                                         device=device)})
        else:
            c = ssm_mod.ssm_init_cache(cfg, nsb * batch, device=device)
            out.append(ssm_mod.SSMCache(*(t.unflatten(0, (nsb, batch))
                                          for t in c)))
    return out


def stack_prefill(stacked: List[Dict[str, Any]], cfg: ArchConfig,
                  x: torch.Tensor, *, positions: torch.Tensor, max_len: int,
                  enc_kv_stacked: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                  gather: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, List[Any]]:
    """Prefill: forward and the decode caches. x: (B, S, d); KV cache rows
    [S, max_len) stay zero; an SSM position's cache is its state after
    the last of the S positions. `gather` as in `stack_forward`."""
    b, s, _ = x.shape
    assert max_len >= s, f"cache capacity {max_len} < prompt length {s}"
    caches = init_caches(cfg, b, max_len, device=x.device)
    for blk in range(cfg.num_superblocks):
        params = _gathered(slice_block(stacked, blk), gather)
        enc_kv = _block_kv(enc_kv_stacked, blk)
        for pos, kind in enumerate(cfg.superblock):
            p = params[pos]
            hn = apply_norm(p["pre_norm"], cfg, x)
            if kind.startswith("attn"):
                hn, k, v = attn_mod.attn_forward(p["mixer"], cfg, hn,
                                                 kind=kind,
                                                 positions=positions)
                caches[pos]["k"][blk, :, :s] = k
                caches[pos]["v"][blk, :, :s] = v
            else:
                hn, c = ssm_mod.ssm_forward(p["mixer"], cfg, hn,
                                            return_state=True)
                caches[pos].conv[blk] = c.conv
                caches[pos].state[blk] = c.state
            if cfg.post_norms:
                hn = apply_norm(p["post_norm"], cfg, hn)
            x, _ = mlp_residual(p, cfg, cross_residual(p, cfg, x + hn,
                                                       enc_kv))
    return x, caches


def stack_decode(stacked: List[Dict[str, Any]], cfg: ArchConfig,
                 x: torch.Tensor, caches: List[Any], pos: torch.Tensor,
                 enc_kv_stacked: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                 gather: Optional[Callable] = None
                 ) -> Tuple[torch.Tensor, List[Any]]:
    """One-token decode. x: (B, 1, d); pos: scalar or (B,) write cursors
    (an SSM layer reads none: its state has taken every position so far).
    The caches are updated in place and returned; a cross-attention layer
    reads its superblock's encoder K and V from `enc_kv_stacked`.
    `gather` as in `stack_forward`."""
    for blk in range(cfg.num_superblocks):
        params = _gathered(slice_block(stacked, blk), gather)
        enc_kv = _block_kv(enc_kv_stacked, blk)
        for i, kind in enumerate(cfg.superblock):
            p = params[i]
            hn = apply_norm(p["pre_norm"], cfg, x)
            if kind.startswith("attn"):
                hn, _, _ = attn_mod.attn_decode(
                    p["mixer"], cfg, hn, caches[i]["k"][blk],
                    caches[i]["v"][blk], pos, kind=kind)
            else:
                c = ssm_mod.SSMCache(caches[i].conv[blk],
                                     caches[i].state[blk])
                hn, new = ssm_mod.ssm_decode(p["mixer"], cfg, hn, c)
                c.conv.copy_(new.conv)
                c.state.copy_(new.state)
            if cfg.post_norms:
                hn = apply_norm(p["post_norm"], cfg, hn)
            x = x + hn
            if "cross" in p:
                if enc_kv is None:
                    raise ValueError("a cross-attention layer needs the "
                                     "encoder's K and V (ServeState.enc_kv)")
                hn = apply_norm(p["pre_cross_norm"], cfg, x)
                hn, _, _ = attn_mod.attn_decode(p["cross"], cfg, hn,
                                                *enc_kv, pos, kind="attn",
                                                cross=True)
                x = x + hn
            x, _ = mlp_residual(p, cfg, x)
    return x, caches
