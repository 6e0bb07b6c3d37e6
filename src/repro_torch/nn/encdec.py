"""Encoder-decoder support (the whisper-base backbone).

The modality frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings (B, frames, d_model) (`multimodal.
audio_frame_embeddings` makes seeded ones) in place of the conv1d x 2 and
sinusoid frontend. The encoder backbone is real: `encoder.num_layers`
bidirectional attention layers ('attn_bidir', rope over the frame
positions, every attention through `kops.flash_attention`, non-causal)
with their MLPs, then a final norm.

In training each encoder superblock is rematerialised as the decoder's
are (`transformer.superblock_forward`, `cfg.remat`).

The decoder's cross-attention K and V are computed once from the encoder
output, per decoder superblock, stacked along the leading superblock axis
(`cross_kv`): a prefill attends over them through the kernel, and every
decode step reads the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

from . import transformer as tfm
from .config import ArchConfig


def encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder stack's config, derived from the decoder's."""
    return dataclasses.replace(cfg, num_layers=cfg.encoder.num_layers,
                               layer_pattern="global", moe=None, encoder=None)


def encoder_init(cfg: ArchConfig, generator: torch.Generator, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """{"stack": the encoder's stacked layers, "final_norm": its norm}."""
    device = resolve_device(device)
    ecfg = encoder_cfg(cfg)
    return {"stack": tfm.stack_init(ecfg, generator, device=device,
                                    dtype=dtype),
            "final_norm": tfm.norm_init(ecfg, device=device)}


def encoder_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """The logical axes of `encoder_init`'s tree."""
    ecfg = encoder_cfg(cfg)
    return {"stack": tfm.stack_axes(ecfg), "final_norm": tfm.norm_axes(ecfg)}


def encoder_forward(enc_params: Dict[str, Any], cfg: ArchConfig,
                    frame_embeds: torch.Tensor, *,
                    gather: Optional[Callable] = None) -> torch.Tensor:
    """frame_embeds: (B, frames, d) stub output in the compute dtype ->
    the encoder's final-normed hidden states (B, frames, d). `gather` (on
    a mesh) turns one encoder superblock's blocks into its parameters, as
    `transformer.stack_forward`'s does."""
    ecfg = encoder_cfg(cfg)
    h = frame_embeds
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), device=h.device)
    kinds = ("attn_bidir",) * len(ecfg.superblock)
    for params in tfm.unstack_blocks(enc_params["stack"],
                                     ecfg.num_superblocks):
        h, aux = tfm.superblock_forward(params, ecfg, h, aux, positions,
                                        kinds=kinds, gather=gather)
    return tfm.apply_norm(enc_params["final_norm"], ecfg, h)


def cross_kv(stacked: List[Dict[str, Any]], cfg: ArchConfig,
             enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder's cross-attention K and V over `enc_out` (B, enc_len,
    d): each (nsb, B, enc_len, KV, hd), contiguous. The whisper decoder's
    superblock is ('attn',), so position 0 holds the cross params."""
    dt, cross = cfg.dtype, stacked[0]["cross"]
    return tuple(torch.einsum("bsd,ldhk->lbshk", enc_out, w.to(dt))
                 .contiguous() for w in (cross.wk, cross.wv))
