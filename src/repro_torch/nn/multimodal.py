"""Modality frontend stubs, as in the reference.

phi-3-vision and whisper-base specify the transformer backbone only; the
CLIP and conv-mel frontends are stubs whose outputs, precomputed patch and
frame embeddings, the caller passes to `lm_prefill` (`prefix_embeds=`,
`enc_embeds=`). These make seeded synthetic embeddings of the right shape
and dtype, unit normal over sqrt(d_model), from a `torch.Generator` on the
caller's device; the reference's `jax.random` draws differ, so tests feed
both packages the same numpy embeddings. The reference's dry-run
ShapeDtypeStructs (`vision_spec`, `audio_spec`) wait for the port's
`launch/specs.py`, which goes with the multi-pod dry run (ROADMAP queue
1 item 16).
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import DeviceLike, resolve_device

from .config import ArchConfig


def _stub(cfg: ArchConfig, shape, seed: int, device: DeviceLike
          ) -> torch.Tensor:
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device)
    return (x / math.sqrt(cfg.d_model)).to(cfg.dtype)


def vision_patch_embeddings(cfg: ArchConfig, batch: int, *, seed: int = 0,
                            device: DeviceLike = None) -> torch.Tensor:
    """Stub CLIP output: (B, num_patches, d_model) in the compute dtype."""
    return _stub(cfg, (batch, cfg.num_patches, cfg.d_model), seed, device)


def audio_frame_embeddings(cfg: ArchConfig, batch: int, frames: int, *,
                           seed: int = 0,
                           device: DeviceLike = None) -> torch.Tensor:
    """Stub conv-frontend output: (B, frames, d_model) in the compute
    dtype; drawn from seed + 1, as the reference's."""
    return _stub(cfg, (batch, frames, cfg.d_model), seed + 1, device)
