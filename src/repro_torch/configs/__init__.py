"""Model configs: the paper's GNNs (`configs/gnn.py`) and the LM
architecture registry (`ARCHS`, `get_config`, `reduced`).

The registry holds every family of the reference, each with its
published dimensions: smollm-135m, qwen3-4b, gemma2-27b, chatglm3-6b
(dense), olmoe-1b-7b, llama4-scout-17b-a16e (moe), mamba2-2.7b (ssm),
jamba-v0.1-52b (hybrid), phi-3-vision-4.2b (vlm) and whisper-base (audio,
encoder-decoder).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.nn.config import ArchConfig, EncoderConfig

from . import (chatglm3_6b, gemma2_27b, jamba_v0p1_52b, llama4_scout_17b_a16e,
               mamba2_2p7b, olmoe_1b_7b, phi3_vision_4p2b, qwen3_4b,
               smollm_135m, whisper_base)

ARCHS: Dict[str, ArchConfig] = {
    "gemma2-27b": gemma2_27b.CONFIG,
    "chatglm3-6b": chatglm3_6b.CONFIG,
    "qwen3-4b": qwen3_4b.CONFIG,
    "smollm-135m": smollm_135m.CONFIG,
    "mamba2-2.7b": mamba2_2p7b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.CONFIG,
    "jamba-v0.1-52b": jamba_v0p1_52b.CONFIG,
    "phi-3-vision-4.2b": phi3_vision_4p2b.CONFIG,
    "whisper-base": whisper_base.CONFIG,
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ArchConfig, *, layers: int | None = None) -> ArchConfig:
    """The reference's smoke-test shrink: the same layer pattern and
    feature flags (GQA ratio, qk-norm, softcaps, partial rope, sandwich
    norms, MoE top-k and shared expert, SSD grouping), tiny widths,
    float32, the loss in chunks of 64 and no remat. A MoE keeps at most 8
    experts and top-2 at width 128, in groups of 64 with capacity factor
    4.0 (no token drops, so a prefill group and a decode group route
    alike); an SSM takes d_state 16, headdim 16 and chunk 32; a vision
    model 16 patches, an encoder 2 layers over 64 frames."""
    sb = len(cfg.superblock)
    nl = layers if layers is not None else 2 * sb
    nl = max(sb, (nl // sb) * sb)
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = max(kv, 4 if cfg.num_heads >= 4 else cfg.num_heads)
    heads = (heads // kv) * kv
    changes = dict(
        num_layers=nl, d_model=128, num_heads=heads, num_kv_heads=kv,
        head_dim=32, d_ff=(256 if cfg.d_ff > 0 else 0), vocab_size=512,
        local_window=(64 if cfg.local_window else None), num_patches=16,
        loss_chunk=64, remat=False, compute_dtype="float32")
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=128,
            shared_expert_ff=(128 if cfg.moe.shared_expert_ff else 0),
            group_size=64, capacity_factor=4.0)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, headdim=16, chunk=32)
    if cfg.encoder is not None:
        changes["encoder"] = EncoderConfig(num_layers=2, frames=64)
    return dataclasses.replace(cfg, **changes)


__all__ = ["ARCHS", "get_config", "reduced", "ArchConfig"]
