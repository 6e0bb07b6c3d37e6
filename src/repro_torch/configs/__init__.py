"""Model configs: the paper's GNNs (`configs/gnn.py`) and the LM
architecture registry (`ARCHS`, `get_config`, `reduced`).

The registry holds the dense family, each with its published dimensions:
smollm-135m, qwen3-4b, gemma2-27b and chatglm3-6b. The reference's six
other architectures (MoE, SSM, hybrid, vision and audio) come with ROADMAP
queue 1 item 14; `get_config` names that item for them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.nn.config import ArchConfig

from . import chatglm3_6b, gemma2_27b, qwen3_4b, smollm_135m

ARCHS: Dict[str, ArchConfig] = {
    "gemma2-27b": gemma2_27b.CONFIG,
    "chatglm3-6b": chatglm3_6b.CONFIG,
    "qwen3-4b": qwen3_4b.CONFIG,
    "smollm-135m": smollm_135m.CONFIG,
}
UNPORTED = ("mamba2-2.7b", "olmoe-1b-7b", "llama4-scout-17b-a16e",
            "jamba-v0.1-52b", "phi-3-vision-4.2b", "whisper-base")


def get_config(name: str) -> ArchConfig:
    if name in UNPORTED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP queue 1 "
                       f"item 14); ported: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ArchConfig, *, layers: int | None = None) -> ArchConfig:
    """The reference's smoke-test shrink: the same layer pattern and
    feature flags (GQA ratio, qk-norm, softcaps, partial rope, sandwich
    norms), tiny widths, float32."""
    sb = len(cfg.superblock)
    nl = layers if layers is not None else 2 * sb
    nl = max(sb, (nl // sb) * sb)
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = max(kv, 4 if cfg.num_heads >= 4 else cfg.num_heads)
    heads = (heads // kv) * kv
    return dataclasses.replace(
        cfg, num_layers=nl, d_model=128, num_heads=heads, num_kv_heads=kv,
        head_dim=32, d_ff=(256 if cfg.d_ff > 0 else 0), vocab_size=512,
        local_window=(64 if cfg.local_window else None), num_patches=16,
        compute_dtype="float32")


__all__ = ["ARCHS", "UNPORTED", "get_config", "reduced", "ArchConfig"]
