"""Architecture configuration of the LM substrate, as data.

`ArchConfig` describes every family the reference covers (dense, ssm, moe,
hybrid, vlm, audio); the port serves the dense family (`layer_pattern`
"global" or "local_global", no MoE, SSM, encoder or frontend) and refuses
the rest where it would run them (ROADMAP queue 1 item 14). Layer
heterogeneity is a *superblock*, the smallest repeating pattern of layer
kinds; parameters carry a leading `num_superblocks` axis.

The reference's knobs of its multi-pod dry run and training (remat, loss,
query and KV chunk sizes, scan unrolling, block skip, bf16 logits, the
flash stub) have no meaning on this path and are not fields here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every_k_layers: int = 1
    shared_expert_ff: int = 0
    capacity_factor: float = 1.25
    group_size: int = 1024
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_kernel: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    num_layers: int
    frames: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # chatglm partial rope = 0.5
    qk_norm: bool = False            # qwen3
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    local_window: Optional[int] = None
    layer_pattern: str = "global"    # global | local_global | jamba | ssm
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None
    num_patches: int = 1024
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    zero_centered_norm: bool = False
    post_norms: bool = False
    scale_embeddings: bool = False
    act: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = True
    compute_dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.num_heads)

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def superblock(self) -> Tuple[str, ...]:
        """Layer kinds of the smallest repeating block: 'attn' (global),
        'attn_local' or 'ssm'."""
        if self.layer_pattern == "global":
            return ("attn",)
        if self.layer_pattern == "local_global":
            return ("attn_local", "attn")
        if self.layer_pattern == "ssm":
            return ("ssm",)
        if self.layer_pattern == "jamba":
            return ("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm")
        raise ValueError(self.layer_pattern)

    @property
    def num_superblocks(self) -> int:
        sb = len(self.superblock)
        assert self.num_layers % sb == 0, (self.num_layers, sb)
        return self.num_layers // sb


def require_ported(cfg: ArchConfig) -> None:
    """Raise unless `cfg` lies on the ported dense serving path."""
    if cfg.moe is not None:
        what = "MoE layers"
    elif cfg.ssm is not None or cfg.layer_pattern not in ("global",
                                                          "local_global"):
        what = f"the {cfg.layer_pattern!r} layer pattern"
    elif cfg.encoder is not None:
        what = "the encoder"
    elif cfg.frontend is not None:
        what = f"the {cfg.frontend!r} frontend"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name} needs {what}, which the port does not have yet "
        "(ROADMAP queue 1 item 14); it serves the dense family")
