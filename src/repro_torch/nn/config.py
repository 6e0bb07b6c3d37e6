"""Architecture configuration of the LM substrate, as data.

`ArchConfig` describes every family the reference covers (dense, ssm, moe,
hybrid, vlm, audio), and the port runs them all: an `encoder` makes the
model an encoder-decoder (whisper: an encoder stack over stub frame
embeddings and cross-attention in every decoder layer), a `frontend`
names the stub whose embeddings the caller passes in (vision patches as a
prefix of `num_patches` positions, or audio frames for the encoder).
Layer heterogeneity is a *superblock*, the smallest repeating pattern of
layer kinds; parameters carry a leading `num_superblocks` axis.

Two training knobs are fields, with the reference's defaults: `remat`
(each superblock's activations recomputed in the backward, the
reference's `jax.checkpoint` of its scan body, here
`torch.utils.checkpoint`) and `loss_chunk` (the sequence positions whose
logits `lm.chunked_xent` makes at a time). The reference's other knobs of
its multi-pod dry run (query and KV chunk sizes, scan unrolling, block
skip, bf16 logits, the flash stub) have no meaning on this path and are
not fields here.

`ShapeConfig` and `SHAPES` are the reference's four input cells of the
dry run (`launch/dryrun.py`): a training batch, a long prefill, a decode
step against a long cache, and a 512k-token decode for the
sub-quadratic families.
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
    remat: bool = True               # recompute each superblock in backward
    loss_chunk: int = 512            # positions per cross-entropy chunk

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

    def layer_uses_moe(self, pos_in_superblock: int, kind: str) -> bool:
        """MoE replaces the MLP at every `every_k_layers`-th superblock
        position (jamba: the odd ones); the kind does not matter."""
        del kind
        if self.moe is None:
            return False
        return pos_in_superblock % self.moe.every_k_layers == (
            self.moe.every_k_layers - 1)

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def attention_free(self) -> bool:
        return self.layer_pattern == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """SSM or hybrid: a constant-size state in most layers."""
        return self.layer_pattern in ("ssm", "jamba")

    def _layer_kinds(self):
        sb = self.superblock
        return [(i % len(sb), sb[i % len(sb)]) for i in range(self.num_layers)]

    def param_count(self) -> int:
        """Analytic parameter count, as the reference counts it (norm
        scales, the SSM's per-head vectors and the conv bias left out)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        n_q, n_kv = self.num_heads, self.num_kv_heads
        mult = 3 if self.gated_mlp else 2
        total = v * d if self.tie_embeddings else 2 * v * d
        for pos, kind in self._layer_kinds():
            if kind.startswith("attn"):
                total += d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
            else:
                s = self.ssm
                d_in = s.expand * d
                total += d * 2 * d_in                      # w_zx
                total += d * 2 * s.n_groups * s.d_state    # w_bc
                total += d * (d_in // s.headdim)           # w_dt
                total += d_in * d                          # w_out
                total += s.conv_kernel * (d_in + 2 * s.n_groups * s.d_state)
            if self.layer_uses_moe(pos, kind):
                m = self.moe
                total += m.num_experts * mult * d * m.d_ff_expert
                total += d * m.num_experts                 # router
                if m.shared_expert_ff:
                    total += mult * d * m.shared_expert_ff
            elif ff > 0:
                total += mult * d * ff
        if self.encoder is not None:
            enc = self.encoder.num_layers * (
                (2 * d * n_q * hd + 2 * d * n_kv * hd) + mult * d * ff)
            cross = self.num_layers * (d * n_q * hd + 2 * d * n_kv * hd
                                       + n_q * hd * d)
            total += enc + cross
        return int(total)

    def active_param_count(self) -> int:
        """Parameters a token touches: `param_count` less the experts it
        is not routed to."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        mult = 3 if self.gated_mlp else 2
        n_moe = sum(1 for pos, kind in self._layer_kinds()
                    if self.layer_uses_moe(pos, kind))
        idle = (m.num_experts - m.top_k) * mult * self.d_model * m.d_ff_expert
        return int(self.param_count() - n_moe * idle)



@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input cell of the dry run."""
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
