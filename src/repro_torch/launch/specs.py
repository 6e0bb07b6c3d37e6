"""Meta-tensor stand-ins and step functions for every (arch x shape) cell
of the dry run.

Port of the reference's `launch/specs.py`. Where the reference makes
`jax.ShapeDtypeStruct`s for `.lower().compile()`, the port makes tensors
on the `meta` device, which have shapes and dtypes and no storage, and
runs the step on them (`launch/dryrun.py`); nothing is allocated or
drawn for a full config. Cell semantics, as in the reference:

  train_4k    — `make_train_step`: loss, gradients and the AdamW update;
  prefill_32k — `make_prefill_step`: forward and the caches (an
                encoder-decoder runs its encoder over the 32k stub frames
                with a short decoder prompt);
  decode_32k  — `make_serve_step`: one new token against a seq_len cache;
  long_500k   — `make_serve_step` at 524288, for the sub-quadratic archs
                only (`runnable`).

Each step takes `mesh=`: it then runs as one rank of the mesh, on its
blocks of the parameters and moments (`runtime.trainer.lm_placement`),
its rows of the batch (`dist.sharding.batch_specs`) and its blocks of
the caches (`dist.sharding.cache_specs(batch_dim=1)`: the batch in dim 1
of the port's stacked caches). On an `launch.mesh.abstract_mesh` its collectives move nothing
and record what they were handed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.ckpt import tree_items, tree_replace
from repro_torch.dist.sharding import data_size
from repro_torch.nn import lm, transformer as tfm
from repro_torch.nn.config import ArchConfig, ShapeConfig
from repro_torch.nn.multimodal import audio_spec, vision_spec
from repro_torch.runtime import trainer

META = torch.device("meta")
WHISPER_DECODE_PROMPT = 256   # the decoder prompt when the encoder carries
                              # the sequence (prefill cells of enc-dec)


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def runnable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is this (arch, shape) cell runnable? (the reference's rules)"""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 512k decode needs "
                       "sub-quadratic attention (skip per assignment)")
    return True, ""


# ---------------------------------------------------------------------------
# Abstract trees (params / optimizer / caches) on the meta device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def abstract_params(cfg: ArchConfig, *, serve: bool = False) -> lm.LMParams:
    """`lm_init`'s tree on the meta device, nothing drawn. Training:
    float32 masters. Serving: every floating leaf bfloat16, as the
    reference's serving cells take it."""
    tree = lm.lm_init(cfg, device=META)
    if not serve:
        return tree
    return _cast(tree, torch.bfloat16)


def _cast(tree, dtype):
    return tree_replace(tree, {k: meta(t.shape, dtype)
                               for k, t in tree_items(tree)})


def abstract_opt(cfg: ArchConfig) -> Dict[str, Any]:
    """AdamW's state for `abstract_params(cfg)`."""
    return trainer.init_opt_state(abstract_params(cfg))


def abstract_caches(cfg: ArchConfig, batch: int, max_len: int):
    return tfm.init_caches(cfg, batch, max_len, device=META)


def abstract_enc_kv(cfg: ArchConfig, batch: int, frames: int):
    nsb = cfg.num_superblocks
    shape = (nsb, batch, frames, cfg.num_kv_heads, cfg.head_dim_)
    return meta(shape, cfg.dtype), meta(shape, cfg.dtype)


# ---------------------------------------------------------------------------
# Per-cell input specs
# ---------------------------------------------------------------------------


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": meta((b, s), torch.int32),
             "labels": meta((b, s), torch.int32),
             "mask": meta((b, s), torch.int32)}
    if cfg.frontend == "vision_stub":
        specs["patches"] = vision_spec(cfg, b)
    if cfg.frontend == "audio_stub":
        specs["frames"] = audio_spec(cfg, b, cfg.encoder.frames)
    return specs


def prefill_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        # the 32k sequence rides the encoder (stub frames); short prompt
        return {"tokens": meta((b, WHISPER_DECODE_PROMPT), torch.int32),
                "frames": audio_spec(cfg, b, s)}
    specs = {"tokens": meta((b, s), torch.int32)}
    if cfg.frontend == "vision_stub":
        specs["patches"] = vision_spec(cfg, b)
    return specs


def decode_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"token": meta((b,), torch.int32),
             "pos": meta((), torch.int32),
             "caches": abstract_caches(cfg, b, s)}
    if cfg.is_encdec:
        specs["enc_kv"] = abstract_enc_kv(cfg, b, cfg.encoder.frames)
    return specs


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return decode_specs(cfg, shape)


# ---------------------------------------------------------------------------
# Step functions (one per cell kind)
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, *, microbatches: int = 8,
                    steps: int = 1000, mesh=None):
    """(params, opt, batch, step) -> (params, opt, metrics) with the
    reference's fixed settings (clip 1.0, lr 3e-4 after 100 warmup steps,
    weight decay 0.1): `runtime.trainer.make_train_step`, on this rank's
    blocks with `mesh`."""
    tc = trainer.TrainConfig(steps=steps, microbatches=microbatches,
                             lr=3e-4, warmup_steps=100, weight_decay=0.1,
                             clip_norm=1.0)
    return trainer.make_train_step(cfg, tc, mesh=mesh)


def _place(cfg: ArchConfig, mesh):
    return None if mesh is None else trainer.lm_placement(cfg, mesh)


def prefill_len(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """The prefill's cache capacity: the prompt, and a vision prefix."""
    max_len = shape.seq_len if not cfg.is_encdec else (
        WHISPER_DECODE_PROMPT + 256)
    if cfg.frontend == "vision_stub":
        max_len += cfg.num_patches
    return max_len


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig, *, mesh=None):
    """(params, batch) -> (last logits, caches); with `mesh` on this
    rank's blocks and rows."""
    max_len = prefill_len(cfg, shape)
    place = _place(cfg, mesh)

    def prefill_step(params, batch):
        if place is not None:
            batch = place.rows(batch)
        logits, state = lm.lm_prefill(
            params, cfg, batch["tokens"], max_len=max_len,
            prefix_embeds=batch.get("patches"),
            enc_embeds=batch.get("frames"), place=place)
        return logits, state.caches
    return prefill_step


def make_serve_step(cfg: ArchConfig, shape: ShapeConfig, *, mesh=None):
    """(params, caches, token, pos, enc_kv=None) -> (logits, caches, pos):
    one decode step, the caches a separate argument written in place.
    With `mesh`: this rank's blocks of the parameters and of the caches
    (`dist.sharding.cache_specs` on dim 1) and its rows of `token`."""
    place = _place(cfg, mesh)

    def serve_step(params, caches, token, pos, enc_kv=None):
        if place is not None:
            token = place.rows({"token": token})["token"]
        state = lm.ServeState(caches=caches, pos=pos, enc_kv=enc_kv)
        logits, state = lm.lm_decode_step(params, cfg, token, state,
                                          place=place)
        return logits, state.caches, state.pos
    return serve_step


# ---------------------------------------------------------------------------
# Dry-run microbatch policy and the two-point cost config
# ---------------------------------------------------------------------------


def train_microbatches(cfg: ArchConfig, shape: ShapeConfig,
                       n_data: int) -> int:
    """The largest power-of-two microbatch count, at most 8, that keeps a
    data rank's microbatch at least one sequence (the reference's
    policy)."""
    per_dev = max(shape.global_batch // n_data, 1)
    return min(8, per_dev)


def cost_config(cfg: ArchConfig, k: int) -> ArchConfig:
    """The config with k superblocks (and a k-layer encoder). The
    reference lowers two such points because XLA's cost analysis counts a
    scanned body once; the port runs every superblock, so the two points
    only check that its counts are linear in k (`dryrun.
    measure_cost_metrics`)."""
    changes: Dict[str, Any] = dict(num_layers=k * len(cfg.superblock))
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(cfg.encoder, num_layers=k)
    return dataclasses.replace(cfg, **changes)
