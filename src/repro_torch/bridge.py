"""Bring state made outside the port (numpy arrays, for example the
reference package's weights or tier calibration converted with
`np.asarray`) onto a device.

Takes the reference's parameter trees (GCN `{"l1": {"w", "b"}, "l2":
{...}}`, GAT `{"l1": {"w", "a_src", "a_dst", "b"}, ...}`, SAGE
`{"l1": {"w_self", "w_neigh", "b"[, "w_pool", "b_pool"]}, ...}`), its GCN,
GAT and SAGE tier calibrations, its GraSp block structures and its LM
parameters (`lm_params_from_jax`) with numpy leaves; nothing here knows of
JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.quant import QuantizedLinear
from repro_torch.core.sparsity import LEAVES, BlockSparse, upload_block_sparse
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.attention import AttnParams
from repro_torch.nn.lm import LMParams
from repro_torch.nn.mlp import MLPParams


def params_from_jax(tree: Dict, *, device: DeviceLike = None) -> Dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    `device` (copies; dtypes kept)."""
    dev = resolve_device(device)
    return {k: (params_from_jax(v, device=dev) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)).to(dev))
            for k, v in tree.items()}


def calibration_from_jax(tree: Dict, *, device: DeviceLike = None) -> Dict:
    """A tier calibration in numpy -> the port's `calibrate_tier` form on
    `device`.

    `tree` holds each QuantizedLinear as a dict of `wq`, `w_scale` and
    `x_scale`: one per layer for GCN and GAT (keys "l1", "l2"), a dict of
    them per layer for SAGE (`{"l1": {"self": ..., "neigh": ...[,
    "pool": ...]}, "l2": ...}`); GCN adds the scalar aggregation scales
    "agg1_h" and "agg2_h". Values and dtypes are kept exactly, so the port
    and the reference can run on identical scales.
    """
    dev = resolve_device(device)

    def convert(v):
        if not isinstance(v, dict):
            return torch.from_numpy(np.array(v)).to(dev)
        if "wq" in v:
            return QuantizedLinear(**{f: convert(v[f])
                                      for f in ("wq", "w_scale", "x_scale")})
        return {k: convert(u) for k, u in v.items()}
    return convert(tree)


def block_sparse_from_jax(sp, *, device: DeviceLike = None) -> BlockSparse:
    """A reference `BlockSparse` whose leaves are numpy arrays -> the
    port's structure on `device`, values and dtypes kept exactly."""
    return upload_block_sparse(BlockSparse(
        **{f: np.asarray(getattr(sp, f)) for f in LEAVES},
        block_size=int(sp.block_size),
        shape=tuple(int(d) for d in sp.shape)), device)


def _fields(node: Any) -> Mapping:
    """A mapping or a named tuple as a mapping."""
    return node if isinstance(node, Mapping) else node._asdict()


def lm_params_from_jax(tree: Any, *, device: DeviceLike = None) -> LMParams:
    """The reference's `LMParams` as plain containers of numpy arrays (each
    `Param` replaced by its value; mappings or named tuples with the
    reference's field names, None where it has None) -> the port's
    `LMParams` on `device`, values and dtypes kept. The stacked layout is
    kept: `stack` is a list over superblock positions whose leaves carry
    the leading num_superblocks axis, so index i of one is index i of the
    other."""
    dev = resolve_device(device)

    def tensor(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(dev)

    def tensors(node, cls):
        f = _fields(node)
        return cls(**{k: tensor(f.get(k)) for k in cls._fields})

    def layer(node):
        out = {}
        for k, v in _fields(node).items():
            if k == "mixer":
                out[k] = tensors(v, AttnParams)
            elif k == "mlp":
                if "w_router" in _fields(v):
                    raise NotImplementedError(
                        "MoE layers are not ported yet (ROADMAP queue 1 "
                        "item 14)")
                out[k] = tensors(v, MLPParams)
            elif k.endswith("norm"):
                out[k] = {n: tensor(a) for n, a in _fields(v).items()}
            else:
                raise NotImplementedError(
                    f"layer field {k!r} is not ported yet (ROADMAP queue 1 "
                    "item 14)")
        return out

    f = _fields(tree)
    if f.get("encoder") is not None:
        raise NotImplementedError("the encoder is not ported yet (ROADMAP "
                                  "queue 1 item 14)")
    return LMParams(embed=tensor(f["embed"]),
                    stack=[layer(pos) for pos in f["stack"]],
                    final_norm={n: tensor(a)
                                for n, a in _fields(f["final_norm"]).items()},
                    unembed=tensor(f.get("unembed")))
