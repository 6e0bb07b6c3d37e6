"""Bring state made outside the port (numpy arrays, for example the
reference package's weights or tier calibration converted with
`np.asarray`) onto a device.

Takes the reference's parameter trees (GCN `{"l1": {"w", "b"}, "l2":
{...}}`, GAT `{"l1": {"w", "a_src", "a_dst", "b"}, ...}`, SAGE
`{"l1": {"w_self", "w_neigh", "b"[, "w_pool", "b_pool"]}, ...}`), its GCN,
GAT and SAGE tier calibrations, its GraSp block structures and its LM
parameters (`lm_params_from_jax`: attention and SSM mixers, MLPs and
MoEs, cross-attention and the encoder) with numpy leaves, and gives parameters back as numpy
(`params_to_numpy`), so weights the port trained can run through the
reference; nothing here knows of JAX.
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
from repro_torch.nn.moe import MoEParams
from repro_torch.nn.ssm import SSMParams


def params_from_jax(tree: Dict, *, device: DeviceLike = None) -> Dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    `device` (copies; dtypes kept)."""
    dev = resolve_device(device)
    return {k: (params_from_jax(v, device=dev) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)).to(dev))
            for k, v in tree.items()}


def params_to_numpy(tree: Any) -> Any:
    """The inverse of `params_from_jax` and `lm_params_from_jax`: tensors
    -> numpy arrays on the host (copies; dtypes kept), in the same nesting
    of dicts and lists, named tuples as dicts of their fields, None kept.
    An `LMParams` gives the reference's fields (`embed`, `stack`,
    `final_norm`, `unembed`, and `encoder` where there is one), without
    the derived `logits_w`."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, LMParams):
        keys = ("embed", "stack", "final_norm", "unembed") + (
            ("encoder",) if tree.encoder is not None else ())
        tree = {k: getattr(tree, k) for k in keys}
    if isinstance(tree, list):
        return [params_to_numpy(v) for v in tree]
    return {k: params_to_numpy(v) for k, v in _fields(tree).items()}


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
    other. A mixer is an SSM's when it has `w_zx`, else attention's; an
    `mlp` with `w_router` is a MoE, with its shared expert if any; a
    `cross` is an attention. The `encoder` subtree (`{"stack",
    "final_norm"}`) takes the same layout."""
    dev = resolve_device(device)

    def tensor(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(dev)

    def tensors(node, cls):
        if node is None:
            return None
        f = _fields(node)
        return cls(**{k: tensor(f.get(k)) for k in cls._fields})

    def norm(node):
        return {n: tensor(a) for n, a in _fields(node).items()}

    def layer(node):
        out = {}
        for k, v in _fields(node).items():
            if k == "mixer":
                out[k] = tensors(v, SSMParams if "w_zx" in _fields(v)
                                 else AttnParams)
            elif k == "cross":
                out[k] = tensors(v, AttnParams)
            elif k == "mlp" and "w_router" in _fields(v):
                f = _fields(v)
                out[k] = MoEParams(
                    **{n: tensor(f.get(n))
                       for n in ("w_router", "w_in", "w_up", "w_out")},
                    shared=tensors(f.get("shared"), MLPParams))
            elif k == "mlp":
                out[k] = tensors(v, MLPParams)
            elif k.endswith("norm"):
                out[k] = norm(v)
            else:
                raise ValueError(f"unknown layer field {k!r}")
        return out

    f = _fields(tree)
    enc = f.get("encoder")
    return LMParams(embed=tensor(f["embed"]),
                    stack=[layer(pos) for pos in f["stack"]],
                    final_norm=norm(f["final_norm"]),
                    unembed=tensor(f.get("unembed")),
                    encoder=None if enc is None else {
                        "stack": [layer(pos) for pos in _fields(enc)["stack"]],
                        "final_norm": norm(_fields(enc)["final_norm"])})
