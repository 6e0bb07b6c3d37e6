"""Bring state made outside the port (numpy arrays, for example the
reference package's weights or tier calibration converted with
`np.asarray`) onto a device.

Takes the reference's parameter trees (GCN `{"l1": {"w", "b"}, "l2":
{...}}`, GAT `{"l1": {"w", "a_src", "a_dst", "b"}, ...}`, SAGE
`{"l1": {"w_self", "w_neigh", "b"[, "w_pool", "b_pool"]}, ...}`), its GCN,
GAT and SAGE tier calibrations and its GraSp block structures with numpy
leaves; nothing here knows of JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.quant import QuantizedLinear
from repro_torch.core.sparsity import LEAVES, BlockSparse, upload_block_sparse
from repro_torch.device import DeviceLike, resolve_device


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
