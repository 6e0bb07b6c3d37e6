"""Bring parameters made outside the port (numpy arrays, for example the
reference package's weights converted with `np.asarray`) onto a device.

Takes the reference's parameter tree `{"l1": {"w", "b"}, "l2": {...}}`
with numpy leaves; nothing here knows of JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_jax(tree: Dict, *, device: DeviceLike = None) -> Dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    `device` (copies; dtypes kept)."""
    dev = resolve_device(device)
    return {k: (params_from_jax(v, device=dev) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)).to(dev))
            for k, v in tree.items()}
