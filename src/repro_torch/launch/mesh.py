"""Meshes of ranks: one process per device, joined by `torch.distributed`.

Port of the reference's `launch/mesh.py`. The reference lays a `Mesh` of
JAX devices out in one process; here each device is driven by a process
of its own (a rank), and a `Mesh` is this rank's view of the layout: the
axis names, the mesh's shape as a {axis: size} dict (the reference's
`mesh.shape`, so `dist.sharding.spec_for_axes` reads either), this rank's
coordinates, its device, and one process group per axis line it sits on.

Ranks fill the mesh in row-major order, as the reference reshapes its
device list: on the ("replica", "shard") mesh, rank r * S + s is replica
r's shard s. Every rank must build the same meshes in the same order:
`torch.distributed.new_group` is a collective over the whole world.

The device of a rank is explicit. `device=None` is `cuda:{local_rank}`
(`LOCAL_RANK`, else the rank) and raises when the host has no such card;
a caller may name one card for every rank (`cuda:0`, as `chip_smoke.py`
does on a one-card machine, with gloo) or the CPU. The backend is
explicit too: NCCL by default on a CUDA device, gloo on the CPU, and a
failure of either raises; nothing switches backend or device quietly.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike

BACKENDS = ("nccl", "gloo")


def rank_device(device: DeviceLike = None,
                rank: Optional[int] = None) -> torch.device:
    """This rank's device: `device` as given, or `cuda:{local_rank}`,
    raising when the host has no such card. The local rank is torchrun's
    `LOCAL_RANK`, else `rank`, else the process group's rank."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", _local_rank(rank))
        return dev
    local = _local_rank(rank)
    if torch.cuda.device_count() <= local:
        raise RuntimeError(
            f"rank with local rank {local} needs cuda:{local}, but the host "
            f"has {torch.cuda.device_count()} CUDA device(s); name a device "
            f"explicitly (device='cuda:0' to share one card, 'cpu' for the "
            f"CPU)")
    return torch.device("cuda", local)


def _local_rank(rank: Optional[int] = None) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is not None:
        return rank
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(*, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     device: DeviceLike = None,
                     timeout_s: float = 300.0) -> torch.device:
    """Join the process group and return this rank's device.

    `init_method` (`tcp://host:port` or `file://path`), `rank` and
    `world_size` are given together, or all left None for torchrun's
    environment (`env://`: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE).
    `backend` defaults to NCCL on a CUDA device and gloo on the CPU; NCCL
    on the CPU raises. A collective that waits longer than `timeout_s`
    raises (gloo) or aborts the process (NCCL), so a lost rank cannot
    hang the others for ever."""
    given = [init_method is not None, rank is not None,
             world_size is not None]
    if any(given) and not all(given):
        raise ValueError("give init_method, rank and world_size together, "
                         "or none of them for torchrun's environment")
    dev = rank_device(device, rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, init_method=init_method or "env://",
              timeout=datetime.timedelta(seconds=timeout_s))
    if rank is not None:
        kw.update(rank=rank, world_size=world_size)
    dist.init_process_group(**kw)
    return dev


@dataclasses.dataclass
class Mesh:
    """This rank's view of a mesh of ranks (see the module docstring).

    `shape` maps each axis name to its size, in axis order; `coords` is
    this rank's index along each axis; `groups` holds, per axis, the
    process group of the ranks that share this rank's other coordinates,
    and under the key of every axis at once the group of the whole mesh.
    """
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[Tuple[str, ...], object]
    device: torch.device
    ranks: Tuple[int, ...]

    @property
    def is_first(self) -> bool:
        """Whether this rank sits at the mesh's origin (every coordinate
        0): the rank that takes the decisions other ranks follow."""
        return not any(self.coords.values())

    @property
    def first_rank(self) -> int:
        """The global rank at the mesh's origin."""
        return self.ranks[0]

    def group(self, *axes: str):
        """The process group over `axes` (one axis, or every axis of the
        mesh) that holds this rank."""
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(axes) or key not in self.groups:
            raise ValueError(f"mesh {self.axis_names} has no group over "
                             f"{axes}")
        return self.groups[key]


def make_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...], *,
              device: DeviceLike = None) -> Optional[Mesh]:
    """A mesh of `shape` over the first prod(shape) ranks of the world, in
    row-major order. Every rank of the world must call it (group creation
    is collective); a rank past the mesh gets None. Raises when the world
    is too small, as the reference does for too few devices."""
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("init_distributed() first: a mesh is made of "
                           "the ranks of a process group")
    need, world = math.prod(shape), dist.get_world_size()
    if world < need:
        raise RuntimeError(f"mesh {tuple(shape)} needs {need} ranks, the "
                           f"world has {world}")
    rank = dist.get_rank()
    ids = torch.arange(need).reshape(shape)
    groups: Dict[Tuple[str, ...], object] = {}
    for k, name in enumerate(axis_names):
        # one line per combination of the other coordinates
        lines = ids.movedim(k, -1).reshape(-1, shape[k])
        for line in lines.tolist():
            g = dist.new_group(line)
            if rank in line:
                groups[(name,)] = g
    if len(axis_names) > 1:
        g = dist.new_group(list(range(need)))
        if rank < need:
            groups[tuple(axis_names)] = g
    if rank >= need:
        return None
    pos = (ids == rank).nonzero()[0].tolist()
    return Mesh(axis_names=tuple(axis_names),
                shape=dict(zip(axis_names, shape)),
                coords=dict(zip(axis_names, pos)), groups=groups,
                device=rank_device(device), ranks=tuple(range(need)))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Optional[Mesh]:
    """The production layout: (16, 16) ("data", "model"), or (2, 16, 16)
    ("pod", "data", "model") with `multi_pod`, whose outer "pod" axis is
    data-parallel across pods; "model" is innermost, so tensor-parallel
    collectives stay among neighbouring ranks. Raises without 256 (512)
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(*, data: Optional[int] = None, model: int = 1,
                   device: DeviceLike = None) -> Optional[Mesh]:
    """A small ("data", "model") mesh over the ranks there are (tests and
    examples): `data` defaults to world_size // model."""
    d = data if data is not None else max(1, dist.get_world_size() // model)
    return make_mesh((d, model), ("data", "model"), device=device)


def make_shard_mesh(shards: int, replicas: int = 1, *,
                    device: DeviceLike = None) -> Optional[Mesh]:
    """The mesh of sharded GNN serving (DESIGN.md §12, §15): the 1-D
    ("shard",) mesh, one rank per graph shard, or with `replicas` R > 1
    the R x S ("replica", "shard") mesh, R concurrent batches of the same
    shard layout, whose halo sums run over "shard" and so stay within a
    replica. Raises when the world has fewer than R * S ranks."""
    if replicas == 1:
        return make_mesh((shards,), ("shard",), device=device)
    return make_mesh((replicas, shards), ("replica", "shard"), device=device)
