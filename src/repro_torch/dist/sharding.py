"""Logical-axis -> mesh-axis distribution rules, and a rank's blocks.

Port of the reference's `dist/sharding.py`. A tensor's dims carry
*logical* axis names; the rules map them onto the axes of a mesh
(`launch.mesh.Mesh`, or anything with the reference's `mesh.shape`
{axis: size}). A dim is split over a mesh axis only when (a) a rule names
that axis, (b) the axis is in the mesh, (c) no earlier dim of the tensor
took it, and (d) the dim divides by the axis size; otherwise it is
replicated. So one definition runs on one process, on a shard mesh, or on
the (16, 16) and (2, 16, 16) production meshes.

A spec is a tuple with one entry per dim: a mesh-axis name or None, the
counterpart of the reference's `PartitionSpec`. Where the reference hands
a spec to XLA, which moves the data, here each rank holds its own block
(`local_block`) and an assembly is a sum of zero-padded blocks over the
spec's process group (`assemble`): exact, since disjoint blocks and zeros
add exactly, and built on `all_reduce` alone, which every backend has
(gloo has no `all_gather` of CUDA tensors).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.dist.compress import psum

Spec = Tuple[Optional[str], ...]

# Tensor-parallel ("model") axes: wide output-ish dims whose matmul
# partials reduce over the innermost mesh axis. Everything else is
# replicated; batch dims shard over the data axes ("pod" outer, "data"
# inner).
AXIS_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "ff": "model",
    "mlp": "model",
    "heads": "model",
    "ssm_in": "model",
    "ssm_heads": "model",
    "embed": None,       # contracted in every matmul: replicate
    "kv": None,          # small KV head counts rarely divide; replicate
    "frames": None,
    # GNN sharded serving (DESIGN.md §12): the leading shard axis of the
    # row-partitioned operands maps onto the "shard" axis of
    # launch.mesh.make_shard_mesh; every other operand dim replicates.
    "graph_shard": "shard",
    # replica groups (DESIGN.md §15): the outer replica axis of an R-wide
    # sharded dispatch maps onto the "replica" axis of the R x S mesh
    "graph_replica": "replica",
}

# Expert parallelism depends on the placement (capacity against
# bandwidth): a dry run picks it per (arch, mesh) with choose_expert_axis
# and pins it here.
_EXPERT_AXIS: Optional[str] = "model"


def set_expert_axis(name: Optional[str]) -> None:
    global _EXPERT_AXIS
    _EXPERT_AXIS = name


def choose_expert_axis(cfg, mesh) -> Optional[str]:
    """The model axis when the expert count divides it, else the data
    axis when it divides that; "model" otherwise."""
    n = int(getattr(cfg, "num_experts", 0) or 0)
    for axis in ("model", "data"):
        if axis in mesh.shape and n > 0 and n % mesh.shape[axis] == 0:
            return axis
    return "model"


def _mesh_axis_for(logical: Optional[str]) -> Optional[str]:
    if logical == "experts":
        return _EXPERT_AXIS
    return AXIS_RULES.get(logical) if logical else None


def spec_for_axes(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                  mesh) -> Spec:
    """The spec of one tensor of `shape` whose dims carry the logical
    `axes`; a dim no rule can split replicates (None)."""
    entries = []
    used = set()
    for dim, logical in zip(shape, axes):
        a = _mesh_axis_for(logical)
        if (a is None or a not in mesh.shape or a in used
                or dim % mesh.shape[a] != 0):
            entries.append(None)
        else:
            entries.append(a)
            used.add(a)
    return tuple(entries)


def param_specs(axes_tree, params, mesh):
    """A tree of specs, one per tensor of `params`: `axes_tree` has the
    structure of `params` with a tuple of logical axis names in place of
    each tensor (the reference keeps them together in its `Param`)."""
    return pytree.tree_map(
        lambda p, axes: spec_for_axes(axes, tuple(p.shape), mesh),
        params, axes_tree)


def mesh_batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of the mesh, outermost first."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _data_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh_batch_axes(mesh))


def batch_spec(mesh, *, ndim: int) -> Tuple[Any, ...]:
    """Dim 0 over the data axes (one name, or a tuple of them outermost
    first, as a `PartitionSpec` normalizes it), the rest replicated."""
    axes = mesh_batch_axes(mesh)
    lead = axes[0] if len(axes) == 1 else (axes or None)
    return (lead,) + (None,) * (ndim - 1)


def cache_specs(tree, mesh, *, seq_sharded: bool = False):
    """Decode-cache specs: dim 0 (the batch) over the data axes where it
    divides. When the batch cannot fill the data axes (`seq_sharded`),
    the cache replicates: correctness first."""
    n = _data_size(mesh)

    def one(leaf):
        ndim = getattr(leaf, "ndim", 0)
        if ndim >= 1 and not seq_sharded and leaf.shape[0] % n == 0:
            return batch_spec(mesh, ndim=ndim)
        return ()

    return pytree.tree_map(one, tree)


@contextlib.contextmanager
def use_distribution(mesh):
    """The reference activates a mesh here so that sharding constraints
    inside a trace resolve against it. A rank already holds only its own
    rows, and nothing is traced, so there is nothing to constrain: the
    context only yields the mesh."""
    yield mesh


def constrain_scan_slices(y: Any) -> Any:
    """The identity: the reference pins the per-microbatch batch dim to
    the data axes so that XLA does not gather the microbatch stack onto
    one replica between scan steps. Each rank holds its own rows and no
    compiler moves them."""
    return y


def _split_dims(spec: Spec):
    """(dim, mesh axes) of every split dim of a spec; an entry may name
    several axes (a tuple, as `batch_spec` gives), outermost first."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        yield d, (entry,) if isinstance(entry, str) else tuple(entry)


def _block_index(axes: Tuple[str, ...], mesh) -> Tuple[int, int]:
    """(this rank's index, the number of blocks) along a dim split over
    `axes`, the first axis outermost."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    return idx, n


def local_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor `t` under `spec` (a view)."""
    for d, axes in _split_dims(spec):
        idx, n = _block_index(axes, mesh)
        size = t.shape[d] // n
        t = t.narrow(d, idx * size, size)
    return t


def assemble(block: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The inverse of `local_block`: the full tensor on every rank of the
    spec's group, from each rank's `block`. Each rank writes its block
    into a zeroed tensor of the full shape and the group sums them with
    one `all_reduce` (exact: the blocks are disjoint). The sum runs over
    the group of the axes the spec names, so on a mesh with other axes
    each of their lines assembles its own tensor."""
    split = list(_split_dims(spec))
    if not split:
        return block + 0.0
    shape = list(block.shape)
    full_axes = []
    for d, axes in split:
        shape[d] *= _block_index(axes, mesh)[1]
        full_axes.extend(axes)
    full = block.new_zeros(shape)
    local_block(full, spec, mesh).copy_(block)
    return psum(full, mesh.group(*full_axes))
