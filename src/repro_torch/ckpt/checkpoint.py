"""Fault-tolerant checkpoints: atomic, keep-k, async, SymG-packed.

Port of the reference's `ckpt/checkpoint.py` with its behaviour and its
on-disk layout:

  * ATOMIC  — a save writes `<dir>/tmp.<step>.<pid>/` and renames it to
              `<dir>/step_<step:010d>` (rename is atomic on POSIX), so a
              crash mid-write never corrupts the restore target. Its
              `manifest.json` holds the step, one [key, array name, shape,
              dtype] per leaf and the SymG-packed names; `arrays.npz` holds
              the arrays `a0`, `a1`, ...
  * KEEP-K  — completed checkpoints beyond `keep` are deleted oldest first;
              tmp directories of crashed writers older than an hour go too.
  * ASYNC   — `CheckpointManager.maybe_save` copies the tree to the host at
              once and writes it on a background thread; `wait()` joins.
  * SymG    — a symmetric float32 (N, N) leaf, N >= 256, is stored as its
              upper triangle and rebuilt on restore.

A tree is tensors (or numpy arrays) in dicts, lists, tuples and named
tuples; None is no leaf. A leaf's key is its path, "/"-joined: dict keys
(visited in sorted order), list and tuple indices, named-tuple field
names — the reference's keys for the same nesting, so a dict-of-arrays
checkpoint written by either package restores in the other. numpy has no
bfloat16: a bfloat16 tensor is stored as its int16 bit pattern under the
manifest dtype "bfloat16" and viewed back on restore, so it restores bit
for bit. Restore places each leaf on its template leaf's device.

On a mesh of ranks (`specs=` and `mesh=`, a tree of specs in the tree's
structure, the counterpart of the reference's `shardings=`): a save
assembles each leaf from the ranks' blocks (`dist.sharding.assemble`,
collective, every rank calls it) and the mesh's origin writes the full
arrays, synchronously, before every rank passes a barrier; a restore
reads the full, topology-free arrays on every rank and keeps its
`local_block` of each. So a checkpoint written on a (2, 1) mesh restores
on (1, 2), or in one process without `specs`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import assemble, local_block, map_specs

BF16 = "bfloat16"


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_items(tree: Any, prefix: str = "", *,
               is_leaf=None) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) for every leaf of `tree` (None is none), in the
    reference's order. `is_leaf` marks nodes that are leaves whatever
    their type (`nn.common.is_axes` for an axes tree, whose leaves are
    tuples)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if tree is None:
        return
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], join(k), is_leaf=is_leaf)
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from tree_items(getattr(tree, k), join(k),
                                  is_leaf=is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, join(i), is_leaf=is_leaf)
    else:
        yield prefix, tree


def tree_replace(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """`tree` with each leaf replaced by leaves[its key]."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_replace(v, leaves, join(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_replace(getattr(tree, k), leaves, join(k))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_replace(v, leaves, join(i))
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(a numpy copy of a leaf, its manifest dtype); bfloat16 as int16
    bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy(), BF16
        arr = t.numpy().copy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _is_symmetric(a: np.ndarray) -> bool:
    return (a.ndim == 2 and a.shape[0] == a.shape[1] and a.shape[0] >= 256
            and a.dtype == np.float32 and np.allclose(a, a.T, atol=1e-6))


def _host_tree(tree: Any) -> Dict[str, Tuple[np.ndarray, str]]:
    return {key: _to_host(leaf) for key, leaf in tree_items(tree)}


def _write(directory: str, step: int, host: Dict[str, Tuple[np.ndarray, str]],
           keep: int, symg_pack: bool) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"step": step, "keys": [], "symg": [],
                                "time": time.time()}
    for i, (key, (arr, dtype)) in enumerate(host.items()):
        name = f"a{i}"
        if symg_pack and _is_symmetric(arr):
            arrays[name] = arr[np.triu_indices(arr.shape[0])]
            manifest["symg"].append([name, int(arr.shape[0])])
        else:
            arrays[name] = arr
        manifest["keys"].append([key, name, list(arr.shape), dtype])
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                  # atomic publish
    _cleanup(directory, keep)
    return final


def save_checkpoint(directory: str, step: int, tree: Any, *, keep: int = 3,
                    symg_pack: bool = True, specs: Any = None,
                    mesh: Any = None) -> Optional[str]:
    """Atomic synchronous save. Returns the final checkpoint path (on a
    mesh: the origin's; None on the other ranks)."""
    if mesh is None:
        return _write(directory, step, _host_tree(tree), keep, symg_pack)
    full = _assembled(tree, specs, mesh)
    path = (_write(directory, step, _host_tree(full), keep, symg_pack)
            if mesh.is_first else None)
    _barrier(mesh)
    return path


def _assembled(tree: Any, specs: Any, mesh: Any) -> Any:
    """Every leaf of `tree` assembled from the mesh's blocks."""
    return map_specs(lambda t, s: assemble(t, s, mesh)
                     if isinstance(t, torch.Tensor) else t, tree, specs)


def _barrier(mesh: Any) -> None:
    """Wait for every rank of the mesh (after the origin's write)."""
    dist.barrier(group=mesh.group(*mesh.axis_names))


def _cleanup(directory: str, keep: int) -> None:
    done = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in done[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    for d in os.listdir(directory):        # abandoned tmp dirs of crashes
        if d.startswith("tmp."):
            try:
                age = time.time() - os.path.getmtime(os.path.join(directory,
                                                                  d))
                if age > 3600:
                    shutil.rmtree(os.path.join(directory, d),
                                  ignore_errors=True)
            except OSError:
                pass


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    done = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    return int(done[-1].split("_")[1]) if done else None


def restore_checkpoint(directory: str, tree: Any, *,
                       step: Optional[int] = None, specs: Any = None,
                       mesh: Any = None) -> Tuple[int, Any]:
    """Restore into the structure of `tree` (values replaced; each leaf on
    its template leaf's device, a numpy template leaf as numpy) from
    `step`, the latest by default. Returns (step, tree). With `specs` and
    `mesh`, each tensor leaf is this rank's `local_block` of the saved
    array (the template's leaves are blocks)."""
    spec_of = ({} if specs is None else
               dict(tree_items(specs, is_leaf=lambda n: type(n) is tuple)))
    s = step if step is not None else latest_step(directory)
    if s is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{s:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    symg = {name: n for name, n in manifest.get("symg", [])}
    by_key: Dict[str, Tuple[np.ndarray, str]] = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, name, shape, dtype in manifest["keys"]:
            arr = data[name]
            if name in symg:
                n = symg[name]
                full = np.zeros((n, n), dtype=arr.dtype)
                full[np.triu_indices(n)] = arr
                arr = full + np.triu(full, k=1).T
            by_key[key] = (arr.reshape(shape), dtype)

    leaves: Dict[str, Any] = {}
    for key, leaf in tree_items(tree):
        if key not in by_key:
            raise KeyError(f"checkpoint missing key {key!r}")
        arr, dtype = by_key[key]
        if dtype == BF16:
            value = torch.from_numpy(arr.astype(np.int16)).view(
                torch.bfloat16)
        else:
            arr = arr.astype(dtype)
            value = torch.from_numpy(arr) if isinstance(
                leaf, torch.Tensor) else arr
        if isinstance(leaf, torch.Tensor):
            if key in spec_of:
                value = local_block(value, spec_of[key], mesh).clone()
            value = value.to(leaf.device)
        leaves[key] = value
    return s, tree_replace(tree, leaves)


class CheckpointManager:
    """Async keep-k manager used by the trainer."""

    def __init__(self, directory: str, *, keep: int = 3, every: int = 50):
        self.directory = directory
        self.keep = keep
        self.every = every
        self._thread: Optional[threading.Thread] = None
        self.saved_steps: List[int] = []

    def maybe_save(self, step: int, tree: Any, *, force: bool = False,
                   specs: Any = None, mesh: Any = None) -> bool:
        """Save at every `every`-th step (or when forced): the tree is
        copied to the host now and written on a background thread. On a
        mesh (`specs`, `mesh`) the save is `save_checkpoint`'s, written
        by the origin before every rank goes on."""
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        self.wait()
        if mesh is not None:
            save_checkpoint(self.directory, step, tree, keep=self.keep,
                            specs=specs, mesh=mesh)
            self.saved_steps.append(step)
            return True
        host = _host_tree(tree)

        def work():
            _write(self.directory, step, host, self.keep, True)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        self.saved_steps.append(step)
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, tree: Any, *, specs: Any = None,
                       mesh: Any = None) -> Tuple[Optional[int], Any]:
        self.wait()
        if latest_step(self.directory) is None:
            return None, tree
        return restore_checkpoint(self.directory, tree, specs=specs,
                                  mesh=mesh)
