"""GraSp: ZVC packing, the 128x128 block bitmap, and the aggregation
backend rule (DESIGN.md §10).

Port of the reference's `core/sparsity.py`. The host half is numpy, a copy
of the reference's: ZVC storage packing, the host block compaction
(`to_block_sparse`, `pad_block_sparse`, `block_stats`), the serving
budget `grasp_max_nnz`, the cost rule (`agg_cost_model`,
`select_agg_backend`, with the port's H100 constants from `core.costs`,
read at call time) and the BFS reordering. The device half is torch:
`stack_block_sparse`, `block_counts` and `compact_block_sparse`, which
derives the budgeted structure from a dense Â already on the device.

`BlockSparse` is a plain dataclass: its array fields (`LEAVES`) are numpy
arrays on the host and tensors on a device, with a leading batch B once
stacked; `block_size` and `shape` are static. Every serving-path structure
is padded to its bucket's `grasp_max_nnz` budget, so all structures of a
bucket share one shape and stack into one batched operand.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from . import costs
from .graph import MXU_TILE


# ----------------------------- element-level ZVC ---------------------------

def zvc_pack(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...]]:
    """Pack: (nonzero values, packed bitmap bytes, original shape)."""
    flat = x.reshape(-1)
    mask = flat != 0
    values = flat[mask]
    bitmap = np.packbits(mask.astype(np.uint8))
    return values.astype(x.dtype), bitmap, x.shape


def zvc_unpack(values: np.ndarray, bitmap: np.ndarray, shape: Tuple[int, ...],
               dtype=np.float32) -> np.ndarray:
    total = int(np.prod(shape))
    mask = np.unpackbits(bitmap)[:total].astype(bool)
    out = np.zeros(total, dtype=dtype)
    out[mask] = values
    return out.reshape(shape)


def zvc_compressed_bytes(x: np.ndarray) -> int:
    """Bytes after ZVC: non-zeros * itemsize + bitmap (1 bit/elem)."""
    nnz = int(np.count_nonzero(x))
    return nnz * x.dtype.itemsize + (x.size + 7) // 8


# ----------------------------- block-level bitmap --------------------------

LEAVES = ("blocks", "block_cols", "counts", "bitmap")


@dataclasses.dataclass
class BlockSparse:
    """Block-compacted matrix for the `bitmap_spmm` kernels.

    blocks:     (B?, n_row_blocks * max_nnz, bs, bs) the gathered non-zero
                blocks, row-major order within each block row.
    block_cols: (B?, n_row_blocks, max_nnz) int32 column block of each
                entry; padded entries hold a valid block index.
    counts:     (B?, n_row_blocks) int32 real entries in each block row.
    bitmap:     (B?, n_row_blocks, n_col_blocks) uint8 — diagnostics.
    """

    blocks: object
    block_cols: object
    counts: object
    bitmap: object
    block_size: int
    shape: Tuple[int, int]

    @property
    def density(self) -> float:
        if isinstance(self.bitmap, torch.Tensor):
            return float(self.bitmap.double().mean())
        return float(np.asarray(self.bitmap).mean())

    @property
    def max_nnz(self) -> int:
        """The per-block-row list budget this structure is padded to."""
        return int(self.block_cols.shape[-1])

    @property
    def nbytes(self) -> int:
        """Bytes the compacted form occupies / moves (blocks + indices)."""
        return int(sum(_nbytes(getattr(self, f))
                       for f in ("blocks", "block_cols", "counts")))


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def upload_block_sparse(sp: BlockSparse, device: DeviceLike = None
                        ) -> BlockSparse:
    """The same structure with every leaf a tensor on `device` (values and
    dtypes kept)."""
    dev = resolve_device(device)
    return dataclasses.replace(sp, **{
        f: torch.as_tensor(np.asarray(getattr(sp, f))).to(dev)
        for f in LEAVES})


def to_block_sparse(a: np.ndarray, *, block_size: int = MXU_TILE,
                    bitmap: Optional[np.ndarray] = None) -> BlockSparse:
    """Host-side block compaction. `bitmap` short-circuits the O(n·m)
    non-zero reduction when the caller already ran `block_stats` on this
    matrix (the serving backend rule does — one scan, not two)."""
    n, m = a.shape
    bs = block_size
    if n % bs or m % bs:
        raise ValueError(f"shape {a.shape} not a multiple of block {bs} "
                         "(NodePad first)")
    rb, cb = n // bs, m // bs
    view = a.reshape(rb, bs, cb, bs).transpose(0, 2, 1, 3)  # (rb, cb, bs, bs)
    if bitmap is None:
        bitmap = (np.abs(view).sum(axis=(2, 3)) > 0).astype(np.uint8)
    counts = bitmap.sum(axis=1).astype(np.int32)
    max_nnz = max(int(counts.max()), 1)
    block_cols = np.zeros((rb, max_nnz), dtype=np.int32)
    blocks = np.zeros((rb * max_nnz, bs, bs), dtype=a.dtype)
    for i in range(rb):
        cols = np.nonzero(bitmap[i])[0]
        block_cols[i, : len(cols)] = cols
        for k, c in enumerate(cols):
            blocks[i * max_nnz + k] = view[i, c]
    return BlockSparse(blocks=blocks, block_cols=block_cols, counts=counts,
                       bitmap=bitmap, block_size=bs, shape=(n, m))


def from_block_sparse(sp: BlockSparse) -> np.ndarray:
    """Host densification of one (unbatched) structure."""
    n, m = sp.shape
    bs = sp.block_size
    blocks, cols, counts = (np.asarray(getattr(sp, f))
                            for f in ("blocks", "block_cols", "counts"))
    max_nnz = cols.shape[1]
    out = np.zeros((n, m), dtype=blocks.dtype)
    for i in range(n // bs):
        for k in range(int(counts[i])):
            c = int(cols[i, k])
            out[i * bs:(i + 1) * bs, c * bs:(c + 1) * bs] = (
                blocks[i * max_nnz + k])
    return out


# ------------------------- batched serving form (DESIGN.md §10) ------------

def grasp_max_nnz(capacity: int, *, block_size: int = MXU_TILE) -> int:
    """Block-list budget for one NodePad bucket (monotone in capacity): a
    quarter of the column blocks, at least 2 and at most all of them."""
    cb = max(capacity // block_size, 1)
    return min(cb, max(2, -(-cb // 4)))          # clamp(ceil(cb/4), 2, cb)


def pad_block_sparse(sp: BlockSparse, max_nnz: int) -> BlockSparse:
    """Pad a host-compacted structure's block lists to a bucket budget.
    Raises when the structure is too dense for the budget —
    `select_agg_backend` routes those graphs dense first."""
    rb, mx = sp.block_cols.shape
    if mx > max_nnz:
        raise ValueError(
            f"block structure needs max_nnz={mx} > budget {max_nnz}; "
            "select_agg_backend should have routed this graph dense")
    if mx == max_nnz:
        return sp
    bs = sp.block_size
    cols = np.zeros((rb, max_nnz), np.int32)
    cols[:, :mx] = sp.block_cols
    blocks = np.zeros((rb, max_nnz, bs, bs), np.asarray(sp.blocks).dtype)
    blocks[:, :mx] = np.asarray(sp.blocks).reshape(rb, mx, bs, bs)
    return dataclasses.replace(sp, blocks=blocks.reshape(rb * max_nnz, bs, bs),
                               block_cols=cols)


def stack_block_sparse(sps: Sequence[BlockSparse]) -> BlockSparse:
    """Stack same-bucket device structures into one batched (B, ...)
    operand. Requires identical (block_size, shape, max_nnz), which every
    structure padded to one bucket's budget has."""
    if not sps:
        raise ValueError("cannot stack an empty block-sparse batch")
    head = sps[0]
    for sp in sps[1:]:
        if (sp.block_size, sp.shape, sp.max_nnz) != (
                head.block_size, head.shape, head.max_nnz):
            raise ValueError(
                "mixed block-sparse structures in one batch: "
                f"{(sp.block_size, sp.shape, sp.max_nnz)} vs "
                f"{(head.block_size, head.shape, head.max_nnz)} "
                "(pad to one bucket budget first)")
    return dataclasses.replace(head, **{
        f: torch.stack([getattr(sp, f) for sp in sps]) for f in LEAVES})


def _block_nonzero(a: torch.Tensor, bs: int) -> torch.Tensor:
    """(rb, cb) bool: which bs x bs blocks of a hold a non-zero."""
    n, m = a.shape
    return a.reshape(n // bs, bs, m // bs, bs).abs().sum(dim=(1, 3)) > 0


def block_counts(a: torch.Tensor, *, block_size: int = MXU_TILE
                 ) -> torch.Tensor:
    """Per-block-row non-zero block counts of one dense Â on its device —
    the one reduction the backend rule needs; a graph routed dense never
    pays the block gather of `compact_block_sparse`."""
    return _block_nonzero(a, block_size).sum(dim=1, dtype=torch.int32)


def compact_block_sparse(a: torch.Tensor, *, max_nnz: int,
                         block_size: int = MXU_TILE
                         ) -> Tuple[BlockSparse, torch.Tensor]:
    """Device-side `to_block_sparse` at a budget: derive the structure from
    a dense Â on its device, moving no bytes over the host link.

    Padded entries gather genuine all-zero blocks at valid column indices:
    a stable sort puts the non-zero columns first in ascending order and
    the zero blocks after them in ascending order, as the reference's
    `jnp.argsort` does. Returns (structure, true_counts): `true_counts` is
    the UNCLAMPED per-row count — a row above `max_nnz` means the structure
    is truncated and must not serve; `counts` inside is clamped.
    """
    n, m = a.shape
    bs = block_size
    rb, cb = n // bs, m // bs
    nz = _block_nonzero(a, bs)                                # (rb, cb)
    counts_true = nz.sum(dim=1, dtype=torch.int32)
    keys = torch.where(nz, torch.arange(cb, dtype=torch.int32,
                                        device=a.device), cb)
    order = torch.argsort(keys, dim=1, stable=True)[:, :max_nnz]
    view = a.reshape(rb, bs, cb, bs).transpose(1, 2)     # (rb, cb, bs, bs)
    blocks = torch.take_along_dim(view, order[:, :, None, None], dim=1)
    return BlockSparse(blocks=blocks.reshape(-1, bs, bs).contiguous(),
                       block_cols=order.to(torch.int32).contiguous(),
                       counts=torch.clamp(counts_true, max=max_nnz),
                       bitmap=nz.to(torch.uint8),
                       block_size=bs, shape=(n, m)), counts_true


def block_stats(a: np.ndarray, *, block_size: int = MXU_TILE) -> Dict:
    """Host-side block-bitmap statistics of one dense operand (the O(cap²)
    pass the host stage runs to feed the backend rule), with the bitmap
    itself so a following `to_block_sparse` skips its own scan."""
    a = np.asarray(a)
    n, m = a.shape
    rb, cb = n // block_size, m // block_size
    nz = np.abs(a.reshape(rb, block_size, cb, block_size)).sum(axis=(1, 3)) > 0
    counts = nz.sum(axis=1)
    return {"nnz_blocks": int(counts.sum()),
            "max_row_nnz": int(counts.max()) if counts.size else 0,
            "n_row_blocks": rb, "n_col_blocks": cb,
            "block_density": float(nz.mean()) if nz.size else 0.0,
            "bitmap": nz.astype(np.uint8)}


# --------------------- backend dispatch rule (DESIGN.md §10) ----------------

def agg_cost_model(capacity: int, feats: int, *, nnz_blocks: int,
                   max_nnz: int, block_size: int = MXU_TILE
                   ) -> Tuple[float, float]:
    """Modelled aggregation latency (dense_s, grasp_s) for one Â @ H.

    Dense: one (cap, cap) @ (cap, F) product — the larger of its flops at
    the dense kernel's rate and its bytes at the HBM rate. GraSp: flops of
    the `nnz_blocks` real blocks only at the walk's rate, bytes of the whole
    padded budget (`rb * max_nnz` blocks and H tiles), plus a per-step
    overhead. Both pay a launch's fixed cost. Reads `core.costs` at call
    time.
    """
    bs = block_size
    rb = max(capacity // bs, 1)
    dense_flops = 2.0 * capacity * capacity * feats
    dense_bytes = 4.0 * (capacity * capacity + 2 * capacity * feats)
    dense_s = (max(dense_flops / costs.DENSE_RATE,
                   dense_bytes / costs.HBM_BW) + costs.AGG_CALL_S)
    steps = rb * max_nnz * max(feats // 128, 1)
    grasp_flops = 2.0 * nnz_blocks * bs * bs * feats
    grasp_bytes = 4.0 * (rb * max_nnz * (bs * bs + bs * feats)
                         + capacity * feats)
    grasp_s = (max(grasp_flops / costs.GRASP_RATE,
                   grasp_bytes / costs.HBM_BW)
               + steps * costs.GRASP_STEP_OVERHEAD_S + costs.AGG_CALL_S)
    return dense_s, grasp_s


def select_agg_backend(capacity: int, feats: int, *, nnz_blocks: int,
                       max_row_nnz: int, mode: str = "auto",
                       block_size: int = MXU_TILE,
                       measured: Optional[Tuple[Optional[float],
                                                Optional[float]]] = None
                       ) -> Tuple[str, float, float]:
    """The per-(graph, bucket) aggregation backend: "dense" | "grasp".

    A block row denser than the bucket's budget cannot be represented, so
    it serves dense whatever the mode; its grasp cost is priced at the list
    width it would need. Otherwise `mode="grasp"` forces the sparse path
    and `mode="auto"` takes the cheaper one — by `measured=(dense_s,
    grasp_s)` when both sides are measured, else by `agg_cost_model`.
    Returns (backend, modelled dense_s, modelled grasp_s).
    """
    if mode not in ("auto", "grasp"):
        raise ValueError(f"mode must be 'auto' or 'grasp', got {mode!r}")
    budget = grasp_max_nnz(capacity, block_size=block_size)
    width = max(budget, max_row_nnz)
    dense_s, grasp_s = agg_cost_model(capacity, feats, nnz_blocks=nnz_blocks,
                                      max_nnz=width, block_size=block_size)
    if max_row_nnz > budget:
        return "dense", dense_s, grasp_s
    if mode == "grasp":
        return "grasp", dense_s, grasp_s
    rank_dense, rank_grasp = dense_s, grasp_s
    if measured is not None and measured[0] is not None \
            and measured[1] is not None:
        rank_dense, rank_grasp = float(measured[0]), float(measured[1])
    return ("grasp" if rank_grasp < rank_dense else "dense"), dense_s, grasp_s


def bfs_reorder(adj: np.ndarray, num_nodes: int) -> np.ndarray:
    """BFS (Cuthill–McKee-like) node permutation that clusters
    neighbourhoods near the diagonal, so fewer 128x128 blocks are non-zero.
    Returns `perm` with A' = A[perm][:, perm]."""
    n = num_nodes
    deg = (adj[:n, :n] > 0).sum(axis=1)
    visited = np.zeros(n, dtype=bool)
    order = []
    for seed in np.argsort(deg):             # lowest degree first
        if visited[seed]:
            continue
        queue = [int(seed)]
        visited[seed] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            nbrs = np.nonzero(adj[v, :n])[0]
            nbrs = nbrs[~visited[nbrs]]
            nbrs = nbrs[np.argsort(deg[nbrs])]
            visited[nbrs] = True
            queue.extend(int(x) for x in nbrs)
    return np.asarray(order + list(range(n, adj.shape[0])), dtype=np.int64)


def apply_reorder(a: np.ndarray, perm: np.ndarray) -> np.ndarray:
    return a[perm][:, perm]


def sparsity_report(a: np.ndarray, *, block_size: int = MXU_TILE) -> dict:
    sp = to_block_sparse(a, block_size=block_size)
    return {
        "element_density": float(np.count_nonzero(a) / a.size),
        "block_density": sp.density,
        "dense_bytes": int(a.nbytes),
        "zvc_bytes": zvc_compressed_bytes(a),
        "block_compacted_bytes": sp.nbytes,
        "flop_skip_fraction": 1.0 - sp.density,
    }
