"""Compressed collectives (QuantGr applied to the all-reduce), in two
forms: over an explicit shard dimension, and over a process group.

Port of the reference's `dist/compress.py`. The reference names an axis
of a `shard_map` or `vmap` and lets `psum`/`pmax` reduce over it. Here,
in the STACKED form (`group=None`), the participants' tensors are stacked
along a leading dimension S of one tensor, and each function returns what
every participant would hold: a (S, ...) result whose S slices are equal
(an expanded view, not S copies), as `jax.vmap(fn, axis_name=...)`
returns it. In the GROUP form each participant is a rank of a
`torch.distributed` process group (`group=`, a line of a
`launch.mesh.Mesh`: `mesh.group("shard")`), passes its own tensor, and
gets the result back; `psum`/`pmax` are `all_reduce`s over the group, and
every byte handed to one is counted in `WIRE`.

The two forms agree bit for bit where the sum is exact whatever its
order: the int8 wire's sums (integers of at most 127 times the group
size, exact in float32) and assemblies of disjoint zero-padded blocks
(the halo, the halo delta). An exact sum of overlapping fp32 terms
(`exact_psum_mean` of gradients) may differ by the rounding of another
order: within (S - 1) float32 ulps of the largest partial sum.

Each participant quantizes to int8 against one globally agreed scale
(the pmax of the absmaxes), the collective would move a quarter of the
bytes, and the dequantization follows the sum. The arithmetic is that of
the reference under `jit`, which its sharded plan always is (XLA's CPU
backend, checked bit for bit by `tests/test_torch_partition.py`):

  * the scale is max(amax, 1e-12) times the float32 reciprocal of 127
    (XLA turns the division by the constant into that product, as for
    `core.quant.quantize_rowwise`), and a mean's 1/S likewise;
  * q = round(g / scale), half to even, clipped to +-127: a division by
    the runtime scale, which XLA keeps;
  * the residual g - q * scale is one fused multiply-add (computed here
    in float64, exact, and rounded once);
  * the sum over the participants runs in their order, from the first.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

INT8_MAX = 127.0
INV_INT8_MAX = float(torch.tensor(1.0 / INT8_MAX, dtype=torch.float32))

# what this process handed to all_reduce (`psum`, `pmax`): calls and
# bytes, read by the per-rank wire accounting of the serving mesh
WIRE = {"calls": 0, "bytes": 0}


def ring_psum_nbytes(shards: int, elems: float, *,
                     bytes_per_elt: float) -> float:
    """Bytes ONE participant moves in a ring all-reduce over `elems`
    elements: 2(S-1)/S of the buffer (reduce-scatter + all-gather). The
    serving engine's collective-byte counters (`GraphServe._halo_bytes`)
    and the sharded latency model (`core.partition.
    modelled_sharded_latency`) both price the wire here. A 1-shard ring
    moves nothing."""
    if shards <= 1:
        return 0.0
    return 2.0 * (shards - 1) / shards * elems * bytes_per_elt


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    WIRE["calls"] += 1
    WIRE["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=op, group=group)
    return t


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the ranks of `group`, on each of them (a new
    tensor). A floating sum gets + 0.0, so a -0.0 comes back +0.0 also
    from a group of one rank, as from a sum that starts from 0."""
    out = _all_reduce(t.clone(), dist.ReduceOp.SUM, group)
    return out + 0.0 if out.is_floating_point() else out


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `t` over the ranks of `group`."""
    return _all_reduce(t.clone(), dist.ReduceOp.MAX, group)


def _inv(n: int) -> float:
    """1/n rounded to float32: a mean is a product by it."""
    return float(torch.tensor(1.0 / n, dtype=torch.float32))


def _psum(g: torch.Tensor) -> torch.Tensor:
    """Sum over the leading shard dimension, in shard order from the
    first; `+ 0.0` gives +0.0 where every term is a zero, as a reduction
    that starts from 0 does."""
    total = g[0] + 0.0
    for s in range(1, g.shape[0]):
        total = total + g[s]
    return total


def _everyone(total: torch.Tensor, shards: int) -> torch.Tensor:
    """The all-reduced value as each of `shards` participants holds it."""
    return total.expand(shards, *total.shape)


def exact_psum_mean(g: torch.Tensor, *, group=None) -> torch.Tensor:
    """Mean-all-reduce of g in fp32: g (S, ...) stacked, or this rank's
    term over `group`."""
    if group is None:
        s = g.shape[0]
        return _everyone(_psum(g) * _inv(s), s)
    return psum(g, group) * _inv(dist.get_world_size(group))


def global_scale(g: torch.Tensor, *, group=None) -> torch.Tensor:
    """The agreed int8 scale of g: its absmax over every participant (the
    stacked dim, or the pmax over `group`), at least 1e-12, over 127."""
    amax = g.abs().amax()
    if group is not None:
        amax = pmax(amax, group)
    return torch.clamp_min(amax, 1e-12) * INV_INT8_MAX


def quantize_wire(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """g's int8 wire values against `scale`, as float32: round(g / scale),
    half to even, clipped to +-127 (+ 0.0: an int8 has no -0)."""
    return torch.clamp(torch.round(g / scale), -INT8_MAX, INT8_MAX) + 0.0


def compressed_psum(g: torch.Tensor, *, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed sum-all-reduce of g (QuantGr on the wire): g (S,
    ...) stacked, or this rank's term over `group`.

    Returns (sum, residual): each participant's contribution is off by at
    most scale/2 per element, so the sum by at most S * scale/2, where
    scale = global absmax / 127. When the participants' buffers are
    DISJOINT zero-padded blocks (the sharded GNN halo exchange), zeros
    quantize exactly, each output element receives one non-zero
    contribution, and its error stays within scale/2 whatever the shard
    count. `residual` = g - its represented value, for error feedback.
    """
    scale = global_scale(g, group=group)
    q = quantize_wire(g, scale)
    residual = (g.double() - q.double() * scale.double()).to(g.dtype)
    if group is None:
        return _everyone(_psum(q) * scale, g.shape[0]), residual
    # the wire's values are whole numbers: their sum is exact in any order
    return psum(q, group) * scale, residual


def compressed_psum_mean(g: torch.Tensor, *, group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed mean-all-reduce with error feedback: (mean,
    residual), |mean - exact mean| <= scale/2 elementwise."""
    total, residual = compressed_psum(g, group=group)
    s = g.shape[0] if group is None else dist.get_world_size(group)
    return total * _inv(s), residual


def compressed_psum_delta(rows: torch.Tensor, owners: torch.Tensor, *,
                          compress: bool = True,
                          group: Optional[object] = None) -> torch.Tensor:
    """Halo-DELTA exchange (DESIGN.md §15): assemble only the dirty
    boundary rows from the shards that own them.

    rows: (S, k, width), each participant's local copy of the k dirty
    rows, or with `group` this rank's (k, width); owners: (k,) (or (S,
    k)) the shard (the rank of `group`) that owns each row. A
    participant's rows it does NOT own are masked to zero, so the
    contributions are disjoint and the sum is an assembly: the wire would
    move k rows instead of full_rows (`ring_psum_nbytes` over k * width
    elements prices it). `compress=True` rides the int8 wire of
    `compressed_psum` (<= scale/2 elementwise error); `compress=False`
    sums exact fp32, a bit-exact assembly.
    """
    if group is not None:
        mine = (owners.to(rows.device) == dist.get_rank(group))
        buf = rows * mine.to(rows.dtype)[:, None]
        if compress:
            return compressed_psum(buf, group=group)[0]
        return psum(buf, group)
    idx = torch.arange(rows.shape[0], device=rows.device)
    mine = (owners.to(rows.device) == idx[:, None]).to(rows.dtype)
    buf = rows * mine[..., None]
    if compress:
        return compressed_psum(buf)[0]
    return _everyone(_psum(buf), rows.shape[0])
