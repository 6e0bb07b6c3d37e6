"""Compressed collectives (QuantGr applied to the all-reduce), over an
explicit shard dimension.

Port of the reference's `dist/compress.py`. The reference names an axis
of a `shard_map` or `vmap` and lets `psum`/`pmax` reduce over it; here
the participants' tensors are stacked along a leading dimension S of one
tensor, and each function returns what every participant would hold: a
(S, ...) result whose S slices are equal (an expanded view, not S
copies), as `jax.vmap(fn, axis_name=...)` returns it.

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

from typing import Tuple

import torch

INT8_MAX = 127.0
INV_INT8_MAX = float(torch.tensor(1.0 / INT8_MAX, dtype=torch.float32))


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


def exact_psum_mean(g: torch.Tensor) -> torch.Tensor:
    """Mean-all-reduce of g (S, ...) in fp32."""
    s = g.shape[0]
    inv = float(torch.tensor(1.0 / s, dtype=torch.float32))
    return _everyone(_psum(g) * inv, s)


def global_scale(g: torch.Tensor) -> torch.Tensor:
    """The agreed int8 scale of g (S, ...): its absmax over every
    participant (the pmax), at least 1e-12, over 127."""
    return torch.clamp_min(g.abs().amax(), 1e-12) * INV_INT8_MAX


def quantize_wire(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """g's int8 wire values against `scale`, as float32: round(g / scale),
    half to even, clipped to +-127 (+ 0.0: an int8 has no -0)."""
    return torch.clamp(torch.round(g / scale), -INT8_MAX, INT8_MAX) + 0.0


def compressed_psum(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed sum-all-reduce of g (S, ...) (QuantGr on the wire).

    Returns (sum, residual): each participant's contribution is off by at
    most scale/2 per element, so the sum by at most S * scale/2, where
    scale = global absmax / 127. When the participants' buffers are
    DISJOINT zero-padded blocks (the sharded GNN halo exchange), zeros
    quantize exactly, each output element receives one non-zero
    contribution, and its error stays within scale/2 whatever the shard
    count. `residual` = g - its represented value, for error feedback.
    """
    scale = global_scale(g)
    q = quantize_wire(g, scale)
    residual = (g.double() - q.double() * scale.double()).to(g.dtype)
    return _everyone(_psum(q) * scale, g.shape[0]), residual


def compressed_psum_mean(g: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed mean-all-reduce with error feedback: (mean,
    residual), |mean - exact mean| <= scale/2 elementwise."""
    total, residual = compressed_psum(g)
    s = g.shape[0]
    inv = float(torch.tensor(1.0 / s, dtype=torch.float32))
    return total * inv, residual


def compressed_psum_delta(rows: torch.Tensor, owners: torch.Tensor, *,
                          compress: bool = True) -> torch.Tensor:
    """Halo-DELTA exchange (DESIGN.md §15): assemble only the dirty
    boundary rows from the shards that own them.

    rows: (S, k, width), each participant's local copy of the k dirty
    rows; owners: (k,) (or (S, k)) the shard that owns each row. A
    participant's rows it does NOT own are masked to zero, so the
    contributions are disjoint and the sum is an assembly: the wire would
    move k rows instead of full_rows (`ring_psum_nbytes` over k * width
    elements prices it). `compress=True` rides the int8 wire of
    `compressed_psum` (<= scale/2 elementwise error); `compress=False`
    sums exact fp32, a bit-exact assembly.
    """
    idx = torch.arange(rows.shape[0], device=rows.device)
    mine = (owners.to(rows.device) == idx[:, None]).to(rows.dtype)
    buf = rows * mine[..., None]
    if compress:
        return compressed_psum(buf)[0]
    return _everyone(_psum(buf), rows.shape[0])
