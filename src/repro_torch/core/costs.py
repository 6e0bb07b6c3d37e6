"""Modelled compute and memory constants of the port's cost rules, for one
NVIDIA H100 SXM.

What `core.sparsity.agg_cost_model` reads lives here: the rates of the
port's two aggregation kernels, the HBM rate, the GraSp walk's per-step
cost and a launch's fixed cost; the int8 rate that, with `DENSE_RATE` and
`HBM_BW`, prices the latency bank's modelled seed
(`runtime.gnn_server.GraphServe._modelled_batch_s`); and the host link
that `transfer_cost` prices for the CacheG manager's re-materialization
tie-break (`runtime.cache`); and the terms of the GraphSplit planners
(`core.partition`): the host's scalar rate and a gather's bytes for the
host/device stage cut, and the card-to-card link and a collective's fixed
cost for `modelled_sharded_latency`'s halo exchange. The reference's
`costs.py` models a TPU-v4 part; none of its numbers is copied. Its
`MXU_RATE` is `DENSE_RATE` here. `agg_cost_model`, `transfer_cost`, the
bank's seed and the partition planners read these names at call time, so
a test may set them.

The four measured terms come from `chip_smoke.py`'s `[agg]` step (PERF.md
§6; NVIDIA H100 80GB HBM3 at 700 W), on the Cora GCN's layer-1 Â @ H (F
= 128) of a 4-graph serving batch of clustered graphs at buckets 1024 and
3072, each call timed queued behind a spin kernel.
"""
from __future__ import annotations

# fp32 products per second of the dense backend's Â @ H on block_matmul's
# 3xTF32 kernel (tc_gemm_tile.cuh's gemm_3xtf32_kernel), at bucket 3072.
DENSE_RATE = 48.66e12
# fp32 products per second of the GraSp walk (bsr_tile.cuh, 3xTF32 on the
# same tile) over the real blocks at bucket 3072, once the time of the
# same call with every count 0 is taken off.
GRASP_RATE = 61.86e12
# HBM3 bytes/s (NVIDIA H100 SXM data sheet).
HBM_BW = 3.35e12
# int8 operations per second of the int8 tensor cores, dense (NVIDIA H100
# SXM data sheet: 1,979 TOPS, 3,958 with sparsity). A peak, not a
# measurement: the bank's seed only orders cold keys, and the first
# measured batch replaces it.
INT8_RATE = 1979e12
# Cost of one (block row, list entry, 128-column strip) step of the GraSp
# walk beyond its bytes, flops and call: what is left of the bucket-1024
# call at GRASP_RATE, over its list steps.
GRASP_STEP_OVERHEAD_S = 45.4e-9
# Fixed cost of one aggregation launch, per graph of the 4-graph batch
# that shares it: the walk's call with every count 0 at bucket 1024. It is
# charged to both backends: the dense launch of the same output has the
# walk's grid, block and store (an empty product would run them alone).
AGG_CALL_S = 1.01e-6

# Host link, pinned host memory to the card, and the fixed cost of one
# copy: chip_smoke.py's `[intake]` step (PERF.md §6; NVIDIA H100 80GB HBM3
# at 700 W), CUDA events around 20 queued copies of 37.7 MB and of 4
# bytes from pinned memory; the rate is the difference over the bytes.
# Pageable memory reached 12.7e9 B/s there.
HOST_LINK_BYTES_PER_S = 53.83e9
LAUNCH_LATENCY_S = 6.08e-6

# Gather/scatter bytes/s: a 4-byte random read still moves a 32-byte
# sector of HBM, so at most an eighth of HBM_BW is useful. A modelled
# figure, not a measurement.
GATHER_BW = HBM_BW / 8
# Host scalar operations per second: 8 host cores at about 3 GHz, one
# operation a cycle. An assumption, not a measurement.
CPU_RATE = 2.4e10

# Card-to-card link that a halo exchange across shards would cross: NVLink
# 4 of an H100 SXM, 900 GB/s both directions together (NVIDIA H100 data
# sheet), 450 GB/s one way.
DEVICE_LINK_BYTES_PER_S = 450e9
# Fixed cost of one collective across cards. An assumption (a few kernel
# launches' worth) until a multi-card run measures it; the port's one-card
# sharded path simulates the shard axis and runs no collective.
COLLECTIVE_LATENCY_S = 10e-6


def transfer_cost(nbytes: int) -> float:
    """Modelled seconds to move `nbytes` host→device in one copy."""
    return LAUNCH_LATENCY_S + nbytes / HOST_LINK_BYTES_PER_S
