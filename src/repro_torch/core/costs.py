"""Modelled compute and memory constants of the port's cost rules, for one
NVIDIA H100 SXM.

Only what `core.sparsity.agg_cost_model` reads lives here: the rate of the
port's fp32 kernels, the HBM rate, and the GraSp per-entry overhead. The
host-link and interconnect constants arrive with sharding (ROADMAP queue 1
item 11). The reference's `costs.py` models a TPU-v4 part; none of its
numbers is copied. `agg_cost_model` reads these names at call time, so a
test may set them.
"""
from __future__ import annotations

# fp32 outside the tensor cores, the rate the port's SIMT tile runs on:
# 67 TFLOP/s (NVIDIA H100 SXM data sheet, 700 W).
FP32_PEAK = 67e12
# Sustained share of that peak: the port's 64x64 fp32 tile measured 25
# TFLOP/s, 0.38 of the peak, on the serving shapes (`chip_smoke.py`,
# PERF.md §6; NVIDIA H100 80GB HBM3 at 700 W).
FP32_DERATE = 0.38
FP32_RATE = FP32_PEAK * FP32_DERATE      # modelled fp32 FLOP/s
# HBM3 bytes/s (NVIDIA H100 SXM data sheet).
HBM_BW = 3.35e12
# Cost of one (block row, list entry, 128-column strip) step of the GraSp
# kernels beyond its bytes and flops: a shared-memory sync and a block
# column read per entry, and a small product that fills the SIMT tile
# less well than a dense one. A first guess, not measured yet;
# `chip_smoke.py` prints the measured dense and GraSp aggregation times
# per bucket that replace it.
GRASP_STEP_OVERHEAD_S = 2e-8
