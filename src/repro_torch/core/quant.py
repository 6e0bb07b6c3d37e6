"""QuantGr: symmetric, static INT8 quantization.

Port of the reference's `core/quant.py`, with the same semantics:
  * symmetric (zero_point = 0, one scale for +/-),
  * static (scales fixed offline during a calibration pass, never at
    runtime),
  * both weights and activations quantized,
  * INT8 matmuls accumulate in INT32.

Calibration = run an FP32 forward over calibration inputs, record absmax
per tensor (activations: per-tensor; weights: per-output-channel).

Plain dataclasses of tensors take the place of the reference's pytrees;
`core.models.ExecutionPlan` reads their leaves for its signature count.
Rounding is `torch.round`, which rounds half to even like `jnp.round`.

Scales follow the reference as its serving engine runs it. Calibration
(`calibrate_absmax`, `quantize_linear`, `quantize_agg`) runs eagerly
there and divides by 127. Â's per-row scales (`quantize_rowwise`) are
derived inside jitted code there (the tier-operand deriver and the plans),
where XLA turns the division by the constant 127 into a multiply by its
float32 reciprocal; the port computes them that way too, so its int8 Â
equals the reference's served int8 Â bit for bit.

Exact integer products: every plain s8 x s8 product here (and in the
kernels' plain versions and `kernels/ref.py`) goes through
`kernels.int8_matmul.int_matmul`, a float64 `torch.matmul` converted back
to int32. It is exact because every partial sum is an integer of magnitude
at most K * 127**2, far below 2**53. `torch.matmul` on int8 tensors returns
int8 and wraps, and CUDA has no integer `torch.matmul` at all. With
`use_kernel`, the products run through the `int8_matmul` CUDA kernel
instead, which equals the plain path bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.int8_matmul import INT8_MAX, int_matmul, quantize_s8

INV_INT8_MAX = float(torch.tensor(1.0 / INT8_MAX, dtype=torch.float32))


@dataclasses.dataclass
class QParams:
    """Static quantization parameters for one tensor."""
    scale: torch.Tensor   # () for per-tensor, (C,) for per-channel


def calibrate_absmax(x: torch.Tensor, *, axis: Optional[int] = None
                     ) -> QParams:
    """Static calibration: scale = absmax / 127 (symmetric)."""
    amax = x.abs().max() if axis is None else x.abs().amax(dim=axis)
    return QParams(scale=torch.clamp_min(amax, 1e-8) / INT8_MAX)


def quantize(x: torch.Tensor, q: QParams) -> torch.Tensor:
    return quantize_s8(x, q.scale)


def dequantize(xq: torch.Tensor, q: QParams) -> torch.Tensor:
    return xq.to(torch.float32) * q.scale


def quantized_matmul_ref(xq: torch.Tensor, wq: torch.Tensor,
                         sx: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """INT8 x INT8 -> INT32 accumulate -> FP32 rescale (plain oracle)."""
    return int_matmul(xq, wq).to(torch.float32) * (sx * sw)


@dataclasses.dataclass
class QuantizedLinear:
    """Offline-quantized weight + static activation scale (QuantGr layer)."""
    wq: torch.Tensor        # (in, out) int8
    w_scale: torch.Tensor   # (out,) per-channel
    x_scale: torch.Tensor   # () per-tensor, from calibration


def quantize_linear(w: torch.Tensor, calib_x: torch.Tensor
                    ) -> QuantizedLinear:
    """Offline: per-channel weight quant + per-tensor activation
    calibration."""
    qw = calibrate_absmax(w, axis=0)           # (out,) channel scales
    qx = calibrate_absmax(calib_x)             # () tensor scale
    return QuantizedLinear(wq=quantize(w, qw), w_scale=qw.scale,
                           x_scale=qx.scale)


def apply_quantized_linear(x: torch.Tensor, ql: QuantizedLinear, *,
                           use_kernel: bool = False) -> torch.Tensor:
    """Runtime: static-scale activation quant -> int8 matmul -> dequant.
    x: (B?, N, in)."""
    xq = quantize_s8(x, ql.x_scale)
    if use_kernel:
        return kops.int8_matmul(xq, ql.wq, ql.x_scale, ql.w_scale)
    return quantized_matmul_ref(xq, ql.wq, ql.x_scale, ql.w_scale)


@dataclasses.dataclass
class QuantizedAgg:
    """QuantGr for the AGGREGATION matmul: Â quantized with per-row scales
    (rows are the normalized neighborhoods), H quantized with a static
    calibration scale."""
    aq: torch.Tensor        # (B?, N, N) int8
    a_scale: torch.Tensor   # (B?, N, 1) per-row
    h_scale: torch.Tensor   # () static activation scale


def quantize_rowwise(a: torch.Tensor):
    """Per-row symmetric INT8 quantization -> (aq, a_scale).

    The Â half of QuantGr aggregation on the serving paths, in-forward
    (`quantize_agg_dynamic`) and cached (`core.models.
    derive_tier_operands`) — one rounding rule, so both give identical
    int8 Â. The scale is amax times the float32 reciprocal of 127, as the
    reference's compiled serving code computes it (module docstring).
    """
    amax = torch.clamp_min(a.abs().amax(dim=-1, keepdim=True), 1e-8)
    a_scale = amax * INV_INT8_MAX
    return quantize_s8(a, a_scale), a_scale


def quantize_agg(norm_adj: torch.Tensor, calib_h: torch.Tensor
                 ) -> QuantizedAgg:
    """Offline: one graph's Â row-quantized, H's scale calibrated; both
    divide by 127, as the reference's eager calibration does."""
    a_scale = torch.clamp_min(norm_adj.abs().amax(dim=-1, keepdim=True),
                              1e-8) / INT8_MAX
    return QuantizedAgg(aq=quantize_s8(norm_adj, a_scale), a_scale=a_scale,
                        h_scale=calibrate_absmax(calib_h).scale)


def quantize_agg_dynamic(norm_adj: torch.Tensor,
                         h_scale: torch.Tensor) -> QuantizedAgg:
    """Derive Â's QuantizedAgg form in the forward pass. Â is structure,
    not activation, so its per-row scales are a function of the fp32
    operand; only `h_scale` is calibration state. The serving engine caches
    this form per structure version instead (`derive_tier_operands`)."""
    aq, a_scale = quantize_rowwise(norm_adj)
    return QuantizedAgg(aq=aq, a_scale=a_scale, h_scale=h_scale)


def apply_quantized_agg(qa: QuantizedAgg, h: torch.Tensor, *,
                        use_kernel: bool = False) -> torch.Tensor:
    """Âq @ q(H) in int32, dequantized per row. h: (B?, N, F)."""
    hq = quantize_s8(h, qa.h_scale)
    if use_kernel:
        out = kops.int8_matmul(qa.aq, hq, 1.0,
                               torch.ones(h.shape[-1], device=h.device))
        return out * (qa.a_scale * qa.h_scale)
    return int_matmul(qa.aq, hq).to(torch.float32) * (qa.a_scale
                                                      * qa.h_scale)


def quantize_tree(params: Dict, calib_acts: Dict) -> Dict:
    """Quantize every (name -> (in,out) weight) given matching calib
    acts."""
    return {k: quantize_linear(w, calib_acts[k]) for k, w in params.items()}


def quant_error(x: torch.Tensor) -> float:
    """Round-trip relative error — bounds QuantGr loss in the tests."""
    q = calibrate_absmax(x)
    rt = dequantize(quantize(x, q), q)
    return float(torch.linalg.norm(rt - x)
                 / torch.clamp_min(torch.linalg.norm(x), 1e-12))
