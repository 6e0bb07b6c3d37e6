"""int8_matmul: the QuantGr INT8 datapath, s8 x s8 -> s32 -> f32.

Port of the TPU kernel `int8_matmul` (reference `kernels/int8_matmul.py`)
as hand-written CUDA C++ for `sm_90a` (`csrc/int8_matmul.cu`, tile in
`csrc/igemm_tile.cuh`): a batched GEMM over `blockIdx.z` on the s8 tensor
cores (`mma.sync` m16n8k32) with exact s32 accumulation, where a batch
stride of 0 broadcasts an operand (the weights of a combine). As in the
TPU kernel, the per-tensor activation scale is folded into the per-column
weight scales (`sw = w_scale * x_scale`), so the epilogue is one multiply.

This module also holds the port's int8 primitives, shared by every plain
int8 path (`core/quant.py`, the kernels' plain versions, `kernels/ref.py`):

  * `quantize_s8` — clamp(round(v / scale), -127, 127) narrowed to int8,
    the reference's rounding rule (`torch.round` rounds half to even, like
    `jnp.round`);
  * `int_matmul` — the exact s8 x s8 -> s32 product. It runs as a float64
    `torch.matmul` and converts back: every partial sum is an integer of
    magnitude at most K * 127**2 (4.96e7 at K = 3072), far below 2**53, so
    float64 holds it exactly in any summation order, on any device and for
    any shape. (`torch.matmul` on int8 tensors returns int8 and wraps; CUDA
    has no integer `torch.matmul`; `torch._int_mm` has shape limits there.)

`int8_matmul` is the wrapper: CPU operands run `int8_matmul_plain`, CUDA
operands launch the kernel or raise. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

from typing import Union

import torch

from . import _build
from ._launch import INT32_MAX, check_cuda, check_int32, launch, on_cpu

LAUNCHES = 0                      # kernel launches by `int8_matmul`
INT8_MAX = 127.0

Scale = Union[float, torch.Tensor]


def check_accumulator(kernel: str, k: int) -> None:
    """Raise unless a K-deep s8 x s8 sum always fits in s32."""
    if k * int(INT8_MAX) ** 2 > INT32_MAX:
        raise ValueError(f"{kernel}: K={k} can overflow the s32 accumulator "
                         f"(K * 127**2 > 2**31 - 1)")


def quantize_s8(v: torch.Tensor, scale: Scale) -> torch.Tensor:
    """clamp(round(v / scale), -127, 127) as int8 (half to even)."""
    return torch.clamp(torch.round(v / scale), -INT8_MAX, INT8_MAX
                       ).to(torch.int8)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (B?, M, K) s8 @ (B?, K, N) s8 -> int32 through float64."""
    check_accumulator("int_matmul", a.shape[-1])
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)
                        ).to(torch.int32)


def fold_scales(x_scale: Scale, w_scale: torch.Tensor) -> torch.Tensor:
    """sw = w_scale * x_scale as one float32 row, as the TPU kernel folds
    them (reference `int8_matmul.py:55`)."""
    return (w_scale.reshape(1, -1) * x_scale).to(torch.float32)


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, x_scale: Scale,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the exact product, then one multiply."""
    return int_matmul(xq, wq).to(torch.float32) * fold_scales(x_scale,
                                                              w_scale)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: Scale,
                w_scale: torch.Tensor) -> torch.Tensor:
    """(B?, M, K) s8 @ (B?, K, N) s8 * x_scale * w_scale[N] -> float32.

    A 2-D operand broadcasts over the other's batch. `x_scale` is a Python
    float or a one-element tensor, `w_scale` an (N,) tensor.
    """
    global LAUNCHES
    if on_cpu(*(t for t in (xq, wq, x_scale, w_scale)
                if isinstance(t, torch.Tensor))):
        return int8_matmul_plain(xq, wq, x_scale, w_scale)
    sw = fold_scales(x_scale, w_scale).reshape(-1)
    device = check_cuda("int8_matmul", int8=("xq", "wq"), xq=xq, wq=wq,
                        sw=sw)
    if xq.dim() not in (2, 3) or wq.dim() not in (2, 3):
        raise ValueError(f"int8_matmul: operands must be 2-D or 3-D, got "
                         f"{tuple(xq.shape)} @ {tuple(wq.shape)}")
    m, k = xq.shape[-2:]
    k2, n = wq.shape[-2:]
    batches = {t.shape[0] for t in (xq, wq) if t.dim() == 3}
    if k != k2 or len(batches) > 1 or sw.numel() != n:
        raise ValueError(f"int8_matmul: shapes {tuple(xq.shape)} @ "
                         f"{tuple(wq.shape)} with {sw.numel()} column "
                         "scales do not multiply")
    check_accumulator("int8_matmul", k)
    batch = batches.pop() if batches else 1
    lead = (batch,) if (xq.dim() == 3 or wq.dim() == 3) else ()
    out = torch.empty(*lead, m, n, dtype=torch.float32, device=device)
    if out.numel():
        stride_a = m * k if xq.dim() == 3 else 0
        stride_b = k * n if wq.dim() == 3 else 0
        check_int32("int8_matmul", batch=batch, m=m, n=n, k=k,
                    stride_a=stride_a, stride_b=stride_b)
        launch("int8_matmul", _build.load("int8_matmul"), device,
               xq.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(),
               batch, m, n, k, stride_a, stride_b)
        LAUNCHES += 1
    return out
