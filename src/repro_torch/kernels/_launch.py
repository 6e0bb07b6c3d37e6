"""Operand checks and the launch call shared by the kernel wrappers.

Routing is by the tensors' device and nothing else: a wrapper takes its
plain PyTorch version only when every operand lies on the CPU; otherwise
the operands must be contiguous CUDA tensors of the kernel's dtypes on one
card, and the kernel launches or an exception says why not. There is no
fallback.
"""
from __future__ import annotations

from typing import Sequence

import torch

INT32_MAX = 2 ** 31 - 1


def on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def check_cuda(kernel: str, *, int8: Sequence[str] = (),
               int32: Sequence[str] = (),
               floating: torch.dtype = torch.float32,
               **tensors: torch.Tensor) -> torch.device:
    """Raise unless every operand is a contiguous tensor on one CUDA device,
    int8 for the names in `int8`, int32 for those in `int32` and of the
    floating dtype `floating` (float32 unless a kernel takes bfloat16 too)
    for the others; return that device."""
    for name, t in tensors.items():
        want = (torch.int8 if name in int8 else
                torch.int32 if name in int32 else floating)
        if t.device.type != "cuda":
            raise ValueError(
                f"{kernel}: {name} lies on {t.device}; the kernel takes CUDA "
                "tensors, and the plain version runs only when every operand "
                "lies on the CPU")
        if t.dtype != want:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, the kernel "
                            f"takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: operands lie on several devices "
                         f"{sorted(map(str, devices))}")
    return devices.pop()


def check_int32(kernel: str, **sizes: int) -> None:
    """The C entry points take sizes and batch strides as 32-bit ints."""
    for name, v in sizes.items():
        if not 0 <= v <= INT32_MAX:
            raise ValueError(f"{kernel}: {name}={v} does not fit the "
                             "kernel's 32-bit size arguments")


def launch(kernel: str, fn, device: torch.device, *args: int) -> None:
    """Call a bound C entry point on the device's current stream (no
    synchronisation) and raise if it reports an error. The kernels link
    their own CUDA runtime, so the device ordinal travels with the call."""
    err = fn(*args, device.index,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {err})")
