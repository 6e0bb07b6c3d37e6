"""Operand checks and the launch call shared by the kernel wrappers.

Routing is by the tensors' device and nothing else: a wrapper takes its
plain PyTorch version only when every operand lies on the CPU, and
`flash_attention`'s entries take a shape-only route when every operand
lies on the `meta` device (the dry run); otherwise the operands must be
contiguous CUDA tensors of the kernel's dtypes on one card, and the
kernel launches or an exception says why not. There is no fallback.

The GNN kernels have no backward: `no_backward` guards their public
entries against operands that require grad (see `ops`). `flash_attention`
has one (`kernels/flash_attention.py`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, List, Sequence, Tuple

import torch

INT32_MAX = 2 ** 31 - 1


def on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def on_meta(*tensors: torch.Tensor) -> bool:
    """Every operand on the `meta` device: a wrapper that has a meta route
    returns outputs of the right shapes there and computes nothing."""
    return all(t.device.type == "meta" for t in tensors)


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


class NoBackward(RuntimeError):
    """A GNN kernel entry was given an operand that requires grad in grad
    mode; those kernels have no backward."""


_cuts = threading.local()


@contextlib.contextmanager
def record_grad_cuts() -> Iterator[List[Tuple[str, torch.Tensor]]]:
    """Yield a list that collects (entry, operand) for every operand that
    requires grad reaching a kernel entry inside the block; those entries
    run under `no_grad` instead of raising `NoBackward`."""
    prev = getattr(_cuts, "log", None)
    _cuts.log = log = []
    try:
        yield log
    finally:
        _cuts.log = prev


def _operands(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _operands(v)


def no_backward(entry):
    """Refuse (or, inside `record_grad_cuts`, record) operands that
    require grad while grad mode is on."""
    @functools.wraps(entry)
    def guarded(*args, **kwargs):
        if torch.is_grad_enabled():
            need = [t for t in _operands((args, list(kwargs.values())))
                    if t.requires_grad]
            if need:
                log = getattr(_cuts, "log", None)
                if log is None:
                    raise NoBackward(
                        f"{entry.__name__}: {len(need)} operand(s) require "
                        "grad, and the kernels have no backward; call it "
                        "under torch.no_grad() or train on the plain forward")
                log.extend((entry.__name__, t) for t in need)
                with torch.no_grad():
                    return entry(*args, **kwargs)
        return entry(*args, **kwargs)
    return guarded
