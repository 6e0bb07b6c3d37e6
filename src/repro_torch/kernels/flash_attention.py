"""flash_attention: GQA attention of the LM prefill, q (B, Sq, H, D) and
k, v (B, Skv, KV, D) with H % KV == 0 -> (B, Sq, H, D), causal or not, with
an optional sliding window, tanh softcap, scale and q_offset.

Port of the TPU kernel `flash_attention` (reference
`kernels/flash_attention.py`) as hand-written CUDA C++ for `sm_90a`: one
CTA per (64-row q tile, head, batch), the KV sweep a loop inside it, an
online softmax with fp32 running max, sum and accumulator per row, and the
key tiles that no row of the q tile may reach skipped. It takes bf16 (the
serving dtype) and fp32 operands, D in {32, 64, 96, 128}, and Sq and Skv
as they are: the TPU wrapper's divisibility assert does not carry over.

Two routes, chosen by `flash_route(dtype, head_dim)` and nothing else:
- "wgmma" (`csrc/flash_attention_tc.cu`): bf16 at D 64, 96 or 128, the
  serving path. Both products on the bf16 tensor cores (wgmma), Q, K and
  V tiles by TMA through an mbarrier ring; D 96 runs on the D 128 tiles,
  their last 32 columns zero-filled by TMA. TMA needs 16-byte-aligned
  bases, so the wrapper raises on any other.
- "simt" (`csrc/flash_attention.cu`): fp32 at every D, whose 2e-5 bar no
  bf16 or TF32 product meets, and bf16 at D 32 (the reduced configs):
  fp32 FMAs on K/V tiles staged in shared memory.

The plain version is `ref.flash_attention_ref`. Both treat a row that no
key may reach (a window past Skv) as the -1e9 softmax does: a uniform
average over every key (ROADMAP queue 3).

`flash_attention` is the wrapper: CPU operands run the plain version,
CUDA operands launch their route's kernel or raise. `LAUNCHES` counts
every launch, `TC_LAUNCHES` and `SIMT_LAUNCHES` each route's.

The gradient. The reference trains by autodiff of its pure-JAX
`chunked_attention` (its Pallas kernel has no VJP); the port trains
through this entry:
- CPU operands: `flash_attention_ref` under ordinary autograd.
- CUDA operands that need a gradient: `FlashAttention`, a
  `torch.autograd.Function` whose forward launches the route above and
  saves the q, k and v it read, and whose backward launches
  `flash_attention_bwd` or raises. Nothing on the card falls back to the
  plain version or to autograd through it.
`flash_attention_bwd` is also an entry of its own (CPU operands run
`ref.flash_attention_bwd_ref`). It takes the forward's routes, by
`flash_route` again, each two launches on one stream with no atomics
(dq with the rows' softmax statistics, then dk and dv summed over each KV
head's group), so two calls give bit-equal results:
- "wgmma" (`csrc/flash_attention_bwd_tc.cu`): bf16 at D 64, 96 or 128,
  every product on wgmma, the tiles by TMA (16-byte-aligned bases, as the
  forward's); P rounded to bf16 and dS as a bf16 pair (hi + lo) as the
  products' A operands.
- "simt" (`csrc/flash_attention_bwd.cu`): fp32 at every D, whose bar is
  twice the plain fp32 backward's error, which no bf16 product meets, and
  bf16 at D 32: fp32 FMAs on tiles staged in shared memory.
`BWD_LAUNCHES` counts its launches, one per backward call,
`BWD_TC_LAUNCHES` and `BWD_SIMT_LAUNCHES` each route's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._launch import check_cuda, check_int32, launch, on_cpu
from .ref import flash_attention_bwd_ref, flash_attention_ref

LAUNCHES = 0                      # kernel launches by `flash_attention`
TC_LAUNCHES = 0                   # ... of them on the "wgmma" route
SIMT_LAUNCHES = 0                 # ... of them on the "simt" route
BWD_LAUNCHES = 0                  # launches by `flash_attention_bwd`
BWD_TC_LAUNCHES = 0               # ... of them on the "wgmma" route
BWD_SIMT_LAUNCHES = 0             # ... of them on the "simt" route
HEAD_DIMS = (32, 64, 96, 128)
DTYPES = (torch.float32, torch.bfloat16)
TC_HEAD_DIMS = (64, 96, 128)
_LIBRARY = {"wgmma": "flash_attention_tc", "simt": "flash_attention"}
_BWD_LIBRARY = {"wgmma": "flash_attention_bwd_tc",
                "simt": "flash_attention_bwd"}
TC_TILE = 64                      # the wgmma backward's q rows per tile


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that CUDA operands of `dtype` and `head_dim` launch:
    "wgmma" (tensor cores) for bf16 at D 64, 96 or 128, else "simt"; raises
    for what neither takes."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention: q is {dtype}, the kernel takes "
                        "float32 or bfloat16")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {head_dim}; the kernel "
                         f"takes {HEAD_DIMS}")
    return ("wgmma" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
            else "simt")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: Optional[int], softcap: Optional[float],
                 q_offset: int) -> None:
    """Raise unless the shapes and options are ones both versions take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q must be (B, Sq, H, D) and k, v "
                         f"(B, Skv, KV, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k, v {tuple(k.shape)} (H % KV must be 0)")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: Skv is 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} must be >= 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap={softcap} must be > 0")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset={q_offset} must be "
                         ">= 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q over k, v; see the module docstring. Returns a
    tensor of q's shape and dtype, differentiable in q, k and v."""
    _check_shapes(q, k, v, window=window, softcap=softcap, q_offset=q_offset)
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                q_offset=q_offset)
    if on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, **opts)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, opts)
    return _launch_forward(q, k, v, **opts)


class FlashAttention(torch.autograd.Function):
    """The kernel route with a gradient: the forward kernel, and
    `flash_attention_bwd` for the backward, on the q, k and v the forward
    read."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        ctx.save_for_backward(q, k, v)
        ctx.opts = opts
        return _launch_forward(q, k, v, **opts)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None


def _check_aligned(kernel: str, **tensors: torch.Tensor) -> None:
    """The "wgmma" routes load by TMA, which needs 16-byte-aligned
    bases."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(
                f"{kernel}: {name} starts at an address that is not 16-byte "
                "aligned; the tensor-core route loads by TMA, which needs "
                "16-byte-aligned bases")


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int],
                    softcap: Optional[float], scale: Optional[float],
                    q_offset: int) -> torch.Tensor:
    """Launch the forward kernel of q's route on CUDA operands."""
    global LAUNCHES, TC_LAUNCHES, SIMT_LAUNCHES
    b, sq, h, d = q.shape
    route = flash_route(q.dtype, d)
    device = check_cuda("flash_attention", floating=q.dtype, q=q, k=k, v=v)
    skv, kvh = k.shape[1], k.shape[2]
    check_int32("flash_attention", batch=b, sq=sq, skv=skv, heads=h,
                q_offset=q_offset, window=window or 0,
                positions=q_offset + sq)
    out = torch.empty_like(q)
    if not out.numel():
        return out
    if route == "wgmma":
        _check_aligned("flash_attention", q=q, k=k, v=v)
        dims = (b, sq, skv, h, kvh, d)
    else:
        dims = (b, sq, skv, h, kvh, d, int(q.dtype == torch.bfloat16))
    launch("flash_attention", _build.load(_LIBRARY[route]), device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims,
           int(causal), window or 0, q_offset,
           scale if scale is not None else d ** -0.5, softcap or 0.0)
    LAUNCHES += 1
    if route == "wgmma":
        TC_LAUNCHES += 1
    else:
        SIMT_LAUNCHES += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention(q, k, v, **options)` for the
    output gradient `dout` (q's shape and dtype), each in its operand's
    shape and dtype. CPU operands run `flash_attention_bwd_ref`; CUDA
    operands launch their route's kernels or raise."""
    _check_shapes(q, k, v, window=window, softcap=softcap, q_offset=q_offset)
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: dout {tuple(dout.shape)} is "
                         f"not q's shape {tuple(q.shape)}")
    if on_cpu(q, k, v, dout):
        return flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                       window=window, softcap=softcap,
                                       scale=scale, q_offset=q_offset)
    return _launch_backward(q, k, v, dout, causal=causal, window=window,
                            softcap=softcap, scale=scale, q_offset=q_offset)


def _launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, *, causal: bool,
                     window: Optional[int], softcap: Optional[float],
                     scale: Optional[float], q_offset: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels of q's route on CUDA operands. The
    rows' statistics (m, 1 / l, Delta) are scratch allocated here: (3, B,
    H, Sq) for "simt", Sq rounded up to a whole q tile for "wgmma"."""
    global BWD_LAUNCHES, BWD_TC_LAUNCHES, BWD_SIMT_LAUNCHES
    b, sq, h, d = q.shape
    route = flash_route(q.dtype, d)
    device = check_cuda("flash_attention_bwd", floating=q.dtype, q=q, k=k,
                        v=v, dout=dout)
    skv, kvh = k.shape[1], k.shape[2]
    check_int32("flash_attention_bwd", batch=b, sq=sq, skv=skv, heads=h,
                q_offset=q_offset, window=window or 0,
                positions=q_offset + sq + (window or 0))
    dq = torch.empty_like(q)
    if not q.numel():
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if route == "wgmma":
        _check_aligned("flash_attention_bwd", q=q, k=k, v=v, dout=dout)
        rows = -(-sq // TC_TILE) * TC_TILE
        dims = (b, sq, skv, h, kvh, d)
    else:
        rows = sq
        dims = (b, sq, skv, h, kvh, d, int(q.dtype == torch.bfloat16))
    stats = torch.empty((3, b, h, rows), dtype=torch.float32, device=device)
    launch("flash_attention_bwd", _build.load(_BWD_LIBRARY[route]), device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
           *dims, int(causal), window or 0, q_offset,
           scale if scale is not None else d ** -0.5, softcap or 0.0)
    BWD_LAUNCHES += 1
    if route == "wgmma":
        BWD_TC_LAUNCHES += 1
    else:
        BWD_SIMT_LAUNCHES += 1
    return dq, dk, dv
