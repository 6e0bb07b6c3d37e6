"""gat_attention: the fused GAT attention of one layer (EffOp + GrAx1 +
GrAx2): per head, out[i] = sum_j softmax_j(leaky_0.2(alpha_dst[i] +
alpha_src[j]) + bias[i, j]) h[j].

Port of the TPU kernel `gat_attention` (reference
`kernels/gat_attention.py`) as hand-written CUDA C++ for `sm_90a`
(`csrc/gat_attention.cu`, attention body in `csrc/gat_tile.cuh`): one block
per strip of 32 rows (16 past F = 16), graph and group of up to 8 heads,
an online softmax over column tiles staged by a cp.async ring, with P.H
as 3xTF32 on the tensor cores (`mma.sync`), so the (rows, n) score strip
the TPU kernel keeps in VMEM is never formed and the bias is read once for
all heads. The head width F is taken as it is (1 to 64), not padded to
128.

`gat_attention` is the wrapper: CPU operands run `gat_attention_plain`,
CUDA operands launch the kernel or raise. `LAUNCHES` counts kernel
launches. `check_attention` holds the operand checks that the fused GAT
kernels (`fused_layers.py`) share.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._launch import check_cuda, check_int32, launch, on_cpu

LAUNCHES = 0                      # kernel launches by `gat_attention`
NEG_SLOPE = 0.2                   # leaky_relu slope of the GAT scores
MAX_F = 64                        # widest head the kernels take


def gat_attention_plain(h: torch.Tensor, alpha_dst: torch.Tensor,
                        alpha_src: torch.Tensor,
                        bias_add: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, one head at a time (one (B, N, N) score
    tensor alive): the reference kernel's arithmetic in its order."""
    outs = []
    for hd in range(h.shape[-2]):
        e = alpha_dst[..., :, None, hd] + alpha_src[..., None, :, hd]
        e = torch.where(e >= 0, e, NEG_SLOPE * e)
        e = e + bias_add
        p = torch.exp(e - e.amax(dim=-1, keepdim=True))
        attn = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-12)
        outs.append(torch.matmul(attn, h[..., hd, :]))
    return torch.stack(outs, dim=-2)


def check_attention(kernel: str, h: torch.Tensor, alpha_dst: torch.Tensor,
                    alpha_src: torch.Tensor, bias_add: torch.Tensor
                    ) -> Tuple[int, int, int, int]:
    """Raise unless h is (B, N, H, F) with 1 <= F <= MAX_F, the alpha terms
    (B, N, H) and bias_add (B, N, N); return (B, N, H, F)."""
    if h.dim() != 4:
        raise ValueError(f"{kernel}: h must be (B, N, H, F), got "
                         f"{tuple(h.shape)}")
    batch, n, heads, f = h.shape
    if (tuple(alpha_dst.shape) != (batch, n, heads)
            or tuple(alpha_src.shape) != (batch, n, heads)
            or tuple(bias_add.shape) != (batch, n, n)):
        raise ValueError(
            f"{kernel}: shapes do not agree: h {tuple(h.shape)}, alpha_dst "
            f"{tuple(alpha_dst.shape)}, alpha_src {tuple(alpha_src.shape)}, "
            f"bias_add {tuple(bias_add.shape)}")
    if not 1 <= f <= MAX_F:
        raise ValueError(f"{kernel}: head width {f} is outside the "
                         f"kernel's 1..{MAX_F}")
    check_int32(kernel, batch=batch, n=n, heads=heads, hf=heads * f)
    return batch, n, heads, f


def gat_attention(h: torch.Tensor, alpha_dst: torch.Tensor,
                  alpha_src: torch.Tensor,
                  bias_add: torch.Tensor) -> torch.Tensor:
    """h: (B, N, H, F); alpha_dst, alpha_src: (B, N, H); bias_add:
    (B, N, N) of 0 / -1e9. Returns (B, N, H, F) float32."""
    global LAUNCHES
    if on_cpu(h, alpha_dst, alpha_src, bias_add):
        return gat_attention_plain(h, alpha_dst, alpha_src, bias_add)
    device = check_cuda("gat_attention", h=h, alpha_dst=alpha_dst,
                        alpha_src=alpha_src, bias_add=bias_add)
    batch, n, heads, f = check_attention("gat_attention", h, alpha_dst,
                                         alpha_src, bias_add)
    out = torch.empty_like(h)
    if out.numel():
        launch("gat_attention", _build.load("gat_attention"), device,
               h.data_ptr(), alpha_dst.data_ptr(), alpha_src.data_ptr(),
               bias_add.data_ptr(), out.data_ptr(), batch, n, heads, f)
        LAUNCHES += 1
    return out
