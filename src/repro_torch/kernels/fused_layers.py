"""Fused per-layer GCN, GAT and SAGE kernels: one wrapper call per layer.

  * `fused_gcn_dense` — act(Â @ (X @ W) + b), fp32. Port of the TPU kernel
    `fused_gcn_dense` (reference `kernels/fused_layers.py`) as hand-written
    CUDA C++ for `sm_90a` (`csrc/fused_gcn_dense.cu`); both its launches
    run `block_matmul`'s 3xTF32 kernel (`csrc/tc_gemm_tile.cuh`), the
    aggregate with bias and activation in its store.
  * `fused_gcn_int8` — the QuantGr layer: X quantized by `x_scale`, the s8
    dot with Wq, dequantized by `sw` and re-quantized to int8 Hq by
    `h_scale`, then act(float(Âq @ Hq) * a_scale[row] * h_scale + b). Port
    of the TPU kernel `fused_gcn_int8` (`csrc/fused_gcn_int8.cu`), bit for
    bit the plain `fused_gcn_int8_plain`.
  * `fused_gcn_grasp` — act(Â @ (X @ W) + b) with Â in the GraSp compacted
    form (`core.sparsity.BlockSparse` leaves). Port of the TPU kernel
    `fused_gcn_grasp` (`csrc/fused_gcn_grasp.cu`); its combine runs
    `block_matmul`'s 3xTF32 kernel, its aggregation is the block-sparse
    walk of `bitmap_spmm` (`csrc/bsr_tile.cuh`).
  * `fused_gat_full` — the whole fp32 GAT layer: H = X @ W, the alpha
    terms, act(attention + b) per head. Port of the TPU kernel
    `fused_gat_full` (`csrc/fused_gat_full.cu`); its combine runs on
    `block_matmul`'s 3xTF32 tile (`csrc/tc_gemm_tile.cuh`), its attention
    is the tensor-core body of `gat_attention` (`csrc/gat_tile.cuh`).
  * `fused_gat_precombined` — act(attention + b) over an h and alpha made
    outside (the QuantGr GAT tiers' int8 combine). Port of the TPU kernel
    `fused_gat_precombined` (`csrc/fused_gat_precombined.cu`).
  * `fused_sage` — act(X @ W_self + AGG @ W_neigh + b), AGG the mean
    aggregation M @ X or the GrAx3 masked max of the pooled features.
    Port of the TPU kernel `fused_sage` (`csrc/fused_sage.cu`); its
    aggregation is the row walk of `sage_max` (`csrc/sage_walk.cuh`), its
    combine runs on `block_matmul`'s 3xTF32 tile.

The four TPU kernels with a combine kept its result in VMEM, filled by
row-block 0 and read by the later ones in grid order; a CUDA grid has no
order, so each port runs a combine launch into a scratch tensor (L2
resident at serving widths) and an aggregate launch with the epilogue
fused into its store. Both launches run on the current stream inside one
wrapper call, which counts one in `LAUNCHES` (dense), `INT8_LAUNCHES`
(int8), `GRASP_LAUNCHES` (GraSp) or `GAT_FULL_LAUNCHES`;
`fused_gat_precombined` is one launch, counted in `GAT_PRE_LAUNCHES`.
`fused_sage` has the same hazard the other way round (its TPU kernel
fills a (rows, Fin) aggregation buffer at output strip 0 and reads it at
every later strip): an aggregate launch into an N x Fin scratch tensor
(rows padded to 16 bytes), then a combine launch with both K loops in one
accumulator and the epilogue in its store, counted once in
`SAGE_LAUNCHES`.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import check_cuda, check_int32, launch, on_cpu
from .bitmap_spmm import bitmap_spmm_plain, check_structure
from .gat_attention import check_attention, gat_attention_plain
from .int8_matmul import check_accumulator, int_matmul, quantize_s8
from .sage_max import check_walk, sage_max_plain

LAUNCHES = 0                      # calls of `fused_gcn_dense` that launched
INT8_LAUNCHES = 0                 # calls of `fused_gcn_int8` that launched
GRASP_LAUNCHES = 0                # calls of `fused_gcn_grasp` that launched
GAT_FULL_LAUNCHES = 0             # calls of `fused_gat_full` that launched
GAT_PRE_LAUNCHES = 0              # launches of `fused_gat_precombined`
SAGE_LAUNCHES = 0                 # calls of `fused_sage` that launched
SAGE_AGGREGATORS = ("mean", "max")
ACTIVATIONS = {"none": 0, "relu": 1, "elu": 2}   # the kernel's `act` codes


def _act(z: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.clamp_min(z, 0.0)
    if activation == "elu":
        return torch.where(z > 0, z, torch.expm1(z))
    if activation == "none":
        return z
    raise ValueError(f"unknown activation {activation!r}")


def _check_activation(activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; pick from "
                         f"{sorted(ACTIVATIONS)}")


def fused_gcn_dense_plain(norm_adj: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, b: torch.Tensor,
                          activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version: combine, aggregate, bias and activation as
    separate ops."""
    h = torch.matmul(x, w)
    return _act(torch.matmul(norm_adj, h) + b.reshape(1, -1), activation)


def fused_gcn_dense(norm_adj: torch.Tensor, x: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor,
                    activation: str = "none") -> torch.Tensor:
    """act(Â @ (X @ W) + b) over a leading batch of graphs.

    norm_adj: (B, N, N); x: (B, N, Fin); w: (Fin, O); b: (O,) or (1, O).
    Returns (B, N, O) float32.
    """
    global LAUNCHES
    _check_activation(activation)
    if on_cpu(norm_adj, x, w, b):
        return fused_gcn_dense_plain(norm_adj, x, w, b, activation)
    device = check_cuda("fused_gcn_dense", norm_adj=norm_adj, x=x, w=w, b=b)
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"fused_gcn_dense: x must be (B, N, Fin) and w "
                         f"(Fin, O), got {tuple(x.shape)}, {tuple(w.shape)}")
    batch, n, fin = x.shape
    o = w.shape[1]
    if (tuple(norm_adj.shape) != (batch, n, n) or w.shape[0] != fin
            or b.numel() != o):
        raise ValueError(
            f"fused_gcn_dense: shapes do not agree: norm_adj "
            f"{tuple(norm_adj.shape)}, x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, b {tuple(b.shape)}")
    out = torch.empty(batch, n, o, dtype=torch.float32, device=device)
    if out.numel():
        check_int32("fused_gcn_dense", batch=batch, n=n, fin=fin, o=o)
        h = torch.empty_like(out)            # combine scratch, L2 resident
        launch("fused_gcn_dense", _build.load("fused_gcn_dense"), device,
               norm_adj.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
               h.data_ptr(), out.data_ptr(), batch, n, fin, o,
               ACTIVATIONS[activation])
        LAUNCHES += 1
    return out


def fused_gcn_int8_plain(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                         x_scale: torch.Tensor, h_scale: torch.Tensor,
                         aq: torch.Tensor, a_scale: torch.Tensor,
                         b: torch.Tensor, activation: str = "none"
                         ) -> torch.Tensor:
    """Plain PyTorch version: the unfused int8 chain, one rounding step per
    op (multiply and add apart, never contracted)."""
    hq = quantize_s8(int_matmul(quantize_s8(x, x_scale), wq).to(torch.float32)
                     * sw.reshape(1, -1), h_scale)
    z = (int_matmul(aq, hq).to(torch.float32) * (a_scale * h_scale)
         + b.reshape(1, -1))
    return _act(z, activation)


def fused_gcn_int8(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                   x_scale: torch.Tensor, h_scale: torch.Tensor,
                   aq: torch.Tensor, a_scale: torch.Tensor, b: torch.Tensor,
                   activation: str = "none") -> torch.Tensor:
    """QuantGr fused layer over a leading batch of graphs.

    x: (B, N, Fin) f32; wq: (Fin, O) s8; sw: (1, O) = x_scale * w_scale;
    x_scale, h_scale: one-element f32; aq: (B, N, N) s8; a_scale: (B, N, 1)
    f32; b: (O,) or (1, O). Returns (B, N, O) float32.
    """
    global INT8_LAUNCHES
    _check_activation(activation)
    operands = dict(x=x, wq=wq, sw=sw, x_scale=x_scale, h_scale=h_scale,
                    aq=aq, a_scale=a_scale, b=b)
    if on_cpu(*operands.values()):
        return fused_gcn_int8_plain(x, wq, sw, x_scale, h_scale, aq, a_scale,
                                    b, activation)
    device = check_cuda("fused_gcn_int8", int8=("wq", "aq"), **operands)
    if x.dim() != 3 or wq.dim() != 2:
        raise ValueError(f"fused_gcn_int8: x must be (B, N, Fin) and wq "
                         f"(Fin, O), got {tuple(x.shape)}, {tuple(wq.shape)}")
    batch, n, fin = x.shape
    o = wq.shape[1]
    if (tuple(aq.shape) != (batch, n, n) or wq.shape[0] != fin
            or a_scale.numel() != batch * n or sw.numel() != o
            or b.numel() != o or x_scale.numel() != 1
            or h_scale.numel() != 1):
        raise ValueError(
            f"fused_gcn_int8: shapes do not agree: x {tuple(x.shape)}, wq "
            f"{tuple(wq.shape)}, sw {tuple(sw.shape)}, aq "
            f"{tuple(aq.shape)}, a_scale {tuple(a_scale.shape)}, b "
            f"{tuple(b.shape)}, scales {x_scale.numel()}, "
            f"{h_scale.numel()}")
    out = torch.empty(batch, n, o, dtype=torch.float32, device=device)
    if out.numel():
        check_int32("fused_gcn_int8", batch=batch, n=n, fin=fin, o=o)
        check_accumulator("fused_gcn_int8", max(fin, n))
        # the combine's int8 Hq, stored K-major for the aggregate's 16-byte
        # copies: (O, n rounded up to 16) per graph
        ldk = -(-n // 16) * 16
        check_int32("fused_gcn_int8", hq=batch * o * ldk)
        hq = torch.empty(batch, o, ldk, dtype=torch.int8, device=device)
        launch("fused_gcn_int8", _build.load("fused_gcn_int8"), device,
               x.data_ptr(), wq.data_ptr(), sw.data_ptr(), x_scale.data_ptr(),
               h_scale.data_ptr(), aq.data_ptr(), a_scale.data_ptr(),
               b.data_ptr(), hq.data_ptr(), out.data_ptr(), batch, n, fin, o,
               ldk, ACTIVATIONS[activation])
        INT8_LAUNCHES += 1
    return out


def fused_gcn_grasp_plain(blocks: torch.Tensor, block_cols: torch.Tensor,
                          counts: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, b: torch.Tensor,
                          activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version: the combine, `bitmap_spmm_plain`, bias and
    activation as separate ops."""
    agg = bitmap_spmm_plain(blocks, block_cols, counts, torch.matmul(x, w))
    return _act(agg + b.reshape(1, -1), activation)


def fused_gcn_grasp(blocks: torch.Tensor, block_cols: torch.Tensor,
                    counts: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, activation: str = "none"
                    ) -> torch.Tensor:
    """GraSp fused layer over a leading batch of graphs.

    blocks (B, rb*max_nnz, 128, 128), block_cols (B, rb, max_nnz) int32 and
    counts (B, rb) int32: the compacted square Â of N = rb*128 rows;
    x: (B, N, Fin); w: (Fin, O); b: (O,) or (1, O). Returns (B, N, O)
    float32.
    """
    global GRASP_LAUNCHES
    _check_activation(activation)
    operands = dict(blocks=blocks, block_cols=block_cols, counts=counts,
                    x=x, w=w, b=b)
    if on_cpu(*operands.values()):
        return fused_gcn_grasp_plain(blocks, block_cols, counts, x, w, b,
                                     activation)
    device = check_cuda("fused_gcn_grasp", int32=("block_cols", "counts"),
                        **operands)
    check_structure("fused_gcn_grasp", blocks, block_cols, counts)
    batch, rb, max_nnz = block_cols.shape
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"fused_gcn_grasp: x must be (B, N, Fin) and w "
                         f"(Fin, O), got {tuple(x.shape)}, {tuple(w.shape)}")
    n, fin = x.shape[1:]
    o = w.shape[1]
    if (x.shape[0] != batch or n != rb * 128 or w.shape[0] != fin
            or b.numel() != o):
        raise ValueError(
            f"fused_gcn_grasp: shapes do not agree: {rb} block rows, x "
            f"{tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    out = torch.empty(batch, n, o, dtype=torch.float32, device=device)
    if out.numel():
        check_int32("fused_gcn_grasp", n=n, fin=fin, o=o)
        h = torch.empty_like(out)            # combine scratch, L2 resident
        launch("fused_gcn_grasp", _build.load("fused_gcn_grasp"), device,
               blocks.data_ptr(), block_cols.data_ptr(), counts.data_ptr(),
               x.data_ptr(), w.data_ptr(), b.data_ptr(), h.data_ptr(),
               out.data_ptr(), batch, rb, max_nnz, fin, o,
               ACTIVATIONS[activation])
        GRASP_LAUNCHES += 1
    return out


def fused_gat_precombined_plain(h: torch.Tensor, alpha_dst: torch.Tensor,
                                alpha_src: torch.Tensor,
                                bias_add: torch.Tensor, b: torch.Tensor,
                                activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version: `gat_attention_plain`, bias and activation
    as separate ops."""
    return _act(gat_attention_plain(h, alpha_dst, alpha_src, bias_add) + b,
                activation)


def fused_gat_precombined(h: torch.Tensor, alpha_dst: torch.Tensor,
                          alpha_src: torch.Tensor, bias_add: torch.Tensor,
                          b: torch.Tensor, activation: str = "none"
                          ) -> torch.Tensor:
    """QuantGr GAT layer after its combine, over a leading batch of graphs.

    h: (B, N, H, F); alpha_dst, alpha_src: (B, N, H); bias_add: (B, N, N)
    of 0 / -1e9; b: (H, F). Returns (B, N, H, F) float32.
    """
    global GAT_PRE_LAUNCHES
    _check_activation(activation)
    operands = dict(h=h, alpha_dst=alpha_dst, alpha_src=alpha_src,
                    bias_add=bias_add, b=b)
    if on_cpu(*operands.values()):
        return fused_gat_precombined_plain(h, alpha_dst, alpha_src, bias_add,
                                           b, activation)
    device = check_cuda("fused_gat_precombined", **operands)
    batch, n, heads, f = check_attention("fused_gat_precombined", h,
                                         alpha_dst, alpha_src, bias_add)
    if tuple(b.shape) != (heads, f):
        raise ValueError(f"fused_gat_precombined: b must be ({heads}, {f}),"
                         f" got {tuple(b.shape)}")
    out = torch.empty_like(h)
    if out.numel():
        launch("fused_gat_precombined", _build.load("fused_gat_precombined"),
               device, h.data_ptr(), alpha_dst.data_ptr(),
               alpha_src.data_ptr(), bias_add.data_ptr(), b.data_ptr(),
               out.data_ptr(), batch, n, heads, f, ACTIVATIONS[activation])
        GAT_PRE_LAUNCHES += 1
    return out


def fused_gat_full_plain(x: torch.Tensor, w: torch.Tensor,
                         a_src: torch.Tensor, a_dst: torch.Tensor,
                         bias_add: torch.Tensor, b: torch.Tensor,
                         activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version: the combine, the alpha einsums, then
    `fused_gat_precombined_plain`."""
    fin, heads, f = w.shape
    h = torch.matmul(x, w.reshape(fin, heads * f)).reshape(
        *x.shape[:-1], heads, f)
    alpha_src = torch.einsum("...nhf,hf->...nh", h, a_src)
    alpha_dst = torch.einsum("...nhf,hf->...nh", h, a_dst)
    return fused_gat_precombined_plain(h, alpha_dst, alpha_src, bias_add, b,
                                       activation)


def fused_gat_full(x: torch.Tensor, w: torch.Tensor, a_src: torch.Tensor,
                   a_dst: torch.Tensor, bias_add: torch.Tensor,
                   b: torch.Tensor, activation: str = "none"
                   ) -> torch.Tensor:
    """Whole fp32 GAT layer over a leading batch of graphs.

    x: (B, N, Fin); w: (Fin, H, F); a_src, a_dst, b: (H, F); bias_add:
    (B, N, N) of 0 / -1e9. Returns (B, N, H, F) float32.
    """
    global GAT_FULL_LAUNCHES
    _check_activation(activation)
    operands = dict(x=x, w=w, a_src=a_src, a_dst=a_dst, bias_add=bias_add,
                    b=b)
    if on_cpu(*operands.values()):
        return fused_gat_full_plain(x, w, a_src, a_dst, bias_add, b,
                                    activation)
    device = check_cuda("fused_gat_full", **operands)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"fused_gat_full: x must be (B, N, Fin) and w "
                         f"(Fin, H, F), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    batch, n, fin = x.shape
    _, heads, f = w.shape
    if (w.shape[0] != fin or tuple(a_src.shape) != (heads, f)
            or tuple(a_dst.shape) != (heads, f)
            or tuple(b.shape) != (heads, f)):
        raise ValueError(
            f"fused_gat_full: shapes do not agree: x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, a_src {tuple(a_src.shape)}, a_dst "
            f"{tuple(a_dst.shape)}, b {tuple(b.shape)}")
    out = torch.empty(batch, n, heads, f, dtype=torch.float32, device=device)
    # scratch of the combine launch, read by the attention launch
    h = torch.empty_like(out)
    alpha_src = torch.empty(batch, n, heads, dtype=torch.float32,
                            device=device)
    alpha_dst = torch.empty_like(alpha_src)
    check_attention("fused_gat_full", h, alpha_dst, alpha_src, bias_add)
    if out.numel():
        check_int32("fused_gat_full", fin=fin)
        launch("fused_gat_full", _build.load("fused_gat_full"), device,
               x.data_ptr(), w.data_ptr(), a_src.data_ptr(),
               a_dst.data_ptr(), bias_add.data_ptr(), b.data_ptr(),
               h.data_ptr(), alpha_src.data_ptr(), alpha_dst.data_ptr(),
               out.data_ptr(), batch, n, fin, heads, f,
               ACTIVATIONS[activation])
        GAT_FULL_LAUNCHES += 1
    return out


def fused_sage_plain(mask: torch.Tensor, xk: torch.Tensor, x: torch.Tensor,
                     w_self: torch.Tensor, w_neigh: torch.Tensor,
                     b: torch.Tensor, aggregator: str = "mean",
                     activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version: the aggregation (`torch.matmul` for mean,
    `sage_max_plain` for max), both combines, bias and activation as
    separate ops."""
    agg = (torch.matmul(mask, xk) if aggregator == "mean"
           else sage_max_plain(mask, xk))
    return _act(torch.matmul(x, w_self) + torch.matmul(agg, w_neigh)
                + b.reshape(1, -1), activation)


def sage_scratch(x: torch.Tensor) -> torch.Tensor:
    """`fused_sage`'s aggregate scratch for x (B, N, Fin): (B, N, ldg)
    float32, its rows padded to 16 bytes (ldg = Fin rounded up to 4) so
    that the combine streams it by 16-byte copies."""
    batch, n, fin = x.shape
    return torch.empty(batch, n, -(-fin // 4) * 4, dtype=torch.float32,
                       device=x.device)


def fused_sage(mask: torch.Tensor, xk: torch.Tensor, x: torch.Tensor,
               w_self: torch.Tensor, w_neigh: torch.Tensor, b: torch.Tensor,
               aggregator: str = "mean", activation: str = "none"
               ) -> torch.Tensor:
    """SAGE layer over a leading batch of graphs.

    mask: (B, N, N), the row-normalised `mean_mask` (mean) or the 0/1
    `sample_mask` (max); xk: (B, N, Fin), X itself (mean) or the pooled
    features (max, >= 0); x: (B, N, Fin); w_self, w_neigh: (Fin, O); b:
    (O,) or (1, O). Returns (B, N, O) float32. The mean walk sums
    m * x[j] in ascending column order with fmaf, as a sequential dense
    pass would; a NaN in an xk row that the mask never selects is never
    read (see `sage_max`).
    """
    global SAGE_LAUNCHES
    _check_activation(activation)
    if aggregator not in SAGE_AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; pick from "
                         f"{SAGE_AGGREGATORS}")
    operands = dict(mask=mask, xk=xk, x=x, w_self=w_self, w_neigh=w_neigh,
                    b=b)
    if on_cpu(*operands.values()):
        return fused_sage_plain(mask, xk, x, w_self, w_neigh, b, aggregator,
                                activation)
    device = check_cuda("fused_sage", **operands)
    batch, m, n, fin = check_walk("fused_sage", mask, xk)
    o = w_self.shape[-1]
    if (m != n or tuple(x.shape) != (batch, n, fin) or w_self.dim() != 2
            or tuple(w_self.shape) != (fin, o)
            or tuple(w_neigh.shape) != (fin, o) or b.numel() != o):
        raise ValueError(
            f"fused_sage: shapes do not agree: mask {tuple(mask.shape)}, "
            f"xk {tuple(xk.shape)}, x "
            f"{tuple(x.shape)}, w_self {tuple(w_self.shape)}, w_neigh "
            f"{tuple(w_neigh.shape)}, b {tuple(b.shape)}")
    out = torch.empty(batch, n, o, dtype=torch.float32, device=device)
    if out.numel():
        agg = sage_scratch(x)
        check_int32("fused_sage", o=o, ldg=agg.shape[-1])
        launch("fused_sage", _build.load("fused_sage"), device,
               mask.data_ptr(), xk.data_ptr(), x.data_ptr(),
               w_self.data_ptr(), w_neigh.data_ptr(), b.data_ptr(),
               agg.data_ptr(), out.data_ptr(), batch, n, fin,
               agg.shape[-1], o, int(aggregator == "max"),
               ACTIVATIONS[activation])
        SAGE_LAUNCHES += 1
    return out
