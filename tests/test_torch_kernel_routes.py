"""The routes of the port's redesigned kernels and the 3xTF32 arithmetic,
on the CPU with no card.

`flash_attention` picks its kernel by dtype and head dim alone
(`flash_route`): the bf16 tensor-core route at D 64, 96 and 128, the SIMT
route otherwise. `block_matmul` runs 3xTF32 on the TF32 tensor cores; its
arithmetic is emulated here in numpy on the Cora GCN's four serving
products: cvt.rna.tf32 as round to nearest, ties away, to 10 mantissa
bits; each m16n8k8 step's eight products summed exactly and added to its
fp32 accumulator with the sum rounded toward zero, as the tensor cores
truncate; every other sum in fp32. With the tile's blocking (a fresh
chain every 16 of K, partial sums every 128) 3xTF32 stays within the card
bar (rtol 1e-4, atol 1e-5) of a float64 product and within twice a plain
fp32 product's error; one chain over all of K, truncated at every step,
misses the twice-fp32 bar, and one TF32 product has hundreds of times
fp32's relative error. At layer 1 the outputs stay below 0.03, so the
bar's atol alone covers even one TF32 product there; at layer 2 one TF32
product misses the bar.

The GAT attention body runs its P.H the same way (`csrc/gat_tile.cuh`):
each softmax weight p and each h element split in two, three products
per k8 step, a fresh chain every 16 columns added in fp32. Emulated on
the Cora GAT's serving shapes (a 3072-node bucket with the GrAx1 mask,
layer 1's 8 heads of 8 and layer 2's 1 head of 7; rows with neighbours
and NodePad rows, whose weights are all 1), the normalised output stays
within the card bar of a float64 product, within 1e-6 of its scale. One
TF32 product loses more than the bar's rtol relative to the outputs'
scale; the served outputs stay near 0.01, where the bar's atol alone
covers it, and with h of order one it misses the bar.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import masks
from repro_torch.core.graph import pad_graph
from repro_torch.data.graphs import cora_like
from repro_torch.kernels import bitmap_spmm as bs
from repro_torch.kernels import compare_builds as cb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_layers as fl
from repro_torch.kernels import ref as kref

CARD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_route(dtype, head_dim):
    want = ("wgmma" if dtype == torch.bfloat16 and head_dim in (64, 96, 128)
            else "simt")
    assert fa.flash_route(dtype, head_dim) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_flash_route_rejects_dtype(dtype):
    with pytest.raises(TypeError):
        fa.flash_route(dtype, 64)


@pytest.mark.parametrize("head_dim", [16, 48, 80, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_route_rejects_head_dim(dtype, head_dim):
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_route(dtype, head_dim)


@pytest.mark.parametrize("head_dim", [32, 64, 96, 128])
def test_cpu_operands_launch_nothing_on_either_route(head_dim):
    """On the CPU every route runs the plain version and counts nothing."""
    rng = np.random.default_rng(head_dim)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((1, 70, 4, head_dim),
                                     (1, 70, 2, head_dim),
                                     (1, 70, 2, head_dim)))
    before = (fa.LAUNCHES, fa.TC_LAUNCHES, fa.SIMT_LAUNCHES)
    got = fa.flash_attention(q, k, v)
    assert (fa.LAUNCHES, fa.TC_LAUNCHES, fa.SIMT_LAUNCHES) == before
    assert torch.equal(got, kref.flash_attention_ref(q, k, v))


# ------------------------------------------------------------ 3xTF32
def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits (the low 13 bits of the fp32 pattern cleared)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    big = tf32(x)
    return big, tf32(x.astype(np.float32) - big)


def round_toward_zero(x: np.ndarray) -> np.ndarray:
    """float64 to fp32, rounded toward zero (the tensor cores' accumulate)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def three_tf32(a: np.ndarray, b: np.ndarray, chain: int = 16,
               flush: int = 128, acc=None) -> np.ndarray:
    """The tile's arithmetic: per 8 of K the three m16n8k8 products (small
    terms first), each truncated into a chain of `chain` of K that starts
    from 0; chains summed in fp32 into a partial sum of `flush` of K,
    partial sums into the total, which starts from 0 or from `acc` (a
    second product through the same accumulator). chain = flush > K is
    one accumulator over all of K."""
    (ab, as_), (bb, bs) = split(a), split(b)
    ab, as_, bb, bs = (t.astype(np.float64) for t in (ab, as_, bb, bs))
    k = a.shape[1]
    acc = (np.zeros((a.shape[0], b.shape[1]), np.float32) if acc is None
           else acc.astype(np.float32))
    mid = np.zeros_like(acc)
    for c0 in range(0, k, chain):
        part = np.zeros_like(acc)
        for k0 in range(c0, min(c0 + chain, k), 8):
            s = slice(k0, min(k0 + 8, k))
            for x, y in ((as_, bb), (ab, bs), (ab, bb)):
                # TF32 products are exact in float64, and so is a sum of 8
                part = round_toward_zero(part + x[:, s] @ y[s])
        mid = mid + part
        if (c0 + chain) % flush == 0 or c0 + chain >= k:
            acc, mid = acc + mid, np.zeros_like(mid)
    return acc


def one_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.matmul(tf32(a), tf32(b), dtype=np.float32)


def _glorot(rng, fan_in, fan_out):
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)


def _gcn_products():
    """The Cora GCN's products at serving scale, on 256 rows each: layer
    1's X @ W over the 1433 features and Â @ H over a 3072-node bucket's
    normalised adjacency (K = 3072), layer 2's X @ W (K = 64) and Â @ H."""
    rng = np.random.default_rng(7)
    pg = pad_graph(cora_like(seed=0), capacity=3072)
    x = pg.features.astype(np.float32)
    adj = pg.norm_adj.astype(np.float32)
    w1, w2 = _glorot(rng, 1433, 64), _glorot(rng, 64, 7)
    b1 = (0.1 * rng.standard_normal(64)).astype(np.float32)
    h1 = np.matmul(x, w1)
    x2 = np.maximum(np.matmul(adj, h1) + b1, 0)
    h2 = np.matmul(x2, w2)
    return {"L1 X@W": (x[:256], w1), "L1 A@H": (adj[:256], h1),
            "L2 X@W": (x2[:256], w2), "L2 A@H": (adj[:256], h2)}


GCN = _gcn_products()


def _rel(got, want):
    """Largest |got - want| relative to the largest |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def _f64(a, b):
    return np.matmul(a.astype(np.float64), b.astype(np.float64))


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)            # TF32's step at 1
    x = np.array([one + ulp / 2, one + ulp / 2 * 0.99, -(one + ulp / 2),
                  one + ulp * 1.5], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one + ulp, one, -(one + ulp), one + 2 * ulp],
                          np.float32))
    big, small = split(np.array([np.pi], np.float32))
    assert abs(float(big[0]) - np.pi) <= 2.0 ** -11 * np.pi
    assert abs(float(big[0]) + float(small[0]) - np.float32(np.pi)) <= (
        2.0 ** -22 * np.pi)


def test_tile_and_build_comparison_round_as_the_emulation(tmp_path):
    # the tile's tf32_rna and compare_builds' int-split rewrite of a tile
    # that still splits with cvt.rna use tf32()'s add and mask
    csrc = Path(cb.__file__).parent / "csrc"
    tile = (csrc / "tc_gemm_tile.cuh").read_text()
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in tile
    assert cb.INT_SPLIT.count("+ 0x1000u) & 0xffffe000u") == 2
    old = tmp_path / "old"
    old.mkdir()
    (old / "tc_gemm_tile.cuh").write_text("{\n" + cb.CVT_SPLIT + "}\n")
    tree = cb.source_tree("t", old, True, out=tmp_path)
    assert (tree / "tc_gemm_tile.cuh").read_text() == (
        "{\n" + cb.INT_SPLIT + "}\n")
    assert cb.source_tree("t", old, False) == old
    with pytest.raises(SystemExit, match="no cvt.rna split"):
        cb.source_tree("now", csrc, True, out=tmp_path)


@pytest.mark.parametrize("case", sorted(GCN))
def test_three_tf32_keeps_the_card_bar(case):
    a, b = GCN[case]
    want = _f64(a, b)
    got = three_tf32(a, b)
    np.testing.assert_allclose(got, want, **CARD)
    # and within twice the error of a plain fp32 product
    assert _rel(got, want) <= 2 * _rel(np.matmul(a, b, dtype=np.float32),
                                       want)


@pytest.mark.parametrize("case", sorted(GCN))
def test_one_truncated_chain_misses_the_twice_fp32_bar(case):
    """Why the tile restarts its chain every 16 of K: one accumulator over
    all of K, truncated at every step, drifts past twice fp32's error."""
    a, b = GCN[case]
    want = _f64(a, b)
    k = a.shape[1]
    one_chain = _rel(three_tf32(a, b, chain=k + 8, flush=k + 8), want)
    assert one_chain > 2 * _rel(np.matmul(a, b, dtype=np.float32), want)


def test_round_toward_zero():
    x = np.array([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 1.0 - 2.0 ** -30,
                  3.0], np.float64)
    np.testing.assert_array_equal(
        round_toward_zero(x),
        np.array([1.0, -1.0, np.nextafter(np.float32(1), np.float32(0)),
                  3.0], np.float32))


@pytest.mark.parametrize("case", sorted(GCN))
def test_one_tf32_product_loses_fp32_accuracy(case):
    a, b = GCN[case]
    want = _f64(a, b)
    one = _rel(one_tf32(a, b), want)
    assert one > 1e-4                  # the bar's rtol, as a norm
    assert one > 100 * _rel(np.matmul(a, b, dtype=np.float32), want)


@pytest.mark.parametrize("case", ["L2 X@W", "L2 A@H"])
def test_one_tf32_product_misses_the_card_bar(case):
    a, b = GCN[case]
    assert not np.allclose(one_tf32(a, b), _f64(a, b), **CARD)


# ------------------------------------------- fused_gcn_dense on the tile
GCN_ROWS = 256          # aggregate rows emulated (the combine runs on all)
ACTS = {"none": lambda z: z, "relu": lambda z: np.maximum(z, 0),
        "elu": lambda z: _elu(z)}


@functools.lru_cache(maxsize=None)
def _gcn_dense_layers():
    """The Cora GCN's two layers at the widths `ops.fused_gcn_layer` serves
    them: a 3072 bucket's Â, Fin padded to 1536 and O to 128 with zeros.
    By layer: (Â's first GCN_ROWS rows, X, W, b, and H as the combine
    emulated in 3xTF32 makes it, rounded to fp32). Layer 2 takes layer
    1's plain fp32 relu output."""
    rng = np.random.default_rng(7)
    pg = pad_graph(cora_like(seed=0), capacity=3072)
    adj = pg.norm_adj.astype(np.float32)

    def pad(a, shape):
        out = np.zeros(shape, np.float32)
        out[tuple(slice(0, k) for k in a.shape)] = a
        return out

    x1 = pad(pg.features.astype(np.float32), (3072, 1536))
    w1 = pad(_glorot(rng, 1433, 64), (1536, 128))
    w2 = pad(_glorot(rng, 64, 7), (128, 128))
    b1 = pad((0.1 * rng.standard_normal(64)).astype(np.float32), (128,))
    b2 = pad((0.1 * rng.standard_normal(7)).astype(np.float32), (128,))
    x2 = np.maximum(np.matmul(adj, np.matmul(x1, w1)) + b1, 0)
    return {layer: (adj[:GCN_ROWS], x, w, b, three_tf32(x, w))
            for layer, (x, w, b) in (("L1", (x1, w1, b1)),
                                     ("L2", (x2, w2, b2)))}


@pytest.mark.parametrize("activation", sorted(ACTS))
@pytest.mark.parametrize("layer", ["L1", "L2"])
def test_fused_gcn_dense_three_tf32_keeps_the_card_bar(layer, activation):
    """fused_gcn_dense's two launches on the 3xTF32 tile, emulated at the
    Cora GCN's served widths: the combine's fp32 H, then Â @ H with the
    tile's chains and partial sums over K = 3072, then bias and activation
    in the store. Within the card bar of the plain version, and within
    twice the plain layer's error against float64."""
    adj, x, w, b, h = _gcn_dense_layers()[layer]
    act = ACTS[activation]
    got = act(three_tf32(adj, h) + b)
    plain = fl.fused_gcn_dense_plain(*(torch.from_numpy(t) for t in (
        adj, x, w, b)), activation).numpy()
    np.testing.assert_allclose(got, plain, **CARD)
    want = act(_f64(adj, _f64(x, w)) + b)
    assert _rel(got, want) <= 2 * _rel(plain, want)


def _grasp_layer(max_nnz):
    """A compacted Â of 2 graphs x 8 block rows at budget `max_nnz` (counts
    from 0 to the budget, distinct columns, |N(0, 0.02)| blocks) with X
    (2, 1024, 256), W (256, 128) and b, from the distributions of
    fused_gcn_grasp's card test."""
    rng = np.random.default_rng(max_nnz)
    counts = rng.integers(0, max_nnz + 1, (2, 8))
    counts[0, 0] = max_nnz
    cols = np.stack([[rng.permutation(8)[:max_nnz] for _ in range(8)]
                     for _ in range(2)])
    blocks = np.abs(rng.standard_normal((2, 8, max_nnz, 128, 128)) * 0.02
                    ).astype(np.float32)
    blocks[np.arange(max_nnz)[None, None, :] >= counts[:, :, None]] = 0.0
    rng = np.random.default_rng(9 + max_nnz)
    x = rng.standard_normal((2, 1024, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.06).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    return blocks, cols, counts, x, w, b


def _walk_entries(blocks, cols, counts, h, blocked):
    """The fp32 SIMT walk that bsr_tile.cuh ran before the 3xTF32 tile: per
    block row, the entries in list order, each 128-deep product summed by
    fmaf (an fp32 product is exact in float64, so each step rounds once);
    `blocked` sums each entry apart and adds it to the total, else one
    chain runs over every entry."""
    out = np.zeros((*h.shape[:2], h.shape[-1]), np.float32)
    for z, i in np.ndindex(*counts.shape):
        acc = np.zeros((128, h.shape[-1]), np.float32)
        for k in range(counts[z, i]):
            blk = blocks[z, i, k].astype(np.float64)
            hk = h[z, cols[z, i, k] * 128:(cols[z, i, k] + 1) * 128]
            part = np.zeros_like(acc) if blocked else acc
            for kk in range(128):
                part = (part + blk[:, kk, None] * hk[kk]).astype(np.float32)
            acc = acc + part if blocked else part
        out[z, i * 128:(i + 1) * 128] = acc
    return out


def _walk_three_tf32(blocks, cols, counts, h):
    """bsr_tile.cuh's walk on the 3xTF32 tile: per block row, the entries
    in list order, each 128-deep product through `mma_tile` into the one
    accumulator (K = 128 is one partial sum, added to the total)."""
    out = np.zeros((*h.shape[:2], h.shape[-1]), np.float32)
    for z, i in np.ndindex(*counts.shape):
        acc = np.zeros((128, h.shape[-1]), np.float32)
        for k in range(counts[z, i]):
            c = cols[z, i, k]
            acc = three_tf32(blocks[z, i, k], h[z, c * 128:(c + 1) * 128],
                             acc=acc)
        out[z, i * 128:(i + 1) * 128] = acc
    return out


def _walk_f64(blocks, cols, counts, h):
    """The walk's sum in float64: every entry's product, in list order."""
    out = np.zeros((*h.shape[:2], h.shape[-1]))
    for z, i in np.ndindex(*counts.shape):
        for k in range(counts[z, i]):
            c = cols[z, i, k]
            out[z, i * 128:(i + 1) * 128] += blocks[z, i, k].astype(
                np.float64) @ h[z, c * 128:(c + 1) * 128].astype(np.float64)
    return out


@pytest.mark.parametrize("max_nnz", [2, 6])
def test_grasp_walk_sums_each_entry_apart(max_nnz):
    """fused_gcn_grasp emulated: the 3xTF32 combine's fp32 H, then the
    walk. Summing each entry's product apart keeps the layer within twice
    the plain version's error against float64 (the card test's bar); one
    fp32 chain over 768 terms (6 entries) misses it."""
    blocks, cols, counts, x, w, b = _grasp_layer(max_nnz)
    h = np.stack([three_tf32(xz, w) for xz in x])
    h64 = np.matmul(x.astype(np.float64), w.astype(np.float64))
    want = _walk_f64(blocks, cols, counts, h64) + b
    plain = fl.fused_gcn_grasp_plain(
        torch.from_numpy(blocks.reshape(2, 8 * max_nnz, 128, 128)),
        torch.from_numpy(cols.astype(np.int32)),
        torch.from_numpy(counts.astype(np.int32)), torch.from_numpy(x),
        torch.from_numpy(w), torch.from_numpy(b)).numpy()
    got = _walk_entries(blocks, cols, counts, h, blocked=True) + b
    np.testing.assert_allclose(got, plain, **CARD)
    assert _rel(got, want) <= 2 * _rel(plain, want)
    if max_nnz == 6:
        chain = _walk_entries(blocks, cols, counts, h, blocked=False) + b
        assert _rel(chain, want) > 2 * _rel(plain, want)


@pytest.mark.parametrize("max_nnz", [1, 2, 6])
@pytest.mark.parametrize("kernel", ["fused_gcn_grasp", "bitmap_spmm"])
def test_grasp_walk_three_tf32_keeps_the_card_bar(kernel, max_nnz):
    """The GraSp walk on the 3xTF32 tile, emulated: fused_gcn_grasp with the
    3xTF32 combine's H (bias in the store), bitmap_spmm on the layer's fp32
    H = X @ W. Within the card bar of the plain version, and within twice
    the plain version's error against float64."""
    blocks, cols, counts, x, w, b = _grasp_layer(max_nnz)
    structure = (torch.from_numpy(blocks.reshape(2, 8 * max_nnz, 128, 128)),
                 torch.from_numpy(cols.astype(np.int32)),
                 torch.from_numpy(counts.astype(np.int32)))
    if kernel == "fused_gcn_grasp":
        h = np.stack([three_tf32(xz, w) for xz in x])
        got = _walk_three_tf32(blocks, cols, counts, h) + b
        plain = fl.fused_gcn_grasp_plain(
            *structure, torch.from_numpy(x), torch.from_numpy(w),
            torch.from_numpy(b)).numpy()
        want = _walk_f64(blocks, cols, counts,
                         np.matmul(x.astype(np.float64), w)) + b
    else:
        h = np.matmul(x, w)
        got = _walk_three_tf32(blocks, cols, counts, h)
        plain = bs.bitmap_spmm_plain(*structure,
                                     torch.from_numpy(h)).numpy()
        want = _walk_f64(blocks, cols, counts, h)
    np.testing.assert_allclose(got, plain, **CARD)
    assert _rel(got, want) <= 2 * _rel(plain, want)


def test_gcn_layers_run_the_three_tf32_launcher():
    """Both GCN layer kernels reach X @ W through the 3xTF32 launcher, the
    GraSp walk runs its entries through the same tile's `mma_tile`, and the
    fp32 SIMT tile is gone: no source under csrc/ includes it."""
    csrc = Path(fl.__file__).parent / "csrc"
    for name in ("fused_gcn_dense.cu", "fused_gcn_grasp.cu"):
        text = (csrc / name).read_text()
        assert "launch_gemm_f32" not in text, name
        assert "launch_gemm_3xtf32" in text, name
    assert "launch_gemm_3xtf32<true>" in (
        csrc / "fused_gcn_dense.cu").read_text()
    assert not (csrc / "gemm_tile.cuh").exists()
    for src in sorted(csrc.glob("*.cu*")):
        assert '#include "gemm_tile.cuh"' not in src.read_text(), src.name
    walk = (csrc / "bsr_tile.cuh").read_text()
    assert '#include "tc_gemm_tile.cuh"' in walk
    assert "mma_tile<" in walk and "fmaf" not in walk


# ------------------------------------------------------- GAT body P.H
GAT_CHAIN = 16          # columns per fresh chain: one softmax step at layer
                        # 2, half of one at layer 1 (csrc/gat_tile.cuh)


def _elu(x):
    return np.where(x > 0, x, np.expm1(np.minimum(x, 0)))


def _gat_weights(h, a_src, a_dst, bias):
    """Per head the body's softmax weights p = exp(s - max_j s) (float32,
    max-subtracted, as the body's once its running max is the row's) and
    their row sums l, with s = leaky_0.2(alpha_dst + alpha_src) + bias."""
    ad = np.einsum("nhf,hf->nh", h, a_dst).astype(np.float32)
    as_ = np.einsum("nhf,hf->nh", h, a_src).astype(np.float32)
    out = []
    for hd in range(h.shape[1]):
        e = ad[:, None, hd] + as_[None, :, hd]
        e = np.maximum(e, np.float32(0.2) * e) + bias
        p = np.exp((e - e.max(axis=1, keepdims=True)).astype(np.float64))
        out.append((p.astype(np.float32), p.sum(axis=1)))
    return out


def _gat_serving_ph():
    """P and H of the Cora GAT's two layers at the 3072 bucket, on 224
    rows with neighbours and 32 NodePad rows: {layer: [(p, h, l) per
    head]}."""
    rng = np.random.default_rng(11)
    pg = pad_graph(cora_like(seed=0), capacity=3072)
    bias = masks.attention_bias_additive(
        masks.adj_with_self_loops(pg.adj, pg.num_nodes)).astype(np.float32)
    rows = np.r_[0:224, 3040:3072]
    x = pg.features.astype(np.float32)
    w1, w2 = _glorot(rng, 1433, 64), _glorot(rng, 64, 7)
    a1 = [_glorot(rng, 8, 8) for _ in range(2)]
    a2 = [_glorot(rng, 1, 7) for _ in range(2)]
    h1 = np.matmul(x, w1).reshape(-1, 8, 8)
    wts1 = _gat_weights(h1, a1[0], a1[1], bias)
    x2 = _elu(np.stack([(p.astype(np.float64) @ h1[:, hd]) / l[:, None]
                        for hd, (p, l) in enumerate(wts1)], axis=1)
              ).reshape(-1, 64).astype(np.float32)
    h2 = np.matmul(x2, w2).reshape(-1, 1, 7)
    wts2 = _gat_weights(h2, a2[0], a2[1], bias)
    return {layer: [(p[rows], h[:, hd], l[rows])
                    for hd, (p, l) in enumerate(wts)]
            for layer, h, wts in (("L1 8 heads of 8", h1, wts1),
                                  ("L2 1 head of 7", h2, wts2))}


GAT_PH = _gat_serving_ph()


def test_gat_serving_weights_mix_neighbours_and_padded_rows():
    for layer, heads in GAT_PH.items():
        for p, _, l in heads:
            nnz = (p > 0).sum(axis=1)
            assert (nnz[224:] == 3072).all(), layer   # NodePad: every column
            assert (nnz[:224] < 200).all(), layer     # the mask's density
            assert np.allclose(l[224:], 3072.0)


def _unit(h):
    """h scaled to a largest |h| of 1: a layer whose h is of order one."""
    return (h / np.abs(h).max()).astype(np.float32)


@pytest.mark.parametrize("scale", ["served", "unit"])
@pytest.mark.parametrize("layer", sorted(GAT_PH))
def test_gat_body_three_tf32_keeps_the_card_bar(layer, scale):
    for p, h, l in GAT_PH[layer]:
        h = _unit(h) if scale == "unit" else h
        want = _f64(p, h) / l[:, None]
        got = three_tf32(p, h, chain=GAT_CHAIN, flush=GAT_CHAIN) / np.maximum(
            l.astype(np.float32), np.float32(1e-12))[:, None]
        np.testing.assert_allclose(got, want, **CARD)
        # fp32's order of accuracy, relative to the outputs' scale
        assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("layer", sorted(GAT_PH))
def test_gat_body_one_tf32_product_loses_the_bar_rtol(layer):
    """At the served data the outputs stay near 0.01, so the bar's atol
    alone covers one TF32 product; relative to the outputs' scale it loses
    more than the bar's rtol, hundreds of times fp32's error."""
    for p, h, l in GAT_PH[layer]:
        want = _f64(p, h) / l[:, None]
        one = _rel(one_tf32(p, h) / l[:, None].astype(np.float32), want)
        assert one > 1e-4
        assert one > 100 * _rel(
            np.matmul(p, h, dtype=np.float32) / l[:, None].astype(np.float32),
            want)


@pytest.mark.parametrize("layer", sorted(GAT_PH))
def test_gat_body_one_tf32_product_misses_the_card_bar(layer):
    """With h of order one, one TF32 product misses the bar that 3xTF32
    keeps (test_gat_body_three_tf32_keeps_the_card_bar[unit])."""
    for p, h, l in GAT_PH[layer]:
        h = _unit(h)
        assert not np.allclose(one_tf32(p, h) / l[:, None].astype(np.float32),
                               _f64(p, h) / l[:, None], **CARD)


# -- the int8 tile of csrc/igemm_tile.cuh: staging and the m16n8k32 map --

I8_BM, I8_BN, I8_BK = 64, 128, 64        # kBM, kBN, kBK
I8_ROW_WORDS, I8_COL_WORDS = 20, 136     # kRowWords, kColWords
I8_THREADS = 256
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4               # the fragments' (g, t) of a lane


def _word(b4):
    """(..., 4) bytes -> (...) uint32, byte e at bits 8e (little-endian)."""
    b = b4.astype(np.int64) & 0xff
    return (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24
            ).astype(np.uint32)


def _bytes(w):
    """(...) uint32 -> (..., 4) signed bytes."""
    b = (w.astype(np.int64)[..., None] >> (8 * np.arange(4))) & 0xff
    return np.where(b > 127, b - 256, b)


def byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the eight bytes x (0-3), y (4-7)."""
    src = np.concatenate([_bytes(x) & 0xff, _bytes(y) & 0xff], axis=-1)
    return _word(np.stack([src[..., (s >> 4 * i) & 7] for i in range(4)],
                          axis=-1))


def transpose4(r):
    """The tile's `transpose4`: four K rows of four columns -> four column
    words of four K, by `__byte_perm`."""
    t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[0], r[1], 0x7362)
    t2, t3 = byte_perm(r[2], r[3], 0x5140), byte_perm(r[2], r[3], 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def _masked(src, rows, cols):
    """src[rows, cols] with zeros where either index is out of range."""
    ok = (rows < src.shape[0]) & (cols < src.shape[1])
    return np.where(ok, src[np.minimum(rows, src.shape[0] - 1),
                            np.minimum(cols, src.shape[1] - 1)], 0)


# the A row and K word whose address lane l gives ldmatrix: row l % 8 of
# matrix l / 8, eight rows down for matrices 1 and 3, four words (16 K)
# on for matrices 2 and 3
ldm_row = LANE % 8 + 8 * ((LANE // 8) % 2)
ldm_word = 4 * (LANE // 16)


def ldmatrix_x4(words, addr):
    """ldmatrix.x4 .b16 over 16-byte rows: register m of lane (g, t) is
    word t of the row whose address lane 8m + g gave."""
    return [words[addr[8 * m + G] + T] for m in range(4)]


def mma_m16n8k32(c, a, b):
    """mma.sync m16n8k32 s8 as the PTX ISA places its fragments: A register
    r holds row g + 8 (r % 2), K 4t + 16 (r // 2) + 0..3; B register r
    holds K 4t + 16 r + 0..3 of column g; c0, c1 sit at row g, columns 2t,
    2t + 1, and c2, c3 eight rows below."""
    am = np.zeros((16, 32), np.int64)
    for r in range(4):
        am[(G + 8 * (r % 2))[:, None],
           4 * T[:, None] + 16 * (r // 2) + np.arange(4)] = _bytes(a[r])
    bm = np.zeros((32, 8), np.int64)
    for r in range(2):
        bm[4 * T[:, None] + 16 * r + np.arange(4), G[:, None]] = _bytes(b[r])
    d = am @ bm
    return [c[r] + d[G + 8 * (r // 2), 2 * T + r % 2] for r in range(4)]


def igemm_tile(a, b, n, k_major):
    """The product as the tile stages, multiplies and stores it: a (M, K)
    int8; b (K, N) row-major, or (N, ldb) K-major with ldb >= K. Returns
    the (M, N) sums at the places the epilogue stores them."""
    m, k = a.shape
    out = np.full((m, n), np.iinfo(np.int64).min)
    q_a = np.arange(I8_BM * I8_BK // 4)              # A words of a slab
    q_b = np.arange(I8_BK * I8_BN // 16)             # B copies of a slab
    for row0 in range(0, m, I8_BM):
        for col0 in range(0, n, I8_BN):
            acc = np.zeros((8, 2, 4, 4, 32), np.int64)
            for k0 in range(0, max(k, 1), I8_BK):
                a_s = np.zeros(I8_BM * I8_ROW_WORDS, np.uint32)
                r, w = q_a // 16, q_a % 16
                a_s[r * I8_ROW_WORDS + w] = _word(_masked(
                    a, (row0 + r)[:, None],
                    (k0 + 4 * w)[:, None] + np.arange(4)))
                b_s = np.zeros(I8_BN * I8_ROW_WORDS, np.uint32)
                if k_major:
                    # 16-byte copies of whole chunks that start below K,
                    # read from the pitch (bytes past K included)
                    nn, ch = q_b // 4, q_b % 4
                    gk = (k0 + 16 * ch)[:, None] + np.arange(16)
                    chunk = np.where(
                        ((col0 + nn < n) & (k0 + 16 * ch < k))[:, None],
                        _masked(b, (col0 + nn)[:, None], gk), 0)
                    for e in range(4):
                        b_s[nn * I8_ROW_WORDS + 4 * ch + e] = _word(
                            chunk[:, 4 * e:4 * e + 4])
                else:
                    # the ring holds the slab as it lies, 64 rows of 32
                    # words; each thread turns four rows of one word
                    ring = _word(_masked(
                        b, (k0 + np.arange(I8_BK))[:, None, None],
                        col0 + 4 * np.arange(32)[None, :, None]
                        + np.arange(4)))
                    kw, cw = q_b // 32, q_b % 32
                    rows = [ring[4 * kw + j, cw] for j in range(4)]
                    for e, col_word in enumerate(transpose4(rows)):
                        b_s[kw * I8_COL_WORDS + 4 * cw + e] = col_word
                for warp in range(8):
                    wm, wn = divmod(warp, 4)
                    for kk in range(I8_BK // 32):
                        kw = kk * 8 + T
                        for i in range(2):
                            frag_a = ldmatrix_x4(a_s, (
                                (wm * 32 + i * 16 + ldm_row) * I8_ROW_WORDS
                                + kk * 8 + ldm_word))
                            for j in range(4):
                                nn = wn * 32 + j * 8 + G
                                frag_b = ([b_s[nn * I8_ROW_WORDS + kw],
                                           b_s[nn * I8_ROW_WORDS + kw + 4]]
                                          if k_major else
                                          [b_s[kw * I8_COL_WORDS + nn],
                                           b_s[(kw + 4) * I8_COL_WORDS + nn]])
                                acc[warp, i, j] = mma_m16n8k32(
                                    acc[warp, i, j], frag_a, frag_b)
            for warp in range(8):
                wm, wn = divmod(warp, 4)
                for i in range(2):
                    for j in range(4):
                        for c_reg in range(4):
                            r = row0 + wm * 32 + i * 16 + G + 8 * (c_reg // 2)
                            c = col0 + wn * 32 + j * 8 + 2 * T + c_reg % 2
                            ok = (r < m) & (c < n)
                            out[r[ok], c[ok]] = acc[warp, i, j, c_reg][ok]
    return out


def _s8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _int8_tile_case(name):
    """(a, b as the tile reads it, N, K-major?, the plain product)."""
    from repro_torch.kernels.int8_matmul import int_matmul
    rng = np.random.default_rng(22)
    if name == "K-major Hq":
        # the aggregate of fused_gcn_int8: Âq (200, 200) @ Hq (200, 128),
        # Hq stored by the combine's epilogue K-major at pitch 208, the 8
        # bytes past K never written (junk here)
        n, o = 200, 128
        aq, hq = _s8(rng, n, n), _s8(rng, n, o)
        ldk = -(-n // 16) * 16
        scratch = _s8(rng, o, ldk)
        r = np.arange(n)[:, None]
        c = np.arange(o)[None, :]
        scratch.reshape(-1)[(c * ldk + r).reshape(-1)] = hq.reshape(-1)
        return aq, scratch, o, True, int_matmul(torch.from_numpy(aq),
                                                torch.from_numpy(hq))
    m, k, n = {"row-major B": (96, 192, 128), "ragged": (70, 45, 30)}[name]
    a, b = _s8(rng, m, k), _s8(rng, k, n)
    return a, b, n, False, int_matmul(torch.from_numpy(a), torch.from_numpy(b))


def test_transpose4_turns_rows_into_column_words():
    rng = np.random.default_rng(5)
    block = _s8(rng, 4, 4)
    got = transpose4([_word(block[j]) for j in range(4)])
    for e in range(4):
        np.testing.assert_array_equal(_bytes(got[e]), block[:, e])


@pytest.mark.parametrize("case", ["row-major B", "K-major Hq", "ragged"])
def test_int8_tile_fragment_map_reassembles_the_product(case):
    """The s8 tile's staging (row-major B turned by `__byte_perm`, K-major
    B copied in 16-byte chunks) and its m16n8k32 fragment indexing, at
    the tile's shared-memory strides, give back the exact product."""
    a, b, n, k_major, want = _int8_tile_case(case)
    got = igemm_tile(a, b, n, k_major)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


@pytest.mark.parametrize("operand", ["A", "K-major B", "row-major B"])
def test_int8_tile_fragment_reads_hit_32_banks(operand):
    """Each fragment read of a warp touches 32 different banks of shared
    memory at the tile's strides (word address mod 32): a 32-bit read of B
    across the warp, and each 8-lane phase of A's ldmatrix (eight 16-byte
    rows)."""
    for wm, wn, kk, f, reg in np.ndindex(2, 4, 2, 4, 4):
        kw = kk * 8 + T + 4 * (reg // 2)
        if operand == "A":
            if f >= 2 or reg:
                continue
            rows = ((wm * 32 + f * 16 + ldm_row) * I8_ROW_WORDS + kk * 8
                    + ldm_word)
            for m in range(4):
                phase = rows[8 * m:8 * m + 8, None] + np.arange(4)
                assert len(set((phase % 32).ravel().tolist())) == 32
            continue
        if reg % 2:
            continue                       # B has two registers: 0 and 2
        elif operand == "K-major B":
            addr = (wn * 32 + f * 8 + G) * I8_ROW_WORDS + kw
        else:
            addr = kw * I8_COL_WORDS + wn * 32 + f * 8 + G
        assert len(set((addr % 32).tolist())) == 32, (operand, wm, wn, kk)


# ------------------------------------------------- fused_sage's combine
SAGE_ROWS = 256         # rows of the graph the combine is emulated on


@functools.lru_cache(maxsize=None)
def _sage_layers():
    """One Cora graph through the Cora SAGE's two layers (1433 -> 64 -> 7,
    10 sampled neighbours and the self loop), by aggregator and layer: the
    layer's mask rows, its aggregation input xk over every node (X for
    mean, the pooled features relu(X @ W_pool + b_pool) for max), its X
    rows, W_self, W_neigh and b, on the first SAGE_ROWS rows. Layer 2
    takes layer 1's relu output (fp32)."""
    rng = np.random.default_rng(24)
    pg = pad_graph(cora_like(seed=0), capacity=2708)
    sample = masks.sage_sample_adjacency(pg.adj, pg.num_nodes,
                                         max_neighbors=10)
    mean = masks.mean_from_mask(sample)
    out = {}
    for aggregator in ("mean", "max"):
        x = pg.features.astype(np.float32)
        for layer, (fin, fout) in (("L1", (1433, 64)), ("L2", (64, 7))):
            ws, wn = _glorot(rng, fin, fout), _glorot(rng, fin, fout)
            b = (0.1 * rng.standard_normal(fout)).astype(np.float32)
            if aggregator == "mean":
                mask, xk = mean, x
            else:
                w_pool = _glorot(rng, fin, fin)
                b_pool = (0.1 * rng.standard_normal(fin)).astype(np.float32)
                mask = sample
                xk = np.maximum(np.matmul(x, w_pool) + b_pool, 0)
            out[layer, aggregator] = (mask[:SAGE_ROWS], xk, x[:SAGE_ROWS],
                                      ws, wn, b)
            agg = np.matmul(mask, xk) if aggregator == "mean" else np.stack(
                [xk[row > 0].max(axis=0, initial=0.0) for row in sample])
            x = np.maximum(np.matmul(x, ws) + np.matmul(agg, wn) + b, 0)
    return out


def _walk(mask, xk, aggregator):
    """sage_walk.cuh's row walk: over each row's set columns in ascending
    order, fmaf(m, xk[j], acc) (mean) or max(acc, m * xk[j]) (max), from
    0. An fp32 product is exact in float64, so the sum rounds once."""
    agg = np.zeros((mask.shape[0], xk.shape[1]), np.float32)
    for i, row in enumerate(mask):
        for j in np.flatnonzero(row):
            if aggregator == "mean":
                agg[i] = (np.float64(row[j]) * xk[j] + agg[i]).astype(
                    np.float32)
            else:
                agg[i] = np.maximum(agg[i], row[j] * xk[j])
    return agg


@pytest.mark.parametrize("aggregator", ["mean", "max"])
@pytest.mark.parametrize("layer", ["L1", "L2"])
def test_sage_combine_three_tf32_keeps_the_card_bar(layer, aggregator):
    """fused_sage's combine (csrc/fused_sage.cu) emulated on the Cora SAGE:
    the walk's AGG, then X @ W_self and AGG @ W_neigh through one
    accumulator, each product with its own 16-deep chains and 128-deep
    partial sums flushed into the one total (the AGG loop starts from the
    X loop's total, past the last ragged partial sum of its K), and the
    bias in the store. Within the card bar of the plain version, and
    within twice an fp32 layer's error against float64."""
    mask, xk, x, ws, wn, b = _sage_layers()[layer, aggregator]
    agg = _walk(mask, xk, aggregator)
    got = three_tf32(agg, wn, acc=three_tf32(x, ws)) + b
    plain = fl.fused_sage_plain(*(torch.from_numpy(t) for t in (
        mask, xk, x, ws, wn, b)), aggregator).numpy()
    np.testing.assert_allclose(got, plain, **CARD)
    agg64 = (_f64(mask, xk) if aggregator == "mean" else
             agg.astype(np.float64))          # a max rounds nothing
    want = _f64(x, ws) + _f64(agg64, wn) + b
    assert _rel(got, want) <= 2 * _rel(plain, want)
