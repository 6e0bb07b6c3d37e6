"""The routes of the port's redesigned kernels and the 3xTF32 arithmetic,
on the CPU with no card.

`flash_attention` picks its kernel by dtype and head dim alone
(`flash_route`): the bf16 tensor-core route at D 64 and 128, the SIMT route
otherwise. `block_matmul` runs 3xTF32 on the TF32 tensor cores; its
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

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import masks
from repro_torch.core.graph import pad_graph
from repro_torch.data.graphs import cora_like
from repro_torch.kernels import compare_builds as cb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as kref

CARD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_route(dtype, head_dim):
    want = ("wgmma" if dtype == torch.bfloat16 and head_dim in (64, 128)
            else "simt")
    assert fa.flash_route(dtype, head_dim) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_flash_route_rejects_dtype(dtype):
    with pytest.raises(TypeError):
        fa.flash_route(dtype, 64)


@pytest.mark.parametrize("head_dim", [16, 48, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_route_rejects_head_dim(dtype, head_dim):
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_route(dtype, head_dim)


@pytest.mark.parametrize("head_dim", [32, 64, 128])
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
               flush: int = 128) -> np.ndarray:
    """The tile's arithmetic: per 8 of K the three m16n8k8 products (small
    terms first), each truncated into a chain of `chain` of K that starts
    from 0; chains summed in fp32 into a partial sum of `flush` of K,
    partial sums into the total. chain = flush > K is one accumulator over
    all of K."""
    (ab, as_), (bb, bs) = split(a), split(b)
    ab, as_, bb, bs = (t.astype(np.float64) for t in (ab, as_, bb, bs))
    k = a.shape[1]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
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
