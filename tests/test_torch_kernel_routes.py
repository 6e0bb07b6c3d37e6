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
"""

import numpy as np
import pytest
import torch

from repro_torch.core.graph import pad_graph
from repro_torch.data.graphs import cora_like
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
