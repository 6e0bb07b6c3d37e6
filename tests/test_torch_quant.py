"""PyTorch port, QuantGr math: each function of `repro_torch.core.quant`
against the reference's `repro.core.quant` on the same numpy inputs.

Tolerance: none where the result is an int8 tensor, a scale, or an exact
s32 product times elementwise scales — those are equal exactly (both
packages round half to even and take the same IEEE steps). Only
`quant_error`, a ratio of two norms summed in different orders, is held
within rtol 1e-5.

Â's row quantization is held against the reference as its serving engine
runs it, under `jax.jit`: there XLA turns `amax / 127` into a multiply by
the float32 reciprocal, which the port copies
(`test_row_scales_follow_the_compiled_reference`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import models as rmodels
from repro.core import quant as rq
from repro_torch.core import quant as tq
from repro_torch.kernels import int8_matmul as im


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _s8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(params=["interpret", "ref"])
def kernel_mode(request, monkeypatch):
    """The reference's kernel routing for `use_kernel=True`: its Pallas
    grids in interpret mode, or its jnp twins."""
    if request.param == "ref":
        monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    else:
        monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)
        monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    return request.param


@pytest.mark.parametrize("axis", [None, 0])
def test_calibrate_quantize_dequantize_match_reference(axis):
    rng = np.random.default_rng(0)
    x = _arr(rng, 64, 24, scale=3.0)
    x[:, 5] = 0.0                            # an all-zero channel: 1e-8 floor
    rqp = rq.calibrate_absmax(jnp.asarray(x), axis=axis)
    tqp = tq.calibrate_absmax(_t(x), axis=axis)
    _eq(tqp.scale, rqp.scale)
    _eq(tq.quantize(_t(x), tqp), rq.quantize(jnp.asarray(x), rqp))
    xq = _s8(rng, 64, 24)
    _eq(tq.dequantize(_t(xq), tqp), rq.dequantize(jnp.asarray(xq), rqp))


def test_quantize_rounds_half_to_even_like_reference():
    # scale 0.25 is a power of two: every x / scale below is an exact tie
    x = np.array([0.125, 0.375, 0.625, -0.125, -0.625, 31.875, -40.0,
                  0.0], np.float32)
    want = rq.quantize(jnp.asarray(x), rq.QParams(scale=jnp.float32(0.25)))
    got = tq.quantize(_t(x), tq.QParams(scale=torch.tensor(0.25)))
    _eq(got, want)
    assert got.tolist() == [0, 2, 2, 0, -2, 127, -127, 0]


def test_quantized_matmul_ref_matches_reference():
    rng = np.random.default_rng(1)
    xq, wq = _s8(rng, 70, 45), _s8(rng, 45, 30)
    sx = np.float32(0.013)
    sw = rng.uniform(1e-3, 1e-2, 30).astype(np.float32)
    _eq(tq.quantized_matmul_ref(_t(xq), _t(wq), torch.tensor(sx), _t(sw)),
        rq.quantized_matmul_ref(jnp.asarray(xq), jnp.asarray(wq),
                                jnp.asarray(sx), jnp.asarray(sw)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_quantize_and_apply_linear_match_reference(kernel_mode, use_kernel):
    rng = np.random.default_rng(2)
    w, x = _arr(rng, 40, 24, scale=0.2), _arr(rng, 90, 40)
    rql = rq.quantize_linear(jnp.asarray(w), jnp.asarray(x))
    tql = tq.quantize_linear(_t(w), _t(x))
    for name in ("wq", "w_scale", "x_scale"):
        _eq(getattr(tql, name), getattr(rql, name))
    x2 = _arr(rng, 90, 40, scale=1.3)        # some values clip at +-127
    _eq(tq.apply_quantized_linear(_t(x2), tql, use_kernel=use_kernel),
        rq.apply_quantized_linear(jnp.asarray(x2), rql,
                                  use_kernel=use_kernel))


def test_quantize_agg_forms_match_reference():
    rng = np.random.default_rng(3)
    adj = np.abs(_arr(rng, 100, 100, scale=0.1))
    adj[7] = 0.0                              # an isolated (padded) row
    h = _arr(rng, 100, 16)
    rqa = rq.quantize_agg(jnp.asarray(adj), jnp.asarray(h))
    tqa = tq.quantize_agg(_t(adj), _t(h))
    for name in ("aq", "a_scale", "h_scale"):
        _eq(getattr(tqa, name), getattr(rqa, name))
    raq, ras = jax.jit(rq.quantize_rowwise)(jnp.asarray(adj))
    taq, tas = tq.quantize_rowwise(_t(adj))
    _eq(taq, raq)
    _eq(tas, ras)
    dyn = tq.quantize_agg_dynamic(_t(adj), torch.tensor(np.float32(0.02)))
    rdyn = jax.jit(rq.quantize_agg_dynamic)(jnp.asarray(adj),
                                            jnp.float32(0.02))
    _eq(dyn.aq, rdyn.aq)
    _eq(dyn.a_scale, rdyn.a_scale)
    # batched rows quantize graph by graph
    bq, bs = tq.quantize_rowwise(_t(np.stack([adj, 2 * adj])))
    _eq(bq[0], raq)
    _eq(bs[1], jax.jit(rq.quantize_rowwise)(jnp.asarray(2 * adj))[1])


def test_row_scales_follow_the_compiled_reference():
    # the reference's eager and jitted row scales disagree in the last bit
    # for some rows; its serving deriver is the jitted one
    rng = np.random.default_rng(11)
    adj = np.abs(_arr(rng, 256, 256, scale=0.37))
    eager = np.asarray(rq.quantize_rowwise(jnp.asarray(adj))[1])
    served = np.asarray(rmodels.build_agg_quantizer()(
        jnp.asarray(adj)).agg_a_scale)
    got = tq.quantize_rowwise(_t(adj))[1].numpy()
    assert (eager != served).any()
    np.testing.assert_array_equal(got, served)
    np.testing.assert_array_equal(got, (np.maximum(adj.max(-1, keepdims=True),
                                                   np.float32(1e-8))
                                        * np.float32(1 / 127)))
    np.testing.assert_allclose(got, eager, rtol=2 ** -23)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_quantized_agg_matches_reference(kernel_mode, use_kernel):
    rng = np.random.default_rng(4)
    adj = np.abs(_arr(rng, 128, 128, scale=0.1))
    h = _arr(rng, 128, 20, scale=2.0)
    rqa = rq.quantize_agg(jnp.asarray(adj), jnp.asarray(h))
    tqa = tq.quantize_agg(_t(adj), _t(h))
    h2 = _arr(rng, 128, 20, scale=2.5)
    _eq(tq.apply_quantized_agg(tqa, _t(h2), use_kernel=use_kernel),
        rq.apply_quantized_agg(rqa, jnp.asarray(h2), use_kernel=use_kernel))


def test_quantize_tree_and_quant_error_match_reference():
    rng = np.random.default_rng(5)
    params = {"a": _arr(rng, 12, 8), "b": _arr(rng, 8, 3)}
    acts = {"a": _arr(rng, 30, 12), "b": _arr(rng, 30, 8)}
    rtree = rq.quantize_tree({k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in acts.items()})
    ttree = tq.quantize_tree({k: _t(v) for k, v in params.items()},
                             {k: _t(v) for k, v in acts.items()})
    assert sorted(ttree) == sorted(rtree)
    for k in rtree:
        _eq(ttree[k].wq, rtree[k].wq)
        _eq(ttree[k].x_scale, rtree[k].x_scale)
    x = _arr(rng, 50, 40)
    got, want = tq.quant_error(_t(x)), rq.quant_error(jnp.asarray(x))
    assert 0 < got < 0.02
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_int_matmul_is_exact_where_int8_matmul_wraps():
    # all-127 rows: every product sums to K * 127**2, far past int8 and
    # past float32's 2**24 integer range, yet inside int32
    k = 1433
    a = torch.full((3, k), 127, dtype=torch.int8)
    b = torch.full((k, 2), 127, dtype=torch.int8)
    b[:, 1] = -127
    got = im.int_matmul(a, b)
    assert got.dtype == torch.int32
    assert got[0].tolist() == [k * 127 ** 2, -k * 127 ** 2]
    assert torch.matmul(a, b).dtype == torch.int8       # wraps instead
    assert torch.matmul(a, b)[0, 0].item() != k * 127 ** 2
    rng = np.random.default_rng(6)
    x, w = _s8(rng, 2, 50, 3072), _s8(rng, 3072, 9)
    np.testing.assert_array_equal(
        im.int_matmul(_t(x), _t(w)).numpy(),
        np.einsum("bmk,kn->bmn", x.astype(np.int64), w.astype(np.int64)))
    with pytest.raises(ValueError, match="overflow"):
        im.int_matmul(torch.zeros(1, 200_000, dtype=torch.int8),
                      torch.zeros(200_000, 1, dtype=torch.int8))
