"""PyTorch port, kernel modules: the plain versions and the `ops` entries of
`repro_torch` against the reference's Pallas kernels (interpret mode, as
conftest sets) and its `ref` twins, and the device routing of the
wrappers. The kernels themselves are checked on a card by
`test_torch_cuda.py`.

Tolerance: fp32 rtol=atol=1e-5 against JAX — XLA's CPU dots and ATen's
CPU GEMM sum in different orders. The int8 products are exact, so
`int8_matmul` is held equal; the fused int8 layer keeps rtol=atol=1e-5
because XLA's CPU jit contracts its epilogue `acc * s + b` into one FMA
where eager PyTorch rounds twice (at most 1 ulp apart). Quantized int8
tensors and weight scales of the calibration are equal exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as rg
from repro.core import models as rmodels
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.block_matmul import block_matmul as jax_block_matmul
from repro.kernels.fused_layers import fused_gcn_dense as jax_fused_gcn_dense
from repro.kernels.fused_layers import fused_gcn_int8 as jax_fused_gcn_int8
from repro.kernels.int8_matmul import int8_matmul as jax_int8_matmul
from repro_torch.core import graph as tg
from repro_torch.core import models as tmodels
from repro_torch.data.graphs import planetoid_like
from repro_torch.kernels import block_matmul as bm_mod
from repro_torch.kernels import fused_layers as fl_mod
from repro_torch.kernels import int8_matmul as im_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)
ACTIVATIONS = ("none", "relu", "elu")


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _s8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _quant_layer(rng, n, fin, o, batch=0):
    """numpy operands of one QuantGr layer: x, wq, w_scale, x_scale,
    h_scale, aq, a_scale, b, with scales that put values on both sides of
    the +-127 clamp."""
    lead = (batch,) if batch else ()
    x = _arr(rng, *lead, n, fin)
    wq = _s8(rng, fin, o)
    w_scale = rng.uniform(2e-3, 6e-3, o).astype(np.float32)
    x_scale = np.float32(np.abs(x).max() / 110.0)
    xq = np.clip(np.round(x / x_scale), -127, 127).astype(np.int64)
    h = (xq @ wq.astype(np.int64)) * (x_scale * w_scale)
    h_scale = np.float32(np.abs(h).max() / 140.0)
    adj = np.abs(_arr(rng, *lead, n, n, scale=0.05))
    a_scale = (np.abs(adj).max(-1, keepdims=True) / 127.0).astype(np.float32)
    aq = np.clip(np.round(adj / a_scale), -127, 127).astype(np.int8)
    return x, wq, w_scale, x_scale, h_scale, aq, a_scale, _arr(rng, o)


@pytest.fixture(params=["interpret", "ref"])
def kernel_mode(request, monkeypatch):
    """The reference's kernel routing: its Pallas grids in interpret mode
    (conftest's default), or its jnp twins."""
    if request.param == "ref":
        monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    else:
        monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)
        monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    return request.param


@pytest.mark.parametrize("batch", [0, 2])
def test_block_matmul_plain_matches_pallas(batch):
    rng = np.random.default_rng(0)
    a = _arr(rng, *((batch,) if batch else ()), 256, 384, scale=384 ** -0.5)
    b = _arr(rng, 384, 128)
    got = bm_mod.block_matmul_plain(_t(a), _t(b)).numpy()
    per_graph = a if batch else a[None]
    want = np.stack([np.asarray(jax_block_matmul(jnp.asarray(g),
                                                 jnp.asarray(b),
                                                 interpret=True))
                     for g in per_graph])
    np.testing.assert_allclose(got, want if batch else want[0], **TOL)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (70, 45, 30),
                                   (200, 130, 7)])
def test_ops_matmul_matches_reference(kernel_mode, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = _arr(rng, m, k), _arr(rng, k, n)
    want = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(tops.matmul(_t(a), _t(b)).numpy(), want,
                               **TOL)
    np.testing.assert_allclose(tref.matmul_ref(_t(a), _t(b)).numpy(),
                               np.asarray(jref.matmul_ref(jnp.asarray(a),
                                                          jnp.asarray(b))),
                               **TOL)


def test_ops_matmul_batched_operands():
    # both batched (Â @ H) and broadcast weights (X @ W), ragged widths
    rng = np.random.default_rng(1)
    adj, h, w = _arr(rng, 3, 100, 100), _arr(rng, 3, 100, 20), _arr(rng, 20, 9)
    np.testing.assert_allclose(tops.matmul(_t(adj), _t(h)).numpy(),
                               np.einsum("bij,bjf->bif", adj, h), **TOL)
    np.testing.assert_allclose(tops.matmul(_t(h), _t(w)).numpy(),
                               h @ w, **TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_fused_gcn_dense_plain_matches_pallas(activation):
    rng = np.random.default_rng(2)
    adj = np.abs(_arr(rng, 2, 256, 256, scale=0.05))
    x, w, b = _arr(rng, 2, 256, 128), _arr(rng, 128, 128, scale=0.3), \
        _arr(rng, 1, 128)
    got = fl_mod.fused_gcn_dense_plain(_t(adj), _t(x), _t(w), _t(b),
                                       activation).numpy()
    want = np.stack([np.asarray(jax_fused_gcn_dense(
        jnp.asarray(adj[i]), jnp.asarray(x[i]), jnp.asarray(w),
        jnp.asarray(b), activation=activation, interpret=True))
        for i in range(2)])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("n,fin,o", [(100, 37, 10), (128, 128, 64)])
def test_ops_fused_gcn_layer_matches_reference(kernel_mode, activation, n,
                                               fin, o):
    rng = np.random.default_rng(n + fin + o)
    adj = np.abs(_arr(rng, n, n, scale=0.05))
    x, w, b = _arr(rng, n, fin), _arr(rng, fin, o, scale=0.3), _arr(rng, o)
    want = np.asarray(jops.fused_gcn_layer(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        norm_adj=jnp.asarray(adj), activation=activation))
    got = tops.fused_gcn_layer(_t(x), _t(w), _t(b), norm_adj=_t(adj),
                               activation=activation).numpy()
    assert got.shape == (n, o)
    np.testing.assert_allclose(got, want, **TOL)
    twin = tref.fused_gcn_layer_ref(_t(x), _t(w), _t(b), norm_adj=_t(adj),
                                    activation=activation).numpy()
    np.testing.assert_allclose(twin, np.asarray(jref.fused_gcn_layer_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b).reshape(1, -1),
        norm_adj=jnp.asarray(adj), activation=activation)), **TOL)
    # batched form: the port's leading dim stands in for the reference vmap
    got_b = tops.fused_gcn_layer(_t(np.stack([x, 2 * x])), _t(w), _t(b),
                                 norm_adj=_t(np.stack([adj, adj])),
                                 activation=activation).numpy()
    np.testing.assert_allclose(got_b[0], want, **TOL)


@pytest.mark.parametrize("batch", [0, 2])
def test_int8_matmul_plain_matches_pallas(batch):
    rng = np.random.default_rng(6)
    a = _s8(rng, *((batch,) if batch else ()), 256, 384)
    b = _s8(rng, 384, 128)
    x_scale = np.float32(0.0123)
    w_scale = rng.uniform(1e-3, 1e-2, 128).astype(np.float32)
    got = im_mod.int8_matmul_plain(_t(a), _t(b), _t(x_scale),
                                   _t(w_scale)).numpy()
    per_graph = a if batch else a[None]
    want = np.stack([np.asarray(jax_int8_matmul(
        jnp.asarray(g), jnp.asarray(b), jnp.asarray(x_scale),
        jnp.asarray(w_scale), interpret=True)) for g in per_graph])
    np.testing.assert_array_equal(got, want if batch else want[0])


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (70, 45, 30),
                                   (200, 130, 7)])
def test_ops_int8_matmul_matches_reference(kernel_mode, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = _s8(rng, m, k), _s8(rng, k, n)
    x_scale = np.float32(0.05)
    w_scale = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    want = np.asarray(jops.int8_matmul(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(x_scale),
                                       jnp.asarray(w_scale)))
    got = tops.int8_matmul(_t(a), _t(b), _t(x_scale), _t(w_scale)).numpy()
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tref.int8_matmul_ref(_t(a), _t(b), _t(x_scale), _t(w_scale)).numpy(),
        np.asarray(jref.int8_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(x_scale),
                                        jnp.asarray(w_scale))))


def test_ops_int8_matmul_batched_operands(kernel_mode):
    # both batched (Âq @ Hq) and broadcast weights (Xq @ Wq), ragged widths
    rng = np.random.default_rng(7)
    aq, hq, wq = _s8(rng, 3, 100, 100), _s8(rng, 3, 100, 20), _s8(rng, 20, 9)
    ones = np.ones(20, np.float32)
    w_scale = rng.uniform(1e-3, 1e-2, 9).astype(np.float32)
    got = tops.int8_matmul(_t(aq), _t(hq), 1.0, _t(ones)).numpy()
    got_w = tops.int8_matmul(_t(hq), _t(wq), _t(np.float32(0.3)),
                             _t(w_scale)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.asarray(jops.int8_matmul(
            jnp.asarray(aq[i]), jnp.asarray(hq[i]), 1.0, jnp.asarray(ones))))
        np.testing.assert_array_equal(got_w[i], np.asarray(jops.int8_matmul(
            jnp.asarray(hq[i]), jnp.asarray(wq), jnp.float32(0.3),
            jnp.asarray(w_scale))))


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_fused_gcn_int8_plain_matches_pallas(activation):
    rng = np.random.default_rng(8)
    x, wq, w_scale, x_scale, h_scale, aq, a_scale, b = _quant_layer(
        rng, 256, 128, 128, batch=2)
    sw = (x_scale * w_scale).reshape(1, -1)
    got = fl_mod.fused_gcn_int8_plain(
        _t(x), _t(wq), _t(sw), _t(x_scale), _t(h_scale), _t(aq),
        _t(a_scale), _t(b), activation).numpy()
    want = np.stack([np.asarray(jax_fused_gcn_int8(
        jnp.asarray(x[i]), jnp.asarray(wq), jnp.asarray(sw),
        jnp.asarray(x_scale).reshape(1, 1), jnp.asarray(h_scale).reshape(1, 1),
        jnp.asarray(aq[i]), jnp.asarray(a_scale[i]),
        jnp.asarray(b).reshape(1, -1), activation=activation,
        interpret=True)) for i in range(2)])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("n,fin,o", [(100, 37, 10), (128, 128, 64)])
def test_ops_fused_gcn_layer_quant_matches_reference(kernel_mode, activation,
                                                     n, fin, o):
    rng = np.random.default_rng(n + fin + o + 1)
    x, wq, w_scale, x_scale, h_scale, aq, a_scale, b = _quant_layer(
        rng, n, fin, o)
    w = _arr(rng, fin, o)                   # unread on the QuantGr branch
    jq = tuple(jnp.asarray(v) for v in (wq, w_scale, x_scale, h_scale, aq,
                                        a_scale))
    tq = tuple(_t(v) for v in (wq, w_scale, x_scale, h_scale, aq, a_scale))
    want = np.asarray(jops.fused_gcn_layer(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), quant=jq,
        activation=activation))
    got = tops.fused_gcn_layer(_t(x), _t(w), _t(b), quant=tq,
                               activation=activation).numpy()
    assert got.shape == (n, o)
    np.testing.assert_allclose(got, want, **TOL)
    twin = tref.fused_gcn_layer_ref(_t(x), _t(w), _t(b), quant=tq,
                                    activation=activation).numpy()
    np.testing.assert_allclose(twin, np.asarray(jref.fused_gcn_layer_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b).reshape(1, -1),
        quant=jq, activation=activation)), **TOL)
    # batched form: aq and a_scale gain the leading graph dim
    tqb = tq[:4] + (_t(np.stack([aq, aq])), _t(np.stack([a_scale] * 2)))
    got_b = tops.fused_gcn_layer(_t(np.stack([x, 0.5 * x])), _t(w), _t(b),
                                 quant=tqb, activation=activation).numpy()
    np.testing.assert_allclose(got_b[0], want, **TOL)


def test_calibrate_tier_matches_reference():
    rng = np.random.default_rng(9)
    g = planetoid_like(num_nodes=150, num_edges=450, num_feats=24,
                       num_classes=4, seed=3, train_per_class=2)
    pg = tg.pad_graph(g, capacity=256)
    w = {"l1": {"w": _arr(rng, 24, 16, scale=0.25),
                "b": _arr(rng, 16, scale=0.1)},
         "l2": {"w": _arr(rng, 16, 4, scale=0.25),
                "b": _arr(rng, 4, scale=0.1)}}
    rcfg = rmodels.GNNConfig(kind="gcn", in_feats=24, hidden=16,
                             num_classes=4)
    tcfg = tmodels.GNNConfig(kind="gcn", in_feats=24, hidden=16,
                             num_classes=4)
    rpg = rg.PaddedGraph(**{f: getattr(pg, f)
                            for f in pg.__dataclass_fields__})
    want = rmodels.calibrate_tier(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
         for k, v in w.items()}, rcfg, jnp.asarray(pg.features),
        rmodels.build_operands(rpg, rcfg, lean=True))
    got = tmodels.calibrate_tier(
        {k: {kk: _t(vv) for kk, vv in v.items()} for k, v in w.items()},
        tcfg, _t(pg.features), tmodels.build_operands(pg, tcfg, device="cpu"))
    assert sorted(got) == sorted(want)
    for layer in ("l1", "l2"):
        np.testing.assert_array_equal(got[layer].wq.numpy(),
                                      np.asarray(want[layer].wq))
        np.testing.assert_array_equal(got[layer].w_scale.numpy(),
                                      np.asarray(want[layer].w_scale))
    np.testing.assert_array_equal(got["l1"].x_scale.numpy(),
                                  np.asarray(want["l1"].x_scale))
    for k in ("agg1_h", "agg2_h"):       # ranges of an fp32 forward
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5)
    np.testing.assert_allclose(got["l2"].x_scale.numpy(),
                               np.asarray(want["l2"].x_scale), rtol=1e-5)


def test_int8_wrappers_route_cpu_to_plain_without_launching():
    im_mod.LAUNCHES = fl_mod.INT8_LAUNCHES = 0
    rng = np.random.default_rng(10)
    a, b = _t(_s8(rng, 2, 128, 128)), _t(_s8(rng, 128, 128))
    ws = torch.rand(128)
    assert torch.equal(im_mod.int8_matmul(a, b, 0.5, ws),
                       im_mod.int8_matmul_plain(a, b, 0.5, ws))
    x, wq, w_scale, x_scale, h_scale, aq, a_scale, bias = (
        _t(v) for v in _quant_layer(rng, 128, 128, 128, batch=2))
    sw = (x_scale * w_scale).reshape(1, -1)
    args = (x, wq, sw, x_scale, h_scale, aq, a_scale, bias, "elu")
    assert torch.equal(fl_mod.fused_gcn_int8(*args),
                       fl_mod.fused_gcn_int8_plain(*args))
    tops.int8_matmul(a, b, 1.0, ws)
    tops.fused_gcn_layer(x, None, bias, quant=(wq, w_scale, x_scale,
                                               h_scale, aq, a_scale))
    assert im_mod.LAUNCHES == 0 and fl_mod.INT8_LAUNCHES == 0


def test_int8_wrappers_raise_off_cpu_instead_of_falling_back():
    meta8 = torch.empty(2, 128, 128, dtype=torch.int8, device="meta")
    cpu8 = torch.zeros(128, 128, dtype=torch.int8)
    one = torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        im_mod.int8_matmul(meta8, cpu8, 1.0, torch.ones(128))
    with pytest.raises(ValueError, match="CUDA"):
        fl_mod.fused_gcn_int8(torch.empty(2, 128, 128, device="meta"), cpu8,
                              torch.ones(1, 128), one, one, meta8,
                              torch.ones(2, 128, 1), torch.zeros(128))
    with pytest.raises(ValueError, match="activation"):
        fl_mod.fused_gcn_int8(torch.zeros(1, 128, 128), cpu8,
                              torch.ones(1, 128), one, one, cpu8[None],
                              torch.ones(1, 128, 1), torch.zeros(128), "gelu")
    assert im_mod.LAUNCHES == 0 and fl_mod.INT8_LAUNCHES == 0


def test_wrappers_route_cpu_to_plain_without_launching():
    bm_mod.LAUNCHES = fl_mod.LAUNCHES = 0
    rng = np.random.default_rng(3)
    a, b = _t(_arr(rng, 2, 128, 128)), _t(_arr(rng, 128, 128))
    assert torch.equal(bm_mod.block_matmul(a, b),
                       bm_mod.block_matmul_plain(a, b))
    bias = _t(_arr(rng, 128))
    assert torch.equal(fl_mod.fused_gcn_dense(a, a, b, bias, "relu"),
                       fl_mod.fused_gcn_dense_plain(a, a, b, bias, "relu"))
    tops.matmul(a, b)
    tops.fused_gcn_layer(a, b, bias, norm_adj=a)
    assert bm_mod.LAUNCHES == 0 and fl_mod.LAUNCHES == 0


def test_wrappers_raise_off_cpu_instead_of_falling_back():
    # a tensor that is neither on the CPU nor on a card: no plain fallback
    meta = torch.empty(2, 128, 128, device="meta")
    cpu = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        bm_mod.block_matmul(meta, cpu)
    with pytest.raises(ValueError, match="CUDA"):
        fl_mod.fused_gcn_dense(meta, meta, cpu, torch.zeros(128))
    with pytest.raises(ValueError, match="activation"):
        fl_mod.fused_gcn_dense(cpu[None], cpu[None], cpu, torch.zeros(128),
                               "gelu")
    assert bm_mod.LAUNCHES == 0 and fl_mod.LAUNCHES == 0
