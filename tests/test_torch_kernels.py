"""PyTorch port, kernel modules: the plain versions and the `ops` entries of
`repro_torch` against the reference's Pallas kernels (interpret mode, as
conftest sets) and its `ref` twins, and the device routing of the
wrappers. The kernels themselves are checked on a card by
`test_torch_cuda.py`.

Tolerance: fp32 rtol=atol=1e-5 against JAX — XLA's CPU dots and ATen's
CPU GEMM sum in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.block_matmul import block_matmul as jax_block_matmul
from repro.kernels.fused_layers import fused_gcn_dense as jax_fused_gcn_dense
from repro_torch.kernels import block_matmul as bm_mod
from repro_torch.kernels import fused_layers as fl_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)
ACTIVATIONS = ("none", "relu", "elu")


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


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
