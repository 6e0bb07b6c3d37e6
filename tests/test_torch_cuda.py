"""PyTorch port on the card: each CUDA kernel against its plain version, and
the port's GraphServe on CUDA against the same engine on the CPU.

Every test here carries the `cuda` marker and skips itself where there is
no card; this file imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: fp32 rtol=1e-4, atol=1e-5 — the kernels and cuBLAS (TF32 off)
sum over K in different orders.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.graph import BucketLadder
from repro_torch.core.layers import Techniques
from repro_torch.core.models import GNNConfig
from repro_torch.data.graphs import planetoid_like
from repro_torch.kernels import block_matmul as bm_mod
from repro_torch.kernels import fused_layers as fl_mod
from repro_torch.runtime.gnn_server import GraphServe, GraphServeConfig

CARD = dict(rtol=1e-4, atol=1e-5)
ACTIVATIONS = ("none", "relu", "elu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _arr(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale
                             ).astype(np.float32))


@pytest.mark.cuda
def test_block_matmul_matches_plain(card):
    rng = np.random.default_rng(4)
    cases = [  # X @ W (W broadcast), Â @ H (both batched), a ragged shape
        (_arr(rng, 3, 256, 384, scale=0.05), _arr(rng, 384, 128)),
        (_arr(rng, 3, 256, 256, scale=0.06), _arr(rng, 3, 256, 128)),
        (_arr(rng, 70, 45), _arr(rng, 45, 30))]
    for a, b in cases:
        a, b = a.to(card), b.to(card)
        before = bm_mod.LAUNCHES
        got = bm_mod.block_matmul(a, b)
        torch.cuda.synchronize()
        assert bm_mod.LAUNCHES == before + 1
        torch.testing.assert_close(got, bm_mod.block_matmul_plain(a, b),
                                   **CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_fused_gcn_dense_matches_plain(card, activation):
    rng = np.random.default_rng(5)
    adj = _arr(rng, 2, 384, 384, scale=0.05).abs().to(card)
    x = _arr(rng, 2, 384, 256).to(card)
    w = _arr(rng, 256, 128, scale=0.06).to(card)
    bias = _arr(rng, 128).to(card)
    before = fl_mod.LAUNCHES
    got = fl_mod.fused_gcn_dense(adj, x, w, bias, activation)
    torch.cuda.synchronize()
    assert fl_mod.LAUNCHES == before + 1
    torch.testing.assert_close(
        got, fl_mod.fused_gcn_dense_plain(adj, x, w, bias, activation),
        **CARD)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_operands(card):
    a = torch.zeros(2, 128, 128, device=card)
    with pytest.raises(TypeError):
        bm_mod.block_matmul(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        bm_mod.block_matmul(a.transpose(1, 2), a)
    with pytest.raises(ValueError, match="CUDA"):
        bm_mod.block_matmul(a, torch.zeros(128, 128))
    with pytest.raises(ValueError, match="shapes"):
        fl_mod.fused_gcn_dense(a, a, torch.zeros(64, 128, device=card),
                               torch.zeros(128, device=card))


@pytest.mark.cuda
def test_graphserve_on_card_matches_cpu(card):
    cfg = GNNConfig(kind="gcn", in_feats=48, hidden=16, num_classes=5)
    out = {}
    for dev in (card, torch.device("cpu")):
        eng = GraphServe(GraphServeConfig(ladder=BucketLadder((128, 256)),
                                          batch_slots=2, return_logits=True),
                         seed=3, device=dev)
        eng.register_model("gcn", cfg, fusion="layer")
        eng.register_model("gcn_mm", cfg, techniques=Techniques(
            stagr=True, grad_dynamic=True, graphsplit=True, use_pallas=True))
        eng.warmup()
        launches = (bm_mod.LAUNCHES, fl_mod.LAUNCHES)
        for i, n in enumerate((60, 120, 200, 250)):
            g = planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=48,
                               num_classes=5, seed=i, train_per_class=2)
            eng.submit(g, model="gcn")
            eng.submit(g, model="gcn_mm")
        out[dev.type] = {r.uid: r.logits for r in eng.run()}
        eng.assert_warm()
        ran = (bm_mod.LAUNCHES - launches[0], fl_mod.LAUNCHES - launches[1])
        # 2 buckets x 1 batch per model: 4 block_matmul or 2 fused per batch
        assert ran == ((8, 4) if dev.type == "cuda" else (0, 0))
    for uid, logits in out["cpu"].items():
        torch.testing.assert_close(torch.from_numpy(out["cuda"][uid]),
                                   torch.from_numpy(logits), **CARD)
