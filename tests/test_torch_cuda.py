"""PyTorch port on the card: each CUDA kernel against its plain version, and
the port's GraphServe on CUDA against the same engine on the CPU, on the
fp32 tier, on the QuantGr int8 tier, on the GraSp backend and for the GAT
and SAGE kinds.

Every test here carries the `cuda` marker and skips itself where there is
no card; this file imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: fp32 rtol=1e-4, atol=1e-5 — the kernels and cuBLAS (TF32 off)
sum over K in different orders; `block_matmul` runs 3xTF32 on the tensor
cores and is also held to a float64 product: its largest error, relative
to the largest |C|, at most twice that of `torch.matmul` in fp32. The int8 kernels take exact integer
products and the plain versions' rounding steps, so they are held equal
(`torch.equal`). The GAT kernels' online softmax sums in another order
than the plain two-pass one, and their product runs as 3xTF32 on the
tensor cores: rtol=1e-4, atol=1e-5 as well. A GAT int8
request is compared layer by layer (see `test_gat_graphserve_on_card`).
`sage_max` takes the same maxima as its plain version and is held equal;
`fused_sage` sums in another order than cuBLAS: CARD.
`flash_attention` sums its online softmax in another order than the plain
two-pass softmax, and rounds the unnormalised weights to bf16 where the
plain version rounds the normalised ones: FLASH_TOL per dtype.
Training: a step's gradients on the card against the same step on the
CPU at rtol=1e-4 and atol=1e-5 * max|g| (cuBLAS, and the baselines'
atomic `index_add`, sum in other orders than the CPU); the edge-list GCN
against the dense one at the reference's bar, CARD.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import layers as glayers
from repro_torch.core.graph import BucketLadder
from repro_torch.core.layers import Techniques
from repro_torch.core.masks import (NEG_INF, mean_from_mask,
                                    sage_sample_adjacency)
from repro_torch.core.models import GNNConfig, stack_operands
from repro_torch.core.quant import QuantizedLinear, quantize_rowwise
from repro_torch.core.sparsity import compact_block_sparse
from repro_torch.data.graphs import clustered_like, planetoid_like
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _build
from repro_torch.kernels import bitmap_spmm as bs_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import block_matmul as bm_mod
from repro_torch.kernels import fused_layers as fl_mod
from repro_torch.kernels import gat_attention as ga_mod
from repro_torch.kernels import int8_matmul as im_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import sage_max as sm_mod
from repro_torch.nn import lm as tlm
from repro_torch.runtime import server as tserver
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


def _rel_to_f64(got, a, b):
    """Largest |got - C| relative to the largest |C|, C the float64 product
    of the same fp32 inputs."""
    want = torch.matmul(a.double(), b.double())
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
def test_block_matmul_matches_plain(card):
    rng = np.random.default_rng(4)
    cases = [  # X @ W (W broadcast), Â @ H (both batched), a ragged shape
        (_arr(rng, 3, 256, 384, scale=0.05), _arr(rng, 384, 128)),
        (_arr(rng, 3, 256, 256, scale=0.06), _arr(rng, 3, 256, 128)),
        (_arr(rng, 70, 45), _arr(rng, 45, 30)),
        # ragged M, N and K: K odd, K not a multiple of 4 (4-byte copies)
        (_arr(rng, 2, 129, 37), _arr(rng, 2, 37, 131)),
        (_arr(rng, 200, 1434, scale=0.05), _arr(rng, 1434, 66)),
        (_arr(rng, 2, 300, 1433, scale=0.05), _arr(rng, 1433, 64)),
        # A broadcast over a batched B; K a multiple of 4, N not
        (_arr(rng, 130, 260), _arr(rng, 3, 260, 70)),
        # the GCN aggregation's K: 3072
        (_arr(rng, 2, 256, 3072, scale=0.02), _arr(rng, 2, 3072, 128))]
    for a, b in cases:
        a, b = a.to(card), b.to(card)
        before = bm_mod.LAUNCHES
        got = bm_mod.block_matmul(a, b)
        torch.cuda.synchronize()
        assert bm_mod.LAUNCHES == before + 1
        torch.testing.assert_close(got, bm_mod.block_matmul_plain(a, b),
                                   **CARD)
        # 3xTF32 keeps fp32 accuracy: at most twice cuBLAS's fp32 error
        assert not torch.backends.cuda.matmul.allow_tf32
        err = _rel_to_f64(got, a, b)
        ref = _rel_to_f64(torch.matmul(a, b), a, b)
        assert err <= 2 * ref, (tuple(a.shape), tuple(b.shape), err, ref)


def _layer_err_vs_f64(got, plain, args):
    """(kernel, plain) largest error against the same layer in float64,
    relative to the largest |output|: `plain` applied to `args` as float64
    gives the reference."""
    ref = plain(*(t.double() if isinstance(t, torch.Tensor)
                  and t.is_floating_point() else t for t in args))
    top = ref.abs().max()
    return tuple(((t.double() - ref).abs().max() / top).item()
                 for t in (got, plain(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_fused_gcn_dense_matches_plain(card, activation):
    # both launches on the 3xTF32 tile: 128-multiples; a ragged M, N and
    # K (4-byte copies of every operand); Fin 1433 (4-byte copies of X,
    # 16-byte ones of Â and H); one graph at the serving K of 3072 (Fin
    # 1536 -> 128, 96 blocks a launch). Each also held to at most twice
    # the plain version's (cuBLAS's fp32) error against float64
    rng = np.random.default_rng(5)
    for batch, n, fin, o, a_scale, w_scale in (
            (2, 384, 256, 128, 0.05, 0.06), (2, 131, 37, 70, 0.05, 0.1),
            (1, 300, 1433, 64, 0.02, 0.03), (1, 3072, 1536, 128, 0.02,
                                             0.03)):
        adj = _arr(rng, batch, n, n, scale=a_scale).abs().to(card)
        x = _arr(rng, batch, n, fin).to(card)
        w = _arr(rng, fin, o, scale=w_scale).to(card)
        bias = _arr(rng, o).to(card)
        args = (adj, x, w, bias, activation)
        before = fl_mod.LAUNCHES
        got = fl_mod.fused_gcn_dense(*args)
        torch.cuda.synchronize()
        assert fl_mod.LAUNCHES == before + 1
        torch.testing.assert_close(
            got, fl_mod.fused_gcn_dense_plain(*args), **CARD)
        assert not torch.backends.cuda.matmul.allow_tf32
        err, ref = _layer_err_vs_f64(got, fl_mod.fused_gcn_dense_plain, args)
        assert err <= 2 * ref, ((batch, n, fin, o), err, ref)


def _s8(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


@pytest.mark.cuda
def test_int8_matmul_matches_plain(card):
    rng = np.random.default_rng(6)
    full = torch.full((2, 64, 3072), 127, dtype=torch.int8)
    signs = torch.full((3072, 8), 127, dtype=torch.int8)
    signs[:, 1::2] = -127                    # |acc| = 3072 * 127**2 > 2**24
    cases = [  # Xq @ Wq (Wq broadcast), Âq @ Hq (both batched), a ragged
        # 2-D shape with K not a multiple of 4, extreme accumulators; the
        # tile's edges (64-row blocks, 128 columns, 64-deep slabs, 16-byte
        # copies where K % 16 == 0): N of 7, 64 and 128, M and K that are
        # no multiple of 64 (K = 200 and 3100: no multiple of 16 either),
        # K = 4160 > 3072 within check_accumulator, batches of 1 and of 4
        # at the serving shape (192 blocks: the wave)
        (_s8(rng, 3, 256, 384), _s8(rng, 384, 128), torch.tensor(0.01),
         torch.rand(128)),
        (_s8(rng, 3, 256, 256), _s8(rng, 3, 256, 128), 1.0,
         torch.ones(128)),
        (_s8(rng, 70, 45), _s8(rng, 45, 30), torch.tensor(0.3),
         torch.rand(30)),
        (full, signs, torch.tensor(1e-3), torch.rand(8)),
        (_s8(rng, 4, 200, 200), _s8(rng, 200, 7), torch.tensor(0.02),
         torch.rand(7)),
        (_s8(rng, 2, 130, 3100), _s8(rng, 2, 3100, 64), 1.0,
         torch.rand(64)),
        (_s8(rng, 1, 3072, 4160), _s8(rng, 4160, 128), torch.tensor(1e-3),
         torch.rand(128)),
        (_s8(rng, 4, 3072, 3072), _s8(rng, 4, 3072, 128), 1.0,
         torch.rand(128))]
    for a, b, xs, ws in cases:
        a, b, ws = a.to(card), b.to(card), ws.to(card)
        xs = xs.to(card) if isinstance(xs, torch.Tensor) else xs
        before = im_mod.LAUNCHES
        got = im_mod.int8_matmul(a, b, xs, ws)
        torch.cuda.synchronize()
        assert im_mod.LAUNCHES == before + 1
        assert torch.equal(got, im_mod.int8_matmul_plain(a, b, xs, ws))


def _quant_layer(rng, batch, n, fin, o, device):
    """One QuantGr layer's operands, with scales that clip some values."""
    x = torch.from_numpy(rng.standard_normal((batch, n, fin)
                                             ).astype(np.float32))
    wq = _s8(rng, fin, o)
    w_scale = torch.from_numpy(rng.uniform(2e-3, 6e-3, o).astype(np.float32))
    x_scale = x.abs().max() / 110.0
    sw = (x_scale * w_scale).reshape(1, -1)
    h = im_mod.int8_matmul_plain(im_mod.quantize_s8(x, x_scale), wq,
                                 x_scale, w_scale)
    h_scale = h.abs().max() / 140.0
    adj = torch.from_numpy(np.abs(rng.standard_normal((batch, n, n)) * 0.05
                                  ).astype(np.float32))
    aq, a_scale = quantize_rowwise(adj)
    bias = torch.from_numpy(rng.standard_normal(o).astype(np.float32))
    return [t.to(device) for t in (x, wq, sw, x_scale.reshape(1),
                                   h_scale.reshape(1), aq, a_scale, bias)]


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_fused_gcn_int8_matches_plain(card, activation):
    rng = np.random.default_rng(7)
    # tiled, ragged; then the tile's edges: N of 7 and 64, n (the
    # aggregate's M and K) of 200 (K-major Hq at pitch 208) and 4100 > 3072,
    # fin of 300 (no multiple of 64), batches of 1 and of 4 at the serving
    # shape (192 blocks: the wave)
    for shape in ((2, 384, 256, 128), (1, 200, 37, 10), (4, 200, 300, 7),
                  (1, 4100, 128, 64), (4, 3072, 1536, 128)):
        args = _quant_layer(rng, *shape, card)
        before = fl_mod.INT8_LAUNCHES
        got = fl_mod.fused_gcn_int8(*args, activation)
        torch.cuda.synchronize()
        assert fl_mod.INT8_LAUNCHES == before + 1
        assert torch.equal(got, fl_mod.fused_gcn_int8_plain(*args,
                                                            activation))


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


@pytest.mark.cuda
def test_cacheg_on_card_materializes_and_spills_pinned(card):
    """The CacheG materializer on the card gives the host's operands (the
    host Â within CARD, the masks exactly), and an evicted entry spills
    to pinned host memory, whose fault answers bit for bit."""
    from repro_torch.core.graph import pad_graph
    from repro_torch.core.models import (build_materializer, build_operands,
                                         compact_operands)
    g = planetoid_like(num_nodes=230, num_edges=690, num_feats=48,
                       num_classes=5, seed=4, train_per_class=2)
    pg = pad_graph(g, capacity=256)
    mat = build_materializer(card)
    for kind in ("gcn", "gat", "sage"):
        cfg = GNNConfig(kind=kind, in_feats=48, hidden=16, num_classes=5,
                        heads=4)
        got = mat(compact_operands(pg, cfg))
        want = build_operands(pg, cfg, device="cpu")
        for f in ("norm_adj", "mask_mult", "bias_add", "sample_mask",
                  "mean_mask"):
            w = getattr(want, f)
            if w is None:
                assert getattr(got, f) is None
            elif f == "norm_adj":
                torch.testing.assert_close(getattr(got, f).cpu(), w, **CARD)
            else:
                assert torch.equal(getattr(got, f).cpu(), w), (kind, f)
    cfg = GNNConfig(kind="gcn", in_feats=48, hidden=16, num_classes=5)
    entry = 256 * 256 * 4 + 16
    eng = GraphServe(GraphServeConfig(ladder=BucketLadder((256,)),
                                      batch_slots=2, return_logits=True,
                                      device_cache_budget_bytes=entry),
                     seed=3, device=card)
    eng.register_model("gcn", cfg, fusion="layer")
    eng.warmup()
    first = []
    for i, n in enumerate((200, 240)):
        gid = eng.attach(planetoid_like(num_nodes=n, num_edges=3 * n,
                                        num_feats=48, num_classes=5, seed=i,
                                        train_per_class=2), model="gcn")
        eng.query(gid)
        first.append(eng.run()[-1].logits)
    spilled = eng._cache._spill[("operand", (0, 0))]
    assert spilled.compact.packed.is_pinned()
    assert spilled.compact.degree.is_pinned()
    eng.query(0)
    assert np.array_equal(eng.run()[-1].logits, first[0])
    s = eng.summary()
    assert (s["cache_spill_hits"], s["operand_cache_misses"]) == (1, 2)
    assert s["cache_resident_bytes"] <= entry
    eng.assert_warm()


@pytest.mark.cuda
def test_compact_upload_stages_through_its_own_pinned_copy(card):
    """`pinned_copy` gives a pinned tensor of the same bytes that does not
    alias its source, and `CompactOperands.to` uploads a pageable form
    through it: the card's form equals the host's, which stays pageable
    and unchanged."""
    from repro_torch.core.graph import pad_graph
    from repro_torch.core.models import compact_operands, pinned_copy
    for t in (torch.arange(70_000, dtype=torch.int32).to(torch.uint8),
              torch.linspace(-3, 3, 3072), torch.tensor(17, dtype=torch.int32)):
        p = pinned_copy(t)
        assert p.is_pinned() and not t.is_pinned()
        assert p.dtype == t.dtype and p.shape == t.shape
        assert torch.equal(p, t) and p.data_ptr() != t.data_ptr()
    g = planetoid_like(num_nodes=230, num_edges=690, num_feats=48,
                       num_classes=5, seed=4, train_per_class=2)
    co = compact_operands(pad_graph(g, capacity=256),
                          GNNConfig(kind="gcn", in_feats=48, hidden=16,
                                    num_classes=5))
    before = [t.clone() for t in (co.packed, co.degree, co.num_nodes)]
    on_card = co.to(card)
    for f, w in zip(("packed", "degree", "num_nodes"), before):
        assert getattr(on_card, f).device.type == "cuda"
        assert torch.equal(getattr(on_card, f).cpu(), w), f
        assert not getattr(co, f).is_pinned()
        assert torch.equal(getattr(co, f), w), f


def _delta_case(n, cap, seed, flips=8):
    """A planetoid graph at `cap`, a delta of `flips` adds and as many
    removes, and the patched padded graph and edge keys."""
    from repro_torch.core.graph import (adjacency_keys, apply_edge_delta,
                                        pad_graph, patch_adjacency_keys)
    g = planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=48,
                       num_classes=5, seed=seed, train_per_class=2)
    pg = pad_graph(g, capacity=cap)
    keys = adjacency_keys(g.edge_index, cap)
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(n, 1)
    on = pg.adj[iu, ju] != 0
    add, rm = (np.stack([iu[s], ju[s]], 1) for s in (
        rng.choice(np.flatnonzero(~on), flips, replace=False),
        rng.choice(np.flatnonzero(on), flips, replace=False)))
    delta = apply_edge_delta(pg.adj, pg.norm_adj, n, add, rm)
    pg2 = dataclasses.replace(pg, adj=delta.adj, norm_adj=delta.norm_adj)
    return g, pg, keys, delta, pg2, patch_adjacency_keys(keys, cap, delta)


@pytest.mark.cuda
def test_delta_patch_on_card_equals_materializer(card):
    """At bucket 1024, the card's patched Â and GAT masks equal the card's
    materializer on the patched compact form bit for bit, and the patched
    int8 rows a whole re-quantization; the inputs stay unwritten."""
    from repro_torch.core.graph import keys_neighbours
    from repro_torch.core.models import (DeltaSpec, build_materializer,
                                         compact_operands,
                                         derive_tier_operands, gcn_degree,
                                         patch_operands, patch_tier_operands)
    cap = 1024
    # three pairs each way: touched nodes and their neighbours fit K_r
    _, pg, keys, delta, pg2, keys2 = _delta_case(1000, cap, seed=6, flips=3)
    mat = build_materializer(card)

    def pad(a, k, dtype):
        a = np.concatenate([a, np.full((k - len(a),), a[0])]).astype(dtype)
        return torch.from_numpy(a).to(card)

    for kind in ("gcn", "gat"):
        cfg = GNNConfig(kind=kind, in_feats=48, hidden=16, num_classes=5,
                        heads=4)
        ops = mat(compact_operands(pg, cfg, keys=keys))
        before = {f: getattr(ops, f).clone() for f in ("norm_adj",
                                                       "mask_mult",
                                                       "bias_add")
                  if getattr(ops, f) is not None}
        spec = DeltaSpec(flip_i=pad(delta.flip_i, 128, np.int32),
                         flip_j=pad(delta.flip_j, 128, np.int32),
                         flip_v=pad(delta.flip_v, 128, np.float32),
                         touched=pad(delta.touched, 64, np.int32),
                         degree=torch.from_numpy(gcn_degree(
                             pg2.adj, pg2.num_nodes, keys2)).to(card),
                         fields=tuple(before))
        got = patch_operands(ops, spec)
        # a form already on the card materializes where it is
        want = mat(compact_operands(pg2, cfg, keys=keys2).to(card))
        for f, old in before.items():
            assert torch.equal(getattr(got, f), getattr(want, f)), (kind, f)
            assert torch.equal(getattr(ops, f), old), (kind, f)
        if kind == "gcn":
            rows = np.union1d(delta.touched,
                              keys_neighbours(keys2, cap, delta.touched))
            assert len(rows) <= 128
            tops = derive_tier_operands(ops.norm_adj)
            pt = patch_tier_operands(tops, got.norm_adj,
                                     pad(rows, 128, np.int32))
            full = derive_tier_operands(want.norm_adj)
            assert torch.equal(pt.agg_aq, full.agg_aq)
            assert torch.equal(pt.agg_a_scale, full.agg_a_scale)


@pytest.mark.cuda
def test_update_delta_on_card_equals_fresh_attach(card):
    """GraphServe on the card: after `update_delta`, the GCN (fp32, int8)
    and GAT answers equal a fresh attach of the patched structure bit for
    bit, `assert_warm()` holds, and nothing fell back."""
    from repro_torch.core.graph import edge_index_from_adjacency
    g, pg, _, delta, _, _ = _delta_case(1000, 1024, seed=8)
    eng = GraphServe(GraphServeConfig(ladder=BucketLadder((1024,)),
                                      batch_slots=2, return_logits=True),
                     seed=3, device=card)
    for kind in ("gcn", "gat"):
        eng.register_model(kind, GNNConfig(kind=kind, in_feats=48,
                                           hidden=16, num_classes=5,
                                           heads=4),
                           tiers=("fp32", "int8"), fusion="layer")
    eng.warmup()
    fresh_g = dataclasses.replace(g, edge_index=edge_index_from_adjacency(
        delta.adj, g.num_nodes))
    add = np.stack([delta.flip_i, delta.flip_j], 1)[delta.flip_v > 0]
    rm = np.stack([delta.flip_i, delta.flip_j], 1)[delta.flip_v == 0]
    for kind in ("gcn", "gat"):
        gid = eng.attach(g, model=kind)
        for tier in ("fp32", "int8"):
            eng.query(gid, tier=tier)
        eng.run()
        assert eng.update_delta(gid, add_edges=add, remove_edges=rm)
        fresh = eng.attach(fresh_g, model=kind)
        for tier in ("fp32", "int8"):
            eng.query(gid, tier=tier)
            eng.query(fresh, tier=tier)
            a, b = eng.run()[-2:]
            assert np.array_equal(a.logits, b.logits), (kind, tier)
    s = eng.summary()
    assert (s["delta_updates"], s["delta_fallbacks"]) == (2, 0)
    eng.assert_warm()


def _calibration_to(cal, device):
    return {k: (QuantizedLinear(v.wq.to(device), v.w_scale.to(device),
                                v.x_scale.to(device))
                if isinstance(v, QuantizedLinear) else v.to(device))
            for k, v in cal.items()}


@pytest.mark.cuda
def test_int8_tier_graphserve_on_card_matches_cpu(card):
    cfg = GNNConfig(kind="gcn", in_feats=48, hidden=16, num_classes=5)
    base = dict(stagr=True, grad_dynamic=True, graphsplit=True)
    graphs = [planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=48,
                             num_classes=5, seed=i, train_per_class=2)
              for i, n in enumerate((60, 120, 200, 250))]
    out, cals = {}, {}
    for dev in (torch.device("cpu"), card):
        eng = GraphServe(GraphServeConfig(ladder=BucketLadder((128, 256)),
                                          batch_slots=2, return_logits=True),
                         seed=3, device=dev)
        eng.register_model("gcn_q", cfg, tiers=("fp32", "int8"),
                           default_tier="int8", fusion="layer")
        eng.register_model("gcn_qmm", cfg, tiers={
            "fp32": Techniques(**base, use_pallas=True),
            "int8": Techniques(**base, quantgr=True, use_pallas=True)},
            default_tier="int8")
        eng.warmup()
        for name in ("gcn_q", "gcn_qmm"):
            if dev.type == "cpu":
                eng.calibrate(name, graphs[3])
                cals[name] = eng.models[name].calibrations["int8"]
            else:                      # the same scales on both devices
                eng.models[name].calibrations["int8"] = _calibration_to(
                    cals[name], dev)
        launches = (im_mod.LAUNCHES, fl_mod.INT8_LAUNCHES)
        for g in graphs:
            eng.submit(g, model="gcn_q")
            eng.submit(g, model="gcn_qmm")
        done = eng.run()
        out[dev.type] = {r.uid: (r.preds, r.logits) for r in done}
        assert {r.tier for r in done} == {"int8"}
        eng.assert_warm()
        assert eng.summary()["tier_fallbacks"] == 0
        ran = (im_mod.LAUNCHES - launches[0],
               fl_mod.INT8_LAUNCHES - launches[1])
        # 2 buckets x 1 batch per model: 4 int8_matmul or 2 fused per batch
        assert ran == ((8, 4) if dev.type == "cuda" else (0, 0))
    for uid, (preds, logits) in out["cpu"].items():
        np.testing.assert_array_equal(out["cuda"][uid][0], preds)
        torch.testing.assert_close(torch.from_numpy(out["cuda"][uid][1]),
                                   torch.from_numpy(logits), **CARD)


def _grasp_structure(rng, batch, rb, max_nnz, device, nan_tail=False):
    """A random compacted Â of `rb` block rows at budget `max_nnz`: counts
    from 0 to the budget, distinct random columns, zero tail blocks (or
    NaN ones)."""
    counts = rng.integers(0, max_nnz + 1, (batch, rb))
    counts[0, 0] = max_nnz
    cols = np.stack([[rng.permutation(rb)[:max_nnz] for _ in range(rb)]
                     for _ in range(batch)]).astype(np.int32)
    blocks = np.abs(rng.standard_normal((batch, rb, max_nnz, 128, 128))
                    * 0.02).astype(np.float32)
    tail = np.arange(max_nnz)[None, None, :] >= counts[:, :, None]
    blocks[tail] = np.nan if nan_tail else 0.0
    return [torch.from_numpy(a).to(device) for a in (
        blocks.reshape(batch, rb * max_nnz, 128, 128), cols,
        counts.astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("max_nnz", [2, 6])
def test_bitmap_spmm_matches_plain_and_skips_the_tail(card, max_nnz):
    rng = np.random.default_rng(8 + max_nnz)
    for f in (128, 64):
        zero = _grasp_structure(np.random.default_rng(max_nnz), 2, 8,
                                max_nnz, card)
        nan = _grasp_structure(np.random.default_rng(max_nnz), 2, 8,
                               max_nnz, card, nan_tail=True)
        h = _arr(rng, 2, 8 * 128, f).to(card)
        want = bs_mod.bitmap_spmm_plain(*zero, h)
        for blocks, cols, counts in (zero, nan):
            before = bs_mod.LAUNCHES
            got = bs_mod.bitmap_spmm(blocks, cols, counts, h)
            torch.cuda.synchronize()
            assert bs_mod.LAUNCHES == before + 1
            torch.testing.assert_close(got, want, **CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_fused_gcn_grasp_matches_plain_and_skips_the_tail(card, activation):
    rng = np.random.default_rng(9)
    for max_nnz in (2, 6):
        zero = _grasp_structure(np.random.default_rng(max_nnz), 2, 8,
                                max_nnz, card)
        nan = _grasp_structure(np.random.default_rng(max_nnz), 2, 8,
                               max_nnz, card, nan_tail=True)
        x = _arr(rng, 2, 8 * 128, 256).to(card)
        w = _arr(rng, 256, 128, scale=0.06).to(card)
        bias = _arr(rng, 128).to(card)
        want = fl_mod.fused_gcn_grasp_plain(*zero, x, w, bias, activation)
        for structure in (zero, nan):
            before = fl_mod.GRASP_LAUNCHES
            got = fl_mod.fused_gcn_grasp(*structure, x, w, bias, activation)
            torch.cuda.synchronize()
            assert fl_mod.GRASP_LAUNCHES == before + 1
            torch.testing.assert_close(got, want, **CARD)
            # the 3xTF32 combine keeps fp32 accuracy: at most twice the
            # plain version's (cuBLAS's fp32) error against float64
            assert not torch.backends.cuda.matmul.allow_tf32
            err, ref = _layer_err_vs_f64(
                got, fl_mod.fused_gcn_grasp_plain,
                (*zero, x, w, bias, activation))
            assert err <= 2 * ref, (max_nnz, err, ref)


@pytest.mark.cuda
def test_grasp_kernels_with_every_count_zero(card):
    """Every count 0: no block is read (all NaN), so bitmap_spmm writes
    zeros and fused_gcn_grasp act(bias) in every row."""
    rng = np.random.default_rng(12)
    blocks, cols, counts = _grasp_structure(rng, 2, 8, 3, card)
    blocks = torch.full_like(blocks, float("nan"))
    counts = torch.zeros_like(counts)
    h = _arr(rng, 2, 8 * 128, 128).to(card)
    out = bs_mod.bitmap_spmm(blocks, cols, counts, h)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))
    x = _arr(rng, 2, 8 * 128, 256).to(card)
    w = _arr(rng, 256, 128, scale=0.06).to(card)
    bias = _arr(rng, 128).to(card)
    for activation in ACTIVATIONS:
        got = fl_mod.fused_gcn_grasp(blocks, cols, counts, x, w, bias,
                                     activation)
        want = fl_mod._act(bias.expand(2, 8 * 128, 128), activation)
        torch.testing.assert_close(got, want, **CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("max_nnz", [2, 6])
def test_grasp_kernels_take_a_width_not_a_multiple_of_4(card, max_nnz):
    """F of 7 and 130 (H by 4-byte copies, ragged column tiles), with NaN
    tail blocks: each kernel at the card bar of its plain version."""
    rng = np.random.default_rng(20 + max_nnz)
    zero = _grasp_structure(np.random.default_rng(max_nnz), 2, 8, max_nnz,
                            card)
    nan = _grasp_structure(np.random.default_rng(max_nnz), 2, 8, max_nnz,
                           card, nan_tail=True)
    for f in (7, 130):
        h = _arr(rng, 2, 8 * 128, f).to(card)
        got = bs_mod.bitmap_spmm(*nan, h)
        torch.testing.assert_close(got, bs_mod.bitmap_spmm_plain(*zero, h),
                                   **CARD)
        x = _arr(rng, 2, 8 * 128, 40).to(card)
        w = _arr(rng, 40, f, scale=0.15).to(card)
        bias = _arr(rng, f).to(card)
        got = fl_mod.fused_gcn_grasp(*nan, x, w, bias, "relu")
        torch.testing.assert_close(
            got, fl_mod.fused_gcn_grasp_plain(*zero, x, w, bias, "relu"),
            **CARD)


@pytest.mark.cuda
def test_grasp_wrappers_reject_unaligned_blocks(card):
    blocks, cols, counts = _grasp_structure(np.random.default_rng(0), 1, 4,
                                            2, card)
    shifted = torch.empty(blocks.numel() + 1, device=card)[1:].view(
        blocks.shape)
    shifted.copy_(blocks)
    h = torch.zeros(1, 512, 128, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        bs_mod.bitmap_spmm(shifted, cols, counts, h)
    with pytest.raises(ValueError, match="16-byte"):
        fl_mod.fused_gcn_grasp(shifted, cols, counts,
                               torch.zeros(1, 512, 128, device=card),
                               torch.zeros(128, 128, device=card),
                               torch.zeros(128, device=card))


@pytest.mark.cuda
def test_grasp_wrappers_reject_bad_operands(card):
    blocks, cols, counts = _grasp_structure(np.random.default_rng(0), 1, 4,
                                            2, card)
    h = torch.zeros(1, 512, 128, device=card)
    with pytest.raises(ValueError, match="CUDA"):
        bs_mod.bitmap_spmm(blocks, cols.cpu(), counts, h)
    with pytest.raises(TypeError, match="int32"):
        bs_mod.bitmap_spmm(blocks, cols.long(), counts, h)
    with pytest.raises(ValueError, match="contiguous"):
        bs_mod.bitmap_spmm(blocks.transpose(2, 3), cols, counts, h)
    with pytest.raises(ValueError, match="shapes do not agree"):
        fl_mod.fused_gcn_grasp(blocks, cols, counts,
                               torch.zeros(1, 256, 128, device=card),
                               torch.zeros(128, 128, device=card),
                               torch.zeros(128, device=card))
    # the device rule: a compacted structure from the card runs the kernel
    sp, _ = compact_block_sparse(torch.eye(512, device=card), max_nnz=2)
    before = bs_mod.LAUNCHES
    out = bs_mod.bitmap_spmm(sp.blocks[None], sp.block_cols[None],
                             sp.counts[None], h + 1.0)
    torch.cuda.synchronize()
    assert bs_mod.LAUNCHES == before + 1 and torch.equal(out, h + 1.0)


@pytest.mark.cuda
def test_grasp_graphserve_on_card_matches_cpu(card):
    cfg = GNNConfig(kind="gcn", in_feats=48, hidden=16, num_classes=5)
    graphs = [clustered_like(num_nodes=n, num_feats=48, num_classes=5,
                             within_density=0.05, seed=n)
              for n in (300, 700, 1000)]
    graphs.append(planetoid_like(num_nodes=900, num_edges=36000,
                                 num_feats=48, num_classes=5, seed=4,
                                 train_per_class=2))
    out = {}
    for dev in (card, torch.device("cpu")):
        eng = GraphServe(GraphServeConfig(ladder=BucketLadder((1024,)),
                                          batch_slots=2, return_logits=True),
                         seed=3, device=dev)
        eng.register_model("sp", cfg, agg_backend="grasp", fusion="layer")
        eng.register_model("sp_auto", cfg, agg_backend="auto")
        eng.warmup()
        launches = (bs_mod.LAUNCHES, fl_mod.GRASP_LAUNCHES)
        for g in graphs:
            eng.submit(g, model="sp")
            eng.submit(g, model="sp_auto")
        gid = eng.attach(graphs[1], model="sp")
        eng.query(gid)
        done = eng.run()
        out[dev.type] = {r.uid: (r.backend, r.logits) for r in done}
        eng.assert_warm()
        s = eng.summary()
        ran = (bs_mod.LAUNCHES - launches[0],
               fl_mod.GRASP_LAUNCHES - launches[1])
        # 4 grasp requests of "sp" (2 batches, 2 fused layers each), 3 of
        # "sp_auto" (2 batches, 2 layers each)
        assert ran == ((4, 4) if dev.type == "cuda" else (0, 0))
        assert s["grasp_batches"] == 4
        assert s["backend_fallbacks"] == (1 if dev.type == "cuda" else 8)
    for uid, (backend, logits) in out["cpu"].items():
        assert out["cuda"][uid][0] == backend
        torch.testing.assert_close(torch.from_numpy(out["cuda"][uid][1]),
                                   torch.from_numpy(logits), **CARD)


# The GAT kernels' cases: head widths on both sides of the 16-byte copy
# rule (f % 4) and of one, two, four and eight n8 fragments; head counts of
# one block, of a split block group (9 = 8 + 1) and with column splits (1,
# 2 heads); n below one tile, ragged (130: 4-byte bias copies; 200, 1000:
# a ragged last tile) and the serving bucket (3072).
GAT_FS = (1, 7, 8, 12, 20, 64)
GAT_HEADS = (1, 2, 8, 9)
GAT_NS = (16, 130, 200, 1000, 3072)


def _n_real(n):
    """Rows past n_real are NodePad's all -1e9 rows."""
    return n - 40 if n > 80 else n - 4


def _gat_bias(rng, batch, n, n_real, device):
    """GrAx1 masks with NodePad's all -1e9 rows past n_real, and rows
    64..95 whose first 64 columns are all -1e9 (the online softmax's
    first steps)."""
    adj = rng.random((batch, n, n)) < 0.05
    adj[:, n_real:] = False
    adj[:, :, n_real:] = False
    idx = np.arange(n_real)
    adj[:, idx, idx] = True
    adj[:, 64:96, :64] = False
    return torch.from_numpy(np.where(adj, 0.0, NEG_INF).astype(np.float32)
                            ).to(device)


def _gat_operands(seed, batch, n, heads, f, device, n_real=None):
    rng = np.random.default_rng(seed)
    bias = _gat_bias(rng, batch, n, n_real or _n_real(n), device)
    return (_arr(rng, batch, n, heads, f).to(device),
            _arr(rng, batch, n, heads).to(device),
            _arr(rng, batch, n, heads).to(device), bias)


@pytest.mark.cuda
@pytest.mark.parametrize("n", GAT_NS)
@pytest.mark.parametrize("heads", GAT_HEADS)
@pytest.mark.parametrize("f", GAT_FS)
def test_gat_attention_matches_plain(card, f, heads, n):
    h, ad, as_, bias = _gat_operands(heads + f + n, 2, n, heads, f, card)
    before = ga_mod.LAUNCHES
    got = ga_mod.gat_attention(h, ad, as_, bias)
    torch.cuda.synchronize()
    assert ga_mod.LAUNCHES == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ga_mod.gat_attention_plain(h, ad, as_,
                                                               bias), **CARD)
    # a padded row averages h uniformly, as the reference does
    torch.testing.assert_close(got[0, -1], h[0].mean(dim=0), **CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("n", GAT_NS)
@pytest.mark.parametrize("heads", GAT_HEADS)
@pytest.mark.parametrize("f", GAT_FS)
def test_fused_gat_precombined_matches_plain(card, f, heads, n):
    activation = ACTIVATIONS[(f + heads + n) % 3]
    h, ad, as_, bias = _gat_operands(heads * f + n, 2, n, heads, f, card)
    b = _arr(np.random.default_rng(f), heads, f, scale=0.1).to(card)
    before = fl_mod.GAT_PRE_LAUNCHES
    got = fl_mod.fused_gat_precombined(h, ad, as_, bias, b, activation)
    torch.cuda.synchronize()
    assert fl_mod.GAT_PRE_LAUNCHES == before + 1
    torch.testing.assert_close(got, fl_mod.fused_gat_precombined_plain(
        h, ad, as_, bias, b, activation), **CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("n", GAT_NS)
@pytest.mark.parametrize("heads", GAT_HEADS)
@pytest.mark.parametrize("f", GAT_FS)
def test_fused_gat_full_matches_plain(card, f, heads, n):
    # fin 40 or 300 (16-byte copies of X) and 37 or 301 (4-byte): 300 and
    # 301 cross the tile's 128-deep partial-sum flush and wrap its
    # 3-stage ring three times; f = 7 copies W 4 bytes at a time (its
    # blocks start at 63-column offsets); 9 heads: attention head groups
    # of 8 and 1, combine tiles of whole heads (5 and 4 at f = 12). W is
    # scaled by 1 / sqrt(fin), as glorot scales it, so that H has one
    # spread at every fin (fin 40's); at larger scores no two fp32 orders
    # meet the bar (test_fused_gat_full_near_float64_at_large_scores)
    rng = np.random.default_rng(12 + f + heads + n)
    activation = ACTIVATIONS[(f + heads + n) % 3]
    fin = (40, 37, 300, 301)[(f + heads + n // 2) % 4]
    x = _arr(rng, 2, n, fin).to(card)
    w = _arr(rng, fin, heads, f, scale=0.1 * (40 / fin) ** 0.5).to(card)
    a_src, a_dst = (_arr(rng, heads, f).to(card) for _ in range(2))
    b = _arr(rng, heads, f, scale=0.1).to(card)
    bias = _gat_bias(rng, 2, n, _n_real(n), card)
    before = fl_mod.GAT_FULL_LAUNCHES
    got = fl_mod.fused_gat_full(x, w, a_src, a_dst, bias, b, activation)
    torch.cuda.synchronize()
    assert fl_mod.GAT_FULL_LAUNCHES == before + 1
    torch.testing.assert_close(got, fl_mod.fused_gat_full_plain(
        x, w, a_src, a_dst, bias, b, activation), **CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("f, heads, n, fin, activation",
                         [(64, 2, 1000, 300, "relu"),
                          (7, 8, 3072, 301, "none")])
def test_fused_gat_full_near_float64_at_large_scores(card, f, heads, n, fin,
                                                     activation):
    # W of scale 0.1 at fin 300: H reaches about 8 and the scores about 50,
    # where the softmax turns fp32 rounding of H and of the scores into
    # output differences above the card bar between any two fp32 orders
    # (the plain version's cuBLAS product included). So the kernel is held
    # to at most twice the plain version's error against float64, on the
    # real rows (a padded row's -1e9 + alpha rounds to -1e9 in fp32 only).
    rng = np.random.default_rng(14 + f + n)
    x = _arr(rng, 2, n, fin).to(card)
    w = _arr(rng, fin, heads, f, scale=0.1).to(card)
    a_src, a_dst = (_arr(rng, heads, f).to(card) for _ in range(2))
    b = _arr(rng, heads, f, scale=0.1).to(card)
    n_real = _n_real(n)
    bias = _gat_bias(rng, 2, n, n_real, card)
    args = (x, w, a_src, a_dst, bias, b)
    got = fl_mod.fused_gat_full(*args, activation)
    plain = fl_mod.fused_gat_full_plain(*args, activation)
    ref = fl_mod.fused_gat_full_plain(*(t.double() for t in args),
                                      activation)
    err_k = float((got.double() - ref)[:, :n_real].abs().max())
    err_p = float((plain.double() - ref)[:, :n_real].abs().max())
    assert err_k <= 2 * err_p, (err_k, err_p)


def _gat_large_scores(rng, n, heads, f, fin, device):
    """h = X @ W with W of scale 0.1 at fin 300, and its alpha terms: h
    reaches about 8 and the scores about 50, as in
    test_fused_gat_full_near_float64_at_large_scores."""
    x = _arr(rng, 2, n, fin).to(device)
    w = _arr(rng, fin, heads, f, scale=0.1).to(device)
    a_src, a_dst = (_arr(rng, heads, f).to(device) for _ in range(2))
    h = torch.einsum("bnk,khf->bnhf", x, w).contiguous()
    return h, (h * a_dst).sum(-1), (h * a_src).sum(-1)


def _err_vs_float64(got, plain, ref, n_real):
    return (float((got.double() - ref)[:, :n_real].abs().max()),
            float((plain.double() - ref)[:, :n_real].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("f, heads, n", [(64, 2, 1000), (7, 8, 3072)])
def test_gat_attention_near_float64_at_large_scores(card, f, heads, n):
    # the attention body of fused_gat_full at scores near 50: the kernel is
    # held to at most twice the plain version's error against float64 on
    # the real rows
    rng = np.random.default_rng(15 + f + n)
    h, ad, as_ = _gat_large_scores(rng, n, heads, f, 300, card)
    n_real = _n_real(n)
    bias = _gat_bias(rng, 2, n, n_real, card)
    args = (h, ad, as_, bias)
    err_k, err_p = _err_vs_float64(
        ga_mod.gat_attention(*args), ga_mod.gat_attention_plain(*args),
        ga_mod.gat_attention_plain(*(t.double() for t in args)), n_real)
    assert err_k <= 2 * err_p, (err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("f, heads, n, activation",
                         [(64, 2, 1000, "relu"), (7, 8, 3072, "none")])
def test_fused_gat_precombined_near_float64_at_large_scores(card, f, heads,
                                                            n, activation):
    rng = np.random.default_rng(16 + f + n)
    h, ad, as_ = _gat_large_scores(rng, n, heads, f, 301, card)
    b = _arr(rng, heads, f, scale=0.1).to(card)
    n_real = _n_real(n)
    bias = _gat_bias(rng, 2, n, n_real, card)
    args = (h, ad, as_, bias, b)
    err_k, err_p = _err_vs_float64(
        fl_mod.fused_gat_precombined(*args, activation),
        fl_mod.fused_gat_precombined_plain(*args, activation),
        fl_mod.fused_gat_precombined_plain(*(t.double() for t in args),
                                           activation), n_real)
    assert err_k <= 2 * err_p, (err_k, err_p)


@pytest.mark.cuda
def test_ops_fused_gat_layer_pads_ragged_graphs_on_card(card):
    rng = np.random.default_rng(13)
    n, fin, heads, f = 200, 48, 8, 8
    x = _arr(rng, 2, n, fin).to(card)
    w = _arr(rng, fin, heads, f, scale=0.1).to(card)
    a_src, a_dst = (_arr(rng, heads, f).to(card) for _ in range(2))
    b = _arr(rng, heads, f, scale=0.1).to(card)
    bias = _gat_bias(rng, 2, n, n, card)         # every row real
    pre = (_arr(rng, 2, n, heads, f).to(card), _arr(rng, 2, n, heads).to(card),
           _arr(rng, 2, n, heads).to(card))
    before = (fl_mod.GAT_FULL_LAUNCHES, fl_mod.GAT_PRE_LAUNCHES)
    got = kops.fused_gat_layer(x, w, a_src, a_dst, bias, b, activation="elu")
    got_pre = kops.fused_gat_layer(None, None, a_src, a_dst, bias, b,
                                   activation="elu", precombined=pre)
    torch.cuda.synchronize()
    assert (fl_mod.GAT_FULL_LAUNCHES, fl_mod.GAT_PRE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, fl_mod.fused_gat_full_plain(
        x, w, a_src, a_dst, bias, b, "elu"), **CARD)
    torch.testing.assert_close(got_pre, fl_mod.fused_gat_precombined_plain(
        *pre, bias, b, "elu"), **CARD)


@pytest.mark.cuda
def test_gat_wrappers_reject_bad_operands(card):
    h, ad, as_, bias = _gat_operands(0, 1, 128, 2, 8, card)
    with pytest.raises(ValueError, match="head width"):
        ga_mod.gat_attention(torch.zeros(1, 128, 1, 65, device=card),
                             ad[..., :1].contiguous(),
                             as_[..., :1].contiguous(), bias)
    with pytest.raises(TypeError):
        ga_mod.gat_attention(h.double(), ad, as_, bias)
    with pytest.raises(ValueError, match="contiguous"):
        ga_mod.gat_attention(h, ad, as_, bias.transpose(1, 2))
    with pytest.raises(ValueError, match="shapes do not agree"):
        ga_mod.gat_attention(h, ad, as_, bias[:, :64, :64].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        ga_mod.gat_attention(h, ad.cpu(), as_, bias)
    with pytest.raises(ValueError, match="b must be"):
        fl_mod.fused_gat_precombined(h, ad, as_, bias,
                                     torch.zeros(2, 7, device=card))
    with pytest.raises(ValueError, match="shapes do not agree"):
        fl_mod.fused_gat_full(torch.zeros(1, 128, 16, device=card),
                              torch.zeros(15, 2, 8, device=card),
                              torch.zeros(2, 8, device=card),
                              torch.zeros(2, 8, device=card), bias,
                              torch.zeros(2, 8, device=card))


@pytest.mark.cuda
def test_gat_graphserve_on_card_matches_cpu(card):
    """GAT fp32 and int8 on the card against the CPU engine, the same
    calibration on both. fp32 logits are held end to end. An int8
    request's layer 2 rounds layer 1's output, where the card's online
    softmax and the CPU's two-pass one may straddle a rounding tie, so it
    is held layer by layer: layer 1 at CARD, and layer 2 on the CPU's
    layer-1 output against the CPU logits."""
    cfg = GNNConfig(kind="gat", in_feats=48, hidden=16, num_classes=5,
                    heads=2)
    base = dict(stagr=True, graphsplit=True, effop=True)
    graphs = [planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=48,
                             num_classes=5, seed=i, train_per_class=2)
              for i, n in enumerate((60, 120, 200, 250))]
    out, engines = {}, {}
    for side, dev in (("cpu", torch.device("cpu")), ("cuda", card)):
        eng = GraphServe(GraphServeConfig(ladder=BucketLadder((128, 256)),
                                          batch_slots=2, return_logits=True),
                         seed=3, device=dev)
        eng.register_model("gat", cfg, tiers=("fp32", "int8"),
                           fusion="layer")
        eng.register_model("gat_mm", cfg, tiers={
            "fp32": Techniques(**base, use_pallas=True),
            "int8": Techniques(**base, quantgr=True, use_pallas=True)})
        eng.warmup()
        for name in ("gat", "gat_mm"):
            if side == "cpu":
                eng.calibrate(name, graphs[3])
            else:                      # the same scales on both devices
                eng.models[name].calibrations["int8"] = _calibration_to(
                    engines["cpu"].models[name].calibrations["int8"], dev)
        launches = (ga_mod.LAUNCHES, fl_mod.GAT_FULL_LAUNCHES,
                    fl_mod.GAT_PRE_LAUNCHES, im_mod.LAUNCHES)
        for g in graphs:
            for tier in ("fp32", "int8"):
                eng.submit(g, model="gat", tier=tier)
                eng.submit(g, model="gat_mm", tier=tier)
        done = eng.run()
        out[side] = {r.uid: r for r in done}
        engines[side] = eng
        eng.assert_warm()
        assert eng.summary()["tier_fallbacks"] == 0
        ran = (ga_mod.LAUNCHES - launches[0],
               fl_mod.GAT_FULL_LAUNCHES - launches[1],
               fl_mod.GAT_PRE_LAUNCHES - launches[2],
               im_mod.LAUNCHES - launches[3])
        # per (model, tier): 2 buckets x 1 batch, 2 layers each
        assert ran == ((8, 4, 4, 4) if side == "cuda" else (0, 0, 0, 0))
    for uid, r_cpu in out["cpu"].items():
        r_gpu = out["cuda"][uid]
        e_gpu, e_cpu = (engines[k].models[r_cpu.model]
                        for k in ("cuda", "cpu"))
        t = e_cpu.tiers[r_cpu.tier]
        if not t.quantgr:
            torch.testing.assert_close(torch.from_numpy(r_gpu.logits),
                                       torch.from_numpy(r_cpu.logits),
                                       **CARD)
            continue
        n = r_cpu.pg.num_nodes
        layer = {}
        for k, e, r in (("cuda", e_gpu, r_gpu), ("cpu", e_cpu, r_cpu)):
            x = torch.from_numpy(r.pg.features).to(engines[k].device)[None]
            ops = stack_operands([r.ops])
            kw = dict(heads=2, out_feats=8,
                      quant=e.calibrations["int8"]["l1"])
            if r.fusion == "layer":
                h1 = glayers.gat_grannite_fused(
                    e.params["l1"], x, ops.bias_add, t, activation="elu",
                    **kw)
            else:
                h1 = torch.nn.functional.elu(glayers.gat_grannite(
                    e.params["l1"], x, ops.mask_mult, ops.bias_add, t, **kw))
            layer[k] = (h1, ops)
        torch.testing.assert_close(layer["cuda"][0][0, :n].cpu(),
                                   layer["cpu"][0][0, :n], **CARD)
        h1_cpu = layer["cpu"][0].to(card)
        ops = layer["cuda"][1]
        kw = dict(heads=1, out_feats=5, quant=e_gpu.calibrations["int8"]["l2"])
        if r_gpu.fusion == "layer":
            z = glayers.gat_grannite_fused(e_gpu.params["l2"], h1_cpu,
                                           ops.bias_add, t, **kw)
        else:
            z = glayers.gat_grannite(e_gpu.params["l2"], h1_cpu,
                                     ops.mask_mult, ops.bias_add, t, **kw)
        torch.testing.assert_close(z[0, :n].cpu(),
                                   torch.from_numpy(r_cpu.logits), **CARD)


def _sage_masks(rng, batch, n, n_real, device, dense_row=None):
    """Sampled 0/1 masks (NodePad's rows and columns empty, optionally one
    row whose every column is set) and their mean masks, on `device`."""
    sample = []
    for _ in range(batch):
        adj = (rng.random((n, n)) < 0.05).astype(np.float32)
        adj[n_real:] = 0.0
        adj[:, n_real:] = 0.0
        m = sage_sample_adjacency(adj, n_real, max_neighbors=10)
        if dense_row is not None:
            m[dense_row] = 1.0
        sample.append(m)
    sample = np.stack(sample)
    mean = np.stack([mean_from_mask(m) for m in sample])
    return (torch.from_numpy(sample).to(device),
            torch.from_numpy(mean).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(384, 1433), (256, 64), (200, 7)])
def test_sage_max_matches_plain(card, n, f):
    rng = np.random.default_rng(n + f)
    sample, _ = _sage_masks(rng, 2, n, n - 40, card, dense_row=5)
    for h in (_arr(rng, 2, n, f).abs().to(card),     # the serving domain
              _arr(rng, 2, n, f).to(card)):          # any sign: equal too
        before = sm_mod.LAUNCHES
        got = sm_mod.sage_max(sample, h)
        torch.cuda.synchronize()
        assert sm_mod.LAUNCHES == before + 1
        assert torch.equal(got, sm_mod.sage_max_plain(sample, h))
    # NaN only in rows of h that no mask row selects (NodePad's, the dense
    # row left out): the kernel never reads them, the plain version
    # multiplies them by 0 and turns every output NaN
    sample, _ = _sage_masks(rng, 2, n, n - 40, card)
    h = _arr(rng, 2, n, f).abs().to(card)
    h_nan = h.clone()
    h_nan[:, n - 40:] = float("nan")
    assert torch.equal(sm_mod.sage_max(sample, h_nan),
                       sm_mod.sage_max_plain(sample, h))
    assert torch.isnan(sm_mod.sage_max_plain(sample, h_nan)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,f", [(128, 384, 1433), (96, 256, 64),
                                   (200, 512, 7), (3072, 6144, 64)])
def test_sage_max_rectangular_matches_plain(card, m, n, f):
    """A shard's (M, N) row block of a sampled mask against the whole
    graph's (N, F) features (the sharded SAGE-max path): equal to the
    plain version, as the square case is."""
    rng = np.random.default_rng(m + n + f)
    sample, _ = _sage_masks(rng, 2, n, n - 40, card, dense_row=5)
    rows = sample[:, n - m - 20:n - 20].contiguous()   # padding rows too
    h = _arr(rng, 2, n, f).abs().to(card)
    before = sm_mod.LAUNCHES
    got = sm_mod.sage_max(rows, h)
    torch.cuda.synchronize()
    assert sm_mod.LAUNCHES == before + 1
    assert got.shape == (2, m, f)
    assert torch.equal(got, sm_mod.sage_max_plain(rows, h))
    assert torch.equal(kops.sage_max(rows[0], h[0]), got[0])


def _sharded_plan_pair(card, case):
    """One 2-shard graph's stacked slices on the card and a model's
    params, for a `use_pallas` plan and its plain twin."""
    from repro_torch.core import models as gmodels
    from repro_torch.core.partition import partition_graph
    kind, agg = case
    cfg = GNNConfig(kind=kind, in_feats=300, hidden=64, num_classes=7,
                    aggregator=agg or "mean")
    g = clustered_like(num_nodes=900, num_feats=300, num_classes=7,
                       cross_frac=0.1, seed=3)
    part = partition_graph(g.edge_index, 900, 2, shard_cap=512)
    x, ops, mask = gmodels.stack_shard_slices(
        gmodels.build_sharded_operands(g, part, cfg, device=card))
    params = gmodels.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=card)
    return gmodels, cfg, part, params, x, ops, mask


@pytest.mark.cuda
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("case", [("gcn", None), ("sage", "max")])
def test_sharded_plan_kernels_match_plain_on_card(card, case, compress):
    """A sharded GCN and SAGE-max plan with `use_pallas` (block_matmul on
    the rectangular row blocks, sage_max rectangular) against the same
    plan's plain products on the card."""
    gmodels, cfg, part, params, x, ops, mask = _sharded_plan_pair(card,
                                                                   case)
    t = (Techniques(stagr=True, graphsplit=True) if cfg.kind == "gcn"
         else Techniques.full_sage())
    launches = (bm_mod.LAUNCHES, sm_mod.LAUNCHES)
    outs = []
    for uk in (True, False):
        plan = gmodels.build_sharded_plan(
            cfg, part.shard_cap, part.shards,
            dataclasses.replace(t, use_pallas=uk), compress=compress,
            device=card)
        outs.append(plan(params, x, ops, None, node_mask=mask))
    torch.cuda.synchronize()
    assert bm_mod.LAUNCHES > launches[0]
    assert (sm_mod.LAUNCHES > launches[1]) == (cfg.aggregator == "max"
                                               and cfg.kind == "sage")
    # the compressed wire may round a value at a tie to the next step
    tol = CARD if not compress else dict(rtol=0, atol=0.05)
    torch.testing.assert_close(outs[0], outs[1], **tol)
    assert (outs[0].argmax(-1) == outs[1].argmax(-1)).float().mean() > 0.99


@pytest.mark.cuda
def test_sharded_replica_rows_equal_single_dispatch_on_card(card):
    """replicas=2 with `use_pallas`: each replica row equals its
    single-replica call bit for bit on the card."""
    gmodels, cfg, part, params, x, ops, mask = _sharded_plan_pair(
        card, ("sage", "max"))
    t = dataclasses.replace(Techniques.full_sage(), use_pallas=True)
    one = gmodels.build_sharded_plan(cfg, part.shard_cap, part.shards, t,
                                     device=card)
    two = gmodels.build_sharded_plan(cfg, part.shard_cap, part.shards, t,
                                     replicas=2, device=card)
    x2 = torch.stack([x, x.flip(1)])
    m2 = torch.stack([mask, mask.flip(1)])
    ops2 = gmodels.stack_operands([ops, dataclasses.replace(
        ops, sample_mask=ops.sample_mask.flip(1))])
    both = two(params, x2, ops2, None, node_mask=m2)
    assert torch.equal(both[0], one(params, x, ops, None, node_mask=mask))
    assert torch.equal(both[1], one(params, x2[1], gmodels.GranniteOperands(
        sample_mask=ops2.sample_mask[1], mean_mask=ops2.mean_mask[1]), None,
        node_mask=m2[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_fused_sage_matches_plain(card, aggregator, activation):
    # the combine's edges on the 3xTF32 tile: the serving shape (X at Fin
    # 1433 by 4-byte copies, AGG at a 1436 pitch by 16-byte ones, O 64 in
    # one block), Fin 301 (not a multiple of 4, across the 128-deep
    # flush), O 7, 16 and 64, batches of 1, 2 and 4. Past fin 300 the
    # weights shrink as glorot scales them, so the outputs keep fin 300's
    # spread; at scale 0.1 the fp32 rounding of any two summation orders
    # over 1433 terms nears the bar's atol (the float64 test below keeps
    # scale 0.1)
    rng = np.random.default_rng(len(aggregator) + len(activation))
    for batch, n, fin, o in ((2, 384, 300, 64), (2, 256, 64, 7),
                             (2, 200, 40, 16), (4, 3072, 1433, 64),
                             (1, 384, 301, 7), (2, 200, 301, 64)):
        sample, mean = _sage_masks(rng, batch, n, n - 30, card, dense_row=2)
        mask = mean if aggregator == "mean" else sample
        x = _arr(rng, batch, n, fin).to(card)
        xk = (x if aggregator == "mean"
              else _arr(rng, batch, n, fin).abs().to(card))
        scale = 0.1 * min(1.0, (300 / fin) ** 0.5)
        ws = _arr(rng, fin, o, scale=scale).to(card)
        wn = _arr(rng, fin, o, scale=scale).to(card)
        b = _arr(rng, o, scale=0.1).to(card)
        before = fl_mod.SAGE_LAUNCHES
        got = fl_mod.fused_sage(mask, xk, x, ws, wn, b, aggregator,
                                activation)
        torch.cuda.synchronize()
        assert fl_mod.SAGE_LAUNCHES == before + 1
        torch.testing.assert_close(got, fl_mod.fused_sage_plain(
            mask, xk, x, ws, wn, b, aggregator, activation), **CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_fused_sage_near_float64_at_the_serving_shape(card, aggregator):
    # a 4 x 3072 batch at Fin 1433 -> 64 with W at scale 0.1: the kernel
    # (the walk, then X and AGG through one 3xTF32 accumulator) is held to
    # at most twice the plain version's error against the same layer in
    # float64
    rng = np.random.default_rng(24 + len(aggregator))
    sample, mean = _sage_masks(rng, 4, 3072, 2708, card)
    mask = mean if aggregator == "mean" else sample
    x = _arr(rng, 4, 3072, 1433).to(card)
    xk = x if aggregator == "mean" else _arr(rng, 4, 3072, 1433).abs().to(card)
    ws, wn = (_arr(rng, 1433, 64, scale=0.1).to(card) for _ in range(2))
    b = _arr(rng, 64, scale=0.1).to(card)
    args = (mask, xk, x, ws, wn, b)
    got = fl_mod.fused_sage(*args, aggregator, "relu")
    plain = fl_mod.fused_sage_plain(*args, aggregator, "relu")
    ref = fl_mod.fused_sage_plain(*(t.double() for t in args), aggregator,
                                  "relu")
    err_k = float((got.double() - ref).abs().max())
    err_p = float((plain.double() - ref).abs().max())
    assert err_k <= 2 * err_p, (err_k, err_p)


@pytest.mark.cuda
def test_sage_wrappers_reject_bad_operands(card):
    sample, _ = _sage_masks(np.random.default_rng(0), 1, 128, 100, card)
    h = torch.rand(1, 128, 16, device=card)
    w = torch.zeros(16, 8, device=card)
    b = torch.zeros(8, device=card)
    with pytest.raises(TypeError):
        sm_mod.sage_max(sample, h.double())
    with pytest.raises(ValueError, match="contiguous"):
        sm_mod.sage_max(sample.transpose(1, 2), h)
    with pytest.raises(ValueError, match="shapes do not agree"):
        sm_mod.sage_max(sample[:, :64, :64].contiguous(), h)
    with pytest.raises(ValueError, match="CUDA"):
        sm_mod.sage_max(sample, h.cpu())
    with pytest.raises(ValueError, match="shapes do not agree"):
        fl_mod.fused_sage(sample, h, h, torch.zeros(15, 8, device=card), w,
                          b, "max")
    with pytest.raises(ValueError, match="aggregator"):
        fl_mod.fused_sage(sample, h, h, w, w, b, "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_sage_graphserve_on_card_matches_cpu(card, aggregator):
    """SAGE fp32 and int8+grax on the card against the CPU engine, the same
    calibration on both: `fusion="layer"` (fused_sage; the QuantGr tier
    does not fuse) and `use_pallas` (block_matmul for mean, sage_max for
    max, int8_matmul for the int8 combines)."""
    cfg = GNNConfig(kind="sage", in_feats=48, hidden=16, num_classes=5,
                    aggregator=aggregator)
    base = dict(stagr=True, graphsplit=True, effop=True, grax3=True)
    graphs = [planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=48,
                             num_classes=5, seed=i, train_per_class=2)
              for i, n in enumerate((60, 120, 200, 250))]
    out, engines = {}, {}
    for side, dev in (("cpu", torch.device("cpu")), ("cuda", card)):
        eng = GraphServe(GraphServeConfig(ladder=BucketLadder((128, 256)),
                                          batch_slots=2, return_logits=True),
                         seed=3, device=dev)
        eng.register_model("sage", cfg, tiers=("fp32", "int8+grax"),
                           fusion="layer")
        eng.register_model("sage_mm", cfg, tiers={
            "fp32": Techniques(**base, use_pallas=True),
            "int8+grax": Techniques(**base, quantgr=True, use_pallas=True)})
        eng.warmup()
        for name in ("sage", "sage_mm"):
            if side == "cpu":
                eng.calibrate(name, graphs[3])
            else:                      # the same scales on both devices
                eng.models[name].calibrations["int8+grax"] = {
                    k: _calibration_to(layer, dev) for k, layer in
                    engines["cpu"].models[name].calibrations[
                        "int8+grax"].items()}
        launches = (fl_mod.SAGE_LAUNCHES, sm_mod.LAUNCHES, bm_mod.LAUNCHES,
                    im_mod.LAUNCHES)
        for g in graphs:
            for tier in ("fp32", "int8+grax"):
                eng.submit(g, model="sage", tier=tier)
                eng.submit(g, model="sage_mm", tier=tier)
        done = eng.run()
        out[side] = {r.uid: r.logits for r in done}
        engines[side] = eng
        eng.assert_warm()
        assert eng.summary()["tier_fallbacks"] == 0
        ran = (fl_mod.SAGE_LAUNCHES - launches[0],
               sm_mod.LAUNCHES - launches[1], bm_mod.LAUNCHES - launches[2],
               im_mod.LAUNCHES - launches[3])
        # per (model, tier): 2 buckets x 1 batch, 2 layers each; the int8
        # combines are self and neigh, and pool for max
        is_max = aggregator == "max"
        want = (4, 8 * is_max, 8 * (not is_max), 4 * (3 if is_max else 2))
        assert ran == (want if side == "cuda" else (0, 0, 0, 0))
    for uid, logits in out["cpu"].items():
        torch.testing.assert_close(torch.from_numpy(out["cuda"][uid]),
                                   torch.from_numpy(logits), **CARD)


FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
FLASH_CASES = {
    # (B, Sq, Skv, H, KV, D, causal, window, softcap, q_offset)
    "smollm_heads": (2, 128, 128, 9, 3, 64, True, None, None, 0),
    "ragged_200": (1, 200, 200, 9, 3, 64, True, None, None, 0),
    "gemma2_window_softcap": (1, 160, 160, 4, 2, 128, True, 64, 50.0, 0),
    "noncausal": (2, 96, 96, 4, 4, 32, False, None, None, 0),
    "q_offset": (2, 64, 192, 8, 2, 64, True, None, None, 128),
    # rows past q position 255 + 48 reach no key: a uniform average
    "window_past_keys": (1, 64, 256, 4, 2, 32, True, 48, None, 250),
    # the tensor-core route's configurations: SmolLM, qwen3, gemma2
    "smollm_b4_s256": (4, 256, 256, 9, 3, 64, True, None, None, 0),
    "qwen3_heads": (1, 192, 192, 32, 8, 128, True, None, None, 0),
    "gemma2_heads": (2, 200, 200, 32, 16, 128, True, 64, 50.0, 0),
    # Sq and Skv on both sides of the key tiles: 128 keys at D 64, 64 at
    # D 128
    "ragged_63_d64": (2, 63, 63, 9, 3, 64, True, None, None, 0),
    "ragged_65_d64": (2, 65, 65, 9, 3, 64, True, None, None, 0),
    "ragged_127_d64": (2, 127, 127, 9, 3, 64, True, None, None, 0),
    "ragged_129_d64": (2, 129, 129, 9, 3, 64, True, None, None, 0),
    "ragged_64_d128": (2, 64, 64, 8, 2, 128, True, None, None, 0),
    "ragged_65_d128": (2, 65, 65, 8, 2, 128, True, None, None, 0),
    "ragged_129_d128": (2, 129, 129, 8, 2, 128, True, None, None, 0),
    "noncausal_d128_ragged": (2, 100, 129, 8, 4, 128, False, None, None, 0),
    "q_offset_d128": (3, 65, 200, 8, 2, 128, True, None, None, 135),
    "window_past_keys_d64": (2, 64, 129, 6, 2, 64, True, 40, None, 130),
    "window_past_keys_d128": (1, 65, 65, 4, 4, 128, False, 30, None, 100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_plain(card, case, dtype):
    b, sq, skv, h, kv, d, causal, window, cap, off = FLASH_CASES[case]
    rng = np.random.default_rng(12)
    q = _arr(rng, b, sq, h, d).to(card, dtype)
    k = _arr(rng, b, skv, kv, d).to(card, dtype)
    v = _arr(rng, b, skv, kv, d).to(card, dtype)
    opts = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    route = fa_mod.flash_route(dtype, d)
    assert route == ("wgmma" if dtype == torch.bfloat16 and d in (64, 128)
                     else "simt")
    counter = "TC_LAUNCHES" if route == "wgmma" else "SIMT_LAUNCHES"
    before = (fa_mod.LAUNCHES, getattr(fa_mod, counter))
    got = fa_mod.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert (fa_mod.LAUNCHES, getattr(fa_mod, counter)) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(
        got.float(), kref.flash_attention_ref(q, k, v, **opts).float(),
        **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_rejects_bad_operands(card):
    q = torch.zeros(1, 64, 4, 64, device=card)
    k = torch.zeros(1, 64, 2, 64, device=card)
    with pytest.raises(TypeError):
        fa_mod.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        fa_mod.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fa_mod.flash_attention(q.transpose(1, 2).contiguous().transpose(
            1, 2), k, k)
    with pytest.raises(ValueError, match="head dim"):
        fa_mod.flash_attention(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               k[..., :48].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention(q, k.cpu(), k)
    # the tensor-core route loads by TMA: a base that is not 16-byte
    # aligned raises, and nothing launches on another route
    qb = torch.zeros(64 * 4 * 64 + 1, dtype=torch.bfloat16, device=card)
    kb = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=card)
    q_odd = qb[1:].view(1, 64, 4, 64)
    assert q_odd.is_contiguous() and q_odd.data_ptr() % 16
    before = fa_mod.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        fa_mod.flash_attention(q_odd, kb, kb)
    k_odd = qb[1:1 + kb.numel()].view(kb.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fa_mod.flash_attention(qb[:-1].view(1, 64, 4, 64), k_odd, kb)
    assert fa_mod.LAUNCHES == before


@pytest.mark.cuda
def test_tensor_core_kernels_sass(card):
    """The redesigned libraries run on the tensor cores: wgmma (HGMMA) and
    TMA loads (UTMALDG) in flash_attention's bf16 route, TF32 MMA in
    block_matmul, in the three GAT libraries' attention body, in
    fused_sage's combine, in the GCN layers' products (both launches of
    fused_gcn_dense and of fused_gcn_grasp) and in bitmap_spmm's GraSp
    walk, s8 MMA (IMMA) in the two int8 libraries."""
    fa = _build.sass_counts("flash_attention_tc",
                            {"HGMMA": ("HGMMA",), "UTMALDG": ("UTMALDG",)})
    assert fa["HGMMA"] > 0 and fa["UTMALDG"] > 0, fa
    for lib in ("block_matmul", "gat_attention", "fused_gat_full",
                "fused_gat_precombined", "fused_sage", "fused_gcn_dense",
                "fused_gcn_grasp", "bitmap_spmm"):
        counts = _build.sass_counts(lib, {"HMMA TF32": ("HMMA", "TF32")})
        assert counts["HMMA TF32"] > 0, (lib, counts)
    for lib in ("int8_matmul", "fused_gcn_int8"):
        counts = _build.sass_counts(lib, {"IMMA": ("IMMA",)})
        assert counts["IMMA"] > 0, (lib, counts)


@pytest.mark.cuda
def test_lm_init_defaults_to_the_card(card):
    """device=None means the card: every weight of `lm_init` lies there."""
    params = tlm.lm_init(reduced(get_config("smollm-135m")), seed=1)
    leaves = [params.embed, *params.final_norm.values()]
    for layer in params.stack:
        leaves += [*layer["mixer"], *layer["mlp"], layer["pre_norm"]["scale"]]
    assert all(t.device == card for t in leaves if t is not None)


@pytest.mark.cuda
def test_lm_server_on_card_prefills_through_the_kernel(card):
    """A reduced smollm served on the card: one flash_attention launch per
    layer per prefill, the same counters as on the CPU, and prefill logits
    that match the CPU's."""
    cfg = reduced(get_config("smollm-135m"))
    params = tlm.lm_init(cfg, seed=3, device="cpu")
    moved = tlm.lm_init(cfg, seed=3, device=card)        # the same draws
    sc = tserver.ServeConfig(buckets=(16, 32), max_len=40, batch_slots=3)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, n) for n in (7, 30, 19, 12, 25)]
    servers = {}
    for dev, p in (("cpu", params), (card, moved)):
        server = tserver.Server(cfg, sc, params=p, device=dev)
        for prompt in prompts:
            server.submit(prompt, max_new_tokens=4)
        before = fa_mod.LAUNCHES
        server.run()
        servers[str(dev)] = (server, fa_mod.LAUNCHES - before)
    (cpu, cpu_launches), (gpu, gpu_launches) = servers.values()
    assert cpu_launches == 0
    assert gpu_launches == gpu.summary()["prefills"] * cfg.num_layers == 4
    counters = ("requests", "compiled_blobs", "prefills", "decode_steps",
                "tokens_out")
    assert ({k: gpu.summary()[k] for k in counters}
            == {k: cpu.summary()[k] for k in counters})
    toks = torch.from_numpy(np.stack([p[:7] for p in prompts[:3]])).long()
    want, _ = tlm.lm_prefill(params, cfg, toks, max_len=16)
    got, _ = tlm.lm_prefill(moved, cfg, toks.to(card), max_len=16)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)



def _pipeline_engine(card):
    """A Cora-width fp32 GCN at bucket 1024, fused, on the card."""
    eng = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=(1024,)),
                                      batch_slots=4, return_logits=True),
                     seed=0, device=card)
    eng.register_model("gcn", GNNConfig(kind="gcn", in_feats=1433, hidden=64,
                                        num_classes=7), fusion="layer")
    eng.warmup()
    return eng


@pytest.mark.cuda
def test_threaded_scheduler_on_card_is_bit_equal_to_sync(card):
    """Four host workers, each on its own stream, at bucket 1024: over 5
    bursts every answer equals the sync path's for the same graph bit for
    bit, nothing recompiles, and each batch launches `fused_gcn_dense`
    twice."""
    from repro_torch.runtime.scheduler import PipelineConfig
    graphs = [planetoid_like(num_nodes=n, num_edges=2 * n, num_feats=1433,
                             num_classes=7, seed=i)
              for i, n in enumerate((300, 520, 700, 880, 1000, 640, 410))]
    eng = _pipeline_engine(card)
    for g in graphs:
        eng.submit(g, model="gcn")
    want = [r.logits for r in sorted(eng.run(), key=lambda r: r.uid)]
    for burst in range(5):
        b0, l0 = eng.metrics["batches"], fl_mod.LAUNCHES
        with eng.scheduler(PipelineConfig(host_workers=4,
                                          window_ms=2.0)) as sched:
            for g in graphs:
                sched.submit(g, model="gcn")
            out = sched.drain(timeout=120)
        assert sched.metrics["completed"] == sched.metrics["accepted"] == 7
        for r, w in zip(out, want):
            assert r.logits.shape == w.shape
            assert np.array_equal(r.logits, w), f"burst {burst}, uid {r.uid}"
        assert fl_mod.LAUNCHES - l0 == 2 * (eng.metrics["batches"] - b0)
        eng.assert_warm()


@pytest.mark.cuda
def test_host_stage_hands_requests_to_the_dispatch_stream(card, monkeypatch):
    """A request prepared on a worker's stream carries an event recorded
    there, and each of its device tensors a `record_stream` for the
    engine's dispatch stream, so the allocator cannot reuse its memory
    under the dispatcher's kernels."""
    recorded = set()
    original = torch.Tensor.record_stream

    def spy(t, stream):
        recorded.add((t.data_ptr(), stream.cuda_stream))
        return original(t, stream)
    monkeypatch.setattr(torch.Tensor, "record_stream", spy)
    eng = _pipeline_engine(card)
    worker = torch.cuda.Stream(card)
    g = planetoid_like(num_nodes=500, num_edges=1000, num_feats=1433,
                       num_classes=7, seed=3)
    with torch.cuda.stream(worker):
        req = eng.prepare_submit(g, model="gcn")
    assert isinstance(req.ready, torch.cuda.Event)
    dispatch = eng._dispatch_stream.cuda_stream
    assert dispatch != worker.cuda_stream
    for t in (req.x, req.ops.norm_adj):
        assert t.device.type == "cuda"
        assert (t.data_ptr(), dispatch) in recorded
    eng._execute_batch([req])
    assert req.preds is not None and req.preds.shape == (500,)


def _trained_case(n=1000, feats=300):
    """A Planetoid-like graph (feats not a multiple of 128, so the kernel
    entries pad and strip it), padded to 1024 with `pad_graph`."""
    from repro_torch.core.graph import pad_graph
    g = planetoid_like(num_nodes=n, num_edges=2 * n, num_feats=feats,
                       num_classes=7, seed=5)
    return g, pad_graph(g)


def _forwards(kind, cfg, pg, g, device):
    """The training forward of `kind` on `device` (`accuracy_table`'s)."""
    from repro_torch.core import models as gm
    if kind.startswith("sage"):
        return lambda p, x: gm.forward_baseline(p, cfg, x, g.edge_index,
                                                pg.capacity)
    ops_ = gm.build_operands(pg, cfg, device=device)
    t = Techniques(stagr=True) if kind == "gcn" else Techniques(effop=True)
    return lambda p, x: gm.forward_grannite(p, cfg, x, ops_, t)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gcn", "gat", "sage-max", "sage-mean"])
def test_training_step_on_card_matches_cpu(card, kind):
    from repro_torch.core import models as gm
    from repro_torch.optim.adamw import adamw_init, adamw_update
    g, pg = _trained_case()
    name, _, agg = kind.partition("-")
    cfg = GNNConfig(kind=name, in_feats=300, num_classes=7,
                    aggregator=agg or "mean")
    cpu = torch.device("cpu")
    params = gm.init_params(torch.Generator().manual_seed(0), cfg,
                            device=cpu)
    grads, stepped = {}, {}
    for key, dev in (("cpu", cpu), ("card", card)):
        fwd = _forwards(kind, cfg, pg, g, dev)
        leaves = {k: {n: v.to(dev).requires_grad_(True)
                      for n, v in layer.items()}
                  for k, layer in params.items()}
        flat = [v for layer in leaves.values() for v in layer.values()]
        loss = gm.masked_cross_entropy(
            fwd(leaves, torch.from_numpy(pg.features).to(dev)),
            torch.from_numpy(pg.labels).long().to(dev),
            torch.from_numpy(pg.train_mask).to(dev))
        grads[key] = [t.cpu() for t in torch.autograd.grad(loss, flat)]
        with torch.no_grad():
            p, _ = adamw_update([t.detach() for t in flat],
                                [t.to(dev) for t in grads[key]],
                                adamw_init(flat), lr=0.01,
                                weight_decay=5e-4)
        stepped[key] = [t.cpu() for t in p]
    gmax = max(t.abs().max().item() for t in grads["cpu"])
    for got, want in zip(grads["card"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * gmax)
    # where a gradient entry is far from 0, the step moves the weight by
    # the same lr * sign(g) on both devices
    for got, want, g_ in zip(stepped["card"], stepped["cpu"], grads["cpu"]):
        far = g_.abs() > 1e-3 * gmax
        torch.testing.assert_close(got[far], want[far], **CARD)


@pytest.mark.cuda
def test_offline_int8_on_card_matches_plain(card):
    """`calibrate_quant`'s one-graph (N, N) int8 Â through `int8_matmul`
    and `fused_gcn_int8`: the int32 products equal the plain ones exactly,
    the fused layer its plain version bit for bit, and the forward the
    plain int8 forward."""
    from repro_torch.core import models as gm
    from repro_torch.core.quant import quantize_s8
    g, pg = _trained_case()
    cfg = GNNConfig(kind="gcn", in_feats=300, num_classes=7)
    params = gm.init_params(torch.Generator().manual_seed(1), cfg,
                            device=card)
    x = torch.from_numpy(pg.features).to(card)
    ops_ = gm.build_operands(pg, cfg, device=card)
    q = gm.calibrate_quant(params, cfg, x, ops_)
    qa = q["agg1"]
    assert qa.aq.shape == (pg.capacity, pg.capacity)
    hq = quantize_s8(x @ params["l1"]["w"], qa.h_scale)
    ones = torch.ones(hq.shape[-1], device=card)
    l0 = im_mod.LAUNCHES
    got = kops.int8_matmul(qa.aq, hq, 1.0, ones)
    assert im_mod.LAUNCHES == l0 + 1
    assert torch.equal(got, im_mod.int_matmul(qa.aq, hq).to(torch.float32))
    ql = q["l1"]
    l0 = fl_mod.INT8_LAUNCHES
    layer = glayers.gcn_grannite_fused(
        params["l1"], x, ops_.norm_adj, Techniques(stagr=True, quantgr=True),
        activation="relu", quant=ql, quant_agg=qa)
    assert fl_mod.INT8_LAUNCHES == l0 + 1
    plain = fl_mod.fused_gcn_int8_plain(
        x[None], ql.wq, (ql.x_scale * ql.w_scale).reshape(1, -1),
        ql.x_scale, qa.h_scale, qa.aq[None], qa.a_scale[None],
        params["l1"]["b"], "relu")[0]
    assert torch.equal(layer, plain)
    ops_q = dataclasses.replace(ops_, quant=q)
    t = Techniques(stagr=True, quantgr=True)
    want = gm.forward_grannite(params, cfg, x, ops_q, t)
    n = g.num_nodes
    for fwd in (lambda: gm.forward_grannite(
                    params, cfg, x, ops_q,
                    dataclasses.replace(t, use_pallas=True)),
                lambda: gm.forward_grannite(params, cfg, x, ops_q, t,
                                            fusion="layer")):
        out = fwd()
        torch.testing.assert_close(out[:n], want[:n], **CARD)
        assert torch.equal(out[:n].argmax(-1), want[:n].argmax(-1))
    with pytest.raises(ValueError, match="calibrate_quant"):
        stack_operands([ops_q, ops_q])


@pytest.mark.cuda
def test_forward_baseline_on_card_matches_grannite(card):
    from repro_torch.core import models as gm
    from repro_torch.core.graph import add_self_loops
    g, pg = _trained_case()
    cfg = GNNConfig(kind="gcn", in_feats=300, num_classes=7)
    params = gm.init_params(torch.Generator().manual_seed(2), cfg,
                            device=card)
    x = torch.from_numpy(pg.features).to(card)
    base = gm.forward_baseline(params, cfg, x,
                               add_self_loops(g.edge_index, g.num_nodes),
                               pg.capacity)
    dense = gm.forward_grannite(params, cfg, x,
                                gm.build_operands(pg, cfg, device=card),
                                Techniques(stagr=True))
    n = g.num_nodes
    assert base.device == card
    torch.testing.assert_close(base[:n], dense[:n], **CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,t,fusion,cut", [
    ("sage-mean", dict(stagr=True, use_pallas=True), "none",
     "l1.b l1.w_neigh l1.w_self"),
    ("gcn", dict(stagr=True), "layer", "l1.b l1.w l2.b l2.w"),
], ids=["sage-mean-pallas", "gcn-layer"])
def test_training_through_kernels_on_card_names_every_cut(card, kind, t,
                                                          fusion, cut):
    """On the card the kernels' outputs have no path back; the entries'
    guard names exactly the parameters whose gradient they would cut, and
    an entry called outside the trainer refuses operands that require
    grad."""
    from repro_torch.core import models as gm
    g, pg = _trained_case()
    name, _, agg = kind.partition("-")
    cfg = GNNConfig(kind=name, in_feats=300, num_classes=7,
                    aggregator=agg or "mean")
    ops_ = gm.build_operands(pg, cfg, device=card)

    def fwd(p, x):
        return gm.forward_grannite(p, cfg, x, ops_, Techniques(**t),
                                   fusion=fusion)

    with pytest.raises(RuntimeError, match="epoch 0: no full gradient") as e:
        gm.train_node_classifier(torch.Generator().manual_seed(0), cfg, pg,
                                 fwd, epochs=2, device=card)
    named = str(e.value).split("reached ")[1].split(";")[0].split(", ")
    assert sorted(named) == cut.split()
    w = torch.ones(8, 8, device=card, requires_grad=True)
    with pytest.raises(kops.NoBackward, match="^matmul: "):
        kops.matmul(torch.ones(8, 8, device=card), w)
