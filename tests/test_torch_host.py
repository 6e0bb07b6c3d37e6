"""PyTorch port, host substrate: the numpy generators and NodePad helpers of
`repro_torch` produce exactly the reference package's arrays."""
import dataclasses

import numpy as np
import pytest

from repro.core import graph as rg
from repro.data import graphs as rd
from repro_torch.core import graph as tg
from repro_torch.data import graphs as td

GENERATORS = {
    "planetoid": dict(num_nodes=150, num_edges=400, num_feats=24,
                      num_classes=4, train_per_class=3),
    "clustered": dict(num_nodes=300, num_feats=16, num_classes=3,
                      within_density=0.05, cluster=64, cross_frac=0.1),
}
FN = {"planetoid": "planetoid_like", "clustered": "clustered_like"}


def _assert_same_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def _graph(n, seed, feats=24, classes=4):
    return td.planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=feats,
                             num_classes=classes, seed=seed,
                             train_per_class=2)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_identical(name, seed):
    kw = dict(GENERATORS[name], seed=seed)
    _assert_same_fields(getattr(td, FN[name])(**kw),
                        getattr(rd, FN[name])(**kw))


def test_cora_like_identical():
    g, r = td.cora_like(seed=0), rd.cora_like(seed=0)
    assert (g.num_nodes, g.features.shape) == (2708, (2708, 1433))
    _assert_same_fields(g, r)


@pytest.mark.parametrize("norm", ["gcn", "mean"])
@pytest.mark.parametrize("capacity", [None, 256])
def test_pad_graph_identical(norm, capacity):
    g = _graph(130, 3)
    got = tg.pad_graph(g, capacity=capacity, norm=norm)
    want = rg.pad_graph(rg.Graph(**dataclasses.asdict(g)), capacity=capacity,
                        norm=norm)
    _assert_same_fields(got, want)


def test_norm_adjacency_helpers_identical():
    g = _graph(90, 5)
    for fn in ("gcn_norm_adjacency", "mean_adjacency"):
        np.testing.assert_array_equal(
            getattr(tg, fn)(g.edge_index, g.num_nodes, 128),
            getattr(rg, fn)(g.edge_index, g.num_nodes, 128))
    np.testing.assert_array_equal(
        tg.dense_adjacency(g.edge_index, 128, num_nodes=g.num_nodes),
        rg.dense_adjacency(g.edge_index, 128, num_nodes=g.num_nodes))
    np.testing.assert_array_equal(tg.add_self_loops(g.edge_index, 90),
                                  rg.add_self_loops(g.edge_index, 90))


@pytest.mark.parametrize("slack", [0.0, 0.5])
def test_bucket_ladder_agrees(slack):
    buckets = (128, 256, 384)
    tl = tg.BucketLadder(buckets=buckets, slack=slack)
    rl = rg.BucketLadder(buckets=buckets, slack=slack)
    for n in range(1, 385, 7):
        assert tl.bucket_for(n) == rl.bucket_for(n), n
        assert tg.node_bucket(n, slack=slack) == rg.node_bucket(n, slack=slack)
    with pytest.raises(ValueError):
        tl.bucket_for(385)
    with pytest.raises(ValueError):
        tg.BucketLadder(buckets=(100,))


def test_stack_padded_agrees():
    pgs = [tg.pad_graph(_graph(n, i), capacity=256)
           for i, n in enumerate((60, 130, 250))]
    _assert_same_fields(
        tg.stack_padded(pgs),
        rg.stack_padded([rg.PaddedGraph(**dataclasses.asdict(p))
                         for p in pgs]))
    with pytest.raises(ValueError):
        tg.stack_padded([pgs[0], tg.pad_graph(_graph(60, 0), capacity=128)])


def test_grow_and_update_edges_agree():
    g = _graph(100, 2)
    ei = np.concatenate([g.edge_index, np.array([[0, 105], [105, 0]],
                                                np.int32)], axis=1)
    feats = np.concatenate([g.features, np.zeros((10, 24), np.float32)])
    for buckets, n in (((128, 256), 110), ((128, 256), 200)):
        tl, rl = tg.BucketLadder(buckets=buckets), rg.BucketLadder(buckets=buckets)
        pg_t = tl.pad(g)
        pg_r = rl.pad(rg.Graph(**dataclasses.asdict(g)))
        f = np.concatenate([feats, np.zeros((max(n - 110, 0), 24), np.float32)])
        got, moved_t = tl.grow(pg_t, ei, n, f[:n])
        want, moved_r = rl.grow(pg_r, ei, n, f[:n])
        assert moved_t == moved_r
        _assert_same_fields(got, want)
    np.testing.assert_array_equal(
        tg.edge_index_from_adjacency(pg_t.adj, 100),
        rg.edge_index_from_adjacency(pg_r.adj, 100))
