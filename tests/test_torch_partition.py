"""PyTorch port, the multi-device GraphSplit slice: the host planners and
the compressed collectives. `core/partition.py` (the host/device stage
cut, the greedy and multilevel N-way partitioners, `partition_for_ladder`,
`patch_halo`, the modelled sharded latency), `EdgeDelta.boundary_rows`
and `dist/compress.py`, each against the reference package on the same
numpy inputs.

Tolerance: none. The partitions (assignment, slot permutation, halos,
loads, cut), the coarsening levels, the planners' figures (with the
reference's constants set on the port's `core.costs`) and the boundary
rows are equal exactly; the compress functions equal the reference's
`jax.jit(jax.vmap(fn, axis_name=...))` bit for bit, the form its sharded
plans run (jitted, XLA multiplies by the float32 reciprocal of 127 and
fuses the residual's multiply-add; `dist/compress.py`'s docstring).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import costs as rcosts
from repro.core import graph as rg
from repro.core import partition as rp
from repro.dist import compress as rc
from repro_torch.core import costs as tcosts
from repro_torch.core import graph as tg
from repro_torch.core import partition as tp
from repro_torch.data import graphs as tdata
from repro_torch.dist import compress as tc

IN_FEATS, CLASSES = 8, 4
# the reference's values of the constants its planners read, by the
# port's names (the port's DENSE_RATE is the reference's MXU_RATE)
REF_CONSTANTS = {"DENSE_RATE": rcosts.MXU_RATE, "GATHER_BW": rcosts.GATHER_BW,
                 "CPU_RATE": rcosts.CPU_RATE,
                 "HOST_LINK_BYTES_PER_S": rcosts.HOST_LINK_BYTES_PER_S,
                 "LAUNCH_LATENCY_S": rcosts.LAUNCH_LATENCY_S,
                 "DEVICE_LINK_BYTES_PER_S": rcosts.DEVICE_LINK_BYTES_PER_S,
                 "COLLECTIVE_LATENCY_S": rcosts.COLLECTIVE_LATENCY_S}


@pytest.fixture
def ref_constants(monkeypatch):
    for name, value in REF_CONSTANTS.items():
        monkeypatch.setattr(tcosts, name, value)


def _clustered(n, seed, **kw):
    return tdata.clustered_like(num_nodes=n, num_feats=IN_FEATS,
                                num_classes=CLASSES, within_density=0.05,
                                cross_frac=0.1, seed=seed, **kw)


def _planetoid(n, seed):
    return tdata.planetoid_like(num_nodes=n, num_edges=3 * n,
                                num_feats=IN_FEATS, num_classes=CLASSES,
                                seed=seed, train_per_class=1)


def _same_part(got, want):
    assert (got.shards, got.shard_cap, got.num_nodes, got.full_rows,
            got.cut_edges, got.halo_nodes) == (
        want.shards, want.shard_cap, want.num_nodes, want.full_rows,
        want.cut_edges, want.halo_nodes)
    for f in ("assignment", "perm", "loads"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert len(got.halo) == len(want.halo)
    for a, b in zip(got.halo, want.halo):
        assert np.array_equal(a, b)


GRAPHS = {"clustered300": lambda: _clustered(300, 0),
          "clustered400": lambda: _clustered(400, 8),
          "planetoid350": lambda: _planetoid(350, 3),
          "clustered900": lambda: _clustered(900, 5)}


@pytest.mark.parametrize("method", ["multilevel", "greedy"])
@pytest.mark.parametrize("name,shards,cap", [
    ("clustered300", 2, 256), ("clustered300", 3, 128),
    ("clustered400", 4, 128), ("planetoid350", 2, 256),
    ("planetoid350", 3, 128), ("clustered900", 4, 256),
    ("clustered900", 8, 128)])
def test_partition_graph_equals_reference(method, name, shards, cap):
    g = GRAPHS[name]()
    got = tp.partition_graph(g.edge_index, g.num_nodes, shards,
                             shard_cap=cap, method=method)
    want = rp.partition_graph(g.edge_index, g.num_nodes, shards,
                              shard_cap=cap, method=method)
    _same_part(got, want)
    np.testing.assert_array_equal(np.sort(got.perm),
                                  np.arange(got.full_rows))


@pytest.mark.parametrize("method", ["multilevel", "greedy"])
def test_partition_tight_cap_equals_reference(method):
    """A load cap below the bucket (`max_load`), where the multilevel
    refinement must repair the balance."""
    g = _clustered(500, 11)
    got = tp.partition_graph(g.edge_index, 500, 4, shard_cap=256,
                             max_load=125, method=method)
    want = rp.partition_graph(g.edge_index, 500, 4, shard_cap=256,
                              max_load=125, method=method)
    _same_part(got, want)
    assert got.loads.max() <= 125


@pytest.mark.parametrize("name,max_shards", [("clustered400", 4),
                                             ("planetoid350", 2),
                                             ("clustered900", 8)])
def test_coarsen_graph_equals_reference(name, max_shards):
    g = GRAPHS[name]()
    got = tp.coarsen_graph(g.edge_index, g.num_nodes, max_shards=max_shards)
    want = rp.coarsen_graph(g.edge_index, g.num_nodes, max_shards=max_shards)
    assert (got.num_nodes, got.max_shards, len(got.levels)) == (
        want.num_nodes, want.max_shards, len(want.levels))
    for a, b in zip(got.levels, want.levels):
        assert a.n == b.n
        for f in ("eu", "ev", "ew", "nw", "parent"):
            x, y = getattr(a, f), getattr(b, f)
            if y is None:
                assert x is None
            else:
                assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("method", ["multilevel", "greedy"])
@pytest.mark.parametrize("n,buckets,counts", [
    (300, (128, 256), (4, 2)), (300, (128, 256), (8,)),
    (900, (128, 256), (2, 4, 8)), (700, (128, 256), (4, 8))])
def test_partition_for_ladder_equals_reference(method, n, buckets, counts):
    g = _clustered(n, 21)
    got = tp.partition_for_ladder(g.edge_index, n,
                                  tg.BucketLadder(buckets=buckets), counts,
                                  method=method)
    want = rp.partition_for_ladder(g.edge_index, n,
                                   rg.BucketLadder(buckets=buckets), counts,
                                   method=method)
    _same_part(got, want)


@pytest.mark.parametrize("case", ["over cap", "cannot hold", "no shards",
                                  "method", "no count fits", "count 1"])
def test_partition_errors_equal_reference(case):
    g = _clustered(64, 2)
    calls = {
        "over cap": lambda m: m.partition_graph(g.edge_index, 64, 2,
                                                shard_cap=128, max_load=200),
        "cannot hold": lambda m: m.partition_graph(g.edge_index, 64, 2,
                                                   shard_cap=128,
                                                   max_load=16),
        "no shards": lambda m: m.partition_graph(g.edge_index, 64, 0,
                                                 shard_cap=128),
        "method": lambda m: m.partition_graph(g.edge_index, 64, 2,
                                              shard_cap=128, method="x"),
        "no count fits": lambda m: m.partition_for_ladder(
            g.edge_index, 3000, (tg if m is tp else rg).BucketLadder(
                buckets=(128, 256)), (2,)),
        "count 1": lambda m: m.partition_for_ladder(
            g.edge_index, 300, (tg if m is tp else rg).BucketLadder(
                buckets=(128, 256)), (1,)),
    }
    msgs = []
    for mod in (tp, rp):
        with pytest.raises(ValueError) as info:
            calls[case](mod)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def _flip_pairs(adj, n, part, rng, cross):
    """Four absent pairs across shards (`cross`) or inside shard 0, and
    two present pairs to remove."""
    a = part.assignment
    iu, ju = np.triu_indices(n, 1)
    same = a[iu] == a[ju]
    pool_add = np.flatnonzero((adj[iu, ju] == 0)
                              & (~same if cross else (same & (a[iu] == 0))))
    pool_rm = np.flatnonzero(adj[iu, ju] != 0)
    add = rng.choice(pool_add, size=4, replace=False)
    rm = rng.choice(pool_rm, size=2, replace=False)
    return (np.stack([iu[add], ju[add]], 1), np.stack([iu[rm], ju[rm]], 1))


@pytest.mark.parametrize("cross", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_patch_halo_and_boundary_rows_equal_reference(cross, seed):
    """A delta's host products on a partitioned graph: the kept
    partition's new halos and cut (`patch_halo`) and the boundary-dirty
    rows (`EdgeDelta.boundary_rows`), equal to the reference's and to a
    recount from the patched edges."""
    rng = np.random.default_rng(seed)
    g = _clustered(300, 30 + seed)
    part = tp.partition_graph(g.edge_index, 300, 3, shard_cap=128)
    pg = tg.pad_graph(g, capacity=part.full_rows)
    add, rm = _flip_pairs(pg.adj, 300, part, rng, cross)
    d_t = tg.apply_edge_delta(pg.adj, pg.norm_adj, 300, add, rm)
    d_r = rg.apply_edge_delta(pg.adj, pg.norm_adj, 300, add, rm)
    got = d_t.boundary_rows(part.assignment, 300)
    want = d_r.boundary_rows(part.assignment, 300)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    edges = tg.edge_index_from_adjacency(d_t.adj, 300)
    p_t = tp.patch_halo(part, edges)
    p_r = rp.patch_halo(rp.GraphShards(**dataclasses.asdict(part)), edges)
    _same_part(p_t, p_r)
    np.testing.assert_array_equal(p_t.perm, part.perm)
    src, dst = edges
    assert p_t.cut_edges == int((part.assignment[src]
                                 != part.assignment[dst]).sum())
    a = part.assignment
    expect = [t for t in d_t.touched
              if (d_t.adj[t, :300] != 0)[a != a[t]].any()]
    np.testing.assert_array_equal(got, np.asarray(expect, np.int32))


def test_boundary_rows_of_an_interior_delta_is_empty():
    g = _clustered(256, 1)
    part = tp.partition_graph(g.edge_index, 256, 2, shard_cap=128)
    pg = tg.pad_graph(g, capacity=256)
    a = part.assignment
    interior = [u for u in np.flatnonzero(a == 0)
                if not (pg.adj[u, :256] != 0)[a != 0].any()]
    u, v = int(interior[0]), int(interior[1])
    d = tg.apply_edge_delta(pg.adj, pg.norm_adj, 256,
                            [(u, v)] if pg.adj[u, v] == 0 else None,
                            [(u, v)] if pg.adj[u, v] != 0 else None)
    assert d.boundary_rows(a, 256).size == 0


@pytest.mark.parametrize("n,edges,fin,fout,cap", [
    (2708, 10556, 1433, 64, 3072), (100, 300, 16, 7, 128),
    (5000, 100000, 128, 256, 8192)])
def test_graphsplit_equals_reference(ref_constants, n, edges, fin, fout,
                                     cap):
    """The host/device stage cut over the modelled stages."""
    st_t = tp.default_gnn_stages(n, edges, fin, fout, capacity=cap)
    st_r = rp.default_gnn_stages(n, edges, fin, fout, capacity=cap)
    for a, b in zip(st_t, st_r):
        assert (a.name, a.host_latency_s, a.device_latency_s,
                a.output_bytes, a.control_heavy) == (
            b.name, b.host_latency_s, b.device_latency_s, b.output_bytes,
            b.control_heavy)
    got, want = tp.graphsplit(st_t), rp.graphsplit(st_r)
    assert (got.cut, got.total_latency_s, got.per_cut_latency_s) == (
        want.cut, want.total_latency_s, want.per_cut_latency_s)
    assert got.placement(st_t) == want.placement(st_r)


def test_graphsplit_picks_the_cheapest_cut():
    stages = [tp.Stage("a", 1e-3, 1.0, output_bytes=10),
              tp.Stage("b", 1.0, 1e-6, output_bytes=10)]
    plan = tp.graphsplit(stages)
    assert plan.cut == 1
    assert plan.placement(stages) == ["host", "device"]
    assert plan.total_latency_s == min(plan.per_cut_latency_s)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("shards,cap", [(1, 2048), (2, 1024), (4, 512),
                                        (8, 256)])
def test_modelled_sharded_latency_equals_reference(ref_constants, compress,
                                                   shards, cap):
    n = shards * cap
    part = tp.GraphShards(shards=shards, shard_cap=cap, num_nodes=n,
                          assignment=np.zeros(n, np.int32),
                          perm=np.arange(n), halo=(), loads=np.array([n]),
                          cut_edges=0)
    kw = dict(in_feats=16, hidden=256, classes=5, exchange_widths=(256, 5),
              compress=compress)
    assert tp.modelled_sharded_latency(part, **kw) == \
        rp.modelled_sharded_latency(
            rp.GraphShards(**dataclasses.asdict(part)), **kw)


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_ring_psum_nbytes_equals_reference(shards):
    for elems in (0, 1, 12288 * 64, 5e6):
        for b in (1, 4):
            assert tc.ring_psum_nbytes(shards, elems, bytes_per_elt=b) == \
                rc.ring_psum_nbytes(shards, elems, bytes_per_elt=b)


def _jit_vmap(fn, *in_axes):
    return jax.jit(jax.vmap(fn, in_axes=in_axes or 0, axis_name="s"))


def _inputs(shards, seed, shape=(64, 5)):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((shards, *shape))
         * rng.uniform(0.01, 100)).astype(np.float32)
    g[0, 0, 0] = -0.0                     # a negative zero on the wire
    return g


def _equal(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    # bit for bit, signs of zeros included
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compressed_psum_equals_reference(shards, seed):
    g = _inputs(shards, seed)
    got = tc.compressed_psum(torch.from_numpy(g))
    want = _jit_vmap(lambda x: rc.compressed_psum(x, "s"))(g)
    _equal(got[0], want[0])
    _equal(got[1], want[1])
    mean = tc.compressed_psum_mean(torch.from_numpy(g))
    want = _jit_vmap(lambda x: rc.compressed_psum_mean(x, "s"))(g)
    _equal(mean[0], want[0])
    _equal(mean[1], want[1])


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_exact_psum_mean_equals_reference(shards):
    g = _inputs(shards, 7)
    _equal(tc.exact_psum_mean(torch.from_numpy(g)),
           _jit_vmap(lambda x: rc.exact_psum_mean(x, "s"))(g))


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("shards", [2, 4])
def test_compressed_psum_delta_equals_reference(compress, shards):
    g = _inputs(shards, 3, shape=(12, 33))
    owners = np.random.default_rng(4).integers(0, shards, 12).astype(
        np.int32)
    got = tc.compressed_psum_delta(torch.from_numpy(g),
                                   torch.from_numpy(owners),
                                   compress=compress)
    want = _jit_vmap(lambda x, o: rc.compressed_psum_delta(
        x, o, "s", compress=compress), 0, None)(g, owners)
    _equal(got, want)
    if not compress:     # an assembly: each row from its owner, exactly
        expect = g[owners, np.arange(12)]
        np.testing.assert_array_equal(got[0].numpy(), expect)


def test_compressed_psum_of_disjoint_blocks_is_within_half_a_step():
    """The halo corollary: disjoint zero-padded blocks sum to the blocks
    themselves, each element within scale/2, whatever the shard count."""
    rng = np.random.default_rng(5)
    s, c, w = 4, 16, 6
    rows = rng.standard_normal((s * c, w)).astype(np.float32)
    bufs = np.zeros((s, s * c, w), np.float32)
    for i in range(s):
        bufs[i, i * c:(i + 1) * c] = rows[i * c:(i + 1) * c]
    total, _ = tc.compressed_psum(torch.from_numpy(bufs))
    scale = np.abs(rows).max() / 127
    assert np.abs(total[0].numpy() - rows).max() <= scale / 2 * (1 + 1e-6)
