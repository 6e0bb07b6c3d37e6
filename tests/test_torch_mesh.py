"""PyTorch port, GraphSplit across processes: the distribution rules
(`dist.sharding`), the meshes of ranks (`launch.mesh`), the group forms of
`dist.compress`, the sharded plan on a mesh (`build_sharded_plan(mesh=)`)
and sharded serving on a mesh (`GraphServe(mesh=)`, `launch.
shard_serve`), held against the reference package and against the
port's own single-process (stacked) forms.

The ranks run as subprocesses on gloo and the CPU, one thread each
(`tests/torch_mesh_rank.py`, `python -m repro_torch.launch.shard_serve`),
started by `spawn_local` under a timeout that kills them all; each group
runs once per module (the fixtures below) and the parametrised cases read
its results. The rank processes import no JAX: the references run here.

Tolerance: a rank's logits equal its rows of the port's stacked plan and
engine bit for bit (the exchange is an assembly of disjoint blocks, on
either wire; the stacked forms are computed here on one thread, as the
ranks run), and so do the group forms of the halo, the halo delta and
the int8 wire's sums. An exact fp32 sum over ranks (`psum`,
`exact_psum_mean`) may round in another order: within 1e-6 relative.
Against the reference the rules of `tests/test_torch_sharded.py` hold:
fp32 with the exact wire at rtol=atol=1e-5 with argmax equal; the int8
wire and the int8 tiers within 0.05 with argmax equal on 99% of rows
(an int8 tie can round to the neighbouring step).
"""
import contextlib
import dataclasses
import json
import sys
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as rg
from repro.core import models as rmodels
from repro.core import partition as rp
from repro.core import quant as rquant
from repro.dist import sharding as rsharding
from repro.nn.common import Param
from repro.runtime import gnn_server as rserve
from repro_torch.core import graph as tg
from repro_torch.core import models as tmodels
from repro_torch.core import partition as tp
from repro_torch.core import quant as tquant
from repro_torch.dist import compress as tcompress
from repro_torch.dist import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shard_serve as ss
from repro_torch.runtime import gnn_server as tserve

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_rank as mr  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
WIRE_ATOL = 0.05
SPAWN_TIMEOUT_S = 120
RANK_SCRIPT = str(Path(__file__).resolve().parent / "torch_mesh_rank.py")


@contextlib.contextmanager
def one_thread():
    """The ranks run on one thread; the stacked forms they are held to
    bit for bit are computed likewise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _spawn_scenario(name):
    (shards, replicas), _ = mr.SCENARIOS[name]
    world = shards * replicas
    with tempfile.TemporaryDirectory() as out:
        ss.spawn_local(world, ["--scenario", name, "--out", out],
                       SPAWN_TIMEOUT_S, program=(RANK_SCRIPT,))
        return [(dict(np.load(f"{out}/rank{r}.npz")),
                 json.loads(Path(f"{out}/rank{r}.json").read_text()))
                for r in range(world)]


@pytest.fixture(scope="module")
def plan_ranks():
    return _spawn_scenario("plans")


@pytest.fixture(scope="module")
def replica_ranks():
    return _spawn_scenario("replicas")


@pytest.fixture(scope="module")
def decision_ranks():
    return _spawn_scenario("decisions")


# --------------------------------------------------- distribution rules

FAKE_MESHES = {"shard4": {"shard": 4}, "replica2x2": {"replica": 2,
                                                      "shard": 2},
               "pod16": {"data": 16, "model": 16},
               "multipod": {"pod": 2, "data": 16, "model": 16}}
AXES_CASES = [
    (("vocab", "embed"), (32000, 512)),          # split on model
    (("vocab", "embed"), (32001, 512)),          # indivisible: replicate
    (("embed", "ff"), (512, 1536)),
    (("heads", "ff"), (32, 1536)),               # model axis reused
    (("experts", "embed", "mlp"), (64, 512, 1024)),
    (("kv", "frames", None), (8, 1500, 64)),
    (("graph_shard", None, None), (4, 128, 12)),
    (("graph_replica", "graph_shard", None), (2, 2, 128)),
    (("graph_shard",), (3,)),                    # 3 shards on a 4-mesh
    (("ssm_in", "ssm_heads"), (2048, 64)),
]


def _fake(shape):
    return types.SimpleNamespace(shape=dict(shape))


@pytest.mark.parametrize("mesh_name", sorted(FAKE_MESHES))
@pytest.mark.parametrize("k", range(len(AXES_CASES)))
def test_spec_for_axes_equals_reference(mesh_name, k):
    """The spec of each tensor equals the reference's PartitionSpec on
    the same mesh shape, its fallbacks included: a missing axis, an axis
    an earlier dim took, a dim the axis size does not divide."""
    axes, shape = AXES_CASES[k]
    m = _fake(FAKE_MESHES[mesh_name])
    assert tsharding.spec_for_axes(axes, shape, m) == tuple(
        rsharding.spec_for_axes(axes, shape, m))


@pytest.mark.parametrize("expert_axis", ["model", "data", None])
def test_expert_axis_rule_equals_reference(expert_axis):
    m = _fake(FAKE_MESHES["pod16"])
    old_t, old_r = tsharding._EXPERT_AXIS, rsharding._EXPERT_AXIS
    try:
        tsharding.set_expert_axis(expert_axis)
        rsharding.set_expert_axis(expert_axis)
        for axes, shape in AXES_CASES:
            assert tsharding.spec_for_axes(axes, shape, m) == tuple(
                rsharding.spec_for_axes(axes, shape, m))
    finally:
        tsharding.set_expert_axis(old_t)
        rsharding.set_expert_axis(old_r)


@pytest.mark.parametrize("mesh_name", sorted(FAKE_MESHES))
def test_param_specs_equal_reference(mesh_name):
    """A hand-made axes tree over a parameter tree gives the specs the
    reference gives its Param tree of the same axes."""
    m = _fake(FAKE_MESHES[mesh_name])
    tree = {"embed": (("vocab", "embed"), (1024, 64)),
            "layers": {"attn": (("embed", "heads"), (64, 32)),
                       "mlp": (("embed", "mlp"), (64, 96)),
                       "moe": (("experts", "embed", "ff"), (16, 64, 48))},
            "norm": (("embed",), (64,))}

    def walk(t, f):
        return {k: walk(v, f) if isinstance(v, dict) else f(*v)
                for k, v in t.items()}

    params = walk(tree, lambda axes, shape: torch.zeros(shape))
    axes_tree = walk(tree, lambda axes, shape: axes)
    ref = rsharding.param_specs(
        walk(tree, lambda axes, shape: Param(jnp.zeros(shape), axes)), m)
    got = tsharding.param_specs(axes_tree, params, m)
    flat_ref = jax.tree_util.tree_leaves(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    flat_got = [got["embed"], got["layers"]["attn"], got["layers"]["mlp"],
                got["layers"]["moe"], got["norm"]]
    assert [tuple(p) for p in flat_ref] == flat_got


@pytest.mark.parametrize("mesh_name", sorted(FAKE_MESHES))
def test_batch_and_cache_specs_equal_reference(mesh_name):
    m = _fake(FAKE_MESHES[mesh_name])
    assert tsharding.mesh_batch_axes(m) == rsharding.mesh_batch_axes(m)
    for ndim in (1, 2, 3):
        assert tsharding.batch_spec(m, ndim=ndim) == tuple(
            rsharding.batch_spec(m, ndim=ndim))
    tree = {"k": np.zeros((32, 4, 8)), "v": np.zeros((33, 4)),
            "pos": np.zeros(())}
    for seq in (False, True):
        got = tsharding.cache_specs(tree, m, seq_sharded=seq)
        want = rsharding.cache_specs(tree, m, seq_sharded=seq)
        assert {k: tuple(v) for k, v in want.items()} == got


@pytest.mark.parametrize("n", [0, 6, 16, 32])
def test_choose_expert_axis_equals_reference(n):
    cfg = types.SimpleNamespace(num_experts=n)
    for shape in FAKE_MESHES.values():
        m = _fake(shape)
        assert tsharding.choose_expert_axis(cfg, m) == \
            rsharding.choose_expert_axis(cfg, m)


def test_distribution_contexts_are_identities():
    with tsharding.use_distribution("m") as m:
        assert m == "m"
    y = torch.zeros(4, 6, 2)
    assert tsharding.constrain_scan_slices(y) is y


@pytest.mark.parametrize("spec", [("shard", None), (None, "shard"),
                                  (("replica", "shard"), None)])
def test_local_block_cuts_this_ranks_block(spec):
    t = torch.arange(8 * 6).reshape(8, 6)
    mesh = types.SimpleNamespace(shape={"replica": 2, "shard": 2},
                                 coords={"replica": 1, "shard": 0})
    got = tsharding.local_block(t, spec, mesh)
    if spec == ("shard", None):
        assert torch.equal(got, t[:4])
    elif spec == (None, "shard"):
        assert torch.equal(got, t[:, :3])
    else:                                  # replica outer: block 1*2 + 0
        assert torch.equal(got, t[4:6])


# ------------------------------------------------------- mesh and device

def test_device_none_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.rank_device(None)
    assert tmesh.rank_device("cpu") == torch.device("cpu")


def test_init_distributed_refuses_what_it_cannot_do():
    with pytest.raises(ValueError, match="together"):
        tmesh.init_distributed(init_method="file:///nonexistent", rank=0)
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA"):
        tmesh.init_distributed(backend="nccl", init_method="file:///x",
                               rank=0, world_size=1, device="cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_shard_mesh(2, device="cpu")


def test_mesh_coordinates_and_groups(plan_ranks, replica_ranks):
    """The 1-D mesh of 2 and the 2 x 2 and 4 meshes of a world of 4: ranks
    fill them row-major, and a mesh larger than the world raises."""
    for r, (_, facts) in enumerate(plan_ranks):
        assert facts["coords"] == {"shard": r} and facts["shape"] == {
            "shard": 2} and facts["group_size"] == 2
    for r, (_, facts) in enumerate(replica_ranks):
        assert facts["coords22"] == {"replica": r // 2, "shard": r % 2}
        assert facts["coords4"] == {"shard": r}
        assert "needs 6 ranks, the world has 4" in facts["too_small"]
        assert "needs 256 ranks, the world has 4" in facts["production"]
        assert facts["host"] == {"data": 2, "model": 2}


# --------------------------------------------------------- collectives

EXACT_FORMS = ("pmax", "compressed_psum", "compressed_psum_mean",
               "compressed_psum_delta/True", "compressed_psum_delta/False",
               "halo_exchange/True", "halo_exchange/False", "assemble")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("form", EXACT_FORMS + ("psum", "exact_psum_mean"))
def test_group_forms_equal_stacked_forms(plan_ranks, replica_ranks, world,
                                         form):
    """Every group form against its stacked form on the same terms: bit
    for bit where the sum is exact in any order (disjoint blocks, the
    int8 wire's whole numbers, a max), within 1e-6 of the largest
    magnitude for an fp32 sum of overlapping terms."""
    ranks = plan_ranks if world == 2 else replica_ranks
    key = "collectives" if world == 2 else "collectives4"
    for _, facts in ranks:
        d = facts[key][form]
        if form in EXACT_FORMS:
            assert d == 0.0, (form, d)
        else:
            assert d <= 1e-6 * 4 * world, (form, d)


# ------------------------------------------------------------ the plans

def _ref_calibration(cal):
    if isinstance(cal, tquant.QuantizedLinear):
        return rquant.QuantizedLinear(**{f: jnp.asarray(getattr(cal, f)
                                                        .numpy())
                                         for f in ("wq", "w_scale",
                                                   "x_scale")})
    if isinstance(cal, dict):
        return {k: _ref_calibration(v) for k, v in cal.items()}
    return jnp.asarray(cal.numpy())


def _ref_cfg(cfg):
    return rmodels.GNNConfig(**dataclasses.asdict(cfg))


def _ref_plan(d, graphs, compress):
    """The reference's sharded plan (vmap-simulated on one CPU device)
    over one graph or one per replica row."""
    rcfg = _ref_cfg(d["cfg"])
    stacks = [rmodels.stack_shard_slices(rmodels.build_sharded_operands(
        rg.Graph(**dataclasses.asdict(g)),
        rp.GraphShards(**dataclasses.asdict(p)), rcfg)) for g, p in graphs]
    plan = rmodels.build_sharded_plan(rcfg, mr.BUCKET, graphs[0][1].shards,
                                      d["t"], compress=compress,
                                      replicas=len(graphs))
    params = jax.tree_util.tree_map(jnp.asarray, d["w"])
    cal = _ref_calibration(d["cal"]) if d["cal"] is not None else None
    if len(graphs) == 1:
        x, ops, mask = stacks[0]
    else:
        x = jnp.stack([s[0] for s in stacks])
        ops = rmodels.stack_operands([s[1] for s in stacks])
        mask = jnp.stack([s[2] for s in stacks])
    return np.asarray(plan(params, x, ops, cal, node_mask=mask))


def _stacked_plan(d, graphs, compress):
    """The port's single-process plan, the shard axis a leading dim."""
    with one_thread():
        stacks = [tmodels.stack_shard_slices(tmodels.build_sharded_operands(
            g, p, d["cfg"], device="cpu")) for g, p in graphs]
        plan = tmodels.build_sharded_plan(d["cfg"], mr.BUCKET,
                                          graphs[0][1].shards, d["t"],
                                          compress=compress,
                                          replicas=len(graphs), device="cpu")
        if len(graphs) == 1:
            x, ops, mask = stacks[0]
        else:
            x = torch.stack([s[0] for s in stacks])
            ops = tmodels.stack_operands([s[1] for s in stacks])
            mask = torch.stack([s[2] for s in stacks])
        return plan(d["params"], x, ops, d["cal"], node_mask=mask).numpy()


def _wire_close(got, want, *, strict):
    if strict:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        return
    np.testing.assert_allclose(got, want, atol=WIRE_ATOL, rtol=0)
    assert (got.reshape(-1, got.shape[-1]).argmax(-1)
            == want.reshape(-1, want.shape[-1]).argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("case,tier,compress", mr.PLAN_CASES)
def test_mesh_plan_equals_stacked_plan_and_reference(plan_ranks, case, tier,
                                                     compress):
    """Each rank's block equals its shard of the port's stacked plan bit
    for bit, its gather over the shard group equals the stacked plan's
    node-order logits, and both meet the reference's sharded plan."""
    with one_thread():
        d = mr.plan_inputs(case, tier)
    stacked = _stacked_plan(d, [(d["g"], d["part"])], compress)
    for r, (arrays, _) in enumerate(plan_ranks):
        np.testing.assert_array_equal(arrays[f"{case}|{tier}|{compress}"],
                                      stacked[r])
        np.testing.assert_array_equal(
            arrays[f"{case}|{tier}|{compress}|nodes"],
            tmodels.unshard_logits(torch.from_numpy(stacked), d["part"]))
    got = np.stack([a[f"{case}|{tier}|{compress}"] for a, _ in plan_ranks])
    _wire_close(got, _ref_plan(d, [(d["g"], d["part"])], compress),
                strict=(tier == "fp32" and not compress))


# the kernel entries one rank's forward calls under use_pallas, both
# layers: GCN X.W and the aggregation; GAT X.W and one attention product
# a head; SAGE the pool combine and the masked max (max) or the mean
# product, then the self and neighbour combines (int8 where quantized)
PALLAS_CALLS = {
    ("gcn", "fp32"): {"matmul": 4}, ("gcn", "int8"): {"int8_matmul": 4},
    ("gat", "fp32"): {"matmul": (1 + mr.HEADS) + (1 + 1)},
    ("gat", "int8"): {"int8_matmul": 2, "matmul": mr.HEADS + 1},
    ("sage_max", "fp32"): {"matmul": 6, "sage_max": 2},
    ("sage_max", "int8"): {"int8_matmul": 6, "sage_max": 2},
    ("sage_mean", "fp32"): {"matmul": 6},
    ("sage_mean", "int8"): {"matmul": 2, "int8_matmul": 4}}


@pytest.mark.parametrize("case,tier", mr.PALLAS_CASES)
def test_mesh_plan_routes_every_product_through_the_kernel_entries(
        plan_ranks, case, tier):
    """With `use_pallas` each rank's products go through `kops.matmul`
    (block_matmul), `kops.int8_matmul` and the rectangular `kops.sage_max`
    (their plain versions on the CPU), as many calls as one stacked
    dispatch makes; the logits equal the plain plan's at 1e-5."""
    want = dict.fromkeys(mr.KERNEL_ENTRIES, 0) | PALLAS_CALLS[(case, tier)]
    for arrays, facts in plan_ranks:
        assert facts["calls"][f"{case}|{tier}"] == want
        np.testing.assert_allclose(arrays[f"{case}|{tier}|pallas"],
                                   arrays[f"{case}|{tier}|False"], **TOL)


@pytest.mark.parametrize("case,tier", mr.REPLICA_CASES)
def test_replica_mesh_equals_stacked_replicas_and_reference(replica_ranks,
                                                            case, tier):
    """The 2 x 2 mesh, one graph per replica row: every rank holds the
    whole (R, S, C, classes) logits after the gather, equal to the port's
    two-replica stacked plan bit for bit, and to the reference's."""
    with one_thread():
        d = mr.plan_inputs(case, tier)
        g2 = mr.graph(190, 9)
        p2 = tp.partition_graph(g2.edge_index, 190, 2, shard_cap=mr.BUCKET)
    graphs = [(d["g"], d["part"]), (g2, p2)]
    stacked = _stacked_plan(d, graphs, False)
    for arrays, _ in replica_ranks:
        np.testing.assert_array_equal(arrays[f"{case}|{tier}|replicas"],
                                      stacked)
    _wire_close(stacked, _ref_plan(d, graphs, False),
                strict=(tier == "fp32"))


@pytest.mark.parametrize("case,tier,compress", mr.WIDE_CASES)
def test_four_shard_mesh_equals_stacked_plan(replica_ranks, case, tier,
                                             compress):
    with one_thread():
        d = mr.plan_inputs(case, tier, n=400, shards=4)
    stacked = _stacked_plan(d, [(d["g"], d["part"])], compress)
    for r, (arrays, _) in enumerate(replica_ranks):
        np.testing.assert_array_equal(
            arrays[f"{case}|{tier}|{compress}|wide"], stacked[r])
    got = np.stack([a[f"{case}|{tier}|{compress}|wide"]
                    for a, _ in replica_ranks])
    _wire_close(got, _ref_plan(d, [(d["g"], d["part"])], compress),
                strict=(tier == "fp32" and not compress))


def test_mesh_plan_refuses_a_mesh_of_another_shape():
    d = mr.plan_inputs("gcn", "fp32")
    mesh = types.SimpleNamespace(shape={"shard": 4}, device="cpu")
    with pytest.raises(ValueError, match="mesh of shape"):
        tmodels.build_sharded_plan(d["cfg"], mr.BUCKET, 2, d["t"],
                                   device="cpu", mesh=mesh)


@pytest.mark.parametrize("case", ["gcn", "gat"])
def test_sharded_operands_of_one_shard_equal_the_full_build(case):
    d = mr.plan_inputs(case, "fp32")
    full = tmodels.build_sharded_operands(d["g"], d["part"], d["cfg"],
                                          device="cpu")
    for s in range(d["part"].shards):
        (one,) = tmodels.build_sharded_operands(d["g"], d["part"], d["cfg"],
                                                device="cpu", shard=s)
        assert torch.equal(one.x, full[s].x)
        assert torch.equal(one.node_mask, full[s].node_mask)
        for f in tmodels.OPERAND_FIELDS[d["cfg"].kind]:
            assert torch.equal(getattr(one.ops, f), getattr(full[s].ops, f))


@pytest.mark.parametrize("case", ["gcn", "gat"])
def test_row_block_patch_equals_rows_of_the_whole_patch(case):
    """`patch_operands(row0=)` on each shard's row block equals those rows
    of the patch of the whole (full, full) matrices bit for bit."""
    d = mr.plan_inputs(case, "fp32")
    g, part = d["g"], d["part"]
    full, c = part.full_rows, part.shard_cap
    add, rm = ss._cross_delta(g, part, 30)
    pg = tg.pad_graph(g, capacity=full)
    delta = tg.apply_edge_delta(pg.adj, pg.norm_adj, g.num_nodes, add, rm)
    inv = np.empty((full,), np.int64)
    inv[part.perm] = np.arange(full)
    fields = tmodels.OPERAND_FIELDS[d["cfg"].kind]
    kt = 16

    def up(a, k=None, dtype=np.int32):
        a = np.asarray(a, dtype)
        if k is not None:
            a = np.concatenate([a, np.full((k - len(a),), a[0], dtype)])
        return torch.from_numpy(a)

    deg = tmodels.gcn_degree(delta.adj, g.num_nodes)[part.perm]
    spec = tmodels.DeltaSpec(
        flip_i=up(inv[delta.flip_i], 2 * kt), flip_j=up(inv[delta.flip_j],
                                                        2 * kt),
        flip_v=up(delta.flip_v, 2 * kt, np.float32),
        touched=up(np.sort(inv[delta.touched]), kt),
        degree=up(deg, dtype=np.float32), fields=fields)
    slices = tmodels.build_sharded_operands(g, part, d["cfg"], device="cpu")
    _, stacked, _ = tmodels.stack_shard_slices(slices)
    whole = tmodels.patch_operands(tmodels.GranniteOperands(**{
        f: getattr(stacked, f).reshape(full, full) for f in fields}), spec)
    changed = False
    for s, sl in enumerate(slices):
        block = tmodels.patch_operands(sl.ops, spec, row0=s * c)
        for f in fields:
            assert torch.equal(getattr(block, f),
                               getattr(whole, f)[s * c:(s + 1) * c])
            changed |= not torch.equal(getattr(block, f), getattr(sl.ops, f))
    assert changed


# ------------------------------------------------------------- serving

ENGINE_SPEC = ss.BurstSpec(kinds=("gcn", "gat", "sage-max", "sage-mean"),
                           nodes=200, feats=mr.IN_FEATS, hidden=mr.HIDDEN,
                           heads=mr.HEADS, classes=mr.CLASSES,
                           ladder=(mr.BUCKET,), shards=2, cal_nodes=100,
                           delta=True, grow=(90, 200), slots=2)


@pytest.fixture(scope="module")
def engine_ranks():
    """shard_serve's burst on 2 gloo ranks (both wires), each rank's
    output and logits, and the single-process port engine's on the same
    calls."""
    with tempfile.TemporaryDirectory() as out:
        texts = ss.spawn_local(2, ss.burst_args(ENGINE_SPEC) + [
            "--backend", "gloo", "--device", "cpu", "--out", out],
            SPAWN_TIMEOUT_S)
        ranks = [ss.last_json(t) for t in texts]
        logits = [{w: {k.replace("|", "/"): v for k, v in np.load(
            f"{out}/rank{r}_{w}.npz").items()} for w in ("off", "on")}
            for r in range(2)]
    with one_thread():
        single = ss.serve(ENGINE_SPEC, wires=(False, True), device="cpu")
    return ranks, logits, single


@pytest.mark.parametrize("wire", ["off", "on"])
def test_mesh_engine_equals_single_process_engine(engine_ranks, wire):
    """Every rank's answers equal the single-process engine's bit for bit
    (the lead answers every request, the others the sharded ones); the
    lead's counters (halo and collective bytes, batches, the delta's)
    equal it; each rank's checks hold (the patched blocks equal a mesh
    rebuild bit for bit); each rank caches about 1/S of the entry."""
    ranks, _, single = engine_ranks
    ref = single[wire]
    for o in ranks:
        got = o["wires"][wire]
        assert got["answers"] and all(ref["answers"][k] == v
                                      for k, v in got["answers"].items())
        assert got["checks"] == ref["checks"] and all(got["checks"].values())
        assert got["batch_log"] == ref["batch_log"]
        assert got["partitions"] == ref["partitions"]
        assert got["cache_resident_bytes"] < 0.6 * ref["cache_resident_bytes"]
    lead = ranks[0]["wires"][wire]
    assert set(lead["answers"]) == set(ref["answers"])
    assert set(ranks[1]["wires"][wire]["answers"]) == set(
        ref["answers"]) - {"grow/unsharded"}
    assert lead["summary"] == json.loads(json.dumps(ref["summary"]))
    assert lead["summary"]["delta_updates"] == 2
    assert lead["summary"]["rebucket_events"] == 2


def test_partitions_are_equal_on_every_rank(engine_ranks):
    """partition_for_ladder is deterministic: both ranks hold the partition
    this process makes, and the engine checked it at attach."""
    ranks, _, _ = engine_ranks
    g = ss.make_graph(ENGINE_SPEC.nodes, ENGINE_SPEC)
    part = tp.partition_for_ladder(
        g.edge_index, g.num_nodes, tg.BucketLadder(buckets=(mr.BUCKET,)),
        (2,))
    want = ss.digest(part.perm)
    for o in ranks:
        for w in ("off", "on"):
            assert set(o["wires"][w]["partitions"].values()) == {want}


def _ref_engine(compress):
    """The reference engine on ENGINE_SPEC's config and weights, with the
    single-process port engine's calibration."""
    sc = rserve.GraphServeConfig(
        ladder=rg.BucketLadder(buckets=(mr.BUCKET,)), batch_slots=2,
        return_logits=True, shard_counts=(2,), halo_compress=compress)
    ref = rserve.GraphServe(sc)
    port = ss.build_engine(ENGINE_SPEC, compress_halo=compress,
                           device="cpu")
    for kind in ENGINE_SPEC.kinds:
        cfg = ss.model_config(kind, ENGINE_SPEC)
        tiers = {tn: dataclasses.replace(t, use_pallas=False)
                 for tn, t in ss.serving_tiers(cfg.kind).items()}
        ref.register_model(kind, _ref_cfg(cfg), jax.tree_util.tree_map(
            jnp.asarray, ss.model_weights(cfg, ENGINE_SPEC.seed)),
            tiers=tiers)
        for tn, c in port.models[kind].calibrations.items():
            ref.models[kind].calibrations[tn] = _ref_calibration(c)
        ref.models[kind].accuracy_delta.update(
            port.models[kind].accuracy_delta)
    return ref


def _ref_burst(ref):
    """`shard_serve.run_burst`'s calls on the reference engine."""
    spec = ENGINE_SPEC
    out = {}
    big = ss.make_graph(spec.nodes, spec)
    rbig = rg.Graph(**dataclasses.asdict(big))
    gids = {k: ref.attach(rbig, model=k, calibrate=False)
            for k in spec.kinds}

    def serve(labels):
        ref.run()
        done = {r.uid: r for r in ref.finished}
        out.update({k: done[u].logits for k, u in labels.items()})

    serve({f"{k}/{tier}": ref.query(gid, tier=tier)
           for k, gid in gids.items() for tier in ss.TIERS})
    labels = {}
    for k in ("gcn", "gat"):
        part = ref._sharded[gids[k]][0]
        add, rm = ss._cross_delta(big, part, spec.seed + 30)
        assert ref.update_delta(gids[k], add_edges=add, remove_edges=rm)
        for tier in ss.TIERS:
            labels[f"{k}/{tier}/delta"] = ref.query(gids[k], tier=tier)
    serve(labels)
    small, mid = (rg.Graph(**dataclasses.asdict(ss.make_graph(n, spec)))
                  for n in spec.grow)
    gid = ref.attach(small, model="gcn", calibrate=False)
    ref.update(gid, mid.edge_index, mid.num_nodes, mid.features)
    serve({"grow/sharded": ref.query(gid)})
    ref.update(gid, small.edge_index, small.num_nodes, small.features)
    serve({"grow/unsharded": ref.query(gid)})
    return out, ref.summary()


def test_mesh_engine_matches_reference_engine(engine_ranks):
    """The lead's answers over the exact wire against the reference
    engine on the same calls (attach, queries of both tiers, a
    cross-shard update_delta, update() into the sharded path and back):
    the module's tolerance, and the counters exactly."""
    ranks, logits, _ = engine_ranks
    want, rs = _ref_burst(_ref_engine(False))
    got = logits[0]["off"]
    assert set(got) == set(want)
    for label, lg in got.items():
        _wire_close(lg, np.asarray(want[label]),
                    strict="int8" not in label)
    lead = ranks[0]["wires"]["off"]["summary"]
    for k in ("batches", "sharded_batches", "halo_bytes_exchanged",
              "collective_bytes_compressed", "collective_bytes_exact",
              "rebucket_events", "delta_updates", "delta_halo_bytes_exchanged",
              "delta_halo_bytes_full", "delta_dirty_rows"):
        assert lead[k] == rs[k], (k, lead[k], rs[k])


@pytest.mark.parametrize("what", ["tiers", "expired", "logits"])
def test_ranks_agree_when_their_clocks_differ(decision_ranks, what):
    """The ranks' fake clocks give their latency banks, governors and
    deadlines different views, yet every rank serves each request at the
    lead's tier, expires the lead's requests and answers bit for bit as
    a single-process engine on the lead's clock does."""
    with one_thread():
        single = mr.decisions_burst(mr.decisions_engine(0))
    served = [facts["served"] for _, facts in decision_ranks]
    for r, (arrays, facts) in enumerate(decision_ranks):
        for u, (tier, expired, lg) in single.items():
            got_tier, got_expired = facts["served"][str(u)]
            if what == "tiers":
                assert got_tier == tier, (r, u)
            elif what == "expired":
                assert got_expired == expired, (r, u)
            elif lg is not None:
                np.testing.assert_array_equal(arrays[str(u)], lg)
    if what == "tiers":
        # the clocks do disagree: the lead routes some request to int8,
        # a rank alone on the other clock would have served it fp32
        tiers = {t for t, _ in served[0].values()}
        assert tiers == {"fp32", "int8"}
    if what == "expired":
        assert any(e for _, e in served[0].values())
        assert any(not e for _, e in served[0].values())


def test_other_clock_alone_decides_otherwise():
    """The premise of the test above: an engine on rank 1's clock alone
    serves the same calls at other tiers or expiries than the lead's."""
    with one_thread():
        lead = mr.decisions_burst(mr.decisions_engine(0))
        other = mr.decisions_burst(mr.decisions_engine(1))
    assert [(t, e) for t, e, _ in lead.values()] != \
        [(t, e) for t, e, _ in other.values()]


def test_ranks_take_the_leads_admission_decision(decision_ranks):
    """Under a byte budget with admission="reject", the lead alone holds
    an unsharded graph's entry, which overflows the budget for a sharded
    graph on the lead but not on the other rank: every rank refuses it
    as the lead does, numbers the graphs alike, and answers a later query
    of that graph as the clock-skewed burst's fp32 query of it."""
    (_, lead), (_, other) = decision_ranks
    la, oa = lead["admission"], other["admission"]
    assert la["resident"] + la["shard_bytes"] > la["budget"]
    assert oa["resident"] + oa["shard_bytes"] <= oa["budget"]
    for arrays, facts in decision_ranks:
        a = facts["admission"]
        assert a["refused"] and a["rejects"] == 1
        assert a["gids"] == la["gids"]
        np.testing.assert_array_equal(arrays["admission"],
                                      arrays[facts["fp32_uid"]])


def test_pipeline_refuses_a_mesh(decision_ranks):
    """No longer refused: every rank of the mesh opens the deterministic
    pipeline, serves an fp32 query through it bit-equal to the sync
    path's fp32 answer of the same graph, and completes what it accepted
    (`tests/test_torch_mesh_pipeline.py` holds the pipeline on a mesh)."""
    for arrays, facts in decision_ranks:
        np.testing.assert_array_equal(arrays["pipeline"],
                                      arrays[facts["fp32_uid"]])
        assert facts["pipeline"]["accepted"] == \
            facts["pipeline"]["completed"] == 1


def test_engine_refuses_a_mesh_it_cannot_serve():
    mesh = types.SimpleNamespace(shape={"shard": 2}, device="cpu")
    with pytest.raises(ValueError, match="shard_counts must be"):
        tserve.GraphServe(tserve.GraphServeConfig(shard_counts=(2, 4)),
                          device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="replica_groups"):
        tserve.GraphServe(tserve.GraphServeConfig(shard_counts=(2,),
                                                  replica_groups=2),
                          device="cpu", mesh=mesh)


def test_timed_all_reduces_wraps_the_collective_and_restores_it(
        monkeypatch):
    """`shard_serve.timed_all_reduces` wraps `dist.compress`'s all_reduce
    only while it is open; a CPU tensor passes through untimed."""
    seen = []

    def fake(t, op, group):
        seen.append(group)
        return t
    monkeypatch.setattr(tcompress, "_all_reduce", fake)
    spans = []
    with ss.timed_all_reduces(spans):
        assert tcompress._all_reduce is not fake
        out = tcompress.psum(torch.ones(3), "g")
    assert tcompress._all_reduce is fake
    assert seen == ["g"] and spans == []
    assert torch.equal(out, torch.ones(3))


# ------------------------------------------------------------- failures

def test_spawn_local_kills_the_ranks_of_a_failed_rank():
    """A rank that exits with an error ends the group at once: the other
    ranks (here asleep, as a rank waiting in a collective would be) are
    killed and the error names the failed rank."""
    prog = ("-c", "import sys, time\n"
            "if sys.argv[sys.argv.index('--rank') + 1] == '1':\n"
            "    raise SystemExit('rank 1 failed')\n"
            "time.sleep(60)\n")
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited"):
        ss.spawn_local(2, [], 30, program=prog)


def test_spawn_local_kills_hung_ranks_at_its_timeout():
    prog = ("-c", "import time; time.sleep(60)")
    with pytest.raises(TimeoutError, match="still running"):
        ss.spawn_local(2, [], 1.0, program=prog)
