"""PyTorch port, the LM's placement: the logical axes of every parameter
(`nn.lm.lm_axes` and the per-module `*_axes`), the specs they give on the
production meshes, the meta-device trees (`launch.specs.abstract_params`),
the placement helpers of `dist/sharding.py` (`gather`, `Placement`,
`optimizer_specs`, `batch_specs`, `block_shape`), the abstract mesh and
its recording collectives (`launch.mesh.abstract_mesh`,
`dist.compress.AbstractGroup`), and `flash_attention`'s meta route.

The axes are held against the reference: for every arch of `ARCHS` at
full size, on the (16, 16) and (2, 16, 16) meshes, each leaf's spec from
`param_specs(lm_axes(cfg), abstract_params(cfg), mesh)` equals the
reference's `param_specs` of the same leaf over `jax.eval_shape` of its
`lm_init` (both given the same stub mesh, which has only `.shape`), with
the key sets equal, under each expert axis the reference's dry run sets.
Everything else is exact: shapes, counts, bytes.
"""
import types

import jax
import pytest
import torch

from repro.configs import ARCHS as RARCHS
from repro.dist import sharding as rsharding
from repro.nn import lm as rlm
from repro.nn.common import Param
from repro_torch.ckpt import tree_items
from repro_torch.configs import ARCHS
from repro_torch.dist import sharding as tsharding
from repro_torch.dist.compress import AbstractGroup, psum
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as kref
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import abstract_mesh, production_shape
from repro_torch.nn import lm as tlm
from repro_torch.nn.common import is_axes
from repro_torch.nn.config import SHAPES
from repro_torch.runtime.trainer import lm_placement

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
_REF_TREES = {}


def _stub(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def _ref_tree(arch):
    if arch not in _REF_TREES:
        _REF_TREES[arch] = jax.eval_shape(
            lambda: rlm.lm_init(jax.random.PRNGKey(0), RARCHS[arch]))
    return _REF_TREES[arch]


@pytest.mark.parametrize("expert_axis", ["model", "data"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_reference(arch, mesh_name, expert_axis):
    m = _stub(mesh_name)
    old_t, old_r = tsharding._EXPERT_AXIS, rsharding._EXPERT_AXIS
    try:
        tsharding.set_expert_axis(expert_axis)
        rsharding.set_expert_axis(expert_axis)
        cfg = ARCHS[arch]
        got = tsharding.param_specs(tlm.lm_axes(cfg), S.abstract_params(cfg),
                                    m)
        want = rsharding.param_specs(_ref_tree(arch), m)
    finally:
        tsharding.set_expert_axis(old_t)
        rsharding.set_expert_axis(old_r)
    got = dict(tree_items(got, is_leaf=is_axes))
    want = {k: tuple(v) for k, v in tree_items(
        want, is_leaf=lambda n: isinstance(n, jax.sharding.PartitionSpec))}
    assert got.keys() == want.keys()
    assert got == want


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_axes_tree_has_the_init_structure(arch):
    """lm_axes has lm_init's keys, one name per dim, the stacked leaves
    led by "layers", and the reference's names leaf for leaf."""
    cfg = ARCHS[arch]
    params = dict(tree_items(S.abstract_params(cfg)))
    axes = dict(tree_items(tlm.lm_axes(cfg), is_leaf=is_axes))
    assert params.keys() == axes.keys()
    for key, t in params.items():
        assert len(axes[key]) == t.dim(), key
        assert (axes[key][0] == "layers") == key.startswith(
            ("stack/", "encoder/stack/")), key
    ref = {k: p.axes for k, p in tree_items(
        _ref_tree(arch), is_leaf=lambda n: isinstance(n, Param))}
    assert {k: tuple(v) for k, v in ref.items()} == axes


# parameters param_count leaves out: norm scales and biases, qk-norms,
# the SSM's per-head vectors, its gated norm and conv bias
_UNCOUNTED = ("scale", "bias", "q_norm", "k_norm", "a_log", "d_skip",
              "dt_bias", "mixer/norm", "conv_b")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_count_equals_param_count(arch):
    """On the meta device, nothing drawn: the counted leaves sum to
    cfg.param_count() exactly; training is float32, serving bfloat16."""
    cfg = ARCHS[arch]
    train, serve = S.abstract_params(cfg), S.abstract_params(cfg, serve=True)
    leaves = dict(tree_items(train))
    counted = sum(t.numel() for k, t in leaves.items()
                  if not k.endswith(_UNCOUNTED))
    assert counted == cfg.param_count()
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in leaves.values())
    assert all(t.dtype == torch.bfloat16 for _, t in tree_items(serve))
    opt = S.abstract_opt(cfg)
    assert [t.shape for _, t in tree_items(opt["m"])] == [
        t.shape for t in leaves.values()]


def test_moe_active_parameters():
    """olmoe: top-8 of 64 experts a token (the reference's count)."""
    cfg = ARCHS["olmoe-1b-7b"]
    assert cfg.active_param_count() == RARCHS["olmoe-1b-7b"].active_param_count()
    assert cfg.active_param_count() < cfg.param_count() / 3


def test_optimizer_and_batch_specs():
    m = _stub("multi")
    specs = {"w": ("data", None)}
    assert tsharding.optimizer_specs(specs) == {"m": specs, "v": specs,
                                                "count": ()}
    batch = {"tokens": torch.empty(64, 8, device="meta"),
             "odd": torch.empty(3, 8, device="meta"),
             "pos": torch.empty((), device="meta")}
    got = tsharding.batch_specs(batch, m)
    # the reference's batch_shardings: batch_spec where dim 0 divides
    assert got == {"tokens": tuple(rsharding.batch_spec(m, ndim=2)),
                   "odd": (), "pos": ()}
    assert got["tokens"] == (("pod", "data"), None)


def test_block_shape():
    m = abstract_mesh(*production_shape(multi_pod=True))
    assert tsharding.block_shape((64, 48), (("pod", "data"), "model"),
                                 m) == (2, 3)
    assert tsharding.block_shape((5, 7), (None, None), m) == (5, 7)


def test_abstract_mesh_groups_record_and_move_nothing():
    mesh = abstract_mesh(*production_shape(multi_pod=True))
    assert mesh.device.type == "meta" and mesh.is_first
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    g = mesh.group("pod", "data")
    assert isinstance(g, AbstractGroup) and g.size == 32
    assert mesh.group("pod", "data", "model").size == 512
    t = torch.empty(10, 4, device="meta")
    assert psum(t, g) is t and g.handed == [160]


def test_gather_on_an_abstract_mesh():
    """The forward assembles the full shape; the backward is this rank's
    block of the gradient; a spec that splits a data axis sums the
    gradient over it first (recorded); a spec that splits nothing is the
    block itself."""
    mesh = abstract_mesh((2, 4), ("data", "model"))
    block = torch.empty(3, 8, device="meta", requires_grad=True)
    full = tsharding.gather(block, (None, "model"), mesh)
    assert full.shape == (3, 32)
    (g,) = torch.autograd.grad(full.sum(), block)
    assert g.shape == (3, 8)
    assert mesh.group("model").handed == [3 * 32 * 4]
    assert not mesh.group("data").handed
    full = tsharding.gather(block, ("data", "model"), mesh)
    (g,) = torch.autograd.grad(full.sum(), block)
    assert full.shape == (6, 32) and g.shape == (3, 8)
    assert mesh.group("data").handed == [6 * 32 * 4]
    assert tsharding.gather(block, (None, None), mesh) is block


def test_placement_rows_and_blocks():
    mesh = abstract_mesh((2, 2), ("data", "model"))
    place = lm_placement(ARCHS["smollm-135m"], mesh)
    assert place.data_axes == ("data",) and place.data_size == 2
    rows = place.rows({"tokens": torch.empty(8, 5, device="meta"),
                       "odd": torch.empty(3, device="meta")})
    assert rows["tokens"].shape == (4, 5) and rows["odd"].shape == (3,)
    # SmolLM's 9 heads do not split on 2; its MLP, vocab do
    assert place.specs.stack[0]["mixer"].wq == (None, None, None, None)
    assert place.specs.stack[0]["mlp"].w_in == (None, None, "model")
    assert place.specs.embed == ("model", None)


def test_flash_attention_meta_route():
    """Meta operands: the shapes come back, nothing is launched, the
    kernel's work is recorded; the backward too. A device other than the
    CPU, CUDA or meta raises."""
    q = torch.empty(2, 64, 4, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.empty(2, 64, 2, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    before = dict(fa.META_WORK), fa.LAUNCHES, fa.BWD_LAUNCHES
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape and out.device.type == "meta"
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert dq.shape == q.shape and dk.shape == k.shape
    ops, nbytes = fa.forward_work(q.shape, k.shape, causal=True)
    bops, bbytes = fa.backward_work(q.shape, k.shape, causal=True)
    assert ops == 4.0 * 64 * 2 * 4 * (64 * 65 // 2)
    assert bops == ops * 2.5
    assert fa.META_WORK["flops"] - before[0]["flops"] == ops + bops
    assert fa.META_WORK["calls"] - before[0]["calls"] == 2
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before[1:]
    x = q.detach().to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(torch.empty(1, 4, 2, 64), x[:1, :4, :2],
                           x[:1, :4, :2])


@pytest.mark.parametrize("case", ["causal", "window", "offset", "full"])
def test_work_formula_counts_the_mask(case):
    """The pair count against a dense count of the reference mask."""
    opts = {"causal": dict(causal=True), "window": dict(causal=True,
                                                        window=5),
            "offset": dict(causal=True, q_offset=7),
            "full": dict(causal=False)}[case]
    sq, skv = 9, 16
    q = torch.arange(sq)[:, None] + opts.get("q_offset", 0)
    k = torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if opts["causal"]:
        mask &= k <= q
    if opts.get("window"):
        mask &= k > q - opts["window"]
    ops, _ = fa.forward_work((1, sq, 1, 8), (1, skv, 1, 8), **opts)
    assert ops == 4.0 * 8 * int(mask.sum())
    ref = kref.flash_attention_ref   # the plain version the route mirrors
    assert callable(ref)


def test_shapes_equal_reference():
    from repro.nn.config import SHAPES as RSHAPES
    assert {k: (v.seq_len, v.global_batch, v.kind, v.is_decode)
            for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind, v.is_decode)
        for k, v in RSHAPES.items()}
