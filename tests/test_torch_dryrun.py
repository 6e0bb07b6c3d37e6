"""PyTorch port, the dry run: `launch/specs.py`, `launch/roofline.py` and
`launch/dryrun.py` (the counterparts of the reference's units in
`tests/test_launch.py`), on meta tensors, with no card and no JAX in the
port.

Cells run here at full shapes (`SHAPES`) but reduced widths and depths
(`configs.reduced`), so that a step runs in seconds; the full cells run
with `python -m repro_torch.launch.dryrun --all --mesh both`. Everything
is exact: shapes, counts, bytes and the pricer's arithmetic.
"""
import dataclasses
import math

import pytest
import torch

from repro.configs import ARCHS as RARCHS
from repro.launch import roofline as rroof
from repro.launch import specs as rspecs
from repro.nn.config import SHAPES as RSHAPES
from repro_torch.ckpt import tree_items
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import costs
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import abstract_mesh, production_shape
from repro_torch.nn.config import SHAPES


def test_runnable_rules():
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            assert S.runnable(ARCHS[arch], shape) == rspecs.runnable(
                RARCHS[arch], RSHAPES[name])
    ok, why = S.runnable(ARCHS["qwen3-4b"], SHAPES["long_500k"])
    assert not ok and "sub-quadratic" in why


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_shapes(arch):
    """Every cell's inputs are meta tensors of the reference's shapes and
    dtypes."""
    cfg, rcfg = ARCHS[arch], RARCHS[arch]
    for name, shape in SHAPES.items():
        if not S.runnable(cfg, shape)[0]:
            continue
        got = dict(tree_items(S.input_specs(cfg, shape)))
        want = dict(tree_items(rspecs.input_specs(rcfg, RSHAPES[name])))
        assert got.keys() == want.keys(), (name, got.keys() ^ want.keys())
        for key, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[key].shape), (name, key)
            assert str(t.dtype).split(".")[-1] == str(want[key].dtype), key


def test_microbatch_policy():
    for n_data in (16, 32):
        for name in ("train_4k", "prefill_32k"):
            assert S.train_microbatches(ARCHS["gemma2-27b"], SHAPES[name],
                                        n_data) == rspecs.train_microbatches(
                RARCHS["gemma2-27b"], RSHAPES[name], n_data)


def test_roofline_terms_price_the_h100():
    """One second each at the H100's rates (core/costs.py, no TPU
    number)."""
    t = R.RooflineTerms(arch="a", shape="train_4k", mesh="single",
                        flops_per_device=costs.PEAK_BF16,
                        bytes_per_device=costs.HBM_BW,
                        coll_bytes_per_device=costs.DEVICE_LINK_BYTES_PER_S,
                        coll_breakdown={},
                        model_flops=costs.PEAK_BF16 * 256, n_devices=256)
    assert abs(t.t_compute - 1.0) < 1e-12
    assert abs(t.t_memory - 1.0) < 1e-12
    assert abs(t.t_collective - 1.0) < 1e-12
    assert t.useful_flops_fraction == 1.0 and t.roofline_fraction == 1.0
    t.bytes_per_device *= 2
    assert t.bottleneck == "memory" and t.roofline_fraction == 0.5
    assert costs.PEAK_BF16 == 989e12 and R.PEAK_BF16 is costs.PEAK_BF16
    assert not hasattr(R, "ICI_BW") and not hasattr(R, "DCN_BW")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma2-27b",
                                  "jamba-v0.1-52b"])
def test_model_flops_equal_reference(arch):
    for name in SHAPES:
        assert R.model_flops_estimate(ARCHS[arch], SHAPES[name]) == \
            rroof.model_flops_estimate(RARCHS[arch], RSHAPES[name])
    f = R.model_flops_estimate(ARCHS["olmoe-1b-7b"], SHAPES["train_4k"])
    assert f < 6.0 * ARCHS["olmoe-1b-7b"].param_count() * 256 * 4096 / 3


def test_fmt_seconds():
    assert [R.fmt_seconds(t) for t in (2.5, 0.0125, 3e-6)] == [
        rroof.fmt_seconds(t) for t in (2.5, 0.0125, 3e-6)]


CELLS = [("smollm-135m", "train_4k", "single"),
         ("olmoe-1b-7b", "decode_32k", "multi"),
         ("mamba2-2.7b", "long_500k", "single"),
         ("whisper-base", "prefill_32k", "single")]


def _small(arch):
    """The reduced config, with the arch's own loss chunk (reduced's 64
    would cut a 4096-token row into 64 checkpointed chunks)."""
    return dataclasses.replace(reduced(ARCHS[arch]),
                               loss_chunk=ARCHS[arch].loss_chunk)


_TRAIN_ROWS = {}


def _run_small(arch, shape_name, mesh_name, **kw):
    """`run_cell` with the arch's reduced config in `ARCHS`' place."""
    saved = D.ARCHS[arch]
    D.ARCHS[arch] = _small(arch)
    try:
        return D.run_cell(arch, shape_name, mesh_name, verbose=False, **kw)
    finally:
        D.ARCHS[arch] = saved


def _train_row():
    if not _TRAIN_ROWS:
        _TRAIN_ROWS["row"] = _run_small("smollm-135m", "train_4k", "single",
                                        with_cost=False)
    return _TRAIN_ROWS["row"]


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_run_cell_on_a_reduced_config(cell):
    """A reduced config through the real cell: every row field, argument
    bytes from the specs, operations above the model's, collectives on
    the wire, the expert axis put back."""
    arch, shape_name, mesh_name = cell
    cfg = _small(arch)
    before = shd._EXPERT_AXIS
    row = (_train_row() if shape_name == "train_4k" else
           _run_small(arch, shape_name, mesh_name, with_cost=False))
    assert shd._EXPERT_AXIS == before
    assert row["status"] == "ok", row.get("traceback")
    shape = SHAPES[shape_name]
    mesh = abstract_mesh(*production_shape(mesh_name == "multi"))
    n = math.prod(mesh.shape.values())
    assert row["devices"] == n
    assert row["temp_bytes_per_dev"] is None
    assert row["arg_bytes_per_dev"] == sum(row["arg_bytes_by_part"].values())
    assert row["flops_per_dev"] > 0 and row["bytes_per_dev"] > 0
    assert row["coll_bytes_per_dev"] > 0
    assert row["model_flops"] == R.model_flops_estimate(cfg, shape)
    for key in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert row[key] > 0
    assert row["bottleneck"] in ("compute", "memory", "collective")
    # the parameters' bytes per rank, from the specs
    place_specs = D.lm_placement(cfg, mesh).specs
    params = S.abstract_params(cfg, serve=shape.kind != "train")
    want = sum(math.prod(shd.block_shape(tuple(t.shape), s, mesh))
               * t.element_size() for (_, t), (_, s) in zip(
                   tree_items(params),
                   tree_items(place_specs, is_leaf=lambda x: type(x) is
                              tuple)))
    assert row["arg_bytes_by_part"]["params"] == want


def test_train_cell_arguments_and_collectives():
    """smollm reduced, train_4k on (16, 16): float32 parameters and both
    moments in blocks, the rank's 16 rows of the batch; every rank of a
    model group gathers, the data group sums the gradients."""
    row = _train_row()
    parts = row["arg_bytes_by_part"]
    assert parts["opt"] == 2 * parts["params"] + 4
    assert parts["batch"] == 3 * 16 * 4096 * 4
    assert row["microbatches"] == 8
    assert set(row["coll_breakdown"]) >= {"all_reduce/model",
                                          "all_reduce/data"}
    # ZeRO-3 over "model": every rank computes its rows through the whole
    # model, so at most 1/16 of the operations is useful
    assert row["useful_fraction"] < 1 / 16


def test_cost_config_is_linear_in_superblocks():
    """The two-point check: a cell's counts at k = 1, 2, 3 superblocks
    step by the same amount, and the check's extrapolation equals the
    full count."""
    cfg = dataclasses.replace(_small("gemma2-27b"), num_layers=6)
    mesh = abstract_mesh(*production_shape(False))
    c1, c2 = S.cost_config(cfg, 1), S.cost_config(cfg, 2)
    assert c1.num_layers == 2 and c2.num_layers == 4
    assert S.cost_config(ARCHS["whisper-base"],
                         2).encoder.num_layers == 2
    m = [D.measure(D.lower_cell(S.cost_config(cfg, k), "prefill_32k",
                                mesh)[0], mesh) for k in (1, 2, 3)]
    for key in ("flops", "bytes"):
        assert m[2][key] - m[1][key] == m[1][key] - m[0][key], key
    exact = D.measure_cost_metrics(cfg, "prefill_32k", mesh)
    full = D.measure(D.lower_cell(cfg, "prefill_32k", mesh)[0], mesh)
    assert exact["flops"] == full["flops"]


LINEAR_CELLS = [("smollm-135m", "train_4k"), ("olmoe-1b-7b", "train_4k"),
                ("whisper-base", "prefill_32k")]


@pytest.mark.parametrize("cell", LINEAR_CELLS, ids=["-".join(c)
                                                    for c in LINEAR_CELLS])
def test_two_point_count_reaches_the_full_count(cell):
    """At 4 superblocks (and a 4-layer encoder) the two points' line
    reaches the full count: a training step's gradients of the stacked
    leaves are stacked once (`transformer.unstack_blocks`), not summed
    over one stack-sized gradient a superblock."""
    arch, shape_name = cell
    cfg = S.cost_config(_small(arch), 4)
    mesh = abstract_mesh(*production_shape(False))
    exact = D.measure_cost_metrics(cfg, shape_name, mesh)
    full = D.measure(D.lower_cell(cfg, shape_name, mesh)[0], mesh)
    for key in ("flops", "bytes"):
        assert exact[key] == full[key], key


def test_a_cell_off_its_two_point_line_fails(monkeypatch):
    """A cell whose two-point extrapolation misses the full count is
    FAILED: the port counts every superblock, so the two must agree."""
    real = D.measure_cost_metrics

    def off(*a, **k):
        out = real(*a, **k)
        return dict(out, flops=out["flops"] * (1 + 1e-6))
    monkeypatch.setattr(D, "measure_cost_metrics", off)
    row = _run_small("whisper-base", "prefill_32k", "single")
    assert row["status"] == "FAILED" and not row["two_point_linear"]
    assert "two-point" in row["error"]
    monkeypatch.setattr(D, "measure_cost_metrics", real)
    row = _run_small("whisper-base", "prefill_32k", "single")
    assert row["status"] == "ok" and row["two_point_linear"]


def test_skipped_and_failed_cells(monkeypatch, capsys):
    row = D.run_cell("qwen3-4b", "long_500k", "single", verbose=False)
    assert row["status"] == "skipped"

    def broken(*a, **k):
        raise RuntimeError("no such shape")
    monkeypatch.setattr(D, "lower_cell", broken)
    row = _run_small("smollm-135m", "train_4k", "single")
    assert row["status"] == "FAILED" and "no such shape" in row["error"]
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "smollm-135m", "--shape", "prefill_32k",
                "--skip-cost"])
    assert e.value.code == 1
    assert "1 FAILED" in capsys.readouterr().out


def test_only_the_baseline_variant():
    with pytest.raises(SystemExit):
        D.main(["--arch", "smollm-135m", "--variant", "opt"])
    with pytest.raises(ValueError):
        with D.apply_variant(ARCHS["olmoe-1b-7b"], "opt", None):
            pass


def test_flop_counter_sees_the_attention_kernel():
    """The meta route's work joins FlopCounterMode's count: a prefill's
    operations exceed the counter's own by the kernel's formula."""
    cfg = _small("smollm-135m")
    mesh = abstract_mesh(*production_shape(False))
    run, _, _ = D.lower_cell(cfg, "prefill_32k", mesh)
    from repro_torch.kernels import flash_attention as fa
    w0 = fa.META_WORK["flops"]
    m = D.measure(run, mesh)
    attn = fa.META_WORK["flops"] - w0
    rows = 32 // 16
    per_layer, _ = fa.forward_work((rows, 32768, cfg.num_heads,
                                    cfg.head_dim_),
                                   (rows, 32768, cfg.num_kv_heads,
                                    cfg.head_dim_))
    assert attn == cfg.num_layers * per_layer
    assert m["flops"] > attn
    assert torch.device("meta").type == "meta"
