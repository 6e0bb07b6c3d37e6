"""The dry run: every (architecture x input shape x mesh) cell of the LM,
run as one rank of a production mesh on meta tensors, and priced for the
H100.

Port of the reference's `launch/dryrun.py`. Where the reference lowers
and compiles each cell for 512 placeholder devices, the port runs the
cell's step once as the origin rank of an `abstract_mesh` ((16, 16)
"single" or (2, 16, 16) "multi"), on tensors of the `meta` device: every
operation checks its shapes and computes nothing, the kernel wrappers
take their meta route, and each collective records what it was handed
and moves nothing. A cell that raises is FAILED, and the run exits 1.

A row gives, per rank: the argument bytes (its blocks of the parameters,
the moments, the batch and the caches, exact from the specs), the
operations (`torch.utils.flop_counter.FlopCounterMode`, the attention by
the kernel's own formula, `kernels.flash_attention.META_WORK`), the bytes
every eager operation reads and writes (`OpBytes`), the collective bytes
on the wire, the three H100 time terms, the bottleneck,
`useful_fraction` and `roofline_fraction` (`launch/roofline.py`).
Temporary bytes are null: meta tensors cannot measure them.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --jobs 8 --out build/dryrun.jsonl

Meta tensors run on the host, about 0.1 ms an operation: a training
cell takes 10-140 s on one core, the whole of `--all --mesh both` about
1,100 core-seconds, so `--jobs N` runs N cells at once.

The compute of this port is ZeRO-3 over "model" (`dist.sharding`): every
rank of a model group computes its data rows through the whole model, so
`useful_fraction` is near 1 / (the model axis's size) by design.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import multiprocessing
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.ckpt import tree_items
from repro_torch.configs import ARCHS
from repro_torch.dist import sharding as shd
from repro_torch.dist.compress import AbstractGroup, ring_psum_nbytes
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import abstract_mesh, production_shape
from repro_torch.nn.config import SHAPES
from repro_torch.runtime.trainer import lm_placement, train_state_specs

MESHES = {"single": False, "multi": True}
VARIANTS = ("baseline",)
# operations that alias or allocate and move no bytes
_NO_BYTES = {torch.ops.aten.detach.default, torch.ops.aten.alias.default,
             torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default,
             torch.ops.aten.new_empty.default,
             torch.ops.aten._unsafe_view.default,
             torch.ops.aten.lift_fresh.default}


class OpBytes(TorchDispatchMode):
    """Sums the bytes every operation reads (its tensor arguments) and
    writes (its tensor results), views and allocations aside: the memory
    traffic of eager execution, where nothing fuses."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_BYTES:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def _block_bytes(tree, specs, mesh) -> int:
    """Bytes of this rank's blocks of `tree`'s tensors under `specs`."""
    sizes = shd.map_specs(
        lambda t, s: math.prod(shd.block_shape(tuple(t.shape), s, mesh))
        * t.element_size(), tree, specs)
    return sum(v for _, v in tree_items(sizes))


def _blocks(tree, specs, mesh):
    """Meta tensors of this rank's block shapes."""
    return shd.map_specs(lambda t, s: torch.empty(
        shd.block_shape(tuple(t.shape), s, mesh), dtype=t.dtype,
        device="meta"), tree, specs)


def lower_cell(cfg, shape_name: str, mesh):
    """Build one cell on `mesh`: (run, argument bytes by part, aux), where
    run() runs the step once on this rank's meta blocks."""
    shape = SHAPES[shape_name]
    place = lm_placement(cfg, mesh)
    params = S.abstract_params(cfg, serve=(shape.kind != "train"))
    pblocks = _blocks(params, place.specs, mesh)
    args = {"params": _block_bytes(params, place.specs, mesh)}
    if shape.kind == "train":
        opt = S.abstract_opt(cfg)
        ospecs = train_state_specs(place)["opt"]
        oblocks = _blocks(opt, ospecs, mesh)
        batch = S.train_batch_specs(cfg, shape)
        mb = S.train_microbatches(cfg, shape, shd.data_size(mesh))
        step_fn = S.make_train_step(cfg, microbatches=mb, mesh=mesh)
        args["opt"] = _block_bytes(opt, ospecs, mesh)
        args["batch"] = _block_bytes(batch, shd.batch_specs(batch, mesh),
                                     mesh)

        def run():
            return step_fn(pblocks, oblocks, batch, torch.tensor(0))
        return run, args, {"microbatches": mb}

    if shape.kind == "prefill":
        batch = S.prefill_specs(cfg, shape)
        step_fn = S.make_prefill_step(cfg, shape, mesh=mesh)
        args["batch"] = _block_bytes(batch, shd.batch_specs(batch, mesh),
                                     mesh)
        return (lambda: step_fn(pblocks, batch)), args, {}

    specs = S.decode_specs(cfg, shape)
    seq_sharded = shape.global_batch < shd.data_size(mesh)
    blocks = {}
    for name in ("caches", "enc_kv"):
        if name in specs:
            cspecs = shd.cache_specs(specs[name], mesh, batch_dim=1,
                                     seq_sharded=seq_sharded)
            blocks[name] = _blocks(specs[name], cspecs, mesh)
            args[name] = _block_bytes(specs[name], cspecs, mesh)
    token = {"token": specs["token"]}
    args["batch"] = _block_bytes(token, shd.batch_specs(token, mesh),
                                 mesh) + 4
    step_fn = S.make_serve_step(cfg, shape, mesh=mesh)

    def run():
        return step_fn(pblocks, blocks["caches"], specs["token"],
                       specs["pos"], blocks.get("enc_kv"))
    return run, args, {"seq_sharded_cache": seq_sharded}


def measure(run, mesh) -> Dict[str, Any]:
    """Run a cell once: (operations, bytes, collective wire bytes by
    group) for this rank."""
    groups = [g for g in mesh.groups.values() if isinstance(g,
                                                            AbstractGroup)]
    for g in groups:
        g.handed.clear()
    work0 = dict(fa.META_WORK)
    with FlopCounterMode(display=False) as flops, OpBytes() as opb:
        run()
    coll = {}
    for g in groups:
        if g.handed:
            wire = sum(ring_psum_nbytes(g.size, b, bytes_per_elt=1)
                       for b in g.handed)
            coll["all_reduce/" + ",".join(g.axes)] = wire
    return {"flops": flops.get_total_flops()
            + fa.META_WORK["flops"] - work0["flops"],
            "bytes": opb.bytes + fa.META_WORK["bytes"] - work0["bytes"],
            "coll": coll}


def measure_cost_metrics(cfg, shape_name: str, mesh) -> Dict[str, Any]:
    """The two-point check: the cell at 2 and 3 superblocks (`specs.
    cost_config`, the cell's own microbatches), per metric M_k = F + k B,
    extrapolated to the arch's superblocks. The port counts every
    superblock, so the extrapolation equals the full count when the
    counts are linear in k; the row carries both. (The reference's
    points are 1 and 2 superblocks at one microbatch; in eager PyTorch a
    stack of one superblock is degenerate, e.g. whisper's cross K and V
    come out contiguous with no copy, and a microbatch gathers the
    weights again, so neither would extrapolate.)"""
    points = []
    for k in (2, 3):
        run, _, _ = lower_cell(S.cost_config(cfg, k), shape_name, mesh)
        points.append(measure(run, mesh))
    nsb = cfg.num_superblocks
    out = {}
    for key in ("flops", "bytes"):
        b = points[1][key] - points[0][key]
        out[key] = points[0][key] + (nsb - 2) * b
    return out


@contextlib.contextmanager
def apply_variant(cfg, variant: str, mesh):
    """The reference's baseline (the paper-faithful one): experts over
    the data axis. Its other variants set knobs (block skip, bf16
    logits, the flash stub) that are not fields of the port's
    `ArchConfig`: the attention is one kernel whatever they say. The
    expert axis is put back on exit."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: the port has {VARIANTS}")
    prev = shd._EXPERT_AXIS
    shd.set_expert_axis("data")
    try:
        yield cfg
    finally:
        shd.set_expert_axis(prev)


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             verbose: bool = True, with_cost: bool = True,
             variant: str = "baseline") -> Dict[str, Any]:
    """One cell's row."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, why = S.runnable(cfg, shape)
    row: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "variant": variant}
    if not ok:
        row.update(status="skipped", reason=why)
        return row
    mesh = abstract_mesh(*production_shape(MESHES[mesh_name]))
    t0 = time.perf_counter()
    try:
        with apply_variant(cfg, variant, mesh) as cfg:
            run, args, aux = lower_cell(cfg, shape_name, mesh)
            m = measure(run, mesh)
            exact = (measure_cost_metrics(cfg, shape_name, mesh)
                     if with_cost else None)
    except Exception as e:      # a failing cell is a fault of the port
        row.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        return row
    terms = R.RooflineTerms(
        arch=arch, shape=shape_name, mesh=mesh_name,
        flops_per_device=m["flops"], bytes_per_device=m["bytes"],
        coll_bytes_per_device=sum(m["coll"].values()),
        coll_breakdown=m["coll"],
        model_flops=R.model_flops_estimate(cfg, shape),
        n_devices=math.prod(mesh.shape.values()),
        argument_bytes=sum(args.values()))
    row.update(status="ok", run_s=round(time.perf_counter() - t0, 2),
               devices=terms.n_devices, arg_bytes_by_part=args,
               temp_bytes_note="null: meta tensors cannot measure "
                               "temporary memory", **aux)
    row.update(terms.row())
    if exact is not None:
        # the port counts every superblock, so the two points' line must
        # reach the full count: a cell whose count is not linear in the
        # superblocks is a fault of the counting
        row["two_point"] = {k: exact[k] for k in ("flops", "bytes")}
        row["two_point_linear"] = all(
            math.isclose(exact[k], m[k], rel_tol=1e-9)
            for k in ("flops", "bytes"))
        if not row["two_point_linear"]:
            row.update(status="FAILED", error=(
                f"the two-point count {row['two_point']} is not the "
                f"full count {({k: m[k] for k in ('flops', 'bytes')})}"))
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] "
              f"args/dev={row['arg_bytes_per_dev'] / 1e9:.2f}GB "
              f"t=({R.fmt_seconds(row['t_compute_s'])}, "
              f"{R.fmt_seconds(row['t_memory_s'])}, "
              f"{R.fmt_seconds(row['t_collective_s'])}) "
              f"bound={row['bottleneck']} "
              f"useful={row['useful_fraction']:.1%} "
              f"roofline={row['roofline_fraction']:.1%} "
              f"({row['run_s']} s)", flush=True)
    return row


def _run_cells(jobs, n: int):
    """The rows of `run_cell(**job)` for each job, in order; with n > 1 in
    n processes (meta tensors run on the host, one core a cell), the
    training cells, the longest, first."""
    if n <= 1:
        return [run_cell(**job) for job in jobs]
    order = sorted(range(len(jobs)),
                   key=lambda i: jobs[i]["shape_name"] != "train_4k")
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            n, mp_context=ctx, initializer=torch.set_num_threads,
            initargs=(1,)) as pool:
        futures = {i: pool.submit(_run_job, jobs[i]) for i in order}
        return [futures[i].result() for i in range(len(jobs))]


def _run_job(job):
    return run_cell(**job)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-cost", action="store_true",
                    help="no two-point check")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS,
                    help="the reference's other variants set knobs the "
                         "port's ArchConfig does not have")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s, m) for a in ARCHS for s in SHAPES for m in meshes]
    else:
        assert args.arch, "--arch (+ optional --shape) or --all"
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(args.arch, s, m) for s in shapes for m in meshes]
    jobs = [dict(arch=a, shape_name=s, mesh_name=m,
                 with_cost=not args.skip_cost and m == "single",
                 variant=args.variant) for a, s, m in cells]
    rows = _run_cells(jobs, args.jobs)
    for row in rows:
        tag = f"[{row['arch']} x {row['shape']} x {row['mesh']}]"
        if row["status"] == "FAILED":
            print(f"{tag} FAILED: {row['error']}")
        elif row["status"] == "skipped":
            print(f"{tag} skipped: {row['reason']}")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    print()
    print(R.render_table(rows))
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    n_fail = len(rows) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED "
          f"of {len(rows)} cells")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
