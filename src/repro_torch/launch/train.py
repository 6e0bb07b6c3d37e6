"""Training launcher: an LM of `configs.ARCHS` trained on the synthetic
token stream, on one device through `runtime.trainer.Trainer`, or with
`--mesh DxM` on a ("data", "model") mesh of D x M ranks, one process a
rank (the reference's "launched once per host").

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256 --ckpt-dir build/train_run
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --device cpu --steps 3

runs on the CUDA card (every layer's attention and its gradient through the
`flash_attention` kernels); `--device cpu` runs the plain PyTorch path, for
example with `--reduced` (the reference's family-faithful shrink). Without
`--reduced` the full config is built. Prints the trainer's summary as JSON.

On a mesh, every rank is started with the same arguments and either
torchrun's environment or `--init-method/--rank/--world-size` (as
`launch/shard_serve.py`; `spawn_local` starts them on one host):

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch smollm-135m --mesh 2x2 --steps 20 --batch 8 --seq 1024

Each rank draws the same weights from the seed and keeps its blocks of
them (`runtime.trainer.lm_placement`), draws the same global batch from
`TokenStream.batch_at(step)` and keeps its rows, and prints one JSON line:
its rank, coordinates, losses, each step's ms, what it handed to
all_reduce, its kernel launches and its peak memory. A checkpoint directory is written by the mesh's origin from
the assembled leaves and restored on any mesh.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager, tree_items
from repro_torch.configs import get_config, reduced
from repro_torch.data.synthetic import TokenStream
from repro_torch.dist import compress
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.nn import lm
from repro_torch.nn.config import ArchConfig
from repro_torch.runtime.trainer import (TrainConfig, Trainer,
                                         init_opt_state, lm_placement,
                                         make_train_step, train_state_specs)


def mesh_shape(text: str):
    """"DxM" -> (D, M)."""
    d, m = (int(v) for v in text.lower().split("x"))
    return d, m


def global_batch(stream: TokenStream, step: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in stream.batch_at(step).items()}


def train_on_mesh(cfg: ArchConfig, tc: TrainConfig, mesh, *,
                  params: Optional[lm.LMParams] = None) -> Dict[str, Any]:
    """`tc.steps` steps of `make_train_step(mesh=)` from step 0, or from
    the latest checkpoint under `tc.ckpt_dir` (saved every
    `tc.ckpt_every` steps and at the end); every rank of the mesh calls
    it. `params` (full, on every rank alike) replace the seed's
    draw. Returns this rank's record: losses and global gradient norms
    by step, step ms (CUDA events on a card, the host clock on the CPU)
    and on a card the ms inside all_reduce, the bytes and calls it handed
    to all_reduce, its `flash_attention` launches, its peak card memory,
    its parameter bytes and the final state."""
    dev = mesh.device
    place = lm_placement(cfg, mesh)
    full = params if params is not None else lm.lm_init(cfg, seed=tc.seed,
                                                        device=dev)
    blocks = place.blocks(full, place.specs)
    del full
    state = {"params": blocks, "opt": init_opt_state(blocks),
             "step": torch.tensor(0, dtype=torch.int32)}
    ckpt = (CheckpointManager(tc.ckpt_dir, keep=tc.ckpt_keep,
                              every=tc.ckpt_every) if tc.ckpt_dir else None)
    specs = train_state_specs(place)
    start = 0
    if ckpt is not None:
        restored, tree = ckpt.restore_latest(state, specs=specs, mesh=mesh)
        if restored is not None:
            state, start = tree, int(tree["step"])
    step_fn = make_train_step(cfg, tc, mesh=mesh)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
                         global_batch=tc.global_batch, seed=tc.seed)
    losses: List[List[float]] = []
    grad_norms: List[List[float]] = []
    step_ms: List[float] = []
    allreduce_ms: List[float] = []
    wire0, launches0 = dict(compress.WIRE), flash_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for step in range(start, tc.steps):
        batch = global_batch(stream, step, dev)
        spans: List = []
        t0 = start_clock(dev)
        with compress.timed_all_reduces(spans):
            params, opt, metrics = step_fn(state["params"], state["opt"],
                                           batch, torch.tensor(step))
        step_ms.append(elapsed_ms(t0, dev))
        allreduce_ms.append(sum(a.elapsed_time(b) for a, b in spans))
        losses.append([step, float(metrics["loss"])])
        grad_norms.append([step, float(metrics["grad_norm"])])
        state = {"params": params, "opt": opt,
                 "step": torch.tensor(step + 1, dtype=torch.int32)}
        if ckpt is not None:
            ckpt.maybe_save(step + 1, state, specs=specs, mesh=mesh)
    if ckpt is not None and ckpt.saved_steps[-1:] != [tc.steps]:
        # the end of the run is kept, as `Trainer.run` keeps it
        ckpt.maybe_save(tc.steps, state, force=True, specs=specs, mesh=mesh)
    return {"rank": dist.get_rank(), "coords": mesh.coords,
            "mesh": mesh.shape, "device": str(dev), "start": start,
            "losses": losses, "grad_norms": grad_norms, "step_ms": step_ms,
            "allreduce_ms": allreduce_ms if dev.type == "cuda" else None,
            "allreduce_bytes": compress.WIRE["bytes"] - wire0["bytes"],
            "allreduce_calls": compress.WIRE["calls"] - wire0["calls"],
            "launches": {k: v - launches0[k]
                         for k, v in flash_launches().items()},
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "param_block_bytes": sum(
                t.numel() * t.element_size()
                for t in _tensors(state["params"])),
            "state": state}


def flash_launches() -> Dict[str, int]:
    """flash_attention's launch counters (this process's)."""
    return {k: getattr(fa, k) for k in ("LAUNCHES", "TC_LAUNCHES",
                                        "SIMT_LAUNCHES", "BWD_LAUNCHES",
                                        "BWD_TC_LAUNCHES",
                                        "BWD_SIMT_LAUNCHES")}


def _tensors(tree):
    return [t for _, t in tree_items(tree)]


def start_clock(dev: torch.device):
    """A recorded CUDA event on a card, the host clock elsewhere; read by
    `elapsed_ms`."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def elapsed_ms(t0, dev: torch.device) -> float:
    """ms since `start_clock` (on a card: event to event, synchronised)."""
    if dev.type == "cuda":
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        return t0.elapsed_time(end)
    return 1e3 * (time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="layer override for --reduced")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (on a mesh "
                         "cuda:{local rank})")
    ap.add_argument("--mesh", default=None,
                    help="DxM: train on a (data, model) mesh of D x M ranks,"
                         " this process one of them")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, layers=args.layers)
    tc = TrainConfig(steps=args.steps, seq_len=args.seq,
                     global_batch=args.batch, microbatches=args.microbatches,
                     lr=args.lr, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, seed=args.seed)
    if args.mesh is None:
        trainer = Trainer(cfg, tc, device=args.device)
        print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
              f"params={cfg.param_count() / 1e6:.1f}M "
              f"device={trainer.device}", flush=True)
        trainer.run()
        print(json.dumps(trainer.summary(), indent=2))
        return
    dev = init_distributed(backend=args.backend,
                           init_method=args.init_method, rank=args.rank,
                           world_size=args.world_size, device=args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        mesh = make_mesh(mesh_shape(args.mesh), ("data", "model"),
                         device=dev)
        if mesh is None:
            raise ValueError(f"rank {dist.get_rank()} lies outside mesh "
                             f"{args.mesh}: the world must be D x M ranks")
        res = train_on_mesh(cfg, tc, mesh)
        res.pop("state")
        print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
