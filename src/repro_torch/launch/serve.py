"""Serving launcher: bucketed batch inference of the dense, moe, ssm,
hybrid and vlm LM families (`--arch` any of `configs.ARCHS` but the
encoder-decoder whisper-base, which `Server` refuses; a vision model is
served on its text backbone, without patches).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --reduced --device cpu

runs on the CUDA card (prefill through the `flash_attention` kernel);
`--device cpu` runs the plain PyTorch path, for example with `--reduced`.
Prints the server's summary as JSON.

With `--mesh DxM` the process is one rank of a ("data", "model") mesh
(started as `launch/train.py --mesh` ranks are): it draws the seed's
weights, keeps its blocks (`runtime.trainer.lm_placement`), and runs one
greedy batch of `--requests` prompts of `--buckets[-1]` tokens through
`lm_prefill` and `--max-new` `lm_decode_step`s on the placement, each
superblock gathered as it runs. It prints one JSON line: its tokens, the
prefill's and a decode step's ms, what it handed to all_reduce and its
`flash_attention` launches.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.dist import compress
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.launch.train import (elapsed_ms, flash_launches, mesh_shape,
                                      start_clock)
from repro_torch.nn import lm
from repro_torch.nn.config import ArchConfig
from repro_torch.runtime.server import ServeConfig, Server
from repro_torch.runtime.trainer import lm_placement


def prompts(cfg: ArchConfig, batch: int, length: int,
            seed: int) -> np.ndarray:
    """The greedy batch of a mesh run: (batch, length) token ids."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, length)).astype(np.int64)


def serve_on_mesh(cfg: ArchConfig, mesh, tokens: np.ndarray, *,
                  max_new: int, seed: int = 0) -> Dict[str, Any]:
    """Greedy prefill and `max_new` decode steps of `tokens` on `mesh`
    from the seed's weights in the compute dtype (every rank calls it).
    Returns this rank's record."""
    dev = mesh.device
    place = lm_placement(cfg, mesh)
    full = lm.lm_init(cfg, seed=seed, device=dev, dtype=cfg.dtype)
    blocks = place.blocks(full, place.specs)
    del full
    prompt = torch.from_numpy(tokens).to(dev)
    wire0, launches0 = dict(compress.WIRE), flash_launches()
    with torch.no_grad():
        t0 = start_clock(dev)
        logits, state = lm.lm_prefill(blocks, cfg, prompt,
                                      max_len=prompt.shape[1] + max_new,
                                      place=place)
        tok = logits.argmax(-1)
        prefill_ms = elapsed_ms(t0, dev)
        out, step_ms = [tok], []
        for _ in range(max_new):
            t0 = start_clock(dev)
            logits, state = lm.lm_decode_step(blocks, cfg, tok, state,
                                              place=place)
            tok = logits.argmax(-1)
            step_ms.append(elapsed_ms(t0, dev))
            out.append(tok)
    return {"rank": dist.get_rank(), "coords": mesh.coords,
            "mesh": mesh.shape, "device": str(dev),
            "tokens": torch.stack(out, 1).tolist(),
            "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "allreduce_bytes": compress.WIRE["bytes"] - wire0["bytes"],
            "launches": {k: v - launches0[k]
                         for k, v in flash_launches().items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--buckets", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (on a mesh "
                         "cuda:{local rank})")
    ap.add_argument("--mesh", default=None,
                    help="DxM: one greedy batch on a (data, model) mesh of "
                         "D x M ranks, this process one of them")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.mesh is not None:
        dev = init_distributed(backend=args.backend,
                               init_method=args.init_method, rank=args.rank,
                               world_size=args.world_size,
                               device=args.device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        try:
            mesh = make_mesh(mesh_shape(args.mesh), ("data", "model"),
                             device=dev)
            if mesh is None:
                raise ValueError(f"rank {dist.get_rank()} lies outside mesh "
                                 f"{args.mesh}")
            toks = prompts(cfg, args.requests, args.buckets[-1], args.seed)
            print(json.dumps(serve_on_mesh(cfg, mesh, toks,
                                           max_new=args.max_new,
                                           seed=args.seed)), flush=True)
        finally:
            dist.destroy_process_group()
        return
    sc = ServeConfig(buckets=tuple(args.buckets), max_len=args.max_len,
                     batch_slots=args.slots)
    server = Server(cfg, sc, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        n = int(rng.integers(4, args.buckets[-1]))
        server.submit(rng.integers(0, cfg.vocab_size, size=n),
                      max_new_tokens=args.max_new)
    server.run()
    print(json.dumps(server.summary(), indent=2))


if __name__ == "__main__":
    main()
