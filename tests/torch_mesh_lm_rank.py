"""One rank of the LM placement checks of `tests/test_torch_mesh_train.py`.

Started by `repro_torch.launch.shard_serve.spawn_local` (gloo, the CPU,
one thread) in a world of 4, as

  python tests/torch_mesh_lm_rank.py --dir DIR \\
      --rank R --world-size 4 --init-method file://...

it reads the starting weights the test wrote (`DIR/init/<arch>`, a
checkpoint of full arrays) and runs, on the (1, 2), (2, 1) and (2, 2)
meshes of the world's first ranks:

  train    3 steps of `make_train_step(mesh=)` for each arch through
           `launch.train.train_on_mesh`; the final state is saved on the
           mesh (`DIR/<mesh>/<arch>`, assembled, written by the origin);
  resume   (2, 1) and (1, 2) runs of 2 steps that checkpoint at step 2
           (`DIR/resume-<mesh>`), then the third step restored on (1, 2)
           from each: this rank's restored blocks go to
           `DIR/blocks-<from>-r<R>.npz`;
  serve    on (1, 2), `greedy_generate(place=)` from a prompt.

Its facts go to the last line of its output as JSON. It imports neither
JAX nor the reference package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.ckpt import (restore_checkpoint,  # noqa: E402
                              tree_items)
from repro_torch.ckpt.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_mesh  # noqa: E402
from repro_torch.launch.train import train_on_mesh  # noqa: E402
from repro_torch.nn import lm  # noqa: E402
from repro_torch.runtime.trainer import (TrainConfig,  # noqa: E402
                                         lm_placement, train_state_specs)

ARCHS = ("smollm-135m", "olmoe-1b-7b")
MESHES = ((1, 2), (2, 1), (2, 2))
TC = dict(steps=3, seq_len=32, global_batch=8, microbatches=2, lr=1e-3,
          warmup_steps=1)
PROMPT = dict(batch=2, len=16, steps=4, max_len=24)


def config(arch: str):
    return reduced(get_config(arch))


def init_params(root: Path, arch: str) -> lm.LMParams:
    template = lm.lm_init(config(arch), device="cpu")
    return restore_checkpoint(str(root / "init" / arch), template)[1]


def prompt(cfg) -> torch.Tensor:
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PROMPT["batch"], PROMPT["len"])).astype(
            np.int64))


def name(shape) -> str:
    return "x".join(map(str, shape))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    args = ap.parse_args(argv)
    root = Path(args.dir)
    init_distributed(backend="gloo", init_method=args.init_method,
                     rank=args.rank, world_size=args.world_size,
                     device="cpu", timeout_s=120)
    torch.set_num_threads(1)
    meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu")
              for shape in MESHES}
    out = {"rank": args.rank, "train": {}, "resume": {}, "serve": None}
    for shape, mesh in meshes.items():
        if mesh is None:
            continue
        for arch in ARCHS:
            cfg = config(arch)
            res = train_on_mesh(cfg, TrainConfig(**TC), mesh,
                                params=init_params(root, arch))
            save_checkpoint(str(root / name(shape) / arch), TC["steps"],
                            res["state"]["params"],
                            specs=lm_placement(cfg, mesh).specs, mesh=mesh)
            out["train"][f"{name(shape)}/{arch}"] = {
                k: res[k] for k in ("coords", "losses", "allreduce_calls",
                                    "param_block_bytes")}
    # resume: 2 steps on (2, 1) and on (1, 2), then step 3 on (1, 2)
    cfg = config("smollm-135m")
    for src in ((2, 1), (1, 2)):
        ckpt_dir = str(root / f"resume-{name(src)}")
        if meshes[src] is not None:
            train_on_mesh(cfg, TrainConfig(**dict(TC, steps=2),
                                           ckpt_dir=ckpt_dir, ckpt_every=2),
                          meshes[src], params=init_params(root, "smollm-135m"))
        mesh = meshes[(1, 2)]
        if mesh is not None:
            res = train_on_mesh(cfg, TrainConfig(**TC, ckpt_dir=ckpt_dir,
                                                 ckpt_every=100), mesh,
                                params=init_params(root, "smollm-135m"))
            out["resume"][name(src)] = {"start": res["start"],
                                        "losses": res["losses"]}
            # the blocks a restore gives this rank, straight from the files
            place = lm_placement(cfg, mesh)
            template = {"params": place.blocks(
                lm.lm_init(cfg, device="cpu"), place.specs)}
            _, tree = restore_checkpoint(
                ckpt_dir, template, step=2,
                specs={"params": train_state_specs(place)["params"]},
                mesh=mesh)
            np.savez(root / f"blocks-{name(src)}-r{args.rank}.npz",
                     **{k.replace("/", "|"): t.numpy()
                        for k, t in tree_items(tree)})
    mesh = meshes[(1, 2)]
    if mesh is not None:
        place = lm_placement(cfg, mesh)
        blocks = place.blocks(init_params(root, "smollm-135m"), place.specs)
        with torch.no_grad():
            toks = lm.greedy_generate(blocks, cfg, prompt(cfg),
                                      steps=PROMPT["steps"],
                                      max_len=PROMPT["max_len"], place=place)
        out["serve"] = toks.tolist()
    print(json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
