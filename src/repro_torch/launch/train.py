"""Training launcher: an LM of `configs.ARCHS` trained on the synthetic
token stream through `runtime.trainer.Trainer`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256 --ckpt-dir build/train_run
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --device cpu --steps 3

runs on the CUDA card (every layer's attention and its gradient through the
`flash_attention` kernels); `--device cpu` runs the plain PyTorch path, for
example with `--reduced` (the reference's family-faithful shrink). Without
`--reduced` the full config is built. Prints the trainer's summary as JSON.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, reduced
from repro_torch.runtime.trainer import TrainConfig, Trainer


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
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, layers=args.layers)
    tc = TrainConfig(steps=args.steps, seq_len=args.seq,
                     global_batch=args.batch, microbatches=args.microbatches,
                     lr=args.lr, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, seed=args.seed)
    trainer = Trainer(cfg, tc, device=args.device)
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"params={cfg.param_count() / 1e6:.1f}M device={trainer.device}",
          flush=True)
    trainer.run()
    print(json.dumps(trainer.summary(), indent=2))


if __name__ == "__main__":
    main()
