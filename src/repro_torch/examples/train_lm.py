"""End-to-end LM training: SmolLM-135M's family (reduced to 6 layers by
default, `--full` for the whole model) for a few hundred steps with
checkpoint/restart, microbatching and straggler monitoring, on the card.
The loss must fall.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \\
      [--full]
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 3 \\
      --device cpu                      # the plain path on the CPU

Checkpoints go to `--ckpt-dir`, by default a temporary directory that is
removed at the end.
"""
from __future__ import annotations

import argparse
import json
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.runtime.trainer import TrainConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m")
    if not args.full:
        cfg = reduced(cfg, layers=6)
    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(steps=args.steps, seq_len=128, global_batch=8,
                         microbatches=2, lr=1e-3, warmup_steps=20,
                         ckpt_dir=args.ckpt_dir or tmp, ckpt_every=50)
        tr = Trainer(cfg, tc, device=args.device)
        print(f"arch={cfg.name} layers={cfg.num_layers} "
              f"params={cfg.param_count() / 1e6:.1f}M device={tr.device}",
              flush=True)
        tr.run()
    s = tr.summary()
    print(json.dumps(s, indent=2))
    assert s["last_loss"] < s["first_loss"], "training must reduce loss"
    print(f"loss: {s['first_loss']:.3f} -> {s['last_loss']:.3f} over "
          f"{s['steps']} steps ({s['stragglers']} straggler steps flagged)")


if __name__ == "__main__":
    main()
