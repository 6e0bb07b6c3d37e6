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
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.runtime.server import ServeConfig, Server


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
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
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
