"""End-to-end serving driver: batched requests against a small LM through
the bucketed server (mixed prompt lengths, zero recompiles), the port of
the reference's `examples/serve_llm.py`: the same arguments, output lines
and assertion, on the card (prefill through the `flash_attention` kernel)
or, with `--device cpu`, on the plain PyTorch path.

  PYTHONPATH=src python -m repro_torch.examples.serve_llm \\
      [--arch qwen3-4b] [--requests 12] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import ARCHS, reduced
from repro_torch.runtime.server import ServeConfig, Server


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = reduced(ARCHS[args.arch])
    sc = ServeConfig(buckets=(32, 64, 128), max_len=256, batch_slots=4)
    server = Server(cfg, sc, seed=0, device=args.device)
    print(f"serving reduced {cfg.name}: buckets={sc.buckets} "
          f"slots={sc.batch_slots} mode={server.sc.mode}")

    rng = np.random.default_rng(1)
    for i in range(args.requests):
        n = int(rng.integers(4, 120))
        uid = server.submit(rng.integers(0, cfg.vocab_size, size=n),
                            max_new_tokens=args.max_new)
        print(f"  submitted request {uid}: prompt_len={n}")

    done = server.run()
    s = server.summary()
    print(json.dumps(s, indent=2))
    if s["compiled_blobs"] > len(sc.buckets) + 1:
        raise AssertionError(
            "NodePad guarantee violated: more blobs than buckets+decode")
    for r in done[:3]:
        print(f"request {r.uid}: output tokens {r.output.tolist()}")


if __name__ == "__main__":
    main()
