#!/usr/bin/env python3
"""Some of chip_smoke.py's phases alone on the card: the quickest check of
the PyTorch port's LM serving at full width, its serving examples and its
GNN intake after a change.

Phases, in the order given (default: flash, dense, scout, examples):
  flash     chip_smoke's FLASH_CASES whose label starts with one of
            FLASH_PREFIXES (the full-width head layouts of chatglm3,
            Llama-4-Scout and gemma2's long wave), kernel against plain
  dense     [serve-dense]: qwen3-4b, chatglm3-6b, gemma2-27b and its long
            wave
  scout     [serve-scout]: Llama-4-Scout at full width, 12 layers
  examples  [examples]: the four serving examples with --device cuda
  intake    [intake]: the host pieces and the fp32 GCN bursts with and
            without CacheG (the check that CacheG's intake is not above
            the eager path's)
  mesh-lm   [mesh-lm]: SmolLM-135M trained and served on meshes of gloo
            ranks sharing the card, against the single-process steps
  mesh-pipeline [mesh-pipeline]: the pipeline scheduler on the GCN's
            meshes of gloo ranks sharing the card, against each rank's
            sync run()
  dryrun    [dryrun]: every arch x shape x production mesh on meta
            tensors (host cores only)

`--root DIR` imports chip_smoke.py and its `src/` from another checkout
(for example the parent commit unpacked under `build/`), so that two
trees' [intake] can be compared in one call, each in its own process:

    python3 tools/serve_probe.py dense scout
    python3 tools/serve_probe.py mesh-lm dryrun
    python3 tools/serve_probe.py mesh-pipeline
    python3 tools/serve_probe.py intake --root build/parent

Run from the repo root on a machine with a card. Any failed check exits
non-zero, as in chip_smoke.py; the card's name and power limit are
printed first.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("flash", "dense", "scout", "examples", "intake", "mesh-lm",
          "mesh-pipeline", "dryrun")
DEFAULT = ("flash", "dense", "scout", "examples")
FLASH_PREFIXES = ("chatglm3", "llama4", "gemma2 S4608")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="*", choices=PHASES,
                    default=list(DEFAULT))
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose chip_smoke.py and src/ to run")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    cs = importlib.import_module("chip_smoke")   # puts root/src on the path
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("serve_probe: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"serve_probe: {root} on {card}", flush=True)
    t0 = time.perf_counter()
    cs._build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for phase in args.phases:
        t0 = time.perf_counter()
        if phase == "flash":
            cs.FLASH_CASES = {k: v for k, v in cs.FLASH_CASES.items()
                              if k.startswith(FLASH_PREFIXES)}
            cs.check(len(cs.FLASH_CASES) == len(FLASH_PREFIXES),
                     f"flash cases {sorted(cs.FLASH_CASES)}")
            print(f"[flash] worst by route {cs.flash_phase(dev)}",
                  flush=True)
        elif phase == "dense":
            cs.serve_dense_phase(dev, card)
        elif phase == "scout":
            cs.serve_moe_phase(dev, card, tag="serve-scout",
                               arch=cs.SCOUT_ARCH, layers=cs.SCOUT_LAYERS)
        elif phase == "examples":
            cs.examples_phase(card)
        elif phase == "mesh-lm":
            print(f"[mesh-lm] launches {cs.mesh_lm_phase(dev, card)}",
                  flush=True)
        elif phase == "mesh-pipeline":
            print(f"[mesh-pipeline] launches "
                  f"{cs.mesh_pipeline_phase(dev, card)}", flush=True)
        elif phase == "dryrun":
            cs.dryrun_phase(card)
        else:
            cora, others = cs.graphs()
            rng = np.random.default_rng(0)
            w1, w2 = cs.glorot(rng, 1433, 64), cs.glorot(rng, 64, 7)
            b1 = (0.1 * rng.standard_normal(64)).astype(np.float32)
            b2 = (0.1 * rng.standard_normal(7)).astype(np.float32)
            params = cs.params_from_jax({"l1": {"w": w1, "b": b1},
                                         "l2": {"w": w2, "b": b2}},
                                        device=dev)
            cs.intake_phase(dev, card, cs.gcn("cora"), params, cora, others)
        print(f"[{phase}] probe phase took {time.perf_counter() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    main()
