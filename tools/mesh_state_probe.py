#!/usr/bin/env python3
"""`[mesh-lm]`'s state check on the CPU: the reduced SmolLM trained 3 steps
by one process and on a (data, model) mesh of gloo ranks, both through
`python -m repro_torch.launch.train`, and the mesh's parameters and
AdamW first moments read against the single process's by
`chip_smoke.mesh_state_readings` (the readings the card phase holds to
its limits).

`--root DIR` trains with another checkout's `src/` (for example a copy
with a step changed on purpose), so that the readings of a faulty mesh
step can be set beside a sound one's; the check itself is always this
checkout's:

    PYTHONPATH=src python3 tools/mesh_state_probe.py 2x1 1x2
    PYTHONPATH=src python3 tools/mesh_state_probe.py 2x1 --root DIR

Prints one line per mesh: its readings, the readings beyond their limits,
and the mesh's losses.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS, BATCH, SEQ, MICRO, LR = 3, 8, 64, 2, 1e-3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("meshes", nargs="+", help="DxM")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose src/ trains")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.ckpt import tree_items
    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config, reduced
    from repro_torch.nn import lm
    from repro_torch.runtime import trainer

    torch.set_num_threads(2)
    cfg = reduced(get_config("smollm-135m"))
    train = ["--arch", "smollm-135m", "--reduced", "--steps", str(STEPS),
             "--batch", str(BATCH), "--seq", str(SEQ), "--microbatches",
             str(MICRO), "--lr", str(LR), "--device", "cpu",
             "--ckpt-every", "100"]
    env = dict(os.environ, PYTHONPATH=str(args.root.resolve() / "src"))
    template = cs._cpu_like(lm.lm_init(cfg, device="meta"))
    init = dict(tree_items(lm.lm_init(cfg, seed=0, device="cpu")))
    bound = 2 * sum(float(trainer.linear_warmup_cosine(
        s, base_lr=LR, warmup_steps=max(1, STEPS // 4), total_steps=STEPS))
        for s in range(STEPS))

    def state(path):
        return dict(tree_items(restore_checkpoint(
            path, {"params": template, "opt": {"m": template}},
            step=STEPS)[1]))

    def run(extra, store=None, world=1):
        """The launcher's processes (one, or a rank each, started as
        `spawn_local` starts them) with the checkout's src/; their
        standard outputs."""
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *train,
               *extra]
        ranks = [[]] if world == 1 else [
            ["--rank", str(r), "--world-size", str(world), "--init-method",
             f"file://{store}"] for r in range(world)]
        procs = [subprocess.Popen(cmd + r, env=env, stdout=subprocess.PIPE,
                                  text=True) for r in ranks]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        if any(p.returncode for p in procs):
            raise SystemExit(f"{cmd}: exit codes "
                             f"{[p.returncode for p in procs]}")
        return outs

    with tempfile.TemporaryDirectory() as tmp:
        run(["--ckpt-dir", f"{tmp}/one"])
        ref = state(f"{tmp}/one")
        for name in args.meshes:
            d, m = map(int, name.split("x"))
            outs = run(["--ckpt-dir", f"{tmp}/{name}", "--mesh", name,
                        "--backend", "gloo"], f"{tmp}/store{name}", d * m)
            worst = cs.mesh_state_readings(ref, init, state(f"{tmp}/{name}"))
            losses = json.loads(outs[0].strip().splitlines()[-1])["losses"]
            print(f"{name} ({args.root}): {cs.fmt_state(worst)}; beyond "
                  f"their limits: {cs.mesh_state_faults(worst, bound)}; "
                  f"losses {[l for _, l in losses]}", flush=True)


if __name__ == "__main__":
    main()
