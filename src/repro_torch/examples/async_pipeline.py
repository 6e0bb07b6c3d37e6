"""Async pipelined serving (DESIGN.md §9): overlap host preprocessing with
device execution on an online request stream; the port of the
reference's `examples/async_pipeline.py` (the same output lines and
assertion), on the card or, with `--device cpu`, on the kernels' plain
versions.

The sync path serializes GraphSplit's two halves — each `submit()` pays
padding + operand packing on the host, then `run()` blocks on the device
batch before the next request is touched. The pipeline scheduler runs the
same engine with host worker threads feeding a batching dispatcher: while
the device executes request N, workers prepare N+1 and N+2, and the batch
window coalesces same-(model, bucket, tier) arrivals into fuller batches.

  PYTHONPATH=src python -m repro_torch.examples.async_pipeline \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.graph import BucketLadder
from repro_torch.core.models import GNNConfig
from repro_torch.data.graphs import planetoid_like
from repro_torch.runtime.gnn_server import GraphServe, GraphServeConfig
from repro_torch.runtime.scheduler import PipelineConfig

IN_FEATS, CLASSES, N_REQ = 64, 7, 16


def build_engine(device=None) -> GraphServe:
    sc = GraphServeConfig(ladder=BucketLadder(buckets=(512, 1024)),
                          batch_slots=4)
    eng = GraphServe(sc, seed=0, device=device)
    eng.register_model("gcn", GNNConfig(kind="gcn", in_feats=IN_FEATS,
                                        hidden=16, num_classes=CLASSES),
                       tiers=("fp32", "int8"))
    eng.register_model("gat", GNNConfig(kind="gat", in_feats=IN_FEATS,
                                        hidden=16, num_classes=CLASSES,
                                        heads=4))
    eng.warmup()
    eng.calibrate("gcn", planetoid_like(num_nodes=200, num_edges=600,
                                        num_feats=IN_FEATS,
                                        num_classes=CLASSES, seed=99,
                                        train_per_class=5))
    return eng


def traffic():
    rng = np.random.default_rng(0)
    out = []
    for i in range(N_REQ):
        kind = "gcn" if i % 2 == 0 else "gat"
        n = int(rng.integers(300, 900))
        tier = ("fp32", "int8")[int(rng.integers(2))] if kind == "gcn" else None
        out.append((kind, tier, planetoid_like(
            num_nodes=n, num_edges=3 * n, num_feats=IN_FEATS,
            num_classes=CLASSES, seed=i, train_per_class=2)))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    stream = traffic()

    # --- online sync baseline: drain after every arrival
    eng = build_engine(args.device)
    t0 = time.perf_counter()
    for kind, tier, g in stream:
        eng.submit(g, model=kind, tier=tier)
        eng.run()
    sync_s = time.perf_counter() - t0
    s = eng.summary()
    print(f"sync  run(): {N_REQ / sync_s:5.1f} req/s  "
          f"device_idle={s['device_idle_fraction']:.2f}  "
          f"occupancy={s['batch_occupancy']:.2f}")

    # --- async pipeline: same arrivals, host workers + batching dispatcher
    eng = build_engine(args.device)
    pc = PipelineConfig(host_workers=2, window_ms=25.0,
                        max_pending=N_REQ, max_ready=N_REQ)
    t0 = time.perf_counter()
    with eng.scheduler(pc) as sched:
        for kind, tier, g in stream:
            sched.submit(g, model=kind, tier=tier)
        done = sched.drain()
    async_s = time.perf_counter() - t0
    eng.assert_warm()                 # overlap won, zero recompiles paid
    s = eng.summary()
    print(f"async pipe : {N_REQ / async_s:5.1f} req/s  "
          f"device_idle={s['device_idle_fraction']:.2f}  "
          f"occupancy={s['batch_occupancy']:.2f}  "
          f"(host workers={pc.host_workers}, window={pc.window_ms}ms)")
    print(f"\n{sync_s / async_s:.2f}x async vs sync; "
          f"{len(done)} requests completed, "
          f"blocked={sched.metrics['blocked']} "
          f"rejected={sched.metrics['rejected']}")
    if not (len(done) == N_REQ and all(r.done for r in done)):
        raise AssertionError(f"{len(done)} of {N_REQ} requests completed")


if __name__ == "__main__":
    main()
