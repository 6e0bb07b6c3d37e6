"""GraSp sparse serving walkthrough (DESIGN.md §10): auto backend
selection flipping dense → grasp as graph density drops; the port of the
reference's `examples/sparse_serving.py` (the same output lines and
assertions), on the card (the GraSp batches through `fused_gcn_grasp`)
or, with `--device cpu`, on the kernels' plain versions.

GraSp is the paper's Step-2 sparsity bitmap: real adjacencies are >99%
zero, so the accelerator can skip all-zero 128×128 blocks of Â entirely.
GraphServe makes that a per-graph DISPATCH decision rather than a build
flag:

  register — `agg_backend="auto"` turns on the backend rule for a model;
             plans exist in BOTH backends after warmup, so however the
             rule routes, nothing recompiles;
  route    — each graph's block bitmap feeds the modelled density/cost
             rule (`select_agg_backend`, on `core/costs.py`'s H100
             terms): scattered/dense graphs keep the dense matmul,
             clustered sparse graphs take the block-skip kernel;
  derive   — the block structure is DERIVED device-side from the cached
             fp32 Â once per structure version (zero extra host→device
             bytes), cached next to the CacheG operands, invalidated by
             update(), released by detach();
  observe  — summary() reports `agg_backends`, `grasp_batches`, and
             `backend_fallbacks` (a sparse dispatch that quietly ran
             the plain version — on a CPU host, where the skip grid
             cannot run);
  correct  — once BOTH backends hold measured batch latencies at a
             (model, bucket), the §14 latency bank overrides the
             roofline RANKING (never eligibility), so late sweep entries
             may route otherwise than the cold model said — the measured
             column below shows what the engine actually consulted.

  PYTHONPATH=src python -m repro_torch.examples.sparse_serving \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core.graph import BucketLadder
from repro_torch.core.models import GNNConfig
from repro_torch.core.sparsity import (block_stats, grasp_max_nnz,
                                       select_agg_backend)
from repro_torch.data.graphs import clustered_like
from repro_torch.runtime.gnn_server import GraphServe, GraphServeConfig


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cap, in_feats, classes, hidden = 1024, 16, 5, 16
    n = 896

    eng = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=(cap,)),
                                      batch_slots=2), seed=0,
                     device=args.device)
    eng.register_model("gcn", GNNConfig(kind="gcn", in_feats=in_feats,
                                        hidden=hidden, num_classes=classes),
                       agg_backend="auto")
    blobs = eng.warmup()      # dense AND grasp plans + the block compactor
    print(f"warm: {blobs} compiled blobs (both backends pre-traced), "
          f"bucket budget grasp_max_nnz({cap}) = {grasp_max_nnz(cap)}\n")

    # Same community structure, falling density: cross-community edges
    # fill the block bitmap at high density; at low density the adjacency
    # is block-diagonal — exactly what the 128x128 skip targets.
    sweep = [("dense-ish", 0.50, 0.30), ("medium", 0.10, 0.05),
             ("sparse", 0.03, 0.0), ("very sparse", 0.01, 0.0)]
    print(f"{'graph':>12} {'elem dens':>10} {'block dens':>10} "
          f"{'model dense':>12} {'model grasp':>12} {'backend':>8}")
    for name, within, cross in sweep:
        g = clustered_like(num_nodes=n, num_feats=in_feats,
                           num_classes=classes, within_density=within,
                           cross_frac=cross, seed=3)
        pg = eng.sc.ladder.pad(g)
        st = block_stats(pg.norm_adj)
        # the engine's rule, verbatim: modelled costs, overridden by the
        # latency bank's measured pair once both backends have served here
        measured = eng._measured_agg_pair("gcn", cap)
        choice, dense_s, grasp_s = select_agg_backend(
            cap, hidden, nnz_blocks=st["nnz_blocks"],
            max_row_nnz=st["max_row_nnz"], measured=measured)
        gid = eng.attach(g, model="gcn")
        eng.query(gid)
        eng.query(gid)        # same (model, bucket, tier, backend) key:
        eng.run()             # one BATCHED dispatch of 2
        served = eng.finished[-1].backend
        if served != choice:
            raise AssertionError(f"{name}: served {served}, the rule said "
                                 f"{choice}")
        both = all(m is not None for m in measured)
        print(f"{name:>12} {g.num_edges / n**2:>10.4f} "
              f"{st['block_density']:>10.2f} {dense_s * 1e6:>10.1f}us "
              f"{grasp_s * 1e6:>10.1f}us {served:>8}"
              f"{'  (measured override live)' if both else ''}")
        eng.detach(gid)

    eng.assert_warm()         # the flip cost zero recompiles
    s = eng.summary()
    print(f"\nagg_backends={s['agg_backends']} "
          f"grasp_batches={s['grasp_batches']} "
          f"backend_fallbacks={s['backend_fallbacks']} "
          f"(fallbacks > 0 on CPU hosts: the ref routing has no skip grid)")


if __name__ == "__main__":
    main()
