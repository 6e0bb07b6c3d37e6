"""Quality-tier serving walkthrough (DESIGN.md §8): one trained GCN served
at three quality tiers through one warm GraphServe engine.

The paper's Step 3 trades accuracy for efficiency (QuantGr INT8, GrAx
approximations). In serving that trade is a per-request decision, so
GraphServe keeps tiers as serving state:

  register  — a model carries a tier registry: fp32 / int8 / int8+grax,
              each a Techniques variant with its own ExecutionPlan;
  warm      — warmup() makes every (model, bucket, tier) plan, QuantGr
              tiers against a placeholder calibration, so no new plan
              signature appears after it;
  calibrate — the first attach() runs the once-per-(model, tier) QuantGr
              calibration and measures accuracy_delta_vs_fp32 on the
              held-out split of the calibration graph;
  query     — query(gid, tier=...) picks the tier per request; an
              uncalibrated quant tier falls back to fp32 (counted, never
              an error); all tiers share one CacheG operand entry;
  metrics   — tier_summary() reports per-tier p50/p99/throughput.

  PYTHONPATH=src python -m repro_torch.examples.quality_tiers
  PYTHONPATH=src python -m repro_torch.examples.quality_tiers \\
      --device cpu --epochs 3 --nodes 200      # the plain path on the CPU
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.core.graph import BucketLadder, pad_graph
from repro_torch.core.models import (GNNConfig, build_operands,
                                     forward_grannite, train_node_classifier)
from repro_torch.data.graphs import planetoid_like
from repro_torch.device import resolve_device
from repro_torch.runtime.gnn_server import (STANDARD_TIERS, GraphServe,
                                            GraphServeConfig, tier_techniques)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--nodes", type=int, default=200,
                    help="nodes of the Planetoid-like graph (at most 256, "
                         "the engine's one bucket)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    in_feats, classes, n = 64, 7, args.nodes
    g = planetoid_like(num_nodes=n, num_edges=3 * n, num_feats=in_feats,
                       num_classes=classes, seed=0, train_per_class=5)
    cfg = GNNConfig(kind="gcn", in_feats=in_feats, hidden=64,
                    num_classes=classes)

    # --- train once (fp32 dense path); every tier serves the same params
    pg = pad_graph(g, capacity=256)
    ops = build_operands(pg, cfg, device=dev)
    t_fp32 = tier_techniques("gcn")["fp32"]
    params = train_node_classifier(
        torch.Generator().manual_seed(0), cfg, pg,
        lambda p, x: forward_grannite(p, cfg, x, ops, t_fp32),
        epochs=args.epochs, device=dev)

    # --- register + warm: every (model, bucket, tier) plan is made now
    sc = GraphServeConfig(ladder=BucketLadder(buckets=(256,)), batch_slots=2)
    eng = GraphServe(sc, seed=0, device=dev)
    eng.register_model("gcn", cfg, params, tiers=STANDARD_TIERS)
    eng.warmup()
    print(f"warm: {eng.compiled_blobs} plan signatures (fp32 + int8 plans — "
          f"int8+grax aliases int8 for GCN — + the CacheG materializer + "
          f"the int8-Â deriver)")

    # --- a quant tier before calibration: served by fp32, counted
    uid = eng.submit(g, model="gcn", tier="int8")
    eng.run()
    served = [r for r in eng.finished if r.uid == uid][0]
    print(f"pre-calibration int8 request served as tier={served.tier!r} "
          f"(tier_fallbacks={eng.metrics['tier_fallbacks']})")

    # --- attach: runs the once-per-(model, tier) calibration and audit
    gid = eng.attach(g, model="gcn")
    deltas = eng.models["gcn"].accuracy_delta
    print("accuracy_delta_vs_fp32 (pts, held-out):",
          {k: round(v, 3) for k, v in deltas.items()})

    # --- mixed-tier traffic over one attached graph, one operand entry
    for i in range(12):
        eng.query(gid, tier=STANDARD_TIERS[i % 3])
    eng.run()
    eng.assert_warm()          # no new plan signature across all of it

    s = eng.summary()
    print(f"\noperand cache: {s['operand_cache_misses']} miss / "
          f"{s['operand_cache_hits']} hits (all tiers share one fp32 entry; "
          f"the int8 Â is derived once per structure version)")
    for tier, st in eng.tier_summary().items():
        print(f"  {tier:10s} {st['requests']:2d} req  "
              f"p50={st['p50_latency_ms']:6.1f} ms  "
              f"p99={st['p99_latency_ms']:6.1f} ms  "
              f"{st['throughput_rps']:6.1f} req/s")
    assert s["tier_fallbacks"] == 1          # only the pre-calibration one


if __name__ == "__main__":
    main()
