"""GrAd + NodePad on the GraphServe engine: serve an EVOLVING graph with
zero recompiles; the port of the reference's
`examples/dynamic_graph_serving.py` (the same output lines and
assertions), on the card or, with `--device cpu`, on the kernels' plain
versions.

Models the paper's Fig. 10 scenario (on-device knowledge graph): nodes and
edges stream in; the engine rebuilds the graph's operands on the host
(GraphSplit) and feeds ONE plan per (model, bucket) with runtime
arguments (GrAd), the node count padded to a NodePad bucket drawn from the
engine's ladder. If the stream outgrew its bucket, the engine would move the
graph up the ladder (one counted recompile) — here the ladder's admission
slack gives enough headroom that the whole run stays recompile-free.

  PYTHONPATH=src python -m repro_torch.examples.dynamic_graph_serving \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

from repro_torch.configs.gnn import gcn
from repro_torch.core.graph import BucketLadder
from repro_torch.data.graphs import dynamic_graph_stream, planetoid_like
from repro_torch.runtime.gnn_server import GraphServe, GraphServeConfig


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    base = planetoid_like(num_nodes=2000, num_edges=4000, num_feats=256,
                          num_classes=7, seed=0)
    cfg = dataclasses.replace(gcn("cora"), in_feats=256)

    # NodePad ladder with 25% admission slack: the stream adds 200 nodes to a
    # 2000-node graph, so the 2560 rung absorbs every update without moving.
    sc = GraphServeConfig(ladder=BucketLadder(buckets=(1024, 2560),
                                              slack=0.25),
                          batch_slots=1)
    eng = GraphServe(sc, seed=0, device=args.device)
    eng.register_model("gcn", cfg)
    eng.warmup()

    gid = eng.attach(base, model="gcn")
    _, pg = eng.graphs[gid]
    print(f"NodePad bucket: {pg.capacity} (graph starts at {base.num_nodes} "
          f"nodes, {eng.compiled_blobs} blobs warm)")

    stream = dynamic_graph_stream(base, steps=10, edges_per_step=64,
                                  nodes_per_step=20)
    t0 = time.perf_counter()
    for i, (ei, n, feats) in enumerate(stream):
        th = time.perf_counter()
        rebucketed = eng.update(gid, ei, n, feats)   # host: GraphSplit
        eng.query(gid)
        host_ms = (time.perf_counter() - th) * 1e3
        td = time.perf_counter()
        eng.run()                            # device: one plan, synced
        dev_ms = (time.perf_counter() - td) * 1e3
        print(f"step {i}: {n} nodes, {ei.shape[1]} edges | host "
              f"{host_ms:6.1f} ms, device {dev_ms:6.1f} ms, "
              f"rebucketed: {rebucketed}, blobs: {eng.compiled_blobs}")
    total = time.perf_counter() - t0

    eng.assert_warm()
    s = eng.summary()
    print(f"\n{s['requests']} graph updates in {total:.2f}s, compiled "
          f"EXACTLY {s['compiled_blobs']} blob(s), "
          f"{s['rebucket_events']} rebucket(s), p50 "
          f"{s['p50_latency_ms']:.1f} ms — GrAd/NodePad recompile-free "
          f"serving")
    if s["rebucket_events"] != 0:
        raise AssertionError(f"{s['rebucket_events']} rebucket(s)")


if __name__ == "__main__":
    main()
