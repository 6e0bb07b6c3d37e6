"""Quickstart: GraNNite GNN inference on a Cora-shaped graph, on the card.

Trains the paper's 2-layer GCN (100 epochs, lr 0.01, weight decay 5e-4),
then runs the same parameters through
 (a) the baseline edge-list path (the default mapping: gathers and
     scatters, the normalisation in the forward),
 (b) the GraNNite dense path (StaGr + PreG + GraphSplit), and
 (c) the whole stack with QuantGr INT8 (`calibrate_quant`'s offline
     form through the `fused_gcn_int8` kernel on a card),
printing the accuracy and the time of each: a miniature of the paper's
Fig. 20/22. Times are CUDA-event ms on a card, printed beside its name and
power limit; host ms on the CPU.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart \\
      --device cpu --epochs 3 --nodes 220      # a tiny graph on the CPU
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs.gnn import gcn
from repro_torch.core.graph import add_self_loops, pad_graph
from repro_torch.core.layers import Techniques
from repro_torch.core.models import (GNNConfig, build_operands,
                                     calibrate_quant, evaluate,
                                     forward_baseline, forward_grannite,
                                     train_node_classifier)
from repro_torch.data.graphs import cora_like, planetoid_like
from repro_torch.device import resolve_device


def timed_ms(fn, dev: torch.device, n: int = 5) -> float:
    """Mean ms of one call after a warm call: CUDA events on a card, the
    host's clock on the CPU."""
    with torch.no_grad():
        fn()
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) / n * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=0,
                    help="a Planetoid-like graph of this many nodes and 64 "
                         "features instead of the Cora-shaped one")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.nodes:
        g = planetoid_like(num_nodes=args.nodes, num_edges=3 * args.nodes,
                           num_feats=64, num_classes=7, seed=0,
                           train_per_class=5)
        cfg = GNNConfig(kind="gcn", in_feats=64, hidden=64, num_classes=7)
        name = "a Planetoid-like"
    else:
        g, cfg, name = cora_like(), gcn("cora"), "a Cora-shaped"
    print(f"== GraNNite quickstart: GCN on {name} graph ({dev}) ==")
    pg = pad_graph(g)           # NodePad: 2708 -> 2816 on Cora
    print(f"graph: {g.num_nodes} nodes / {g.num_edges} edges, padded to "
          f"{pg.capacity}")
    ops_ = build_operands(pg, cfg, device=dev)  # GraphSplit: host PreG/StaGr

    def fwd_dense(p, x):
        return forward_grannite(p, cfg, x, ops_, Techniques(stagr=True))

    print(f"training 2-layer GCN ({args.epochs} epochs, lr 0.01, wd 5e-4)...")
    params = train_node_classifier(torch.Generator().manual_seed(0), cfg, pg,
                                   fwd_dense, epochs=args.epochs, device=dev)
    acc = evaluate(cfg, params, pg, fwd_dense, device=dev)
    print(f"test accuracy (fp32 dense path): {acc:.3f}")

    x = torch.from_numpy(pg.features).to(dev)
    ei = torch.from_numpy(add_self_loops(g.edge_index, g.num_nodes)).to(dev)
    ops_q = dataclasses.replace(ops_,
                                quant=calibrate_quant(params, cfg, x, ops_))
    t_q = Techniques(stagr=True, quantgr=True)

    def fwd_quant(p, xx):
        return forward_grannite(p, cfg, xx, ops_q, t_q, fusion="layer")

    tb = timed_ms(lambda: forward_baseline(params, cfg, x, ei, pg.capacity),
                  dev)
    td = timed_ms(lambda: fwd_dense(params, x), dev)
    tq = timed_ms(lambda: fwd_quant(params, x), dev)
    acc_q = evaluate(cfg, params, pg, fwd_quant, device=dev)
    if dev.type == "cuda":
        from repro_torch.kernels.timing import card_line
        print(f"card: {card_line()} (CUDA events)")
    else:
        print("timed on the host clock")
    print(f"baseline (gather/scatter): {tb:7.2f} ms   1.00x")
    print(f"GraNNite (StaGr dense)   : {td:7.2f} ms   {tb / td:.2f}x")
    print(f"+ QuantGr INT8           : {tq:7.2f} ms   {tb / tq:.2f}x "
          f"(accuracy {acc_q:.3f}, delta {acc_q - acc:+.3f})")


if __name__ == "__main__":
    main()
