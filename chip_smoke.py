#!/usr/bin/env python3
"""Drive the PyTorch port's GCN serving path on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its
last line; there is no CPU path):

  1. build — compile every CUDA kernel of the path from
     `src/repro_torch/kernels/csrc/` (one nvcc per source, in parallel) and
     print ptxas's register/shared-memory lines;
  2. kernels — `block_matmul` and `fused_gcn_dense` against their plain
     PyTorch versions at the serving shapes (4 Cora-sized graphs padded to
     3072 nodes, features 1433 -> 1536, widths padded to 128);
  3. serving — a GraphServe on the card with the Cora 2-layer GCN twice:
     `gcn` with `fusion="layer"` (fused_gcn_dense) and `gcn_mm` with
     `use_pallas` (block_matmul). Cora and five Planetoid-like graphs go to
     each model, one graph is attached and queried twice; every logit is
     held against a forward through the plain versions, and the kernels'
     launch counts must equal what the dispatched batches imply;
  4. times — CUDA-event times of each kernel, its plain version and the
     matching library call at the serving shapes, beside the card's bound.

Output: progress lines, the card's name and power limit, one
`{"kernels": [...]}` line, and last `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.gnn import gcn  # noqa: E402
from repro_torch.core.graph import BucketLadder, pad_graph  # noqa: E402
from repro_torch.core.layers import Techniques  # noqa: E402
from repro_torch.data.graphs import cora_like, planetoid_like  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import fused_layers as fl  # noqa: E402
from repro_torch.runtime.gnn_server import (GraphServe,  # noqa: E402
                                            GraphServeConfig)

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 and fp32 outside the
# tensor cores — the fp32 SIMT kernels' roofline.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
LADDER, SLOTS = (1024, 3072), 4
CAP, FIN_PAD, TILE = 3072, 1536, 128
PLANETOID_SIZES = (300, 700, 1000, 1800, 2700)
# fp32 kernel vs cuBLAS fp32 (TF32 off): same products, other summation
# order over K <= 3072
TOL = dict(rtol=1e-4, atol=1e-5)
SOURCES = {"block_matmul": ("src/repro_torch/kernels/csrc/block_matmul.cu",
                            "src/repro/kernels/block_matmul.py:35"),
           "fused_gcn_dense": ("src/repro_torch/kernels/csrc/"
                               "fused_gcn_dense.cu",
                               "src/repro/kernels/fused_layers.py:97")}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def glorot(rng, fan_in, fan_out):
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)


def pad_to(a, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def time_ms(fn, iters=20):
    """Mean device time of one call, by CUDA events over `iters` warm calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    """(least ms the card needs, what bounds it) at the published peaks."""
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def matmul_work(a, b):
    bsz, m, k = a.shape
    n = b.shape[-1]
    return 2.0 * bsz * m * n * k, 4.0 * (a.numel() + b.numel() + bsz * m * n)


def fused_work(adj, x, w):
    bsz, n, fin = x.shape
    o = w.shape[1]
    flops = 2.0 * bsz * n * fin * o + 2.0 * bsz * n * n * o
    return flops, 4.0 * (adj.numel() + x.numel() + w.numel() + o + bsz * n * o)


def graphs():
    cora = cora_like(seed=0)
    others = [planetoid_like(num_nodes=n, num_edges=2 * n, num_feats=1433,
                             num_classes=7, seed=1 + i)
              for i, n in enumerate(PLANETOID_SIZES)]
    return cora, others


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {len(logs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"[build] {lib}: {line.strip()}")

    # ------------------------------------------------- 2. kernel checks
    rng = np.random.default_rng(0)
    cora, others = graphs()
    batch_graphs = [cora, others[3], others[4], cora]        # 3072 bucket
    pgs = [pad_graph(g, capacity=CAP) for g in batch_graphs]
    adj = torch.from_numpy(np.stack([p.norm_adj for p in pgs])).to(dev)
    x1 = torch.from_numpy(np.stack([pad_to(p.features, (CAP, FIN_PAD))
                                    for p in pgs])).to(dev)
    w1_np, w2_np = glorot(rng, 1433, 64), glorot(rng, 64, 7)
    b1_np = (0.1 * rng.standard_normal(64)).astype(np.float32)
    b2_np = (0.1 * rng.standard_normal(7)).astype(np.float32)
    w1 = torch.from_numpy(pad_to(w1_np, (FIN_PAD, TILE))).to(dev)
    w2 = torch.from_numpy(pad_to(w2_np, (TILE, TILE))).to(dev)
    b1 = torch.from_numpy(pad_to(b1_np, (TILE,))).to(dev)
    b2 = torch.from_numpy(pad_to(b2_np, (TILE,))).to(dev)
    h1 = bm.block_matmul_plain(x1, w1)
    x2 = fl.fused_gcn_dense_plain(adj, x1, w1, b1, "relu")   # layer-2 input
    h2 = bm.block_matmul_plain(x2, w2)
    products = {"L1 X@W": (x1, w1), "L1 A@H": (adj, h1),
                "L2 X@W": (x2, w2), "L2 A@H": (adj, h2)}
    layers = {"L1 relu": (adj, x1, w1, b1, "relu"),
              "L2 none": (adj, x2, w2, b2, "none")}
    err = {"block_matmul": 0.0, "fused_gcn_dense": 0.0}

    def compare(kernel, label, run, want):
        # the kernels match cuBLAS bit for bit here, so equal outputs alone
        # would not show that the kernel ran: its counter must move too
        mod = bm if kernel == "block_matmul" else fl
        before = mod.LAUNCHES
        got = run()
        check(mod.LAUNCHES == before + 1, f"{kernel} {label}: no launch")
        torch.cuda.synchronize()
        diff = (got - want).abs()
        rel = (diff / want.abs().clamp_min(1e-6)).max().item()
        print(f"[check] {kernel} {label} {tuple(got.shape)}: max_abs_err "
              f"{diff.max().item():.3e} max_rel_err {rel:.3e} "
              f"(tol rtol={TOL['rtol']} atol={TOL['atol']})", flush=True)
        torch.testing.assert_close(got, want, **TOL)
        err[kernel] = max(err[kernel], diff.max().item())

    for label, (a, b) in products.items():
        compare("block_matmul", label, lambda: bm.block_matmul(a, b),
                bm.block_matmul_plain(a, b))
    for label, args in layers.items():
        compare("fused_gcn_dense", label, lambda: fl.fused_gcn_dense(*args),
                fl.fused_gcn_dense_plain(*args))

    # -------------------------------------------------------- 3. serving
    cfg = gcn("cora")
    params = params_from_jax({"l1": {"w": w1_np, "b": b1_np},
                              "l2": {"w": w2_np, "b": b2_np}}, device=dev)
    eng = GraphServe(GraphServeConfig(ladder=BucketLadder(buckets=LADDER),
                                      batch_slots=SLOTS, return_logits=True,
                                      use_cacheg=False), seed=0, device=dev)
    eng.register_model("gcn", cfg, params, fusion="layer")
    eng.register_model("gcn_mm", cfg, params, techniques=Techniques(
        stagr=True, grad_dynamic=True, graphsplit=True, use_pallas=True))
    t0 = time.perf_counter()
    blobs = eng.warmup()
    print(f"[serve] warmup: {blobs} plan signatures in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    bm.LAUNCHES = fl.LAUNCHES = 0           # the main path starts here
    t_serve = time.perf_counter()
    for model in ("gcn", "gcn_mm"):
        for g in [cora] + others:
            eng.submit(g, model=model)
    gid = eng.attach(planetoid_like(num_nodes=900, num_edges=1800,
                                    num_feats=1433, num_classes=7, seed=11),
                     model="gcn")
    eng.query(gid)
    eng.query(gid)
    intake_s = time.perf_counter() - t_serve   # host prep + operand upload
    per_key = Counter((r.model, r.bucket, r.fusion) for r in eng.queue)
    done = eng.run()
    serve_s = time.perf_counter() - t_serve
    launches = {"block_matmul": bm.LAUNCHES, "fused_gcn_dense": fl.LAUNCHES}

    batches = {k: -(-n // SLOTS) for k, n in per_key.items()}
    want = {"fused_gcn_dense": 2 * sum(v for k, v in batches.items()
                                       if k[2] == "layer"),
            "block_matmul": 4 * sum(v for k, v in batches.items()
                                    if k[0] == "gcn_mm" and k[2] == "none")}
    print(f"[serve] {len(done)} requests in {sum(batches.values())} batches "
          f"{sorted(batches.items())}; launches {launches}, expected {want}",
          flush=True)
    check(eng.metrics["batches"] == sum(batches.values()),
          f"{eng.metrics['batches']} batches dispatched, expected "
          f"{sum(batches.values())}")
    check(launches == want, f"kernel launches {launches} != {want}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(len(done) == 2 * (1 + len(PLANETOID_SIZES)) + 2,
          f"{len(done)} requests finished")
    eng.assert_warm()

    p1, p2 = params["l1"], params["l2"]
    agree = []
    for r in done:
        n = r.pg.num_nodes
        check(r.logits is not None and r.logits.shape == (n, 7)
              and np.isfinite(r.logits).all(),
              f"request {r.uid}: logits missing, misshapen or not finite")
        a = torch.from_numpy(r.pg.norm_adj).to(dev)[None]
        x = torch.from_numpy(r.pg.features).to(dev)[None]
        if r.fusion == "layer":
            h = fl.fused_gcn_dense_plain(a, x, p1["w"], p1["b"], "relu")
            ref = fl.fused_gcn_dense_plain(a, h, p2["w"], p2["b"], "none")
        else:
            h = torch.relu(bm.block_matmul_plain(
                a, bm.block_matmul_plain(x, p1["w"])) + p1["b"])
            ref = bm.block_matmul_plain(
                a, bm.block_matmul_plain(h, p2["w"])) + p2["b"]
        ref = ref[0, :n].cpu()
        torch.testing.assert_close(torch.from_numpy(r.logits), ref, **TOL)
        agree.append(float((r.preds == ref.argmax(-1).numpy()).mean()))
    s = eng.summary()
    print(f"[serve] logits of all {len(done)} requests match the plain "
          f"forward (rtol={TOL['rtol']} atol={TOL['atol']}); argmax "
          f"agreement min {min(agree):.4f}", flush=True)
    print("[serve] summary " + json.dumps(
        {k: s[k] for k in ("requests", "batches", "batch_occupancy",
                           "p50_latency_ms", "p99_latency_ms",
                           "throughput_rps", "device_busy_s",
                           "device_idle_fraction", "operand_bytes_h2d",
                           "compiled_blobs")}
        | {"wall_s": serve_s, "intake_s": intake_s,
           "run_s": serve_s - intake_s}), flush=True)

    # ---------------------------------------------------------- 4. times
    rows = []
    for kernel, cases in (("block_matmul", products), ("fused_gcn_dense",
                                                       layers)):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "flops": 0.0, "bytes": 0.0}
        for label, args in cases.items():
            if kernel == "block_matmul":
                a, b = args
                t_k = time_ms(lambda: bm.block_matmul(a, b))
                t_p = time_ms(lambda: bm.block_matmul_plain(a, b))
                t_l = time_ms(lambda: torch.matmul(a, b))
                flops, nbytes = matmul_work(a, b)
            else:
                t_k = time_ms(lambda: fl.fused_gcn_dense(*args))
                t_p = time_ms(lambda: fl.fused_gcn_dense_plain(*args))
                t_l = None
                flops, nbytes = fused_work(*args[:3])
            b_ms, b_by = bound(flops, nbytes)
            print(f"[time] {kernel} {label}: kernel {t_k:.4f} ms, plain "
                  f"{t_p:.4f} ms, library "
                  f"{'n/a' if t_l is None else f'{t_l:.4f} ms'}, bound "
                  f"{b_ms:.4f} ms ({b_by}); {flops / t_k / 1e9:.1f} TFLOP/s",
                  flush=True)
            tot["ms"] += t_k
            tot["plain_ms"] += t_p
            tot["library_ms"] = (None if t_l is None
                                 else tot["library_ms"] + t_l)
            tot["flops"] += flops
            tot["bytes"] += nbytes
        b_ms, b_by = bound(tot["flops"], tot["bytes"])
        src, replaces = SOURCES[kernel]
        rows.append({"name": kernel, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kernel],
                     "max_abs_err": err[kernel], "ms": tot["ms"],
                     "plain_ms": tot["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": tot["library_ms"],
                     "per": f"one batch of {SLOTS} graphs at {CAP} nodes: "
                            + ", ".join(cases)})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
