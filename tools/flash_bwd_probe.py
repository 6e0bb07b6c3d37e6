#!/usr/bin/env python3
"""flash_attention_bwd alone on the card: the quickest check of the
PyTorch port's attention backward after a change to its kernels.

It builds the two backward libraries and the forward's tensor-core one
(printing ptxas's registers and spills and the SASS's HGMMA and UTMALDG
counts), then runs `flash_attention_bwd` on chip_smoke.py's BWD_CASES,
on ten more tensor-core shapes (ragged Sq and Skv, q_offset, windows
past the keys, softcaps at D 64, 96 and 128) and on every case of
tests/test_torch_cuda.py's FLASH_CASES at D 64, 96 and 128 in bf16,
printing each case's route and its dq, dk and dv error against float64
beside the plain backward's (the bar is 2x), checks that two calls at
SmolLM's training shape are bit-equal, times both BWD_TIMED shapes as
chip_smoke.py's kernels row does (`bwd_row`: events, queued, SDPA's
backward, the SIMT route at SmolLM's shape), and splits each call's
device time between its two kernels with torch.profiler.

Run from the repo root on a machine with a card (about 60 s):
    python3 tools/flash_bwd_probe.py
It exits 1 when a case fails the bar or differs between two calls.
"""
from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from test_torch_cuda import FLASH_CASES  # noqa: E402

BF = torch.bfloat16
# (B, Sq, Skv, H, KV, D), causal, window, softcap, q_offset
EXTRA = {
    "d96 noncausal 65x129": ((2, 65, 129, 8, 4, 96), False, None, None, 0),
    "d96 window softcap": ((1, 65, 129, 8, 4, 96), True, 30, 50.0, 64),
    "d64 window past keys": ((2, 64, 129, 6, 2, 64), True, 40, None, 130),
    "d128 window past keys": ((1, 65, 65, 4, 4, 128), False, 30, None, 100),
    "d64 ragged 63": ((2, 63, 63, 9, 3, 64), True, None, None, 0),
    "d128 ragged 129": ((2, 129, 129, 8, 2, 128), True, None, None, 0),
    "d64 q_offset": ((2, 64, 192, 8, 2, 64), True, None, None, 128),
    "d128 noncausal 100x129": ((2, 100, 129, 8, 4, 128), False, None, None,
                               0),
    "d64 window 64 softcap 50": ((2, 256, 256, 8, 4, 64), True, 64, 50.0, 0),
    "d128 softcap 30, 200 x 330, q_offset 130": (
        (2, 200, 330, 8, 2, 128), True, None, 30.0, 130),
}


def cases():
    out = {label: case[:6] for label, case in cs.BWD_CASES.items()}
    out.update({label: case + (BF,) for label, case in EXTRA.items()})
    for label, (b, sq, skv, h, kv, d, causal, window, cap,
                off) in FLASH_CASES.items():
        if d in fa.TC_HEAD_DIMS:
            out["flash case " + label] = ((b, sq, skv, h, kv, d), causal,
                                          window, cap, off, BF)
    return out


def check_case(rng, dev, label, shape, causal, window, cap, off, dtype):
    """One case: its route and each gradient's error against float64
    beside the plain backward's. Returns the largest ratio."""
    opts = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    q, k, v = cs.flash_inputs(rng, shape, dtype, dev)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(dev, dtype)
    tc = fa.BWD_TC_LAUNCHES
    got = fa.flash_attention_bwd(q, k, v, dout, **opts)
    torch.cuda.synchronize()
    route = "wgmma" if fa.BWD_TC_LAUNCHES > tc else "simt"
    plain = kref.flash_attention_bwd_ref(q, k, v, dout, **opts)
    exact = cs.attention_f64_grads(q, k, v, dout, **opts)
    worst, parts = 0.0, []
    for name, g, p_, x in zip(("dq", "dk", "dv"), got, plain, exact):
        e_k = (g.double() - x).abs().max().item()
        e_p = (p_.double() - x).abs().max().item()
        ratio = e_k / e_p if e_p else (0.0 if e_k == 0 else math.inf)
        if not torch.isfinite(g).all():
            ratio = math.inf
        worst = max(worst, ratio)
        parts.append(f"{name} {e_k:.3e} (plain {e_p:.3e}, {ratio:.2f}x)")
    print(f"[case] {label} route {route}: "
          f"{'ok' if worst <= 2 else 'FAIL'} " + ", ".join(parts),
          flush=True)
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_probe: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    logs = _build.build(["flash_attention_tc", "flash_attention_bwd_tc",
                         "flash_attention_bwd"])
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for line in logs["flash_attention_bwd_tc"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("[ptxas]", line.strip(), flush=True)
    for lib in ("flash_attention_bwd_tc", "flash_attention_tc"):
        print("[sass]", lib, _build.sass_counts(lib, cs.SASS[lib]),
              flush=True)
    card = cs.card_line()
    print(card, flush=True)

    rng = np.random.default_rng(37)
    worst = max(check_case(rng, dev, label, *case)
                for label, case in cases().items())
    q, k, v = cs.flash_inputs(rng, cs.BWD_TIMED["smollm_train"], BF, dev)
    dout = torch.randn_like(q)
    first = fa.flash_attention_bwd(q, k, v, dout)
    second = fa.flash_attention_bwd(q, k, v, dout)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"[determinism] two calls at SmolLM's shape bit-equal: {same}",
          flush=True)
    del q, k, v, dout, first, second

    print("[row]", cs.bwd_row(dev, 0, (0.0, 0.0, 0.0), card), flush=True)
    for key, shape in cs.BWD_TIMED.items():
        q, k, v = cs.flash_inputs(rng, shape, BF, dev)
        dout = torch.randn_like(q)
        kernels = cs.device_kernels(
            lambda: fa.flash_attention_bwd(q, k, v, dout), iters=10)
        print(f"[profile] {key}: device ms a call by kernel "
              + str({name[:60]: round(ms / 10, 4)
                     for name, (ms, _) in kernels.items()}) + f"; {card}",
              flush=True)
    print(f"[probe] worst error ratio {worst:.3f} (bar 2), determinism "
          f"{same}", flush=True)
    return 0 if worst <= 2 and same else 1


if __name__ == "__main__":
    sys.exit(main())
