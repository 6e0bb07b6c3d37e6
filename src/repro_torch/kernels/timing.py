"""Timing helpers for kernels on the card: a call's device time with the
host's launch gaps hidden, and the card's name and power limit to print
beside every time. Used by chip_smoke.py and `compare_builds`."""
from __future__ import annotations

import subprocess

import torch


def queued_ms(fn, iters=20, spin_ms=50.0):
    """Device ms of one call of `fn` with the host's launch gaps hidden: a
    spin kernel holds the stream while the host queues every call, so the
    events time the kernels back to back (torch.profiler misses some of a
    tight loop's ctypes launches). The spin grows until the host was ahead
    of the card; None when it never was (a call that waits for the card,
    or more launches than the card's queue holds)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(5):
        torch.cuda._sleep(int(spin_ms * 2e6))     # about spin_ms at 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()       # the spin still held the stream
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        spin_ms *= 4
    return None


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]
