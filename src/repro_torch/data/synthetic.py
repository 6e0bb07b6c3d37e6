"""Deterministic synthetic token stream for LM training (numpy host code).

A copy of the reference's `data/synthetic.py`, so that the port needs
nothing of it: each batch is a pure function of (seed, step, host), drawn
by numpy's counter-based Philox, so a run restored at step k regenerates
exactly the batches from k on, and each host makes only its slice of the
global batch. The batches are bit for bit the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"divide across {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """tokens, labels (the next tokens) and mask (all ones), each
        (host_batch, seq_len) int32, from Philox keyed on (seed, step,
        host)."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, step, self.host_id]))
        tokens = rng.integers(0, self.vocab_size,
                              size=(self.host_batch, self.seq_len + 1),
                              dtype=np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
                "mask": np.ones((self.host_batch, self.seq_len),
                                dtype=np.int32)}


def lm_batch_iterator(stream: TokenStream, *, start_step: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield stream.batch_at(step)
        step += 1
