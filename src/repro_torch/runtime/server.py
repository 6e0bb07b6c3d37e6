"""LM serving runtime: bucketed prefill and batched decode with per-slot
cursors, for the dense, moe, ssm, hybrid and vlm families.

  * Prompts are right-padded to one of a fixed set of BUCKET lengths and
    the KV cache to one max_len, so the server keeps one prefill callable
    per bucket and one decode callable: `compile_count` counts
    len(buckets) + 1 at most, one per ("prefill", bucket) key and one for
    decode, as the reference's jit cache does. Nothing is compiled here:
    PyTorch runs eagerly, and CUDA graphs of the decode step are later
    speed work.
  * Per-slot cache cursors (`pos`, a (B,) vector) are inputs, so evolving
    sequence state creates no new callable.

Two scheduling modes, as the reference:
  * "continuous" — per-slot positions: decode starts at each slot's prompt
    length. The first token of every slot comes from the prefill's last
    *padded* position, as in the reference (ROADMAP queue 3).
  * "wave" — lockstep: decode starts at the longest prompt's length.
    SSM and hybrid models (`attention_free`, layer patterns "ssm" and
    "jamba") always run in waves, as in the reference. Their recurrent
    state has no per-slot rewind: a prompt shorter than its bucket is
    right-padded, and the state integrates the padded positions too
    (ROADMAP queue 3), as the reference's does.

A vision model (phi-3-vision) is served on its text backbone alone, with
no patches, as the reference's server serves it; its patch prefix goes
through `lm_prefill(prefix_embeds=)` directly. An encoder-decoder
(whisper) is refused: this server takes no frames, and the reference's
fails at its first decode step (its cross layers find no encoder K and
V); its path is `lm_prefill(enc_embeds=)` and `lm_decode_step`.

Prefill runs its attention through the hand-written `flash_attention`
kernel on the card (`nn/attention.py`). The server records, per wave, the
time from the wave's start to its first token on the host (`ttft_s`, with
the bucket) and the decode time (`decode_s`); both end in a device sync.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn import lm
from repro_torch.nn.config import ArchConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (L,) int32
    max_new_tokens: int = 16
    done: bool = False
    output: Optional[np.ndarray] = None
    submitted_s: float = 0.0
    finished_s: float = 0.0


@dataclasses.dataclass
class ServeConfig:
    buckets: tuple = (64, 128, 256)     # prompt buckets
    max_len: int = 512                  # cache capacity (prompt + decode)
    batch_slots: int = 4                # decode batch width
    mode: str = "continuous"            # continuous | wave


class Server:
    def __init__(self, cfg: ArchConfig, sc: ServeConfig,
                 params: Optional[lm.LMParams] = None, *, seed: int = 0,
                 device: DeviceLike = None):
        if cfg.is_encdec:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: the Server takes no "
                "frames; serve it through lm_prefill(enc_embeds=) and "
                "lm_decode_step")
        self.cfg = cfg
        self.sc = sc
        if cfg.attention_free or cfg.layer_pattern in ("ssm", "jamba"):
            self.sc = dataclasses.replace(sc, mode="wave")
        self.device = resolve_device(device)
        if params is None:
            # drawn on the server's device, each matrix rounded to the
            # compute dtype as it is made: a full-width model never exists
            # in float32
            params = lm.lm_init(cfg, seed=seed, device=self.device,
                                dtype=cfg.dtype)
        if params.embed.device != self.device:
            raise ValueError(f"params lie on {params.embed.device}, "
                             f"the server on {self.device}")
        self.params = lm.to_compute_dtype(params, cfg)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.compile_count = 0
        self._compiled: Dict[Any, Callable] = {}
        self.metrics = {"prefills": 0, "decode_steps": 0, "tokens_out": 0,
                        "queue_wait_s": [], "ttft_s": [], "decode_s": 0.0}

    # ------------------------------------------------------------------ API
    def submit(self, prompt: np.ndarray, *, max_new_tokens: int = 16) -> int:
        uid = len(self.queue) + len(self.finished)
        self.queue.append(Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                                  max_new_tokens=max_new_tokens,
                                  submitted_s=time.perf_counter()))
        return uid

    def bucket_for(self, length: int) -> int:
        for b in self.sc.buckets:
            if length <= b:
                return b
        raise ValueError(f"prompt length {length} exceeds largest bucket "
                         f"{self.sc.buckets[-1]}")

    # ---------------------------------------------------- step callables
    def _prefill_fn(self, bucket: int) -> Callable:
        key = ("prefill", bucket)
        if key not in self._compiled:
            cfg, max_len = self.cfg, self.sc.max_len

            def fn(params, tokens):
                return lm.lm_prefill(params, cfg, tokens, max_len=max_len)
            self._compiled[key] = fn
            self.compile_count += 1
        return self._compiled[key]

    def _decode_fn(self) -> Callable:
        key = ("decode",)
        if key not in self._compiled:
            cfg = self.cfg

            def fn(params, token, caches, pos):
                state = lm.ServeState(caches=caches, pos=pos)
                logits, state = lm.lm_decode_step(params, cfg, token, state)
                nxt = logits.argmax(-1).to(torch.int32)
                return nxt, state.caches, state.pos
            self._compiled[key] = fn
            self.compile_count += 1
        return self._compiled[key]

    # ------------------------------------------------------------- scheduling
    def run(self) -> List[Request]:
        with torch.inference_mode():
            while self.queue:
                self._run_wave()
        return self.finished

    def _take_batch(self) -> List[Request]:
        batch = self.queue[: self.sc.batch_slots]
        self.queue = self.queue[self.sc.batch_slots:]
        return batch

    def _run_wave(self):
        """One wave: pad a batch of prompts to a common bucket, prefill,
        decode in lockstep with per-slot cursors."""
        batch = self._take_batch()
        if not batch:
            return
        t0 = time.perf_counter()
        b, dev = self.sc.batch_slots, self.device
        lens = [len(r.prompt) for r in batch]
        bucket = self.bucket_for(max(lens))
        toks = np.zeros((b, bucket), np.int32)
        plens = np.ones((b,), np.int32)     # empty slots decode junk, dropped
        for i, r in enumerate(batch):
            toks[i, : lens[i]] = r.prompt
            plens[i] = lens[i]

        prefill = self._prefill_fn(bucket)
        logits, state = prefill(self.params,
                                torch.from_numpy(toks).long().to(dev))
        self.metrics["prefills"] += 1
        for r in batch:
            self.metrics["queue_wait_s"].append(
                time.perf_counter() - r.submitted_s)
        if self.sc.mode == "continuous":
            pos = torch.from_numpy(plens).to(dev)
        else:
            pos = torch.tensor(max(lens), dtype=torch.int32, device=dev)
        # the first token comes from the last padded prompt position, as
        # in the reference
        tok = logits.argmax(-1).to(torch.int32)

        steps = max(r.max_new_tokens for r in batch)
        outs = np.zeros((b, steps), np.int32)
        outs[:, 0] = tok.cpu().numpy()
        t1 = time.perf_counter()
        self.metrics["ttft_s"].append((bucket, t1 - t0))
        decode = self._decode_fn()
        caches = state.caches
        for t in range(1, steps):
            tok, caches, pos = decode(self.params, tok, caches, pos)
            outs[:, t] = tok.cpu().numpy()
            self.metrics["decode_steps"] += 1
        now = time.perf_counter()
        self.metrics["decode_s"] += now - t1
        for i, r in enumerate(batch):
            n = r.max_new_tokens
            r.output = outs[i, :n]
            r.done = True
            r.finished_s = now
            self.metrics["tokens_out"] += int(n)
            self.finished.append(r)

    # ---------------------------------------------------------------- metrics
    def summary(self) -> Dict[str, Any]:
        waits = self.metrics["queue_wait_s"]
        return {
            "requests": len(self.finished),
            "compiled_blobs": self.compile_count,
            "prefills": self.metrics["prefills"],
            "decode_steps": self.metrics["decode_steps"],
            "tokens_out": self.metrics["tokens_out"],
            "mean_queue_wait_s": float(np.mean(waits)) if waits else 0.0,
        }
