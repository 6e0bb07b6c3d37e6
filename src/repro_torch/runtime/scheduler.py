"""The two-stage host/device pipeline that drives one GraphServe engine
(DESIGN.md §9).

Port of the reference's `runtime/scheduler.py`. The engine's sync path
runs both stages one after the other: `run()` starts only after every
submit has finished its host work, so the card idles through exactly the
preprocessing GraphSplit exists to hide. The scheduler overlaps them:

  intake ──▶ HOST stage                 ──▶ ready ──▶ DEVICE stage
  bounded    worker threads running         bounded   one dispatcher thread
  queue      engine.prepare_submit /        buffer    grouping ready requests
             prepare_query (NodePad,        (per      by batch key (model,
             the compact form and its       batch     bucket, tier, backend,
             upload, the materializer,      key)      fusion) and running
             the feature upload, cache                engine._execute_batch
             lookups)

On the card each host worker runs its stage on its own CUDA stream (the
kernel wrappers launch on the thread's current stream), and the engine
hands each request over to its dispatch stream with an event and
`record_stream` (`GraphServe._hand_over`); on the CPU the same code runs
with no streams.

Policies (`PipelineConfig`):

  * Batch window: a key with fewer ready requests than its width waits up
    to `window_ms` (from its oldest ready request) while host work is
    still in flight, then dispatches partial; `window_ms=0` dispatches
    what is ready at once.
  * Selection: `gnn_server.edf_best_fill_key`, the sync path's rule:
    fullest key first, then the most urgent deadline, then the model
    dispatched longest ago, then FIFO.
  * Backpressure: both queues are bounded. A full intake makes
    `submit`/`query` block (`backpressure="block"`, counted in
    `metrics["blocked"]`) or raise `QueueFull` ("reject", counted in
    `metrics["rejected"]`); a full ready buffer blocks the host workers,
    which fills the intake.
  * SLO (§14): the governor's `should_shed` refuses a request through the
    reject path whatever the backpressure mode; requests whose deadline
    passed in the ready buffer complete flagged without a dispatch.
  * Determinism: `deterministic=True` forces one host worker and
    `window_ms=0` and runs the pipeline inline on the caller's thread (no
    threads), so one submission order gives one batch composition, which
    the tests hold against the reference. Backpressure stays live: "block"
    advances the pipeline inline.

Every engine contract holds under the scheduler: plans and derivers only
replay (`assert_warm()`), cache accounting is unchanged (workers racing on
a cold key may both build; both count as misses and the insert is
version-checked), and tier fallback happens in the host stage as in the
sync path. A key's width is `batch_slots` for an unsharded key and
`replica_groups` for a sharded one (§15: one request per replica row),
in the selection, the take and the batch window alike.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.core.graph import Graph
from repro_torch.runtime.gnn_server import (BatchKey, GNNRequest, GraphServe,
                                            edf_best_fill_key)


class QueueFull(RuntimeError):
    """Raised by submit/query under `backpressure="reject"` when the intake
    queue holds `max_pending`, and when the SLO governor sheds load."""


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    host_workers: int = 2          # threads running the engine's host stage
    window_ms: float = 2.0         # most wait to fill a partial batch
    max_pending: int = 64          # intake queue bound (host stage input)
    max_ready: int = 64            # ready buffer bound (device stage input)
    backpressure: str = "block"    # "block" | "reject" on a full intake
    deterministic: bool = False    # one worker, window 0, inline drive

    def __post_init__(self):
        if self.backpressure not in ("block", "reject"):
            raise ValueError("backpressure must be 'block' or 'reject', "
                             f"got {self.backpressure!r}")
        if self.host_workers < 1:
            raise ValueError("host_workers must be >= 1")
        if self.max_pending < 1 or self.max_ready < 1:
            raise ValueError("queue bounds must be >= 1")


@dataclasses.dataclass
class _Work:
    """One accepted intake item, before its host stage ran."""
    ticket: int
    kind: str                      # "submit" | "query"
    submitted_s: float             # intake time (latency counts queue wait)
    model: Optional[str] = None
    graph: Optional[Graph] = None
    graph_id: Optional[int] = None
    tier: Optional[str] = None
    fusion: Optional[str] = None
    deadline_ms: Optional[float] = None   # §14: from submitted_s
    tolerance: Optional[float] = None     # §14: tier-router budget (points)


# One ready-buffer entry: (arrival serial, arrival time, request). The
# serial is the FIFO tie-break of the selection rule; the arrival time
# anchors the key's batch window.
_Ready = Tuple[int, float, GNNRequest]


class PipelineScheduler:
    """Drives one GraphServe engine as a host/device pipeline.

    Use it as a context manager (`with eng.scheduler(pc) as sched:`) or
    call `close()`; `drain()` waits until every accepted request completed
    and returns them in ticket order. The engine's sync API stays usable
    beside it: the scheduler adds requests only through the engine's
    prepare stages and `_execute_batch`, never through `engine.queue`.
    """

    def __init__(self, engine: GraphServe, pc: Optional[PipelineConfig] = None):
        pc = pc or PipelineConfig()
        if pc.deterministic:
            # one batch composition per submission order: one worker (host
            # order = submission order) and no window (dispatch depends on
            # the ready set only, never on thread timing)
            pc = dataclasses.replace(pc, host_workers=1, window_ms=0.0)
        self.engine = engine
        self.pc = pc
        self.metrics = {"accepted": 0, "rejected": 0, "blocked": 0,
                        "completed": 0, "host_busy_s": 0.0}
        self._cond = threading.Condition()
        self._pending: Deque[_Work] = deque()
        self._ready: Dict[BatchKey, Deque[_Ready]] = {}
        self._ready_count = 0
        self._inflight_host = 0        # popped from intake, not yet ready
        self._arrival_serial = 0
        self._next_ticket = 0
        self._results: Dict[int, GNNRequest] = {}
        self._errors: Dict[int, BaseException] = {}
        self._closed = False
        self._threads: List[threading.Thread] = []
        if not pc.deterministic:
            for i in range(pc.host_workers):
                t = threading.Thread(target=self._host_loop, args=(i,),
                                     name=f"graphserve-host-{i}", daemon=True)
                t.start()
                self._threads.append(t)
            t = threading.Thread(target=self._dispatch_loop,
                                 name="graphserve-dispatch", daemon=True)
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------- intake
    def submit(self, g: Graph, *, model: str,
               tier: Optional[str] = None,
               fusion: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               tolerance: Optional[float] = None) -> int:
        """Enqueue a one-shot request; returns a ticket (see `drain`). The
        deadline counts from here, so intake queue wait spends it."""
        return self._accept(_Work(ticket=-1, kind="submit",
                                  submitted_s=self.engine.clock.now(),
                                  model=model, graph=g, tier=tier,
                                  fusion=fusion, deadline_ms=deadline_ms,
                                  tolerance=tolerance))

    def query(self, graph_id: int, *, tier: Optional[str] = None,
              fusion: Optional[str] = None,
              deadline_ms: Optional[float] = None,
              tolerance: Optional[float] = None) -> int:
        """Enqueue a query over an attached graph; returns a ticket."""
        return self._accept(_Work(ticket=-1, kind="query",
                                  submitted_s=self.engine.clock.now(),
                                  graph_id=graph_id, tier=tier,
                                  fusion=fusion, deadline_ms=deadline_ms,
                                  tolerance=tolerance))

    def _accept(self, w: _Work) -> int:
        gov = self.engine.governor
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if gov is not None and gov.should_shed(len(self._pending)):
                # the governor's shed: quality is at the floor and the
                # queue keeps growing; refused through the reject path in
                # either backpressure mode, counted here and in the engine
                self.metrics["rejected"] += 1
                self.engine._count("shed_requests")
                raise QueueFull(
                    f"SLO governor shedding at queue depth "
                    f"{len(self._pending)} (level {gov.level})")
            if len(self._pending) >= self.pc.max_pending:
                if self.pc.backpressure == "reject":
                    self.metrics["rejected"] += 1
                    raise QueueFull(
                        f"intake queue at max_pending={self.pc.max_pending}")
                self.metrics["blocked"] += 1
                if self.pc.deterministic:
                    # inline backpressure: advance the pipeline here until
                    # the intake has room (no threads to wait on)
                    while len(self._pending) >= self.pc.max_pending:
                        self._step_inline()
                else:
                    while (len(self._pending) >= self.pc.max_pending
                           and not self._closed):
                        self._cond.wait()
                    if self._closed:
                        raise RuntimeError("scheduler closed while blocked")
            w = dataclasses.replace(w, ticket=self._next_ticket)
            self._next_ticket += 1
            self._pending.append(w)
            self.metrics["accepted"] += 1
            self._cond.notify_all()
            return w.ticket

    # --------------------------------------------------------- host stage
    def _prepare(self, w: _Work) -> GNNRequest:
        if w.kind == "submit":
            return self.engine.prepare_submit(w.graph, model=w.model,
                                              tier=w.tier, fusion=w.fusion,
                                              submitted_s=w.submitted_s,
                                              deadline_ms=w.deadline_ms,
                                              tolerance=w.tolerance)
        return self.engine.prepare_query(w.graph_id, tier=w.tier,
                                         fusion=w.fusion,
                                         submitted_s=w.submitted_s,
                                         deadline_ms=w.deadline_ms,
                                         tolerance=w.tolerance)

    def _host_loop(self, index: int) -> None:
        # on the card this worker's device work (uploads, materializer,
        # int8 Â, GraSp structure) queues on a stream of its own, which
        # the engine keeps for the next scheduler's worker of this index
        stream = self.engine.host_stream(index)
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending:
                    return                       # closed and drained
                w = self._pending.popleft()
                self._inflight_host += 1
                self._cond.notify_all()          # intake space freed
            t0 = time.perf_counter()
            req = err = None
            try:
                if stream is None:
                    req = self._prepare(w)
                else:
                    with torch.cuda.stream(stream):
                        req = self._prepare(w)
            except BaseException as exc:         # noqa: BLE001 - kept for
                err = exc                        # drain() to re-raise
            dt = time.perf_counter() - t0
            with self._cond:
                self.metrics["host_busy_s"] += dt
                if err is not None:
                    self._errors[w.ticket] = err
                    self._inflight_host -= 1
                    self.metrics["completed"] += 1
                    self._cond.notify_all()
                    continue
                while self._ready_count >= self.pc.max_ready and not self._closed:
                    self._cond.wait()            # ready full: hold intake
                self._push_ready_locked(w.ticket, req)
                self._inflight_host -= 1
                self._cond.notify_all()

    def _push_ready_locked(self, ticket: int, req: GNNRequest) -> None:
        key = (req.model, req.bucket, req.tier, req.backend, req.fusion,
               req.shards)
        self._ready.setdefault(key, deque()).append(
            (self._arrival_serial, self.engine.clock.now(), req))
        self._arrival_serial += 1
        self._ready_count += 1
        self._results[ticket] = req

    # ------------------------------------------------------- device stage
    def _expire_ready_locked(self) -> int:
        """The expiry sweep over the ready buffer (§14): requests whose
        deadline passed complete flagged (`GraphServe._complete_expired`:
        `deadline_missed`, no preds) instead of taking batch slots.
        Returns how many were swept. Runs under `_cond` and takes the
        engine lock inside, always in that order, never the reverse."""
        now = self.engine.clock.now()
        expired: List[GNNRequest] = []
        for key in list(self._ready):
            q = self._ready[key]
            keep = deque(item for item in q
                         if not (item[2].deadline_s is not None
                                 and item[2].deadline_s <= now))
            if len(keep) != len(q):
                expired.extend(item[2] for item in q
                               if item[2].deadline_s is not None
                               and item[2].deadline_s <= now)
                if keep:
                    self._ready[key] = keep
                else:
                    del self._ready[key]
        if expired:
            self._ready_count -= len(expired)
            self.engine._complete_expired(expired, now)
            self.metrics["completed"] += len(expired)
        return len(expired)

    def _select_locked(self) -> BatchKey:
        now = self.engine.clock.now()
        stats = {}
        for k, q in self._ready.items():
            slack = min((item[2].deadline_s - now
                         if item[2].deadline_s is not None else float("inf"))
                        for item in q)
            stats[k] = (len(q), q[0][0], slack)
        return edf_best_fill_key(stats, self.engine.sc.batch_slots,
                                 self.engine._last_dispatch,
                                 replica_slots=self.engine.sc.replica_groups)

    def _width(self, key: BatchKey) -> int:
        """Dispatch width of one batch key: a sharded key (§12) fills the
        replica rows (§15; 1 when `replica_groups` is 1, the shard axis
        taking the dim a batch would use), an unsharded key the batch
        slots."""
        return (self.engine.sc.replica_groups if key[5]
                else self.engine.sc.batch_slots)

    def _take_locked(self, key: BatchKey) -> List[GNNRequest]:
        q = self._ready[key]
        n = min(self._width(key), len(q))
        batch = [q.popleft()[2] for _ in range(n)]
        if not q:
            del self._ready[key]
        self._ready_count -= n
        return batch

    def _dispatch_loop(self) -> None:
        window_s = self.pc.window_ms * 1e-3
        while True:
            with self._cond:
                batch = None
                while batch is None:
                    if self._ready_count == 0:
                        if (self._closed and not self._pending
                                and self._inflight_host == 0):
                            return
                        self._cond.wait()        # device idle: nothing ready
                        continue
                    if self._expire_ready_locked():
                        # expired requests completed without a dispatch:
                        # ready space freed, look again
                        self._cond.notify_all()
                        continue
                    key = self._select_locked()
                    fill = len(self._ready[key])
                    unready = len(self._pending) + self._inflight_host
                    if (fill < self._width(key) and unready > 0
                            and window_s > 0):
                        # batch window: stragglers are still in the host
                        # stage; wait (to the key's oldest arrival plus
                        # the window) for a fuller batch
                        deadline = self._ready[key][0][1] + window_s
                        now = self.engine.clock.now()
                        if now < deadline:
                            self._cond.wait(deadline - now)
                            continue
                    batch = self._take_locked(key)
                    self._cond.notify_all()      # ready space freed
            self.engine._execute_batch(batch)
            with self._cond:
                self.metrics["completed"] += len(batch)
                self._cond.notify_all()

    # ------------------------------------------------- deterministic drive
    def _step_inline(self) -> None:
        """Advance the inline pipeline one step: host work first (FIFO)
        while the ready buffer has room, else one selected batch.
        Deterministic mode only."""
        if self._pending and self._ready_count < self.pc.max_ready:
            w = self._pending.popleft()
            t0 = time.perf_counter()
            req = self._prepare(w)               # inline: errors propagate
            self.metrics["host_busy_s"] += time.perf_counter() - t0
            self._push_ready_locked(w.ticket, req)
            return
        if self._ready_count:
            self._expire_ready_locked()          # §14 sweep before select
        if self._ready_count:
            batch = self._take_locked(self._select_locked())
            self.engine._execute_batch(batch)
            self.metrics["completed"] += len(batch)

    # ------------------------------------------------------------ lifecycle
    def drain(self, timeout: Optional[float] = None) -> List[GNNRequest]:
        """Run or wait until every accepted request completed; return them
        in ticket order. A host-stage error (the earliest ticket's) is
        re-raised and consumed, so a caller that catches it can call
        `drain()` again for the completed requests (an errored ticket has
        no result). Raises `TimeoutError` past `timeout` seconds."""
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        if self.pc.deterministic:
            while self._pending or self._ready_count:
                if deadline is not None and time.perf_counter() > deadline:
                    raise TimeoutError(
                        f"{len(self._pending) + self._ready_count} "
                        "request(s) still undispatched")
                self._step_inline()
        else:
            with self._cond:
                while self.metrics["completed"] < self.metrics["accepted"]:
                    left = (deadline - time.perf_counter()
                            if deadline is not None else None)
                    if left is not None and left <= 0:
                        raise TimeoutError(
                            f"{self.metrics['accepted'] - self.metrics['completed']}"
                            " request(s) still in flight")
                    self._cond.wait(left)
        if self._errors:
            errors, self._errors = self._errors, {}
            raise errors[min(errors)]
        return [self._results[t] for t in sorted(self._results)]

    def close(self) -> None:
        """Stop accepting, finish outstanding work, join the threads.
        Idempotent; the engine stays usable afterwards."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self.pc.deterministic:
            while self._pending or self._ready_count:
                self._step_inline()
        for t in self._threads:
            t.join()
        self._threads = []

    def __enter__(self) -> "PipelineScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- metrics
    def summary(self) -> Dict[str, object]:
        """The engine's summary (device_busy_s and device_idle_fraction
        included) with the pipeline's own counters under `"pipeline"`."""
        s = self.engine.summary()
        with self._cond:
            s["pipeline"] = {
                "host_workers": self.pc.host_workers,
                "window_ms": self.pc.window_ms,
                "deterministic": self.pc.deterministic,
                "accepted": self.metrics["accepted"],
                "completed": self.metrics["completed"],
                "rejected": self.metrics["rejected"],
                "blocked": self.metrics["blocked"],
                "host_busy_s": self.metrics["host_busy_s"],
            }
        return s
