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

On a mesh of ranks (`GraphServe(mesh=)`) every rank opens the scheduler
and makes the same calls on it. The lead (the mesh's origin rank) runs
the pipeline above. Before each sharded batch's first collective its
dispatcher tells the mesh the batch's uids, its tier and the sharded
requests expired since the last message (`GraphServe._tell`; a sweep
that expired sharded requests is told at once), and every rank agrees
that it holds the batch (`_agree_ready`), so a rank that cannot run it
raises on every rank instead of leaving the others in the exchange. Each
other rank (a follower) runs its own host stage on its own row block;
its dispatcher takes the lead's messages and runs exactly the batches
named, in the lead's order, waiting until each named request is ready
here; it completes the requests the lead expired, also those it prepares
later. A follower never selects, never waits out a window and never
sheds, and its ready buffer is unbounded: it holds at most what the lead
accepted, so a follower's host worker never waits on a request the lead
has yet to pick. Intake: every rank's call is gathered with the lead's
decision (`_agree_call`: accept, blocked then accept, reject, shed) over
the caller's own gloo group, so `QueueFull` raises on every rank or on
none, "block" holds every rank together, and ranks that made different
calls raise together; then each rank binds the request's uid, in call
order, and a query's graph version. A follower gives an unsharded
request its uid and a ticket with no work (only the lead answers it).
Deterministic mode: where the lead's inline pipeline dispatches (a
blocked intake, `drain`, `close`), the followers follow its messages at
the same call until its pause (`drain`, intake) or its end (`close`).
Threads and groups: the caller's thread uses the caller's gloo group
(intake, close, attach()'s admission, the partition check), the
dispatcher's thread the mesh's groups (messages, the readiness check,
the halo exchange, the gather of the logits); host workers issue no
collective.

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
from typing import Deque, Dict, List, Optional, Set, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.graph import Graph
from repro_torch.runtime.gnn_server import (_BATCH, _DONE, _PAUSE, BatchKey,
                                            GNNRequest, GraphServe,
                                            edf_best_fill_key)

# what a rank's call is, in the rows every rank of a mesh gathers
_INTAKE, _CLOSE = 1, 2
# the lead's intake decisions
_ACCEPT, _BLOCKED, _REJECT, _SHED = 0, 1, 2, 3


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
    uid: Optional[int] = None             # bound at intake on a mesh
    snapshot: Optional[tuple] = None      # a query's graph at intake (mesh)


# One ready-buffer entry: (arrival serial, arrival time, request). The
# serial is the FIFO tie-break of the selection rule; the arrival time
# anchors the key's batch window.
_Ready = Tuple[int, float, GNNRequest]


class PipelineScheduler:
    """Drives one GraphServe engine as a host/device pipeline.

    Use it as a context manager (`with eng.scheduler(pc) as sched:`) or
    call `close()`; `drain()` waits until every accepted request completed
    and returns them in ticket order (on a follower of a mesh, the
    sharded ones). The engine's sync API stays usable beside it: the
    scheduler adds requests only through the engine's prepare stages and
    `_execute_batch`, never through `engine.queue`. `dispatch_log` holds
    [uids, model, tier, shards] of each batch this rank ran, in order.
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
        self.dispatch_log: List[list] = []
        self._cond = threading.Condition()
        self._pending: Deque[_Work] = deque()
        self._ready: Dict[BatchKey, Deque[_Ready]] = {}
        self._ready_count = 0
        self._inflight_host = 0        # popped from intake, not yet ready
        self._arrival_serial = 0
        self._next_ticket = 0
        self._results: Dict[int, GNNRequest] = {}
        self._errors: Dict[int, BaseException] = {}
        self._failure: Optional[BaseException] = None   # the dispatcher's
        self._closed = False
        # a mesh (module docstring): a follower's prepared requests by uid,
        # its host stages' errors by uid, and the uids the lead expired
        # before this rank prepared them
        self._mesh = engine.mesh is not None
        self._follower = not engine._lead
        self._told: Dict[int, GNNRequest] = {}
        self._lost: Dict[int, BaseException] = {}
        self._doomed: Set[int] = set()
        if self._mesh:
            engine._open_scheduler = self
        self._threads: List[threading.Thread] = []
        if not pc.deterministic:
            for i in range(pc.host_workers):
                t = threading.Thread(target=self._host_loop, args=(i,),
                                     name=f"graphserve-host-{i}", daemon=True)
                t.start()
                self._threads.append(t)
            t = threading.Thread(target=self._dispatch_main,
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
        if self._mesh:
            return self._accept_mesh(w)
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self._admit_locked(self._decide_locked())
            return self._enqueue_locked(w)

    def _accept_mesh(self, w: _Work) -> int:
        """Intake on a mesh (module docstring): the lead decides, every
        rank takes its decision, then binds the uid and, for a query, the
        graph's version."""
        eng = self.engine
        if w.kind == "query":
            w.snapshot = eng._snapshot(w.graph_id)
        sharded = w.snapshot is not None and w.snapshot[4] is not None
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            decision = _ACCEPT if self._follower else self._decide_locked()
        with eng._lock:
            uid = eng._uid
        decision = eng._agree_call((_INTAKE, uid, int(sharded)), decision)
        with self._cond:
            self._admit_locked(decision)
            w.uid = eng._take_uid()
            if self._follower and not sharded:
                # the lead alone serves it: a ticket with no work
                ticket = self._next_ticket
                self._next_ticket += 1
                self.metrics["accepted"] += 1
                self.metrics["completed"] += 1
                return ticket
            return self._enqueue_locked(w)

    def _decide_locked(self) -> int:
        """The lead's (or one process's) intake decision. A blocked
        intake of the threaded pipeline waits here for room."""
        gov = self.engine.governor
        if gov is not None and gov.should_shed(len(self._pending)):
            return _SHED
        if len(self._pending) < self.pc.max_pending:
            return _ACCEPT
        if self.pc.backpressure == "reject":
            return _REJECT
        self.metrics["blocked"] += 1
        if not self.pc.deterministic:
            while (len(self._pending) >= self.pc.max_pending
                   and not self._closed):
                self._cond.wait()
            if self._closed:
                raise RuntimeError("scheduler closed while blocked")
        return _BLOCKED

    def _admit_locked(self, decision: int) -> None:
        """Carry out an intake decision: count and raise a shed or a
        reject; a blocked intake of the deterministic pipeline advances
        it inline until the intake has room (no threads to wait on)."""
        if decision == _SHED:
            # the governor's shed: quality is at the floor and the queue
            # keeps growing; refused through the reject path in either
            # backpressure mode, counted here and in the engine
            self.metrics["rejected"] += 1
            self.engine._count("shed_requests")
            gov = self.engine.governor
            raise QueueFull("the lead's SLO governor is shedding"
                            if self._follower else
                            f"SLO governor shedding at queue depth "
                            f"{len(self._pending)} (level {gov.level})")
        if decision == _REJECT:
            self.metrics["rejected"] += 1
            raise QueueFull(
                f"intake queue at max_pending={self.pc.max_pending}")
        if decision != _BLOCKED:
            return
        if self._follower:
            self.metrics["blocked"] += 1
        if self.pc.deterministic:
            self._drive_inline(until_room=True)

    def _enqueue_locked(self, w: _Work) -> int:
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
                                              tolerance=w.tolerance,
                                              uid=w.uid)
        return self.engine.prepare_query(w.graph_id, tier=w.tier,
                                         fusion=w.fusion,
                                         submitted_s=w.submitted_s,
                                         deadline_ms=w.deadline_ms,
                                         tolerance=w.tolerance, uid=w.uid,
                                         snapshot=w.snapshot)

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
                    self._lose_locked(w, err)
                    self._inflight_host -= 1
                    self._cond.notify_all()
                    continue
                while (self._ready_count >= self.pc.max_ready
                       and not self._follower and not self._closed
                       and self._failure is None):
                    self._cond.wait()            # ready full: hold intake
                self._push_ready_locked(w.ticket, req)
                self._inflight_host -= 1
                self._cond.notify_all()

    def _lose_locked(self, w: _Work, err: BaseException) -> None:
        """A host stage that raised: its ticket completes with the error
        (`drain` re-raises it); a follower also keeps it by uid, for the
        lead's batch that names it."""
        self._errors[w.ticket] = err
        self.metrics["completed"] += 1
        if self._follower:
            self._lost[w.uid] = err

    def _push_ready_locked(self, ticket: int, req: GNNRequest) -> None:
        self._results[ticket] = req
        if self._follower:
            if req.uid in self._doomed:          # the lead expired it
                self._doomed.discard(req.uid)
                self.engine._complete_expired([req], self.engine.clock.now())
                self.metrics["completed"] += 1
            else:
                self._told[req.uid] = req
            return
        key = (req.model, req.bucket, req.tier, req.backend, req.fusion,
               req.shards)
        self._ready.setdefault(key, deque()).append(
            (self._arrival_serial, self.engine.clock.now(), req))
        self._arrival_serial += 1
        self._ready_count += 1

    # ------------------------------------------------------- device stage
    def _expire_ready_locked(self) -> List[GNNRequest]:
        """The expiry sweep over the ready buffer (§14): requests whose
        deadline passed complete flagged (`GraphServe._complete_expired`:
        `deadline_missed`, no preds) instead of taking batch slots.
        Returns the swept requests. Runs under `_cond` and takes the
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
        return expired

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

    def _dispatch_main(self) -> None:
        """The dispatcher thread: the lead's (or one process's) loop, or
        a follower's; a failure ends it and `drain`/`close` raise it."""
        try:
            if self._follower:
                self._follow_loop()
            else:
                self._dispatch_loop()
        except Exception as exc:                 # noqa: BLE001 - the
            with self._cond:                     # thread's boundary
                self._failure = exc
                self._cond.notify_all()

    def _dispatch_loop(self) -> None:
        window_s = self.pc.window_ms * 1e-3
        while True:
            with self._cond:
                batch = self._next_batch_locked(window_s)
            if batch is None:                    # closed and drained
                if self._mesh:
                    self.engine._tell(_DONE)
                return
            if batch:
                self._dispatch(batch)
            else:                                # a mesh: expiries, told
                self.engine._tell(_PAUSE)        # at once

    def _next_batch_locked(self, window_s: float
                           ) -> Optional[List[GNNRequest]]:
        """The next batch to dispatch; [] when a sweep expired sharded
        requests of a mesh (told before anything else), None when the
        scheduler is closed and drained."""
        while True:
            if self._ready_count == 0:
                if (self._closed and not self._pending
                        and self._inflight_host == 0):
                    return None
                self._cond.wait()                # device idle: nothing ready
                continue
            expired = self._expire_ready_locked()
            if expired:
                # expired requests completed without a dispatch: ready
                # space freed, look again
                self._cond.notify_all()
                if self._mesh and any(r.shards for r in expired):
                    return []
                continue
            key = self._select_locked()
            fill = len(self._ready[key])
            unready = len(self._pending) + self._inflight_host
            if (fill < self._width(key) and unready > 0
                    and window_s > 0):
                # batch window: stragglers are still in the host stage;
                # wait (to the key's oldest arrival plus the window) for a
                # fuller batch
                deadline = self._ready[key][0][1] + window_s
                now = self.engine.clock.now()
                if now < deadline:
                    self._cond.wait(deadline - now)
                    continue
            batch = self._take_locked(key)
            self._cond.notify_all()              # ready space freed
            return batch

    def _dispatch(self, batch: List[GNNRequest]) -> None:
        """Run one batch the lead (or one process) picked; on a mesh a
        sharded batch is told to the mesh first."""
        eng = self.engine
        if self._mesh and batch[0].shards:
            eng._tell(_BATCH, batch)
            if not eng._agree_ready(True):
                raise RuntimeError(
                    f"a rank of the mesh cannot run the lead's batch of uids "
                    f"{[r.uid for r in batch]}")
        eng._execute_batch(batch)
        self._done(batch)

    def _done(self, batch: List[GNNRequest]) -> None:
        with self._cond:
            self.dispatch_log.append([[r.uid for r in batch], batch[0].model,
                                      batch[0].tier, batch[0].shards])
            self.metrics["completed"] += len(batch)
            self._cond.notify_all()

    # ------------------------------------------------------- a follower
    def _follow_loop(self) -> None:
        """A follower's dispatcher: the lead's messages until its end."""
        while True:
            op, uids, gone, tier = self.engine._hear()
            with self._cond:
                self._expire_told_locked(gone)
                if op == _DONE:
                    return
                if op != _BATCH:
                    continue
                while not all(u in self._told or u in self._lost
                              for u in uids):
                    self._cond.wait()            # its host stage runs
                batch = [self._told.pop(u) for u in uids if u in self._told]
            self._follow_batch(batch, uids, tier)

    def _follow_inline(self) -> None:
        """A follower of the deterministic pipeline: the lead's messages
        until its pause or end, preparing inline, in order, each request
        a message names."""
        while True:
            op, uids, gone, tier = self.engine._hear()
            with self._cond:
                self._prepare_through(max(uids + gone, default=-1))
                self._expire_told_locked(gone)
                if op != _BATCH:
                    return
                batch = [self._told.pop(u) for u in uids if u in self._told]
            self._follow_batch(batch, uids, tier)

    def _prepare_through(self, uid: int) -> None:
        """Deterministic follower: the host stage of every pending
        request up to `uid` (a follower's uids rise in intake order)."""
        while self._pending and self._pending[0].uid <= uid:
            w = self._pending.popleft()
            t0 = time.perf_counter()
            try:
                req = self._prepare(w)
            except Exception as exc:             # noqa: BLE001 - the lead
                self._lose_locked(w, exc)        # learns it at the batch
                continue
            self.metrics["host_busy_s"] += time.perf_counter() - t0
            self._push_ready_locked(w.ticket, req)

    def _expire_told_locked(self, gone: List[int]) -> None:
        """Complete the requests the lead expired; keep the uids of those
        not yet prepared for their host stage's end."""
        if not gone:
            return
        self._doomed.update(u for u in gone
                            if u not in self._told and u not in self._lost)
        expired = [self._told.pop(u) for u in gone if u in self._told]
        if expired:
            self.engine._complete_expired(expired, self.engine.clock.now())
            self.metrics["completed"] += len(expired)
            self._cond.notify_all()

    def _follow_batch(self, batch: List[GNNRequest], uids: List[int],
                      tier: int) -> None:
        """Run the lead's batch once every rank holds it, at its tier."""
        if not self.engine._agree_ready(len(batch) == len(uids)):
            lost = {u: repr(self._lost[u]) for u in uids if u in self._lost}
            raise RuntimeError(
                f"rank {dist.get_rank()} cannot run the lead's batch of "
                f"uids {uids}: "
                + (f"the host stage failed here for {lost}" if lost
                   else "another rank holds no request of it"))
        self.engine._run_told(batch, tier)
        self._done(batch)

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
            self._dispatch(self._take_locked(self._select_locked()))

    def _drive_inline(self, *, until_room: bool = False,
                      end: int = _PAUSE) -> None:
        """The deterministic pipeline's drive at one call: the lead (or
        one process) steps until the intake has room (`until_room`) or
        everything is done, then tells a mesh `end`; a follower follows
        its messages to that point."""
        if self._follower:
            self._follow_inline()
            return
        if until_room:
            while len(self._pending) >= self.pc.max_pending:
                self._step_inline()
        else:
            while self._pending or self._ready_count:
                self._step_inline()
        if self._mesh:
            self.engine._tell(end)

    # ------------------------------------------------------------ lifecycle
    def drain(self, timeout: Optional[float] = None) -> List[GNNRequest]:
        """Run or wait until every accepted request completed; return them
        in ticket order. A host-stage error (the earliest ticket's) is
        re-raised and consumed, so a caller that catches it can call
        `drain()` again for the completed requests (an errored ticket has
        no result); a dispatcher's failure is re-raised every time.
        Raises `TimeoutError` past `timeout` seconds. On a mesh every rank
        drains at the same call."""
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        if self.pc.deterministic:
            with self._cond:
                if self._follower:
                    self._follow_inline()
                else:
                    while self._pending or self._ready_count:
                        if (deadline is not None
                                and time.perf_counter() > deadline):
                            raise TimeoutError(
                                f"{len(self._pending) + self._ready_count} "
                                "request(s) still undispatched")
                        self._step_inline()
                    if self._mesh:
                        self.engine._tell(_PAUSE)
        else:
            with self._cond:
                while (self.metrics["completed"] < self.metrics["accepted"]
                       and self._failure is None):
                    left = (deadline - time.perf_counter()
                            if deadline is not None else None)
                    if left is not None and left <= 0:
                        raise TimeoutError(
                            f"{self.metrics['accepted'] - self.metrics['completed']}"
                            " request(s) still in flight")
                    self._cond.wait(left)
        if self._failure is not None:
            raise self._failure
        if self._errors:
            errors, self._errors = self._errors, {}
            raise errors[min(errors)]
        return [self._results[t] for t in sorted(self._results)]

    def close(self) -> None:
        """Stop accepting, finish outstanding work, join the threads.
        Idempotent; the engine stays usable afterwards. On a mesh every
        rank closes at the same call: the lead tells the mesh it is done
        once its work is, and a follower raises if it still holds a
        request the lead never named."""
        with self._cond:
            first = not self._closed
        if first and self._mesh:
            with self.engine._lock:
                uid = self.engine._uid
            self.engine._agree_call((_CLOSE, uid, 0), 0)
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            if self.pc.deterministic and first:
                self._drive_inline(end=_DONE)
        for t in self._threads:
            t.join()
        self._threads = []
        if self._mesh and self.engine._open_scheduler is self:
            self.engine._open_scheduler = None
        if self._failure is not None:
            raise self._failure
        if self._told or self._pending:
            raise RuntimeError(
                f"rank {dist.get_rank()} still holds requests "
                f"{sorted(self._told) + [w.uid for w in self._pending]} the "
                f"lead never dispatched")

    def request(self, ticket: int) -> Optional[GNNRequest]:
        """A ticket's request once its host stage ran (done after
        `drain`); None before, for an errored ticket, and on a follower
        of a mesh for a request only the lead serves."""
        with self._cond:
            return self._results.get(ticket)

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
