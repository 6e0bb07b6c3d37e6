"""Byte-budgeted device cache for GraphServe's operand hierarchy (§13).

Port of the reference's `runtime/cache.py`. CacheG (DESIGN.md §7) keeps
up to three device-resident forms per attached graph — the fp32 operand
set, the derived int8 Â and the derived GraSp decision and structure —
or, for a graph sharded across shards (§12), its tuple of operand row
blocks, all keyed by (graph_id, structure_version) and NOTHING else. Unbounded,
that pins O(cap²) device bytes per graph. This module bounds it:

  * every entry carries its device-byte cost and a re-materialization
    cost estimate (`remat_s`);
  * eviction is cost-aware LRU against `budget_bytes`: victims are picked
    least-recently-used GRAPH first (group recency — the max `last_use`
    across a key's entries — so a hot derived form keeps its primary
    resident), derived entries before the primary they hang off
    (`KIND_RANK`), cheapest re-materialization first among peers;
  * evicted primaries optionally spill to a host-RAM compact form (the
    SymG bit-packed `HostOperands`, pinned on a CUDA engine) produced by
    the entry's `spill_fn` at eviction time; a later fault re-materializes
    from the spilled form instead of re-running the host build. Entries
    whose `spill_fn` is None or declines (directed graphs) are dropped
    instead. Conservation: evictions == spilled + dropped.

Lifecycle vs capacity: `invalidate()` (update/detach removing a dead
version) is NOT an eviction — it touches no counter, so the eviction
metrics measure memory pressure, never graph churn.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

Key = Tuple[int, int]                    # (graph_id, structure_version)

# derived forms (rank 0) evict before the primary they hang off (rank 1):
# a graph's fp32 operand set, or its sharded slice tuple
KIND_RANK = {"tier": 0, "grasp": 0, "operand": 1, "shard": 1}
PRIMARY_KINDS = ("operand", "shard")


class CacheAdmissionError(RuntimeError):
    """attach() admission control rejected a graph: its primary operand
    entry cannot fit the configured `device_cache_budget_bytes` (or the
    policy is "reject" and the budget is full)."""


def tree_tensors(value):
    """The tensors of a cached value or a request's device state, found
    through dataclasses and tuples (the reference's pytree leaves).
    Anything else (the grasp backend string, None, ints) holds none."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, tuple):
        for v in value:
            yield from tree_tensors(v)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            yield from tree_tensors(getattr(value, f.name))


def tree_nbytes(value) -> int:
    """Bytes of a cached value: the sum of the buffer sizes of its tensors
    (the reference's `pytree_nbytes` over its leaves)."""
    return sum(t.numel() * t.element_size() for t in tree_tensors(value))


def estimate_dense_entry_bytes(num_fields: int, capacity: int) -> int:
    """Projected device cost of one unsharded fp32 operand entry: the
    kind's populated (cap, cap) fields plus the reference's (1, 1)
    placeholder holes (`core.models.operand_nbytes` layout)."""
    return num_fields * capacity * capacity * 4 + (5 - num_fields) * 4


def estimate_shard_entry_bytes(shards: int, shard_cap: int, full_rows: int,
                               num_fields: int, in_feats: int) -> int:
    """Projected device cost of one sharded slice-tuple entry: per shard,
    the kind's (shard_cap, full_rows) operand row blocks plus the
    reference's placeholder holes, the (shard_cap, F) feature block and
    the (shard_cap,) node mask."""
    per = (num_fields * shard_cap * full_rows * 4 + (5 - num_fields) * 4
           + shard_cap * in_feats * 4 + shard_cap * 4)
    return shards * per


@dataclasses.dataclass
class CacheEntry:
    kind: str
    key: Key
    value: object
    nbytes: int
    remat_s: float = 0.0
    spill_fn: Optional[Callable[[], Optional[object]]] = None
    last_use: int = 0


class DeviceCacheManager:
    """The operand caches behind one byte budget (DESIGN.md §13)."""

    def __init__(self, *, budget_bytes: Optional[int] = None,
                 spill_to_host: bool = True):
        if budget_bytes is not None and budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be positive or None, "
                             f"got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self.spill_to_host = spill_to_host
        self._entries: Dict[Tuple[str, Key], CacheEntry] = {}
        self._spill: Dict[Tuple[str, Key], object] = {}
        self._clock = 0
        self._resident = 0
        self.evictions = 0
        self.spilled = 0
        self.dropped = 0
        self.spill_hits = 0

    # ------------------------------------------------------------- accounting
    @property
    def resident_bytes(self) -> int:
        return self._resident

    @property
    def spill_entries(self) -> int:
        return len(self._spill)

    def entry_sizes(self) -> Dict[Tuple[str, Key], int]:
        """Per-entry costs (their sum equals `resident_bytes`)."""
        return {k: e.nbytes for k, e in self._entries.items()}

    def view(self, kind: str) -> Dict[Key, object]:
        """Snapshot of one kind's entries as a plain {key: value} dict."""
        return {e.key: e.value for e in self._entries.values()
                if e.kind == kind}

    # -------------------------------------------------------------- hit paths
    def get(self, kind: str, key: Key):
        e = self._entries.get((kind, key))
        if e is None:
            return None
        self._clock += 1
        e.last_use = self._clock
        return e.value

    def spill_get(self, kind: str, key: Key):
        """Second-level hit: the host-RAM compact form of an evicted
        primary, if one was spilled. Non-destructive — the spilled form
        stays valid for the key's whole lifetime (structure is immutable
        per version), so a re-eviction never re-packs."""
        payload = self._spill.get((kind, key))
        if payload is not None:
            self.spill_hits += 1
        return payload

    # ------------------------------------------------------------ admission
    def fits(self, nbytes: int) -> bool:
        """Can an entry of this size EVER be resident (evicting everything
        else)? attach() admission control asks this before registering."""
        return self.budget_bytes is None or nbytes <= self.budget_bytes

    def would_overflow(self, nbytes: int) -> bool:
        """Would inserting this size require eviction right now? The
        "reject" admission policy refuses attach() in that case."""
        return (self.budget_bytes is not None
                and self._resident + nbytes > self.budget_bytes)

    # --------------------------------------------------------------- mutation
    def put(self, kind: str, key: Key, value, *, nbytes: int,
            remat_s: float = 0.0,
            spill_fn: Optional[Callable[[], Optional[object]]] = None,
            protect: Iterable[Key] = ()) -> bool:
        """Insert (or refresh) one entry, evicting until it fits. Returns
        False when the entry alone exceeds the whole budget: the value is
        NOT cached (the caller serves it transiently; the next query
        rebuilds). `protect` keys (plus the inserted key) are never
        victims, so a derived insert cannot evict the primary it derives
        from."""
        if self.budget_bytes is not None and nbytes > self.budget_bytes:
            return False
        old = self._entries.get((kind, key))
        if old is not None:
            self._resident -= old.nbytes
        self._evict_until(nbytes, protect=set(protect) | {key})
        self._clock += 1
        self._entries[(kind, key)] = CacheEntry(
            kind=kind, key=key, value=value, nbytes=nbytes,
            remat_s=remat_s, spill_fn=spill_fn, last_use=self._clock)
        self._resident += nbytes
        return True

    def invalidate(self, key: Key) -> int:
        """Lifecycle removal (update()/detach() retiring a version): drop
        every kind's entry AND any spilled form at this key. No-op on
        never-populated keys; never counted as an eviction."""
        removed = 0
        for kind in KIND_RANK:
            e = self._entries.pop((kind, key), None)
            if e is not None:
                self._resident -= e.nbytes
                removed += 1
            if self._spill.pop((kind, key), None) is not None:
                removed += 1
        return removed

    # --------------------------------------------------------------- eviction
    def _evict_until(self, need: int, protect: set) -> None:
        if self.budget_bytes is None:
            return
        while self._resident + need > self.budget_bytes:
            victim = self._pick_victim(protect)
            if victim is None:
                return               # everything left is protected
            self._evict(victim)

    def _pick_victim(self, protect: set) -> Optional[CacheEntry]:
        candidates = [e for e in self._entries.values()
                      if e.key not in protect]
        if not candidates:
            return None
        recency: Dict[Key, int] = {}
        for e in candidates:
            recency[e.key] = max(recency.get(e.key, 0), e.last_use)
        return min(candidates,
                   key=lambda e: (recency[e.key], KIND_RANK[e.kind],
                                  e.remat_s, e.last_use))

    def _evict(self, e: CacheEntry) -> None:
        del self._entries[(e.kind, e.key)]
        self._resident -= e.nbytes
        self.evictions += 1
        spill_key = (e.kind, e.key)
        if (self.spill_to_host and e.kind in PRIMARY_KINDS
                and spill_key in self._spill):
            self.spilled += 1        # re-eviction: the packed form persists
            return
        payload = None
        if self.spill_to_host and e.kind in PRIMARY_KINDS \
                and e.spill_fn is not None:
            payload = e.spill_fn()
        if payload is not None:
            self._spill[spill_key] = payload
            self.spilled += 1
        else:
            self.dropped += 1
