"""SLO governor: a rolling-p99 watcher with hysteresis (DESIGN.md §14).

Port of the reference's `runtime/slo.py` (numpy only). The governor
watches the rolling request-latency p99 against a target. After
`breach_checks` consecutive breaches it steps the default quality tier
one rung down the ladder (fp32 → int8 → int8+grax); after `clear_checks`
consecutive clears it steps back up. The unequal counts are the
hysteresis: one slow batch cannot flip the tier, one fast one cannot flip
it back.

At the bottom rung, with the intake queue at `max_queue_depth` or deeper,
`should_shed` asks the pipeline scheduler to refuse new requests (its
`QueueFull` path). The governor steers only requests that pinned neither a
tier nor a tolerance. Its state advances in `observe()`, which GraphServe
calls once per completed request under its engine lock with latencies on
the engine's clock, so a fake clock drives the whole cycle.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SLOConfig:
    target_p99_ms: float = 50.0      # rolling-p99 latency target
    window: int = 64                 # rolling window size (requests)
    min_samples: int = 4             # no verdicts before this many samples
    breach_checks: int = 3           # consecutive breaches -> downgrade
    clear_checks: int = 6            # consecutive clears -> upgrade
    max_queue_depth: int = 64        # shed threshold at the bottom rung
    # quality-descending tier ladder the governor walks; intersected with
    # each model's registered tiers at override time
    ladder: Tuple[str, ...] = ("fp32", "int8", "int8+grax")


class SLOGovernor:
    """Hysteretic tier-downgrade controller over a rolling latency window."""

    def __init__(self, cfg: Optional[SLOConfig] = None):
        self.cfg = cfg or SLOConfig()
        self._lat: deque = deque(maxlen=self.cfg.window)
        self.level = 0                   # rungs below the default tier
        self.downgrades = 0              # level-raise transitions
        self.upgrades = 0                # level-drop transitions
        self._breach_streak = 0
        self._clear_streak = 0

    @property
    def max_level(self) -> int:
        return len(self.cfg.ladder) - 1

    def p99_ms(self) -> Optional[float]:
        if len(self._lat) < self.cfg.min_samples:
            return None
        return float(np.percentile(np.asarray(self._lat), 99) * 1e3)

    def observe(self, latency_s: float) -> None:
        """Feed one completed request's latency; run the hysteresis step."""
        self._lat.append(float(latency_s))
        p99 = self.p99_ms()
        if p99 is None:
            return
        if p99 > self.cfg.target_p99_ms:
            self._breach_streak += 1
            self._clear_streak = 0
            if (self._breach_streak >= self.cfg.breach_checks
                    and self.level < self.max_level):
                self.level += 1
                self.downgrades += 1
                self._breach_streak = 0
        else:
            self._clear_streak += 1
            self._breach_streak = 0
            if (self._clear_streak >= self.cfg.clear_checks
                    and self.level > 0):
                self.level -= 1
                self.upgrades += 1
                self._clear_streak = 0

    def tier_override(self, default_tier: str,
                      registered: Sequence[str]) -> Optional[str]:
        """The tier for a request with no preference at the current level:
        None at level 0 (the model default); else `level` rungs below the
        default on the configured ladder restricted to the model's
        registered tiers, saturating at the bottom rung."""
        if self.level == 0:
            return None
        ladder: List[str] = [t for t in self.cfg.ladder if t in registered]
        if not ladder:
            return None
        start = ladder.index(default_tier) if default_tier in ladder else 0
        return ladder[min(start + self.level, len(ladder) - 1)]

    def should_shed(self, queue_depth: int) -> bool:
        """True when quality is exhausted and the queue keeps growing."""
        return (self.level >= self.max_level
                and queue_depth >= self.cfg.max_queue_depth)
