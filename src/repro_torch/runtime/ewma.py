"""Exponentially weighted averages of the runtime: the trainer's straggler
gate and the serving latency bank (DESIGN.md §14).

Port of the reference's `runtime/ewma.py`, plain Python. Two consumers:

* `StragglerGate`: the trainer's (`runtime/trainer.py`) per-step
  straggler detector over a bias-corrected baseline.
* `LatencyBank`: the serving cost oracle. Per batch key it keeps a
  bias-corrected EWMA of measured `_execute_batch` spans, seeded (for
  prediction only; the seed never blends into the average) from the
  analytic cost model. The backend rule's measured pair, the tolerance
  tier router and the governor read it, so the model orders cold keys and
  measurement takes over with the first sample.

One difference from the reference: `Ewma.value` is clamped to the least
and largest sample seen. `s / den` is a weighted mean of the samples, so
it lies between them in exact arithmetic, but rounding can carry it one
ulp outside (one sample of 7.0 at alpha 0.01 gives 7.000000000000001 in
the reference); the port's value never leaves the samples' range.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Optional


class Ewma:
    """Bias-corrected exponential moving average.

    Keeps ``s = (1-a)*s + a*x`` and ``den = (1-a)*den + a``; the value is
    ``s/den`` clamped to [min, max] of the samples. After one sample the
    value is that sample; after k it is the weighted mean of all k with
    geometric weights renormalized over the samples seen, so a first
    outlier decays at the rate of any other sample instead of anchoring
    the series.
    """

    __slots__ = ("alpha", "_s", "_den", "count", "min", "max")

    def __init__(self, alpha: float = 0.1):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._s = 0.0
        self._den = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, x: float) -> float:
        a = self.alpha
        self._s = (1.0 - a) * self._s + a * float(x)
        self._den = (1.0 - a) * self._den + a
        self.count += 1
        if x < self.min:
            self.min = float(x)
        if x > self.max:
            self.max = float(x)
        return self.value

    @property
    def value(self) -> Optional[float]:
        if self.count == 0:
            return None
        return min(max(self._s / self._den, self.min), self.max)


class StragglerGate:
    """Trainer straggler detector over a bias-corrected EWMA baseline.

    A step straggles when ``wall > factor * baseline``; straggling steps
    do not train the baseline (they are what it exists to detect). The
    first sample always trains it.
    """

    def __init__(self, factor: float, alpha: float = 0.1):
        self.factor = float(factor)
        self._ewma = Ewma(alpha)

    @property
    def baseline(self) -> Optional[float]:
        return self._ewma.value

    def check(self, wall: float) -> bool:
        """Record one step's wall time; True when it straggled."""
        base = self._ewma.value
        straggler = base is not None and wall > self.factor * base
        if not straggler:
            self._ewma.observe(wall)
        return straggler


@dataclass
class _BankEntry:
    ewma: Ewma
    seed: Optional[float] = None  # modelled seconds, for prediction only


class LatencyBank:
    """Per-key measured latency with a model-seeded cold start.

    Keys are the tuples the caller routes on; GraphServe uses its batch
    key ``(model, bucket, tier, backend, fusion, shards)``. `predict`
    returns the measured EWMA once samples exist, else the seed registered
    by `seed`, else None. The seed never mixes into the average, so a
    prediction stays within [min, max] of the samples once there are any.
    Not thread-safe by itself: GraphServe calls it under its engine lock.
    """

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._entries: Dict[Hashable, _BankEntry] = {}

    def _entry(self, key: Hashable) -> _BankEntry:
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _BankEntry(Ewma(self.alpha))
        return e

    def seed(self, key: Hashable, modelled_s: float) -> None:
        """Register the modelled latency of a cold key."""
        self._entry(key).seed = float(modelled_s)

    def observe(self, key: Hashable, seconds: float) -> None:
        self._entry(key).ewma.observe(float(seconds))

    def predict(self, key: Hashable) -> Optional[float]:
        e = self._entries.get(key)
        if e is None:
            return None
        if e.ewma.count > 0:
            return e.ewma.value
        return e.seed

    def measured(self, key: Hashable) -> Optional[float]:
        """The measured EWMA only: None until a real sample lands."""
        e = self._entries.get(key)
        if e is None or e.ewma.count == 0:
            return None
        return e.ewma.value

    def samples(self, key: Hashable) -> int:
        e = self._entries.get(key)
        return 0 if e is None else e.ewma.count

    def measured_pair(
        self,
        match: Callable[[Hashable], bool],
        backend_of: Callable[[Hashable], str],
    ) -> Dict[str, float]:
        """Least measured latency per backend over the matching keys. The
        backend rule overrides its model only when both backends have
        real samples, so an unmeasured path is never condemned by the
        model alone."""
        best: Dict[str, float] = {}
        for key, e in self._entries.items():
            if e.ewma.count == 0 or not match(key):
                continue
            b = backend_of(key)
            v = e.ewma.value
            if b not in best or v < best[b]:
                best[b] = v
        return best

    def ewma_vs_model(self) -> Optional[float]:
        """Mean measured/modelled ratio over the keys that hold both: 1.0
        means the model prices batches exactly."""
        ratios = [
            e.ewma.value / e.seed
            for e in self._entries.values()
            if e.ewma.count > 0 and e.seed and e.seed > 0
        ]
        if not ratios:
            return None
        return sum(ratios) / len(ratios)

    def keys(self):
        return list(self._entries.keys())
