"""MetricsRegistry: counters, gauges, streaming distributions — host-side only.

The port's own copy of ``tpu_dist/observe/metrics.py`` (framework-free
there too; the port imports nothing of ``tpu_dist``). Same instrument
names, same estimator, so reports of the two packages read alike:

* **disabled is free** — every instrument checks one boolean before doing
  any work, so an un-enabled registry costs an attribute read per call and
  production code can leave instrumentation in place unconditionally;
* **host code only** — recording is a Python-level side effect between
  device calls, never inside a captured CUDA graph;
* **bounded memory** — distributions keep exact count/sum/min/max forever
  but sample values into a fixed reservoir (Vitter's algorithm R, seeded so
  runs are reproducible), so p50/p95/p99 stay available over arbitrarily
  long runs without unbounded growth.

Quantiles use linear interpolation over the sorted reservoir (numpy's
default scheme), which makes small-sample quantiles exact — the property
the unit tests pin.
"""

from __future__ import annotations

import random
import threading
from typing import Optional

#: Quantiles every distribution snapshot reports.
SNAPSHOT_QUANTILES = (0.5, 0.95, 0.99)

#: Reservoir size: exact quantiles up to this many observations, uniform
#: subsampling beyond it. 1024 doubles are 8 KiB per distribution.
DEFAULT_RESERVOIR_SIZE = 1024


def quantile(sorted_values: list, q: float) -> float:
    """Linear-interpolation quantile of an ascending-sorted list
    (numpy's default 'linear' method): h = (n-1)q, interpolate between
    floor(h) and ceil(h)."""
    if not sorted_values:
        raise ValueError("quantile of an empty sequence")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    n = len(sorted_values)
    if n == 1:
        return float(sorted_values[0])
    h = (n - 1) * q
    lo = int(h)
    hi = min(lo + 1, n - 1)
    frac = h - lo
    return float(sorted_values[lo]) * (1.0 - frac) + float(
        sorted_values[hi]) * frac


_COUNTER_LOCK = threading.Lock()


class Counter:
    """Monotonic count (steps run, collectives fired, faults seen)."""

    __slots__ = ("_registry", "value")

    def __init__(self, registry: "MetricsRegistry"):
        self._registry = registry
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if self._registry.enabled:
            # Several threads count (a serving fleet's replicas): += alone
            # can lose an update between its read and its write.
            with _COUNTER_LOCK:
                self.value += n


class Gauge:
    """Last-written value (current epoch time, a rank's step duration)."""

    __slots__ = ("_registry", "value")

    def __init__(self, registry: "MetricsRegistry"):
        self._registry = registry
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        if self._registry.enabled:
            self.value = float(v)


class Distribution:
    """Streaming value distribution: exact count/sum/min/max plus
    reservoir-sampled quantiles."""

    __slots__ = ("_registry", "_lock", "_rng", "_reservoir", "_capacity",
                 "count", "sum", "min", "max")

    def __init__(self, registry: "MetricsRegistry",
                 reservoir_size: int = DEFAULT_RESERVOIR_SIZE):
        self._registry = registry
        self._lock = threading.Lock()
        # Seeded per-instrument: reservoir contents are reproducible across
        # runs and never touch torch's RNG or the global `random` state.
        self._rng = random.Random(0xD157)
        self._reservoir: list = []
        self._capacity = reservoir_size
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        if not self._registry.enabled:
            return
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            # Algorithm R: keep each of the first k values, then replace a
            # random slot with probability k/count.
            if len(self._reservoir) < self._capacity:
                self._reservoir.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._capacity:
                    self._reservoir[j] = v

    def quantile(self, q: float) -> float:
        with self._lock:
            values = sorted(self._reservoir)
        return quantile(values, q)

    def snapshot(self) -> dict:
        with self._lock:
            values = sorted(self._reservoir)
        out = {"count": self.count, "sum": self.sum,
               "min": self.min, "max": self.max}
        for q in SNAPSHOT_QUANTILES:
            out[f"p{int(q * 100)}"] = quantile(values, q) if values else None
        return out


class MetricsRegistry:
    """Named instrument namespace with one on/off switch.

    Instruments are created on first use and live for the registry's
    lifetime; a disabled registry still hands out instruments (call sites
    never branch) — they just drop writes.
    """

    def __init__(self, *, enabled: bool = True,
                 reservoir_size: int = DEFAULT_RESERVOIR_SIZE):
        self.enabled = bool(enabled)
        self._reservoir_size = reservoir_size
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._distributions: dict[str, Distribution] = {}

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _get(self, table: dict, name: str, factory):
        inst = table.get(name)
        if inst is None:
            with self._lock:
                inst = table.setdefault(name, factory())
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, lambda: Counter(self))

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, lambda: Gauge(self))

    def distribution(self, name: str) -> Distribution:
        return self._get(
            self._distributions, name,
            lambda: Distribution(self, self._reservoir_size))

    def reset(self) -> None:
        """Drop every instrument (a fresh run's clean slate)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._distributions.clear()

    def snapshot(self) -> dict:
        """Point-in-time JSON-ready view of every instrument."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            dists = dict(self._distributions)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "distributions": {k: d.snapshot()
                              for k, d in sorted(dists.items())},
        }


#: The process-wide default registry. Starts DISABLED: instrumentation is
#: free until a Telemetry callback (or an explicit enable()) turns it on.
_default = MetricsRegistry(enabled=False)


def get_registry() -> MetricsRegistry:
    return _default


def enabled() -> bool:
    """Cheap read: is the default registry recording?"""
    return _default.enabled


def enable() -> None:
    _default.enable()


def disable() -> None:
    _default.disable()


# -- eager recording helpers --------------------------------------------------
# One-liners for callback/hook call sites. These are HOST side effects:
# a captured CUDA graph would not replay them.

def inc(name: str, n: int = 1) -> None:
    _default.counter(name).inc(n)


def observe_value(name: str, v: float) -> None:
    _default.distribution(name).observe(v)


def set_gauge(name: str, v: float) -> None:
    _default.gauge(name).set(v)
