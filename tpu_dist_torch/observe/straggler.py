"""Straggler and heartbeat detection over per-rank step timings.

The port's own copy of ``tpu_dist/observe/straggler.py`` (no framework
code: the same verdicts on the same inputs).

A synchronous-SPMD gang runs at the speed of its slowest member: one rank
with a throttled chip, a contended host, or a failing NIC drags every
all-reduce. The reference stack had no way to see this — a slow worker
just looked like a slow job. Here the chief aggregates each rank's mean
step duration (gathered through ``collectives.host_all_gather``, see
telemetry.py) and flags ranks whose step time exceeds a multiple of the
gang median. Median — not mean — so a single extreme straggler cannot
mask itself by dragging the baseline up.

Detection is advisory: verdicts are recorded as ``straggler_detected``
events in the resilience ``EventLog`` for the Supervisor's chaos reports;
nothing here kills or restarts a rank.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional, Sequence

#: A rank is a straggler when step_s > threshold * median(step_s).
DEFAULT_THRESHOLD = 2.0

#: Absolute floor: below this median step time (seconds), ratios are
#: dominated by scheduler noise and nothing is flagged.
DEFAULT_MIN_STEP_S = 1e-4


@dataclasses.dataclass(frozen=True)
class StragglerVerdict:
    """One flagged rank: its step time, the gang median, and the ratio."""

    rank: int
    step_s: float
    median_s: float
    ratio: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def detect_stragglers(
        per_rank_step_s: Sequence[float],
        *,
        threshold: float = DEFAULT_THRESHOLD,
        min_step_s: float = DEFAULT_MIN_STEP_S,
) -> list[StragglerVerdict]:
    """Flag ranks whose mean step time exceeds ``threshold`` x the gang
    median. A gang of 0 or 1 ranks has no peers to compare against and a
    sub-``min_step_s`` median is all noise — both return no verdicts.
    """
    if threshold <= 1.0:
        raise ValueError(f"threshold must be > 1.0, got {threshold}")
    times = [float(t) for t in per_rank_step_s]
    if len(times) <= 1:
        return []
    median = statistics.median(times)
    if median < min_step_s:
        return []
    out = []
    for rank, t in enumerate(times):
        if t > threshold * median:
            out.append(StragglerVerdict(
                rank=rank, step_s=t, median_s=median, ratio=t / median))
    return out


class HeartbeatMonitor:
    """Last-progress tracker: which ranks have gone silent?

    Complements ratio-based detection — a rank that *stops* reporting has
    no step time to compare. Feed it ``beat(rank)`` whenever a rank's
    timing arrives; ``stale_ranks(timeout_s)`` names the ranks whose last
    beat is older than the timeout (never-beaten known ranks included).
    """

    def __init__(self, num_ranks: int, *, clock=time.monotonic):
        self._clock = clock
        self._last_beat: dict[int, Optional[float]] = {
            r: None for r in range(num_ranks)}
        self._started = self._clock()

    def beat(self, rank: int) -> None:
        self._last_beat[rank] = self._clock()

    def stale_ranks(self, timeout_s: float) -> list[int]:
        now = self._clock()
        stale = []
        for rank in sorted(self._last_beat):
            last = self._last_beat[rank]
            ref = last if last is not None else self._started
            if now - ref > timeout_s:
                stale.append(rank)
        return stale
