"""Keras-style epoch progress bar.

Copy of ``tpu_dist/utils/progbar.py``: per-epoch ``N/N`` progress with step
time and loss, throttled so display never bounds the training loop.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, total: int, *, enabled: bool = True, width: int = 24,
                 min_interval_s: float = 0.1):
        self.total = total
        self.enabled = enabled
        self.width = width
        self.min_interval = min_interval_s
        self._start = time.perf_counter()
        self._last_render = 0.0

    def update(self, step: int, **values) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        if step < self.total and now - self._last_render < self.min_interval:
            return
        self._last_render = now
        frac = step / max(self.total, 1)
        filled = int(frac * self.width)
        bar = "=" * filled + (">" if filled < self.width else "")
        bar = bar.ljust(self.width, ".")
        ms = 1000.0 * (now - self._start) / max(step, 1)
        vals = " - ".join(f"{k}: {v:.4f}" for k, v in values.items())
        sys.stdout.write(f"\r{step}/{self.total} [{bar}] - {ms:.0f}ms/step - {vals}")
        sys.stdout.flush()

    def finish(self, logs: dict) -> None:
        if not self.enabled:
            return
        elapsed = time.perf_counter() - self._start
        ms = 1000.0 * elapsed / max(self.total, 1)
        vals = " - ".join(
            f"{k}: {v:.4f}" for k, v in logs.items() if isinstance(v, float))
        sys.stdout.write(
            f"\r{self.total}/{self.total} - {elapsed:.1f}s - {ms:.0f}ms/step - {vals}\n")
        sys.stdout.flush()
