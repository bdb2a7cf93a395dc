"""GOOD: every wait is bounded — the get() carries a timeout and the
loop condition consults a deadline."""
import queue
import threading
import time


class Consumer:
    def __init__(self):
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._drain, daemon=True)

    def _drain(self):
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                return
