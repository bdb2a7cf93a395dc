"""GOOD: both the thread-side and main-side writes to self._progress
hold self._lock — the SC401 lockset intersection is non-empty."""
import threading


class Tracker:
    def __init__(self):
        self._lock = threading.Lock()
        self._progress = 0
        self._thread = threading.Thread(target=self._work, daemon=True)

    def _work(self):
        for i in range(100):
            with self._lock:
                self._progress = i

    def request(self, n):
        with self._lock:
            self._progress = n
