"""BAD: self._progress is written by the worker thread AND by request()
on the main thread with no common lock -> SC401 (the writes can race)."""
import threading


class Tracker:
    def __init__(self):
        self._lock = threading.Lock()
        self._progress = 0
        self._thread = threading.Thread(target=self._work, daemon=True)

    def _work(self):
        for i in range(100):
            self._progress = i

    def request(self, n):
        self._progress = n
