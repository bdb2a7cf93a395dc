"""BAD: Thread.join() while holding self._lock -> SC402. If the worker
ever needs that lock to finish, stop() deadlocks the process."""
import threading


class Stopper:
    def __init__(self):
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._work, daemon=True)

    def _work(self):
        return sum(range(10))

    def stop(self):
        with self._lock:
            self._thread.join()
