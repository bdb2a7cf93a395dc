"""GOOD: the lock only covers the flag flip; the join happens after the
critical section — and a Condition waiting on ITSELF under `with cond:`
is the exempt condition-variable idiom, not SC402."""
import threading


class Stopper:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition()
        self._stopping = False
        self._thread = threading.Thread(target=self._work, daemon=True)

    def _work(self):
        with self._cond:
            self._cond.wait(timeout=1.0)

    def stop(self):
        with self._lock:
            self._stopping = True
        self._thread.join()
