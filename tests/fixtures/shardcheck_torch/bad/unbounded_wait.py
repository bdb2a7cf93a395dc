"""BAD: the drain loop blocks on q.get() with no timeout and no
deadline/abort escape -> SC502. A dead producer hangs this rank."""
import queue
import threading


class Consumer:
    def __init__(self):
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._drain, daemon=True)

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
