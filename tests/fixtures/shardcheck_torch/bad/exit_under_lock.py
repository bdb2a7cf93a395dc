"""BAD: os._exit while holding the state lock -> SC404. _exit skips all
teardown, abandoning whatever the lock was protecting mid-update."""
import os
import threading

_STATE_LOCK = threading.Lock()


def fail_fast(code):
    with _STATE_LOCK:
        os._exit(code)
