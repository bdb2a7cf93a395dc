"""GOOD: the lock only covers the flag flip; the hard exit happens after
the critical section is released."""
import os
import threading

_STATE_LOCK = threading.Lock()
_ABORTING = False


def fail_fast(code):
    global _ABORTING
    with _STATE_LOCK:
        _ABORTING = True
    os._exit(code)
