"""BAD: the disable comment names SC403 but no SC403 fires on that line
-> SC901. A suppression that eats nothing rots into a blanket exemption
when code moves back under it."""
import threading


def _work():
    return sum(range(10))


def start():
    t = threading.Thread(target=_work, daemon=True)  # shardcheck: disable=SC403 -- stale: the flush moved to the main thread
    t.start()
    return t
