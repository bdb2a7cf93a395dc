"""BAD: the spawned thread joins a gang barrier -> SC403. Its launch
races the main thread's collectives and the rendezvous mismatches."""
import threading

from tpu_dist_torch.cluster import bootstrap


def _flush():
    bootstrap.barrier("flush")


def start():
    t = threading.Thread(target=_flush, daemon=True)
    t.start()
    return t
