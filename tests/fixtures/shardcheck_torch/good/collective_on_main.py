"""GOOD: the worker thread only computes; the barrier runs on the main
thread after the join — the async-writer commit-point idiom."""
import threading

from tpu_dist_torch.cluster import bootstrap


def _count(out):
    out.append(sum(range(100)))


def run():
    out = []
    t = threading.Thread(target=_count, args=(out,), daemon=True)
    t.start()
    t.join()
    bootstrap.barrier("after_join")
    return out
