"""GOOD: the suppression is load-bearing — it eats a real SC403 on its
line (with the required rationale), so SC901 stays quiet."""
import threading

from tpu_dist_torch.cluster import bootstrap


def _flush():
    bootstrap.barrier("flush")  # shardcheck: disable=SC403 -- single-process demo harness; there is no gang to race


def start():
    t = threading.Thread(target=_flush, daemon=True)
    t.start()
    return t
