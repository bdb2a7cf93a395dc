"""GOOD: unordered sources are sorted before they feed order, or the
loop body is order-insensitive -> no SC603.

* sorted() wraps the scan before the append;
* append-then-return-sorted is order-clean (the sort erases arrival
  order);
* a pure unlink/set-bookkeeping body has no order to corrupt.
"""
import os


def collect_packets(directory):
    out = []
    for name in sorted(os.listdir(directory)):
        out.append(name)
    return out


def all_steps(directory):
    out = []
    for name in os.listdir(directory):
        out.append(name)
    return sorted(out)


def gc_stale(directory, keep):
    seen = set()
    for name in os.listdir(directory):
        if name not in keep:
            os.remove(os.path.join(directory, name))
        seen.add(name)
    return seen
