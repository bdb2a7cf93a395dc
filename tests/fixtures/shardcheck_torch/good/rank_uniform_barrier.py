"""GOOD: both arms of the chief check reach a rendezvous — the guard
clause's implicit else (the rest of the function) pays the same barrier
the peers' arm does, transitively through _join()."""
from tpu_dist_torch.cluster import bootstrap


def _join(step):
    bootstrap.epoch_rendezvous(step)


def sync(step):
    if not bootstrap.is_chief():
        _join(step)
        return
    bootstrap.epoch_rendezvous(step)
