"""BAD: only the chief reaches the barrier -> SC501. Every other rank
never shows up at the rendezvous and the chief blocks until timeout."""
from tpu_dist_torch.cluster import bootstrap


def publish(step):
    if bootstrap.is_chief():
        bootstrap.barrier(f"publish_{step}")
