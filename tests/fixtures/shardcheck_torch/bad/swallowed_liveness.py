"""shardcheck bad fixture: broad handler eats the dead-peer signal (SC105).

The epoch loop polls the liveness monitor, but the blanket
``except Exception`` treats a PeerUnavailableError verdict like any
transient hiccup and keeps looping — the job runs half-alive forever
instead of exiting for its supervisor to restart.
"""

from tpu_dist_torch.cluster import bootstrap


def train_forever(monitor, run_epoch):
    epoch = 0
    while True:
        try:
            monitor.raise_if_failed()
            run_epoch(epoch)
            bootstrap.barrier(f"epoch_{epoch}")
        except Exception:
            continue
        epoch += 1
