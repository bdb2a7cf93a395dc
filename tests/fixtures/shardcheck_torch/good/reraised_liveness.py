"""shardcheck good fixture: the dead-peer signal propagates (SC105 clean).

Three acceptable shapes: a dedicated PeerUnavailableError handler ahead of
the broad one, a broad handler that re-raises, and a narrow handler that
cannot swallow the verdict at all.
"""

import logging

from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.cluster.liveness import PeerUnavailableError

logger = logging.getLogger(__name__)


def train_supervised(monitor, run_epoch, epochs):
    for epoch in range(epochs):
        try:
            monitor.raise_if_failed()
            run_epoch(epoch)
            bootstrap.barrier(f"epoch_{epoch}")
        except PeerUnavailableError:
            raise SystemExit(17)
        except Exception as e:
            logger.warning("epoch %d failed: %s", epoch, e)


def train_reraising(monitor, run_epoch, epochs):
    for epoch in range(epochs):
        try:
            monitor.raise_if_failed()
            run_epoch(epoch)
        except Exception:
            logger.exception("epoch %d failed", epoch)
            raise


def train_narrow(run_epoch, epochs):
    for epoch in range(epochs):
        try:
            run_epoch(epoch)
            bootstrap.barrier(f"epoch_{epoch}")
        except OSError as e:
            logger.warning("epoch %d I/O failure: %s", epoch, e)
