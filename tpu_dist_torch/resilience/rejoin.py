"""Mid-epoch gang reform: the step-granular half of elastic training.

Counterpart of ``tpu_dist/resilience/rejoin.py``. The epoch-boundary
:class:`~tpu_dist_torch.resilience.injector.RejoinGate` lets a relaunched
worker back in only at the next ``on_epoch_begin``; a rank lost mid-epoch
still costs a gang restart. The gang-generation protocol
(``cluster/bootstrap.py``) closes that gap:

1. The Supervisor detects a dead rank and publishes a reform request for
   generation g+1 in the shared gang directory.
2. Every survivor's :class:`StepRejoinGate` sees it at its next step
   boundary (the drain's seam) and raises :class:`GangReform` out of the
   hot loop.
3. ``Trainer.fit`` catches it: publishes the async save in flight, acks,
   reforms its clique under generation g+1 (``bootstrap.reinitialize``),
   restores the consensus checkpoint in place and meets the relaunched
   rank at a ``generation_rendezvous``; survivors keep their process.
4. The replay from the restored epoch draws the same per-epoch seeds, so
   the losses equal a fault-free run's bit for bit.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from tpu_dist_torch.resilience import events
from tpu_dist_torch.training.callbacks import Callback


class GangReform(Exception):
    """Raised out of the fit loop when a reform request is pending: a
    transfer of control, caught at the retry seam beside
    ``RollbackAndReplay``, which runs the survivor side of the reform."""

    def __init__(self, request: dict, *, seen_at: float):
        self.request = request
        self.generation = int(request["generation"])
        self.lost_ranks = list(request.get("lost_ranks") or [])
        #: ``time.monotonic()`` when the gate saw the request: the drain
        #: clock's zero.
        self.seen_at = seen_at
        super().__init__(
            f"gang reform requested: generation {self.generation}, "
            f"lost rank(s) {self.lost_ranks}")


class StepRejoinGate(Callback):
    """Step-boundary reform gate and generation-namespaced epoch barrier.

    Reads the gang directory's reform request at every ``on_batch_end`` /
    ``on_epoch_begin`` (one small JSON file) and raises
    :class:`GangReform` when it names a newer generation than ours;
    otherwise it holds each epoch's start at a ``generation_rendezvous`` on
    the ``epoch * steps_per_epoch`` step, so the gang steps together."""

    wants_batches = True

    def __init__(self, directory: str, *, rank: int, world: int,
                 steps_per_epoch: int, timeout_s: float = 120.0):
        self.directory = directory
        self.rank = int(rank)
        self.world = int(world)
        self.steps_per_epoch = int(steps_per_epoch)
        self.timeout_s = float(timeout_s)
        self.generation: Optional[int] = None
        #: (generation, step) of the last rendezvous passed: the reform's
        #: explicit barrier is not repeated by the next epoch's start.
        self._met_at: Optional[tuple] = None

    def on_train_begin(self) -> None:
        from tpu_dist_torch.cluster import bootstrap

        # A relaunched worker carries the reformed generation in its
        # environment; a survivor that raced the commit adopts the file.
        self.generation = max(bootstrap.current_generation(),
                              bootstrap.read_generation(self.directory))

    def _check_reform(self) -> None:
        from tpu_dist_torch.cluster import bootstrap

        req = bootstrap.read_reform_request(self.directory)
        if req is not None and int(req["generation"]) > (self.generation or 0):
            raise GangReform(req, seen_at=time.monotonic())

    def on_batch_end(self, step: int, logs: dict) -> None:
        self._check_reform()

    def rendezvous(self, *, step: int, epoch: Optional[int] = None) -> None:
        """Meet the gang at ``step`` under the current generation. A rank
        parked here while a peer dies would wait out the timeout (the dead
        rank never publishes this generation's marker), so the wait checks
        for a reform every round and raises :class:`GangReform` from it."""
        from tpu_dist_torch.cluster import bootstrap
        from tpu_dist_torch.observe import metrics as metrics_lib

        coord = (self.generation, step)
        if self._met_at == coord:
            return
        t0 = time.monotonic()
        ranks = bootstrap.generation_rendezvous(
            self.directory, generation=self.generation or 0, step=step,
            rank=self.rank, world=self.world, timeout_s=self.timeout_s,
            abort_check=self._check_reform)
        wait_s = time.monotonic() - t0
        self._met_at = coord
        metrics_lib.observe_value("elastic.rejoin_wait_s", wait_s)
        log = events.log_from_env()
        if log is not None:
            log.append("rejoin_rendezvous", attempt=events.current_attempt(),
                       generation=self.generation, step=step, epoch=epoch,
                       ranks=ranks, wait_s=round(wait_s, 6))

    def on_epoch_begin(self, epoch: int) -> None:
        self._check_reform()
        self.rendezvous(step=epoch * self.steps_per_epoch, epoch=epoch)


def maybe_step_rejoin_gate(*, steps_per_epoch: int
                           ) -> Optional[StepRejoinGate]:
    """A :class:`StepRejoinGate` when ``$TPU_DIST_GANG_DIR`` names the gang
    directory, else None. The gang coordinates come from
    ``$TPU_DIST_REJOIN_WORLD`` / ``$TPU_DIST_REJOIN_RANK`` (supervised
    single-process workers are each process 0 of their own), else the
    process group's; ``$TPU_DIST_REJOIN_TIMEOUT_S`` bounds every wait
    (default 120)."""
    from tpu_dist_torch.cluster import bootstrap

    directory = os.environ.get(bootstrap.GANG_DIR_ENV)
    if not directory:
        return None
    world = os.environ.get("TPU_DIST_REJOIN_WORLD")
    rank = os.environ.get("TPU_DIST_REJOIN_RANK")
    if world is None:
        world = bootstrap.process_count()
    if rank is None:
        rank = bootstrap.process_index()
    timeout_s = float(os.environ.get("TPU_DIST_REJOIN_TIMEOUT_S", "120"))
    return StepRejoinGate(directory, rank=int(rank), world=int(world),
                          steps_per_epoch=steps_per_epoch,
                          timeout_s=timeout_s)
