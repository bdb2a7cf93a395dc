"""Supervisable training entry points.

Counterpart of ``tpu_dist/resilience/entrypoints.py``. A supervised worker
is a training script that

1. trains with ``fit(checkpoint_dir=...)``, so a restart resumes from the
   newest complete checkpoint;
2. turns a liveness verdict (``cluster.liveness.PeerUnavailableError``)
   into ``EXIT_PEER_UNAVAILABLE`` and an exhausted integrity budget
   (``training.integrity.IntegrityAbort``) into ``EXIT_INTEGRITY``;
3. reports its result as one ``RESULT:{...}`` stdout line;
4. drains on SIGTERM: :func:`run_entry` installs the seam
   (:func:`install_sigterm_handler`), the ``PreemptionDrain`` callback
   stops the fit at the next step boundary, ``on_train_end`` publishes any
   save in flight, and the worker exits ``EXIT_PREEMPTED``, all within
   ``TPU_DIST_PREEMPT_DEADLINE_S`` (a watchdog exits hard past it).

:func:`run_entry` wraps any callable in (2)-(4); :func:`demo_train` is the
built-in deterministic workload, the reference CNN on synthetic MNIST,
whose restarted run reproduces the uninterrupted run's final loss (the
generator is seeded per epoch, and the dataset's cardinality equals
``steps_per_epoch``). :func:`demo_ps_worker` and :func:`demo_ps_server` are
the same workload as the parameter server's two roles
(``resilience/ps_chaos.py`` names them in ``TPU_DIST_ENTRY``).

Configuration comes through the environment, so the supervisor launches
the same argv for every worker of every attempt:

====================================  =======================================
``TPU_DIST_CHECKPOINT_DIR``           checkpoint/resume directory (unset =
                                      no checkpointing, no resume)
``TPU_DIST_DEMO_EPOCHS``              epochs (default 3)
``TPU_DIST_DEMO_STEPS_PER_EPOCH``     steps per epoch (default 4)
``TPU_DIST_DEMO_BATCH``               global batch size (default 32)
``TPU_DIST_DEMO_STRATEGY``            ``mirrored`` = ``MultiWorkerMirrored
                                      Strategy`` over the gang (gloo, one
                                      replica a process); default: one
                                      process, no strategy
``TPU_DIST_DEMO_SHARDED``             ``1`` = the v2 sharded checkpoint
                                      layout (``ModelCheckpoint(dir,
                                      sharded=True)``)
``TPU_DIST_PREEMPT_DEADLINE_S``       graceful-drain watchdog deadline
                                      (default 60)
``TPU_DIST_ENTRY``                    ``module:callable`` to run instead of
                                      :func:`demo_train`
====================================  =======================================

``python -m tpu_dist_torch.resilience.entrypoints [--device cpu]`` runs
the entry under :func:`run_entry`; the demo trains on ``--device`` (CUDA
unless ``cpu``).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import threading
import time
from typing import Callable, Optional

from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.faults import (EXIT_INTEGRITY,
                                              EXIT_PEER_UNAVAILABLE,
                                              EXIT_PREEMPTED)

CHECKPOINT_DIR_ENV = "TPU_DIST_CHECKPOINT_DIR"
ENTRY_ENV = "TPU_DIST_ENTRY"
PREEMPT_DEADLINE_ENV = "TPU_DIST_PREEMPT_DEADLINE_S"


# -- graceful-preemption seam -------------------------------------------------
# Module-level so the trainer (through injector.maybe_preemption_drain) and
# the entry wrapper see the same request: one process, one preemption.

_PREEMPT_LOCK = threading.Lock()
_PREEMPT_ARMED = False
_PREEMPT_REQUESTED_AT: Optional[float] = None


def preemption_armed() -> bool:
    """True once :func:`install_sigterm_handler` ran in this process: the
    trainer adds its drain callback only then."""
    return _PREEMPT_ARMED


def preemption_requested() -> bool:
    return _PREEMPT_REQUESTED_AT is not None


def preemption_requested_at() -> Optional[float]:
    """``time.monotonic()`` of the first SIGTERM, or None."""
    return _PREEMPT_REQUESTED_AT


def _drain_deadline_s() -> float:
    try:
        return float(os.environ.get(PREEMPT_DEADLINE_ENV, "60"))
    except ValueError:
        return 60.0


def request_preemption(why: str) -> None:
    """Record a preemption notice (once): count it
    (``elastic.preemptions``), log ``preempt_requested``, and start the
    drain watchdog, a daemon timer that exits the process hard (code 1,
    not ``EXIT_PREEMPTED``: the checkpoint may be torn) if the drain
    outlives its deadline. The SIGTERM handler calls it, and the drain of
    a rank whose peer was preempted (``PreemptionDrain``)."""
    global _PREEMPT_REQUESTED_AT
    with _PREEMPT_LOCK:
        if _PREEMPT_REQUESTED_AT is not None:
            return  # a duplicate notice; the drain is underway
        _PREEMPT_REQUESTED_AT = time.monotonic()
    deadline = _drain_deadline_s()
    from tpu_dist_torch.observe import metrics as metrics_lib

    metrics_lib.inc("elastic.preemptions")
    events.maybe_log("preempt_requested", deadline_s=deadline,
                     attempt=events.current_attempt())
    print(f"tpu_dist_torch.resilience: {why} — draining at the next step "
          f"boundary (deadline {deadline:.0f}s)", file=sys.stderr,
          flush=True)

    def _watchdog():
        time.sleep(deadline)
        events.maybe_log("preempt_drain_timeout", deadline_s=deadline,
                         attempt=events.current_attempt())
        os._exit(1)

    threading.Thread(target=_watchdog, daemon=True,
                     name="tpu-dist-preempt-watchdog").start()


def install_sigterm_handler() -> None:
    """Arm the graceful-preemption seam (idempotent, main thread only): on
    SIGTERM, :func:`request_preemption`."""
    global _PREEMPT_ARMED
    import signal

    def _on_sigterm(signum, frame):
        request_preemption("SIGTERM received")

    signal.signal(signal.SIGTERM, _on_sigterm)
    _PREEMPT_ARMED = True


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def demo_dataset(*, n: int, batch: int, seed: int = 0):
    """Synthetic MNIST-shaped data, identical in every process and attempt
    (the JAX package's arrays)."""
    import numpy as np

    from tpu_dist_torch.data.pipeline import Dataset

    rng = np.random.RandomState(seed)
    x = rng.rand(n, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, size=(n,)).astype(np.int32)
    return Dataset.from_tensor_slices((x, y)).batch(batch)


def demo_train(device: Optional[str] = None) -> dict:
    """The chaos demo's workload: the reference CNN on synthetic MNIST, on
    ``device`` (CUDA unless ``"cpu"``). Returns ``{"final_loss",
    "epochs_run", "losses"}``; under ``TPU_DIST_CHECKPOINT_DIR`` a
    restarted run resumes and its ``final_loss`` matches the uninterrupted
    run's."""
    import contextlib

    from tpu_dist_torch.models.cnn import build_and_compile_cnn_model

    epochs = _env_int("TPU_DIST_DEMO_EPOCHS", 3)
    steps_per_epoch = _env_int("TPU_DIST_DEMO_STEPS_PER_EPOCH", 4)
    batch = _env_int("TPU_DIST_DEMO_BATCH", 32)
    # Cardinality == steps_per_epoch: every epoch consumes exactly one pass.
    ds = demo_dataset(n=batch * steps_per_epoch, batch=batch)
    scope = contextlib.nullcontext()
    if os.environ.get("TPU_DIST_DEMO_STRATEGY", "").lower() == "mirrored":
        # Data parallel over the gang the supervisor launched: gloo, which
        # also lets the processes share one card. The global batch is
        # fixed, so the losses do not depend on the process count.
        from tpu_dist_torch.parallel.strategy import \
            MultiWorkerMirroredStrategy

        scope = MultiWorkerMirroredStrategy(communication="ring",
                                            device=device).scope()
    with scope:
        model = build_and_compile_cnn_model(learning_rate=0.01,
                                            device=device)
        callbacks = []
        ckpt_dir = os.environ.get(CHECKPOINT_DIR_ENV)
        if ckpt_dir and os.environ.get("TPU_DIST_DEMO_SHARDED") == "1":
            from tpu_dist_torch.training.callbacks import ModelCheckpoint

            # One for the same directory replaces fit's own v1 one.
            callbacks.append(ModelCheckpoint(ckpt_dir, sharded=True))
        history = model.fit(
            ds, epochs=epochs, steps_per_epoch=steps_per_epoch, verbose=0,
            callbacks=callbacks, checkpoint_dir=ckpt_dir)
    losses = [round(float(l), 10) for l in history.history.get("loss", [])]
    return {
        "final_loss": losses[-1] if losses else None,
        "epochs_run": len(losses),
        "losses": losses,
    }


def demo_ps_worker(device: Optional[str] = None) -> dict:
    """The PS chaos legs' worker: :func:`demo_train`'s CNN and data, fit
    under a :class:`~tpu_dist_torch.parallel.ps_strategy.
    ParameterServerStrategy` scope on ``device`` (pull, local step, push,
    no collective; ended by the server's STOP). Every worker reads the same
    dataset (seed 0), so the asynchronous and synchronous legs' losses are
    comparable. Configured by ``TPU_DIST_PS_DIR`` / ``_RANK`` / ``_WORLD``
    / ``_STALENESS`` and the ``TPU_DIST_DEMO_*`` knobs."""
    from tpu_dist_torch.models.cnn import build_and_compile_cnn_model
    from tpu_dist_torch.parallel.ps_strategy import ParameterServerStrategy

    epochs = _env_int("TPU_DIST_DEMO_EPOCHS", 3)
    steps_per_epoch = _env_int("TPU_DIST_DEMO_STEPS_PER_EPOCH", 4)
    batch = _env_int("TPU_DIST_DEMO_BATCH", 32)
    ds = demo_dataset(n=batch * steps_per_epoch, batch=batch)
    strategy = ParameterServerStrategy(device=device)
    with strategy.scope():
        model = build_and_compile_cnn_model(learning_rate=0.01)
        history = model.fit(ds, epochs=epochs,
                            steps_per_epoch=steps_per_epoch, verbose=0)
    losses = [round(float(l), 10) for l in history.history.get("loss", [])]
    return {
        "role": "worker",
        "rank": strategy.rank,
        "pushes": strategy.pushed,
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
    }


def demo_ps_server(device: Optional[str] = None) -> dict:
    """The PS chaos legs' server on ``device``: owns the parameters and
    the optimizer state, applies pushed gradients until the apply budget
    (``TPU_DIST_PS_BUDGET``, default epochs x steps x world) is spent,
    then evaluates the final parameters on the demo dataset: the
    ``final_loss`` the convergence gates compare."""
    import numpy as np
    import torch

    from tpu_dist_torch.cluster import ps_transport
    from tpu_dist_torch.cluster.ps_transport import PSDir
    from tpu_dist_torch.models.cnn import build_and_compile_cnn_model
    from tpu_dist_torch.parallel.ps_strategy import PSServer

    epochs = _env_int("TPU_DIST_DEMO_EPOCHS", 3)
    steps_per_epoch = _env_int("TPU_DIST_DEMO_STEPS_PER_EPOCH", 4)
    batch = _env_int("TPU_DIST_DEMO_BATCH", 32)
    world = ps_transport.world_from_env()
    budget = _env_int("TPU_DIST_PS_BUDGET", epochs * steps_per_epoch * world)
    ps_dir = os.environ.get(ps_transport.PS_DIR_ENV)
    if not ps_dir:
        raise ValueError(f"demo_ps_server needs ${ps_transport.PS_DIR_ENV}")
    model = build_and_compile_cnn_model(learning_rate=0.01, device=device)
    server = PSServer(
        model, PSDir(ps_dir), num_workers=world, budget=budget,
        sync=ps_transport.sync_from_env(),
        checkpoint_dir=os.environ.get(CHECKPOINT_DIR_ENV),
        ckpt_every=_env_int("TPU_DIST_PS_CKPT_EVERY", 8),
        retain_grads=os.environ.get("TPU_DIST_PS_RETAIN_GRADS") == "1")
    stats = server.run()
    # The final parameters' loss on the demo dataset: the PS counterpart
    # of the synchronous demo's last-epoch loss.
    losses = []
    dev = next(model.parameters()).device
    model.eval()
    with torch.no_grad():
        for xb, yb in demo_dataset(n=batch * steps_per_epoch,
                                   batch=batch).as_numpy_iterator():
            logits = model(torch.from_numpy(np.asarray(xb)).to(dev))
            losses.append(float(model.loss(
                logits, torch.from_numpy(np.asarray(yb)).to(dev))))
    return {
        "role": "server",
        "final_loss": round(float(np.mean(losses)), 10) if losses else None,
        **stats,
    }


def run_entry(fn: Callable[[], Optional[dict]]) -> int:
    """Run ``fn`` under the resilience protocol; returns the exit code:
    0 with a ``RESULT:`` line; ``EXIT_PEER_UNAVAILABLE`` (logged
    ``peer_unavailable``); ``EXIT_INTEGRITY`` (``integrity_abort``: a
    restart would replay into the same wall, so the supervisor stops);
    ``EXIT_PREEMPTED`` after a drained SIGTERM (``preempt_drained`` with
    its seconds; no ``RESULT:``, the run did not finish); 1 for any other
    error (``worker_error``)."""
    from tpu_dist_torch.cluster.liveness import PeerUnavailableError
    from tpu_dist_torch.training.integrity import IntegrityAbort

    install_sigterm_handler()
    try:
        result = fn()
    except PeerUnavailableError as exc:
        events.maybe_log("peer_unavailable", error=str(exc))
        print(f"tpu_dist_torch.resilience: giving up on dead peer: {exc}",
              file=sys.stderr, flush=True)
        return EXIT_PEER_UNAVAILABLE
    except IntegrityAbort as exc:
        events.maybe_log("integrity_abort", error=str(exc))
        print(f"tpu_dist_torch.resilience: integrity rollback budget "
              f"exhausted: {exc}; exiting {EXIT_INTEGRITY} "
              f"(integrity_abort)", file=sys.stderr, flush=True)
        return EXIT_INTEGRITY
    except Exception as exc:  # the exit code reports it; the supervisor restarts
        events.maybe_log("worker_error", error=f"{type(exc).__name__}: {exc}")
        import traceback

        traceback.print_exc()
        return 1
    if preemption_requested():
        # fit returned because the drain stopped it; every callback
        # (ModelCheckpoint's async close included) has finished.
        drain_s = time.monotonic() - (preemption_requested_at() or 0.0)
        from tpu_dist_torch.observe import metrics as metrics_lib

        metrics_lib.observe_value("elastic.drain_s", drain_s)
        events.maybe_log("preempt_drained", drain_s=round(drain_s, 6),
                         attempt=events.current_attempt())
        print(f"tpu_dist_torch.resilience: drain complete in {drain_s:.3f}s;"
              f" exiting {EXIT_PREEMPTED} (preempted)",
              file=sys.stderr, flush=True)
        return EXIT_PREEMPTED
    if result is not None:
        print("RESULT:" + json.dumps(result), flush=True)
    return 0


def resolve_entry(device: Optional[str] = None
                  ) -> Callable[[], Optional[dict]]:
    """The callable ``$TPU_DIST_ENTRY`` names (``module:callable``), given
    ``device`` when it takes one (the PS demos do), else :func:`demo_train`
    on ``device``."""
    spec = os.environ.get(ENTRY_ENV)
    if not spec:
        return functools.partial(demo_train, device=device)
    mod_name, sep, fn_name = spec.partition(":")
    if not sep or not mod_name or not fn_name:
        raise ValueError(
            f"${ENTRY_ENV} must be 'module:callable', got {spec!r}")
    import importlib
    import inspect

    fn = getattr(importlib.import_module(mod_name), fn_name)
    if not callable(fn):
        raise TypeError(f"{spec} is not callable")
    if device is not None and "device" in inspect.signature(fn).parameters:
        return functools.partial(fn, device=device)
    return fn


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.resilience.entrypoints",
        description="Run the training entry under the resilience protocol.")
    parser.add_argument("--device", default=None,
                        help="the demo's device (default: cuda)")
    args = parser.parse_args(argv)
    return run_entry(resolve_entry(args.device))


if __name__ == "__main__":
    # Delegate to the canonical module instance: under ``python -m`` this
    # file runs as ``__main__``, a second module object, and arming the
    # seam here would leave the instance the trainer imports unarmed.
    from tpu_dist_torch.resilience import entrypoints as _canonical

    sys.exit(_canonical.main())
