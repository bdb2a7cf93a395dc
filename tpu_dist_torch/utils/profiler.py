"""Profiling hooks: TensorBoard-compatible traces, chief-only by default.

Counterpart of ``tpu_dist/utils/profiler.py`` on ``torch.profiler``. The
JAX package writes ``jax.profiler`` traces of XLA programs; here
:func:`trace` records the span's host activity, and the card's kernels
when CUDA is available, and writes one Chrome/TensorBoard trace file
(``<host>_<pid>.<timestamp>.pt.trace.json``, TensorBoard's PyTorch
profiler layout) into ``logdir``. :func:`step_annotation` marks each
train step so the viewer aligns host dispatch with device work;
:func:`annotate` marks a named host span and records its wall time in the
port's metrics registry.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator

import torch

from tpu_dist_torch.observe import metrics

logger = logging.getLogger("tpu_dist_torch.profiler")

#: True while a trace span is open in this process: hot loops skip
#: annotation entirely when nothing is recording.
_ACTIVE = False


def _registry():
    """The port's metrics registry when it is enabled, else None."""
    reg = metrics.get_registry()
    return reg if reg.enabled else None


def is_active() -> bool:
    return _ACTIVE


@contextlib.contextmanager
def trace(logdir: str | os.PathLike, *,
          chief_only: bool = True) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the enclosed span into
    ``logdir`` (created if missing). ``chief_only`` keeps the reference's
    division of labour: only the chief traces; the other processes run
    the body untraced and write nothing."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    from tpu_dist_torch.cluster import bootstrap

    if chief_only and not bootstrap.is_chief():
        yield
        return
    global _ACTIVE
    logdir = os.fspath(logdir)
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    _ACTIVE = True
    reg = _registry()
    if reg is not None:
        reg.counter("profiler.traces").inc()
    logger.info("profiler trace started -> %s", logdir)
    try:
        yield
    finally:
        _ACTIVE = False
        prof.stop()
        logger.info("profiler trace written -> %s", logdir)


def step_annotation(step: int):
    """A context marking train step ``step`` in the trace timeline (a
    ``record_function`` span named ``train_step#<step>``); a null context
    when no trace is active."""
    if not _ACTIVE:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"train_step#{step}")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named host span in the trace (``record_function``). When the
    metrics registry is enabled it also records the span's wall time as
    the distribution ``span.<name>.s``, trace or none."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        reg = _registry()
        if reg is not None:
            reg.distribution(f"span.{name}.s").observe(
                time.perf_counter() - t0)
