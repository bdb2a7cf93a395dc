"""Job worker: the supervised entry point one packed job's gang runs.

Counterpart of ``tpu_dist/jobs/worker.py``. Launched by the
:class:`~tpu_dist_torch.jobs.scheduler.JobPool` as ``python -m
tpu_dist_torch.jobs.worker [--device D]`` with the spec in
``$TPU_DIST_JOB_SPEC``, wrapped in
:func:`~tpu_dist_torch.resilience.entrypoints.run_entry`, so every job
worker speaks the resilience protocol: SIGTERM drain, protocol exit codes,
the ``RESULT:{...}`` line its pool parses.

Both workloads are deterministic functions of the spec alone: the data,
the request stream and the seeds derive from the job-name seed
(:func:`~tpu_dist_torch.jobs.spec.derive_job_seed`), the global batch is
fixed, so a job's losses or tokens are the same run solo or packed, across
restarts and across slot placements, which the isolation and blast-radius
gates compare.

* **train**: the reference's Dense regression (8 -> 16 relu -> 4, SGD,
  MSE). A gang of N processes trains it data-parallel over gloo
  (``MultiWorkerMirroredStrategy``, one replica a process).
* **serve**: a one-block LM through ``ServeEngine``, greedy, over a seeded
  request stream; on the card each prefill launches the flash forward
  kernel. The reference's block is 16 wide with two 8-wide heads, which
  the kernel does not take (``ops/flash_attention.HEAD_DIMS``): here it is
  64 wide with two 32-wide heads. Each process of a serve gang serves the
  stream on its own device (a replica; the engine holds no collective),
  and rank 0 reports.

:func:`run_inline` is the in-process twin: the same workload placed
through :func:`~tpu_dist_torch.jobs.runtime.job_scope` onto a
:class:`~tpu_dist_torch.jobs.runtime.MeshRuntime` slot.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

from tpu_dist_torch.jobs.spec import JOB_ROOT_ENV, JobNamespace, JobSpec

#: The serve job's LM: vocabulary, positions, width and heads.
SERVE_VOCAB, SERVE_MAX_LEN, SERVE_D_MODEL, SERVE_HEADS = 32, 32, 64, 2


def _job_dataset(spec: JobSpec, seed: int):
    """Synthetic regression data, cardinality == steps_per_epoch."""
    import numpy as np

    from tpu_dist_torch.data.pipeline import Dataset

    rng = np.random.RandomState(seed)
    n = spec.batch * spec.steps_per_epoch
    x = rng.rand(n, 8).astype(np.float32)
    y = rng.rand(n, 4).astype(np.float32)
    return Dataset.from_tensor_slices((x, y)).batch(spec.batch)


def _build_train_model(spec: JobSpec, device=None):
    from tpu_dist_torch.models import Dense, Sequential

    model = Sequential([Dense(16, activation="relu"), Dense(4)],
                       input_shape=(8,), name=f"job_{spec.name}")
    model.compile(optimizer="sgd", loss="mse", device=device)
    return model


def _train_result(spec: JobSpec, ns: JobNamespace, history,
                  wall_s: float) -> dict:
    losses = [round(float(l), 10) for l in history.history.get("loss", [])]
    steps = spec.total_steps
    return {
        "job": spec.name, "kind": "train",
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
        "epochs_run": len(losses),
        "steps": steps,
        "wall_s": round(wall_s, 4),
        "metrics": {
            ns.metric("steps_per_s"): (round(steps / wall_s, 4)
                                       if wall_s > 0 else None),
            ns.metric("final_loss"): losses[-1] if losses else None,
        },
    }


def _run_train(spec: JobSpec, ns: JobNamespace,
               checkpoint_dir: Optional[str], device=None) -> dict:
    """The train workload, on the ambient strategy (none, a job scope's
    slot or the gang's) or on ``device``."""
    model = _build_train_model(spec, device)
    ds = _job_dataset(spec, ns.seed)
    t0 = time.monotonic()
    history = model.fit(ds, epochs=spec.epochs,
                        steps_per_epoch=spec.steps_per_epoch, verbose=0,
                        seed=ns.seed, checkpoint_dir=checkpoint_dir)
    return _train_result(spec, ns, history, time.monotonic() - t0)


def _serve_requests(spec: JobSpec, seed: int, vocab: int,
                    max_len: int) -> list[dict]:
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(spec.requests):
        plen = int(rng.integers(2, max(3, max_len // 4)))
        out.append({
            "prompt": rng.integers(0, vocab, size=plen).tolist(),
            "max_new_tokens": spec.max_new,
        })
    return out


def _run_serve(spec: JobSpec, ns: JobNamespace,
               journal_dir: Optional[str], device=None) -> dict:
    """The serve workload: greedy continuous batching over the seeded
    stream; the token streams are the parity payload."""
    from tpu_dist_torch.models.transformer import build_transformer_lm
    from tpu_dist_torch.ops import flash_attention
    from tpu_dist_torch.serve.engine import ServeEngine

    launches0 = flash_attention.flash_attention_fwd.launches
    # Weights from the job's seed, as the reference's engine inits them.
    model = build_transformer_lm(SERVE_VOCAB, SERVE_MAX_LEN,
                                 d_model=SERVE_D_MODEL, depth=1,
                                 num_heads=SERVE_HEADS, seed=ns.seed)
    engine = ServeEngine(model, max_batch=min(4, spec.requests),
                         max_len=SERVE_MAX_LEN, temperature=0.0,
                         seed=ns.seed, journal=journal_dir, device=device)
    t0 = time.monotonic()
    for i, req in enumerate(_serve_requests(spec, ns.seed, SERVE_VOCAB,
                                            SERVE_MAX_LEN)):
        # Paced arrivals: request i waits for its arrival time while the
        # engine drains. Greedy decode does not depend on the batch, so
        # pacing moves wall time only, never the streams.
        target = t0 + i * spec.arrival_s
        while True:
            engine.run_until_idle()
            wait = target - time.monotonic()
            if wait <= 0:
                break
            time.sleep(min(0.02, wait))
        engine.submit(**req)
    engine.run_until_idle()
    engine.close()
    wall_s = time.monotonic() - t0
    streams = {str(r.rid): [int(t) for t in r.generated]
               for r in sorted(engine.finished, key=lambda r: r.rid)}
    tokens = sum(len(s) for s in streams.values())
    return {
        "job": spec.name, "kind": "serve",
        "streams": streams,
        "tokens": tokens,
        "wall_s": round(wall_s, 4),
        # The flash forward's launches (its prefills; none on the CPU).
        "flash_fwd_launches": (flash_attention.flash_attention_fwd.launches
                               - launches0),
        "metrics": {
            ns.metric("tokens_per_s"): (round(tokens / wall_s, 4)
                                        if wall_s > 0 else None),
            ns.metric("tokens"): tokens,
        },
    }


def job_main(device: Optional[str] = None) -> dict:
    """Resolve the spec from the environment and run its workload on
    ``device`` (CUDA unless ``"cpu"``): a train job of several processes
    data-parallel over the gang the supervisor launched."""
    spec = JobSpec.from_env()
    if spec is None:
        raise RuntimeError(
            "tpu_dist_torch.jobs.worker needs $TPU_DIST_JOB_SPEC (it is "
            "launched by a JobPool, not by hand)")
    ns = JobNamespace(spec, os.environ.get(JOB_ROOT_ENV))
    if spec.kind == "serve":
        from tpu_dist_torch.serve.journal import journal_dir_from_env

        return _run_serve(spec, ns, journal_dir_from_env(), device)
    from tpu_dist_torch.resilience.entrypoints import CHECKPOINT_DIR_ENV

    scope = contextlib.nullcontext()
    if os.environ.get("TF_CONFIG"):
        from tpu_dist_torch.parallel.strategy import \
            MultiWorkerMirroredStrategy

        scope = MultiWorkerMirroredStrategy(communication="ring",
                                            device=device).scope()
    with scope:
        return _run_train(spec, ns,
                          os.environ.get(CHECKPOINT_DIR_ENV) or None, device)


def run_inline(runtime, spec: JobSpec, *, root: Optional[str] = None) -> dict:
    """The same workload in-process, placed on a slot of ``runtime``
    through :func:`~tpu_dist_torch.jobs.runtime.job_scope`, the path on
    which the trainer and the engine take their programs from the
    runtime's cache. Checkpoints and journals go to the namespace when
    ``root`` is set."""
    from tpu_dist_torch.jobs.runtime import job_scope

    with job_scope(runtime, spec, root=root) as ctx:
        ns = ctx.namespace
        device = ctx.strategy.device
        if spec.kind == "train":
            ckpt = str(ns.checkpoint_dir) if root is not None else None
            return _run_train(spec, ns, ckpt, device)
        journal = str(ns.journal_dir) if root is not None else None
        return _run_serve(spec, ns, journal, device)


def main(argv: Optional[list] = None) -> int:
    import functools

    from tpu_dist_torch.resilience.entrypoints import run_entry

    parser = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.jobs.worker",
        description="Run one packed job's workload (launched by a JobPool).")
    parser.add_argument("--device", default=None,
                        help="the job's device (default: cuda)")
    args = parser.parse_args(argv)
    return run_entry(functools.partial(job_main, device=args.device))


if __name__ == "__main__":
    import sys

    # Delegate to the canonical module instance, as the entry points do:
    # under ``python -m`` this file is a second module object.
    from tpu_dist_torch.jobs import worker as _canonical

    sys.exit(_canonical.main())
