"""``python -m tpu_dist_torch.serve`` — demo + seeded load generator.

Counterpart of ``tpu_dist/serve/cli.py``:

* default (demo): build the causal LM from ``--seed``, serve a handful of
  prompts through the continuous-batching engine, print the generations
  and the latency/throughput summary.
* ``--bench``: a seeded load-generator run — **closed-loop** (``--clients
  K``: at most K requests in flight, the next submitted as one finishes)
  or **open-loop** (``--arrival-rate R``: exponential interarrivals at R
  req/s). Prints a JSON report with p50/p95/p99 request latency, TTFT,
  throughput and batch occupancy; exits 1 when no request completed.
* ``--chaos --plan P``: the gated serve chaos run (``serve/chaos.py``):
  ``engine_crash@reqN`` / ``decode_stall@reqN:Ss`` against a supervised
  ``--worker`` subprocess that recovers from its journal, and
  ``request_storm@reqN`` with and without load shedding on a virtual
  clock. Exits 0 iff every gate holds, 2 without a serve fault.
* ``--worker``: one supervised attempt of a chaos run (journal and fault
  plan from the environment, a ``RESULT:{...}`` line on stdout).
* ``--fleet``: the sessioned workload through ``--fleet-replicas``
  replicas behind the prefix-affinity router (``serve/fleet.py``), every
  stream against a solo baseline, gated routing, failover
  (``replica_kill@reqN:replicaR``) and storm (``router_storm@reqN:xM``)
  invariants; exits 0 iff every gate holds, 2 with a solo fault kind.
  ``--devices-per-replica 1`` leases each replica a slot of the jobs
  runtime (``jobs/runtime.py``); more than 1 is ROADMAP item 12b.

Set ``$TPU_DIST_OBSERVE_DIR`` to also export the metrics snapshot of a
``--bench`` or demo run as a schema-versioned JSONL series and a
Prometheus textfile there (``serve.jsonl``, ``serve.prom``), as training
telemetry does.

``--journal-dir``, ``--max-queue``, ``--max-ttft-s``, ``--retry-budget``
and ``--stall-timeout-s`` arm the engine's journal, load shedding and
stall watchdog in every mode.

``--paged`` serves from the paged KV pool with prefix caching
(``--page-size``, ``--num-pages``, ``--budget-mb``, ``--kv-dtype int8``
for quantized pages, ``--ragged`` for one full-capacity decode program);
``--budget-mb`` alone guards the contiguous cache. ``--model-dir D``
serves a ``save_model`` directory (either package's) instead of the demo
LM, its cache slots as long as the model's positions; ``--vocab`` and
``--max-len`` still shape the workload, which must fit the saved model.
Runs on the CUDA device unless ``--device cpu`` is given. The full width
of the repo's benchmark LM is ``--vocab 8192 --d-model 512 --depth 4
--num-heads 8 --max-len 512``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np

from tpu_dist_torch.observe import metrics


def _quantile(vals, p: float) -> Optional[float]:
    """None on empty, else the :func:`metrics.quantile` estimator."""
    if not vals:
        return None
    return round(metrics.quantile(sorted(float(v) for v in vals), p), 6)


def _build_engine(args, *, policy: Optional[str] = None, **engine_kwargs):
    """Build the demo/bench engine; ``engine_kwargs`` forward the
    resilience knobs (journal, max_queue, stall watchdog, ...) straight to
    :class:`~tpu_dist_torch.serve.engine.ServeEngine`."""
    from tpu_dist_torch.models.transformer import build_transformer_lm
    from tpu_dist_torch.serve.engine import ServeEngine

    paged_kwargs = {}
    if getattr(args, "paged", False):
        paged_kwargs = {"paged": True, "page_size": args.page_size,
                        "num_pages": args.num_pages}
        if getattr(args, "kv_dtype", None) is not None:
            paged_kwargs["kv_dtype"] = args.kv_dtype
        if getattr(args, "ragged", False):
            paged_kwargs["ragged"] = True
    if getattr(args, "budget_mb", None) is not None:
        paged_kwargs["budget_bytes"] = int(args.budget_mb * 2**20)
    if args.model_dir:
        return ServeEngine.from_saved(
            args.model_dir, max_batch=args.max_batch,
            policy=policy or args.policy, temperature=args.temperature,
            seed=args.seed, device=args.device, **paged_kwargs,
            **engine_kwargs)
    model = build_transformer_lm(args.vocab, args.max_len,
                                 d_model=args.d_model, depth=args.depth,
                                 num_heads=args.num_heads, seed=args.seed)
    return ServeEngine(model, max_batch=args.max_batch,
                       max_len=args.max_len, policy=policy or args.policy,
                       temperature=args.temperature, seed=args.seed,
                       device=args.device, **paged_kwargs, **engine_kwargs)


def _workload(args) -> list[dict]:
    """Seeded synthetic request stream: ragged prompts, varied budgets."""
    rng = np.random.default_rng(args.seed)
    out = []
    for _ in range(args.requests):
        plen = int(rng.integers(2, max(3, args.max_len // 4)))
        out.append({
            "prompt": rng.integers(0, args.vocab, size=plen).tolist(),
            "max_new_tokens": int(rng.integers(args.min_new,
                                               args.max_new + 1)),
        })
    return out


def _summary(engine, *, wall_s: float) -> dict:
    from tpu_dist_torch.serve.scheduler import DONE, EVICTED, SHED
    from tpu_dist_torch.utils.device import device_name

    # Terminal states are exclusive and exhaustive: every finished request
    # is exactly one of done / evicted / shed.
    done = [r for r in engine.finished if r.status == DONE]
    evicted = [r for r in engine.finished if r.status == EVICTED]
    shed = [r for r in engine.finished if r.status == SHED]
    assert len(done) + len(evicted) + len(shed) == len(engine.finished), \
        "finished request with a non-terminal status"
    tokens = sum(len(r.generated) for r in engine.finished)
    q = _quantile
    lat = [r.latency_s for r in done if r.latency_s is not None]
    ttft = [r.ttft_s for r in done if r.ttft_s is not None]
    snap = metrics.get_registry().snapshot() if metrics.enabled() else None
    occ = (snap["distributions"].get("serve.batch.occupancy")
           if snap else None)
    return {
        "device": device_name(engine.device),
        "completed": len(done),
        "evicted": len(evicted),
        "shed": len(shed),
        "tokens_generated": tokens,
        "wall_s": round(wall_s, 4),
        "throughput_tok_s": (round(tokens / wall_s, 2) if wall_s > 0
                             else None),
        "latency_s": {"p50": q(lat, 0.5), "p95": q(lat, 0.95),
                      "p99": q(lat, 0.99)},
        "ttft_s": {"p50": q(ttft, 0.5), "p95": q(ttft, 0.95),
                   "p99": q(ttft, 0.99)},
        "batch_occupancy": occ,
        "compiled_programs": engine.compiled_programs(),
    }


def run_load(engine, workload: list[dict], *, clients: int = 0,
             arrival_rate: float = 0.0, seed: int = 0,
             deadline_s: Optional[float] = None) -> dict:
    """Drive a request stream through the engine; returns the summary.

    ``clients > 0`` -> closed-loop: at most ``clients`` requests in flight;
    the next request of the stream is submitted the moment one finishes.
    ``arrival_rate > 0`` -> open-loop: request i arrives at the i-th
    seeded exponential arrival time. Both modes drain the full workload.
    """
    rng = np.random.default_rng(seed)
    pending = list(workload)
    t0 = time.monotonic()
    if arrival_rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate,
                                             size=len(pending)))
    else:
        arrivals = None
        width = max(1, clients or engine.max_batch)

    submitted = 0
    while submitted < len(pending) or not engine.scheduler.idle():  # shardcheck: disable=SC502 -- local engine progress bounds the loop
        if arrivals is not None:
            elapsed = time.monotonic() - t0
            while (submitted < len(pending)
                   and arrivals[submitted] <= elapsed):
                w = pending[submitted]
                engine.submit(w["prompt"],
                              max_new_tokens=w["max_new_tokens"],
                              deadline_s=deadline_s)
                submitted += 1
        else:
            in_flight = (engine.scheduler.num_active
                         + engine.scheduler.queue_depth())
            while submitted < len(pending) and in_flight < width:
                w = pending[submitted]
                engine.submit(w["prompt"],
                              max_new_tokens=w["max_new_tokens"],
                              deadline_s=deadline_s)
                submitted += 1
                in_flight += 1
        if engine.scheduler.idle():
            if arrivals is None:
                continue  # closed loop refills immediately above
            # Open loop: idle until the next arrival is due.
            nxt = arrivals[submitted] - (time.monotonic() - t0)
            if nxt > 0:
                time.sleep(min(nxt, 0.05))
            continue
        engine.step()
    return _summary(engine, wall_s=time.monotonic() - t0)


def _export_observe(tag: str) -> Optional[str]:
    """Write the metrics snapshot under ``$TPU_DIST_OBSERVE_DIR`` (a JSONL
    record of kind ``tag`` and a Prometheus textfile); returns the
    directory, or None when the variable is unset."""
    from tpu_dist_torch.observe.telemetry import OBSERVE_DIR_ENV

    d = os.environ.get(OBSERVE_DIR_ENV)
    if not d:
        return None
    from tpu_dist_torch.observe.exporters import (JsonlExporter,
                                                  write_prometheus_textfile)

    os.makedirs(d, exist_ok=True)
    snap = metrics.get_registry().snapshot()
    with JsonlExporter(os.path.join(d, "serve.jsonl")) as ex:
        ex.write(snap, kind=tag)
    write_prometheus_textfile(snap, os.path.join(d, "serve.prom"))
    return d


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.serve",
        description="continuous-batching inference demo + load generator "
                    "(PyTorch/CUDA port)")
    p.add_argument("--bench", action="store_true",
                   help="seeded load-generator run, JSON report")
    p.add_argument("--model-dir", default=None,
                   help="serve a models.save_model directory instead of a "
                        "freshly initialized demo LM")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "plain PyTorch path)")
    p.add_argument("--policy", choices=("continuous", "static"),
                   default="continuous")
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--clients", type=int, default=0,
                   help="closed-loop client count (0 = saturate the batch)")
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="open-loop arrivals per second (0 = closed loop)")
    p.add_argument("--deadline-s", type=float, default=None)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--min-new", type=int, default=4)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--paged", action="store_true",
                   help="paged KV cache + prefix reuse instead of the "
                        "contiguous per-slot preallocation")
    p.add_argument("--page-size", type=int, default=16,
                   help="positions per KV page (with --paged)")
    p.add_argument("--num-pages", type=int, default=None,
                   help="page-pool size (default: contiguous-capacity "
                        "parity, max_batch * ceil(max_len/page_size))")
    p.add_argument("--budget-mb", type=float, default=None,
                   help="KV memory budget in MiB — loud sizing error "
                        "(contiguous) or pool auto-sizing (--paged)")
    p.add_argument("--kv-dtype", choices=("fp32", "bf16", "int8"),
                   default=None,
                   help="paged-pool storage dtype (with --paged); int8 "
                        "quantizes K/V pages with per-position fp32 "
                        "scales — ~2x pages at a fixed --budget-mb")
    p.add_argument("--ragged", action="store_true",
                   help="one full-capacity decode program with per-slot "
                        "masking instead of pow2 buckets (with --paged)")
    p.add_argument("--worker", action="store_true",
                   help="supervised serve worker: journal + fault plan "
                        "from the environment, RESULT line on stdout")
    p.add_argument("--chaos", action="store_true",
                   help="serve chaos run: baseline, supervised faults, "
                        "gated JSON report")
    p.add_argument("--plan", default=None,
                   help="fault plan for --chaos (engine_crash@reqN / "
                        "decode_stall@reqN:Ss / request_storm@reqN)")
    p.add_argument("--journal-dir", default=None,
                   help="durable request journal directory (recovery "
                        "replays an existing journal)")
    p.add_argument("--max-queue", type=int, default=None,
                   help="bounded admission queue: shed past this depth")
    p.add_argument("--max-ttft-s", type=float, default=None,
                   help="shed when projected TTFT exceeds this bound")
    p.add_argument("--retry-budget", type=int, default=3,
                   help="max crash replays before a request is shed")
    p.add_argument("--stall-timeout-s", type=float, default=None,
                   help="decode-stall watchdog bound (None = disabled)")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--deadline", type=float, default=120.0, metavar="S",
                   help="per-attempt wall-clock deadline for --chaos")
    p.add_argument("--storm-requests", type=int, default=300)
    p.add_argument("--storm-burst", type=int, default=25,
                   help="storm submissions between decode rounds")
    p.add_argument("--virtual-step-s", type=float, default=0.05,
                   help="virtual decode-step seconds for the storm gate")
    p.add_argument("--p99-target-s", type=float, default=None,
                   help="storm p99 gate (default: BENCH_SERVE.json)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--report", default=None,
                   help="also write the chaos JSON report to this path")
    p.add_argument("--fleet", action="store_true",
                   help="multi-replica fleet run: sessioned workload "
                        "through the prefix-affinity router, token-parity "
                        "+ failover gates (serve/fleet.py)")
    p.add_argument("--fleet-replicas", type=int, default=2,
                   help="initial replica count for --fleet")
    p.add_argument("--fleet-sessions", type=int, default=4,
                   help="distinct shared-prefix sessions in the --fleet "
                        "workload (affinity anti-vacuity needs >= 1)")
    p.add_argument("--devices-per-replica", type=int, default=None,
                   help="lease each replica a slot of this many devices "
                        "through the jobs runtime (1; more is item 12b)")
    args = p.parse_args(argv)

    if args.fleet:
        from tpu_dist_torch.serve.fleet import run_fleet

        return run_fleet(args)
    if args.worker:
        from tpu_dist_torch.serve.chaos import run_worker

        return run_worker(args)
    if args.chaos:
        from tpu_dist_torch.serve.chaos import run_chaos

        return run_chaos(args)

    metrics.get_registry().reset()
    metrics.enable()
    try:
        engine = _build_engine(args, journal=args.journal_dir,
                               max_queue=args.max_queue,
                               max_ttft_s=args.max_ttft_s,
                               retry_budget=args.retry_budget,
                               stall_timeout_s=args.stall_timeout_s)
        if args.bench:
            summary = run_load(engine, _workload(args),
                               clients=args.clients,
                               arrival_rate=args.arrival_rate,
                               seed=args.seed, deadline_s=args.deadline_s)
            engine.close()
            report = {
                "bench": "serve.load",
                "mode": ("open-loop" if args.arrival_rate > 0
                         else "closed-loop"),
                "policy": args.policy,
                "config": {"requests": args.requests,
                           "max_batch": args.max_batch,
                           "max_len": args.max_len,
                           "clients": args.clients,
                           "arrival_rate": args.arrival_rate,
                           "paged": bool(args.paged),
                           "page_size": args.page_size,
                           "kv_dtype": args.kv_dtype,
                           "ragged": bool(args.ragged),
                           "seed": args.seed},
                **summary,
            }
            report["ok"] = report["completed"] > 0
            obs = _export_observe("serve_bench")
            if obs:
                report["observe_dir"] = obs
            print(json.dumps(report, indent=2))
            if not report["ok"]:
                print(f"VACUOUS: no request completed "
                      f"({report['shed']} shed, {report['evicted']} "
                      f"evicted)", file=sys.stderr)
                return 1
            return 0

        # Demo: a few seeded prompts through the engine, verbose output.
        rng = np.random.default_rng(args.seed)
        reqs = [engine.submit(
                    rng.integers(0, args.vocab,
                                 size=int(rng.integers(2, 9))).tolist(),
                    max_new_tokens=int(rng.integers(4, 13)))
                for _ in range(min(args.requests, 6))]
        t0 = time.monotonic()
        engine.run_until_idle()
        engine.close()
        for r in reqs:
            print(f"req {r.rid}: prompt[{len(r.prompt)}] -> "
                  f"{r.generated} ({r.finish_reason}, "
                  f"{(r.latency_s or 0) * 1e3:.1f} ms)")
        print(json.dumps(_summary(engine,
                                  wall_s=time.monotonic() - t0), indent=2))
        _export_observe("serve_demo")
        return 0
    finally:
        metrics.disable()


if __name__ == "__main__":
    sys.exit(main())
