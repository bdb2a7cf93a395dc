"""``python -m tpu_dist_torch.serve`` — demo + seeded load generator.

Counterpart of ``tpu_dist/serve/cli.py`` (its demo and ``--bench`` modes):

* default (demo): build the causal LM from ``--seed``, serve a handful of
  prompts through the continuous-batching engine, print the generations
  and the latency/throughput summary.
* ``--bench``: a seeded load-generator run — **closed-loop** (``--clients
  K``: at most K requests in flight, the next submitted as one finishes)
  or **open-loop** (``--arrival-rate R``: exponential interarrivals at R
  req/s). Prints a JSON report with p50/p95/p99 request latency, TTFT,
  throughput and batch occupancy; exits 1 when no request completed.

Runs on the CUDA device unless ``--device cpu`` is given. The full width
of the repo's benchmark LM is ``--vocab 8192 --d-model 512 --depth 4
--num-heads 8 --max-len 512``.
"""

from __future__ import annotations

import argparse
import json
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


def _build_engine(args):
    from tpu_dist_torch.models.transformer import build_transformer_lm
    from tpu_dist_torch.serve.engine import ServeEngine

    model = build_transformer_lm(args.vocab, args.max_len,
                                 d_model=args.d_model, depth=args.depth,
                                 num_heads=args.num_heads, seed=args.seed)
    return ServeEngine(model, max_batch=args.max_batch,
                       max_len=args.max_len, policy=args.policy,
                       temperature=args.temperature, seed=args.seed,
                       device=args.device)


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
    from tpu_dist_torch.serve.scheduler import DONE, EVICTED
    from tpu_dist_torch.utils.device import device_name

    done = [r for r in engine.finished if r.status == DONE]
    evicted = [r for r in engine.finished if r.status == EVICTED]
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
    while submitted < len(pending) or not engine.scheduler.idle():
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.serve",
        description="continuous-batching inference demo + load generator "
                    "(PyTorch/CUDA port)")
    p.add_argument("--bench", action="store_true",
                   help="seeded load-generator run, JSON report")
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
    args = p.parse_args(argv)

    metrics.get_registry().reset()
    metrics.enable()
    try:
        engine = _build_engine(args)
        if args.bench:
            summary = run_load(engine, _workload(args),
                               clients=args.clients,
                               arrival_rate=args.arrival_rate,
                               seed=args.seed, deadline_s=args.deadline_s)
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
                           "seed": args.seed},
                **summary,
            }
            report["ok"] = report["completed"] > 0
            print(json.dumps(report, indent=2))
            if not report["ok"]:
                print(f"VACUOUS: no request completed "
                      f"({report['evicted']} evicted)", file=sys.stderr)
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
        for r in reqs:
            print(f"req {r.rid}: prompt[{len(r.prompt)}] -> "
                  f"{r.generated} ({r.finish_reason}, "
                  f"{(r.latency_s or 0) * 1e3:.1f} ms)")
        print(json.dumps(_summary(engine,
                                  wall_s=time.monotonic() - t0), indent=2))
        return 0
    finally:
        metrics.disable()


if __name__ == "__main__":
    sys.exit(main())
