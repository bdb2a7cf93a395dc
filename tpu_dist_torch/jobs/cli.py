"""``python -m tpu_dist_torch.jobs`` — the multi-job bench and chaos driver.

Counterpart of ``tpu_dist/jobs/cli.py``. ``--bench`` packs the seeded mix
(two train and two serve jobs, a 2-slot slice each: a gang of two
processes) onto one virtual pool and reports per-job throughput and the
packed **makespan against serial**, serial being the same jobs one at a
time on the same slice size, so process start-up costs appear in both. The
gate: packed makespan <= ``--gate-ratio`` x serial, and every job done.

``--chaos`` hands the mix to :mod:`tpu_dist_torch.jobs.chaos`: solo parity
baselines, then packed runs with ``job_kill`` / ``job_hang`` plans armed,
gated on anti-vacuity, blast radius zero and the classification of failed
jobs. ``--device`` (CUDA unless ``cpu``) is every job process's device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
from typing import Optional

from tpu_dist_torch.jobs.scheduler import DONE, JobPool
from tpu_dist_torch.jobs.spec import JobSpec


def bench_mix() -> list[JobSpec]:
    """The seeded bench mix: 2 train + 2 serve jobs, one 2-slot slice
    each, filling the 8-slot pool exactly when packed."""
    return [
        JobSpec(name="train-a", kind="train", devices=2, priority=1,
                epochs=2, steps_per_epoch=4, batch=8),
        JobSpec(name="train-b", kind="train", devices=2, priority=0,
                epochs=2, steps_per_epoch=4, batch=8),
        JobSpec(name="serve-a", kind="serve", devices=2, priority=1,
                requests=4, max_new=8, arrival_s=1.5),
        JobSpec(name="serve-b", kind="serve", devices=2, priority=0,
                requests=4, max_new=8, arrival_s=1.5),
    ]


def chaos_mix() -> list[JobSpec]:
    """The chaos mix (the blast-radius gate's shape): 3 jobs on the
    8-slot pool — job 0 train survivor, job 1 train fault target, job 2
    serve survivor."""
    return [
        JobSpec(name="alpha", kind="train", devices=2, priority=0,
                epochs=2, steps_per_epoch=4, batch=8),
        JobSpec(name="bravo", kind="train", devices=2, priority=0,
                epochs=2, steps_per_epoch=4, batch=8),
        JobSpec(name="charlie", kind="serve", devices=2, priority=0,
                requests=4, max_new=8),
    ]


def run_solo(spec: JobSpec, *, root, pool: int, max_restarts: int,
             deadline_s: float, device: Optional[str] = None) -> dict:
    """One job alone on the pool — the serial leg / parity baseline. The
    gang shape (one process a slot of the job's slice) matches the packed
    run exactly, so results are comparable bit for bit."""
    jp = JobPool([spec], root=root, pool=pool, max_restarts=max_restarts,
                 attempt_deadline_s=deadline_s, device=device)
    report = jp.run()
    return report["jobs"][0] | {"makespan_s": report["makespan_s"]}


def run_bench(args) -> int:
    mix = bench_mix()
    workdir = pathlib.Path(args.workdir or tempfile.mkdtemp(
        prefix="tpu-dist-jobs-bench-"))
    print(f"jobs bench workdir: {workdir}", file=sys.stderr)

    serial: dict[str, dict] = {}
    serial_s = 0.0
    for spec in mix:
        print(f"serial: running {spec.name} solo...", file=sys.stderr)
        solo = run_solo(spec, root=workdir / "solo" / spec.name,
                        pool=args.pool, max_restarts=args.max_restarts,
                        deadline_s=args.deadline, device=args.device)
        serial[spec.name] = solo
        serial_s += solo["makespan_s"]

    print(f"packed: running {len(mix)} jobs concurrently...",
          file=sys.stderr)
    packed = JobPool(mix, root=workdir / "packed", pool=args.pool,
                     max_restarts=args.max_restarts,
                     attempt_deadline_s=args.deadline,
                     device=args.device).run()

    ratio = (packed["makespan_s"] / serial_s) if serial_s > 0 else None
    all_done = (packed["done"] == len(mix)
                and all(j["state"] == DONE for j in serial.values()))
    ok = bool(all_done and ratio is not None and ratio <= args.gate_ratio)
    report = {
        "config": {
            "pool_devices": args.pool,
            "jobs": [s.to_json() for s in mix],
            "gate_ratio": args.gate_ratio,
            "device": args.device,
        },
        "serial": {"makespan_s": round(serial_s, 4), "jobs": serial},
        "packed": packed,
        "packed_over_serial": (None if ratio is None else round(ratio, 4)),
        "all_done": all_done,
        "ok": ok,
    }
    out = json.dumps(report, indent=2)
    print(out)
    if args.report:
        pathlib.Path(args.report).write_text(out + "\n")
    if not ok:
        why = ("a job did not complete" if not all_done else
               f"packed/serial ratio {ratio:.3f} > gate {args.gate_ratio}")
        print(f"jobs bench gate FAILED: {why}", file=sys.stderr)
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.jobs",
        description="multi-tenant job runtime: bench + chaos driver")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--bench", action="store_true",
                      help="pack the demo mix; report makespan vs serial")
    mode.add_argument("--chaos", action="store_true",
                      help="gated multi-job fault suite (blast radius)")
    p.add_argument("--pool", type=int, default=8,
                   help="virtual device pool size (default 8)")
    p.add_argument("--device", default=None,
                   help="every job process's device (default: cuda; "
                        "'cpu' runs the plain PyTorch path)")
    p.add_argument("--plan", default=None,
                   help="fault plan for --chaos "
                        "(default job_kill@job1; job kinds only)")
    p.add_argument("--abort-plan", default="job_kill@job1:abort",
                   help="second --chaos phase plan proving failed-job "
                        "classification; '' disables the phase")
    p.add_argument("--max-restarts", type=int, default=2)
    p.add_argument("--deadline", type=float, default=180.0,
                   help="per-attempt supervisor deadline (seconds)")
    p.add_argument("--gate-ratio", type=float, default=0.8,
                   help="--bench gate: packed makespan <= ratio x serial")
    p.add_argument("--workdir", default=None,
                   help="working directory (default: a fresh tempdir)")
    p.add_argument("--report", default=None,
                   help="also write the JSON report to this path")
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.bench:
        return run_bench(args)
    from tpu_dist_torch.jobs.chaos import run_chaos

    return run_chaos(args)
