"""``python -m tpu_dist_torch.observe`` — demo, summarize, diff, bench.

Counterpart of ``tpu_dist/observe/cli.py``; ``demo`` and ``bench`` train on
the CUDA device unless ``--device cpu`` is given. The CLI mirrors the resilience chaos runner's conventions: machine-first
JSON output, and a hard anti-vacuity stance — a metrics series with no
step timing or no collective traffic FAILS, because an empty series passed
silently is how observability rots.

Subcommands::

    demo        run the built-in workload instrumented; write + validate a
                metrics series (exit 1 if the series is empty or missing
                step/collective metrics)
    summarize   read a series back; print steps/s, step-time percentiles,
                per-collective counts; --require step,collective turns
                missing families into a nonzero exit
    diff        compare two series' summaries; gate steps/s regression
                with --max-regress-pct
    bench       measure telemetry overhead (off vs. on over --rounds
                alternations) on the demo workload; the JSON report goes
                to stdout, and to a file only where --out says

The demo workload is the reference resilience demo's synthetic-MNIST CNN
(:func:`demo_dataset`, the port's copy of the reference's
``resilience/entrypoints.py`` function) so chaos and observe exercises
stay comparable.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import tempfile
from typing import Optional

#: Schema tag of the bench report.
BENCH_SCHEMA = "tpu_dist.bench_observe/v1"

#: Metric families --require understands: family -> predicate over the
#: final snapshot's counters.
_FAMILIES = ("step", "collective")


def _final_snapshot(records: list[dict]) -> Optional[dict]:
    """The series' authoritative snapshot: the last ``kind="final"`` record
    if one exists (snapshots are cumulative), else the last record."""
    if not records:
        return None
    for rec in reversed(records):
        if rec.get("kind") == "final":
            return rec.get("metrics")
    return records[-1].get("metrics")


def _family_present(snapshot: dict, family: str) -> bool:
    counters = snapshot.get("counters", {})
    if family == "step":
        return counters.get("step.count", 0) > 0
    if family == "collective":
        return any(name.startswith("collective.") and name.endswith(".calls")
                   and value > 0 for name, value in counters.items())
    raise ValueError(
        f"unknown metric family {family!r} (known: {list(_FAMILIES)})")


def summarize_series(records: list[dict]) -> dict:
    """Reduce a JSONL series to the numbers a regression check compares."""
    snapshot = _final_snapshot(records) or {}
    counters = snapshot.get("counters", {})
    gauges = snapshot.get("gauges", {})
    dists = snapshot.get("distributions", {})
    step = dists.get("step.total_s", {})
    collectives = {
        name[len("collective."):-len(".calls")]: value
        for name, value in sorted(counters.items())
        if name.startswith("collective.") and name.endswith(".calls")}
    return {
        "records": len(records),
        "steps": counters.get("step.count", 0),
        "steps_per_s": gauges.get("epoch.steps_per_s"),
        "step_total_s": {q: step.get(q) for q in ("p50", "p95", "p99")},
        "step_phase_p50_s": {
            phase: (dists.get(f"step.{phase}_s", {}) or {}).get("p50")
            for phase in ("data_wait", "dispatch", "device_block")},
        "collective_calls": collectives,
        "straggler_flags": counters.get("straggler.flags", 0),
    }


def _check_required(snapshot: Optional[dict], families: list[str]) -> list[str]:
    """Names of required families that are missing/empty (snapshot None =
    all missing)."""
    if snapshot is None:
        return list(families)
    return [f for f in families if not _family_present(snapshot, f)]


def _parse_require(spec: Optional[str]) -> list[str]:
    if not spec:
        return []
    families = [f.strip() for f in spec.split(",") if f.strip()]
    for f in families:
        if f not in _FAMILIES:
            raise SystemExit(
                f"error: unknown --require family {f!r} "
                f"(known: {','.join(_FAMILIES)})")
    return families


# -- demo workload ------------------------------------------------------------

def demo_dataset(*, n: int, batch: int, seed: int = 0):
    """Synthetic MNIST-shaped data, identical in every process and attempt
    (the reference's ``resilience/entrypoints.py`` ``demo_dataset``)."""
    import numpy as np

    from tpu_dist_torch.data.pipeline import Dataset

    rng = np.random.RandomState(seed)
    x = rng.rand(n, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, size=(n,)).astype(np.int32)
    return Dataset.from_tensor_slices((x, y)).batch(batch)


def _run_demo(observe_dir: Optional[pathlib.Path], *, epochs: int,
              steps_per_epoch: int, batch: int, telemetry: bool,
              model=None, device=None):
    """One in-process instrumented demo run; returns (history, model).

    ``model=None`` builds a fresh CNN on ``device``; passing the previous
    run's model back in reuses its programs (the bench uses this so the
    off/on comparison measures telemetry, not warm-up).
    """
    from tpu_dist_torch.models.cnn import build_and_compile_cnn_model
    from tpu_dist_torch.observe.telemetry import Telemetry

    ds = demo_dataset(n=batch * steps_per_epoch, batch=batch)
    if model is None:
        model = build_and_compile_cnn_model(learning_rate=0.01,
                                            device=device)
    callbacks = []
    if telemetry:
        callbacks.append(Telemetry(
            jsonl_path=observe_dir / "metrics.jsonl" if observe_dir else None,
            prometheus_path=(observe_dir / "metrics.prom"
                             if observe_dir else None)))
    history = model.fit(ds, epochs=epochs, steps_per_epoch=steps_per_epoch,
                        verbose=0, callbacks=callbacks)
    return history, model


def _timed_epochs(history) -> list:
    """A run's epoch times but epoch 0's, which carries the warm-up."""
    return [float(t) for t in history.history.get("epoch_time", [])[1:]]


def _add_demo_knobs(p: argparse.ArgumentParser, *, epochs: int,
                    steps: int, batch: int) -> None:
    p.add_argument("--epochs", type=int, default=epochs)
    p.add_argument("--steps-per-epoch", type=int, default=steps)
    p.add_argument("--batch", type=int, default=batch)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "plain PyTorch path)")


# -- subcommands --------------------------------------------------------------

def cmd_demo(args) -> int:
    out_dir = pathlib.Path(args.out or tempfile.mkdtemp(
        prefix="tpu-dist-observe-"))
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"observe demo: writing to {out_dir}", file=sys.stderr)
    _run_demo(out_dir, epochs=args.epochs,
              steps_per_epoch=args.steps_per_epoch, batch=args.batch,
              telemetry=True, device=args.device)

    from tpu_dist_torch.observe.exporters import read_series

    records = read_series(out_dir / "metrics.jsonl")
    summary = summarize_series(records)
    missing = _check_required(_final_snapshot(records),
                              list(_FAMILIES))  # demo always requires both
    payload = {"metrics_path": str(out_dir / "metrics.jsonl"),
               "prometheus_path": str(out_dir / "metrics.prom"),
               "summary": summary, "missing": missing,
               "ok": not records == [] and not missing}
    print(json.dumps(payload, indent=2))
    if not records:
        print("error: demo produced an EMPTY metrics series — vacuous run",
              file=sys.stderr)
        return 1
    if missing:
        print(f"error: demo series is missing metric families: {missing}",
              file=sys.stderr)
        return 1
    return 0


def cmd_summarize(args) -> int:
    from tpu_dist_torch.observe.exporters import read_series

    try:
        records = read_series(args.series)
    except FileNotFoundError:
        print(f"error: no series at {args.series}", file=sys.stderr)
        return 1
    summary = summarize_series(records)
    required = _parse_require(args.require)
    missing = _check_required(_final_snapshot(records), required)
    if args.json:
        print(json.dumps({"summary": summary, "missing": missing,
                          "ok": not missing and bool(records)}, indent=2))
    else:
        print(f"records:          {summary['records']}")
        print(f"steps:            {summary['steps']}")
        sps = summary["steps_per_s"]
        print(f"steps/s (epoch):  "
              f"{sps:.3f}" if sps is not None else "steps/s (epoch):  n/a")
        st = summary["step_total_s"]
        if st.get("p50") is not None:
            print("step time p50/p95/p99: "
                  + " / ".join(f"{st[q] * 1e3:.2f}ms"
                               for q in ("p50", "p95", "p99")))
        for op, calls in summary["collective_calls"].items():
            print(f"collective {op}: {calls} calls")
        if summary["straggler_flags"]:
            print(f"straggler flags:  {summary['straggler_flags']}")
    if not records:
        print("error: series is empty", file=sys.stderr)
        return 1
    if missing:
        print(f"error: required metric families missing: {missing}",
              file=sys.stderr)
        return 1
    return 0


def cmd_diff(args) -> int:
    from tpu_dist_torch.observe.exporters import read_series

    base = summarize_series(read_series(args.baseline))
    curr = summarize_series(read_series(args.current))
    result = {"baseline": base, "current": curr}
    regressions = []
    if base["steps_per_s"] and curr["steps_per_s"]:
        delta_pct = 100.0 * (1.0 - curr["steps_per_s"] / base["steps_per_s"])
        result["steps_per_s_regress_pct"] = round(delta_pct, 3)
        if delta_pct > args.max_regress_pct:
            regressions.append(
                f"steps/s regressed {delta_pct:.1f}% "
                f"(limit {args.max_regress_pct}%)")
    for q in ("p50", "p95"):
        b, c = base["step_total_s"].get(q), curr["step_total_s"].get(q)
        if b and c:
            result[f"step_{q}_delta_pct"] = round(100.0 * (c / b - 1.0), 3)
    result["regressions"] = regressions
    result["ok"] = not regressions
    print(json.dumps(result, indent=2))
    return 0 if not regressions else 1


def cmd_bench(args) -> int:
    workdir = pathlib.Path(args.workdir or tempfile.mkdtemp(
        prefix="tpu-dist-observe-bench-"))
    workdir.mkdir(parents=True, exist_ok=True)
    knobs = dict(epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
                 batch=args.batch)
    # A warm-up run, then rounds of one on and one off run on ONE model
    # (shared programs), so the two sides interleave and the host's drift
    # over the bench falls on both; the side that goes first alternates
    # (on, off, off, on, ...), so neither always runs right after the
    # other's exports and teardown. A run's rate is its fastest epoch but
    # epoch 0 (which carries the warm-up); a side's rate is the mean over
    # its runs. At 4 x 4 a host-bound step of ~2 ms makes an epoch ~8 ms, and
    # runs of the same code differ by ~12 % on one host: one run a side
    # (the reference's off / on / off) decides on noise, and the mean of
    # many shrinks it by their square root. The on runs are Telemetry as
    # a user runs it: a blocking wait on each execution's end, the series
    # written at each epoch's end and at the fit's.
    on_dir = workdir / "on"
    print("bench: warm-up (telemetry off)...", file=sys.stderr)
    _, model = _run_demo(None, telemetry=False, device=args.device, **knobs)
    rates = {"on": [], "off": []}
    for r in range(args.rounds):
        order = ("on", "off") if r % 2 == 0 else ("off", "on")
        print(f"bench: round {r + 1}: telemetry {order[0]}, then "
              f"{order[1]}...", file=sys.stderr)
        for side in order:
            hist, model = _run_demo(on_dir if side == "on" else None,
                                    telemetry=side == "on", model=model,
                                    **knobs)
            times = _timed_epochs(hist)
            if not times:
                print("error: bench runs produced no timeable epochs "
                      "(need epochs >= 2)", file=sys.stderr)
                return 1
            rates[side].append(args.steps_per_epoch / min(times))
    on, off = (statistics.fmean(rates[k]) for k in ("on", "off"))
    overhead_pct = 100.0 * (1.0 - on / off)
    report = {
        "schema": BENCH_SCHEMA,
        "workload": {"model": "demo_cnn", **knobs},
        "rounds": args.rounds,
        "telemetry_off_steps_per_s": round(off, 3),
        "telemetry_on_steps_per_s": round(on, 3),
        "overhead_pct": round(overhead_pct, 3),
        "max_overhead_pct": args.max_overhead_pct,
        "metrics_path": str(on_dir / "metrics.jsonl"),
        "ok": overhead_pct < args.max_overhead_pct,
    }
    out = json.dumps(report, indent=2)
    print(out)
    if args.out:
        pathlib.Path(args.out).write_text(out + "\n")
    if not report["ok"]:
        print(f"error: telemetry overhead {overhead_pct:.2f}% exceeds "
              f"{args.max_overhead_pct}%", file=sys.stderr)
        return 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.observe",
        description="Observability runner: instrumented demo run, series "
                    "summarize/diff, telemetry-overhead benchmark.")
    sub = p.add_subparsers(dest="command", required=True)

    demo = sub.add_parser("demo", help="instrumented demo run + validation")
    _add_demo_knobs(demo, epochs=3, steps=4, batch=32)
    demo.add_argument("--out", default=None,
                      help="directory for metrics.jsonl/metrics.prom "
                           "(default: fresh temp dir)")
    demo.set_defaults(fn=cmd_demo)

    summ = sub.add_parser("summarize", help="summarize a metrics series")
    summ.add_argument("series", help="path to a metrics.jsonl series")
    summ.add_argument("--require", default=None, metavar="FAMILIES",
                      help="comma list of families that must be non-empty "
                           f"({','.join(_FAMILIES)}); missing = exit 1")
    summ.add_argument("--json", action="store_true")
    summ.set_defaults(fn=cmd_summarize)

    diff = sub.add_parser("diff", help="compare two series (regression gate)")
    diff.add_argument("baseline")
    diff.add_argument("current")
    diff.add_argument("--max-regress-pct", type=float, default=10.0,
                      help="max allowed steps/s regression (default 10)")
    diff.set_defaults(fn=cmd_diff)

    bench = sub.add_parser(
        "bench", help="measure telemetry overhead (interleaved on/off runs)")
    _add_demo_knobs(bench, epochs=4, steps=4, batch=256)
    bench.add_argument("--workdir", default=None)
    bench.add_argument("--out", default=None,
                       help="also write the JSON report to this path")
    bench.add_argument("--max-overhead-pct", type=float, default=5.0)
    bench.add_argument("--rounds", type=int, default=400,
                       help="on/off pairs after a warm-up run, the side "
                            "that goes first alternating; each side scores "
                            "the mean of its runs' fastest epochs")
    bench.set_defaults(fn=cmd_bench)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
