"""shardcheck CLI: ``python -m tpu_dist_torch.analysis [cost] [paths]``.

Counterpart of ``tpu_dist/analysis/cli.py``. The default (check) mode
runs two passes over the given paths (default: the installed
``tpu_dist_torch`` package):

1. the AST lint (ast_lint.py) over every ``.py`` file — no imports, no
   device;
2. unless ``--no-trace``: the recorded checks (trace_checks.py) — the
   built-in entry points (trainer steps, both pipeline schedules, the
   TP/SP/MoE parallel steps, the serve, integrity, jobs and PS steps)
   recorded on the CPU on fake process groups, plus any analyzed module
   that defines a ``shardcheck_entry()`` returning ``(fn, example_args)``
   or ``(fn, example_args, world)``.

Exit code 1 when any finding reaches ``--fail-on`` severity (default:
error; ``--strict`` lowers it to warning), 0 otherwise. ``--format
github`` renders findings as workflow annotations
(``::error file=…,line=…::``).

``--concurrency`` (SC4xx/SC5xx) and ``--determinism`` (SC6xx) each swap
in a pure-AST interprocedural pass over a shared call-graph Project —
no imports, no backend. ``--rules SC601,SC603`` narrows any mode to the
listed rules (SC900/SC901 always ride along); ``--list-rules`` prints
the catalogue.

``cost`` mode prices the same recordings instead of rule-checking them:
per entry point, modeled communication volume and peak live tensor bytes
(costmodel.py), optionally diffed against a committed baseline
(baseline.py) — ``--baseline`` to gate, ``--update-baseline`` to commit
intended growth, ``--mesh data=8,model=4`` to model a topology other
than the recorded one. The reference's ``--calibrate`` (a timed psum
sweep on the host's devices) has no counterpart: a link file in its
format is read with ``--links``.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import os
import sys
from typing import Optional

from tpu_dist_torch.analysis import ast_lint, report
from tpu_dist_torch.analysis.rules import (
    RULES,
    Finding,
    apply_suppressions,
    stale_suppressions,
)

#: The port's committed baseline, beside this module.
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "ANALYSIS_BASELINE.json")

#: Which rules each mode evaluates — the SC901 staleness scope. SC2xx/
#: SC3xx are excluded on purpose: whether a recorded/baseline finding
#: exists depends on the environment, so their suppressions cannot be
#: proven stale from a single run.
_AST_RULE_IDS = frozenset({"SC101", "SC102", "SC103", "SC104", "SC105"})
_CONCURRENCY_RULE_IDS = frozenset({
    "SC401", "SC402", "SC403", "SC404", "SC501", "SC502", "SC503"})
_DETERMINISM_RULE_IDS = frozenset({
    "SC601", "SC602", "SC603", "SC604", "SC605"})


def _add_rules_arg(parser) -> None:
    parser.add_argument(
        "--rules", default=None, metavar="SCnnn[,SCnnn...]",
        help="run only these rule IDs (e.g. --rules SC601,SC603); "
             "SC900 degradation and SC901 staleness reporting always "
             "stay on")


def _parse_rules(parser, spec: Optional[str]) -> Optional[frozenset]:
    """Validated ``--rules`` selection, or None for 'all rules'."""
    if spec is None:
        return None
    selected = {part.strip() for part in spec.split(",") if part.strip()}
    unknown = sorted(r for r in selected if r not in RULES)
    if unknown:
        parser.error(f"unknown rule ID(s): {', '.join(unknown)}; "
                     f"see --list-rules")
    if not selected:
        parser.error("--rules given but no rule IDs parsed")
    return frozenset(selected)


def _filter_rules(findings, selected: Optional[frozenset]) -> list:
    """Keep only selected rules. SC900 (degradation) and SC901 (stale
    suppressions) are never filtered out: a narrowed run must still be
    honest about what it could not analyze."""
    if selected is None:
        return list(findings)
    keep = set(selected) | {"SC900", "SC901"}
    return [f for f in findings if f.rule_id in keep]


def _has_shardcheck_entry(path: str) -> bool:
    """Cheap AST probe so only opted-in modules get imported."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return False
    return any(isinstance(node, (ast.FunctionDef,))
               and node.name == "shardcheck_entry"
               for node in tree.body)


def _load_module_entry(path: str):
    """Import ``path`` and normalize its ``shardcheck_entry()`` to
    :class:`~tpu_dist_torch.analysis.trace_checks.EntryPoint` — the
    optional third element is the number of fake ranks to run it on."""
    from tpu_dist_torch.analysis.trace_checks import EntryPoint

    name = "_shardcheck_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    entry = tuple(module.shardcheck_entry())
    fn, args = entry[:2]
    world = int(entry[2]) if len(entry) == 3 else 1
    return EntryPoint(lambda rank, seed: (lambda: fn(*args)), world)


def _check_module_entry(path: str) -> list[Finding]:
    """Import ``path`` and run the recorded checks on its
    shardcheck_entry()."""
    from tpu_dist_torch.analysis import trace_checks

    try:
        entry = _load_module_entry(path)
        return trace_checks.check_trace(
            trace_checks.run_entry(entry),
            label=f"{path}::shardcheck_entry", path=path)
    except Exception as e:  # noqa: BLE001 - degrade, never crash the run
        return [Finding(
            "SC900", path, 1, 0,
            f"shardcheck_entry() could not be recorded "
            f"({trace_checks._cause(e)})")]


def _default_paths() -> list[str]:
    """The installed package itself — the dogfood target."""
    import tpu_dist_torch

    return [os.path.dirname(os.path.abspath(tpu_dist_torch.__file__))]


def _render(findings, *, fmt: str, paths=(), fail_on: str) -> None:
    if fmt == "json":
        report.dump_json(report.to_json_dict(
            findings, paths=paths, fail_on=fail_on))
    elif fmt == "github":
        report.render_github(findings)
    else:
        report.render_text(findings, paths=paths)


def _project_mode_check(paths, checkers, mode_rule_ids,
                        selected: Optional[frozenset]) -> list[Finding]:
    """Shared driver for the project-graph modes (--concurrency,
    --determinism): build the call graph once, run the mode's checkers,
    apply suppressions, then SC901 staleness scoped to the rules this
    run actually evaluated (mode ∩ --rules selection — a suppression for
    a deselected rule cannot be proven stale by a run that never looked
    for its finding)."""
    from tpu_dist_torch.analysis import concurrency

    project = concurrency.build_project(paths)
    raw: list[Finding] = []
    for check in checkers:
        raw.extend(check(project))
    raw = _filter_rules(raw, selected)
    source_by_path = {m.path: m.source_lines
                      for m in project.modules.values()}
    evaluated = (mode_rule_ids if selected is None
                 else mode_rule_ids & selected)
    findings = apply_suppressions(raw, source_by_path)
    findings.extend(apply_suppressions(
        stale_suppressions(raw, source_by_path, evaluated),
        source_by_path))
    return findings


def _concurrency_check(paths,
                       selected: Optional[frozenset] = None
                       ) -> list[Finding]:
    """``--concurrency`` mode: SC4xx thread-safety + SC5xx liveness over
    the interprocedural host call graph. Pure AST — no imports, no
    backend."""
    from tpu_dist_torch.analysis import concurrency, liveness

    return _project_mode_check(
        paths, [concurrency.check_project, liveness.check_project],
        _CONCURRENCY_RULE_IDS, selected)


def _determinism_check(paths,
                       selected: Optional[frozenset] = None
                       ) -> list[Finding]:
    """``--determinism`` mode: SC6xx determinism/RNG-lineage rules over
    the same host call graph. Pure AST — the recorded half of the family
    (SC610) rides the `cost` subcommand, which already records."""
    from tpu_dist_torch.analysis import determinism

    return _project_mode_check(
        paths, [determinism.check_project],
        _DETERMINISM_RULE_IDS, selected)


def main(argv: Optional[list] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "cost":
        return cost_main(argv[1:])

    parser = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.analysis",
        description="shardcheck: collective consistency checks for "
                    "tpu_dist_torch programs (see also the `cost` "
                    "subcommand for the communication/memory cost model)")
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to check (default: the "
             "tpu_dist_torch package)")
    parser.add_argument(
        "--json", action="store_true",
        help="machine-readable JSON on stdout instead of text "
             "(alias for --format json)")
    parser.add_argument(
        "--format", default=None, choices=("text", "json", "github"),
        help="output format; `github` emits ::error/::warning workflow "
             "annotations (default: text)")
    parser.add_argument(
        "--no-trace", action="store_true",
        help="skip the recorded checks (AST lint only; no entry point "
             "runs)")
    parser.add_argument(
        "--concurrency", action="store_true",
        help="run the host-runtime concurrency/liveness analyzer "
             "(SC4xx/SC5xx + SC901) instead of the sharding lint; pure "
             "AST, no backend")
    parser.add_argument(
        "--determinism", action="store_true",
        help="run the determinism/RNG-lineage analyzer (SC6xx + SC901) "
             "instead of the sharding lint; pure AST, no backend (the "
             "SC610 recorded companion runs under the `cost` subcommand)")
    _add_rules_arg(parser)
    parser.add_argument(
        "--fail-on", default="error",
        choices=("error", "warning", "info", "never"),
        help="lowest severity that makes the exit code non-zero "
             "(default: error)")
    parser.add_argument(
        "--strict", action="store_true",
        help="fail on warnings too (shorthand for --fail-on warning)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        report.render_rules()
        return 0

    fmt = args.format or ("json" if args.json else "text")
    fail_on = "warning" if args.strict else args.fail_on
    selected = _parse_rules(parser, args.rules)

    paths = args.paths or _default_paths()
    for p in paths:
        if not os.path.exists(p):
            parser.error(f"no such path: {p}")

    if args.concurrency and args.determinism:
        parser.error("--concurrency and --determinism are separate "
                     "modes; run them as two invocations")
    if args.concurrency:
        findings = _concurrency_check(paths, selected)
        _render(findings, fmt=fmt, paths=paths, fail_on=fail_on)
        return report.exit_code(findings, fail_on=fail_on)
    if args.determinism:
        findings = _determinism_check(paths, selected)
        _render(findings, fmt=fmt, paths=paths, fail_on=fail_on)
        return report.exit_code(findings, fail_on=fail_on)

    raw, source_by_path = ast_lint.lint_paths_raw(paths)
    raw = _filter_rules(raw, selected)
    evaluated = (_AST_RULE_IDS if selected is None
                 else _AST_RULE_IDS & selected)
    findings = apply_suppressions(raw, source_by_path)
    findings.extend(apply_suppressions(
        stale_suppressions(raw, source_by_path, evaluated),
        source_by_path))

    if not args.no_trace:
        from tpu_dist_torch.analysis import trace_checks

        files = ast_lint.iter_python_files(paths)
        # Built-in entry points run when the package under check is (or
        # contains) tpu_dist_torch itself — the dogfooded self-check.
        if any(os.sep + "tpu_dist_torch" + os.sep
               in os.path.abspath(f) + os.sep
               or os.path.basename(f) == "trainer.py" for f in files):
            findings.extend(_filter_rules(
                trace_checks.run_entry_points(), selected))
        trace_findings = []
        for f in files:
            if _has_shardcheck_entry(f):
                trace_findings.extend(_check_module_entry(f))
        trace_findings = _filter_rules(trace_findings, selected)
        source_by_path = {}
        for f in {t.path for t in trace_findings if os.path.exists(t.path)}:
            with open(f, "r", encoding="utf-8") as fh:
                source_by_path[f] = fh.read().splitlines()
        findings.extend(apply_suppressions(trace_findings, source_by_path))

    _render(findings, fmt=fmt, paths=paths, fail_on=fail_on)
    return report.exit_code(findings, fail_on=fail_on)


def cost_main(argv: Optional[list] = None) -> int:
    """``python -m tpu_dist_torch.analysis cost`` — the cost model +
    baseline gate. See the module docstring for semantics; the mesh precedence is
    ``--mesh`` > the baseline's committed mesh > the traced meshes
    unmodified, so a bare ``cost --baseline ...`` (the check.sh stage)
    reprices exactly the topology the baseline was committed at."""
    from tpu_dist_torch.analysis import baseline as baseline_lib
    from tpu_dist_torch.analysis import costmodel

    parser = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.analysis cost",
        description="shardcheck cost model: static per-entry-point "
                    "communication volume and peak live-buffer estimate, "
                    "with an optional committed-baseline CI gate")
    parser.add_argument(
        "paths", nargs="*",
        help="additional modules with a shardcheck_entry() to price "
             "alongside the built-in entry points")
    parser.add_argument(
        "--mesh", default=None,
        metavar="AXIS=N[:BW_GBPS[:LAT_US]][,...]",
        help="model the ring costs at these axis sizes (e.g. "
             "data=8,model=4) instead of the traced mesh sizes; an "
             "optional per-axis link suffix (e.g. data=8:90:1.5 for "
             "90 GB/s links with 1.5 us launch latency) feeds the step "
             "latency estimate")
    parser.add_argument(
        "--entries", default=None, metavar="NAME[,NAME...]",
        help="restrict to these built-in entry points (default: all)")
    parser.add_argument(
        "--links", default=None, metavar="@PATH",
        help="price with a link file in the reference's calibration "
             "format (per-axis links + flops rate); explicit --mesh link "
             "suffixes still win for their axes")
    parser.add_argument(
        "--baseline", default=None, metavar="PATH",
        help="diff against this committed baseline; comm growth past the "
             "tolerance is an SC301 error, peak live bytes past budget an "
             "SC302 warning")
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="write the measured costs to --baseline (default "
             "tpu_dist_torch/analysis/ANALYSIS_BASELINE.json) instead of "
             "diffing, carrying over still-valid memory budgets")
    parser.add_argument(
        "--tolerance", type=float, default=None, metavar="PCT",
        help="comm-growth tolerance in percent (default: the baseline's "
             f"committed value, else {baseline_lib.DEFAULT_TOLERANCE_PCT:g})")
    parser.add_argument(
        "--json", action="store_true",
        help="machine-readable JSON on stdout instead of text "
             "(alias for --format json)")
    parser.add_argument(
        "--format", default=None, choices=("text", "json", "github"),
        help="output format (github: workflow annotations for findings)")
    parser.add_argument(
        "--strict", action="store_true",
        help="fail on warnings (SC302) too, not just SC301 errors")
    _add_rules_arg(parser)
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        report.render_rules()
        return 0

    fmt = args.format or ("json" if args.json else "text")
    fail_on = "warning" if args.strict else "error"
    selected = _parse_rules(parser, args.rules)
    baseline_path = args.baseline or DEFAULT_BASELINE

    for p in args.paths:
        if not os.path.exists(p):
            parser.error(f"no such path: {p}")

    previous = None
    if os.path.exists(baseline_path) and (args.baseline
                                          or args.update_baseline):
        previous = baseline_lib.load(baseline_path)
    elif args.baseline and not args.update_baseline:
        parser.error(f"no such baseline: {args.baseline}")

    links = {}
    if args.mesh is not None:
        model_mesh, links = costmodel.parse_mesh_links(args.mesh)
    elif previous is not None and not args.update_baseline:
        model_mesh = dict(previous.get("mesh", {}))
    else:
        model_mesh = {}

    flops_per_s = None
    if args.links is not None:
        path = args.links[1:] if args.links.startswith("@") else args.links
        if not os.path.exists(path):
            parser.error(f"no such calibration file: {path}")
        file_links, flops_per_s = costmodel.load_links(path)
        # Explicit --mesh suffixes override the file per axis.
        links = {**file_links, **links}

    from tpu_dist_torch.analysis import trace_checks

    names = (set(args.entries.split(",")) if args.entries else None)
    if names:
        # ``module:<basename>`` labels select path entries; the rest must
        # name built-ins.
        unknown = {n for n in names
                   if n not in trace_checks.ENTRY_POINTS
                   and not n.startswith("module:")}
        if unknown:
            parser.error(f"unknown entry point(s): {sorted(unknown)}; "
                         f"known: {sorted(trace_checks.ENTRY_POINTS)} "
                         "plus module:<basename> labels")
    # Rank 0 of one seed prices an entry, as the reference prices one
    # device's program.
    recorded, findings = trace_checks.record_entry_points(names, seeds=(0,))
    first = {name: by_seed[0][0] for name, by_seed in recorded.items()}
    reports = {
        name: costmodel.analyze_trace(
            rec, entry=name, model_mesh=model_mesh, links=links,
            flops_per_s=flops_per_s)
        for name, rec in first.items()}
    # SC610 rides the cost pipeline: the recordings are already in hand,
    # so the random-op sets are free to record/diff here.
    rng_now = {name: trace_checks.rng_primitives(rec)
               for name, rec in first.items()}

    for p in args.paths:
        for f in ast_lint.iter_python_files([p]):
            if not _has_shardcheck_entry(f):
                continue
            label = "module:" + os.path.splitext(os.path.basename(f))[0]
            if names is not None and label not in names:
                continue
            try:
                rec = trace_checks.run_entry(
                    _load_module_entry(f), seeds=(0,))[0][0]
                reports[label] = costmodel.analyze_trace(
                    rec, entry=label, model_mesh=model_mesh, links=links,
                    flops_per_s=flops_per_s)
                rng_now[label] = trace_checks.rng_primitives(rec)
            except Exception as e:  # noqa: BLE001 - degrade, never crash
                findings.append(Finding(
                    "SC900", f, 1, 0,
                    f"shardcheck_entry() could not be recorded "
                    f"({trace_checks._cause(e)})"))

    if args.update_baseline:
        tol = (args.tolerance if args.tolerance is not None
               else (previous or {}).get(
                   "tolerance_pct", baseline_lib.DEFAULT_TOLERANCE_PCT))
        data = baseline_lib.build(
            reports, mesh=model_mesh, tolerance_pct=tol, previous=previous,
            rng=rng_now)
        baseline_lib.write(baseline_path, data)
        print(f"wrote {baseline_path}: {len(reports)} entry point(s), "
              f"mesh {model_mesh or '(as traced)'}, "
              f"tolerance {float(tol):g}%")
        for f in report.sort_findings(findings):
            print(f.render())
        return 0

    if previous is not None:
        findings.extend(baseline_lib.compare(
            reports, previous, tolerance_pct=args.tolerance,
            path=baseline_path))
        findings.extend(trace_checks.check_rng_baseline(
            rng_now, previous.get("rng", {}), baseline_path))

    findings = _filter_rules(findings, selected)
    if fmt == "json":
        report.dump_json(report.to_cost_json(
            reports, findings, mesh=model_mesh,
            baseline_path=args.baseline, fail_on=fail_on))
    elif fmt == "github":
        report.render_github(findings)
    else:
        report.render_cost_text(reports, findings, mesh=model_mesh)
    return report.exit_code(findings, fail_on=fail_on)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
