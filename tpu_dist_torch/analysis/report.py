"""shardcheck report layer: text/JSON rendering and exit-code policy.

Counterpart of ``tpu_dist/analysis/report.py``; ``--list-rules`` also
names the rules the port keeps only as decisions."""

from __future__ import annotations

import json
import sys
from typing import Iterable

from tpu_dist_torch.analysis.rules import RULES, Finding, Severity


def sort_findings(findings: Iterable[Finding]) -> list[Finding]:
    """Stable display order: by path, then line, then rule id."""
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule_id))


def counts_by_severity(findings: Iterable[Finding]) -> dict:
    counts = {str(s): 0 for s in Severity}
    for f in findings:
        counts[str(f.severity)] += 1
    return counts


def exit_code(findings: Iterable[Finding], *,
              fail_on: str = "error") -> int:
    """1 when any finding reaches the failure threshold, else 0.

    ``fail_on="never"`` always exits 0 (report-only mode).
    """
    if fail_on == "never":
        return 0
    threshold = Severity.parse(fail_on)
    return int(any(f.severity >= threshold for f in findings))


def to_json_dict(findings: Iterable[Finding], *, paths=(),
                 fail_on: str = "error") -> dict:
    findings = sort_findings(findings)
    return {
        "tool": "shardcheck",
        "checked_paths": list(paths),
        "counts": counts_by_severity(findings),
        "findings": [f.to_json() for f in findings],
        "exit_code": exit_code(findings, fail_on=fail_on),
    }


def render_text(findings: Iterable[Finding], *, paths=(),
                stream=None) -> None:
    stream = stream or sys.stdout
    findings = sort_findings(findings)
    for f in findings:
        print(f.render(), file=stream)
    counts = counts_by_severity(findings)
    total = sum(counts.values())
    if total:
        print(f"shardcheck: {counts['error']} error(s), "
              f"{counts['warning']} warning(s), {counts['info']} info "
              f"across {len(list(paths)) or 'the given'} path(s)",
              file=stream)
    else:
        print("shardcheck: no findings", file=stream)


#: GitHub workflow-command levels by severity. There is no ::info; the
#: annotation vocabulary is error/warning/notice.
_GITHUB_LEVEL = {
    Severity.ERROR: "error",
    Severity.WARNING: "warning",
    Severity.INFO: "notice",
}


def _github_escape(text: str) -> str:
    """Workflow-command data escaping for the message position: %, CR
    and LF per the spec. A literal ``::`` in the message (SC4xx messages
    quote lock names and call chains) needs no escaping — the runner
    splits on the first two ``::`` delimiters only, and it would render
    any %-encoding we added verbatim."""
    return (text.replace("%", "%25")
            .replace("\r", "%0D")
            .replace("\n", "%0A"))


def _github_escape_property(text: str) -> str:
    """Property-position escaping (file=...): the parser additionally
    treats ``:`` and ``,`` as structure there."""
    return (_github_escape(text)
            .replace(":", "%3A")
            .replace(",", "%2C"))


def render_github(findings: Iterable[Finding], *, stream=None) -> None:
    """Findings as GitHub workflow annotations
    (``::error file=...,line=...,col=...::[SCnnn] message``)."""
    stream = stream or sys.stdout
    for f in sort_findings(findings):
        level = _GITHUB_LEVEL[f.severity]
        message = _github_escape(f"[{f.rule_id}] {f.message}")
        path = _github_escape_property(f.path)
        print(f"::{level} file={path},line={f.line},col={f.col}::"
              f"{message}", file=stream)


def _human_bytes(n: int) -> str:
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if value < 1024 or unit == "GiB":
            return (f"{int(value)} {unit}" if unit == "B"
                    else f"{value:.1f} {unit}")
        value /= 1024
    return f"{n} B"  # pragma: no cover - unreachable


def _human_time(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.1f} us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f} ms"
    return f"{seconds:.3f} s"


def render_cost_text(reports, findings: Iterable[Finding] = (), *,
                     mesh=None, stream=None) -> None:
    """Human-readable cost report: one block per entry point (totals,
    modeled step latency with the non-overlappable comm tail, plus every
    collective launch site), then any baseline findings."""
    stream = stream or sys.stdout
    if mesh:
        print("modeled mesh: "
              + ",".join(f"{k}={v}" for k, v in sorted(mesh.items())),
              file=stream)
    for name in sorted(reports):
        r = reports[name]
        print(f"{name}: comm {r.total_comm_bytes} B "
              f"({_human_bytes(r.total_comm_bytes)}), peak live "
              f"{r.peak_hbm_bytes} B ({_human_bytes(r.peak_hbm_bytes)}), "
              f"{len(r.collectives)} collective launch site(s)",
              file=stream)
        lat = getattr(r, "latency", None)
        if lat is not None:
            print(f"  est step latency {_human_time(lat.step_latency_s)} "
                  f"= compute {_human_time(lat.compute_s)} + comm tail "
                  f"{_human_time(lat.comm_tail_s)} "
                  f"(comm {_human_time(lat.comm_s)}, overlapped "
                  f"{_human_time(lat.overlapped_s)}, {lat.launches} "
                  f"launch(es))", file=stream)
        for c in r.collectives:
            axes = ",".join(c.axes) or "?"
            mult = f" x{c.multiplier}" if c.multiplier != 1 else ""
            print(f"  {c.op}[{axes}|{c.axis_size}] "
                  f"{c.dtype}{list(c.shape)} = {c.payload_bytes} B"
                  f"{mult} -> {c.bytes} B", file=stream)
    findings = sort_findings(findings)
    for f in findings:
        print(f.render(), file=stream)
    if not findings:
        print("shardcheck cost: no findings", file=stream)


def to_cost_json(reports, findings: Iterable[Finding] = (), *,
                 mesh=None, baseline_path=None,
                 fail_on: str = "error") -> dict:
    findings = sort_findings(findings)
    return {
        "tool": "shardcheck-cost",
        "mesh": dict(mesh or {}),
        "baseline": baseline_path,
        "entries": {name: reports[name].to_json()
                    for name in sorted(reports)},
        "counts": counts_by_severity(findings),
        "findings": [f.to_json() for f in findings],
        "exit_code": exit_code(findings, fail_on=fail_on),
    }


def render_rules(stream=None) -> None:
    """The advertised catalogue, for ``--list-rules``."""
    stream = stream or sys.stdout
    for rule in sorted(RULES.values(), key=lambda r: r.id):
        print(f"{rule.id} [{rule.severity}] {rule.name}\n"
              f"    {rule.description}", file=stream)
        if rule.decision:
            print(f"    not ported, by decision: {rule.decision}",
                  file=stream)


def dump_json(payload: dict, stream=None) -> None:
    json.dump(payload, stream or sys.stdout, indent=2, sort_keys=False)
    print(file=stream or sys.stdout)
