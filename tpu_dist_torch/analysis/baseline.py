"""Committed cost baseline: load/write/diff for the port's
``tpu_dist_torch/analysis/ANALYSIS_BASELINE.json``.

Counterpart of ``tpu_dist/analysis/baseline.py``. The baseline is the
port's communication/memory budget, diffed by ``python -m
tpu_dist_torch.analysis cost --baseline``: an entry point whose modeled
comm volume grows past the tolerance fails the gate (SC301), and one
whose recorded peak of live tensor bytes crosses its budget warns
(SC302). Intended growth is committed by re-running with
``--update-baseline`` and checking the diff in — the same review loop as
a golden-file test.

Schema (``tpu_dist_torch.analysis/cost-v1``)::

    {
      "schema": "tpu_dist_torch.analysis/cost-v1",
      "mesh": {"data": 8},          # modeled mesh the numbers were priced at
      "tolerance_pct": 10.0,        # default comm-growth tolerance
      "entries": {
        "<entry>": {
          "total_comm_bytes": 1234,
          "peak_hbm_bytes": 5678,
          "hbm_budget_bytes": 11356   # 2x measured peak at update time
        }
      },
      "rng": {                        # optional; SC610 determinism gate
        "<entry>": []                 # random aten ops recorded
      }
    }

The ``rng`` section is optional and lives BESIDE ``entries``: an entry
recorded as ``[]`` is contractually RNG-free and growing a random aten op
is an SC610 error
(:func:`tpu_dist_torch.analysis.trace_checks.check_rng_baseline`).
"""

from __future__ import annotations

import json
import os
from typing import Mapping

from tpu_dist_torch.analysis.rules import Finding

SCHEMA = "tpu_dist_torch.analysis/cost-v1"

#: Default comm-volume growth tolerance (percent) and the headroom factor
#: ``--update-baseline`` grants the HBM budget over the measured peak.
DEFAULT_TOLERANCE_PCT = 10.0
HBM_BUDGET_FACTOR = 2.0


def load(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: schema {data.get('schema')!r} is not {SCHEMA!r}")
    if not isinstance(data.get("entries"), dict):
        raise ValueError(f"{path}: missing 'entries' mapping")
    return data


def build(reports: Mapping, *, mesh: Mapping,
          tolerance_pct: float = DEFAULT_TOLERANCE_PCT,
          previous: dict | None = None,
          rng: Mapping | None = None) -> dict:
    """Baseline dict from ``{entry: CostReport}``. HBM budgets are carried
    over from ``previous`` when they still cover the measured peak, else
    re-granted at ``HBM_BUDGET_FACTOR`` x the new peak. ``rng`` maps
    entry -> sorted RNG primitive names (SC610); when None the previous
    baseline's section is carried forward unchanged."""
    prev_entries = (previous or {}).get("entries", {})
    entries = {}
    for name in sorted(reports):
        r = reports[name]
        prev_budget = prev_entries.get(name, {}).get("hbm_budget_bytes")
        budget = (prev_budget
                  if prev_budget is not None
                  and prev_budget >= r.peak_hbm_bytes
                  else int(r.peak_hbm_bytes * HBM_BUDGET_FACTOR))
        entries[name] = {
            "total_comm_bytes": r.total_comm_bytes,
            "peak_hbm_bytes": r.peak_hbm_bytes,
            "hbm_budget_bytes": budget,
        }
    data = {
        "schema": SCHEMA,
        "mesh": {k: int(v) for k, v in dict(mesh).items()},
        "tolerance_pct": float(tolerance_pct),
        "entries": entries,
    }
    if rng is None:
        rng = (previous or {}).get("rng")
    if rng is not None:
        data["rng"] = {name: sorted(rng[name]) for name in sorted(rng)}
    return data


def write(path: str, data: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=False)
        fh.write("\n")
    os.replace(tmp, path)


def compare(reports: Mapping, data: dict, *,
            tolerance_pct: float | None = None,
            path: str = "ANALYSIS_BASELINE.json") -> list:
    """Diff current ``{entry: CostReport}`` against a loaded baseline.

    Returns findings: SC301 (error) for comm growth past tolerance,
    SC302 (warning) for peak HBM past the entry's budget, SC900 (info)
    for entries on either side the other does not know about — those
    need an ``--update-baseline`` commit, not a failed build.
    """
    tol = (tolerance_pct if tolerance_pct is not None
           else float(data.get("tolerance_pct", DEFAULT_TOLERANCE_PCT)))
    baseline_entries = data["entries"]
    findings: list[Finding] = []
    for name in sorted(reports):
        r = reports[name]
        base = baseline_entries.get(name)
        if base is None:
            findings.append(Finding(
                "SC900", path, 1, 0,
                f"entry point {name} is not in the baseline; run "
                "`python -m tpu_dist_torch.analysis cost --update-baseline` "
                "and commit the diff"))
            continue
        allowed = base["total_comm_bytes"] * (1.0 + tol / 100.0)
        if r.total_comm_bytes > allowed:
            findings.append(Finding(
                "SC301", path, 1, 0,
                f"{name}: modeled comm volume {r.total_comm_bytes} B "
                f"exceeds baseline {base['total_comm_bytes']} B by more "
                f"than {tol:g}% (allowed {int(allowed)} B); if intended, "
                "re-run with --update-baseline and commit"))
        budget = base.get("hbm_budget_bytes")
        if budget is not None and r.peak_hbm_bytes > budget:
            findings.append(Finding(
                "SC302", path, 1, 0,
                f"{name}: peak live-buffer estimate {r.peak_hbm_bytes} B "
                f"exceeds the HBM budget {budget} B (measured baseline "
                f"peak {base['peak_hbm_bytes']} B)"))
    for name in sorted(set(baseline_entries) - set(reports)):
        findings.append(Finding(
            "SC900", path, 1, 0,
            f"baseline entry {name} was not produced by this run "
            "(entry point removed or untraceable here); re-run with "
            "--update-baseline to drop it"))
    return findings
