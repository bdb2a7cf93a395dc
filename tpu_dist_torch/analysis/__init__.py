"""tpu_dist_torch.analysis — "shardcheck" for the PyTorch port.

Counterpart of ``tpu_dist/analysis/``: the same rule catalogue, CLI modes
and baseline gate, checking the port's own code. A distributed PyTorch
program's mistakes — a collective one rank skips, an axis name no mesh
declares, a collective launched from a helper thread, a seed read off the
wall clock — run fine on one process and deadlock or diverge across
ranks; this subsystem catches them before a card is spent:

* :mod:`~tpu_dist_torch.analysis.ast_lint` — source-level rules
  SC101-SC105 (unknown axis name, placement/rank mismatch, host side
  effects under a CUDA-graph capture, a captured program's output read
  after its next replay, swallowed liveness errors);
* :mod:`~tpu_dist_torch.analysis.trace_checks` — the counterpart of the
  reference's jaxpr checks: a ``TorchDispatchMode`` recorder of every
  ``c10d`` launch and random ``aten`` op, run per rank on a fake process
  group over 28 registered entry points (the reference's, name for
  name): SC201 (ranks' collective sequences differ), SC202 (a sequence's
  length follows the data), SC203 (payloads or send/recv pairs that do
  not line up);
* :mod:`~tpu_dist_torch.analysis.costmodel` /
  :mod:`~tpu_dist_torch.analysis.baseline` — the communication and
  peak-live-bytes model over the same recordings, and the committed
  baseline behind SC301/SC302/SC610
  (``tpu_dist_torch/analysis/ANALYSIS_BASELINE.json``);
* :mod:`~tpu_dist_torch.analysis.concurrency` /
  :mod:`~tpu_dist_torch.analysis.liveness` — ``--concurrency``:
  SC401-SC404 and SC501-SC503 over the host call graph, with
  ``torch.distributed``'s collectives and the port's wrappers as
  rendezvous and CUDA launches as dispatch;
* :mod:`~tpu_dist_torch.analysis.determinism` — ``--determinism``:
  SC601-SC605 over torch's generators and the stdlib/numpy sources;
* :mod:`~tpu_dist_torch.analysis.rules` /
  :mod:`~tpu_dist_torch.analysis.report` — the catalogue (SC104 is the
  captured-output rule; SC303 is kept only as a decision: PyTorch has no
  buffer donation), suppressions and their SC901 policing, output
  formats, exit codes;
* :mod:`~tpu_dist_torch.analysis.cli` — ``python -m
  tpu_dist_torch.analysis [paths]``, ``--concurrency``,
  ``--determinism`` and ``cost``.

The reference's ``check_jaxpr`` and ``analyze_jaxpr`` name an object
PyTorch lacks; :func:`check_trace` and :func:`analyze_trace` take their
place.
"""

from tpu_dist_torch.analysis.ast_lint import lint_file, lint_paths
from tpu_dist_torch.analysis.baseline import (
    DEFAULT_TOLERANCE_PCT,
    build as build_baseline,
    compare as compare_baseline,
    load as load_baseline,
)
from tpu_dist_torch.analysis.cli import cost_main, main
from tpu_dist_torch.analysis.costmodel import (
    CollectiveCost,
    CostReport,
    analyze_trace,
    comm_bytes,
    parse_mesh,
    peak_live_bytes,
)
from tpu_dist_torch.analysis.report import exit_code, to_json_dict
from tpu_dist_torch.analysis.rules import RULES, Finding, Rule, Severity
from tpu_dist_torch.analysis.trace_checks import (
    CollectiveRecorder,
    check_branch_collectives,
    check_callable,
    check_trace,
    check_while_collectives,
    collective_sequence,
    record,
    run_entry_points,
)

__all__ = [
    "RULES", "Finding", "Rule", "Severity",
    "lint_file", "lint_paths",
    "check_branch_collectives", "check_callable", "check_trace",
    "check_while_collectives", "collective_sequence",
    "run_entry_points", "CollectiveRecorder", "record",
    "CollectiveCost", "CostReport", "analyze_trace", "comm_bytes",
    "parse_mesh", "peak_live_bytes",
    "DEFAULT_TOLERANCE_PCT", "build_baseline", "compare_baseline",
    "load_baseline",
    "exit_code", "to_json_dict",
    "main", "cost_main",
]
