"""ServeSupervisor: keep a serving engine alive across crashes.

Counterpart of ``tpu_dist/serve/supervisor.py``: a serving-shaped
:class:`~tpu_dist_torch.resilience.supervisor.Supervisor` (the same
backoff, grace, exit classification, per-attempt deadline and event log):

* the gang is always ONE worker — a serve engine is a single process;
* every attempt gets ``$TPU_DIST_SERVE_JOURNAL`` pointing at the shared
  journal directory, so attempt N+1 *recovers* attempt N's queued and
  in-flight requests (``serve/journal.py``) instead of starting empty;
* ``no_restart_exits`` is EMPTY: :data:`~tpu_dist_torch.resilience.faults.
  EXIT_SERVE_ABORT` — a wedged decode caught by the stall watchdog — is
  exactly the failure a fresh process cures, so every nonzero exit
  restarts within the budget;
* the restart count lands on the ``serve.engine.restarts`` counter, and
  the final journal is the record of what was served
  (:meth:`ServeSupervisor.journal_state`).

The worker argv is typically ``python -m tpu_dist_torch.serve --worker
...``; its last ``RESULT:{...}`` stdout line is read back with
:meth:`ServeSupervisor.final_result`.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Sequence

from tpu_dist_torch.observe import metrics
from tpu_dist_torch.resilience.cli import parse_result_line
from tpu_dist_torch.resilience.supervisor import (BackoffPolicy, GracePolicy,
                                                  Supervisor,
                                                  SupervisorReport)
from tpu_dist_torch.serve import journal as journal_lib


class ServeSupervisor(Supervisor):
    """Supervise one serve worker process against a shared journal.

    Args:
      cmd: worker argv (e.g. ``[sys.executable, "-m",
        "tpu_dist_torch.serve", "--worker", ...]``); rerun unchanged every
        attempt.
      journal_dir: the journal directory every attempt shares — exported
        to the worker as ``$TPU_DIST_SERVE_JOURNAL``.
      Everything else is forwarded to :class:`Supervisor` (one worker,
      empty ``no_restart_exits``).
    """

    def __init__(self, cmd: Sequence[str], *,
                 journal_dir: str | pathlib.Path,
                 max_restarts: int = 3,
                 attempt_deadline_s: Optional[float] = None,
                 backoff: BackoffPolicy = BackoffPolicy(initial_s=0.1,
                                                        max_s=2.0),
                 grace: GracePolicy = GracePolicy(),
                 env: Optional[dict] = None,
                 log_dir: str | pathlib.Path = "serve-logs",
                 event_log=None):
        self.journal_dir = pathlib.Path(journal_dir)
        env = dict(env or {})
        env[journal_lib.JOURNAL_DIR_ENV] = str(self.journal_dir)
        super().__init__(cmd, num_workers=1, max_restarts=max_restarts,
                         attempt_deadline_s=attempt_deadline_s,
                         backoff=backoff, grace=grace, env=env,
                         log_dir=log_dir, event_log=event_log,
                         no_restart_exits=())

    def run(self) -> SupervisorReport:
        report = super().run()
        if report.restarts:
            metrics.inc("serve.engine.restarts", report.restarts)
        return report

    def final_result(self, report: SupervisorReport) -> Optional[dict]:
        """The last ``RESULT:{...}`` line of the FINAL attempt's worker
        log, or None when the worker never printed one."""
        log = self.worker_log(report.attempts - 1, 0)
        try:
            return parse_result_line(log.read_text())
        except OSError:
            return None

    def journal_state(self) -> journal_lib.JournalState:
        """Replay the shared journal — the record of what was served across
        every attempt (per-request token streams included)."""
        return journal_lib.load(self.journal_dir / journal_lib.JOURNAL_NAME)
