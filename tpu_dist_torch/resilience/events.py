"""Structured resilience event log: the failure-handling trail.

Counterpart of ``tpu_dist/resilience/events.py``, copied whole (the port
imports nothing of ``tpu_dist``); the record schema, the file format and
the environment names are the reference's, so either package's tools
read the other's log. One JSONL file that every participant in a chaos
run appends to:

* the :class:`~tpu_dist_torch.resilience.injector.ServeFaultInjector`
  (inside the serve engine) logs ``fault_armed`` / ``fault_fired`` /
  ``resumed``;
* the :class:`~tpu_dist_torch.resilience.supervisor.Supervisor` logs
  ``attempt_start`` / ``worker_exit`` / ``restart`` / ``recovered`` /
  ``run_complete``;
* the serve engine logs ``serve_replay`` and ``serve_stall``.

Every event carries a wall-clock timestamp, the writer's role, its pid
and (where the writer knows it) the restart attempt, so a post-mortem can
interleave supervisor- and worker-side views of the same incident.
Workers inherit the log path through ``TPU_DIST_EVENT_LOG`` (set by the
Supervisor); appends are single ``write`` calls, so concurrent writers on
a POSIX filesystem interleave at line granularity.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

#: Environment variable carrying the event-log path into worker processes.
EVENT_LOG_ENV = "TPU_DIST_EVENT_LOG"

#: Environment variable carrying the supervisor's restart-attempt counter
#: into worker processes (0 on the first launch).
ATTEMPT_ENV = "TPU_DIST_RESILIENCE_ATTEMPT"


def current_attempt() -> int:
    """The supervisor restart attempt this process runs under (0 outside a
    supervised run)."""
    try:
        return int(os.environ.get(ATTEMPT_ENV, "0"))
    except ValueError:
        return 0


class EventLog:
    """Append-only JSONL event stream shared by supervisor and workers."""

    def __init__(self, path: str | os.PathLike, *, role: str = "worker"):
        self.path = os.fspath(path)
        self.role = role
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)

    def append(self, event: str, **fields: Any) -> dict:
        record = {"event": event, "ts": round(time.time(), 6),
                  "role": self.role, "pid": os.getpid(), **fields}
        # One write() per record keeps concurrent writers line-atomic.
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(record) + "\n")
        return record


def read_events(path: str | os.PathLike,
                event: Optional[str] = None) -> list[dict]:
    """All events in ``path`` (optionally filtered by event type). Partial
    trailing lines — a writer killed mid-append — are skipped, not fatal:
    chaos runs kill writers on purpose."""
    out: list[dict] = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if event is None or rec.get("event") == event:
                    out.append(rec)
    except FileNotFoundError:
        pass
    return out


def log_from_env(*, role: str = "worker") -> Optional[EventLog]:
    """The process-wide event log named by ``$TPU_DIST_EVENT_LOG``, or None
    when this process is not part of an instrumented run."""
    path = os.environ.get(EVENT_LOG_ENV)
    if not path:
        return None
    return EventLog(path, role=role)


def maybe_log(event: str, **fields: Any) -> None:
    """Fire-and-forget append for call sites (e.g. the trainer) that must
    never fail because observability is wired up wrong."""
    try:
        log = log_from_env()
        if log is not None:
            log.append(event, **fields)
    except OSError:  # pragma: no cover - diagnostics only, never fatal
        pass
