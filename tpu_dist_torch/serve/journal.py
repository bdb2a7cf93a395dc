"""Durable request journal: the serve engine's crash-recovery log.

Counterpart of ``tpu_dist/serve/journal.py``, copied whole (the port
imports nothing of ``tpu_dist``). The file name, the record schema and
the environment names are the reference's, so each package recovers from
the other's journal. An append-only JSONL file records every request's
lifecycle — ``submit`` (prompt and generation knobs), ``token`` (each
emitted token), ``finish`` (terminal status and reason) and ``replay``
(one marker per crash recovery, naming the requests that were in flight)
— so a supervised engine restart can reconstruct where serving stood:

* requests journaled ``submit`` but never ``finish`` and with no tokens
  are **queued**: re-admitted in arrival order;
* requests with tokens but no ``finish`` were **active** mid-decode:
  re-prefilled with ``prompt + tokens_emitted_so_far``, so the greedy
  continuation equals an uninterrupted run's;
* requests whose journaled tokens already satisfy their stop condition
  (EOS flushed, length reached) finish **during replay** — their terminal
  record was lost in the crash, not their work.

Durability model: records are **buffered in memory and flushed once per
decode step** — a single ``write`` of the whole batch followed by an
``fsync`` (the same durability discipline as ``training/checkpoint.py``:
atomicity is not durability; data sitting in the page cache is lost to a
crash). One fsync per decode step keeps the journal off the per-token hot
path; everything since the last flush is regenerated deterministically on
replay, so the flush granularity bounds *recomputation*, never
*correctness*. A writer killed mid-flush leaves at most one torn trailing
line, which :func:`load` skips exactly like the resilience event log does.

The journal is host-side and framework-free: it records scheduling truth
and never touches a device tensor, so it adds no work to the captured
decode program.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Optional

#: Environment variable a supervised serve worker reads its journal
#: directory from (set by the serve chaos runner / ServeSupervisor).
JOURNAL_DIR_ENV = "TPU_DIST_SERVE_JOURNAL"

#: Environment variable bounding the journal file size (bytes): past it,
#: the next flush compacts the file (:meth:`RequestJournal.flush`).
#: Unset/empty/0 = never rotate (the historical behavior).
JOURNAL_MAX_BYTES_ENV = "TPU_DIST_SERVE_JOURNAL_MAX_BYTES"

#: Journal file name inside the journal directory.
JOURNAL_NAME = "journal.jsonl"


class RequestJournal:
    """Buffered, fsync'd append-only journal for one serving process.

    Args:
      directory: journal directory (created if missing); the JSONL lives at
        ``<directory>/journal.jsonl``. An existing journal is APPENDED to —
        recovery reads it first (:func:`load`), then the recovered engine
        keeps writing to the same file, so the full request history
        survives any number of restarts.
      fsync: set False to skip the per-flush fsync (tests on tmpfs; a
        production engine keeps it on — a journal that loses its tail to
        the page cache silently re-queues shed work).
      max_bytes: rotate (compact) the journal when a flush leaves the
        file larger than this. Compaction drops finished requests'
        records — their rids survive in the rotation marker, so
        idempotent resubmission and rid allocation are unchanged — and
        rewrites unfinished requests' submit+token trails verbatim, so a
        crash after any number of rotations replays exactly like one
        before the first. None (or a false-y value) = never rotate; a
        long-lived engine's journal then grows with every token served.
    """

    def __init__(self, directory: str | os.PathLike, *, fsync: bool = True,
                 max_bytes: Optional[int] = None):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.path = self.directory / JOURNAL_NAME
        self.fsync = bool(fsync)
        self.max_bytes = int(max_bytes) if max_bytes else None
        self.rotations = 0
        self._buf: list[str] = []
        self._closed = False

    # -- records (buffered) --------------------------------------------------

    def _put(self, rec: dict) -> None:
        if self._closed:
            raise RuntimeError(f"journal {self.path} is closed")
        self._buf.append(json.dumps(rec))

    def record_submit(self, req) -> None:
        # ts fields below are operator telemetry ONLY: load()/replay never
        # read them, rotate() strips them, and no gate compares them.
        self._put({"rec": "submit", "rid": int(req.rid),  # shardcheck: disable=SC601 -- ts is write-only telemetry, ignored by load()/replay
                   "prompt": [int(t) for t in req.prompt],
                   "max_new_tokens": int(req.max_new_tokens),
                   "eos_id": (None if req.eos_id is None
                              else int(req.eos_id)),
                   "deadline_s": req.deadline_s,
                   "ts": round(time.time(), 6)})

    def record_token(self, rid: int, token: int) -> None:
        self._put({"rec": "token", "rid": int(rid), "t": int(token)})

    def record_finish(self, req) -> None:
        self._put({"rec": "finish", "rid": int(req.rid),  # shardcheck: disable=SC601 -- ts is write-only telemetry, ignored by load()/replay
                   "status": req.status, "reason": req.finish_reason,
                   "ts": round(time.time(), 6)})

    def record_replay(self, *, attempt: int, queued: list, active: list,
                      completed: list, replay_s: float) -> None:
        """One marker per crash recovery. ``active`` is what counts against
        each request's retry budget: those are the requests that were being
        decoded when the engine died (the poison-pill suspects)."""
        self._put({"rec": "replay", "attempt": int(attempt),  # shardcheck: disable=SC601 -- ts is write-only telemetry, ignored by load()/replay
                   "queued": [int(r) for r in queued],
                   "active": [int(r) for r in active],
                   "completed": [int(r) for r in completed],
                   "replay_s": round(float(replay_s), 6),
                   "ts": round(time.time(), 6)})
        self.flush()

    # -- durability ----------------------------------------------------------

    def flush(self) -> int:
        """Write every buffered record as ONE append + fsync; returns the
        number of records flushed. Called by the engine between decode
        steps — the batched-fsync contract in the module docstring."""
        if not self._buf:
            return 0
        n = len(self._buf)
        data = "\n".join(self._buf) + "\n"
        self._buf = []
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(data)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        if (self.max_bytes is not None
                and self.path.stat().st_size > self.max_bytes):
            self.rotate()
        return n

    def rotate(self) -> dict:
        """Compact the journal in place: drop finished requests' records,
        keep replay-marker history and every unfinished request's full
        submit+token trail, and lead with ONE cumulative ``rotate`` marker
        carrying the dropped rids (so ``known_rids``/``next_rid`` read
        back exactly as before compaction). Atomic and durable the
        checkpoint way — temp file, fsync, rename, fsync(dir) — so a
        crash mid-rotation leaves either the old journal or the new one,
        never a blend. Returns the rotation marker."""
        state = load(self.path)
        finished = sorted(state.compacted_rids
                          | {r.rid for r in state.requests.values()
                             if r.finished})
        self.rotations = state.rotations + 1
        marker = {"rec": "rotate", "rotations": self.rotations,
                  "finished_rids": finished,
                  "ts": round(time.time(), 6)}
        lines = [json.dumps(marker)]
        lines += [json.dumps(m) for m in state.replay_markers]
        unfinished = sorted((r for r in state.requests.values()
                             if not r.finished), key=lambda r: r.order)
        for r in unfinished:
            lines.append(json.dumps(
                {"rec": "submit", "rid": r.rid, "prompt": r.prompt,
                 "max_new_tokens": r.max_new_tokens, "eos_id": r.eos_id,
                 "deadline_s": r.deadline_s}))
            lines += [json.dumps({"rec": "token", "rid": r.rid, "t": t})
                      for t in r.tokens]
        tmp = self.path.with_name(JOURNAL_NAME + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")  # shardcheck: disable=SC601 -- rotate marker ts is write-only telemetry; replay ignores it
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        if self.fsync:
            fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        return marker

    def close(self) -> None:
        if not self._closed:
            self.flush()
            self._closed = True

    def __enter__(self) -> "RequestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class JournaledRequest:
    """Replay-side view of one journaled request."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_id", "deadline_s",
                 "tokens", "status", "finish_reason", "order", "replays")

    def __init__(self, rid: int, *, prompt: list, max_new_tokens: int,
                 eos_id: Optional[int], deadline_s: Optional[float],
                 order: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.deadline_s = deadline_s
        self.tokens: list[int] = []
        self.status: Optional[str] = None      # terminal status, if finished
        self.finish_reason: Optional[str] = None
        self.order = order                     # arrival order (submit index)
        self.replays = 0                       # times caught ACTIVE in a crash

    @property
    def finished(self) -> bool:
        return self.status is not None

    def stop_satisfied(self) -> bool:
        """True when the journaled tokens already meet the request's stop
        condition — the terminal record was lost, not the work."""
        if self.eos_id is not None and self.eos_id in self.tokens:
            return True
        return len(self.tokens) >= self.max_new_tokens

    def implied_finish_reason(self) -> str:
        if self.eos_id is not None and self.eos_id in self.tokens:
            return "eos"
        return "length"


class JournalState:
    """Everything :func:`load` reconstructs from a journal file."""

    def __init__(self):
        self.requests: dict[int, JournaledRequest] = {}
        self.replay_markers: list[dict] = []
        self.records = 0
        #: Finished rids whose records a rotation dropped — still "known"
        #: (resubmission idempotency, rid allocation), just not replayable.
        self.compacted_rids: set = set()
        self.rotations = 0

    @property
    def known_rids(self) -> set:
        return set(self.requests) | self.compacted_rids

    @property
    def next_rid(self) -> int:
        return max(max(self.requests, default=-1),
                   max(self.compacted_rids, default=-1)) + 1

    def pending(self) -> tuple[list, list]:
        """``(active, queued)`` in arrival order: active = unfinished with
        tokens (were mid-decode), queued = unfinished without tokens."""
        unfinished = sorted((r for r in self.requests.values()
                             if not r.finished), key=lambda r: r.order)
        active = [r for r in unfinished if r.tokens]
        queued = [r for r in unfinished if not r.tokens]
        return active, queued


def load(path: str | os.PathLike) -> JournalState:
    """Replay a journal file into a :class:`JournalState`. Unparseable
    (torn) lines are skipped — crash recovery reads journals whose writer
    died mid-append, by design. A missing file is an empty state."""
    state = JournalState()
    try:
        fh = open(path, "r", encoding="utf-8")
    except FileNotFoundError:
        return state
    with fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            kind = rec.get("rec")
            state.records += 1
            if kind == "submit":
                rid = int(rec["rid"])
                state.requests[rid] = JournaledRequest(
                    rid, prompt=list(rec.get("prompt", [])),
                    max_new_tokens=int(rec.get("max_new_tokens", 0)),
                    eos_id=rec.get("eos_id"),
                    deadline_s=rec.get("deadline_s"),
                    order=len(state.requests))
            elif kind == "token":
                jr = state.requests.get(int(rec.get("rid", -1)))
                if jr is not None:
                    jr.tokens.append(int(rec["t"]))
            elif kind == "finish":
                jr = state.requests.get(int(rec.get("rid", -1)))
                if jr is not None:
                    jr.status = rec.get("status")
                    jr.finish_reason = rec.get("reason")
            elif kind == "replay":
                state.replay_markers.append(rec)
                for rid in rec.get("active", []):
                    jr = state.requests.get(int(rid))
                    if jr is not None:
                        jr.replays += 1
            elif kind == "rotate":
                state.compacted_rids |= {int(r) for r in
                                         rec.get("finished_rids", [])}
                state.rotations = max(state.rotations,
                                      int(rec.get("rotations", 0)))
    return state


def journal_dir_from_env() -> Optional[str]:
    """The journal directory named by ``$TPU_DIST_SERVE_JOURNAL``, or None
    when this process serves without crash recovery."""
    d = os.environ.get(JOURNAL_DIR_ENV)
    return d if d else None


def journal_max_bytes_from_env() -> Optional[int]:
    """The rotation threshold from ``$TPU_DIST_SERVE_JOURNAL_MAX_BYTES``,
    or None (never rotate) when unset, empty, zero, or unparseable."""
    raw = os.environ.get(JOURNAL_MAX_BYTES_ENV)
    if not raw or not raw.strip():
        return None
    try:
        n = int(raw)
    except ValueError:
        return None
    return n if n > 0 else None
