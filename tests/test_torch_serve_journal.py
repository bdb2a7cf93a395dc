"""The port's request journal against the reference's, on the CPU.

The same lifecycle (submits, tokens, finishes, replay markers, rotations)
driven through both packages' ``RequestJournal`` must write the same
records, the ``ts`` fields aside; each package's ``load`` must read the
other's journal to the same ``JournalState``; and the reference's own
journal cases (``tests/test_serve_resilience.py``: buffered flushes, the
torn trailing line, replay markers, stop conditions, rotation and the
environment parsing) hold for the port as they do for the reference.
"""

import json

import pytest

from tpu_dist.serve import journal as jjournal
from tpu_dist.serve import scheduler as jsched
from tpu_dist_torch.serve import journal
from tpu_dist_torch.serve import scheduler as sched
from tpu_dist_torch.serve.journal import RequestJournal
from tpu_dist_torch.serve.scheduler import DONE, Request

PACKAGES = {"torch": (journal, sched), "jax": (jjournal, jsched)}


def _lifecycle(jmod, smod, directory, *, max_bytes=None):
    """One scripted lifecycle through a package's journal."""
    j = jmod.RequestJournal(directory, fsync=False, max_bytes=max_bytes)
    reqs = [smod.Request(prompt=[1, 2], max_new_tokens=4, rid=0),
            smod.Request(prompt=[3], max_new_tokens=2, eos_id=9, rid=1),
            smod.Request(prompt=[4, 5], max_new_tokens=3, rid=2,
                         deadline_s=2.5),
            smod.Request(prompt=[6, 7, 8], max_new_tokens=5, rid=3)]
    for r in reqs:
        j.record_submit(r)
    j.flush()
    j.record_token(0, 11)
    j.record_token(1, 9)
    reqs[1].status = smod.DONE
    reqs[1].finish_reason = "eos"
    j.record_finish(reqs[1])
    j.flush()
    j.record_token(0, 12)
    reqs[3].status = smod.SHED
    reqs[3].finish_reason = "shed"
    j.record_finish(reqs[3])
    j.record_replay(attempt=1, queued=[2], active=[0], completed=[1],
                    replay_s=0.25)
    j.record_token(2, 7)
    j.close()
    return j


def _records(path):
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("ts", None)
        out.append(rec)
    return out


def _state(s):
    return {
        "requests": {rid: (r.prompt, r.max_new_tokens, r.eos_id,
                           r.deadline_s, r.tokens, r.status,
                           r.finish_reason, r.order, r.replays,
                           r.finished, r.stop_satisfied())
                     for rid, r in s.requests.items()},
        "markers": [{k: v for k, v in m.items() if k != "ts"}
                    for m in s.replay_markers],
        "records": s.records, "compacted": s.compacted_rids,
        "rotations": s.rotations, "known": s.known_rids,
        "next_rid": s.next_rid,
        "pending": tuple([r.rid for r in p] for p in s.pending()),
    }


def test_same_lifecycle_writes_the_same_records(tmp_path):
    ours = _lifecycle(journal, sched, tmp_path / "torch")
    ref = _lifecycle(jjournal, jsched, tmp_path / "jax")
    assert ours.path.name == ref.path.name == "journal.jsonl"
    assert _records(ours.path) == _records(ref.path)
    # ts is written (operator telemetry) and only ts was dropped.
    assert all("ts" in json.loads(line) for line in
               ours.path.read_text().splitlines()
               if json.loads(line)["rec"] in ("submit", "finish", "replay"))


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_each_package_loads_the_others_journal(tmp_path, writer):
    j = _lifecycle(*PACKAGES[writer], tmp_path)
    ours, ref = journal.load(j.path), jjournal.load(j.path)
    assert _state(ours) == _state(ref)
    assert ours.requests[0].tokens == [11, 12]
    assert ours.requests[0].replays == 1
    assert ours.pending() and [r.rid for r in ours.pending()[0]] == [0, 2]


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_rotation_writes_and_reads_alike(tmp_path, writer):
    jmod, smod = PACKAGES[writer]
    j = _lifecycle(jmod, smod, tmp_path)
    j._closed = False
    marker = j.rotate()
    assert marker["finished_rids"] == [1, 3] and marker["rotations"] == 1
    assert _state(journal.load(j.path)) == _state(jjournal.load(j.path))
    assert journal.load(j.path).compacted_rids == {1, 3}


def test_rotated_files_are_equal_ts_aside(tmp_path):
    a = _lifecycle(journal, sched, tmp_path / "torch")
    b = _lifecycle(jjournal, jsched, tmp_path / "jax")
    a._closed = b._closed = False
    a.rotate()
    b.rotate()
    assert _records(a.path) == _records(b.path)


@pytest.mark.parametrize("max_bytes", [300, 400, 900])
def test_max_bytes_rotation_matches_reference(tmp_path, max_bytes):
    for name, (jmod, smod) in PACKAGES.items():
        j = jmod.RequestJournal(tmp_path / name, fsync=False,
                                max_bytes=max_bytes)
        for rid in range(12):
            r = smod.Request(prompt=[rid, rid + 1], max_new_tokens=1,
                             rid=rid)
            j.record_submit(r)
            j.record_token(rid, 7)
            r.status = smod.DONE
            r.finish_reason = "length"
            j.record_finish(r)
            j.flush()
    ours = journal.load(tmp_path / "torch" / journal.JOURNAL_NAME)
    ref = jjournal.load(tmp_path / "jax" / jjournal.JOURNAL_NAME)
    assert _state(ours) == _state(ref)
    assert ours.rotations >= 1 and ours.known_rids == set(range(12))
    assert (tmp_path / "torch" / journal.JOURNAL_NAME).stat().st_size < 1200


# -- the reference's journal cases, for the port ------------------------------


def test_roundtrip_and_pending_order(tmp_path):
    j = RequestJournal(tmp_path, fsync=False)
    reqs = [Request(prompt=[1, 2], max_new_tokens=4, rid=0),
            Request(prompt=[3], max_new_tokens=2, eos_id=9, rid=1),
            Request(prompt=[4, 5], max_new_tokens=3, rid=2)]
    for r in reqs:
        j.record_submit(r)
    j.record_token(0, 11)
    j.record_token(0, 12)
    reqs[1].status = DONE
    reqs[1].finish_reason = "eos"
    j.record_finish(reqs[1])
    j.close()
    state = journal.load(j.path)
    assert state.known_rids == {0, 1, 2} and state.next_rid == 3
    assert state.requests[0].tokens == [11, 12]
    assert state.requests[1].finished
    assert state.requests[1].finish_reason == "eos"
    active, queued = state.pending()
    assert [r.rid for r in active] == [0]
    assert [r.rid for r in queued] == [2]


def test_flush_is_batched(tmp_path):
    j = RequestJournal(tmp_path, fsync=False)
    j.record_submit(Request(prompt=[1], rid=0))
    j.record_token(0, 5)
    assert not j.path.exists()
    assert j.flush() == 2
    assert len(j.path.read_text().splitlines()) == 2
    assert j.flush() == 0


def test_fsync_flush_is_one_append(tmp_path, monkeypatch):
    syncs = []
    monkeypatch.setattr(journal.os, "fsync", syncs.append)
    j = RequestJournal(tmp_path)
    j.record_submit(Request(prompt=[1], rid=0))
    j.record_token(0, 5)
    j.record_token(0, 6)
    assert j.flush() == 3 and len(syncs) == 1
    assert j.flush() == 0 and len(syncs) == 1


@pytest.mark.parametrize("torn", ['{"rec": "token", "rid": 0, "t"', "{",
                                  '{"rec": "finish", "rid": 0, "sta'])
def test_torn_trailing_line_skipped(tmp_path, torn):
    j = RequestJournal(tmp_path, fsync=False)
    j.record_submit(Request(prompt=[1, 2], rid=0))
    j.record_token(0, 7)
    j.flush()
    with open(j.path, "a") as fh:
        fh.write(torn)
    state, ref = journal.load(j.path), jjournal.load(j.path)
    assert state.requests[0].tokens == [7]
    assert not state.requests[0].finished
    assert _state(state) == _state(ref)


def test_missing_file_is_empty_state(tmp_path):
    state = journal.load(tmp_path / "nope.jsonl")
    assert not state.requests and state.next_rid == 0


def test_replay_marker_counts_active_replays(tmp_path):
    j = RequestJournal(tmp_path, fsync=False)
    j.record_submit(Request(prompt=[1], rid=0))
    j.record_submit(Request(prompt=[2], rid=1))
    j.record_token(0, 3)
    for attempt in (1, 2):
        j.record_replay(attempt=attempt, queued=[1], active=[0],
                        completed=[], replay_s=0.01)
    j.close()
    state = journal.load(j.path)
    assert state.requests[0].replays == 2
    assert state.requests[1].replays == 0
    assert len(state.replay_markers) == 2


def test_stop_satisfied():
    jr = journal.JournaledRequest(0, prompt=[1], max_new_tokens=3, eos_id=9,
                                  deadline_s=None, order=0)
    jr.tokens = [4, 5]
    assert not jr.stop_satisfied()
    jr.tokens = [4, 9]
    assert jr.stop_satisfied() and jr.implied_finish_reason() == "eos"
    jr.tokens = [4, 5, 6]
    jr.eos_id = None
    assert jr.stop_satisfied() and jr.implied_finish_reason() == "length"


def test_closed_journal_rejects_records(tmp_path):
    j = RequestJournal(tmp_path, fsync=False)
    j.close()
    with pytest.raises(RuntimeError):
        j.record_token(0, 1)


def test_torn_line_after_rotation_still_tolerated(tmp_path):
    j = _lifecycle(journal, sched, tmp_path)
    j._closed = False
    j.rotate()
    with open(j.path, "a") as fh:
        fh.write('{"rec": "token", "rid": 0, "t"')
    state = journal.load(j.path)
    assert state.compacted_rids == {1, 3}
    assert state.requests[0].tokens == [11, 12]


def test_env_names_and_parsing_match_reference(monkeypatch):
    assert journal.JOURNAL_DIR_ENV == jjournal.JOURNAL_DIR_ENV
    assert journal.JOURNAL_MAX_BYTES_ENV == jjournal.JOURNAL_MAX_BYTES_ENV
    assert journal.JOURNAL_NAME == jjournal.JOURNAL_NAME
    monkeypatch.delenv(journal.JOURNAL_MAX_BYTES_ENV, raising=False)
    monkeypatch.delenv(journal.JOURNAL_DIR_ENV, raising=False)
    assert journal.journal_max_bytes_from_env() is None
    assert journal.journal_dir_from_env() is None
    for raw in ("", "0", "nope", "-5", " 65536", "65536"):
        monkeypatch.setenv(journal.JOURNAL_MAX_BYTES_ENV, raw)
        assert (journal.journal_max_bytes_from_env()
                == jjournal.journal_max_bytes_from_env())
    assert journal.journal_max_bytes_from_env() == 65536
    monkeypatch.setenv(journal.JOURNAL_DIR_ENV, "/some/dir")
    assert journal.journal_dir_from_env() == "/some/dir"
