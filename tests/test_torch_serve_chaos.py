"""The port's supervisors and serve chaos CLI against the reference's.

The port's ``Supervisor`` and ``ServeSupervisor`` run the same scripted
``python -c`` workers as the reference's (exits by attempt and rank, a
hang past the deadline, two ranks with TF_CONFIGs): the attempts,
restarts, exit codes and their classifications, the event sequence and
the workers' ``RESULT`` lines must be the reference's. Then one end-to-end
``python -m tpu_dist_torch.serve --chaos --plan engine_crash@reqN --device
cpu`` at tiny width: the fault fires, the engine restarts, recovery goes
through a journal replay and every stream equals the baseline exactly.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from tpu_dist.resilience import events as jevents
from tpu_dist.resilience import supervisor as jsupervisor
from tpu_dist.serve import supervisor as jserve_supervisor
from tpu_dist_torch.resilience import events, supervisor
from tpu_dist_torch.resilience.cli import parse_result_line
from tpu_dist_torch.serve import cli
from tpu_dist_torch.serve import journal
from tpu_dist_torch.serve import supervisor as serve_supervisor

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: Worker scripts: the attempt and rank come from the environment.
_PRELUDE = ("import json, os, sys, time; "
            "a = int(os.environ['TPU_DIST_RESILIENCE_ATTEMPT']); "
            "tf = os.environ.get('TF_CONFIG'); "
            "r = json.loads(tf)['task']['index'] if tf else 0; ")
WORKERS = {
    "clean": "sys.exit(0)",
    "crash_then_clean": "sys.exit(43 if a == 0 else 0)",
    "integrity_abort": "sys.exit(41 if a == 0 else 0)",
    "serve_abort": "sys.exit(45 if a < 2 else 0)",
    "always_crash": "sys.exit(1)",
    "hang_then_clean": "time.sleep(60) if a == 0 else sys.exit(0)",
    "rank1_dies": ("sys.exit(0) if a > 0 else "
                   "(sys.exit(43) if r == 1 else time.sleep(60))"),
    "result": ("print('noise'); "
               "print('RESULT:' + json.dumps({'attempt': a, 'j': "
               "bool(os.environ.get('TPU_DIST_SERVE_JOURNAL'))})); "
               "sys.exit(0 if a else 45)"),
}


def _cmd(name):
    return [sys.executable, "-c", _PRELUDE + WORKERS[name]]


def _kw(mod, tmp_path, tag, deadline_s=30.0):
    return dict(
        max_restarts=2, attempt_deadline_s=deadline_s,
        backoff=mod.BackoffPolicy(initial_s=0.01, max_s=0.02),
        grace=mod.GracePolicy(exit_grace_s=0.2, term_grace_s=1.0),
        log_dir=tmp_path / tag / "logs")


def _report(rep):
    out = rep.to_json()
    for k in ("wall_time_s", "recovery_wall_s"):
        assert k in out
        out.pop(k)
    return out


def _event_names(path):
    return [e["event"] for e in events.read_events(path)]


@pytest.mark.parametrize("name,workers", [
    ("clean", 1), ("crash_then_clean", 1), ("integrity_abort", 1),
    ("always_crash", 1), ("hang_then_clean", 1), ("rank1_dies", 2)])
def test_supervisor_matches_reference(tmp_path, name, workers):
    got = []
    for tag, mod, ev in (("torch", supervisor, events),
                         ("jax", jsupervisor, jevents)):
        path = tmp_path / tag / "events.jsonl"
        # Only the hanging worker meets its deadline; a generous one
        # elsewhere keeps a loaded machine from turning a slow start into
        # a deadline kill.
        deadline_s = 4.0 if name.startswith("hang") else 30.0
        sup = mod.Supervisor(_cmd(name), num_workers=workers,
                             event_log=ev.EventLog(path, role="supervisor"),
                             **_kw(mod, tmp_path, tag, deadline_s))
        rep = sup.run()
        got.append((rep.success, rep.attempts, rep.restarts, _report(rep),
                    _event_names(path)))
    assert got[0] == got[1]
    rep = got[0][3]
    if name == "integrity_abort":
        assert got[0][:3] == (False, 1, 0)
    if name == "hang_then_clean":
        assert rep["exit_kinds"] == [["signal_9"], ["clean"]]
    if name == "rank1_dies":
        assert rep["exit_kinds"][0][1] == "fault_kill"
        assert rep["exit_kinds"][1] == ["clean", "clean"]


@pytest.mark.parametrize("name", ["serve_abort", "integrity_abort",
                                  "result"])
def test_serve_supervisor_matches_reference(tmp_path, name):
    got = []
    for tag, mod, ev in (("torch", serve_supervisor, events),
                         ("jax", jserve_supervisor, jevents)):
        path = tmp_path / tag / "events.jsonl"
        kw = _kw(mod, tmp_path, tag)
        kw.pop("backoff")
        sup = mod.ServeSupervisor(
            _cmd(name), journal_dir=tmp_path / tag / "journal",
            event_log=ev.EventLog(path, role="supervisor"), **kw)
        rep = sup.run()
        got.append((rep.success, rep.attempts, _report(rep),
                    _event_names(path), sup.final_result(rep),
                    sup.journal_state().records))
    assert got[0] == got[1]
    # EXIT_SERVE_ABORT and even integrity_abort restart under serving.
    assert got[0][0] is True and got[0][1] >= 2
    if name == "result":
        assert got[0][4] == {"attempt": 1, "j": True}


def test_unported_supervisor_arguments_raise(tmp_path):
    # Item 18b ported the elastic arguments; several devices a process
    # (a device count above 1) is item 12b.
    with pytest.raises(NotImplementedError, match="item 12b of queue 1"):
        supervisor.Supervisor(_cmd("clean"), device_schedule=[2])
    supervisor.Supervisor(_cmd("clean"), device_schedule=[1, 1])
    # Item 20 leased each fleet replica a slot; a replica of several
    # devices in one process is item 12b.
    with pytest.raises(NotImplementedError, match="item 12b of queue 1"):
        cli.main(["--fleet", "--devices-per-replica", "2"])


def test_backoff_and_classification_match_reference():
    for mod in (supervisor, jsupervisor):
        with pytest.raises(ValueError):
            mod.BackoffPolicy().delay(-1)
        with pytest.raises(ValueError):
            mod.Supervisor(_cmd("clean"), num_workers=0)
        with pytest.raises(ValueError):
            mod.Supervisor(_cmd("clean"), max_restarts=-1)
    for n in range(8):
        assert (supervisor.BackoffPolicy().delay(n)
                == jsupervisor.BackoffPolicy().delay(n))
    for code in (None, 0, 1, 17, 19, 41, 43, 45, 47, -9, -15):
        assert supervisor.classify_exit(code) == jsupervisor.classify_exit(
            code)


def test_result_line_protocol():
    from tpu_dist.resilience.cli import parse_result_line as jparse

    text = ("x\nRESULT:{\"a\": 1}\nRESULT:{torn\nRESULT:{\"a\": 2}\n"
            "tail RESULT:{\"a\": 3}\n")
    assert parse_result_line(text) == jparse(text) == {"a": 2}
    assert parse_result_line("nothing") is None


def test_chaos_needs_a_serve_fault(capsys):
    assert cli.main(["--chaos", "--plan", "kill-worker@step2",
                     "--device", "cpu"]) == 2
    assert cli.main(["--chaos", "--device", "cpu"]) == 2
    assert cli.main(["--chaos", "--plan", "replica_kill@req1",
                     "--device", "cpu"]) == 2
    assert cli.main(["--chaos", "--plan", "engine_crash@req1",
                     "--temperature", "0.5", "--device", "cpu"]) == 2
    capsys.readouterr()


def test_engine_crash_chaos_end_to_end_on_the_cpu(tmp_path):
    report_path = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.serve", "--chaos", "--plan",
         "engine_crash@req2", "--device", "cpu", "--requests", "6",
         "--max-batch", "4", "--max-len", "32", "--vocab", "32",
         "--d-model", "16", "--depth", "1", "--num-heads", "2",
         "--max-new", "8", "--workdir", str(tmp_path / "chaos"),
         "--report", str(report_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(report_path.read_text())
    assert report["ok"], report.get("failure")
    eng = report["engine"]
    assert eng["restarts"] >= 1
    assert any(f["kind"] == "engine_crash" for f in eng["faults_fired"])
    assert eng["journal_replays"], "recovered without a journal replay"
    assert eng["token_mismatches"] == [] and eng["certified_ties"] == []
    assert eng["parity_ok"] is True
    assert "fault_kill" in {k for ks in eng["exit_kinds"] for k in ks}
    assert eng["final_result"]["replay"]["attempt"] == 1
    assert len(eng["restart_to_first_token_s"]) == eng["restarts"]
    state = journal.load(tmp_path / "chaos" / "journal" /
                         journal.JOURNAL_NAME)
    assert len(state.requests) == eng["baseline_requests"] == 6
    assert all(jr.finished for jr in state.requests.values())
