"""The port's serving resilience against the reference's, on the CPU.

Both engines serve the same weights (the reference's ``init``, bridged)
and the same seeded requests. Crash recovery — an engine abandoned after
a few steps with its unflushed journal tail dropped, then a second engine
on the same journal directory — must give the reference's uninterrupted
streams token for token, on the contiguous cache, the paged pool and the
int8 ragged pool, and from a journal either package wrote. Requests whose
stop condition is already journaled finish during replay; the retry
budget sheds a poison pill durably. Load shedding (queue bound, projected
TTFT, unmeetable deadline) gives the reference's causes and counts; the
watchdog fires through an injected ``stall_action``; the storm's shedding
and control reports on the ``VirtualClock`` equal the reference's; the
fault grammar and the serve injector behave as the reference's.
"""

import argparse
import time

import numpy as np
import pytest

from tpu_dist.models.transformer import build_transformer_lm as jbuild
from tpu_dist.resilience import faults as jfaults
from tpu_dist.resilience import injector as jinjector
from tpu_dist.serve import chaos as jchaos
from tpu_dist.serve import journal as jjournal
from tpu_dist.serve.engine import ServeEngine as JServeEngine
from tpu_dist_torch.models import transformer as tr
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.resilience import faults, injector
from tpu_dist_torch.serve import chaos, journal
from tpu_dist_torch.serve.engine import ServeEngine
from tpu_dist_torch.serve.scheduler import DONE, QUEUED, SHED

VOCAB, SEQ = 32, 32
PAGED = {"contiguous": {}, "paged": dict(paged=True, page_size=8),
         "int8_ragged": dict(paged=True, page_size=8, kv_dtype="int8",
                             ragged=True)}


@pytest.fixture(scope="module")
def pair():
    jmodel = jbuild(VOCAB, SEQ, d_model=16, depth=2, num_heads=2)
    params = jmodel.init(0)["params"]
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=16, depth=2,
                                    num_heads=2)
    model.load_jax_params(params)
    return jmodel, model


def _engine(model, **kw):
    return ServeEngine(model, max_len=SEQ, device="cpu",
                       **{"max_batch": 4, **kw})


def _jengine(jmodel, **kw):
    return JServeEngine(jmodel, max_len=SEQ, **{"max_batch": 4, **kw})


def _workload(n, *, seed=7, max_new=10):
    rng = np.random.default_rng(seed)
    return [{"prompt": rng.integers(0, VOCAB,
                                    size=int(rng.integers(2, 8))).tolist(),
             "max_new_tokens": int(rng.integers(3, max_new + 1))}
            for _ in range(n)]


def _serve(engine, workload):
    reqs = [engine.submit(w["prompt"], max_new_tokens=w["max_new_tokens"])
            for w in workload]
    engine.run_until_idle()
    return {r.rid: list(r.generated) for r in reqs}


def _crash(engine, workload, steps=3):
    """Serve a few rounds with the journal armed, then abandon the engine
    without close(): everything since the last flush is lost, as under
    ``os._exit``."""
    for w in workload:
        engine.submit(w["prompt"], max_new_tokens=w["max_new_tokens"])
    for _ in range(steps):
        engine.step()
    engine.journal._buf.clear()


def _journal_streams(directory):
    state = journal.load(directory / journal.JOURNAL_NAME)
    return state, {rid: (jr.finished, jr.tokens)
                   for rid, jr in state.requests.items()}


# -- crash recovery -----------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(PAGED))
def test_recovery_streams_equal_the_references(pair, tmp_path, mode):
    jmodel, model = pair
    workload = _workload(8)
    want = _serve(_jengine(jmodel, **PAGED[mode]), workload)
    first = _engine(model, journal=tmp_path / "j", **PAGED[mode])
    _crash(first, workload)
    del first
    second = _engine(model, journal=tmp_path / "j", **PAGED[mode])
    assert second.last_replay is not None
    assert second.known_rids == set(range(8))
    replay = second.last_replay
    assert replay["active"] and replay["replayed"]
    assert sorted(replay["replayed"] + replay["completed"]) == sorted(
        replay["active"] + replay["queued"])
    second.run_until_idle()
    if second.paged:
        second._paging.allocator.check()
    second.close()
    state, got = _journal_streams(tmp_path / "j")
    assert len(state.replay_markers) == 1
    assert got == {rid: (True, toks) for rid, toks in want.items()}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recovery_from_the_other_packages_journal(pair, tmp_path, writer):
    """A journal one package wrote mid-run is recovered by the other's
    engine, and the streams are the reference's uninterrupted ones."""
    jmodel, model = pair
    workload = _workload(8)
    want = _serve(_jengine(jmodel), workload)
    make = {"jax": _jengine, "torch": _engine}
    crashed = make[writer]((jmodel, model)[writer == "torch"],
                           journal=tmp_path / "j")
    _crash(crashed, workload)
    del crashed
    other = "torch" if writer == "jax" else "jax"
    revived = make[other]((jmodel, model)[other == "torch"],
                          journal=tmp_path / "j")
    assert revived.known_rids == set(range(8))
    revived.run_until_idle()
    revived.close()
    for mod in (journal, jjournal):
        state = mod.load(tmp_path / "j" / mod.JOURNAL_NAME)
        assert {rid: jr.tokens for rid, jr in state.requests.items()} == want
        assert all(jr.finished for jr in state.requests.values())


def test_active_request_resumes_midstream(pair, tmp_path):
    jmodel, model = pair
    engine = _engine(model, max_batch=2, journal=tmp_path / "j")
    req = engine.submit([3, 1, 4, 1], max_new_tokens=8)
    for _ in range(4):
        engine.step()
    emitted = list(req.generated)
    assert 0 < len(emitted) < 8
    del engine
    revived = _engine(model, max_batch=2, journal=tmp_path / "j")
    (again,) = [r for r in revived.scheduler.queue if r.rid == req.rid]
    assert again.generated == emitted
    revived.run_until_idle()
    assert again.generated == _jengine(jmodel, max_batch=2).generate(
        [3, 1, 4, 1], max_new_tokens=8)


@pytest.mark.parametrize("tokens,reason", [([5, 6], "length"),
                                           ([9], "eos")])
def test_stop_satisfied_requests_finish_during_replay(pair, tmp_path,
                                                      tokens, reason):
    jmodel, model = pair
    got = []
    for name, make, m in (("torch", _engine, model),
                          ("jax", _jengine, jmodel)):
        j = journal.RequestJournal(tmp_path / name, fsync=False)
        from tpu_dist_torch.serve.scheduler import Request

        j.record_submit(Request(prompt=[1, 2], max_new_tokens=2, eos_id=9,
                                rid=0))
        for t in tokens:
            j.record_token(0, t)
        j.close()
        engine = make(m, max_batch=2, journal=tmp_path / name)
        assert engine.scheduler.idle()
        (r,) = engine.finished
        got.append((r.rid, r.status, r.finish_reason, r.generated,
                    engine.last_replay["completed"]))
    assert got[0] == got[1] == (0, DONE, reason, tokens, [0])


def test_retry_budget_sheds_a_poison_pill(pair, tmp_path):
    jmodel, model = pair
    from tpu_dist_torch.serve.scheduler import Request

    got = []
    for name, make, m in (("torch", _engine, model),
                          ("jax", _jengine, jmodel)):
        j = journal.RequestJournal(tmp_path / name, fsync=False)
        j.record_submit(Request(prompt=[1, 2], max_new_tokens=8, rid=0))
        j.record_token(0, 5)
        for attempt in (1, 2):
            j.record_replay(attempt=attempt, queued=[], active=[0],
                            completed=[], replay_s=0.01)
        j.close()
        engine = make(m, max_batch=2, journal=tmp_path / name,
                      retry_budget=2)
        (r,) = engine.finished
        assert engine.scheduler.idle()
        engine.close()
        # The shed is durable: a third start does not resurrect it.
        third = make(m, max_batch=2, journal=tmp_path / name,
                     retry_budget=2)
        assert third.scheduler.idle() and not third.finished
        replay = dict(third.last_replay)
        assert replay.pop("replay_s") >= 0.0
        got.append((r.status, r.shed_cause, r.finish_reason, replay))
    assert got[0] == got[1]
    assert got[0][:2] == (SHED, "retry_budget")


def test_fresh_ids_continue_past_the_journal(pair, tmp_path):
    jmodel, model = pair
    workload = _workload(4)
    engine = _engine(model, journal=tmp_path / "j")
    _serve(engine, workload)
    engine.close()
    revived = _engine(model, journal=tmp_path / "j")
    assert revived.known_rids == set(range(4)) and revived.scheduler.idle()
    assert revived.last_replay["replayed"] == []
    assert revived.submit([1, 2, 3], max_new_tokens=2).rid == 4


def test_adopt_request_continues_the_donors_stream(pair, tmp_path):
    jmodel, model = pair
    want = _jengine(jmodel).generate([3, 1, 4, 1, 5], max_new_tokens=9)
    got = []
    for make, m, d in ((_engine, model, "torch"), (_jengine, jmodel, "jax")):
        engine = make(m, journal=tmp_path / d)
        engine.submit([2, 2], max_new_tokens=3)
        adopted = engine.adopt_request([3, 1, 4, 1, 5],
                                       generated=want[:4], max_new_tokens=9)
        done = engine.adopt_request([7, 7], generated=[1, 2],
                                    max_new_tokens=2)
        engine.run_until_idle()
        engine.close()
        got.append((adopted.rid, adopted.generated, done.rid, done.status,
                    done.finish_reason))
        state = journal.load(tmp_path / d / journal.JOURNAL_NAME)
        assert state.requests[adopted.rid].tokens == want
    assert got[0] == got[1]
    assert got[0][1] == want


# -- load shedding ------------------------------------------------------------


def _shed_trace(make, m, clock, script):
    # A clock that never moves: no deadline expires while serving.
    engine = make(m, clock=clock, **script["engine"])
    if "ema" in script:
        engine._step_ema_s = script["ema"]
    out = [(r.rid, r.status, r.shed_cause) for r in
           (engine.submit(p, **kw) for p, kw in script["submits"])]
    engine.run_until_idle()
    return out, [(r.rid, r.status, r.finish_reason, r.shed_cause,
                  r.generated) for r in engine.finished]


SHED_SCRIPTS = {
    "queue_full": {"engine": dict(max_batch=1, max_queue=3),
                   "submits": [([1, 2], dict(max_new_tokens=4))] * 5},
    "projected_ttft": {"engine": dict(max_batch=1, max_ttft_s=1.0),
                       "ema": 0.5,
                       "submits": [([1, 2], dict(max_new_tokens=6)),
                                   ([3, 4], dict(max_new_tokens=6)),
                                   ([5, 6], dict(max_new_tokens=6))]},
    "deadline_unmeetable": {
        "engine": dict(max_batch=1), "ema": 0.5,
        "submits": [([1, 2], dict(max_new_tokens=20, deadline_s=1.0)),
                    ([1, 2], dict(max_new_tokens=20, deadline_s=60.0))]},
    "no_ema_no_projection": {
        "engine": dict(max_batch=1, max_ttft_s=0.1),
        "submits": [([1], dict(max_new_tokens=30, deadline_s=0.5))]},
}


@pytest.mark.parametrize("name", sorted(SHED_SCRIPTS))
def test_shedding_matches_reference(pair, name):
    jmodel, model = pair
    script = SHED_SCRIPTS[name]
    ours = _shed_trace(_engine, model, chaos.VirtualClock(), script)
    ref = _shed_trace(_jengine, jmodel, jchaos.VirtualClock(), script)
    assert ours == ref
    causes = [c for _, s, c in ours[0] if s == SHED]
    if name.startswith("no_ema"):
        assert causes == [] and ours[0][0][1] == QUEUED
    else:
        assert causes and set(causes) == {name}


def test_shed_requests_are_journaled_and_never_replayed(pair, tmp_path):
    jmodel, model = pair
    engine = _engine(model, max_batch=1, max_queue=1,
                     journal=tmp_path / "j")
    reqs = [engine.submit([1, 2], max_new_tokens=3) for _ in range(3)]
    assert [r.status for r in reqs] == [QUEUED, SHED, SHED]
    engine.step()
    del engine
    state = journal.load(tmp_path / "j" / journal.JOURNAL_NAME)
    assert [state.requests[i].status for i in range(3)] == [None, SHED, SHED]
    revived = _engine(model, max_batch=1, journal=tmp_path / "j")
    assert revived.last_replay["replayed"] == [0]
    revived.run_until_idle()
    assert [r.rid for r in revived.finished] == [0]


# -- the watchdog, the EMA and the close --------------------------------------


class _Stall:
    def __init__(self, naps):
        self._naps = list(naps)

    def on_decode(self):
        if self._naps:
            time.sleep(self._naps.pop(0))

    def on_step_end(self, done_count):
        pass


@pytest.mark.parametrize("naps,timeout,fires", [([0.5], 0.15, 1),
                                                ([], 30.0, 0)])
def test_watchdog_fires_through_an_injected_action(pair, naps, timeout,
                                                   fires):
    jmodel, model = pair
    got = []
    for make, m in ((_engine, model), (_jengine, jmodel)):
        tripped = []
        engine = make(m, max_batch=1, stall_timeout_s=timeout,
                      stall_action=tripped.append,
                      fault_injector=_Stall(naps))
        engine.submit([1, 2, 3], max_new_tokens=3)
        engine.run_until_idle()
        got.append(tripped)
    assert got[0] == got[1]
    assert len(got[0]) == fires
    if fires:
        assert got[0][0] == {"timeout_s": timeout, "bucket": 1, "active": 1}


def test_virtual_clock_drives_the_ema(pair):
    jmodel, model = pair
    emas = []
    for make, m, clock_mod in ((_engine, model, chaos),
                               (_jengine, jmodel, jchaos)):
        engine = make(m, max_batch=1, clock=clock_mod.VirtualClock(),
                      virtual_step_s=0.25)
        engine.submit([1, 2], max_new_tokens=3)
        engine.run_until_idle()
        emas.append(engine._step_ema_s)
    assert emas[0] == emas[1] == pytest.approx(0.25)


def test_close_flushes_the_journal_and_drops_readiness(pair, tmp_path):
    _, model = pair
    metrics.get_registry().reset()
    metrics.enable()
    try:
        engine = _engine(model, journal=tmp_path / "j")
        gauge = metrics.get_registry().gauge("serve.ready")
        assert gauge.value == 1.0
        engine.submit([1, 2], max_new_tokens=2)
        assert engine.journal._buf
        engine.close()
        engine.close()
        assert gauge.value == 0.0 and engine.journal._closed
        assert journal.load(engine.journal.path).requests[0].prompt == [1, 2]
    finally:
        metrics.disable()


# -- the storm on the virtual clock -------------------------------------------


def _storm_args(**kw):
    base = dict(max_queue=None, max_ttft_s=None, max_batch=4, max_len=SEQ,
                min_new=3, max_new=12, vocab=VOCAB, d_model=16, depth=1,
                num_heads=2, seed=0, storm_requests=80, storm_burst=10,
                virtual_step_s=0.05, model_dir=None, policy="continuous",
                temperature=0.0)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("shedding", [True, False])
def test_storm_reports_equal_the_references(shedding):
    ours = chaos.run_storm(_storm_args(device="cpu"), shedding=shedding,
                           target_s=4.0)
    ref = jchaos.run_storm(_storm_args(), shedding=shedding, target_s=4.0)
    assert ours == ref
    if shedding:
        assert ours["shed"] > 0 and ours["p99_latency_virtual_s"] <= 4.0
    else:
        assert ours["shed"] == 0 and ours["p99_latency_virtual_s"] > 4.0


def test_p99_target_is_read_as_the_reference_reads_it():
    assert chaos.bench_p99_target_s() == jchaos.bench_p99_target_s()
    assert chaos.DEFAULT_P99_TARGET_S == jchaos.DEFAULT_P99_TARGET_S


# -- the fault grammar and the injector ---------------------------------------


SPECS = ["engine-crash@req3", "decode-stall@req2:5s", "request-storm@req0",
         "request_storm@req0:x400", "replica_kill@req2:replica1",
         "router-storm@req0:x64", "kill-worker@step5", "kill@step5:rank1",
         "ckpt-fail@epoch0:truncate", "ckpt-fail@epoch1:x2",
         "delay-collective@step3:0.5s", "delay@step*:rank1:always:2.5s",
         "hang-collective@step4:rank0", "slow-input@step2:0.25s:x4",
         "nan_loss@step5", "bitflip@step9:leaf2:replica5",
         "job_kill@job1:abort", "job_hang@job0:5s:step2",
         "engine_crash@req1:attempt2,decode_stall@req0:always",
         '{"faults": [{"kind": "engine-crash", "req": 4, "attempt": null}]}']


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_round_trips_as_the_references(spec):
    ours, ref = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert ours.to_json() == ref.to_json()
    assert list(faults.describe(ours)) == list(jfaults.describe(ref))
    # Through JSON and back (to_json drops None fields in both packages,
    # so an "every attempt" fault comes back as attempt 0 in both).
    again = faults.FaultPlan.parse(ours.dumps())
    assert again.to_json() == jfaults.FaultPlan.parse(ref.dumps()).to_json()


@pytest.mark.parametrize("spec", ["engine_crash@step3", "kill@req3",
                                  "bogus@req1", "engine_crash", "kill@",
                                  "kill@step2:leaf1", "kill@step2:zzz",
                                  "ckpt-fail@epoch0:x0", '{"nope": 1}'])
def test_bad_specs_raise_alike(spec):
    for mod in (faults, jfaults):
        with pytest.raises(ValueError):
            mod.FaultPlan.parse(spec)


def test_exit_registry_matches_reference():
    assert faults.EXIT_CODES == jfaults.EXIT_CODES
    assert faults.EXIT_SERVE_ABORT == 45
    for code in (0, 1, 17, 19, 41, 43, 45, 47, -9, 99):
        assert (faults.classify_exit_code(code)
                == jfaults.classify_exit_code(code))
    assert faults.SERVE_KINDS == jfaults.SERVE_KINDS
    assert faults.FLEET_KINDS == jfaults.FLEET_KINDS
    assert faults.KINDS == jfaults.KINDS


def _injector_trace(mod, spec, monkeypatch, script):
    exits, naps = [], []
    monkeypatch.setattr(mod.os, "_exit", exits.append)
    monkeypatch.setattr(mod.time, "sleep", naps.append)
    fmod = faults if mod is injector else jfaults
    inj = mod.ServeFaultInjector(fmod.FaultPlan.parse(spec).faults)
    trace = []
    for call in script:
        if call is None:
            inj.on_decode()
        else:
            inj.on_step_end(call)
        trace.append((list(exits), list(naps)))
    return trace


@pytest.mark.parametrize("spec", ["engine-crash@req2", "decode-stall@req1:2s",
                                  "decode_stall@req0:0.5s:x2,engine_crash@req3",
                                  "request_storm@req0"])
def test_injector_fires_as_the_references(spec, monkeypatch):
    script = [None, 0, None, 1, None, 2, None, 3, None, 4]
    ours = _injector_trace(injector, spec, monkeypatch, script)
    ref = _injector_trace(jinjector, spec, monkeypatch, script)
    assert ours == ref


def test_env_factory_filters_attempt_and_kind(monkeypatch):
    monkeypatch.setenv(faults.FAULT_PLAN_ENV,
                       "engine-crash@req1, request-storm@req0")
    for mod in (injector, jinjector):
        inj = mod.maybe_serve_injector_from_env(attempt=0)
        assert [f.kind for f in inj.faults] == ["engine_crash"]
        assert mod.maybe_serve_injector_from_env(attempt=1) is None
    monkeypatch.delenv(faults.FAULT_PLAN_ENV)
    assert injector.maybe_serve_injector_from_env(attempt=0) is None
