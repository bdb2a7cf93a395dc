"""The port's serving fleet (``tpu_dist_torch/serve/fleet.py``) against the
reference's, on the CPU.

Both fleets serve the same weights (the reference's ``init``, bridged) and
the same seeded sessioned workload, case for case with
``tests/test_serve_fleet.py``: the router key is the prefix-cache key
(the digests equal the reference's); streams, route counts, failovers,
death records and program dicts equal the reference fleet's and the
uninterrupted solo streams; a 1-replica fleet runs exactly the solo
program set; kills merge rid spaces, resume mid-stream from the journal
and survive a torn journal line; int8 ragged replicas fail over; the storm
settles; autoscale decisions equal the reference's; and the CLI's gates
and route counts equal the reference CLI's.

Each worker's engine is built only once every request has been routed
(``_gated``), so both packages' replicas see the whole workload in their
first step, and the router drains only once the killed replicas are dead:
which requests a kill orphans, and where they go, is then the same in
both.
"""

import io
import json
import contextlib
import threading
import time

import numpy as np
import pytest

from tpu_dist.models.transformer import build_transformer_lm as jbuild
from tpu_dist.resilience import faults as jfaults
from tpu_dist.serve import fleet as jfleet
from tpu_dist.serve import paging as jpaging
from tpu_dist.serve.cli import main as jmain
from tpu_dist.serve.engine import ServeEngine as JServeEngine
from tpu_dist_torch.models import transformer as tr
from tpu_dist_torch.resilience.faults import (FLEET_KINDS, SERVE_KINDS,
                                              FaultPlan, FaultSpec)
from tpu_dist_torch.serve import fleet, paging
from tpu_dist_torch.serve import journal as journal_lib
from tpu_dist_torch.serve.cli import main
from tpu_dist_torch.serve.engine import ServeEngine
from tpu_dist_torch.serve.scheduler import DONE

VOCAB = 32
PAGE = 8


@pytest.fixture(scope="module")
def pair():
    jmodel = jbuild(VOCAB, 32, d_model=16, depth=1, num_heads=2)
    params = jmodel.init(0)["params"]
    model = tr.build_transformer_lm(VOCAB, 32, d_model=16, depth=1,
                                    num_heads=2)
    model.load_jax_params(params)
    return jmodel, model


SIDES = ("jax", "torch")


def _engine(side, model, **kw):
    if side == "jax":
        return JServeEngine(model, max_batch=4, max_len=32, seed=0, **kw)
    return ServeEngine(model, max_batch=4, max_len=32, seed=0, device="cpu",
                       **kw)


def _gated(side, model, gate=None, **engine_kwargs):
    """A replica factory; with ``gate``, each worker builds its engine only
    once the gate is set (every request routed)."""
    def factory(replica, *, journal, fault_injector):
        del replica
        if gate is not None:
            assert gate.wait(60.0)
        return _engine(side, model, journal=journal,
                       fault_injector=fault_injector, **engine_kwargs)
    return factory


def _sessioned_workload(sessions=3, visits=3, *, seed=0):
    """The reference test's workload: shared full-page prefixes, ragged
    suffixes, work-identical sessions."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, VOCAB, size=PAGE).tolist()
                for _ in range(sessions)]
    suffix_lens = [int(rng.integers(1, 4)) for _ in range(visits)]
    budgets = [int(rng.integers(3, 7)) for _ in range(visits)]
    out = []
    for v in range(visits):
        for s in range(sessions):
            suffix = rng.integers(1, VOCAB, size=suffix_lens[v]).tolist()
            out.append((prefixes[s] + suffix, budgets[v]))
    return out


def _solo(side, model, workload, **engine_kwargs):
    solo = _engine(side, model, **engine_kwargs)
    reqs = [solo.submit(p, max_new_tokens=n) for p, n in workload]
    solo.run_until_idle()
    programs = solo.compiled_programs()
    solo.close()
    return [list(r.generated) for r in reqs], programs


def _run(side, model, workload, tmp_path, *, plan=None, engine_kwargs=None,
         **fleet_kwargs):
    """One gated fleet run; returns (fleet, its FleetRequests)."""
    mod = jfleet if side == "jax" else fleet
    plan_mod = jfaults if side == "jax" else None
    if plan is not None:
        plan = (plan_mod.FaultPlan if plan_mod else FaultPlan).parse(plan)
    gate = threading.Event()
    f = mod.ServeFleet(_gated(side, model, gate, **(engine_kwargs or {})),
                       page_size=PAGE, plan=plan,
                       journal_root=str(tmp_path / side), **fleet_kwargs)
    f.start()
    frs = [f.submit(p, max_new_tokens=n) for p, n in workload]
    gate.set()
    # The router fails over only inside drain(): letting every targeted
    # replica die first makes two kills' orphans land on the survivor in
    # one pass, whichever thread died first.
    for spec in (plan.faults if plan is not None else ()):
        if spec.kind == "replica_kill":
            w = f._workers[spec.replica or 0]
            deadline = time.monotonic() + 60.0
            while w.alive() and time.monotonic() < deadline:
                time.sleep(0.005)
    f.drain(timeout_s=120.0)
    f.close()
    return f, frs


def _record(f, frs) -> dict:
    """What the two packages' fleets must agree on. Deaths are sorted by
    replica (two kills race to the router). A survivor that adopts work
    batches it as the adoption lands between its steps, so after a kill
    the survivors' programs are held to the solo program universe (the
    reference CLI's ``no_new_programs`` gate) and the killed replicas'
    programs compared exactly."""
    programs = f.compiled_programs()
    killed = {d["replica"] for d in f.deaths}
    if killed:
        mod = jfleet if isinstance(f, jfleet.ServeFleet) else fleet
        universe = mod._program_universe((1, 2, 4), 32)
        assert all(mod._program_keys(p) <= universe
                   for p in programs.values())
        programs = {i: p for i, p in programs.items() if i in killed}
    return {"streams": [fr.tokens for fr in frs],
            "status": [fr.status for fr in frs],
            "replica": [fr.replica for fr in frs],
            "route": dict(f.route_counts),
            "failover_replayed": f.failover_replayed,
            "deaths": sorted(f.deaths, key=lambda d: d["replica"]),
            "programs": programs}


def _both(pair, workload, tmp_path, **kw) -> tuple:
    """The reference fleet's and the port's runs; their records equal."""
    runs = {side: _run(side, model, workload, tmp_path, **kw)
            for side, model in zip(SIDES, pair)}
    jrec, rec = (_record(*runs[s]) for s in SIDES)
    assert rec == jrec
    return runs["torch"][0], rec


# -- the router key is the cache key ------------------------------------------


class TestPromptDigest:
    def _state(self):
        return paging.PagedKVState(num_pages=16, page_size=4, slots=4,
                                   max_pages=6, bytes_per_token=8)

    @pytest.mark.parametrize("prompt", [list(range(1, 9)),
                                        list(range(1, 8)), [5, 6, 7], []],
                             ids=["full_pages", "ragged", "sub_page",
                                  "empty"])
    def test_digest_equals_the_references(self, prompt):
        assert (paging.PrefixCache.prompt_digest(prompt, 4)
                == jpaging.PrefixCache.prompt_digest(prompt, 4))

    def test_full_page_digest_is_full_cache_key(self):
        st = self._state()
        prompt = list(range(1, 9))
        st.allocator.reserve_pending(2)
        st.begin(0, prompt, 8)
        st.register_prefill(0, prompt)
        key = paging.PrefixCache.prompt_digest(prompt, 4)
        assert key in st.prefix._full
        assert key == paging._digest(
            paging._digest(paging._ROOT, tuple(prompt[:4])),
            tuple(prompt[4:]))

    def test_partial_tail_digest_is_hashed_partial_key(self):
        st = self._state()
        prompt = list(range(1, 8))
        st.allocator.reserve_pending(3)
        st.begin(0, prompt, 9)
        st.register_prefill(0, prompt)
        st.finish(0, prompt)
        ((parent, tail),) = st.prefix._partial.keys()
        assert (paging.PrefixCache.prompt_digest(prompt, 4)
                == paging._digest(parent, tail))
        assert parent == paging.PrefixCache.prompt_digest(prompt[:4], 4)

    def test_page_size_validated(self):
        with pytest.raises(ValueError, match="page_size"):
            paging.PrefixCache.prompt_digest([1, 2], 0)


# -- the fleet fault grammar ---------------------------------------------------


class TestFleetFaultGrammar:
    def test_fleet_kinds_parse_as_the_references(self):
        for text in ("replica_kill@req2:replica1", "replica-kill@req0",
                     "router_storm@req3:x8", "router-storm@req0"):
            (f,) = FaultPlan.parse(text).faults
            (g,) = jfaults.FaultPlan.parse(text).faults
            assert (f.kind, f.req, f.replica, f.count) == (
                g.kind, g.req, g.replica, g.count)
        with pytest.raises(ValueError, match="replica"):
            FaultPlan.parse("engine_crash@req1:replica1")
        assert FLEET_KINDS < SERVE_KINDS

    def test_injector_arms_only_its_replica(self):
        spec = FaultSpec(kind="replica_kill", req=1, replica=1)
        assert not fleet.FleetFaultInjector(0, [spec]).faults
        inj = fleet.FleetFaultInjector(1, [spec])
        inj.on_step_end(0)
        with pytest.raises(fleet.ReplicaKilled):
            inj.on_step_end(1)
        assert inj.fired == [{"kind": "replica_kill", "req": 1,
                              "replica": 1, "done": 1}]

    def test_clis_reject_the_other_grammar(self, capsys):
        assert main(["--chaos", "--plan", "replica_kill@req0",
                     "--device", "cpu"]) == 2
        assert "--fleet" in capsys.readouterr().err
        assert main(["--fleet", "--plan", "engine_crash@req0",
                     "--device", "cpu"]) == 2
        assert "--chaos" in capsys.readouterr().err

    def test_fleet_ctor_rejects_solo_kinds_and_leases(self, pair):
        with pytest.raises(ValueError, match="--chaos"):
            fleet.ServeFleet(_gated("torch", pair[1]),
                             plan=FaultPlan.parse("engine_crash@req0"))
        # A replica leases one slot (item 20); several devices in one
        # process are item 12b.
        with pytest.raises(NotImplementedError, match="item 12b"):
            fleet.ServeFleet(_gated("torch", pair[1]), devices_per_replica=2)
        with pytest.raises(NotImplementedError, match="item 12b"):
            main(["--fleet", "--devices-per-replica", "2", "--device",
                  "cpu"])


# -- routing and parity -----------------------------------------------------------


class TestFleetRouting:
    @pytest.mark.parametrize("replicas", [1, 2])
    def test_parity_affinity_and_program_pin(self, pair, tmp_path,
                                             replicas):
        workload = _sessioned_workload(sessions=4, visits=3)
        baseline, solo_programs = _solo("torch", pair[1], workload)
        assert baseline == _solo("jax", pair[0], workload)[0]
        f, rec = _both(pair, workload, tmp_path, replicas=replicas)
        assert rec["status"] == [DONE] * len(workload)
        assert rec["streams"] == baseline
        if replicas == 1:
            assert rec["programs"] == {0: solo_programs}
            assert rec["route"]["affinity"] > 0
        else:
            assert rec["route"]["affinity"] >= 1
            assert rec["route"]["fallback"] >= 1
            by_session = {}
            for (prompt, _), r in zip(workload, rec["replica"]):
                by_session.setdefault(tuple(prompt[:PAGE]), set()).add(r)
            assert all(len(v) == 1 for v in by_session.values())

    def test_hot_prefix_load_shed_overrides_affinity(self, pair):
        """The reference's decision sequence, replica for replica: the
        burst's routes depend on the router's outstanding counts alone."""
        got = {}
        for side, model in zip(SIDES, pair):
            mod = jfleet if side == "jax" else fleet
            f = mod.ServeFleet(_gated(side, model), replicas=2,
                               page_size=PAGE, affinity_load_slack=3)
            f.start()
            hot = list(range(1, PAGE + 1))
            first = f.submit(hot + [1], max_new_tokens=2)
            burst = [f.submit(hot + [2], max_new_tokens=2) for _ in range(6)]
            f.drain(timeout_s=60.0)
            after = f.submit(hot + [3], max_new_tokens=2)
            f.drain(timeout_s=60.0)
            f.close()
            frs = [first, *burst, after]
            got[side] = ([(fr.route, fr.replica) for fr in frs],
                         dict(f.route_counts), [fr.tokens for fr in frs],
                         [fr.status for fr in frs])
        assert got["torch"] == got["jax"]
        routes, counts, _, status = got["torch"]
        pin = routes[0][1]
        assert [r for r, _ in routes[1:7]] == [
            "affinity", "affinity", "affinity", "overridden", "affinity",
            "overridden"]
        assert routes[-1] == ("affinity", pin)
        assert counts == {"affinity": 5, "fallback": 1,
                          "affinity_overridden": 2}
        assert status == [DONE] * 8

    def test_short_prompts_route_stateless(self, pair, tmp_path):
        workload = [([7, 8, 9], 3)] * 2
        _, rec = _both(pair, workload, tmp_path, replicas=2)
        assert set(rec["replica"]) == {0, 1}
        assert rec["route"] == {"affinity": 0, "fallback": 2,
                                "affinity_overridden": 0}
        assert rec["status"] == [DONE, DONE]


# -- failover ----------------------------------------------------------------


class TestFleetFailover:
    def test_double_kill_merges_rid_spaces_onto_survivor(self, pair,
                                                         tmp_path):
        workload = _sessioned_workload(sessions=3, visits=3)
        baseline, _ = _solo("torch", pair[1], workload)
        f, rec = _both(pair, workload, tmp_path, replicas=3,
                       plan="replica_kill@req0:replica0,"
                            "replica_kill@req0:replica1")
        assert sorted(d["replica"] for d in rec["deaths"]) == [0, 1]
        assert all(d["killed"] for d in rec["deaths"])
        assert rec["failover_replayed"] >= 2
        assert rec["streams"] == baseline
        assert set(f._workers[0].rid_map()) & set(f._workers[1].rid_map())
        frs = list(f.requests.values())
        survivor_rids = [fr.rid for fr in frs if fr.replica == 2]
        assert len(survivor_rids) == len(set(survivor_rids))
        assert f._workers[2].restarts == 0 and not f._workers[2].killed

    def test_mid_stream_kill_resumes_from_journal(self, pair, tmp_path):
        workload = _sessioned_workload(sessions=2, visits=4)
        baseline, _ = _solo("torch", pair[1], workload)
        f, rec = _both(pair, workload, tmp_path, replicas=2,
                       plan="replica_kill@req1:replica0")
        assert [d["replica"] for d in rec["deaths"]] == [0]
        assert rec["failover_replayed"] >= 1
        assert rec["streams"] == baseline
        assert f._workers[1].restarts == 0

    def test_replay_tolerates_torn_trailing_journal_line(self, pair,
                                                         tmp_path):
        prompt = list(range(1, 11))
        dead = _engine("torch", pair[1], journal=str(tmp_path / "dead"))
        req = dead.submit(prompt, max_new_tokens=6)
        for _ in range(3):
            dead.step()
        path = tmp_path / "dead" / journal_lib.JOURNAL_NAME
        with open(path, "a", encoding="utf-8") as fh:
            fh.write('{"kind": "token", "rid"')
        partial = list(journal_lib.load(path).requests[req.rid].tokens)
        assert 0 < len(partial) < 6
        survivor = _engine("torch", pair[1],
                           journal=str(tmp_path / "survivor"))
        adopted = survivor.adopt_request(prompt, generated=partial,
                                         max_new_tokens=6)
        survivor.run_until_idle()
        survivor.close()
        base, _ = _solo("jax", pair[0], [(prompt, 6)])
        assert adopted.status == DONE
        assert list(adopted.generated) == base[0]

    def test_int8_ragged_replicas_fail_over(self, pair, tmp_path):
        quant = dict(paged=True, page_size=PAGE, kv_dtype="int8",
                     ragged=True)
        workload = _sessioned_workload(sessions=2, visits=3)
        baseline, _ = _solo("jax", pair[0], workload, **quant)
        _, rec = _both(pair, workload, tmp_path, replicas=2,
                       plan="replica_kill@req1:replica0",
                       engine_kwargs=quant)
        assert [d["replica"] for d in rec["deaths"]] == [0]
        assert rec["failover_replayed"] >= 1
        assert rec["streams"] == baseline
        assert all(p["paged_decode"] == [4] for p in rec["programs"].values())

    def test_adopt_request_reprefills_int8_midstream(self, pair):
        quant = dict(paged=True, page_size=PAGE, kv_dtype="int8")
        prompt = list(range(1, 11))
        (base,), _ = _solo("jax", pair[0], [(prompt, 6)], **quant)
        survivor = _engine("torch", pair[1], **quant)
        adopted = survivor.adopt_request(prompt, generated=base[:3],
                                         max_new_tokens=6)
        survivor.run_until_idle()
        survivor.close()
        assert adopted.status == DONE
        assert list(adopted.generated) == base

    def test_router_storm_settles(self, pair, tmp_path):
        workload = _sessioned_workload(sessions=2, visits=2)
        f, rec = _both(pair, workload, tmp_path, replicas=2,
                       plan="router_storm@req1:x5", storm_vocab=VOCAB)
        assert f._storm_fired == [{"kind": "router_storm", "req": 1,
                                   "count": 5, "at_index": 1}]
        chaff = [fr for fr in f.requests.values() if fr.chaff]
        assert len(chaff) == 5 and all(fr.status is not None for fr in chaff)
        assert rec["status"] == [DONE] * len(workload)


# -- autoscaling ---------------------------------------------------------------


class TestAutoscale:
    def test_decide_equals_the_references(self):
        kw = dict(min_replicas=1, max_replicas=3, scale_up_outstanding=4,
                  ttft_target_s=0.2, idle_ticks_down=5)
        cases = [
            dict(outstanding={0: 4, 1: 5}, idle_ticks={}, step_ema_s=None,
                 max_batch=4),
            dict(outstanding={0: 3, 1: 0}, idle_ticks={0: 0, 1: 0},
                 step_ema_s=1.0, max_batch=4),
            dict(outstanding={0: 1, 1: 0}, idle_ticks={0: 0, 1: 2},
                 step_ema_s=0.01, max_batch=4),
            dict(outstanding={0: 0, 1: 0}, idle_ticks={0: 5, 1: 5},
                 step_ema_s=0.01, max_batch=4),
        ]
        got = [fleet.AutoscalePolicy(**kw).decide(**c) for c in cases]
        assert got == [jfleet.AutoscalePolicy(**kw).decide(**c)
                       for c in cases]
        assert [g[0] for g in got] == ["up", "up", "hold", "down"]
        assert got[3][1] == 1
        floor = dict(outstanding={0: 99, 1: 99}, idle_ticks={0: 99, 1: 99},
                     step_ema_s=1.0, max_batch=1)
        assert fleet.AutoscalePolicy(min_replicas=2, max_replicas=2).decide(
            **floor)[0] == "hold"

    def test_fleet_scales_up_then_retires_idle(self, pair):
        got = {}
        for side, model in zip(SIDES, pair):
            mod = jfleet if side == "jax" else fleet
            f = mod.ServeFleet(_gated(side, model), replicas=2,
                               page_size=PAGE)
            f.start()
            workload = _sessioned_workload(sessions=2, visits=3)
            frs = [f.submit(p, max_new_tokens=n) for p, n in workload]
            pol = mod.AutoscalePolicy(min_replicas=2, max_replicas=3,
                                      scale_up_outstanding=2,
                                      idle_ticks_down=3)
            f._autoscale = pol
            first = [f.autoscale_tick(), sorted(f._workers),
                     f.autoscale_tick()]
            f.drain(timeout_s=120.0)
            for _ in range(2 * pol.idle_ticks_down):
                f.autoscale_tick()
            retired = f.autoscale_events[-1]["replica"]
            assert f._workers[retired].join(20.0)
            alive = sorted(f.alive_indices())
            f.close()
            got[side] = (first, [(e["action"], e["replica"])
                                 for e in f.autoscale_events], alive,
                         [fr.tokens for fr in frs],
                         [fr.status for fr in frs])
        assert got["torch"] == got["jax"]
        first, events, alive, _, status = got["torch"]
        assert first == ["up", [0, 1, 2], None]
        assert [a for a, _ in events] == ["up", "down"]
        assert alive == sorted({0, 1, 2} - {events[-1][1]})
        assert status == [DONE] * 6


# -- the CLI -------------------------------------------------------------------


def _cli(fn, argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    text = out.getvalue()
    report = json.loads(text[text.index("\n{") + 1:text.rindex("\n}") + 2])
    return rc, report


@pytest.mark.parametrize("plan", [None, "replica_kill@req2:replica0"],
                         ids=["clean", "kill"])
def test_fleet_cli_gates_and_routes_equal_the_references(plan):
    argv = ["--fleet", "--requests", "12"]
    if plan:
        argv += ["--plan", plan]
    rc, report = _cli(main, argv + ["--device", "cpu"])
    jrc, jreport = _cli(jmain, argv)
    assert rc == jrc == 0
    assert report["gates"] == jreport["gates"]
    assert all(report["gates"].values())
    assert report["route"] == jreport["route"]
    assert report["device"] == "cpu" and report["certified_ties"] == []
    if plan:
        assert {"kill_fired", "failover_replayed"} <= set(report["gates"])
        assert [d["fired"] for d in report["deaths"]] == [
            d["fired"] for d in jreport["deaths"]]
