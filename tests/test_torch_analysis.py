"""The port's shardcheck (``tpu_dist_torch.analysis``) against the
reference's (``tpu_dist.analysis``): the catalogue, the functions both
packages share (on the same inputs, drawn by hypothesis), every rule over
the port's flagging and clean fixtures, the AST passes on the reference's
fixtures that import no JAX, the CLI's contract, and the port's tree under
its own checker. Assertions are on rule IDs and lines, never message
text. The recorded entry points are ``test_torch_analysis_entries.py``'s.
"""

import contextlib
import io
import json
import pathlib
import threading

import pytest
from hypothesis import given, settings, strategies as st

from tpu_dist.analysis import baseline as jbaseline
from tpu_dist.analysis import concurrency as jconcurrency
from tpu_dist.analysis import costmodel as jcost
from tpu_dist.analysis import determinism as jdeterminism
from tpu_dist.analysis import liveness as jliveness
from tpu_dist.analysis import report as jreport
from tpu_dist.analysis import rules as jrules
from tpu_dist_torch.analysis import RULES, lint_file
from tpu_dist_torch.analysis import baseline, concurrency, costmodel
from tpu_dist_torch.analysis import determinism, liveness, report, rules
from tpu_dist_torch.analysis.cli import cost_main, main as shardcheck_main
from tpu_dist_torch.cluster import liveness as port_liveness

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "shardcheck_torch"
BAD, GOOD = FIXTURES / "bad", FIXTURES / "good"
COST, BASELINES = FIXTURES / "cost", FIXTURES / "baselines"
REF_FIXTURES = ROOT / "tests" / "fixtures" / "shardcheck"
PORT_BASELINE = ROOT / "tpu_dist_torch" / "analysis" / "ANALYSIS_BASELINE.json"

#: Rules the port keeps in its catalogue only as decisions (ROADMAP.md
#: "Not ported, by decision").
DECISIONS = {"SC303"}

#: Each bad fixture -> (the CLI mode that checks it, exactly its rules).
BAD_FIXTURES = {
    "wrong_axis_name.py": ("check", {"SC101"}),
    "rank_mismatch_spec.py": ("check", {"SC102"}),
    "side_effect_in_capture.py": ("check", {"SC103"}),
    "captured_output_reuse.py": ("check", {"SC104"}),
    "swallowed_liveness.py": ("check", {"SC105"}),
    "branch_collective.py": ("check", {"SC201"}),
    "while_collective.py": ("check", {"SC202"}),
    "unpaired_send.py": ("check", {"SC203"}),
    "thread_unlocked_write.py": ("--concurrency", {"SC401"}),
    "blocking_join_under_lock.py": ("--concurrency", {"SC402"}),
    "collective_on_thread.py": ("--concurrency", {"SC403"}),
    "exit_under_lock.py": ("--concurrency", {"SC404"}),
    "rank_divergent_barrier.py": ("--concurrency", {"SC501"}),
    "unbounded_wait.py": ("--concurrency", {"SC502"}),
    "torn_protocol_write.py": ("--concurrency", {"SC503"}),
    "stale_suppression.py": ("--concurrency", {"SC901"}),
    "nondet_seed_taint.py": ("--determinism", {"SC601"}),
    "seed_replayed.py": ("--determinism", {"SC602"}),
    "unsorted_scan_order.py": ("--determinism", {"SC603"}),
    "fold_constant_collision.py": ("--determinism", {"SC604"}),
    "unordered_float_sum.py": ("--determinism", {"SC605"}),
}

#: The cost gate's fixtures: module:cost_entry's one all-reduce of a
#: float32 [16, 8] over 4 ranks is 2 * 3/4 * 512 = 768 bytes.
COST_ARGS = [str(COST), "--entries", "module:cost_entry"]
RNG_ARGS = [str(COST), "--entries", "module:rng_entry"]

#: The reference's concurrency and determinism fixtures that import no
#: JAX: both packages' passes must find the same rules on the same lines.
COMMON_GROUND = sorted(
    p for d in ("bad", "good") for p in (REF_FIXTURES / d).glob("*.py")
    if "jax" not in p.read_text())


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _cli_json(argv, fn=shardcheck_main):
    rc, out = _run(fn, argv + ["--json"])
    return rc, json.loads(out)


def _ids(payload):
    return {f["rule_id"] for f in payload["findings"]}


def _mode_args(mode):
    return [] if mode == "check" else [mode]


# -- the catalogue -----------------------------------------------------------------

def test_catalogue_has_the_references_ids_slugs_and_severities():
    assert set(RULES) == set(jrules.RULES)
    for rid, rule in RULES.items():
        ref = jrules.RULES[rid]
        assert (rule.name, int(rule.severity)) == (ref.name,
                                                   int(ref.severity)), rid
    assert {r for r, rule in RULES.items() if rule.decision} == DECISIONS


def test_list_rules_names_every_rule_and_the_decisions():
    rc, out = _run(shardcheck_main, ["--list-rules"])
    assert rc == 0
    for rid in RULES:
        assert f"{rid} [" in out
    assert out.count("not ported, by decision") == len(DECISIONS)


# -- the functions both packages share ---------------------------------------------

#: The port's recorded c10d op for each reference primitive.
OP_PAIRS = [("psum", "allreduce_"), ("pmax", "allreduce_"),
            ("all_gather", "allgather_"), ("all_gather", "_allgather_base_"),
            ("all_to_all", "alltoall_base_"),
            ("psum_scatter", "reduce_scatter_"),
            ("reduce_scatter", "_reduce_scatter_base_"),
            ("ppermute", "send"), ("pbroadcast", "barrier")]


@settings(max_examples=60, deadline=None)
@given(pair=st.sampled_from(OP_PAIRS), payload=st.integers(0, 1 << 34),
       size=st.integers(1, 64))
def test_comm_bytes_is_the_references_on_the_same_inputs(pair, payload,
                                                         size):
    ref_op, port_op = pair
    want = jcost.comm_bytes(ref_op, payload, size)
    assert costmodel.comm_bytes(port_op, payload, size) == want
    assert costmodel.comm_bytes(ref_op, payload, size) == want
    assert costmodel.comm_bytes(f"c10d.{port_op}.default", payload,
                                size) == want


_AXIS = st.text("abcdexyz_", min_size=1, max_size=6)
_MESH_PART = st.one_of(
    st.builds(lambda a, n: f"{a}={n}", _AXIS, st.integers(-2, 64)),
    st.builds(lambda a, n, bw, lat: f"{a}={n}:{bw}:{lat}", _AXIS,
              st.integers(1, 16), st.floats(-1, 900, allow_nan=False),
              st.floats(-1, 10, allow_nan=False)),
    st.text("=:,xy1", max_size=6))


@settings(max_examples=80, deadline=None)
@given(parts=st.lists(_MESH_PART, max_size=4))
def test_parse_mesh_is_the_references_on_the_same_inputs(parts):
    spec = ",".join(parts)

    def outcome(fn):
        try:
            return fn(spec)
        except ValueError:
            return ValueError

    assert outcome(costmodel.parse_mesh) == outcome(jcost.parse_mesh)
    got, want = (outcome(costmodel.parse_mesh_links),
                 outcome(jcost.parse_mesh_links))
    if want is ValueError:
        assert got is ValueError
    else:
        assert got[0] == want[0]
        assert {k: (v.bandwidth_gbps, v.latency_us)
                for k, v in got[1].items()} == {
            k: (v.bandwidth_gbps, v.latency_us)
            for k, v in want[1].items()}


_RULE_IDS = sorted(RULES)
_LINE = st.one_of(
    st.text(max_size=30),
    st.builds(lambda code, ids, tail: f"{code}  # shardcheck: disable="
              f"{','.join(ids)}{tail}", st.text("xy = 1()", max_size=8),
              st.lists(st.sampled_from(_RULE_IDS + ["all", "ALL"]),
                       min_size=1, max_size=3),
              st.sampled_from(["", " -- why", " - why", "#", " why"])))


def _key(findings):
    return sorted((f.rule_id, f.path, f.line, f.col, f.message)
                  for f in findings)


@settings(max_examples=60, deadline=None)
@given(lines=st.lists(_LINE, min_size=1, max_size=6),
       hits=st.lists(st.tuples(st.sampled_from(_RULE_IDS),
                               st.integers(1, 7)), max_size=8),
       evaluated=st.sets(st.sampled_from(_RULE_IDS)))
def test_suppressions_are_the_references_on_the_same_inputs(lines, hits,
                                                            evaluated):
    for line in lines:
        assert rules.suppressions_for_line(line) == \
            jrules.suppressions_for_line(line)
    src = {"f.py": lines}
    port = [rules.Finding(r, "f.py", n, 0, "m") for r, n in hits]
    ref = [jrules.Finding(r, "f.py", n, 0, "m") for r, n in hits]
    assert _key(rules.apply_suppressions(port, src)) == _key(
        jrules.apply_suppressions(ref, src))
    assert _key(rules.stale_suppressions(port, src, evaluated)) == _key(
        jrules.stale_suppressions(ref, src, evaluated))


@settings(max_examples=40, deadline=None)
@given(hits=st.lists(st.tuples(st.sampled_from(_RULE_IDS),
                               st.integers(1, 99)), max_size=6),
       fail_on=st.sampled_from(["error", "warning", "info", "never"]))
def test_exit_code_and_json_are_the_references_on_the_same_inputs(
        hits, fail_on):
    port = [rules.Finding(r, "p.py", n, 1, "m") for r, n in hits]
    ref = [jrules.Finding(r, "p.py", n, 1, "m") for r, n in hits]
    assert report.exit_code(port, fail_on=fail_on) == jreport.exit_code(
        ref, fail_on=fail_on)
    assert report.to_json_dict(port, paths=["p.py"], fail_on=fail_on) == \
        jreport.to_json_dict(ref, paths=["p.py"], fail_on=fail_on)


class _Report:
    def __init__(self, comm, peak):
        self.total_comm_bytes, self.peak_hbm_bytes = comm, peak


@settings(max_examples=40, deadline=None)
@given(now=st.dictionaries(st.sampled_from("abcd"), st.tuples(
           st.integers(0, 1 << 20), st.integers(0, 1 << 20)), max_size=4),
       base=st.dictionaries(st.sampled_from("abce"), st.tuples(
           st.integers(0, 1 << 20), st.integers(0, 1 << 20),
           st.one_of(st.none(), st.integers(0, 1 << 21))), max_size=4),
       tol=st.one_of(st.none(), st.floats(0, 50, allow_nan=False)))
def test_baseline_compare_is_the_references_on_the_same_inputs(now, base,
                                                               tol):
    reports = {k: _Report(*v) for k, v in now.items()}
    data = {"schema": "x", "tolerance_pct": 10.0, "entries": {
        k: {"total_comm_bytes": c, "peak_hbm_bytes": p,
            **({} if b is None else {"hbm_budget_bytes": b})}
        for k, (c, p, b) in base.items()}}
    got = baseline.compare(reports, data, tolerance_pct=tol, path="B")
    want = jbaseline.compare(reports, data, tolerance_pct=tol, path="B")
    assert [(f.rule_id, f.path, f.line) for f in got] == [
        (f.rule_id, f.path, f.line) for f in want]
    built = baseline.build(reports, mesh={"data": 2}, previous=data)
    assert built["entries"] == jbaseline.build(
        reports, mesh={"data": 2}, previous=data)["entries"]


# -- the rules over the port's fixtures ----------------------------------------------

@pytest.mark.parametrize("name", sorted(BAD_FIXTURES))
def test_bad_fixture_flags_exactly_its_rule(name):
    mode, want = BAD_FIXTURES[name]
    rc, payload = _cli_json([str(BAD / name), *_mode_args(mode)])
    assert _ids(payload) == want
    severe = any(RULES[r].severity >= rules.Severity.ERROR for r in want)
    assert rc == int(severe)


@pytest.mark.parametrize("mode", ["check", "--concurrency",
                                  "--determinism"])
def test_good_fixtures_are_clean_in_every_mode(mode):
    rc, payload = _cli_json([str(GOOD), "--strict", *_mode_args(mode)])
    assert (rc, payload["findings"]) == (0, [])


@pytest.mark.parametrize("name", sorted(p.name for p in GOOD.glob("*.py")))
def test_good_fixture_is_clean_alone(name):
    assert lint_file(str(GOOD / name)) == []
    for mode in ("--concurrency", "--determinism"):
        rc, payload = _cli_json([str(GOOD / name), mode, "--strict",
                                 "--no-trace"])
        assert (rc, payload["findings"]) == (0, []), mode


def test_cost_gate_flags_sc301_sc302_and_sc610_and_passes_clean():
    flagged = set()
    for name, want in (("cost_regressed.json", {"SC301"}),
                       ("cost_low_hbm.json", {"SC302"})):
        rc, payload = _cli_json(COST_ARGS + [
            "--baseline", str(BASELINES / name), "--strict"], cost_main)
        assert (rc, _ids(payload)) == (1, want)
        flagged |= want
    rc, payload = _cli_json(RNG_ARGS + [
        "--baseline", str(BASELINES / "rng_free.json")], cost_main)
    assert (rc, _ids(payload)) == (1, {"SC610"})
    entry = payload["entries"]["module:rng_entry"]
    assert entry["total_comm_bytes"] == 0
    rc, payload = _cli_json(COST_ARGS + [
        "--baseline", str(BASELINES / "cost_good.json"), "--strict"],
        cost_main)
    assert (rc, payload["findings"]) == (0, [])
    site, = payload["entries"]["module:cost_entry"]["collectives"]
    assert (site["op"], site["axis_size"], site["payload_bytes"],
            site["bytes"]) == ("allreduce_", 4, 512, 768)
    rc, payload = _cli_json(RNG_ARGS + [
        "--baseline", str(BASELINES / "rng_recorded.json"), "--strict"],
        cost_main)
    assert (rc, payload["findings"]) == (0, [])


def test_every_rule_the_port_keeps_has_flagging_and_clean_coverage():
    flagged = set()
    for mode, want in BAD_FIXTURES.values():
        flagged |= want
    # SC301, SC302, SC610: the cost fixtures against their baselines
    # (test_cost_gate_flags_sc301_sc302_and_sc610_and_passes_clean).
    flagged |= {"SC301", "SC302", "SC610"}
    # SC900 is the degradation rule; its flagging cases are synthetic
    # (the unparseable file and the entry that raises, below).
    kept = {r for r, rule in RULES.items() if not rule.decision}
    assert kept - {"SC900"} == flagged
    assert all((BAD / name).exists() for name in BAD_FIXTURES)
    assert len(list(GOOD.glob("*.py"))) >= 15


# -- the AST passes on common ground -------------------------------------------------

def _pass_ids(mod_conc, mod_live, mod_det, path):
    project = mod_conc.build_project([str(path)])
    found = (mod_conc.check_project(project)
             + mod_live.check_project(project)
             + mod_det.check_project(project))
    return sorted((f.rule_id, f.line) for f in found)


@pytest.mark.parametrize("path", COMMON_GROUND, ids=lambda p: p.name)
def test_ast_passes_find_the_references_findings_on_common_ground(path):
    assert len(COMMON_GROUND) >= 15
    assert _pass_ids(concurrency, liveness, determinism, path) == \
        _pass_ids(jconcurrency, jliveness, jdeterminism, path)


# -- the CLI's contract ----------------------------------------------------------------

def test_suppression_comment_silences_a_rule(tmp_path):
    f = tmp_path / "suppressed.py"
    f.write_text(
        "from tpu_dist_torch.parallel import mesh as mesh_lib\n"
        "def g(mesh):\n"
        "    return mesh_lib.axis_group(mesh, 'nope')"
        "  # shardcheck: disable=SC101 -- test axis, mesh built elsewhere\n")
    assert lint_file(str(f)) == []
    f.write_text(f.read_text().split("  #")[0] + "\n")
    assert {x.rule_id for x in lint_file(str(f))} == {"SC101"}


def test_unparseable_file_degrades_to_sc900(tmp_path):
    f = tmp_path / "broken.py"
    f.write_text("def oops(:\n")
    findings = lint_file(str(f))
    assert [x.rule_id for x in findings] == ["SC900"]
    assert report.exit_code(findings, fail_on="error") == 0
    assert report.exit_code(findings, fail_on="info") == 1


def test_an_entry_that_raises_degrades_to_sc900_naming_its_class(tmp_path):
    f = tmp_path / "raising_entry.py"
    f.write_text("def shardcheck_entry():\n"
                 "    raise KeyError('no such layer')\n")
    rc, payload = _cli_json([str(f)])
    finding, = payload["findings"]
    assert (rc, finding["rule_id"]) == (0, "SC900")
    assert "KeyError" in finding["message"]


def test_json_github_and_fail_on_never(tmp_path):
    rc, payload = _cli_json([str(BAD / "wrong_axis_name.py")])
    assert rc == 1 and payload["tool"] == "shardcheck"
    assert payload["counts"]["error"] == 1
    rc, out = _run(shardcheck_main, [str(BAD / "wrong_axis_name.py"),
                                     "--format", "github"])
    assert rc == 1 and out.startswith("::error file=") and "[SC101]" in out
    rc, _ = _run(shardcheck_main, [str(BAD / "wrong_axis_name.py"),
                                   "--fail-on", "never"])
    assert rc == 0


def test_rules_filter_narrows_a_mode():
    rc, payload = _cli_json([str(BAD), "--concurrency", "--rules",
                             "SC402"])
    assert _ids(payload) == {"SC402"} and rc == 1
    with pytest.raises(SystemExit):
        _run(shardcheck_main, ["--rules", "SC999", str(GOOD)])


# -- the port's own tree -----------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--concurrency", "--strict"], ["--determinism", "--strict"],
    ["--fail-on", "error", "--no-trace"]], ids=["concurrency",
                                                "determinism", "lint"])
def test_the_ports_tree_is_clean_under_its_own_checker(argv):
    rc, payload = _cli_json([str(ROOT / "tpu_dist_torch"), *argv])
    assert (rc, [f for f in payload["findings"]
                 if f["rule_id"] != "SC900"]) == (0, [])


def test_every_ported_suppression_gives_its_reason():
    for path in (ROOT / "tpu_dist_torch").rglob("*.py"):
        if path.parent.name == "analysis":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if rules.suppressions_for_line(line) is not None:
                assert " -- " in line.split("shardcheck:")[1], (path, i)


def test_a_probe_round_begun_before_a_reset_condemns_no_peer(monkeypatch):
    """A reform resets the liveness monitor while its probe thread may be
    inside a round against the old group: that round's verdict must not
    condemn a peer of the reformed group (the port's monitor wrote the
    verdict state from two threads with no lock)."""
    monitor = port_liveness.LivenessMonitor(interval_s=0.01,
                                            rejoin_window_s=0.0)
    entered, release = threading.Event(), threading.Event()

    def slow_probe(timeout_s):
        entered.set()
        release.wait(5)
        return [1]

    monkeypatch.setattr(port_liveness, "check_peer_health", slow_probe)
    monkeypatch.setattr(monitor, "_group_gone", lambda world: False)
    thread = threading.Thread(target=monitor._loop, args=(None,),
                              daemon=True)
    thread.start()
    assert entered.wait(5)
    monitor.reset()  # the reform, on the main thread
    release.set()
    monitor._stop.set()
    thread.join(5)
    assert not thread.is_alive()
    assert not monitor.failed and monitor.dead_peers == []
    # A round that begins after the reset still condemns a dead peer.
    assert monitor._observe([1]) and monitor.dead_peers == [1]


def test_the_ports_baseline_is_committed_and_gates_clean():
    data = baseline.load(str(PORT_BASELINE))
    assert data["schema"] == "tpu_dist_torch.analysis/cost-v1"
    assert len(data["entries"]) == 28 and set(data["rng"]) == set(
        data["entries"])
