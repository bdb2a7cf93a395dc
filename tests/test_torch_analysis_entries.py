"""The port's recorded entry points against the reference's traced ones.

``tpu_dist_torch/analysis/trace_checks.py`` registers a counterpart of
each of the reference's 28 ``ENTRY_POINTS`` under the same name, recorded
on the CPU on fake process groups. Every one records with no finding;
where an entry communicates, its collective launches (kind, payload
bytes, count) and its modeled comm bytes equal the reference's trace, or
differ by design with both numbers pinned here and the reason in
ROADMAP.md's port notes.
"""

import json
import pathlib

import pytest

from tpu_dist.analysis import costmodel as jcost
from tpu_dist.analysis import jaxpr_checks
from tpu_dist_torch.analysis import costmodel, trace_checks
from tpu_dist_torch.analysis.cli import cost_main

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_BASELINE = ROOT / "tpu_dist_torch" / "analysis" / "ANALYSIS_BASELINE.json"

#: Communicating entries whose launches differ by design: (the reference's
#: modeled comm bytes, the port's, why).
BY_DESIGN = {
    "pipeline_parallel.gpipe_schedule": (
        120, 96, "the reference ppermutes on all M + S - 1 ticks; the "
        "port's stage 0 sends only on its M valid ticks"),
    "pipeline_1f1b.one_f_one_b": (
        160, 3524, "the reference schedules scalar stage functions; the "
        "port's 1F1B drives a pipelined two-block LM (activation sends "
        "and the pipe axis's all-reduce of the replicated leaves)"),
    "parallel.sequence.ring_attention": (
        2048, 2304, "the reference shifts K and V on all P steps of its "
        "scan; the port shifts P - 1 times and gathers the output "
        "sequence (its ring_attention takes and returns the whole "
        "sequence)"),
    "parallel.expert.moe_layer": (
        970, 3466, "the port's all_to_all_single moves [G, E, C, d] slabs "
        "with every empty capacity slot, and gathers the tokens of the "
        "expert axis's group"),
    "training.integrity.audit_checksum_sharded": (
        0, 448, "one device a process: the checksum table crosses the "
        "ranks in a gather, where the reference's devices share one "
        "process"),
}

#: Communicating entries whose launches equal the reference's.
EQUAL = ("training.trainer.train_step_bucketed",
         "parallel.tensor.megatron_block")

#: The reference's primitives and the port's c10d ops by kind; a recv is
#: the sender's bytes, priced at the send.
_KIND = {"psum": "all_reduce", "allreduce_": "all_reduce",
         "all_gather": "all_gather", "allgather_": "all_gather",
         "_allgather_base_": "all_gather", "all_to_all": "all_to_all",
         "alltoall_base_": "all_to_all", "ppermute": "send",
         "send": "send"}


@pytest.fixture(scope="module")
def recorded():
    recs, findings = trace_checks.record_entry_points()
    return recs, findings


@pytest.fixture(scope="module")
def reference(eight_devices):
    names = set(BY_DESIGN) | set(EQUAL)
    traced, findings = jaxpr_checks.trace_entry_points(names)
    assert findings == []
    return {n: jcost.analyze_jaxpr(c, entry=n) for n, c in traced.items()}


def _launches(report) -> list:
    return sorted((_KIND[c.op], c.payload_bytes, c.multiplier)
                  for c in report.collectives if c.op in _KIND)


def test_registry_is_the_references_name_for_name():
    assert list(trace_checks.ENTRY_POINTS) == list(jaxpr_checks.ENTRY_POINTS)


def test_every_entry_records_with_no_finding(recorded):
    recs, findings = recorded
    assert set(recs) == set(trace_checks.ENTRY_POINTS) and findings == []
    for name, by_seed in recs.items():
        assert set(by_seed) == set(trace_checks.SEEDS)
        assert trace_checks.check_trace(by_seed, label=name) == [], name


@pytest.mark.parametrize("name", EQUAL)
def test_collectives_equal_the_references(recorded, reference, name):
    port = costmodel.analyze_trace(recorded[0][name][0][0], entry=name)
    assert _launches(port) == _launches(reference[name])
    assert port.total_comm_bytes == reference[name].total_comm_bytes > 0


@pytest.mark.parametrize("name", sorted(BY_DESIGN))
def test_collectives_that_differ_by_design_are_pinned(recorded, reference,
                                                      name):
    ref_bytes, port_bytes, _why = BY_DESIGN[name]
    port = costmodel.analyze_trace(recorded[0][name][0][0], entry=name)
    assert reference[name].total_comm_bytes == ref_bytes
    assert port.total_comm_bytes == port_bytes


def test_every_other_entry_is_collective_free_in_both(recorded):
    with open(ROOT / "ANALYSIS_BASELINE.json") as f:
        ref = json.load(f)["entries"]
    for name, by_seed in recorded[0].items():
        if name in BY_DESIGN or name in EQUAL:
            continue
        assert by_seed[0][0].comm_events() == [], name
        assert ref[name]["total_comm_bytes"] == 0, name


def test_ranks_pair_their_sends_and_share_their_sequences(recorded):
    ring = recorded[0]["parallel.sequence.ring_attention"][0]
    sends = sum(e.op == "send" for r in ring.values() for e in r.events)
    recvs = sum(e.op == "recv_" for r in ring.values() for e in r.events)
    assert sends == recvs == 4 * 6
    moe = recorded[0]["parallel.expert.moe_layer"][0]
    assert len({tuple(e.op for e in r.collectives())
                for r in moe.values()}) == 1


def test_baseline_and_registry_are_one_to_one_and_the_gate_passes(capsys):
    with open(PORT_BASELINE) as f:
        data = json.load(f)
    assert set(data["entries"]) == set(trace_checks.ENTRY_POINTS)
    assert set(data["rng"]) == set(trace_checks.ENTRY_POINTS)
    rc = cost_main(["--baseline", str(PORT_BASELINE), "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert (rc, payload["findings"]) == (0, [])
    assert payload["entries"]["parallel.tensor.megatron_block"][
        "total_comm_bytes"] == 768
