"""The port's observe layer (``tpu_dist_torch/observe``) against the
reference's, on the CPU, case for case with ``tests/test_observe.py``.

Quantiles, the registry and straggler verdicts equal the reference's on
the same inputs; a series either package writes reads in the other and
one snapshot renders to the same Prometheus text; the step timer divides
by the execution's steps; the collective hook counts calls, bytes and
phases, and the port's wrappers fire it as the reference's do; a
``Telemetry`` fit records the step and collective families and restores
the hook, the timer and the registry's state; ``$TPU_DIST_OBSERVE_DIR``
arms it; the CLI's demo, summarize, diff and their anti-vacuity exits;
``JSONLogger`` writes the reference's lines; ``LazyLogs`` read the card
once; ``serve --bench`` exports its snapshot; ``Supervisor(observe_dir=)``
gives each rank its own series; and two gloo workers exchange their step
times, the chief naming the slowed rank.
"""

import json
import os
import pathlib
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from tpu_dist.models import Dense as JDense
from tpu_dist.models import Sequential as JSequential
from tpu_dist.observe import exporters as jexporters
from tpu_dist.observe import metrics as jmetrics
from tpu_dist.observe import straggler as jstraggler
from tpu_dist.ops import SGD as JSGD
from tpu_dist.ops import SparseCategoricalCrossentropy as JSCCE
from tpu_dist.training.callbacks import JSONLogger as JJSONLogger
from tpu_dist_torch.data import Dataset
from tpu_dist_torch.models import Dense, Sequential
from tpu_dist_torch.observe import exporters, metrics, straggler
from tpu_dist_torch.observe.metrics import MetricsRegistry, quantile
from tpu_dist_torch.observe.telemetry import (OBSERVE_DIR_ENV, StepTimer,
                                              Telemetry, active_step_timer,
                                              maybe_telemetry_from_env,
                                              registry_collective_hook)
from tpu_dist_torch.ops import SGD, SparseCategoricalCrossentropy
from tpu_dist_torch.parallel import collectives
from tpu_dist_torch.resilience import events
from tpu_dist_torch.training.callbacks import JSONLogger, LazyLogs

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Fit losses against the reference's (the port's training tolerance).
TOL = dict(atol=2e-5, rtol=2e-5)


def _model(lr=0.2, seed=0):
    m = Sequential([Dense(16, activation="relu"), Dense(4)],
                   input_shape=(8,))
    m.compile(loss=SparseCategoricalCrossentropy(from_logits=True),
              optimizer=SGD(learning_rate=lr), device="cpu")
    return m


def _pair(lr=0.2):
    jm = JSequential([JDense(16, activation="relu"), JDense(4)],
                     input_shape=(8,))
    variables = jax.tree_util.tree_map(np.asarray, jm.init(0))
    jm.compile(loss=JSCCE(from_logits=True), optimizer=JSGD(learning_rate=lr))
    tm = _model(lr)
    tm.load_jax_variables(variables)
    return jm, tm


def _xy(n=64, seed=1):
    rng = np.random.default_rng(seed)
    y = rng.integers(4, size=n)
    x = (np.eye(8)[y * 2] + rng.normal(0, 0.1, (n, 8))).astype(np.float32)
    return x, y.astype(np.int64)


def _ds(n=64, batch=32, seed=1):
    return Dataset.from_tensor_slices(_xy(n, seed)).batch(batch)


# -- quantiles and the registry ---------------------------------------------------


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.95, 0.99, 1.0])
def test_quantile_equals_the_references(q):
    vals = [float(v) for v in range(1, 101)]
    assert quantile(vals, q) == jmetrics.quantile(vals, q)
    assert quantile([7.0], q) == 7.0


def test_quantile_errors():
    with pytest.raises(ValueError):
        quantile([], 0.5)
    with pytest.raises(ValueError):
        quantile([1.0], 1.5)


def test_distribution_snapshot_equals_the_references():
    got = []
    for mod in (metrics, jmetrics):
        d = mod.MetricsRegistry(enabled=True, reservoir_size=64).distribution(
            "t")
        for v in range(10_000):
            d.observe(float(v))
        got.append(d.snapshot())
    assert got[0] == got[1]
    assert got[0]["count"] == 10_000 and got[0]["sum"] == sum(range(10_000))


def test_registry_disabled_singletons_and_helpers():
    r = MetricsRegistry(enabled=False)
    r.counter("c").inc(5)
    r.gauge("g").set(1.0)
    r.distribution("d").observe(3.0)
    snap = r.snapshot()
    assert (snap["counters"]["c"], snap["gauges"]["g"],
            snap["distributions"]["d"]["count"]) == (0, None, 0)
    r.enable()
    assert r.counter("x") is r.counter("x")
    r.counter("x").inc(2)
    r.reset()
    assert r.counter("x").value == 0
    reg = metrics.get_registry()
    was = reg.enabled
    reg.enable()
    try:
        reg.reset()
        metrics.inc("helper.c", 2)
        metrics.set_gauge("helper.g", 4.0)
        metrics.observe_value("helper.d", 1.0)
        snap = reg.snapshot()
        assert snap["counters"]["helper.c"] == 2
        assert snap["gauges"]["helper.g"] == 4.0
    finally:
        reg.reset()
        if not was:
            reg.disable()


# -- stragglers -------------------------------------------------------------------


@pytest.mark.parametrize("times", [[0.1, 0.1, 0.35, 0.1], [0.1] * 8, [5.0],
                                   [1e-6, 1e-6, 1e-5], [0.2, 0.05, 0.05],
                                   []])
@pytest.mark.parametrize("threshold", [2.0, 1.5])
def test_straggler_verdicts_equal_the_references(times, threshold):
    got = straggler.detect_stragglers(times, threshold=threshold)
    want = jstraggler.detect_stragglers(times, threshold=threshold)
    assert [v.to_dict() for v in got] == [v.to_dict() for v in want]


def test_straggler_threshold_and_heartbeat():
    with pytest.raises(ValueError):
        straggler.detect_stragglers([0.1, 0.2], threshold=1.0)
    clock = [100.0]
    mon = straggler.HeartbeatMonitor(3, clock=lambda: clock[0])
    mon.beat(0)
    clock[0] = 105.0
    mon.beat(1)
    clock[0] = 109.0
    assert mon.stale_ranks(5.0) == [0, 2]
    assert mon.stale_ranks(20.0) == []


# -- exporters -----------------------------------------------------------------


def _snapshot(mod):
    r = mod.MetricsRegistry(enabled=True)
    r.counter("step.count").inc(7)
    r.gauge("epoch.steps_per_s").set(12.5)
    r.gauge("unset")
    d = r.distribution("step.total_s")
    for v in (0.1, 0.2, 0.3):
        d.observe(v)
    return r.snapshot()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_series_reads_across_the_packages(tmp_path, writer):
    wmod, rmod = ((exporters, jexporters) if writer == "torch"
                  else (jexporters, exporters))
    path = tmp_path / "m.jsonl"
    snap = _snapshot(metrics)
    with wmod.JsonlExporter(path) as ex:
        ex.write(snap, kind="epoch", epoch=0)
        ex.write(snap, kind="final")
    assert exporters.SCHEMA == jexporters.SCHEMA
    recs = rmod.read_series(path)
    assert [r["kind"] for r in recs] == ["epoch", "final"]
    assert recs[1]["metrics"] == json.loads(json.dumps(snap))
    # The torn tail a killed writer leaves is skipped, unless strict.
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"schema": "tpu_dist.obs')
    assert len(rmod.read_series(path)) == 2
    with pytest.raises(json.JSONDecodeError):
        rmod.read_series(path, strict=True)
    path.write_text(json.dumps({"schema": "someone/else"}) + "\n")
    with pytest.raises(rmod.SchemaError):
        rmod.read_series(path)


def test_prometheus_text_is_the_references(tmp_path):
    snap = _snapshot(metrics)
    assert snap == _snapshot(jmetrics)
    exporters.write_prometheus_textfile(snap, tmp_path / "t.prom")
    jexporters.write_prometheus_textfile(snap, tmp_path / "j.prom")
    text = (tmp_path / "t.prom").read_text()
    assert text == (tmp_path / "j.prom").read_text()
    assert "tpu_dist_step_count 7" in text
    assert 'tpu_dist_step_total_s{quantile="0.5"} 0.2' in text
    assert list(tmp_path.glob("*.tmp*")) == []


def test_prometheus_textfile_makes_its_missing_parent(tmp_path):
    snap = _snapshot(metrics)
    path = tmp_path / "a" / "b" / "t.prom"
    exporters.write_prometheus_textfile(snap, path)
    jexporters.write_prometheus_textfile(snap, tmp_path / "j" / "j.prom")
    assert path.read_text() == (tmp_path / "j" / "j.prom").read_text()
    # A rewrite replaces the file whole and leaves no temporary behind.
    exporters.write_prometheus_textfile({"counters": {"x": 1}}, path)
    assert path.read_text() == ("# TYPE tpu_dist_x counter\n"
                                "tpu_dist_x 1\n")
    assert [f.name for f in path.parent.iterdir()] == ["t.prom"]


# -- the step timer and the collective hook -------------------------------------


def test_step_timer_divides_by_steps():
    reg = MetricsRegistry(enabled=True)
    timer = StepTimer(reg)
    timer.record_execution(steps=4, data_wait_s=0.4, dispatch_s=0.8,
                           device_block_s=1.2)
    timer.record_execution(steps=0, data_wait_s=1.0, dispatch_s=1.0,
                           device_block_s=1.0)
    assert reg.snapshot()["counters"]["step.count"] == 0  # until flushed
    timer.flush()
    snap = reg.snapshot()
    assert snap["counters"]["step.count"] == 4
    dist = snap["distributions"]
    assert dist["step.total_s"]["p50"] == pytest.approx(0.6)
    assert dist["step.data_wait_s"]["p50"] == pytest.approx(0.1)
    assert dist["step.device_block_s"]["p50"] == pytest.approx(0.3)
    assert dist["step.overlap"]["p50"] == pytest.approx(0.5)
    assert timer.epoch_mean_step_s() == pytest.approx(0.6)


def test_collective_hook_counts_bytes_and_phases():
    reg = MetricsRegistry(enabled=True)
    hook = registry_collective_hook(reg)
    hook("all_reduce", phase="trace", leaves=1, nbytes=64)
    hook("all_reduce", phase="eager", leaves=1, nbytes=64, seconds=0.01)
    snap = reg.snapshot()
    assert snap["counters"]["collective.all_reduce.calls"] == 2
    assert snap["counters"]["collective.all_reduce.trace_calls"] == 1
    assert snap["counters"]["collective.all_reduce.bytes"] == 128
    assert snap["distributions"][
        "collective.all_reduce.host_seconds"]["count"] == 1
    assert snap["distributions"]["step.comm_wait_s"]["count"] == 1


def test_wrappers_fire_the_hooks_as_the_references_do():
    from tpu_dist_torch.cluster import bootstrap

    seen, faults = [], []

    def hook(op, **kw):
        seen.append((op, kw["phase"], kw["leaves"], kw["nbytes"],
                     kw["seconds"] is not None))

    def broken(op, **kw):
        raise RuntimeError("telemetry bug")

    prev = collectives.install_observe_hook(hook)
    prev_fault = collectives.install_fault_hook(faults.append)
    try:
        collectives.host_all_gather(np.float32(1.5))
        collectives.host_all_reduce_sum(np.ones(3))
        collectives.broadcast_from_chief({"w": np.zeros((2, 2))})
        collectives.all_reduce([torch.ones(4)])
        collectives.all_gather(torch.ones(2))
        bootstrap.barrier()
        collectives.install_observe_hook(broken)
        collectives.host_all_gather(np.float32(1.0))  # swallowed
    finally:
        collectives.install_observe_hook(prev)
        collectives.install_fault_hook(prev_fault)
    assert seen == [("host_all_gather", "eager", 1, 4, True),
                    ("host_all_reduce_sum", "eager", 1, 24, True),
                    ("broadcast_from_chief", "eager", 1, 32, True),
                    ("all_reduce", "eager", 1, 16, False),
                    ("all_gather", "eager", 1, 8, False),
                    ("barrier", "eager", 0, 0, True)]
    assert faults == ["host_all_gather", "host_all_reduce_sum",
                      "broadcast_from_chief", "all_reduce", "all_gather",
                      "barrier", "host_all_gather"]


# -- Telemetry on a fit -----------------------------------------------------------


def test_fit_records_steps_and_collectives(tmp_path):
    reg = MetricsRegistry(enabled=False)
    cb = Telemetry(jsonl_path=tmp_path / "m.jsonl",
                   prometheus_path=tmp_path / "m.prom", registry=reg)
    before_hook = collectives._OBSERVE_HOOK
    _model().fit(_ds(), epochs=2, verbose=0, callbacks=[cb])
    snap = reg.snapshot()
    assert snap["counters"]["step.count"] == 4
    for phase in ("total", "data_wait", "dispatch", "device_block"):
        assert snap["distributions"][f"step.{phase}_s"]["count"] == 4
    assert snap["counters"]["collective.host_all_gather.calls"] == 2
    assert snap["gauges"]["rank0.step_time_s"] > 0
    assert snap["gauges"]["epoch.steps_per_s"] > 0
    recs = exporters.read_series(tmp_path / "m.jsonl")
    assert [r["kind"] for r in recs] == ["epoch", "epoch", "final"]
    assert jexporters.read_series(tmp_path / "m.jsonl") == recs
    assert (tmp_path / "m.prom").exists()
    # The span restores what it found.
    assert collectives._OBSERVE_HOOK is before_hook
    assert active_step_timer() is None
    assert reg.enabled is False


def test_fit_at_k_steps_per_execution_counts_steps():
    reg = MetricsRegistry(enabled=False)
    m = _model()
    m.steps_per_execution = 2
    m.fit(_ds(n=128), epochs=1, verbose=0,
          callbacks=[Telemetry(registry=reg)])
    snap = reg.snapshot()
    assert snap["counters"]["step.count"] == 4
    assert snap["distributions"]["step.total_s"]["count"] == 2


def test_env_armed_telemetry_and_events(tmp_path, monkeypatch):
    monkeypatch.setenv(OBSERVE_DIR_ENV, str(tmp_path / "obs"))
    monkeypatch.setenv(events.EVENT_LOG_ENV, str(tmp_path / "events.jsonl"))
    assert maybe_telemetry_from_env() is not None
    _model().fit(_ds(), epochs=2, verbose=0)
    recs = exporters.read_series(tmp_path / "obs" / "metrics.jsonl")
    assert recs and recs[-1]["kind"] == "final"
    assert (tmp_path / "obs" / "metrics.prom").exists()
    timing = events.read_events(tmp_path / "events.jsonl", "step_timing")
    assert [(t["epoch"], t["steps"], t["rank"]) for t in timing] == [
        (0, 2, 0), (1, 2, 0)]
    # A Telemetry the caller passes wins: no second one from the env.
    reg = MetricsRegistry(enabled=False)
    _model().fit(_ds(), epochs=1, verbose=0,
                 callbacks=[Telemetry(registry=reg)])
    assert reg.snapshot()["counters"]["step.count"] == 2
    assert len(exporters.read_series(tmp_path / "obs" / "metrics.jsonl")
               ) == len(recs)


def test_env_unset_means_no_telemetry(monkeypatch):
    monkeypatch.delenv(OBSERVE_DIR_ENV, raising=False)
    assert maybe_telemetry_from_env() is None


# -- JSONLogger, LazyLogs ----------------------------------------------------------


def test_json_logger_lines_equal_the_references(tmp_path):
    jm, tm = _pair()
    x, y = _xy()
    jm.fit((x, y), epochs=2, steps_per_epoch=2, verbose=0,
           callbacks=[JJSONLogger(str(tmp_path / "j.jsonl"),
                                  log_batches=True)])
    tm.fit((x, y), epochs=2, steps_per_epoch=2, verbose=0,
           callbacks=[JSONLogger(str(tmp_path / "t.jsonl"),
                                 log_batches=True)])
    want = [json.loads(s) for s in (tmp_path / "j.jsonl").open()]
    got = [json.loads(s) for s in (tmp_path / "t.jsonl").open()]
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["event"] for r in got] == ["batch", "batch", "epoch"] * 2
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in ("loss",
                                                       "epoch_time")} == {
            k: v for k, v in w.items() if k not in ("loss", "epoch_time")}
        np.testing.assert_allclose(g["loss"], w["loss"], **TOL)
        assert g["loss"] == round(g["loss"], 6)


def test_lazy_logs_read_once():
    value = torch.tensor(2.5)
    logs = LazyLogs({"epoch_time": 0.5}, {"loss": value * 2,
                                          "accuracy": value / 5})
    assert len(logs) == 3 and "loss" in logs and logs._device
    assert isinstance(dict.__getitem__(logs, "loss"), torch.Tensor)
    assert logs["loss"] == 5.0 and not logs._device
    assert all(type(v) is float for v in logs.values())
    assert logs.copy() == {"epoch_time": 0.5, "loss": 5.0, "accuracy": 0.5}
    val = LazyLogs(device_logs={"loss": torch.tensor(1.0)})
    logs.absorb(val, prefix="val_")
    assert val._device and logs["val_loss"] == 1.0


def test_fit_without_readers_leaves_history_unread():
    m = _model()
    h = m.fit(_ds(), epochs=2, verbose=0)
    assert all(isinstance(p, LazyLogs) and p._device for p in h._pending)
    hist = h.history
    assert not h._pending and len(hist["loss"]) == 2
    assert all(type(v) is float for v in hist["loss"] + hist["epoch_time"])
    assert list(hist) == ["epoch_time", "loss"]


# -- the CLIs ---------------------------------------------------------------------


def test_demo_writes_valid_series(tmp_path, capsys):
    from tpu_dist_torch.observe.cli import main

    rc = main(["demo", "--epochs", "2", "--steps-per-epoch", "2",
               "--batch", "8", "--out", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] and payload["missing"] == []
    assert payload["summary"]["steps"] == 4
    assert payload["summary"]["collective_calls"] == {"host_all_gather": 2}
    assert pathlib.Path(payload["metrics_path"]).exists()
    assert pathlib.Path(payload["prometheus_path"]).exists()


def test_summarize_requires_and_vacuous_exits(tmp_path, capsys):
    from tpu_dist.observe.cli import main as jmain
    from tpu_dist_torch.observe.cli import main

    r = MetricsRegistry(enabled=True)
    r.counter("collective.all_reduce.calls").inc()
    path = tmp_path / "m.jsonl"
    with exporters.JsonlExporter(path) as ex:
        ex.write(r.snapshot(), kind="final")
    (tmp_path / "empty.jsonl").write_text("")
    for fn in (main, jmain):
        assert fn(["summarize", str(path)]) == 0
        assert fn(["summarize", str(path), "--require", "step"]) == 1
        assert fn(["summarize", str(path), "--require", "collective"]) == 0
        assert fn(["summarize", str(tmp_path / "empty.jsonl")]) == 1
        assert fn(["summarize", str(tmp_path / "nope.jsonl")]) == 1
        with pytest.raises(SystemExit):
            fn(["summarize", str(path), "--require", "bogus"])
    capsys.readouterr()
    main(["summarize", str(path), "--json"])
    tout = json.loads(capsys.readouterr().out)
    jmain(["summarize", str(path), "--json"])
    assert tout == json.loads(capsys.readouterr().out)


def test_diff_flags_regression(tmp_path, capsys):
    from tpu_dist_torch.observe.cli import main

    def series(path, steps_per_s):
        r = MetricsRegistry(enabled=True)
        r.counter("step.count").inc(4)
        r.gauge("epoch.steps_per_s").set(steps_per_s)
        with exporters.JsonlExporter(path) as ex:
            ex.write(r.snapshot(), kind="final")

    series(tmp_path / "base.jsonl", 100.0)
    series(tmp_path / "slow.jsonl", 50.0)
    assert main(["diff", str(tmp_path / "base.jsonl"),
                 str(tmp_path / "base.jsonl")]) == 0
    capsys.readouterr()
    rc = main(["diff", str(tmp_path / "base.jsonl"),
               str(tmp_path / "slow.jsonl"), "--max-regress-pct", "20"])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["steps_per_s_regress_pct"] == pytest.approx(50.0)
    assert payload["regressions"]


def test_bench_writes_only_where_told(tmp_path, capsys, monkeypatch):
    from tpu_dist_torch.observe.cli import BENCH_SCHEMA, main

    monkeypatch.chdir(tmp_path)
    rc = main(["bench", "--epochs", "2", "--steps-per-epoch", "2",
               "--batch", "8", "--device", "cpu", "--workdir",
               str(tmp_path / "w"), "--max-overhead-pct", "1000",
               "--rounds", "3"])
    captured = capsys.readouterr()
    report = json.loads(captured.out)
    # The side that goes first alternates from round to round.
    assert [line.split(": ")[-1] for line in captured.err.splitlines()
            if line.startswith("bench: round")] == [
        "telemetry on, then off...", "telemetry off, then on...",
        "telemetry on, then off..."]
    assert rc == 0 and report["ok"] and report["schema"] == BENCH_SCHEMA
    assert report["rounds"] == 3
    # The on runs are Telemetry as a user runs it: a record at each
    # epoch's end and one at the fit's, in each of the 3 runs.
    kinds = [r["kind"] for r in exporters.read_series(report["metrics_path"])]
    assert kinds == ["epoch", "epoch", "final"] * 3
    # The rates in the report are rounded to 3 decimals; the overhead was
    # taken from the unrounded ones.
    assert report["overhead_pct"] == pytest.approx(100 * (
        1 - report["telemetry_on_steps_per_s"]
        / report["telemetry_off_steps_per_s"]), abs=0.1)
    assert not (tmp_path / "BENCH_OBSERVE.json").exists()
    assert main(["bench", "--epochs", "1", "--device", "cpu",
                 "--batch", "8"]) == 1  # no timeable epoch


def test_serve_bench_exports_observe(tmp_path, monkeypatch, capsys):
    from tpu_dist_torch.serve.cli import main

    monkeypatch.setenv(OBSERVE_DIR_ENV, str(tmp_path / "obs"))
    assert main(["--bench", "--requests", "4", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["observe_dir"] == str(tmp_path / "obs")
    (rec,) = jexporters.read_series(tmp_path / "obs" / "serve.jsonl")
    assert rec["kind"] == "serve_bench"
    assert rec["metrics"]["counters"]["serve.requests.completed"] == 4
    assert "tpu_dist_serve_prefills 4" in (
        tmp_path / "obs" / "serve.prom").read_text()


# -- two ranks under a Supervisor ---------------------------------------------------


_WORKER = textwrap.dedent("""
    import time

    import numpy as np

    from tpu_dist_torch.cluster import bootstrap
    from tpu_dist_torch.data import Dataset
    from tpu_dist_torch.models import Dense, Sequential
    from tpu_dist_torch.observe.telemetry import maybe_telemetry_from_env
    from tpu_dist_torch.ops import SGD, SparseCategoricalCrossentropy

    # The process group carries the telemetry exchange only: each rank
    # fits its own model, so rank 1's slow input pipeline shows in its own
    # step time and in no one else's.
    bootstrap.initialize(device="cpu")
    rank = bootstrap.process_index()
    SLEEP_S = 0.03 if rank == 1 else 0.0


    def slow(a, b):
        if SLEEP_S:
            time.sleep(SLEEP_S)
        return True


    rng = np.random.RandomState(0)
    x = rng.rand(48, 4).astype(np.float32)
    y = rng.randint(0, 4, size=(48,)).astype(np.int32)
    ds = Dataset.from_tensor_slices((x, y)).filter(slow).batch(8)
    model = Sequential([Dense(8, activation="relu"), Dense(4)],
                       input_shape=(4,))
    model.compile(loss=SparseCategoricalCrossentropy(from_logits=True),
                  optimizer=SGD(learning_rate=0.05), device="cpu")
    # Of two ranks the median is their mean, so a rank's ratio to it stays
    # under 2 (the default threshold) however slow it is: 1.5 flags a rank
    # three times slower than its peer.
    telemetry = maybe_telemetry_from_env()
    telemetry.straggler_threshold = 1.5
    model.fit(ds, epochs=2, steps_per_epoch=3, verbose=0,
              callbacks=[telemetry])
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One Supervisor spawn of two gloo ranks with ``observe_dir``."""
    from tpu_dist_torch.resilience.supervisor import Supervisor

    root = tmp_path_factory.mktemp("ranks")
    log = events.EventLog(root / "events.jsonl")
    env = {"PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")]),
           events.EVENT_LOG_ENV: str(root / "events.jsonl")}
    sup = Supervisor([sys.executable, "-c", _WORKER], num_workers=2,
                     max_restarts=0, attempt_deadline_s=120.0, env=env,
                     log_dir=root / "logs", event_log=log,
                     observe_dir=root / "obs")
    report = sup.run()
    return root, report


def test_supervisor_observe_dir_gives_each_rank_a_series(two_ranks):
    root, report = two_ranks
    assert report.success, report.to_json()
    for rank in (0, 1):
        recs = exporters.read_series(root / "obs" / f"rank{rank}"
                                     / "metrics.jsonl")
        assert [r["kind"] for r in recs] == ["epoch", "epoch", "final"]
        gauges = recs[-1]["metrics"]["gauges"]
        # Both ranks hold both ranks' step times after the exchange.
        assert gauges["rank0.step_time_s"] > 0
        assert gauges["rank1.step_time_s"] > gauges["rank0.step_time_s"]
        assert (root / "obs" / f"rank{rank}" / "metrics.prom").exists()


def test_slowed_rank_is_flagged_by_rank(two_ranks):
    root, _ = two_ranks
    timing = events.read_events(root / "events.jsonl", "step_timing")
    assert sorted((t["rank"], t["epoch"]) for t in timing) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    flagged = events.read_events(root / "events.jsonl",
                                 "straggler_detected")
    assert [f["rank"] for f in flagged] == [1, 1]
    assert all(f["ratio"] > 1.5 for f in flagged)
