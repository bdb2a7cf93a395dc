"""The jobs runtime (``tpu_dist_torch/jobs``) against the JAX package's
(CPU).

The parts that are arithmetic are held to the reference's decisions on the
same inputs: ``derive_job_seed`` integer for integer, the specs' wire
format, the namespaces, ``MeshRuntime``'s divisor rule and leases over the
same request sequences, and ``PackingScheduler``'s admissions over seeded
submissions. Then the port's own properties: a job scope places the
trainer's and the engine's programs in the runtime's cache and changes no
result (a fit outside any scope builds its programs as before and never
imports the runtime); a job's results are the same solo and packed; and a
small ``JobPool`` of one-process gangs (a slot is a process here) whose
train and serve jobs equal their in-process solo runs bit for bit, with
``job_kill`` restarting only its target (blast radius zero) and
``job_kill:abort`` failing it without a restart.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from tpu_dist.jobs import cli as jcli
from tpu_dist.jobs import runtime as jruntime
from tpu_dist.jobs import scheduler as jscheduler
from tpu_dist.jobs import spec as jspec
from tpu_dist_torch.jobs import cli as tcli
from tpu_dist_torch.jobs.runtime import (JobContext, MeshRuntime,
                                         current_job, job_scope)
from tpu_dist_torch.jobs.scheduler import (DONE, FAILED, QUEUED, RUNNING,
                                           JobPool, PackingScheduler,
                                           _pool_env)
from tpu_dist_torch.jobs.spec import (JOB_ROOT_ENV, JOB_SPEC_ENV,
                                      JobNamespace, JobSpec, derive_job_seed)
from tpu_dist_torch.jobs.worker import run_inline
from tpu_dist_torch.resilience import events
from tpu_dist_torch.resilience.faults import FAULT_PLAN_ENV, JOB_INDEX_ENV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the arithmetic, against the reference's ----------------------------------

def test_derive_job_seed_equals_the_references():
    names = ["a", "train-a", "serve-b", "alpha", "fleet-r0", "x" * 40,
             "tenant.7", "j_9"]
    for name in names:
        for base in (0, 1, 7, 12345, 2 ** 31 - 1, 2 ** 40):
            assert derive_job_seed(name, base) == jspec.derive_job_seed(
                name, base)


def test_specs_cross_the_wire_between_the_packages(monkeypatch):
    ref = jspec.JobSpec(name="t-1", kind="serve", devices=2, priority=3,
                        requests=5, max_new=9, arrival_s=0.25)
    port = JobSpec.from_json(ref.to_json())
    assert port.to_json() == ref.to_json() and port.dumps() == ref.dumps()
    monkeypatch.setenv(JOB_SPEC_ENV, port.dumps())
    assert jspec.JobSpec.from_env() == ref
    for bad, match in (({"name": "a", "kind": "batch"}, "unknown job kind"),
                       ({"name": "no spaces"}, "job name"),
                       ({"name": "a", "devices": 0}, "devices must be"),
                       ({"name": "a", "arrival_s": -1}, "arrival_s"),
                       ({"name": "a", "colour": 1}, "unknown JobSpec")):
        for cls in (JobSpec, jspec.JobSpec):
            with pytest.raises(ValueError, match=match):
                cls.from_json(bad)


def test_namespaces_match_the_references(tmp_path):
    spec = JobSpec(name="alpha", seed=3)
    port, ref = JobNamespace(spec, tmp_path), jspec.JobNamespace(
        jspec.JobSpec(**spec.to_json()), tmp_path)
    for attr in ("seed", "metric_prefix", "job_dir", "checkpoint_dir",
                 "event_log", "observe_dir", "log_dir", "journal_dir"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.metric("x") == ref.metric("x") == "job.alpha.x"
    with pytest.raises(RuntimeError, match="no root"):
        JobNamespace(spec, None).checkpoint_dir


def _lease_trace(runtime_cls, ops):
    """The outcomes of a sequence of ('acquire', n) / ('release', i) ops on
    an 8-slot virtual pool: (start, size) or None, or an error's text."""
    rt = runtime_cls(8)
    held, out = [], []
    for op, arg in ops:
        try:
            if op == "acquire":
                lease = rt.try_acquire(arg)
                held.append(lease)
                out.append(None if lease is None
                           else (lease.start, lease.size))
            elif held:
                lease = held[arg % len(held)]
                if lease is not None:
                    lease.release()
                out.append(("released", rt.free_devices()))
        except (ValueError, RuntimeError) as exc:
            out.append(("error", str(exc)))
    return out


def test_mesh_runtime_leases_as_the_references():
    rng = np.random.default_rng(3)
    for _ in range(20):
        ops = [("release", int(rng.integers(0, 100)))
               if rng.random() < 0.35 else
               ("acquire", int(rng.choice([1, 2, 3, 4, 8, 9])))
               for _ in range(14)]
        assert _lease_trace(MeshRuntime, ops) == _lease_trace(
            jruntime.MeshRuntime, ops)


def test_double_release_is_loud():
    rt = MeshRuntime(4)
    lease = rt.acquire(2)
    lease.release()
    with pytest.raises(RuntimeError, match="double release"):
        lease.release()


def test_device_pools_lease_slots_one_device_a_process():
    rt = MeshRuntime(["cpu", "cpu"])
    assert rt.pool_size == 2 and rt.devices[0].type == "cpu"
    one = rt.acquire(1)
    assert one.devices == (rt.devices[0],)
    assert str(one.strategy().device) == "cpu"
    one.release()
    with pytest.raises(NotImplementedError, match="12b"):
        rt.acquire(2).strategy()
    with pytest.raises(RuntimeError, match="virtual-pool"):
        MeshRuntime(4).acquire(2).strategy()


def test_program_cache_builds_once():
    rt = MeshRuntime(2)
    calls = []

    def build():
        calls.append(1)
        return object()

    first = rt.cached(("job", "m", 0, "train_step"), build)
    assert rt.cached(("job", "m", 0, "train_step"), build) is first
    assert len(calls) == 1 and rt.program_hits == 1
    assert rt.program_keys() == [("job", "m", 0, "train_step")]


def _admissions(mod, specs_json, runtime_cls):
    """The scheduler's decisions: admit every admissible job, finish the
    first submitted of the running ones, repeat; the (name, lease start)
    admitted each round."""
    sched = mod.PackingScheduler(runtime_cls(8))
    spec_cls = JobSpec if mod is not jscheduler else jspec.JobSpec
    for s in specs_json:
        sched.submit(spec_cls.from_json(s))
    trace = []
    while not sched.settled():
        while True:
            placed = sched.next_admissible()
            if placed is None:
                break
            record, lease = placed
            sched.mark_running(record, lease)
            trace.append((record.spec.name, lease.start))
        running = sorted(sched.running(), key=lambda r: r.index)
        sched.mark_done(running[0])
        trace.append(("done", running[0].spec.name))
    return trace, [r.to_json()["state"] for r in sched.records]


def test_packing_decisions_equal_the_references():
    import tpu_dist_torch.jobs.scheduler as tscheduler

    rng = np.random.default_rng(11)
    for trial in range(25):
        specs = [JobSpec(name=f"j{trial}-{i}",
                         devices=int(rng.choice([1, 2, 4, 8])),
                         priority=int(rng.integers(0, 3))).to_json()
                 for i in range(int(rng.integers(3, 9)))]
        assert _admissions(tscheduler, specs, MeshRuntime) == _admissions(
            jscheduler, specs, jruntime.MeshRuntime)


def test_submit_validates_early_and_the_state_machine():
    sched = PackingScheduler(MeshRuntime(8))
    with pytest.raises(ValueError, match="does not divide"):
        sched.submit(JobSpec(name="odd", devices=3))
    rec = sched.submit(JobSpec(name="a", devices=4))
    with pytest.raises(ValueError, match="duplicate job name"):
        sched.submit(JobSpec(name="a"))
    assert rec.state == QUEUED
    record, lease = sched.next_admissible()
    sched.mark_running(record, lease)
    assert record.state == RUNNING and sched.runtime.free_devices() == 4
    sched.mark_failed(record, classification="job_abort")
    assert (record.state, record.classification) == (FAILED, "job_abort")
    assert lease.released and sched.settled()


#: The gang wiring the port's ``_pool_env`` drops and the reference's keeps:
#: a pool inside a reformed gang must not hand its jobs the caller's
#: generation or gang directories (a port note).
_PORT_ONLY_DROPS = ("TPU_DIST_REJOIN_DIR", "TPU_DIST_GANG_DIR",
                    "TPU_DIST_GANG_GENERATION", "TPU_DIST_REJOIN_WORLD")


def test_pool_env_strips_job_and_gang_wiring(monkeypatch):
    # The caller's gang wiring is cleared first: an in-process reform run
    # earlier in the same worker may have left a generation behind.
    for var in _PORT_ONLY_DROPS:
        monkeypatch.delenv(var, raising=False)
    for var in (FAULT_PLAN_ENV, events.EVENT_LOG_ENV, JOB_SPEC_ENV,
                JOB_ROOT_ENV, JOB_INDEX_ENV, "TF_CONFIG",
                "TPU_DIST_REJOIN_RANK"):
        monkeypatch.setenv(var, "from-the-caller")
    env = _pool_env({JOB_INDEX_ENV: "2"})
    assert env[JOB_INDEX_ENV] == "2"
    for var in (FAULT_PLAN_ENV, events.EVENT_LOG_ENV, JOB_SPEC_ENV,
                JOB_ROOT_ENV, "TF_CONFIG", "TPU_DIST_REJOIN_RANK"):
        assert var not in env
    ref = jscheduler._pool_env({})
    assert set(ref) - set(env) <= {"TF_CONFIG", "TPU_DIST_REJOIN_RANK"}


def test_pool_env_holds_with_the_gang_wiring_inherited(monkeypatch):
    """The test above, run where a reform left the gang variables set."""
    for var in _PORT_ONLY_DROPS:
        monkeypatch.setenv(var, "3")
    test_pool_env_strips_job_and_gang_wiring(monkeypatch)
    env = _pool_env({})
    assert not set(_PORT_ONLY_DROPS) & set(env)
    for var in _PORT_ONLY_DROPS:
        monkeypatch.setenv(var, "3")
    assert set(_PORT_ONLY_DROPS) <= set(jscheduler._pool_env({}))


def test_the_cli_takes_the_references_arguments_and_mixes():
    for argv in (["--bench"], ["--chaos"]):
        port = vars(tcli.build_parser().parse_args(argv))
        ref = vars(jcli.build_parser().parse_args(argv))
        assert port.pop("device") is None and port == ref
    assert [s.to_json() for s in tcli.bench_mix()] == [
        s.to_json() for s in jcli.bench_mix()]
    assert [s.to_json() for s in tcli.chaos_mix()] == [
        s.to_json() for s in jcli.chaos_mix()]


# -- job scopes, the trainer and the engine ------------------------------------

def test_scope_pushes_context_and_releases():
    rt = MeshRuntime(["cpu", "cpu"])
    seen = []
    with job_scope(rt, JobSpec(name="a")) as ctx:
        assert isinstance(ctx, JobContext) and current_job() is ctx
        assert rt.free_devices() == 1
        t = threading.Thread(target=lambda: seen.append(current_job()))
        t.start()
        t.join()
        with job_scope(rt, JobSpec(name="b")) as inner:
            assert inner.lease.start != ctx.lease.start
            assert current_job() is inner
        assert current_job() is ctx
    assert seen == [None] and current_job() is None
    assert rt.free_devices() == 2
    with pytest.raises(ZeroDivisionError):
        with job_scope(rt, JobSpec(name="c")):
            1 / 0
    assert rt.free_devices() == 2


def test_a_fit_outside_any_job_scope_never_imports_the_runtime():
    """The solo no-op: a fit that no job scope wraps builds its programs
    as before, and never imports the jobs runtime."""
    code = (
        "import sys, numpy as np\n"
        "from tpu_dist_torch.models import Dense, Sequential\n"
        "m = Sequential([Dense(4)], input_shape=(3,))\n"
        "m.compile(optimizer='sgd', loss='mse', device='cpu')\n"
        "x = np.ones((8, 3), np.float32); y = np.zeros((8, 4), np.float32)\n"
        "m.fit((x, y), epochs=1, verbose=0)\n"
        "assert m._trainer._job is None\n"
        "print('tpu_dist_torch.jobs.runtime' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_job_is_the_same_solo_and_packed(tmp_path, kind):
    """run_inline on a slot of a pool whose other slot a neighbour holds
    gives the solo run's results bit for bit; the programs of the job's
    trainer live in the pool's cache under its name."""
    spec = (JobSpec(name="iso-train", epochs=2, steps_per_epoch=3, batch=8)
            if kind == "train" else
            JobSpec(name="iso-serve", kind="serve", requests=3, max_new=6))
    solo = run_inline(MeshRuntime(["cpu", "cpu"]), spec,
                      root=str(tmp_path / "solo"))
    rt = MeshRuntime(["cpu", "cpu"])
    neighbour = rt.acquire(1)
    packed = run_inline(rt, spec, root=str(tmp_path / "packed"))
    neighbour.release()
    if kind == "train":
        assert solo["losses"] == packed["losses"] != []
        keys = rt.program_keys()
        assert keys and {k[0] for k in keys} == {spec.name}
        assert "train_step" in {k[3] for k in keys}
    else:
        assert solo["streams"] == packed["streams"] and solo["tokens"] > 0
        assert (tmp_path / "solo" / "jobs" / spec.name / "journal").exists()
    assert all(k.startswith(f"job.{spec.name}.") for k in solo["metrics"])


def test_distinct_jobs_never_share_programs_or_streams():
    rt = MeshRuntime(["cpu"])
    a = run_inline(rt, JobSpec(name="tenant-a", epochs=1, steps_per_epoch=2))
    b = run_inline(rt, JobSpec(name="tenant-b", epochs=1, steps_per_epoch=2))
    assert a["losses"] != b["losses"]
    assert {k[0] for k in rt.program_keys()} == {"tenant-a", "tenant-b"}


# -- a small JobPool: one-process gangs on the CPU ------------------------------

ALPHA = JobSpec(name="alpha", epochs=2, steps_per_epoch=3, batch=8)
BRAVO = JobSpec(name="bravo", epochs=2, steps_per_epoch=3, batch=8)
CHARLIE = JobSpec(name="charlie", kind="serve", requests=3, max_new=6)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Three pools at once, each in a thread: alpha and charlie packed; the
    three jobs with ``job_kill@job1``; alpha and bravo with
    ``job_kill@job1:abort``. And each job's solo run in this process."""
    runs = {
        "packed": ([ALPHA, CHARLIE], None),
        "kill": ([ALPHA, BRAVO, CHARLIE], "job_kill@job1"),
        "abort": ([ALPHA, BRAVO], "job_kill@job1:abort"),
    }
    out, threads = {}, []
    for label, (specs, plan) in runs.items():
        root = tmp_path_factory.mktemp(label)

        def run(label=label, specs=specs, plan=plan, root=root):
            out[label] = (JobPool(specs, root=root, pool=4, plan=plan,
                                  max_restarts=2, attempt_deadline_s=120.0,
                                  backoff_s=0.05, device="cpu").run(), root)

        threads.append(threading.Thread(target=run, daemon=True))
        threads[-1].start()
    solo = {s.name: run_inline(MeshRuntime(["cpu"]), s)
            for s in (ALPHA, BRAVO, CHARLIE)}
    for t in threads:
        t.join(300)
    return out, solo


def _by_name(report):
    return {j["name"]: j for j in report["jobs"]}


def _same(kind, got, want):
    if kind == "train":
        return got["losses"] == want["losses"] != []
    return got["streams"] == want["streams"] != {}


def test_packed_train_and_serve_jobs_equal_their_solo_runs(pools):
    (report, _), solo = pools[0]["packed"], pools[1]
    assert report["done"] == 2 and report["failed"] == 0
    for name, job in _by_name(report).items():
        assert job["restarts"] == 0
        assert _same(job["kind"], job["result"], solo[name]), name


def test_job_kill_blast_radius_zero(pools):
    (report, root), solo = pools[0]["kill"], pools[1]
    jobs = _by_name(report)
    assert report["done"] == 3
    assert jobs["bravo"]["restarts"] >= 1
    for name, spec in (("alpha", ALPHA), ("bravo", BRAVO),
                       ("charlie", CHARLIE)):
        fired = events.read_events(JobNamespace(spec, root).event_log,
                                   "fault_fired")
        assert bool(fired) == (name == "bravo"), (name, fired)
        if name != "bravo":
            assert jobs[name]["restarts"] == 0
        assert _same(spec.kind, jobs[name]["result"], solo[name]), name


def test_job_abort_fails_without_restart(pools):
    report, _ = pools[0]["abort"]
    jobs = _by_name(report)
    assert jobs["alpha"]["state"] == DONE
    assert (jobs["bravo"]["state"], jobs["bravo"]["classification"],
            jobs["bravo"]["restarts"]) == (FAILED, "job_abort", 0)
