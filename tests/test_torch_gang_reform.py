"""The mid-epoch gang reform (item 18b) against the reference's
``tests/test_gang_reform.py``.

* the gang-generation protocol's files are a contract on disk: the
  barriers' markers and the reform request, ack, restore and generation
  files written by ``tpu_dist.cluster.bootstrap`` are read by the port's
  functions, and the reverse;
* ``bootstrap.reinitialize``: re-stamping without a process group, a real
  teardown and re-dial of an explicit one-process gloo group with an
  all-reduce before and after (``tests/test_torch_elastic.py`` runs the
  two-rank one);
* the survivor's side through a real CPU ``fit`` (world 1, so the
  rendezvous is immediate): the consensus step replays bit for bit with
  the port's uninterrupted fit, the scratch consensus from epoch 0, and
  both within the CNN tolerance of the reference's same reformed fit on
  bridged weights;
* the Supervisor's reform over a plain-Python gang that imports no torch
  (it speaks the protocol through the files alone): absorbed without a
  restart, an ack timeout that condemns the attempt, a second loss
  mid-reform;
* ``python -m tpu_dist_torch.resilience --step-rejoin`` end to end,
  marked ``slow`` as the reference marks its own (``chip_smoke.py`` phase
  32 runs it on the card).
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tpu_dist as tdj
from tpu_dist.cluster import bootstrap as jboot
from tpu_dist.resilience import rejoin as jrejoin
from tpu_dist.training.callbacks import Callback as JCallback
from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.data import Dataset
from tpu_dist_torch.models import cnn
from tpu_dist_torch.resilience import events, rejoin
from tpu_dist_torch.resilience.events import EVENT_LOG_ENV, EventLog
from tpu_dist_torch.resilience.faults import FAULT_PLAN_ENV
from tpu_dist_torch.resilience.injector import maybe_injector_from_env
from tpu_dist_torch.resilience.supervisor import GracePolicy, Supervisor
from tpu_dist_torch.training.callbacks import Callback

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: The port's CNN training tolerance against the reference
#: (``tests/test_torch_cnn.py``).
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def fresh_generation(monkeypatch):
    """Both packages' generation caches and their env mirror reset, so a
    test that bumps the generation leaks into no other."""
    # setenv first, so that monkeypatch records the caller's value (or its
    # absence) and restores it after ``reinitialize`` wrote os.environ.
    monkeypatch.setenv(bootstrap.GENERATION_ENV, "0")
    monkeypatch.delenv(bootstrap.GENERATION_ENV)
    saved = bootstrap._GENERATION, jboot._GENERATION
    bootstrap._GENERATION = jboot._GENERATION = None
    yield
    bootstrap._GENERATION, jboot._GENERATION = saved


def _meet(fns):
    """Run the barrier callables on threads; their results in order."""
    out, errs = [None] * len(fns), []

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errs.append(exc)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    if errs:
        raise errs[0]
    return out


# -- barriers and files --------------------------------------------------------------

@pytest.mark.parametrize("ranks", [("port", "port"), ("port", "jax"),
                                   ("jax", "port")],
                         ids=["port", "port_jax", "jax_port"])
def test_generation_rendezvous_meets_across_threads_and_packages(
        tmp_path, ranks):
    mods = {"port": bootstrap, "jax": jboot}
    got = _meet([lambda r=r, m=mods[name]: m.generation_rendezvous(
        tmp_path, generation=3, step=8, rank=r, world=2, timeout_s=20,
        poll_s=0.01) for r, name in enumerate(ranks)])
    assert got == [[0, 1], [0, 1]]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "gen-3.step-8.rank-0", "gen-3.step-8.rank-1"]


@pytest.mark.parametrize("mod", [bootstrap, jboot], ids=["port", "jax"])
def test_epoch_rendezvous_meets_and_reaps_older_markers(tmp_path, mod,
                                                        fresh_generation):
    ns = "g0a0"
    # Markers of another namespace and of an epoch two back are this
    # rank's to reap; another rank's are not.
    for name in ("g9a0.epoch-4.rank-0", f"{ns}.epoch-1.rank-0",
                 f"{ns}.epoch-1.rank-1", "epoch-2.rank-0"):
        (tmp_path / name).write_text("1")
    got = _meet([lambda r=r: mod.epoch_rendezvous(
        tmp_path, epoch=3, rank=r, world=2, timeout_s=20, poll_s=0.01,
        namespace=ns) for r in (0, 1)])
    assert got == [[0, 1], [0, 1]]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"{ns}.epoch-3.rank-0", f"{ns}.epoch-3.rank-1"]


def test_default_namespace_is_the_references(fresh_generation, monkeypatch):
    monkeypatch.setenv(bootstrap.GENERATION_ENV, "2")
    monkeypatch.setenv(events.ATTEMPT_ENV, "5")
    assert (bootstrap._default_rendezvous_namespace()
            == jboot._default_rendezvous_namespace() == "g2a5")


@pytest.mark.parametrize("mod", [bootstrap, jboot], ids=["port", "jax"])
def test_timeout_names_the_missing_rank_and_withdraws_the_marker(tmp_path,
                                                                 mod):
    with pytest.raises(TimeoutError, match=r"missing rank\(s\) \[1\]"):
        mod.generation_rendezvous(tmp_path, generation=0, step=0, rank=0,
                                  world=2, timeout_s=0.2, poll_s=0.02)
    assert list(tmp_path.iterdir()) == []


def test_stale_generation_marker_cannot_satisfy_the_barrier(tmp_path):
    # Rank 1's marker of generation 0 (a broken clique's) is there;
    # generation 1's barrier still waits for it.
    (tmp_path / "gen-0.step-4.rank-1").write_text("1")
    with pytest.raises(TimeoutError):
        bootstrap.generation_rendezvous(tmp_path, generation=1, step=4,
                                        rank=0, world=2, timeout_s=0.2,
                                        poll_s=0.02)


def test_abort_check_raises_out_of_the_wait(tmp_path):
    calls = []

    def abort():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("reform")

    with pytest.raises(RuntimeError, match="reform"):
        bootstrap.generation_rendezvous(tmp_path, generation=0, step=0,
                                        rank=0, world=2, timeout_s=20,
                                        poll_s=0.01, abort_check=abort)
    assert len(calls) == 3


def test_reform_acks_survive_marker_reaping(tmp_path):
    bootstrap.ack_reform(tmp_path, generation=1, rank=0, available_step=3)
    bootstrap.generation_rendezvous(tmp_path, generation=1, step=0, rank=0,
                                    world=1, timeout_s=5)
    assert bootstrap.read_reform_acks(tmp_path, generation=1) == {
        0: {"rank": 0, "available_step": 3}}


@pytest.mark.parametrize("writer, reader", [(bootstrap, jboot),
                                            (jboot, bootstrap)],
                         ids=["port_to_jax", "jax_to_port"])
def test_reform_files_cross_between_packages(tmp_path, writer, reader):
    assert reader.read_reform_request(tmp_path) is None
    req = writer.request_reform(tmp_path, generation=2, lost_ranks=[3, 1],
                                detect_s=0.25)
    got = reader.read_reform_request(tmp_path)
    assert got == req and got["lost_ranks"] == [1, 3]
    writer.ack_reform(tmp_path, generation=2, rank=0, available_step=4)
    writer.ack_reform(tmp_path, generation=2, rank=2, available_step=None)
    writer.ack_reform(tmp_path, generation=1, rank=5, available_step=0)
    assert reader.read_reform_acks(tmp_path, generation=2) == {
        0: {"rank": 0, "available_step": 4},
        2: {"rank": 2, "available_step": None}}
    assert reader.read_restore_step(tmp_path, generation=2) == (False, None)
    writer.publish_restore_step(tmp_path, generation=2, step=4)
    assert reader.read_restore_step(tmp_path, generation=2) == (True, 4)
    writer.publish_restore_step(tmp_path, generation=3, step=None)
    assert reader.read_restore_step(tmp_path, generation=3) == (True, None)
    assert reader.read_generation(tmp_path) == 0
    writer.publish_generation(tmp_path, 2)
    assert reader.read_generation(tmp_path) == 2
    writer.withdraw_reform(tmp_path)
    writer.withdraw_reform(tmp_path)  # idempotent
    assert reader.read_reform_request(tmp_path) is None


def test_torn_files_read_as_absent(tmp_path):
    (tmp_path / "reform-request.json").write_text('{"generation": 1')
    (tmp_path / "reform-g1.restore").write_text("{")
    (tmp_path / "reform-g1.drained.rank-0").write_text("[")
    (tmp_path / "generation").write_text("x")
    assert bootstrap.read_reform_request(tmp_path) is None
    assert bootstrap.read_restore_step(tmp_path, generation=1) == (False,
                                                                   None)
    assert bootstrap.read_reform_acks(tmp_path, generation=1) == {}
    assert bootstrap.read_generation(tmp_path) == 0


# -- reinitialize -----------------------------------------------------------------------

def test_reinitialize_without_a_group_restamps_the_generation(
        fresh_generation):
    assert bootstrap.current_generation() == 0
    assert bootstrap.reinitialize() == 1
    assert os.environ[bootstrap.GENERATION_ENV] == "1"
    assert bootstrap.reinitialize(generation=5) == 5
    assert bootstrap.current_generation() == 5
    assert bootstrap.last_reinit["port"] is None
    # A relaunched worker reads its generation from the environment, as
    # the reference's does.
    bootstrap._GENERATION = jboot._GENERATION = None
    assert bootstrap.current_generation() == jboot.current_generation() == 5


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_reinitialize_tears_down_and_redials_an_explicit_group(
        fresh_generation):
    port = _free_port()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        x = torch.arange(3.0)
        dist.all_reduce(x)
        world = dist.group.WORLD
        assert bootstrap.reinitialize(generation=1,
                                      coordinator_port=_free_port()) == 1
        assert dist.is_initialized() and dist.group.WORLD is not world
        assert bootstrap.last_reinit["port"] != port
        assert bootstrap.last_reinit["teardown_s"] < 5.0
        y = torch.arange(3.0)
        dist.all_reduce(y)
        assert torch.equal(x, y)
    finally:
        dist.destroy_process_group()
        bootstrap._GROUP_PARAMS = None


# -- the step rejoin gate -----------------------------------------------------------------

def test_gate_is_absent_without_a_gang_dir(monkeypatch):
    monkeypatch.delenv(bootstrap.GANG_DIR_ENV, raising=False)
    assert rejoin.maybe_step_rejoin_gate(steps_per_epoch=4) is None


def test_gate_takes_the_environments_coordinates(tmp_path, monkeypatch):
    monkeypatch.setenv(bootstrap.GANG_DIR_ENV, str(tmp_path))
    monkeypatch.setenv("TPU_DIST_REJOIN_WORLD", "3")
    monkeypatch.setenv("TPU_DIST_REJOIN_RANK", "2")
    monkeypatch.setenv("TPU_DIST_REJOIN_TIMEOUT_S", "7")
    gate = rejoin.maybe_step_rejoin_gate(steps_per_epoch=5)
    ref = jrejoin.maybe_step_rejoin_gate(steps_per_epoch=5)
    for g in (gate, ref):
        assert (g.directory, g.rank, g.world, g.steps_per_epoch,
                g.timeout_s) == (str(tmp_path), 2, 3, 5, 7.0)


def test_gate_raises_on_a_newer_generation_only(tmp_path,
                                                fresh_generation):
    gate = rejoin.StepRejoinGate(str(tmp_path), rank=0, world=1,
                                 steps_per_epoch=2)
    gate.on_train_begin()
    gate.on_batch_end(0, {})
    jboot.request_reform(tmp_path, generation=0, lost_ranks=[1])
    gate.on_batch_end(1, {})  # not newer than ours
    jboot.request_reform(tmp_path, generation=1, lost_ranks=[1],
                         detect_s=0.5)
    with pytest.raises(rejoin.GangReform) as err:
        gate.on_batch_end(2, {})
    assert err.value.generation == 1 and err.value.lost_ranks == [1]
    # A relaunched worker adopts the committed generation.
    jboot.publish_generation(tmp_path, 1)
    gate.on_train_begin()
    assert gate.generation == 1
    gate.on_batch_end(3, {})


# -- the survivor's side through a real fit -------------------------------------------------

def _reformer(base, gang_dir, restore_step, boot):
    """A callback playing the Supervisor inside a world-1 fit: the reform
    request and the consensus step at the third batch (epoch 1's first)."""

    class Reformer(base):
        wants_batches = True

        def __init__(self):
            self.batches = 0

        def on_batch_end(self, step, logs):
            self.batches += 1
            if self.batches == 3:
                boot.request_reform(gang_dir, generation=1, lost_ranks=[1],
                                    detect_s=0.01)
                boot.publish_restore_step(gang_dir, generation=1,
                                          step=restore_step)

    return Reformer()


def _data():
    rng = np.random.RandomState(0)
    return (rng.rand(32, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, size=(32,)).astype(np.int32))


def _arm(monkeypatch, tmp_path, tag):
    gang = tmp_path / f"gang-{tag}"
    gang.mkdir()
    log = tmp_path / f"events-{tag}.jsonl"
    monkeypatch.setenv(bootstrap.GANG_DIR_ENV, str(gang))
    monkeypatch.setenv("TPU_DIST_REJOIN_WORLD", "1")
    monkeypatch.setenv("TPU_DIST_REJOIN_RANK", "0")
    monkeypatch.setenv(EVENT_LOG_ENV, str(log))
    monkeypatch.delenv("TPU_DIST_RESTORE_STEP", raising=False)
    return gang, log


def _port_fit(tmp_path, weights, callbacks=(), tag=None):
    model = cnn.build_and_compile_cnn_model(learning_rate=0.01,
                                            device="cpu")
    model.load_jax_variables(weights)
    x, y = _data()
    ds = Dataset.from_tensor_slices((x, y)).batch(16)
    ckpt = None if tag is None else str(tmp_path / f"ckpt-{tag}")
    return model.fit(ds, epochs=3, steps_per_epoch=2, verbose=0,
                     checkpoint_dir=ckpt,
                     callbacks=list(callbacks)).history["loss"]


def _jax_fit(tmp_path, monkeypatch, restore_step, tag):
    gang, _ = _arm(monkeypatch, tmp_path, f"jax-{tag}")
    model = tdj.models.build_and_compile_cnn_model(learning_rate=0.01)
    x, y = _data()
    ds = tdj.data.Dataset.from_tensor_slices((x, y)).batch(16)
    return [float(v) for v in model.fit(
        ds, epochs=3, steps_per_epoch=2, verbose=0,
        checkpoint_dir=str(tmp_path / f"jckpt-{tag}"),
        callbacks=[_reformer(JCallback, str(gang), restore_step, jboot)]
    ).history["loss"]]


@pytest.mark.parametrize("restore_step", [0, None],
                         ids=["consensus_step", "scratch"])
def test_reformed_fit_replays_exactly(tmp_path, monkeypatch,
                                      fresh_generation, restore_step):
    jm = tdj.models.build_and_compile_cnn_model(learning_rate=0.01)
    weights = jax_tree_to_numpy(jm.init(0))
    baseline = _port_fit(tmp_path, weights)
    gang, log = _arm(monkeypatch, tmp_path, "port")
    got = _port_fit(tmp_path, weights, [_reformer(
        Callback, str(gang), restore_step, bootstrap)], tag="port")
    # The consensus step replays epochs 1-2; the scratch one replays
    # everything from the fit's start, so epoch 0 appears twice.
    want = baseline if restore_step == 0 else [baseline[0]] + baseline
    assert got == want
    (ev,) = events.read_events(log, "gang_reform")
    assert ev["generation"] == 1 and ev["lost_ranks"] == [1]
    assert ev["restored_step"] == restore_step
    assert ev["next_epoch"] == (1 if restore_step == 0 else 0)
    for phase in ("drain_s", "reform_s", "restore_s"):
        assert ev[phase] >= 0.0
    acks = bootstrap.read_reform_acks(gang, generation=1)
    assert acks[0]["available_step"] == 0
    assert bootstrap.current_generation() == 1
    # The reference's same reformed fit, from the same weights.
    bootstrap._GENERATION = jboot._GENERATION = None
    monkeypatch.delenv(bootstrap.GENERATION_ENV, raising=False)
    np.testing.assert_allclose(got, _jax_fit(tmp_path, monkeypatch,
                                             restore_step, "ref"), **TOL)


def jax_tree_to_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


# -- the Supervisor over a gang that imports no torch ---------------------------------------

_PROTOCOL = textwrap.dedent("""\
    import json, os, pathlib, sys, time

    rank = int(os.environ["TPU_DIST_REJOIN_RANK"])
    gang = pathlib.Path(os.environ["TPU_DIST_GANG_DIR"])
    gen = int(os.environ.get("TPU_DIST_GANG_GENERATION", "0") or 0)
    rejoin = int(os.environ.get("TPU_DIST_GANG_REJOIN", "0") or 0)

    def read(name):
        try:
            return json.loads((gang / name).read_text())
        except (OSError, ValueError):
            return None

    def meet(g, step, deadline):
        (gang / f"gen-{g}.step-{step}.rank-{rank}").write_text("1")
        while not all((gang / f"gen-{g}.step-{step}.rank-{r}").exists()
                      for r in (0, 1)):
            assert time.time() < deadline, "rendezvous timed out"
            time.sleep(0.05)
""")


def _reform_worker() -> list:
    """Rank 1 dies once mid-run; rank 0 survives, acks the reform and
    meets the relaunched rank 1 at the new generation's rendezvous."""
    body = _PROTOCOL + textwrap.dedent("""\
        deadline = time.time() + 30
        if rank == 1 and not rejoin:
            time.sleep(0.3)
            sys.exit(7)
        if rank == 1:
            assert os.environ["TPU_DIST_RESTORE_STEP"] == "none"
            assert gen == 1, gen
            meet(gen, 0, deadline)
            sys.exit(0)
        while True:
            req = read("reform-request.json")
            if req is not None and req["generation"] > gen:
                break
            assert time.time() < deadline, "no reform request"
            time.sleep(0.05)
        g = req["generation"]
        (gang / f"reform-g{g}.drained.rank-0").write_text(
            json.dumps({"rank": 0, "available_step": None}))
        while read(f"reform-g{g}.restore") is None:
            assert time.time() < deadline, "no consensus restore step"
            time.sleep(0.05)
        assert read(f"reform-g{g}.restore") == {"step": None}
        meet(g, 0, deadline)
    """)
    return [sys.executable, "-c", body]


def _no_torch_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return env


def test_supervisor_absorbs_a_lost_rank_without_a_restart(tmp_path):
    gang = tmp_path / "gang"
    sup = Supervisor(_reform_worker(), num_workers=2, max_restarts=0,
                     step_rejoin_dir=gang, reform_ack_timeout_s=30.0,
                     env=_no_torch_env(), log_dir=tmp_path / "logs",
                     event_log=EventLog(tmp_path / "events.jsonl",
                                        role="supervisor"))
    report = sup.run()
    assert report.success, report.to_json()
    assert report.attempts == 1 and report.restarts == 0
    assert report.to_json()["gang_reforms"] == [1]
    assert report.to_json()["rejoins"] == [1]
    (req,) = events.read_events(tmp_path / "events.jsonl",
                                "gang_reform_requested")
    assert req["generation"] == 1 and req["lost_ranks"] == [1]
    assert req["detect_s"] >= 0.0 and req["restore_step"] is None
    (rej,) = events.read_events(tmp_path / "events.jsonl", "worker_rejoin")
    assert rej["rank"] == 1 and rej["prior_code"] == 7
    assert jboot.read_generation(gang) == 1
    assert sup.worker_log(0, 1, rejoin=1).name == "attempt0-rank1-rejoin1.log"
    assert sup.worker_log(0, 1, rejoin=1).exists()


def test_an_ack_timeout_condemns_the_attempt(tmp_path):
    cmd = [sys.executable, "-c", textwrap.dedent("""\
        import os, sys, time

        if int(os.environ["TPU_DIST_REJOIN_RANK"]) == 1:
            time.sleep(0.2)
            sys.exit(7)
        time.sleep(30)  # the survivor never speaks the protocol
    """)]
    gang = tmp_path / "gang"
    sup = Supervisor(cmd, num_workers=2, max_restarts=0,
                     step_rejoin_dir=gang, reform_ack_timeout_s=1.0,
                     grace=GracePolicy(exit_grace_s=0.3, term_grace_s=5.0),
                     env=_no_torch_env(), log_dir=tmp_path / "logs",
                     event_log=EventLog(tmp_path / "events.jsonl",
                                        role="supervisor"))
    report = sup.run()
    assert not report.success
    assert report.outcomes[0].gang_reforms == 0
    (ev,) = events.read_events(tmp_path / "events.jsonl",
                               "gang_reform_failed")
    assert ev["reason"] == ev["cause"] == "ack_timeout"
    assert jboot.read_reform_request(gang) is None


def test_a_second_loss_mid_reform_falls_back_to_a_gang_restart(tmp_path):
    markers = tmp_path / "markers"
    markers.mkdir()
    cmd = [sys.executable, "-c", textwrap.dedent(f"""\
        import os, pathlib, sys, time

        rank = int(os.environ["TPU_DIST_REJOIN_RANK"])
        marker = pathlib.Path({str(markers)!r}) / f"died-{{rank}}"
        if marker.exists():
            sys.exit(0)  # the restarted gang runs clean
        marker.write_text("x")
        if rank == 1:
            time.sleep(0.2)
            sys.exit(7)   # the first loss starts the reform
        time.sleep(1.5)   # the second dies mid-drain and never acks
        sys.exit(5)
    """)]
    gang = tmp_path / "gang"
    sup = Supervisor(cmd, num_workers=2, max_restarts=1,
                     step_rejoin_dir=gang, reform_ack_timeout_s=30.0,
                     grace=GracePolicy(exit_grace_s=0.3, term_grace_s=5.0),
                     env=_no_torch_env(), log_dir=tmp_path / "logs",
                     event_log=EventLog(tmp_path / "events.jsonl",
                                        role="supervisor"))
    report = sup.run()
    assert report.success, report.to_json()
    assert report.restarts == 1 and report.outcomes[0].gang_reforms == 0
    (ev,) = events.read_events(tmp_path / "events.jsonl",
                               "gang_reform_failed")
    assert (ev["reason"], ev["cause"], ev["ranks"]) == (
        "survivor_died", "second_loss", [0])
    assert jboot.read_reform_request(gang) is None


def test_the_workers_environment_is_the_references(tmp_path, monkeypatch):
    from tpu_dist.resilience.supervisor import Supervisor as JSupervisor

    kw = dict(num_workers=2, step_rejoin_dir=tmp_path / "gang",
              rank_scoped_env_keys=("CKPT",), env={"CKPT": "/c"})
    keys = ("TPU_DIST_REJOIN_RANK", "TPU_DIST_REJOIN_WORLD",
            "TPU_DIST_GANG_DIR", "TPU_DIST_GANG_GENERATION",
            "TPU_DIST_GANG_REJOIN", "TPU_DIST_RESTORE_STEP", "CKPT")
    got = []
    for cls in (Supervisor, JSupervisor):
        sup = cls(["x"], **kw)
        sup._worker_env(0, 0)
        sup._generation, sup._restore_step = 2, 3
        env = sup._worker_env(1, 0, rejoin=1)
        got.append({k: env.get(k) for k in keys})
        assert sup.gang_size(0) == 2
    assert got[0] == got[1]
    assert got[0]["TPU_DIST_RESTORE_STEP"] == "3"
    assert got[0]["CKPT"] == "/c/rank1"


# -- the injector's gang identity ---------------------------------------------------------------

def test_the_rank_override_and_the_incarnation_target_faults(monkeypatch):
    monkeypatch.setenv(FAULT_PLAN_ENV, "kill@step5:rank1")
    monkeypatch.setenv("TPU_DIST_REJOIN_RANK", "1")
    monkeypatch.delenv("TPU_DIST_GANG_REJOIN", raising=False)
    assert maybe_injector_from_env(steps_per_epoch=4) is not None
    monkeypatch.setenv("TPU_DIST_GANG_REJOIN", "1")
    assert maybe_injector_from_env(steps_per_epoch=4) is None


# -- the CLI end to end ---------------------------------------------------------------------------

@pytest.mark.slow
def test_step_rejoin_end_to_end(tmp_path):
    """Both legs on the CPU (~30 s); phase 32 (a) of ``chip_smoke.py``
    runs the same on the card."""
    out = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.resilience", "--device",
         "cpu", "--step-rejoin", "--plan", "kill-worker@step6:rank1",
         "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout)
    assert report["ok"] and report["loss_delta"] == 0.0
    assert report["step_rejoin"]["reform"]["restarts"] == 0
    assert report["step_rejoin"]["reform"]["gang_reforms"] == [1]
    assert set(report["recovery_breakdown"]) == {
        "detect_s", "drain_s", "reform_s", "restore_s"}
