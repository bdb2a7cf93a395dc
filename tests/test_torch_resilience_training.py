"""Training resilience (``resilience/injector.py``, ``entrypoints.py``,
``cli.py``, ``cluster/liveness.py``) against the JAX package's (CPU).

* the injector arms the same slice of a plan as the reference's
  (``maybe_injector_from_env``), a bitflip on the rank its replica names;
* the checkpoint write seam: a truncated stage is published but rejected,
  the restore falls back to the last complete step and the resumed fit
  ends on the uninterrupted one's losses (the reference's own run too); a
  transient failure publishes nothing and the fit goes on;
* a ``delay_collective`` stalls the checkpoint commit's barrier;
* the SIGTERM drain in a subprocess: a ``preempt`` fault drains at the
  step, publishes the epoch before it and exits ``EXIT_PREEMPTED``;
* three gloo ranks, one spawn: the SDC audit names the rank and leaf a
  flip corrupted (the reference's leaf name); rank 2 exits and
  ``check_peer_health`` names it and the monitor raises; rank 0 exits and
  rank 1 finds the store gone (``PeerUnavailableError``);
* the reference's acceptance demo end to end: ``python -m
  tpu_dist_torch.resilience --device cpu --plan
  kill-worker@step5,kill-during-save@epoch2:attempt1``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import tpu_dist as td
from tpu_dist.resilience.injector import \
    maybe_injector_from_env as jmaybe_injector
from tpu_dist.training import checkpoint as jcheckpoint
from tpu_dist_torch.cluster import make_local_cluster
from tpu_dist_torch.data import Dataset
from tpu_dist_torch.models import cnn
from tpu_dist_torch.models.bridge import flatten_keys
from tpu_dist_torch.resilience import (FAULT_PLAN_ENV, FaultInjector,
                                       maybe_injector_from_env, read_events)
from tpu_dist_torch.resilience import cli
from tpu_dist_torch.resilience.events import EVENT_LOG_ENV
from tpu_dist_torch.resilience.faults import (EXIT_FAULT_KILL,
                                              EXIT_PREEMPTED, FaultPlan)
from tpu_dist_torch.training import checkpoint

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120

WORKER = '''
import json, os, sys, time
import numpy as np
from tpu_dist_torch.cluster import bootstrap, liveness
from tpu_dist_torch.models import Sequential, layers
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.parallel import MultiWorkerMirroredStrategy
from tpu_dist_torch.training import integrity

strategy = MultiWorkerMirroredStrategy(device="cpu")
rank = bootstrap.process_index()
monitor = strategy.liveness_monitor
out = {"rank": rank, "threads": sorted(t.name for t in monitor._threads)}
with strategy.scope():
    m = Sequential([layers.Dense(8, activation="relu"), layers.Dense(4)],
                   input_shape=(4,), seed=rank)
    m.compile(loss=losses.SparseCategoricalCrossentropy(from_logits=True),
              optimizer=optimizers.SGD(0.1))
m._get_trainer("").ensure_variables()  # rank 0's weights everywhere
guard = integrity.IntegrityGuard(integrity.IntegrityConfig()).bind(
    strategy, shard_keys=integrity.shard_keys(m))
leaves = integrity.named_leaves(m)
out["clean"] = guard.audit(leaves, gstep=2)
if rank == 1:
    out["flipped"] = integrity.flip_param_bit(m, replica=1, leaf=1)
try:
    guard.audit(leaves, gstep=4)
    out["sdc"] = None
except integrity.RollbackAndReplay as rb:
    out["sdc"] = {"kind": rb.kind, "culprits": rb.detail["culprits"]}
bootstrap.barrier("liveness")
if rank == 2:
    os._exit(0)
deadline = time.monotonic() + 30
if rank == 0:
    dead = []
    while not dead and time.monotonic() < deadline:
        time.sleep(0.2)
        dead = list(liveness.check_peer_health(timeout_s=1.0))
    out["dead"] = dead
    while not monitor.failed and time.monotonic() < deadline:
        time.sleep(0.1)
    try:
        monitor.raise_if_failed()
        out["raised"] = False
    except liveness.PeerUnavailableError:
        out["raised"] = True
    print(json.dumps(out), flush=True)
    open("rank0.done", "w").close()
    os._exit(0)
while not os.path.exists("rank0.done") and time.monotonic() < deadline:
    time.sleep(0.1)
time.sleep(1.0)
t0 = time.monotonic()
try:
    liveness.check_peer_health(timeout_s=1.0, retries=3)
    out["store_gone"] = False
except liveness.PeerUnavailableError:
    out["store_gone"] = True
out["store_gone_s"] = time.monotonic() - t0
print(json.dumps(out), flush=True)
os._exit(0)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Three gloo ranks of :data:`WORKER`, started once for the file."""
    tmp = tmp_path_factory.mktemp("resilience_ranks")
    (tmp / "worker.py").write_text(WORKER)
    procs = []
    for tf_config in make_local_cluster(3, base_port=_free_port()):
        env = dict(os.environ, TF_CONFIG=json.dumps(tf_config),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   TPU_DIST_HEALTH_INTERVAL="0.2",
                   TPU_DIST_HEALTH_TIMEOUT="1.0")
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp / "worker.py")], cwd=tmp, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            if out.strip():
                rec = json.loads(out.strip().splitlines()[-1])
                outs[rec["rank"]] = rec
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# -- arming ----------------------------------------------------------------------

@pytest.mark.parametrize("plan, rank, attempt", [
    ("slow-input@step1:rank3", 0, 0), ("slow-input@step1:rank3", 3, 0),
    ("kill@step5:rank1", 1, 1), ("delay@step*:rank1:always:2.5s", 1, 4),
    ("nan_loss@step5, kill@epoch1:rank2", 2, 0),
], ids=["other_rank", "its_rank", "later_attempt", "always", "mixed"])
def test_injector_arms_the_references_slice(monkeypatch, plan, rank,
                                            attempt):
    monkeypatch.setenv(FAULT_PLAN_ENV, plan)
    ours = maybe_injector_from_env(steps_per_epoch=4, rank=rank,
                                   attempt=attempt)
    ref = jmaybe_injector(steps_per_epoch=4, rank=rank, attempt=attempt)
    got = None if ours is None else [f.to_json() for f in ours.faults]
    want = None if ref is None else [f.to_json() for f in ref.faults]
    assert got == want


def test_a_bitflip_arms_on_the_rank_its_replica_names(monkeypatch):
    """A replica is a process here: ``:replica1`` arms on rank 1 only (the
    reference arms it in every process of a one-process run)."""
    monkeypatch.setenv(FAULT_PLAN_ENV, "bitflip@step9:leaf1:replica1")
    assert maybe_injector_from_env(steps_per_epoch=4, rank=0,
                                   attempt=0) is None
    (f,) = maybe_injector_from_env(steps_per_epoch=4, rank=1,
                                   attempt=0).faults
    assert f.kind == "bitflip" and f.leaf == 1
    monkeypatch.setenv(FAULT_PLAN_ENV, "bitflip@step9:rank1")
    assert maybe_injector_from_env(steps_per_epoch=4, rank=1, attempt=0)
    monkeypatch.delenv(FAULT_PLAN_ENV)
    assert maybe_injector_from_env(steps_per_epoch=4, rank=0,
                                   attempt=0) is None


# -- the checkpoint write seam -----------------------------------------------------

def _cnn_fit(ckdir, *, epochs, jax_side=False):
    rng = np.random.RandomState(0)
    x = rng.rand(32, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, size=(32,)).astype(np.int32)
    if jax_side:
        model = td.models.build_and_compile_cnn_model(learning_rate=0.01)
        ds = td.data.Dataset.from_tensor_slices((x, y)).batch(16)
    else:
        from tpu_dist.models import cnn as jcnn

        model = cnn.build_and_compile_cnn_model(learning_rate=0.01,
                                                device="cpu")
        model.load_jax_variables(jax.tree_util.tree_map(
            np.asarray, jcnn.build_cnn_model().init(0)))
        ds = Dataset.from_tensor_slices((x, y)).batch(16)
    hist = model.fit(ds, epochs=epochs, steps_per_epoch=2, verbose=0,
                     checkpoint_dir=str(ckdir))
    return [float(v) for v in hist.history["loss"]]


def test_a_truncated_stage_is_rejected_and_the_resume_falls_back(
        tmp_path, monkeypatch):
    """The reference's ``TestInProcessChaos``: ``ckpt-fail@epoch1:truncate``
    publishes a torn step 1; the resumed fit restores step 0 and replays
    epochs 1-2 onto the uninterrupted losses."""
    monkeypatch.delenv(FAULT_PLAN_ENV, raising=False)
    baseline = _cnn_fit(tmp_path / "baseline", epochs=3)
    np.testing.assert_allclose(
        baseline, _cnn_fit(tmp_path / "ref", epochs=3, jax_side=True),
        rtol=1e-5)
    event_path = tmp_path / "events.jsonl"
    monkeypatch.setenv(EVENT_LOG_ENV, str(event_path))
    monkeypatch.setenv(FAULT_PLAN_ENV, "ckpt-fail@epoch1:truncate")
    ckdir = tmp_path / "chaos"
    assert _cnn_fit(ckdir, epochs=2) == baseline[:2]
    fired = read_events(event_path, "fault_fired")
    assert [(e["kind"], e["mode"]) for e in fired] == [
        ("checkpoint_fail", "truncate")]
    assert checkpoint.latest_step(ckdir) == 1
    assert checkpoint.latest_complete_step(ckdir) == 0
    # The reference's validation rejects the torn step too.
    assert jcheckpoint.latest_complete_step(ckdir) == 0
    monkeypatch.setenv(FAULT_PLAN_ENV, "")
    resumed = _cnn_fit(ckdir, epochs=3)
    assert resumed == baseline[1:]
    assert read_events(event_path, "checkpoint_resume")[-1]["step"] == 0


def test_a_transient_write_failure_publishes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv(EVENT_LOG_ENV, str(tmp_path / "events.jsonl"))
    monkeypatch.setenv(FAULT_PLAN_ENV, "ckpt-fail@epoch1")
    losses_ = _cnn_fit(tmp_path / "ck", epochs=3)
    assert len(losses_) == 3
    assert checkpoint.all_steps(tmp_path / "ck") == [0, 2]
    assert not any(p.name.startswith("tmp")
                   for p in (tmp_path / "ck").iterdir())


def test_delay_collective_stalls_the_commit_barrier(tmp_path, monkeypatch):
    monkeypatch.setenv(EVENT_LOG_ENV, str(tmp_path / "events.jsonl"))
    monkeypatch.setenv(FAULT_PLAN_ENV, "delay-collective@epoch1:0.3s")
    _cnn_fit(tmp_path / "ck", epochs=2)
    (e,) = read_events(tmp_path / "events.jsonl", "fault_fired")
    assert e["kind"] == "delay_collective" and e["seconds"] == 0.3
    assert e["op"] == "barrier"


def test_injector_restores_the_seams_it_installed(monkeypatch):
    from tpu_dist_torch.parallel import collectives
    from tpu_dist_torch.training import integrity

    plan = FaultPlan.parse("delay-collective@step1, ckpt-fail@epoch0, "
                           "nan_loss@step2")
    inj = FaultInjector(plan.faults, steps_per_epoch=4)
    inj.on_train_begin()
    assert integrity.batch_hook_installed()
    inj.on_train_end()
    assert not integrity.batch_hook_installed()
    assert collectives.install_fault_hook(None) is None
    assert checkpoint.install_write_fault_hook(None) is None


# -- the SIGTERM drain ---------------------------------------------------------------

def test_a_preempt_fault_drains_and_exits_preempted(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               TPU_DIST_FAULT_PLAN="preempt@step6",
               TPU_DIST_EVENT_LOG=str(tmp_path / "events.jsonl"),
               TPU_DIST_CHECKPOINT_DIR=str(tmp_path / "ckpt"))
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.resilience.entrypoints",
         "--device", "cpu"], capture_output=True, text=True,
        timeout=TIMEOUT_S, cwd=str(ROOT), env=env)
    assert proc.returncode == EXIT_PREEMPTED, proc.stderr[-2000:]
    assert "RESULT:" not in proc.stdout
    kinds = [e["event"] for e in read_events(tmp_path / "events.jsonl")]
    assert kinds.index("preempt_requested") < kinds.index("preempt_drained")
    (drained,) = read_events(tmp_path / "events.jsonl", "preempt_drained")
    assert drained["drain_s"] >= 0
    # Drained inside epoch 1: epoch 0's checkpoint is published, no other.
    assert checkpoint.latest_complete_step(tmp_path / "ckpt") == 0


# -- three gloo ranks ----------------------------------------------------------------

def test_the_sdc_audit_names_the_flipped_rank_and_leaf(ranks):
    jm = td.Sequential([td.models.Dense(8, activation="relu"),
                        td.models.Dense(4)], input_shape=(4,))
    want_leaf = list(flatten_keys(jax.tree_util.tree_map(
        np.asarray, jm.init(0)["params"])))[1]
    for rank in range(3):
        out = ranks[rank] if rank in ranks else None
        if out is None:
            continue
        assert out["clean"] is True
        assert out["sdc"]["kind"] == "sdc"
        # A group of three has a majority: only the flipped rank is named.
        assert [(c["rank"], c["leaf"]) for c in out["sdc"]["culprits"]] == [
            (1, want_leaf)]
    assert ranks[1]["flipped"]["leaf"] == want_leaf


def test_liveness_names_the_dead_rank_and_fails_the_monitor(ranks):
    assert ranks[0]["threads"] == ["tpu_dist_torch_health",
                                   "tpu_dist_torch_heartbeat"]
    assert ranks[0]["dead"] == [2]
    assert ranks[0]["raised"] is True


def test_an_unreachable_store_raises_peer_unavailable(ranks):
    assert ranks[1]["store_gone"] is True
    assert ranks[1]["store_gone_s"] < 30


# -- the chaos CLI -------------------------------------------------------------------

@pytest.mark.parametrize("argv, item", [
    (["--ps-chaos"], "20"),
], ids=["ps_chaos"])
def test_unported_cli_modes_name_their_item(argv, item, monkeypatch,
                                            tmp_path):
    # Item 20 ported the last of them: --ps-chaos runs the parameter
    # server's legs (resilience/ps_chaos.py; tests/test_torch_ps.py and
    # chip_smoke.py phase 33 run them).
    from tpu_dist_torch.resilience import ps_chaos

    seen = []
    monkeypatch.setattr(ps_chaos, "run_ps_chaos",
                        lambda args, workdir: seen.append(workdir) or 0)
    assert cli.main(argv + ["--workdir", str(tmp_path)]) == 0
    assert seen == [tmp_path]


def test_cli_usage_errors(tmp_path):
    assert cli.main(["--plan", "  "]) == 2
    # bitflip needs replicas, and a replica is a worker process here.
    assert cli.main(["--plan", "bitflip@step9:leaf1:replica1",
                     "--workdir", str(tmp_path)]) == 2


def test_kill_worker_chaos_run_end_to_end(tmp_path):
    """The reference's acceptance demo: kill at global step 5 on attempt
    0, then on the restarted attempt kill inside the write seam while the
    epoch-2 async save is staged but unpublished. Recovery comes from the
    last PUBLISHED step and the final attempt reaches the baseline's
    loss."""
    report_path = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.resilience", "--device", "cpu",
         "--plan", "kill-worker@step5,kill-during-save@epoch2:attempt1",
         "--workdir", str(tmp_path / "chaos"),
         "--report", str(report_path)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(report_path.read_text())
    assert report["ok"] and report["success"]
    assert report["restarts"] >= 2
    assert report["exit_codes"][0] == [EXIT_FAULT_KILL]
    assert report["exit_codes"][1] == [EXIT_FAULT_KILL]
    assert sorted(f["kind"] for f in report["faults_fired"]) == [
        "kill", "kill_during_save"]
    assert report["resumed_from"][-1] == 1
    assert report["parity_ok"]
    assert abs(report["loss_delta"]) <= 1e-5
    kinds = [e["event"] for e in read_events(
        tmp_path / "chaos" / "events.jsonl")]
    assert "restart" in kinds and "recovered" in kinds
    assert "checkpoint_resume" in kinds
    # The killed writer's epoch-2 stage is still where it was staged,
    # never published (the step-2 directory is the last attempt's save).
    ckdir = tmp_path / "chaos" / "ckpt"
    stages = [p / "stage" for p in ckdir.iterdir() if p.name.startswith("tmp")]
    assert len(stages) == 1 and stages[0].is_dir()
    assert json.loads((stages[0] / "manifest.json").read_text())["step"] == 2
