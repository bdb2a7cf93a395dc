"""Elasticity (item 18b) against the reference's ``tests/test_elastic.py``.

* the liveness monitor's rejoin window: the same probe sequences through
  both packages' ``LivenessMonitor``s give the same verdicts, detection
  times and events;
* the epoch ``RejoinGate`` and the Supervisor's per-rank rejoin and
  ``worker_schedule`` over plain-Python gangs;
* the sharded v2 checkpoint. Two gloo ranks under ``{model: 2}`` fit the
  LM, save it as v1 (gathered) and as v2 (sync and async); the
  reference's own ``checkpoint.restore_model`` reads the v2 step to the v1
  step's arrays, one process restores it (2 -> 1) to the same bytes, and
  a one-process v2 step goes onto the two ranks and back (1 -> 2 -> 1)
  bit for bit. Four ranks under ``{data: 2, model: 2}`` write each block
  once (the data-axis replica at coordinate 0). The failure modes: a
  missing shard file, an index whose shape disagrees, a model axis that
  does not divide a leaf stored sharded. The port restores a one-device
  v2 step the reference wrote;
* ``bootstrap.reinitialize`` on live gloo groups: two ranks re-dial on
  ``base + 1`` with an all-reduce before and after; four ranks get their
  mesh subgroups and ``ModelShard`` groups remade, and the sharded LM
  trains on through them as one process does;
* ``python -m tpu_dist_torch.resilience --reshape 2,1``, marked ``slow``
  as the reference marks its own (``chip_smoke.py`` phase 32 runs it).

Both spawns start before the tests that need them and run at once.
"""

import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import textwrap
import threading
import types

import numpy as np
import pytest
import torch

import tpu_dist as tdj
from tpu_dist.cluster import liveness as jliveness
from tpu_dist.models.transformer import build_transformer_lm as jlm
from tpu_dist.ops import losses as jlosses
from tpu_dist.ops import optimizers as jopt
from tpu_dist.resilience import injector as jinjector
from tpu_dist.training import checkpoint as jckpt
from tpu_dist_torch.cluster import bootstrap, liveness, make_local_cluster
from tpu_dist_torch.data import Dataset
from tpu_dist_torch.models import bridge, cnn
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.parallel import mesh as mesh_lib
from tpu_dist_torch.resilience import events, injector
from tpu_dist_torch.resilience.events import EVENT_LOG_ENV, EventLog
from tpu_dist_torch.resilience.supervisor import GracePolicy, Supervisor
from tpu_dist_torch.training import checkpoint

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
#: The tensor-parallel fits' bar against one process
#: (``tests/test_torch_tensor_parallel.py``).
TP_TOL = dict(atol=2e-5, rtol=2e-5)
VOCAB, SEQ, LR = 29, 16, 1e-2

COMMON = '''
import json, os, pathlib
import numpy as np
import torch
import torch.distributed as dist
import tpu_dist_torch as td
from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.training import checkpoint
from tpu_dist_torch.training.callbacks import ModelCheckpoint

VOCAB, SEQ, LR = %(vocab)d, %(seq)d, %(lr)r
seq = np.arange(256) * 3 %% VOCAB
XS = np.stack([seq[i:i + SEQ] for i in range(0, 192, 4)]).astype(np.int64)
YS = np.stack([seq[i + 1:i + SEQ + 1] for i in range(0, 192, 4)]).astype(
    np.int64)


def dataset():
    return td.data.Dataset.from_tensor_slices((XS, YS)).batch(16).repeat()


def lm(strategy, seed=0):
    with strategy.scope():
        model = build_transformer_lm(VOCAB, SEQ, d_model=32, depth=1,
                                     num_heads=4, seed=seed)
        model.compile(loss=losses.SparseCategoricalCrossentropy(
            from_logits=True), optimizer=optimizers.Adam(LR), device="cpu")
    return model


def fit(model, steps, **kw):
    return model.fit(dataset(), epochs=1, steps_per_epoch=steps, verbose=0,
                     **kw).history["loss"]

''' % {"vocab": VOCAB, "seq": SEQ, "lr": LR}

WORKER2 = COMMON + '''
strategy = td.MultiWorkerMirroredStrategy(
    axis_shapes={"data": 1, "model": 2}, device="cpu")
rank = td.cluster.process_index()
out = {"rank": rank}
model = lm(strategy)
out["loss"] = fit(model, 4, callbacks=[ModelCheckpoint("v2a",
                                                       sharded=True)])
checkpoint.save("v1", model, step=0)
checkpoint.save("v2s", model, step=0, sharded=True)
out["layout"] = sorted(model._tensor_parallel[1])
out["bytes"] = {name: os.path.getsize(f"v2s/ckpt-0/{name}")
                for name in (f"arrays-shard-{rank}.npz", f"shards-{rank}.json")}

# One process's v2 step (the test's) onto the two ranks, and back.
reader = lm(strategy, seed=5)
out["one_step"] = checkpoint.restore_model("one", reader)
checkpoint.save("back", reader, step=0, sharded=True)

# The group re-dialled on base + 1 under generation 1.
x = torch.full((2,), float(rank + 1))
dist.all_reduce(x)
out["generation"] = bootstrap.reinitialize()
y = torch.full((2,), float(rank + 1))
dist.all_reduce(y)
out["before"], out["after"] = x.tolist(), y.tolist()
out["reinit"] = bootstrap.last_reinit
out["post_reinit_loss"] = fit(model, 2)
print(json.dumps(out))
'''

WORKER4 = COMMON + '''
strategy = td.MultiWorkerMirroredStrategy(
    axis_shapes={"data": 2, "model": 2}, device="cpu")
rank = td.cluster.process_index()
out = {"rank": rank}
model = lm(strategy)
fit(model, 2)
checkpoint.save("dm_v1", model, step=0)
checkpoint.save("dm_v2", model, step=0, sharded=True)
shard = model._tensor_parallel[0]
old = shard.group
out["generation"] = bootstrap.reinitialize()
out["regrouped"] = shard.group is not old and shard.group is not None
t = torch.full((1,), float(rank))
dist.all_reduce(t, group=shard.group)
out["model_axis_sum"] = t.item()
out["post_reinit_loss"] = fit(model, 2)
print(json.dumps(out))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n: int, script: str, tmp: pathlib.Path) -> list:
    (tmp / "worker.py").write_text(script)
    procs = []
    for tf_config in make_local_cluster(n, base_port=_free_port()):
        env = dict(os.environ, TF_CONFIG=json.dumps(tf_config),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        env.pop(bootstrap.GENERATION_ENV, None)
        procs.append(subprocess.Popen(
            [sys.executable, "worker.py"], cwd=tmp, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _finish(procs: list) -> list:
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _lm(seed=0):
    model = build_transformer_lm(VOCAB, SEQ, d_model=32, depth=1,
                                 num_heads=4, seed=seed)
    model.compile(loss=losses.SparseCategoricalCrossentropy(
        from_logits=True), optimizer=optimizers.Adam(LR), device="cpu")
    return model


def _dataset():
    seq = np.arange(256) * 3 % VOCAB
    xs = np.stack([seq[i:i + SEQ] for i in range(0, 192, 4)])
    ys = np.stack([seq[i + 1:i + SEQ + 1] for i in range(0, 192, 4)])
    return Dataset.from_tensor_slices((xs.astype(np.int64),
                                       ys.astype(np.int64))).batch(16).repeat()


def _fit(model, steps):
    return model.fit(_dataset(), epochs=1, steps_per_epoch=steps,
                     verbose=0).history["loss"]


def _arrays(model) -> dict:
    model._trainer.ensure_variables()
    return {k: t.detach().numpy().copy() for k, t in
            bridge.checkpoint_tensors(model,
                                      model._trainer.variables["opt"]).items()}


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_bytes(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two spawns, started at once: two ranks under ``{model: 2}``
    (after the one-process v2 step they read is written), four under
    ``{data: 2, model: 2}``."""
    two = tmp_path_factory.mktemp("two")
    one = _lm(seed=3)
    _fit(one, 3)
    checkpoint.save(two / "one", one, step=0, sharded=True)
    four = tmp_path_factory.mktemp("four")
    procs2 = _spawn(2, WORKER2, two)
    procs4 = _spawn(4, WORKER4, four)
    out2, out4 = _finish(procs2), _finish(procs4)
    return types.SimpleNamespace(two=two, four=four, out2=out2, out4=out4,
                                 one=_arrays(one))


# -- liveness: the rejoin window -----------------------------------------------------------

SEQUENCES = {
    "zero_window": (0.0, [([1], 0.0)]),
    "recovers": (5.0, [([2], 0.0), ([], 1.0), ([], 2.0)]),
    "expires": (5.0, [([2], 0.0), ([2], 4.0), ([2], 6.0)]),
    "late_answer_stays_terminal": (5.0, [([2], 0.0), ([2], 6.0),
                                         ([], 7.0)]),
    "overlapping": (5.0, [([1], 0.0), ([1, 2], 3.0), ([1, 2], 6.0)]),
    "detect_from_last_round": (5.0, [([], 0.0), ([3], 2.5), ([], 4.0),
                                     ([3], 9.0)]),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_rejoin_window_matches_the_reference(name, tmp_path, monkeypatch):
    window, rounds = SEQUENCES[name]
    got = []
    for tag, mod in (("port", liveness), ("jax", jliveness)):
        log = tmp_path / f"{tag}.jsonl"
        monkeypatch.setenv(EVENT_LOG_ENV, str(log))
        m = mod.LivenessMonitor(rejoin_window_s=window)
        trace = [(m._observe(dead, now=now), m.failed, list(m.dead_peers),
                  list(getattr(m, "suspect_peers", [])), m.last_detect_s
                  if window else None) for dead, now in rounds]
        recs = [{k: v for k, v in e.items() if k not in ("ts", "pid",
                                                         "role", "host")}
                for e in events.read_events(log)] if log.exists() else []
        got.append((trace, recs))
    assert got[0] == got[1]
    if name == "expires":
        assert got[0][0][-1][:3] == (True, True, [2])


def test_the_default_window_still_fails_at_once():
    m = liveness.LivenessMonitor()
    assert m._observe([1]) and m.failed and m.dead_peers == [1]
    m.reset()
    assert not m.failed and m.dead_peers == [] and m.suspect_peers == []


# -- the epoch rejoin gate -----------------------------------------------------------------

def test_rejoin_gate_env_is_the_references(tmp_path, monkeypatch):
    monkeypatch.delenv(bootstrap.REJOIN_DIR_ENV, raising=False)
    assert injector.maybe_rejoin_gate() is None
    monkeypatch.setenv(bootstrap.REJOIN_DIR_ENV, str(tmp_path))
    monkeypatch.setenv("TPU_DIST_REJOIN_WORLD", "2")
    monkeypatch.setenv("TPU_DIST_REJOIN_RANK", "1")
    monkeypatch.setenv("TPU_DIST_REJOIN_TIMEOUT_S", "9")
    got = [(g.directory, g.world, g.rank, g.timeout_s) for g in
           (injector.maybe_rejoin_gate(), jinjector.maybe_rejoin_gate())]
    assert got[0] == got[1] == (str(tmp_path), 2, 1, 9.0)


def test_rejoin_gates_hold_the_epoch_for_the_whole_gang(tmp_path,
                                                        monkeypatch):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv(EVENT_LOG_ENV, str(log))
    gates = [injector.RejoinGate(str(tmp_path / "rv"), world=2, rank=r,
                                 timeout_s=20) for r in (0, 1)]
    threads = [threading.Thread(target=g.on_epoch_begin, args=(2,))
               for g in gates]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    recs = events.read_events(log, "rejoin_rendezvous")
    assert sorted(r["ranks"] == [0, 1] and r["epoch"] == 2
                  for r in recs) == [True, True]
    with pytest.raises(TimeoutError, match=r"missing rank\(s\) \[1\]"):
        injector.RejoinGate(str(tmp_path / "alone"), world=2, rank=0,
                            timeout_s=0.2).on_epoch_begin(0)


# -- the Supervisor's per-rank rejoin and worker schedule -------------------------------------

def _gang(body: str) -> list:
    return [sys.executable, "-c", textwrap.dedent(body)]


def _sup(cmd, tmp_path, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return Supervisor(cmd, log_dir=tmp_path / "logs",
                      grace=GracePolicy(exit_grace_s=0.3, term_grace_s=5.0),
                      event_log=EventLog(tmp_path / "events.jsonl",
                                         role="supervisor"), env=env, **kw)


def test_a_crashed_rank_rejoins_without_a_gang_restart(tmp_path):
    cmd = _gang("""\
        import os, sys, time

        rank = int(os.environ["TPU_DIST_REJOIN_RANK"])
        if rank == 1 and not os.environ.get("TPU_DIST_GANG_REJOIN"):
            sys.exit(9)
        time.sleep(1.0)
    """)
    report = _sup(cmd, tmp_path, num_workers=2, max_restarts=0,
                  rejoin_window_s=10.0).run()
    assert report.success, report.to_json()
    assert report.restarts == 0 and report.to_json()["rejoins"] == [1]
    assert report.to_json()["gang_reforms"] == [0]
    names = [e["event"] for e in events.read_events(tmp_path /
                                                   "events.jsonl")]
    assert "worker_rejoin" in names and "recovered" in names


def test_a_crashed_chief_still_restarts_the_gang(tmp_path):
    cmd = _gang("""\
        import os, pathlib, sys

        rank = int(os.environ["TPU_DIST_REJOIN_RANK"])
        marker = pathlib.Path(os.environ["MARK"])
        if rank == 0 and not marker.exists():
            marker.write_text("x")
            sys.exit(9)
    """)
    sup = _sup(cmd, tmp_path, num_workers=2, max_restarts=1,
               rejoin_window_s=10.0)
    sup.env["MARK"] = str(tmp_path / "died")
    report = sup.run()
    assert report.success and report.restarts == 1
    assert report.to_json()["rejoins"] == [0, 0]


def test_the_worker_schedule_reshapes_the_gang(tmp_path):
    cmd = _gang("""\
        import os, sys

        world = int(os.environ.get("TPU_DIST_REJOIN_WORLD", "1"))
        attempt = int(os.environ["TPU_DIST_RESILIENCE_ATTEMPT"])
        sys.exit(3 if attempt == 0 else 0)
    """)
    report = _sup(cmd, tmp_path, num_workers=2, max_restarts=2,
                  worker_schedule=[2, 1], device_schedule=[1, 1]).run()
    assert report.success and report.restarts == 1
    assert report.to_json()["gang_shapes"] == [
        {"num_workers": 2, "device_count": 1},
        {"num_workers": 1, "device_count": 1}]
    with pytest.raises(ValueError, match="worker_schedule"):
        Supervisor(cmd, worker_schedule=[])


# -- the v2 layout ------------------------------------------------------------------------------

def test_two_ranks_write_blocks_the_reference_reads_as_the_v1_arrays(
        ranks):
    two = ranks.two
    v1 = _npz(two / "v1" / "ckpt-0" / "arrays.npz")
    manifest = json.loads((two / "v2s" / "ckpt-0" / "manifest.json")
                          .read_text())
    assert manifest["format"] == "tpu_dist.checkpoint.v2-sharded"
    assert manifest["process_count"] == manifest["device_count"] == 2
    sharded = {k for k, m in manifest["leaves"].items() if m["sharded"]}
    assert sharded and sharded < set(v1)
    index = [json.loads((two / "v2s" / "ckpt-0" / f"shards-{p}.json")
                        .read_text()) for p in (0, 1)]
    assert set(index[0]) == set(index[1]) == sharded
    # No process holds a global sharded leaf: the chief's npz has only
    # the replicated ones.
    assert set(_npz(two / "v2s" / "ckpt-0" / "arrays.npz")) == \
        set(v1) - sharded
    for r in ranks.out2:
        assert r["bytes"][f"arrays-shard-{r['rank']}.npz"] > 0
    # The reference's own restore of the port's v2 step, sync and async.
    for d in ("v2s", "v2a"):
        jm = jlm(VOCAB, SEQ, d_model=32, depth=1, num_heads=4)
        jm.compile(loss=jlosses.SparseCategoricalCrossentropy(
            from_logits=True), optimizer=jopt.Adam(LR))
        assert jckpt.restore_model(two / d, jm) == 0
        got = {k: np.asarray(v) for k, v in
               jckpt._flatten({k: jm.variables[k] for k in
                               ("params", "opt")}).items()}
        _same_bytes(got, v1)


def test_two_to_one_restores_the_v1_bytes(ranks, tmp_path, monkeypatch):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv(EVENT_LOG_ENV, str(log))
    v1 = _npz(ranks.two / "v1" / "ckpt-0" / "arrays.npz")
    for d in ("v2s", "v2a"):
        model = _lm(seed=7)
        assert checkpoint.restore_model(ranks.two / d, model) == 0
        _same_bytes(_arrays(model), v1)
    recs = events.read_events(log, "reshape_restore")
    assert [(r["saved_process_count"], r["process_count"]) for r in recs] \
        == [(2, 1), (2, 1)]


def test_one_to_two_to_one_round_trip_is_bit_for_bit(ranks):
    assert [r["one_step"] for r in ranks.out2] == [0, 0]
    model = _lm(seed=9)
    assert checkpoint.restore_model(ranks.two / "back", model) == 0
    _same_bytes(_arrays(model), ranks.one)


def test_four_ranks_write_each_block_once(ranks):
    d = ranks.four / "dm_v2" / "ckpt-0"
    index = [json.loads((d / f"shards-{p}.json").read_text())
             for p in range(4)]
    # Ranks 2 and 3 (data coordinate 1) hold copies of ranks 0's and 1's
    # blocks: they write none.
    assert index[0] and index[1] and index[2] == index[3] == {}
    model = _lm(seed=2)
    checkpoint.restore_model(ranks.four / "dm_v2", model)
    _same_bytes(_arrays(model), _npz(ranks.four / "dm_v1" / "ckpt-0"
                                     / "arrays.npz"))


def test_async_v2_saves_and_commits_in_one_process(tmp_path):
    model = _lm()
    _fit(model, 2)
    with checkpoint.AsyncCheckpointer(tmp_path, sharded=True,
                                      max_to_keep=2) as ckpt:
        for step in range(3):
            ckpt.save_async(model, step=step)
        assert ckpt.in_flight_step == 2
    assert checkpoint.all_steps(tmp_path) == [1, 2]
    assert checkpoint.latest_complete_step(tmp_path) == 2
    assert not list(tmp_path.glob(".stage-*"))
    back = _lm(seed=4)
    checkpoint.restore_model(tmp_path, back)
    _same_bytes(_arrays(back), _arrays(model))


def _copy(ranks, tmp_path) -> pathlib.Path:
    d = tmp_path / "v2"
    shutil.copytree(ranks.two / "v2s", d)
    return d


def test_a_missing_shard_file_is_refused(ranks, tmp_path):
    d = _copy(ranks, tmp_path)
    (d / "ckpt-0" / "arrays-shard-1.npz").unlink()
    assert "arrays-shard-1.npz" in checkpoint.validate_step_dir(d / "ckpt-0")
    with pytest.raises(ValueError, match="failed validation"):
        checkpoint.restore_model(d, _lm(), step=0)
    (d / "ckpt-0" / "shards-1.json").unlink()
    with pytest.raises(ValueError, match="missing shard files"):
        checkpoint.restore_model(d, _lm(), step=0)


def test_an_index_whose_shape_disagrees_is_refused(ranks, tmp_path):
    d = _copy(ranks, tmp_path)
    path = d / "ckpt-0" / "shards-0.json"
    index = json.loads(path.read_text())
    entry = index[sorted(index)[0]][0]
    entry["slices"][-1][1] += 1
    path.write_text(json.dumps(index))
    with pytest.raises(ValueError, match="refusing to assemble a torn"):
        checkpoint.restore_model(d, _lm(), step=0)


def test_a_model_axis_that_does_not_divide_is_refused(ranks):
    manifest = json.loads((ranks.two / "v2s" / "ckpt-0" / "manifest.json")
                          .read_text())
    sharded = {k for k, m in manifest["leaves"].items() if m["sharded"]}
    model = _lm()
    live = checkpoint._live_tensors(model, gathered=False)
    for size, ok in ((3, False), (2, True), (4, True)):
        trainer = types.SimpleNamespace(
            variables=model._trainer.variables,
            strategy=types.SimpleNamespace(parallel_mesh=mesh_lib.Mesh(
                ("data", "model"), (1, size), torch.device("cpu"))))
        if ok:
            checkpoint._check_divisible_placement(model, trainer, sharded,
                                                  {}, live)
            continue
        with pytest.raises(ValueError, match="does not divide mesh axis "
                                             "'model'"):
            checkpoint._check_divisible_placement(model, trainer, sharded,
                                                  {}, live)
    # A leaf the checkpoint stored replicated degrades gracefully.
    checkpoint._check_divisible_placement(model, trainer, set(), {}, live)


def test_the_port_restores_a_v2_step_the_reference_wrote(tmp_path):
    jm = tdj.models.build_cnn_model()
    tm = cnn.build_cnn_model()
    tm.load_jax_variables(jax_numpy(jm.init(0)))
    jm.compile(optimizer=jopt.Adam(0.01), loss=jlosses.
               SparseCategoricalCrossentropy(from_logits=True))
    tm.compile(optimizer=optimizers.Adam(0.01), loss=losses.
               SparseCategoricalCrossentropy(from_logits=True), device="cpu")
    rng = np.random.default_rng(0)
    data = (rng.random((32, 28, 28, 1), dtype=np.float32),
            rng.integers(0, 10, 32))
    jm.fit(data, epochs=1, verbose=0)
    jckpt.save(tmp_path, jm, step=0, sharded=True)
    assert json.loads((tmp_path / "ckpt-0" / "manifest.json").read_text())[
        "format"] == "tpu_dist.checkpoint.v2-sharded"
    assert checkpoint.restore_model(tmp_path, tm) == 0
    want = {k: np.asarray(v) for k, v in jckpt._flatten(
        {k: jm.variables[k] for k in ("params", "state", "opt")
         if k in jm.variables}).items()}
    _same_bytes(_arrays(tm), want)


def jax_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


# -- reinitialize on live groups ------------------------------------------------------------

def test_two_ranks_redial_the_group_on_the_next_port(ranks):
    for r in ranks.out2:
        assert r["generation"] == 1
        assert r["before"] == r["after"] == [3.0, 3.0]
        assert r["reinit"]["generation"] == 1
        assert r["reinit"]["teardown_s"] < 5.0
    ports = {r["reinit"]["port"] for r in ranks.out2}
    assert len(ports) == 1
    # The sharded LM trains on through the new group as one process does
    # from the same state.
    model = _lm(seed=11)
    checkpoint.restore_model(ranks.two / "v1", model)
    want = _fit(model, 2)
    for r in ranks.out2:
        np.testing.assert_allclose(r["post_reinit_loss"], want, **TP_TOL)


def test_four_ranks_get_their_mesh_subgroups_remade(ranks):
    # Row-major {data: 2, model: 2}: the model axis pairs ranks (0, 1)
    # and (2, 3).
    assert [r["model_axis_sum"] for r in ranks.out4] == [1.0, 1.0, 5.0,
                                                         5.0]
    assert all(r["regrouped"] and r["generation"] == 1 for r in ranks.out4)
    model = _lm(seed=12)
    checkpoint.restore_model(ranks.four / "dm_v1", model)
    want = _fit(model, 2)
    for r in ranks.out4:
        np.testing.assert_allclose(r["post_reinit_loss"], want, **TP_TOL)


# -- the CLI end to end -------------------------------------------------------------------------

@pytest.mark.slow
def test_preempt_and_reshape_end_to_end(tmp_path):
    """Two gloo processes preempted at step 5 (both drain at the same step
    boundary), the restart on one restoring their v2 step; phase 32 (b)
    of ``chip_smoke.py`` runs the same on the card."""
    out = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.resilience", "--device",
         "cpu", "--reshape", "2,1", "--plan", "preempt@step5",
         "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    report = json.loads(out.stdout)
    assert report["exit_kinds"][0] == ["preempted", "preempted"]
    assert [(r["saved_process_count"], r["process_count"])
            for r in report["reshape_restores"]] == [(2, 1)]
    assert report["loss_delta"] <= 1e-5, report
    assert out.returncode == 0 and report["ok"], out.stderr[-3000:]
