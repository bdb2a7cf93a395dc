"""The parameter server (``tpu_dist_torch/cluster/ps_transport.py``,
``parallel/ps_strategy.py``, the trainer's PS worker path) against the JAX
package's (CPU).

The transport's round trips, under the reference test names of
``tests/test_ps_strategy.py``, each written by one package and read by the
other (the on-disk format is the reference's byte for byte); the bounded
staleness pull; the step keys; the server's session and its replay. Then
the interop gate: a port worker's pushes applied by a reference
``PSServer`` and a reference worker's by the port's, each session replayed
in both packages from the same bridged weights: the same parameters within
``PARAM_TOL``, and the two workers' gradients on the same weights and
batches within ``GRAD_TOL``. The two packages' replays agree bit for bit
where their SGD arithmetic is the same: XLA on the CPU contracts the
reference's compiled ``p - lr * g`` into one rounding, while the port
rounds twice, as its fused kernel does (``csrc/fused_sgd.cu``, held to
the plain version bit for bit on the card). At a power-of-two rate
``lr * g`` is exact and the two agree; the tiny model trains at
``LR = 2**-3``, and ``test_the_plain_sgd_rounds_twice_where_xla_contracts``
records both answers at 0.1.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import tpu_dist as td
from tpu_dist.cluster import ps_transport as jtransport
from tpu_dist.parallel import ps_strategy as jps
from tpu_dist.training import integrity as jintegrity
from tpu_dist_torch.cluster import ps_transport
from tpu_dist_torch.cluster.ps_transport import DEFAULT_STALENESS, PSDir
from tpu_dist_torch.models import Sequential, layers
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.parallel import ps_strategy
from tpu_dist_torch.parallel.ps_strategy import (ParameterServerStrategy,
                                                 PSServer, arrays_to_tree,
                                                 replay_apply_log,
                                                 tree_to_arrays,
                                                 worker_step_key)
from tpu_dist_torch.resilience import cli as tcli
from tpu_dist_torch.training import integrity

#: Parameters after the same packets in the same order, the two packages'
#: optimizers on the same weights (fp32 rounding).
PARAM_TOL = 1e-5
#: A worker's gradients against the reference worker's on the same weights
#: and batch (fp32 sums in another order).
GRAD_TOL = 1e-5
#: The two sessions' length: one worker, lock-step, 4 applies.
BUDGET = 4
#: The tiny model's SGD rate: a power of two, so ``lr * g`` is exact and
#: both packages' updates round once (module docstring).
LR = 0.125

SIDES = {"port": PSDir, "ref": jtransport.PSDir}


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.rand(3, 2).astype(np.float32),
            "b": rng.rand(2).astype(np.float32)}


# -- the transport, written by one package and read by the other ------------

@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_publish_load_roundtrip(tmp_path, writer, reader):
    arrays = _arrays()
    sums = integrity.host_leaf_checksums(arrays)
    assert sums == jintegrity.host_leaf_checksums(arrays)
    SIDES[writer](tmp_path).ensure().publish_params(
        arrays, version=0, applied={0: 0}, checksums=sums)
    manifest, loaded = SIDES[reader](tmp_path).load_published()
    assert manifest["version"] == 0 and manifest["file"] == "params-0.npz"
    assert manifest["applied"] == {"0": 0}
    assert manifest["checksums"] == sums
    assert loaded.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(loaded[k], arrays[k])


def test_publish_retains_last_two_snapshots(tmp_path):
    psdir = PSDir(tmp_path).ensure()
    for v in range(4):
        arrays = _arrays(v)
        psdir.publish_params(arrays, version=v, applied={0: v},
                             checksums=integrity.host_leaf_checksums(arrays))
    kept = sorted(p.name for p in psdir.params.glob("params-*.npz"))
    assert kept == ["params-2.npz", "params-3.npz"]
    assert jtransport.PSDir(tmp_path).load_published()[0]["version"] == 3


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_push_grad_meta_rides_inside_the_npz(tmp_path, writer, reader):
    arrays = _arrays()
    path = SIDES[writer](tmp_path).ensure().push_grad(
        arrays, rank=1, seq=7, meta={"base_version": 3, "loss": 0.25})
    assert path.name == "g-r1-00000007.npz"
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    meta, loaded = SIDES[reader].load_grad(path)
    assert (meta["rank"], meta["seq"], meta["base_version"]) == (1, 7, 3)
    assert meta["loss"] == 0.25
    for k in arrays:
        np.testing.assert_array_equal(loaded[k], arrays[k])


def test_the_files_hold_the_references_members(tmp_path):
    """The same publish and push by each package: the same npz members
    with the same bytes, the same manifest fields."""
    arrays = _arrays(3)
    sums = integrity.host_leaf_checksums(arrays)
    members = {}
    for side, cls in SIDES.items():
        psdir = cls(tmp_path / side).ensure()
        psdir.publish_params(arrays, version=2, applied={0: 1, 1: 1},
                             checksums=sums)
        grad = psdir.push_grad(arrays, rank=0, seq=4,
                               meta={"base_version": 2, "loss": 0.5})
        with np.load(psdir.params / "params-2.npz") as z:
            params = {k: z[k].tobytes() for k in z.files}
        with np.load(grad) as z:
            packet = {k: (z[k].dtype.str, z[k].shape) for k in z.files}
        manifest = psdir.read_manifest()
        manifest.pop("time")
        members[side] = (params, packet, manifest)
    assert members["port"] == members["ref"]


def test_scan_grads_arrival_order_not_name_order(tmp_path):
    psdir = PSDir(tmp_path).ensure()
    p_late = psdir.push_grad(_arrays(), rank=0, seq=5, meta={})
    p_early = psdir.push_grad(_arrays(), rank=1, seq=0, meta={})
    t = time.time()
    os.utime(p_late, ns=(int(t * 1e9), int((t - 5.0) * 1e9)))
    order = psdir.scan_grads(seen=set())
    assert [p.name for p in order] == [p_late.name, p_early.name]
    assert [p.name for p in jtransport.PSDir(tmp_path).scan_grads(
        seen=set())] == [p.name for p in order]
    assert psdir.scan_grads(seen={p.name for p in order}) == []


def test_scan_grads_equal_mtime_is_name_tiebroken(tmp_path):
    names = [(0, 5), (1, 0), (2, 3), (1, 7), (0, 1)]
    rng = np.random.RandomState(11)
    expected = None
    for trial in range(3):
        psdir = PSDir(tmp_path / f"trial{trial}").ensure()
        for i in rng.permutation(len(names)):
            rank, seq = names[i]
            psdir.push_grad(_arrays(int(i)), rank=rank, seq=seq, meta={})
        ns = int(time.time() * 1e9)
        for p in psdir.grads.iterdir():
            os.utime(p, ns=(ns, ns))
        got = [p.name for p in psdir.scan_grads(seen=set())]
        assert got == sorted(got)
        expected = expected or got
        assert got == expected


def test_apply_log_survives_torn_tail_and_rewrite(tmp_path):
    psdir = PSDir(tmp_path).ensure()
    for i in range(3):
        psdir.append_apply_log({"apply": i + 1, "rank": 0, "seq": i})
    with open(psdir.apply_log, "a", encoding="utf-8") as f:
        f.write('{"apply": 4, "rank"')  # a crash mid-append
    recs = psdir.read_apply_log()
    assert [r["apply"] for r in recs] == [1, 2, 3]
    assert jtransport.PSDir(tmp_path).read_apply_log() == recs
    psdir.rewrite_apply_log(recs[:1])
    assert jtransport.PSDir(tmp_path).read_apply_log() == [
        {"apply": 1, "rank": 0, "seq": 0}]


def test_control_facts(tmp_path):
    psdir = PSDir(tmp_path).ensure()
    ref = jtransport.PSDir(tmp_path)
    assert psdir.stop_requested() is None
    assert psdir.heartbeat_age_s(0) is None
    psdir.heartbeat(0, step=3)
    assert psdir.heartbeat_age_s(0) < 5.0 and ref.heartbeat_age_s(0) < 5.0
    ref.mark_done(1, steps=8)
    assert psdir.done_ranks() == ref.done_ranks() == {1}
    psdir.write_stop(reason="budget", applies=16)
    for side in (psdir, ref):
        stop = side.stop_requested()
        assert (stop["reason"], stop["applies"]) == ("budget", 16)


def test_env_resolvers(monkeypatch):
    def resolved():
        return [(mod.staleness_from_env(), mod.role_from_env(),
                 mod.rank_from_env(), mod.world_from_env(),
                 mod.sync_from_env(), mod.pull_timeout_from_env())
                for mod in (ps_transport, jtransport)]

    for var, value in ((ps_transport.PS_STALENESS_ENV, "7"),
                       (ps_transport.PS_ROLE_ENV, "Server"),
                       (ps_transport.PS_RANK_ENV, "3"),
                       (ps_transport.PS_WORLD_ENV, "5"),
                       (ps_transport.PS_SYNC_ENV, "1"),
                       (ps_transport.PS_PULL_TIMEOUT_ENV, "12.5")):
        monkeypatch.setenv(var, value)
    port, ref = resolved()
    assert port == ref == (7, "server", 3, 5, True, 12.5)
    monkeypatch.setenv(ps_transport.PS_STALENESS_ENV, "lots")
    monkeypatch.setenv(ps_transport.PS_ROLE_ENV, "coordinator")
    monkeypatch.setenv(ps_transport.PS_PULL_TIMEOUT_ENV, "0")
    monkeypatch.delenv(ps_transport.PS_RANK_ENV)
    monkeypatch.setenv("TPU_DIST_REJOIN_RANK", "2")
    port, ref = resolved()
    assert port == ref == (DEFAULT_STALENESS, None, 2, 5, True, 1.0)


# -- the worker's side ---------------------------------------------------------

def _strategy(tmp_path, **kw):
    kw.setdefault("role", "worker")
    kw.setdefault("rank", 0)
    kw.setdefault("num_workers", 1)
    kw.setdefault("staleness", 1)
    kw.setdefault("sync", False)
    kw.setdefault("pull_timeout_s", 1.0)
    return ParameterServerStrategy(str(tmp_path), device="cpu", **kw)


def _publish(psdir, arrays, *, version, applied_mine):
    psdir.publish_params(arrays, version=version, applied={0: applied_mine},
                         checksums=integrity.host_leaf_checksums(arrays))


def test_pull_times_out_past_the_staleness_window(tmp_path):
    strategy = _strategy(tmp_path)
    strategy._pushed = 2
    _publish(strategy.psdir, _arrays(), version=0, applied_mine=0)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="pull timed out"):
        strategy.pull(_arrays())
    assert time.perf_counter() - t0 >= 0.9


def test_pull_releases_once_the_server_catches_up(tmp_path):
    strategy = _strategy(tmp_path)
    strategy._pushed = 2
    tree = {"dense": {"kernel": torch.ones(3, 2), "bias": torch.zeros(2)}}
    arrays = tree_to_arrays(tree)
    assert set(arrays) == {"['dense']['bias']", "['dense']['kernel']"}
    _publish(strategy.psdir, arrays, version=5, applied_mine=1)
    params, version = strategy.pull(tree)
    assert version == 5
    np.testing.assert_array_equal(params["dense"]["kernel"], np.ones((3, 2)))


def test_pull_returns_none_on_stop(tmp_path):
    strategy = _strategy(tmp_path)
    strategy.psdir.write_stop(reason="budget", applies=4)
    assert strategy.pull(_arrays()) is None


def test_pull_aborts_on_checksum_mismatch(tmp_path):
    strategy = _strategy(tmp_path)
    arrays = _arrays()
    sums = integrity.host_leaf_checksums(arrays)
    sums["w"] ^= 1
    strategy.psdir.publish_params(arrays, version=0, applied={0: 0},
                                  checksums=sums)
    with pytest.raises(integrity.IntegrityAbort, match="checksum"):
        strategy.pull(arrays)


def test_sync_mode_pins_lockstep(tmp_path):
    assert _strategy(tmp_path, sync=True, staleness=4).staleness == 0


def test_push_increments_seq_and_embeds_base_version(tmp_path):
    strategy = _strategy(tmp_path)
    tree = _arrays()
    arrays = tree_to_arrays(tree)
    _publish(strategy.psdir, arrays, version=3, applied_mine=0)
    strategy.pull(tree)
    assert strategy.push(arrays, loss=0.5) == 0
    assert strategy.push(arrays, loss=0.4) == 1
    assert strategy.pushed == 2
    meta, _ = jtransport.PSDir.load_grad(
        strategy.psdir.grads / "g-r0-00000001.npz")
    assert (meta["base_version"], meta["loss"]) == (3, 0.4)


def test_step_keys_are_deterministic_and_disjoint():
    draws = {(r, s): tuple(torch.rand(4, generator=worker_step_key(
        0x5EED, rank=r, local_step=s)).tolist())
        for r in range(3) for s in range(4)}
    again = torch.rand(4, generator=worker_step_key(0x5EED, rank=1,
                                                    local_step=2))
    assert tuple(again.tolist()) == draws[(1, 2)]
    assert len(set(draws.values())) == len(draws)
    gen = torch.Generator()
    assert worker_step_key(0x5EED, rank=1, local_step=2,
                           generator=gen) is gen


def test_the_chaos_cli_takes_the_references_ps_arguments():
    from tpu_dist.resilience import cli as jcli

    names = ("ps_world", "ps_epochs", "ps_steps", "ps_batch", "ps_staleness",
             "ps_tol", "ps_legs", "ps_chaos")
    port = vars(tcli.build_parser().parse_args(["--ps-chaos"]))
    ref = vars(jcli.build_parser().parse_args(["--ps-chaos"]))
    assert {n: port[n] for n in names} == {n: ref[n] for n in names}


def test_tree_roundtrip_and_shape_guard():
    params = {"a": np.ones((2, 3), np.float32),
              "b": [np.zeros((4,), np.float32)]}
    arrays = tree_to_arrays(params)
    assert arrays.keys() == jps.tree_to_arrays(params).keys()
    back = arrays_to_tree(params, arrays)
    assert back.keys() == params.keys() and isinstance(back["b"], list)
    bad = dict(arrays)
    bad[next(iter(bad))] = np.zeros((9, 9), np.float32)
    with pytest.raises(ValueError, match="shape"):
        arrays_to_tree(params, bad)
    with pytest.raises(KeyError, match="missing"):
        arrays_to_tree(params, {})


# -- the server, its replay, and the two packages together ---------------------

def _ref_model():
    m = td.Sequential([td.models.Dense(6, activation="relu"),
                       td.models.Dense(3)], input_shape=(4,))
    m.compile(loss=td.ops.SparseCategoricalCrossentropy(from_logits=True),
              optimizer=td.ops.SGD(learning_rate=LR))
    return m


def _port_model(weights=True):
    """The reference test's tiny model, seed 0's reference weights
    bridged in (``weights``)."""
    m = Sequential([layers.Dense(6, activation="relu"), layers.Dense(3)],
                   input_shape=(4,))
    if weights:
        m.load_jax_variables(
            jax.tree_util.tree_map(np.asarray, _ref_model().init(0)))
    m.compile(loss=losses.SparseCategoricalCrossentropy(from_logits=True),
              optimizer=optimizers.SGD(learning_rate=LR), device="cpu")
    return m


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(16, 4).astype(np.float32),
            rng.randint(0, 3, size=(16,)).astype(np.int32))


def test_server_session_replays_to_identical_checksums(tmp_path):
    """A recorded session's retained packets, re-applied in logged order
    from the server's start, give the published snapshot's checksums bit
    for bit, in this package and in the reference's."""
    psdir = PSDir(tmp_path / "ps").ensure()
    params = ps_strategy.params_tree(_port_model())
    rng = np.random.RandomState(7)
    budget = 6
    for i in range(budget):
        grads = {k: rng.normal(scale=0.1, size=a.shape).astype(np.float32)
                 for k, a in tree_to_arrays(params).items()}
        psdir.push_grad(grads, rank=0, seq=i,
                        meta={"base_version": i, "loss": 1.0 - 0.1 * i})
    server = PSServer(_port_model(), psdir, num_workers=1, budget=budget,
                      seed=None, checksum_every=2, retain_grads=True)
    stats = server.run()
    assert (stats["applies"], stats["stop_reason"],
            stats["applied_by_rank"]) == (budget, "budget", {"0": budget})
    log = psdir.read_apply_log()
    assert [r["seq"] for r in log if "rank" in r] == list(range(budget))
    assert [r["applies"] for r in log
            if r.get("event") == "checksum_epoch"] == [2, 4, 6]
    manifest, final = psdir.load_published()
    assert manifest["version"] == budget
    replay = replay_apply_log(psdir, _port_model(), seed=None)
    assert replay["applies"] == budget
    assert replay["checksums"] == manifest["checksums"] == \
        integrity.host_leaf_checksums(final)
    ref = jps.replay_apply_log(jtransport.PSDir(tmp_path / "ps"),
                               _ref_model(), seed=0)
    assert ref == replay


def test_replay_refuses_gced_packets(tmp_path):
    psdir = PSDir(tmp_path / "ps").ensure()
    psdir.append_apply_log({"apply": 1, "rank": 0, "seq": 0})
    with pytest.raises(FileNotFoundError, match="retain_grads"):
        replay_apply_log(psdir, _port_model(), seed=None)


def test_a_server_restart_restores_and_reapplies_past_its_checkpoint(
        tmp_path):
    """maybe_restore: the newest complete checkpoint in place, the apply
    log rewound to it, the packets past it applied again; the session ends
    where an uninterrupted one does."""
    def session(root, kill_after):
        psdir = PSDir(root / "ps").ensure()
        rng = np.random.RandomState(5)
        for i in range(6):
            grads = {k: rng.normal(scale=0.1, size=a.shape).astype(
                np.float32) for k, a in tree_to_arrays(
                    ps_strategy.params_tree(_port_model(False))).items()}
            psdir.push_grad(grads, rank=0, seq=i, meta={"base_version": i})
        ckpt = str(root / "ckpt")
        if kill_after:
            first = PSServer(_port_model(), psdir, num_workers=1,
                             budget=kill_after, seed=None,
                             checkpoint_dir=ckpt, ckpt_every=2)
            first.run()
            # Entries past the last checkpoint describe applies a crash
            # would lose: put one back in the log as a torn server's.
            psdir.append_apply_log({"apply": kill_after + 1, "rank": 0,
                                    "seq": kill_after})
        server = PSServer(_port_model(), psdir, num_workers=1, budget=6,
                          seed=None, checkpoint_dir=ckpt, ckpt_every=2,
                          checksum_every=2)
        stats = server.run()
        return stats, psdir.load_published()[0]["checksums"]

    clean, want = session(tmp_path / "clean", 0)
    stats, got = session(tmp_path / "restarted", 4)
    assert stats["restored_from"] == 4 and stats["applies"] == 6
    assert got == want and clean["applies"] == 6


def _serve_in_thread(make_server):
    box = {}

    def run():
        try:
            box["stats"] = make_server().run()
        except BaseException as exc:  # reraised by the test
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


@pytest.fixture(scope="module")
def interop(tmp_path_factory):
    """Two lock-step sessions of BUDGET applies, one worker each on the
    same bridged weights and batches: a port worker against a reference
    server, and a reference worker against a port server; each server in
    a thread."""
    x, y = _data()
    out = {}
    for worker_side in ("port", "ref"):
        root = tmp_path_factory.mktemp(f"interop_{worker_side}")
        path = str(root / "ps")
        if worker_side == "port":
            thread, box = _serve_in_thread(lambda: jps.PSServer(
                _ref_model(), jtransport.PSDir(path), num_workers=1,
                budget=BUDGET, seed=0, retain_grads=True))
            strategy = ParameterServerStrategy(
                path, role="worker", rank=0, num_workers=1, staleness=0,
                pull_timeout_s=60, device="cpu")
            with strategy.scope():
                model = _port_model(weights=False)
            from tpu_dist_torch.data import Dataset

            ds = Dataset.from_tensor_slices((x, y)).batch(4)
        else:
            thread, box = _serve_in_thread(lambda: PSServer(
                _port_model(), PSDir(path), num_workers=1, budget=BUDGET,
                seed=None, retain_grads=True))
            strategy = jps.ParameterServerStrategy(
                path, role="worker", rank=0, num_workers=1, staleness=0,
                pull_timeout_s=60)
            with strategy.scope():
                model = _ref_model()
            ds = td.data.Dataset.from_tensor_slices((x, y)).batch(4)
        history = model.fit(ds, epochs=1, steps_per_epoch=BUDGET, verbose=0)
        thread.join(60)
        if "error" in box:
            raise box["error"]
        out[worker_side] = {"dir": path, "stats": box["stats"],
                            "pushes": strategy.pushed,
                            "loss": history.history["loss"]}
    return out


@pytest.mark.parametrize("worker_side", ["port", "ref"])
def test_each_packages_server_applies_the_others_pushes(interop,
                                                        worker_side):
    s = interop[worker_side]
    assert s["stats"]["applies"] == BUDGET == s["pushes"]
    assert s["stats"]["stop_reason"] == "budget"
    log = PSDir(s["dir"]).read_apply_log()
    applied = [(r["rank"], r["seq"], r["base_version"]) for r in log
               if "rank" in r]
    # Lock-step: packet k was computed at version k.
    assert applied == [(0, k, k) for k in range(BUDGET)]


@pytest.mark.parametrize("worker_side", ["port", "ref"])
def test_the_same_packets_in_the_same_order_give_the_same_parameters(
        interop, worker_side):
    """Each session replayed in both packages from the same weights: the
    same parameters within PARAM_TOL, the same checksums, and the
    server's own final snapshot."""
    path = interop[worker_side]["dir"]
    port_model = _port_model()
    port = replay_apply_log(PSDir(path), port_model, seed=None)
    ref = jps.replay_apply_log(jtransport.PSDir(path), _ref_model(), seed=0)
    assert port["checksums"] == ref["checksums"]
    manifest, final = PSDir(path).load_published()
    assert manifest["checksums"] == port["checksums"]
    got = tree_to_arrays(ps_strategy.params_tree(port_model))
    for k, v in final.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_TOL)


def test_the_workers_gradients_on_bridged_weights_agree(interop):
    """The two sessions saw the same weights at every version (the port's
    server replays the reference's updates within PARAM_TOL), so the two
    workers' packets, forward and backward on the same batches, agree
    within GRAD_TOL, and so do their losses."""
    for k in range(BUDGET):
        name = f"g-r0-{k:08d}.npz"
        _, port = PSDir.load_grad(PSDir(interop["port"]["dir"]).grads / name)
        _, ref = PSDir.load_grad(PSDir(interop["ref"]["dir"]).grads / name)
        assert port.keys() == ref.keys()
        for key in port:
            np.testing.assert_allclose(port[key], ref[key], rtol=0,
                                       atol=GRAD_TOL, err_msg=key)
    np.testing.assert_allclose(interop["port"]["loss"],
                               interop["ref"]["loss"], rtol=1e-5)


def test_the_plain_sgd_rounds_twice_where_xla_contracts():
    """Both answers: the reference's compiled ``p - lr * g`` is one
    rounding on the CPU (XLA's fused multiply-add), the port's plain SGD
    two (its kernel's ``__fmul_rn`` and ``__fsub_rn``); at a power-of-two
    rate they agree bit for bit, at 0.1 they part by an ulp in some
    elements."""
    from tpu_dist_torch.ops import fused

    rng = np.random.default_rng(4)
    p = rng.standard_normal((257, 33)).astype(np.float32)
    g = (rng.standard_normal((257, 33)) * 0.1).astype(np.float32)
    for lr in (0.1, LR):
        ref_opt = td.ops.SGD(learning_rate=lr)
        ref = np.asarray(jax.jit(lambda p, g: ref_opt.update(
            {"w": g}, ref_opt.init({"w": p}), {"w": p})[0]["w"])(p, g))
        once = (p.astype(np.float64) - np.float64(np.float32(lr))
                * g.astype(np.float64)).astype(np.float32)
        twice = p - np.float32(lr) * g
        got = torch.from_numpy(p.copy())
        fused.fused_sgd_plain([got], [torch.from_numpy(g)], learning_rate=lr)
        np.testing.assert_array_equal(got.numpy(), twice)
        np.testing.assert_array_equal(ref, once)
        assert np.array_equal(once, twice) == (lr == LR)
