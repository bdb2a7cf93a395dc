"""The integrity guard (``tpu_dist_torch/training/integrity.py``) against
the JAX package's (CPU).

The health vector, its window fold, the guard's verdicts on the same
health sequences, the audit's checksum table and the bit flip are held to
the reference's on the same numpy-seeded inputs; then the guard in a
``fit``: a ``nan_loss`` rolls back and ends on the clean fit's loss
exactly (at k = 1 and k = 2), a replay that hits the same step again goes
strictly older, budget exhaustion aborts with ``EXIT_INTEGRITY``, and
quarantine skips the window as the reference's fit does.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_dist as td
from tpu_dist.training import integrity as jint
from tpu_dist_torch.models import Sequential, cnn, layers
from tpu_dist_torch.models.bridge import flatten_keys
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.resilience import FAULT_PLAN_ENV, read_events
from tpu_dist_torch.resilience.events import EVENT_LOG_ENV
from tpu_dist_torch.resilience.faults import EXIT_INTEGRITY
from tpu_dist_torch.training import integrity
from tpu_dist_torch.training.integrity import (IntegrityAbort,
                                               IntegrityConfig,
                                               IntegrityGuard,
                                               RollbackAndReplay)

#: The health norms: fp32 sums of squares in another order (the port reduces
#: per-leaf norms, the reference sums squares leaf by leaf).
HEALTH_RTOL = 1e-5


def _tree(rng, shapes, scale=1.0):
    return {name: np.asarray(scale * rng.standard_normal(shape), np.float32)
            for name, shape in shapes.items()}


SHAPES = {"dense": (4, 8), "dense_bias": (8,), "embed": (16, 3),
          "scalar": ()}


@pytest.mark.parametrize("poison", [None, "loss", "grad"])
def test_health_summary_matches_the_reference(poison):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng, SHAPES), _tree(rng, SHAPES, 3.0)
    new = {k: v - 0.1 * grads[k] for k, v in params.items()}
    loss = np.float32(np.nan if poison == "loss" else 2.5)
    if poison == "grad":
        grads["dense"][1, 2] = np.inf
    want = np.asarray(jint.health_summary(
        jnp.float32(loss), {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in new.items()}))
    t = lambda tree: {k: torch.from_numpy(np.asarray(v))
                      for k, v in tree.items()}
    got = integrity.health_summary(torch.tensor(loss), t(grads), t(params),
                                   t(new)).numpy()
    assert got.dtype == np.float32 and got.shape == (3,)
    assert got[0] == want[0]  # the count exactly
    np.testing.assert_allclose(got[1:], want[1:], rtol=HEALTH_RTOL)


def test_step_health_in_place_equals_the_summary():
    """The armed step's in-place design (a copy before the update, ``old −
    new`` after it) gives ``health_summary`` of the same trees."""
    rng = np.random.default_rng(1)
    params = [torch.from_numpy(v) for v in _tree(rng, SHAPES).values()]
    grads = [torch.from_numpy(v) for v in _tree(rng, SHAPES, 2.0).values()]
    before = [p.clone() for p in params]
    sh = integrity.StepHealth(params)
    sh.before(params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(0.05 * g)
    got = sh.after(torch.tensor(1.0), grads, params)
    want = integrity.health_summary(torch.tensor(1.0), grads, before, params)
    torch.testing.assert_close(got, want, rtol=HEALTH_RTOL, atol=0)


def test_reduce_window_health_matches_the_reference():
    stack = np.random.default_rng(2).random((5, 3)).astype(np.float32)
    stack[:, 0] = [0.0, 1.0, 2.0, 0.0, 3.0]  # non-finite counts
    want = np.asarray(jint.reduce_window_health(jnp.asarray(stack)))
    got = integrity.reduce_window_health(torch.from_numpy(stack)).numpy()
    np.testing.assert_array_equal(got, want)


def _verdicts(guard, healths, error_types):
    """(kind, step) of every anomaly the guard's judgement raises over the
    sequence, the sequence continuing after each (budget set high)."""
    out = []
    for step, h in enumerate(healths):
        try:
            guard._judge(step, 1, np.asarray(h))
        except error_types as exc:
            out.append((exc.kind, exc.gstep))
    return out, guard._ema


def _sequence(seed):
    rng = np.random.default_rng(seed)
    norms = rng.uniform(0.5, 2.0, 40)
    norms[[3, 12, 25]] *= [80.0, 400.0, 30.0]   # spikes (and a near miss)
    seq = [[0.0, n * n, 0.01] for n in norms]
    seq[18][0] = 1.0                                # a NaN loss
    seq[30][1] = np.inf                             # an overflowed norm
    return seq


@pytest.mark.parametrize("cfg, low_precision", [
    ({}, False),
    ({"spike_factor": 10.0, "warmup_steps": 2}, False),
    ({"loss_scale": 1024.0}, False),
    ({"spike_factor": 20.0}, True),                 # bf16 slack x4
    ({"spike_factor": 20.0, "bf16_spike_slack": 1.0}, True),
], ids=["default", "tight", "loss_scale", "bf16_slack", "no_slack"])
def test_guard_verdicts_match_the_reference(cfg, low_precision):
    seq = _sequence(3)
    if cfg.get("loss_scale"):
        seq = [[h[0], h[1] * cfg["loss_scale"] ** 2, h[2]] for h in seq]
    ref = jint.IntegrityGuard(jint.IntegrityConfig(rollback_budget=99, **cfg))
    ours = IntegrityGuard(IntegrityConfig(rollback_budget=99, **cfg))
    for g in (ref, ours):
        g._low_precision, g._lp_known = low_precision, True
    want = _verdicts(ref, seq, jint.RollbackAndReplay)
    got = _verdicts(ours, seq, RollbackAndReplay)
    assert got[0] == want[0] and got[0]
    assert got[1] == pytest.approx(want[1], rel=1e-12)


def test_rollback_plan_goes_strictly_older_as_the_reference():
    ref = jint.IntegrityGuard(jint.IntegrityConfig(rollback_budget=99))
    ours = IntegrityGuard(IntegrityConfig(rollback_budget=99))
    for gstep, restored in ((5, 2), (5, 1), (9, 1), (3, 0)):
        want = ref.rollback_plan(jint.RollbackAndReplay("nan_loss", gstep))
        got = ours.rollback_plan(RollbackAndReplay("nan_loss", gstep))
        assert got == want
        ref.note_rollback(jint.RollbackAndReplay("nan_loss", gstep), restored)
        ours.note_rollback(RollbackAndReplay("nan_loss", gstep), restored)
    assert ours.rollback_plan(RollbackAndReplay("nan_loss", 3)) == 0


def test_health_is_read_one_execution_behind(monkeypatch):
    """Execution N's vector is read only when N + 1 has been queued (or at
    the flush), and nothing in between synchronizes."""
    calls = []
    plain = integrity._HostCopy

    class Recording(plain):
        def start(self, health):
            calls.append(("start", float(health[1])))
            return super().start(health)

        @staticmethod
        def read(buf, event):
            calls.append(("read", float(buf[1])))
            return plain.read(buf, event)

    monkeypatch.setattr(integrity, "_HostCopy", Recording)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(("sync",)))
    guard = IntegrityGuard()
    for step in range(3):
        guard.on_execution(step, 1, torch.tensor([0.0, step + 1.0, 0.1]),
                           None)
    guard.flush()
    guard.flush()  # nothing pending
    assert calls == [("start", 1.0), ("start", 2.0), ("read", 1.0),
                     ("start", 3.0), ("read", 2.0), ("read", 3.0)]


# -- the SDC audit's checksums and the bit flip --------------------------------

def _leaves(seed):
    rng = np.random.default_rng(seed)
    out = {f"['f{i}']": torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
        for i, shape in enumerate([(3, 5), (7,), (), (64, 33)])}
    out["['h']"] = torch.from_numpy(
        rng.standard_normal((9, 4)).astype(np.float32)).to(torch.bfloat16)
    return out


def test_checksum_table_equals_the_references_bit_for_bit():
    from jax.sharding import Mesh, PartitionSpec as P

    leaves = _leaves(4)
    got = integrity.leaf_checksums(leaves.values()).numpy()
    # The reference's host mirror, and its compiled per-device audit on a
    # one-device mesh (bf16 leaves as bf16 arrays there too).
    want = jint.host_leaf_checksums(
        {k: t.float().numpy() for k, t in leaves.items()})
    assert [int(v) for v in got] == [want[k] for k in sorted(leaves)]
    arrays = [jnp.asarray(t.float().numpy(), jnp.bfloat16
                          if t.dtype == torch.bfloat16 else jnp.float32)
              for t in leaves.values()]
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    key = tuple((a.shape, str(a.dtype), str(P())) for a in arrays)
    table = np.asarray(jint.build_audit_checksum(mesh, key)(*arrays))
    assert table.shape == (1, len(arrays))
    assert [int(v) for v in table[0]] == [int(v) for v in got]


def test_host_checksums_and_pull_verification_match_the_reference():
    arrays = {k: t.float().numpy() for k, t in _leaves(6).items()}
    assert integrity.host_leaf_checksums(arrays) == \
        jint.host_leaf_checksums(arrays)
    manifest = {"version": 3,
                "checksums": integrity.host_leaf_checksums(arrays)}
    integrity.verify_pull_checksums(arrays, manifest)
    arrays["['f1']"] = arrays["['f1']"].copy()
    arrays["['f1']"].view(np.uint32)[0] ^= 1
    for verify, error in ((integrity.verify_pull_checksums, IntegrityAbort),
                          (jint.verify_pull_checksums, jint.IntegrityAbort)):
        with pytest.raises(error, match="mismatch on leaves"):
            verify(arrays, manifest)
        with pytest.raises(error, match="missing"):
            verify({}, manifest)


def test_flip_param_bit_flips_what_the_reference_flips():
    """The same leaf index names the same parameter (the reference's sorted
    flatten order, not the module order) and the same element and bit."""
    jm, tm = _cnn_pair()
    params = jax.tree_util.tree_map(np.asarray, jm.init(0)["params"])
    for leaf, bit in ((1, 22), (3, 31), (6, 0), (11, 53)):
        jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
        info_ref = jint.flip_param_bit(jvars, replica=0, leaf=leaf, bit=bit)
        info = integrity.flip_param_bit(tm, replica=0, leaf=leaf, bit=bit)
        assert info["leaf"] == info_ref["leaf"]
        assert info["effective_bit"] == info_ref["effective_bit"]
        assert info["dtype"] == info_ref["dtype"]
        got = {k: t.numpy() for k, t in integrity.named_leaves(tm).items()}
        want = {k: np.asarray(v)
                for k, v in flatten_keys(jvars["params"]).items()}
        for k in want:
            np.testing.assert_array_equal(got[k].view(np.uint32),
                                          want[k].view(np.uint32), err_msg=k)
        # Flip back: the next case starts from the initial weights.
        integrity.flip_param_bit(tm, replica=0, leaf=leaf, bit=bit)


def test_bf16_flip_takes_the_bit_modulo_16():
    t = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    model = torch.nn.Module()
    model.w = t
    info = integrity.flip_param_bit(model, replica=0, bit=22)
    assert info["effective_bit"] == 6 and info["dtype"] == "bfloat16"
    assert t[0].item() == 1.5 and t[1].item() == 1.0   # top mantissa bit


def _cnn_pair():
    from tpu_dist.models import cnn as jcnn

    jm, tm = jcnn.build_cnn_model(), cnn.build_cnn_model()
    tm.load_jax_variables(jax.tree_util.tree_map(np.asarray, jm.init(0)))
    return jm, tm


# -- the guard in a fit ---------------------------------------------------------

def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(64, 4).astype(np.float32)
    y = rng.randint(0, 4, size=(64,)).astype(np.int32)
    return x, y


def _arm(monkeypatch, tmp_path, plan, budget="3", quarantine=False):
    tmp_path.mkdir(parents=True, exist_ok=True)
    if plan:
        monkeypatch.setenv(FAULT_PLAN_ENV, plan)
    else:
        monkeypatch.delenv(FAULT_PLAN_ENV, raising=False)
    monkeypatch.setenv(integrity.INTEGRITY_ENV, "1")
    monkeypatch.setenv(integrity.BUDGET_ENV, budget)
    if quarantine:
        monkeypatch.setenv(integrity.QUARANTINE_ENV, "1")
    monkeypatch.setenv(EVENT_LOG_ENV, str(tmp_path / "events.jsonl"))


def _fit(tmp_path, monkeypatch, *, plan=None, budget="3", k=1, epochs=3,
         quarantine=False, jax_side=False):
    """The reference test's model and data (cardinality == steps per
    epoch), seed-0 weights bridged into the port's model.

    The reference's rollback reads the newest published checkpoint without
    committing a save in flight, so with ``fit``'s own asynchronous
    checkpoint its first rollback finds epoch 0's step only if the writer
    thread has published it by then: on a loaded host it has not, and the
    rollback restarts from the fit's start. The reference side therefore
    saves synchronously (``ModelCheckpoint(async_save=False)`` for the same
    directory replaces ``fit``'s own), so epoch 0's step is published
    before epoch 1 runs. The port keeps ``fit``'s asynchronous checkpoint:
    its rollback commits the save in flight first."""
    _arm(monkeypatch, tmp_path, plan, budget, quarantine)
    x, y = _data()
    callbacks = []
    jm = td.Sequential([td.models.Dense(8, activation="relu"),
                        td.models.Dense(4)], input_shape=(4,))
    if jax_side:
        jm.compile(
            loss=td.ops.SparseCategoricalCrossentropy(from_logits=True),
            optimizer=td.ops.SGD(learning_rate=0.1), steps_per_execution=k)
        ds = td.data.Dataset.from_tensor_slices((x, y)).batch(16)
        model = jm
        callbacks.append(td.training.callbacks.ModelCheckpoint(
            str(tmp_path / "ckpt"), async_save=False))
    else:
        from tpu_dist_torch.data import Dataset

        model = Sequential([layers.Dense(8, activation="relu"),
                            layers.Dense(4)], input_shape=(4,))
        model.load_jax_variables(
            jax.tree_util.tree_map(np.asarray, jm.init(0)))
        model.compile(
            loss=losses.SparseCategoricalCrossentropy(from_logits=True),
            optimizer=optimizers.SGD(learning_rate=0.1),
            steps_per_execution=k, device="cpu")
        ds = Dataset.from_tensor_slices((x, y)).batch(16)
    h = model.fit(ds, epochs=epochs, steps_per_epoch=4, verbose=0,
                  callbacks=callbacks, checkpoint_dir=str(tmp_path / "ckpt"))
    return [float(v) for v in h.history["loss"]]


@pytest.mark.parametrize("k", [1, 2])
def test_nan_loss_rolls_back_and_ends_on_the_clean_loss(tmp_path,
                                                        monkeypatch, k):
    clean = _fit(tmp_path / "clean", monkeypatch, k=k)
    chaos = _fit(tmp_path / "chaos", monkeypatch, plan="nan_loss@step5", k=k)
    events = read_events(tmp_path / "chaos" / "events.jsonl")
    (rb,) = [e for e in events if e["event"] == "integrity_rollback"]
    assert rb["kind"] == "nan_loss"
    assert rb["restored_step"] == 0 and rb["next_epoch"] == 1
    assert chaos[-1] == clean[-1]
    # And the clean fit is the reference's within fp32 rounding.
    want = _fit(tmp_path / "ref", monkeypatch, k=k, jax_side=True)
    np.testing.assert_allclose(clean, want, rtol=1e-5)


def _rollbacks(path):
    return [(r["restored_step"], r["next_epoch"])
            for r in read_events(path / "events.jsonl", "integrity_rollback")]


def test_a_second_hit_at_the_same_step_restores_strictly_older(
        tmp_path, monkeypatch):
    """Three firings: the first pass poisons steps 5 and 6 (its judgement
    of step 5 comes one execution behind), the replay step 5 again."""
    plan = "nan_loss@step5:x3"
    clean = _fit(tmp_path / "clean", monkeypatch)
    chaos = _fit(tmp_path / "chaos", monkeypatch, plan=plan)
    _fit(tmp_path / "ref", monkeypatch, plan=plan, jax_side=True)
    # Step 0, then (no published step before it) the fit's start.
    assert _rollbacks(tmp_path / "chaos") == [(0, 1), (None, 0)]
    assert _rollbacks(tmp_path / "ref") == _rollbacks(tmp_path / "chaos")
    assert chaos[-1] == clean[-1]


def test_budget_exhaustion_aborts_with_exit_integrity(tmp_path, monkeypatch):
    with pytest.raises(IntegrityAbort):
        _fit(tmp_path, monkeypatch, plan="nan_loss@step5:x5", budget="1")
    kinds = [e["event"] for e in read_events(tmp_path / "events.jsonl")]
    assert "integrity_budget_exhausted" in kinds
    from tpu_dist_torch.resilience import entrypoints

    def boom():
        raise IntegrityAbort("synthetic")

    prev_handler = signal.getsignal(signal.SIGTERM)
    prev_armed = entrypoints._PREEMPT_ARMED
    try:
        assert entrypoints.run_entry(boom) == EXIT_INTEGRITY
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        entrypoints._PREEMPT_ARMED = prev_armed


def test_quarantine_skips_the_window_as_the_reference_does(tmp_path,
                                                           monkeypatch):
    plan = "nan_loss@step5:x5"
    got = _fit(tmp_path / "port", monkeypatch, plan=plan, quarantine=True)
    want = _fit(tmp_path / "ref", monkeypatch, plan=plan, quarantine=True,
                jax_side=True)
    skips = [[(s["step"], s["window"]) for s in read_events(
        tmp_path / side / "events.jsonl", "integrity_quarantine_skip")]
        for side in ("port", "ref")]
    assert skips[0] == skips[1] and skips[0][0] == (5, 1)
    # Each hit restores epoch 0's published step and replays epoch 1, the
    # quarantine growing by the hit step each time.
    assert _rollbacks(tmp_path / "port") == [(0, 1), (0, 1), (0, 1)]
    assert _rollbacks(tmp_path / "port") == _rollbacks(tmp_path / "ref")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_the_plain_ce_fills_out_of_range_labels_with_nan_as_the_reference():
    """A token batch's ``nan_loss`` sets its labels to 2**30: the
    reference's ``take_along_axis`` fills such a row's loss with NaN (and
    counts a negative label from the end); PyTorch's gather would index out
    of bounds."""
    from tpu_dist.ops import losses as jlosses

    logits = np.random.default_rng(5).standard_normal((6, 4)).astype(
        np.float32)
    labels = np.array([0, 3, -1, -4, -5, 2 ** 30])
    want = np.asarray(jlosses.sparse_categorical_crossentropy(
        jnp.asarray(logits), jnp.asarray(labels)))
    got = losses.sparse_categorical_crossentropy(
        torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isnan(got[4:]).all()
