"""Ring attention over a ``seq`` mesh axis: gloo workers against the
reference.

The bar is the reference's (``tests/test_sequence.py``): ring attention
equals dense softmax attention on the gathered arrays, in value and
gradient, bidirectional and causal, on a ``seq`` mesh and on a ``data x
seq`` one. Two spawns serve every case, each with its own timeout:

* two workers, ``{"data": 1, "seq": 2}``: ``ring_attention`` on each
  process's block of seeded q, k, v (``sequence_sharding``), the blocks of
  the output and of the gradients of a seeded cotangent gathered by the
  test, against the reference's ``ring_attention`` on two devices and
  against dense attention, at atol = rtol = 1e-5; a forced ``kv_chunk``
  (2), an indivisible one (3, the automatic rule's result bit for bit),
  a custom scale; ``RingAttention``'s late mesh (the scope's) against the
  function and an explicit mesh, and its indivisible length's error;
  ``examples/long_context_ring_attention.py`` at a tiny size;
* four workers, ``{"data": 2, "seq": 2}``: the same with the batch over
  the data axis (``batch_axis="data"``), and the LM with
  ``RingAttention(batch_axis="data")`` fit from the reference's
  ``init(0)``: its losses equal the reference's fit of the same LM on the
  same mesh at 1e-5, then ``save_model`` / ``load_model`` under the scope
  round-trip it (the spec comes back, its mesh not stored; predictions
  equal).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_dist as tdj
from tpu_dist.models.transformer import build_transformer_lm as jlm
from tpu_dist.parallel import make_mesh as jmake_mesh
from tpu_dist.parallel import sequence as jsequence
from tpu_dist_torch.models.bridge import params_from_jax, variables_from_jax
from tpu_dist_torch.parallel import MirroredStrategy, RingAttention
from tpu_dist_torch.parallel import mesh as mesh_lib
from tpu_dist_torch.parallel import sequence
from test_torch_tensor_parallel import _finish, _spawn

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPE2 = (2, 3, 32, 8)      # [B, H, L, D] on {seq: 2}
SHAPE4 = (4, 3, 16, 8)      # on {data: 2, seq: 2}
VOCAB, LN = 11, 16
#: The reference's hybrid-mesh LM fit (``tests/test_transformer.py:170``):
#: 4 epochs of 5 steps.
HYBRID_EPOCHS = 4

COMMON = '''
import json, sys
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.parallel import (RingAttention, ring_attention,
                                     sequence_sharding)
from tpu_dist_torch.parallel.sequence import ring_attention_blocks


def ring(strategy, arrays, batch_axis=None, **kw):
    """Each process's blocks of the output and of the gradients of
    sum(out * do), for each causal flag."""
    mesh = strategy.mesh
    place = sequence_sharding(mesh, batch_axis=batch_axis).place
    out = {}
    for causal in (False, True):
        q, k, v = (place(arrays[n]).requires_grad_() for n in "qkv")
        o = ring_attention_blocks(q, k, v, mesh=mesh, causal=causal,
                                  batch_axis=batch_axis, **kw)
        grads = torch.autograd.grad((o * place(arrays["do"])).sum(),
                                    (q, k, v))
        out[causal] = [o.detach().numpy().tolist()] + [
            g.numpy().tolist() for g in grads]
    return out
'''

WORKER2 = COMMON + '''
strategy = td.MultiWorkerMirroredStrategy(axis_shapes={"data": 1, "seq": 2},
                                          device="cpu")
a = np.load("qkv2.npz")
out = {"rank": td.cluster.process_index(), "plain": ring(strategy, a),
       "chunk2": ring(strategy, a, kv_chunk=2),
       "chunk3": ring(strategy, a, kv_chunk=3),
       "scale": ring(strategy, a, scale=0.25)}
full = [torch.from_numpy(a[n]) for n in "qkv"]
with strategy.scope():
    late = RingAttention()(*full, causal=True)
explicit = RingAttention(mesh=strategy.mesh)(*full, causal=True)
out["late"] = late.numpy().tolist()
out["late_equal"] = bool(torch.equal(late, explicit))
try:
    with strategy.scope():
        RingAttention()(*(t[:, :, :15] for t in full))
except ValueError as e:
    out["indivisible"] = str(e)

# The reference's attention_fn contract: partial(ring_attention) on the
# whole sequence, in a layer and in an LM's fit.
import functools
from tpu_dist_torch.models.transformer import (MultiHeadAttention,
                                               build_transformer_lm)
from tpu_dist_torch.ops import losses, optimizers

mha = np.load("mha.npz")


def mha_run(fn):
    layer = MultiHeadAttention(num_heads=2, key_dim=8, causal=True,
                               attention_fn=fn)
    layer.init(torch.Generator().manual_seed(0), (8, 16))
    names = [n for n, _ in layer.named_parameters()]
    layer.load_state_dict({n: torch.from_numpy(mha[n]) for n in names})
    x = torch.from_numpy(mha["x"]).requires_grad_()
    y = layer(x)
    grads = torch.autograd.grad((y * torch.from_numpy(mha["dy"])).sum(),
                                [x, *layer.parameters()])
    return {"y": y.detach().numpy().tolist(),
            **{n: g.numpy().tolist() for n, g in zip(["x", *names], grads)}}


ring_fn = functools.partial(ring_attention, mesh=strategy.mesh,
                            axis_name="seq", causal=True)
out["mha_ring"] = mha_run(ring_fn)
out["mha_dense"] = mha_run(None)
out["spec_bits"] = bool(torch.equal(
    RingAttention(mesh=strategy.mesh)(*full, causal=True),
    ring_attention(*full, mesh=strategy.mesh, causal=True)))
VOCAB, LN = %(vocab)d, %(ln)d
seq = np.arange(512) * 3 %% VOCAB
xs = np.stack([seq[i:i + LN] for i in range(0, 480, 4)]).astype(np.int64)
ys = np.stack([seq[i + 1:i + LN + 1] for i in range(0, 480, 4)]).astype(
    np.int64)
with strategy.scope():
    model = build_transformer_lm(
        VOCAB, LN, d_model=32, depth=1, num_heads=2,
        attention_fn=functools.partial(ring_attention, mesh=strategy.mesh,
                                       axis_name="seq", causal=True,
                                       batch_axis="data"))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in np.load("lm.npz").items()})
    model.compile(loss=losses.SparseCategoricalCrossentropy(
        from_logits=True), optimizer=optimizers.Adam(learning_rate=0.01),
        metrics=["accuracy"], device="cpu")
    ds = td.data.Dataset.from_tensor_slices((xs, ys)).batch(24).repeat()
    out["hybrid_lm"] = model.fit(ds, epochs=%(epochs)d, steps_per_epoch=5,
                                 verbose=0).history

from tpu_dist_torch.examples import long_context_ring_attention

out["example"] = long_context_ring_attention.main(
    ["--device", "cpu", "--seq-len", "64", "--heads", "2", "--head-dim",
     "8", "--check", "32"])
print(json.dumps(out))
''' % {"vocab": VOCAB, "ln": LN, "epochs": HYBRID_EPOCHS}

WORKER4 = COMMON + '''
from tpu_dist_torch.models import load_model
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import losses, optimizers

strategy = td.MultiWorkerMirroredStrategy(axis_shapes={"data": 2, "seq": 2},
                                          device="cpu")
out = {"rank": td.cluster.process_index(),
       "replicas": strategy.num_replicas_in_sync,
       "plain": ring(strategy, np.load("qkv4.npz"), batch_axis="data")}
VOCAB, LN = %(vocab)d, %(ln)d
seq = np.arange(256) * 3 %% VOCAB
xs = np.stack([seq[i:i + LN] for i in range(0, 192, 4)]).astype(np.int64)
ys = np.stack([seq[i + 1:i + LN + 1] for i in range(0, 192, 4)]).astype(
    np.int64)
with strategy.scope():
    model = build_transformer_lm(
        VOCAB, LN, d_model=32, depth=1, num_heads=2,
        attention_fn=RingAttention(batch_axis="data"))
    if td.cluster.is_chief():
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in np.load("lm.npz").items()})
    model.compile(loss=losses.SparseCategoricalCrossentropy(
        from_logits=True), optimizer=optimizers.Adam(learning_rate=0.01),
        metrics=["accuracy"], device="cpu")
    ds = td.data.Dataset.from_tensor_slices((xs, ys)).batch(24).repeat()
    out["loss"] = model.fit(ds, epochs=1, steps_per_epoch=3,
                            verbose=0).history["loss"]
    model.save("ring_lm")
    loaded = load_model("ring_lm", device="cpu")
    attn = loaded.layers[2].layers[0].main["multiheadattention"].attention_fn
    out["spec"] = [type(attn).__name__, attn.mesh is None, attn.batch_axis]
    x = xs[:4]
    out["preds_equal"] = bool(np.array_equal(model.predict(x),
                                             loaded.predict(x)))
print(json.dumps(out))
''' % {"vocab": VOCAB, "ln": LN}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=shape).astype(np.float32) for n in
            ("q", "k", "v", "do")}


def _dense(q, k, v, *, causal=False, scale=None):
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        ln = q.shape[2]
        s = jnp.where(np.tril(np.ones((ln, ln), bool)), s, -jnp.inf)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


def _value_and_grads(fn, a, **kw):
    """fn's output and the gradients of sum(out * do) for q, k, v, in one
    jitted program."""
    def loss(q, k, v):
        out = fn(q, k, v, **kw)
        return (out * a["do"]).sum(), out

    args = [jnp.asarray(a[n]) for n in "qkv"]
    grads, out = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *args)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _assemble(outs, key, causal, data: int):
    """The global output and gradients from the workers' blocks (ranks
    row-major over (data, seq)); each entry a list of 4 arrays."""
    seq = len(outs) // data
    per = [[np.asarray(t) for t in o[key][str(causal).lower()]]
           for o in outs]
    return [np.concatenate([np.concatenate(
        [per[d * seq + s][i] for s in range(seq)], axis=2)
        for d in range(data)], axis=0) for i in range(4)]


def _mha_case() -> dict:
    """The reference's ``MultiHeadAttention(2, 8)`` params at seed 0 (its
    ``_mha`` helper), bridged, and a seeded x of ``[2, 8, 16]`` (as in
    ``tests/test_transformer.py:128``) with a seeded cotangent."""
    from tpu_dist.models.transformer import MultiHeadAttention as JMHA

    params, _, _ = JMHA(num_heads=2, key_dim=8, causal=True).init(
        jax.random.PRNGKey(0), (8, 16))
    out = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    rng = np.random.default_rng(3)
    out["x"] = rng.normal(size=(2, 8, 16)).astype(np.float32)
    out["dy"] = rng.normal(size=(2, 8, 16)).astype(np.float32)
    return out


def _jax_mha(case: dict) -> dict:
    """The reference's dense causal layer on ``case``: the output and the
    gradients of sum(y * dy) for x and every parameter."""
    from tpu_dist.models.transformer import MultiHeadAttention as JMHA

    layer = JMHA(num_heads=2, key_dim=8, causal=True)
    names = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")
    params = {n: jnp.asarray(case[n]) for n in names}

    def loss(p, x):
        y, _ = layer.apply(p, {}, x)
        return (y * case["dy"]).sum(), y

    (gp, gx), y = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(case["x"]))
    return {"y": np.asarray(y), "x": np.asarray(gx),
            **{n: np.asarray(gp[n]) for n in names}}


@pytest.fixture(scope="module")
def run(eight_devices, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequence")
    a2, a4 = _qkv(SHAPE2, 0), _qkv(SHAPE4, 1)
    np.savez(tmp / "qkv2.npz", **a2)
    np.savez(tmp / "qkv4.npz", **a4)
    jmodel = jlm(VOCAB, LN, d_model=32, depth=1, num_heads=2,
                 attention_fn=jsequence.RingAttention(batch_axis="data"))
    init = jax.tree_util.tree_map(np.asarray, jmodel.init(0))
    np.savez(tmp / "lm.npz", **{k: v.numpy() for k, v in
                                variables_from_jax(init).items()})
    mha = _mha_case()
    np.savez(tmp / "mha.npz", **mha)
    procs = {}
    for n, text in ((2, WORKER2), (4, WORKER4)):
        (tmp / f"worker{n}.py").write_text(text)
        procs[n] = _spawn(n, tmp / f"worker{n}.py", tmp)
    # The reference while the workers run.
    mesh2 = jmake_mesh({"seq": 2}, devices=jax.devices()[:2])
    mesh4 = jmake_mesh({"data": 2, "seq": 2}, devices=jax.devices()[:4])
    ref = {}
    for causal in (False, True):
        ref["ring2", causal] = _value_and_grads(
            jsequence.ring_attention, a2, mesh=mesh2, axis_name="seq",
            causal=causal)
        ref["dense2", causal] = _value_and_grads(_dense, a2, causal=causal)
        ref["scale2", causal] = _value_and_grads(
            jsequence.ring_attention, a2, mesh=mesh2, axis_name="seq",
            causal=causal, scale=0.25)
        ref["ring4", causal] = _value_and_grads(
            jsequence.ring_attention, a4, mesh=mesh4, axis_name="seq",
            causal=causal, batch_axis="data")
        ref["dense4", causal] = _value_and_grads(_dense, a4, causal=causal)
    strategy = tdj.MirroredStrategy(devices=jax.devices()[:4],
                                    axis_shapes={"data": 2, "seq": 2})
    seq = np.arange(256) * 3 % VOCAB
    xs = np.stack([seq[i:i + LN] for i in range(0, 192, 4)]).astype(np.int64)
    ys = np.stack([seq[i + 1:i + LN + 1] for i in range(0, 192, 4)]).astype(
        np.int64)
    with strategy.scope():
        jmodel.compile(loss=tdj.ops.SparseCategoricalCrossentropy(
            from_logits=True), optimizer=tdj.ops.Adam(learning_rate=0.01),
            metrics=["accuracy"])
        ds = tdj.data.Dataset.from_tensor_slices((xs, ys)).batch(24).repeat()
        ref["lm_loss"] = jmodel.fit(ds, epochs=1, steps_per_epoch=3,
                                    verbose=0).history["loss"]
    ref["mha_dense"] = _jax_mha(mha)
    jdense = jlm(VOCAB, LN, d_model=32, depth=1, num_heads=2)
    jdense.compile(loss=tdj.ops.SparseCategoricalCrossentropy(
        from_logits=True), optimizer=tdj.ops.Adam(learning_rate=0.01),
        metrics=["accuracy"])
    seq = np.arange(512) * 3 % VOCAB
    xs = np.stack([seq[i:i + LN] for i in range(0, 480, 4)]).astype(np.int64)
    ys = np.stack([seq[i + 1:i + LN + 1] for i in range(0, 480, 4)]).astype(
        np.int64)
    ds = tdj.data.Dataset.from_tensor_slices((xs, ys)).batch(24).repeat()
    ref["hybrid_lm"] = jdense.fit(ds, epochs=HYBRID_EPOCHS, steps_per_epoch=5,
                                  verbose=0).history
    outs = {n: _finish(p) for n, p in procs.items()}
    return outs, ref, a2


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.multiprocess
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_the_reference_and_dense_in_value_and_grad(run, causal):
    outs, ref, _ = run
    got = _assemble(outs[2], "plain", causal, 1)
    _close(got, ref["ring2", causal])
    _close(got, ref["dense2", causal])


@pytest.mark.multiprocess
@pytest.mark.parametrize("causal", [False, True])
def test_combined_data_and_seq_axes(run, causal):
    outs, ref, _ = run
    assert all(o["replicas"] == 2 for o in outs[4])
    got = _assemble(outs[4], "plain", causal, 2)
    _close(got, ref["ring4", causal])
    _close(got, ref["dense4", causal])


@pytest.mark.multiprocess
@pytest.mark.parametrize("causal", [False, True])
def test_kv_chunking_forced_and_indivisible(run, causal):
    outs, ref, _ = run
    _close(_assemble(outs[2], "chunk2", causal, 1), ref["dense2", causal])
    # An indivisible chunk falls back to the automatic rule: the same bits.
    for i, (g, w) in enumerate(zip(_assemble(outs[2], "chunk3", causal, 1),
                                   _assemble(outs[2], "plain", causal, 1))):
        np.testing.assert_array_equal(g, w, err_msg=str(i))


@pytest.mark.multiprocess
@pytest.mark.parametrize("causal", [False, True])
def test_custom_scale(run, causal):
    outs, ref, _ = run
    _close(_assemble(outs[2], "scale", causal, 1), ref["scale2", causal])


@pytest.mark.multiprocess
def test_ring_attention_spec_resolves_the_scopes_mesh(run):
    outs, ref, _ = run
    for o in outs[2]:
        assert o["late_equal"]
        np.testing.assert_allclose(o["late"], ref["dense2", True][0], **TOL)
        assert "not divisible by mesh axis 'seq' size 2" in o["indivisible"]


@pytest.mark.multiprocess
def test_lm_with_ring_attention_fits_as_the_reference_and_round_trips(run):
    outs, ref, _ = run
    for o in outs[4]:
        np.testing.assert_allclose(o["loss"], ref["lm_loss"], **TOL)
        assert o["loss"] == outs[4][0]["loss"]
        assert o["spec"] == ["RingAttention", True, "data"]
        assert o["preds_equal"]


@pytest.mark.multiprocess
def test_the_long_context_example_runs(run):
    outs, _, _ = run
    ex = [o["example"] for o in outs[2]]
    assert ex[0]["block"] == ex[1]["block"] == [2, 2, 32, 8]
    assert ex[0]["max_abs_err"] < 3e-5 and ex[1]["max_abs_err"] is None


@pytest.mark.multiprocess
def test_ring_attention_fn_matches_dense(run):
    # The reference's test_transformer.py:128: a causal layer whose
    # attention_fn is partial(ring_attention, mesh=, axis_name="seq",
    # causal=True) equals the dense layer (atol = rtol = 2e-5, its bar),
    # here in value and gradient on both ranks of {data: 1, seq: 2}.
    outs, ref, _ = run
    want = ref["mha_dense"]
    for o in outs[2]:
        assert sorted(o["mha_ring"]) == sorted(want)
        for name, w in want.items():
            np.testing.assert_allclose(o["mha_ring"][name], w, atol=2e-5,
                                       rtol=2e-5, err_msg=name)
            np.testing.assert_allclose(o["mha_dense"][name], w, atol=2e-5,
                                       rtol=2e-5, err_msg=name)
    assert outs[2][0]["mha_ring"] == outs[2][1]["mha_ring"]


@pytest.mark.multiprocess
def test_ring_attention_spec_equals_the_function_bit_for_bit(run):
    # The reference's test_transformer.py:230, on the same arrays.
    outs, _, _ = run
    assert all(o["spec_bits"] for o in outs[2])


@pytest.mark.multiprocess
def test_ring_attention_lm_trains_on_hybrid_mesh(run):
    # The reference's test_transformer.py:170 on {data: 1, seq: 2}: the LM
    # with partial(ring_attention, ..., causal=True, batch_axis="data")
    # fits as the reference's dense LM from the same weights does.
    outs, ref, _ = run
    want = ref["hybrid_lm"]
    for o in outs[2]:
        got = o["hybrid_lm"]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=2e-5,
                                   rtol=2e-5)
        assert got["accuracy"][-1] > 0.9, got
    a, b = (o["hybrid_lm"] for o in outs[2])
    assert (a["loss"], a["accuracy"]) == (b["loss"], b["accuracy"])


def test_rejects_cross_attention_shapes():
    mesh = mesh_lib.Mesh(("data", "seq"), (1, 1), torch.device("cpu"))
    q = torch.zeros(1, 2, 16, 4)
    k = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="self-attention"):
        sequence.ring_attention_blocks(q, k, k, mesh=mesh)


def test_ring_attention_spec_without_seq_axis_raises_actionably():
    q = torch.zeros(1, 2, 8, 4)
    with MirroredStrategy(device="cpu").scope():
        with pytest.raises(ValueError, match="axis_shapes"):
            RingAttention()(q, q, q, causal=True)


def test_kv_chunk_rule_is_the_references():
    # Explicit chunks that divide are kept; others fall back to 2048 above
    # 4096 positions (when it divides), else none.
    assert sequence._chunk(2, 32) == 2
    assert sequence._chunk(3, 32) is None
    assert sequence._chunk(None, 4096) is None
    assert sequence._chunk(None, 8192) == 2048
    assert sequence._chunk(3, 8192) == 2048
    assert sequence._chunk(None, 6000) is None
    assert (sequence._KV_CHUNK_AUTO_THRESHOLD, sequence._KV_CHUNK_DEFAULT) \
        == (jsequence._KV_CHUNK_AUTO_THRESHOLD, jsequence._KV_CHUNK_DEFAULT)
