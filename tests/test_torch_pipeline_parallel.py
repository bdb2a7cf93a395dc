"""Pipeline parallelism (a ``pipe`` mesh axis): the port against the
reference.

The bar is the reference's (``tests/test_pipeline_parallel.py``): GPipe
and 1F1B change placement only. Outputs, gradients and training equal the
sequential composition of the same stacked stages, while each process
holds one stage.

* one process: ``PipelinedBlocks``' sequential path against the
  reference's fallback scan on bridged weights, value and gradient; the
  init checks; the pipelined LM's logits; the 1F1B timeline's in-flight
  count at M = 16, S = 4 (``min(S, M)`` = 4 stage inputs, where GPipe's
  scan holds M + S - 1 = 19);
* two gloo workers, ``{"data": 1, "pipe": 2}``, one spawn: the pipelined
  LM from the reference's ``init(0)``: one forward and backward against
  the reference's fallback (the gradients gathered over the axis), the
  1F1B step's loss and gradients against the same at the reference's
  ``rtol=5e-4, atol=5e-5`` with its stash counts at M = 4, an SGD loop on
  the 1F1B step, the 1F1B step's errors, a batch the microbatches do not
  divide (one warning, the sequential path), then ``fit`` against the
  reference's fit on one device (its fallback), with the replicated
  leaves bit for bit across the ranks; the fit's checkpoint and saved
  model restored in one process without a pipe axis; the example at a
  tiny size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_dist as tdj
from tpu_dist.models import layers as jlayers
from tpu_dist.models.transformer import build_transformer_lm as jlm
from tpu_dist.parallel.pipeline_parallel import PipelinedBlocks as JPB
from tpu_dist_torch.models import layers
from tpu_dist_torch.models.bridge import params_from_jax, variables_from_jax
from tpu_dist_torch.models.serialize import load_model
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.parallel import (MirroredStrategy, MixtureOfExperts,
                                     PipelinedBlocks, make_1f1b_train_step,
                                     pipeline_1f1b)
from tpu_dist_torch.training import checkpoint
from test_torch_tensor_parallel import _finish, _spawn

VOCAB, SEQ, LR = 29, 16, 1e-2
EPOCHS, STEPS = 2, 4
#: The reference's bars: GPipe against the sequential path (value and
#: gradient), 1F1B against it.
TOL = dict(rtol=2e-4, atol=2e-5)
TOL_1F1B = dict(rtol=5e-4, atol=5e-5)

WORKER = '''
import json, logging
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.parallel import make_1f1b_train_step, tensor
from tpu_dist_torch.parallel import pipeline_parallel
from tpu_dist_torch.training import checkpoint

VOCAB, SEQ, LR = %(vocab)d, %(seq)d, %(lr)r
seq = np.arange(256) * 3 %% VOCAB
XS = np.stack([seq[i:i + SEQ] for i in range(0, 192, 4)]).astype(np.int64)
YS = np.stack([seq[i + 1:i + SEQ + 1] for i in range(0, 192, 4)]).astype(
    np.int64)
strategy = td.MultiWorkerMirroredStrategy(axis_shapes={"data": 1, "pipe": 2},
                                          device="cpu")
rank = td.cluster.process_index()
loss_fn = losses.SparseCategoricalCrossentropy(from_logits=True)
out = {"rank": rank, "replicas": strategy.num_replicas_in_sync}


def lm(compiled=True):
    with strategy.scope():
        model = build_transformer_lm(VOCAB, SEQ, d_model=32, depth=4,
                                     num_heads=4, pipeline_stages=2,
                                     pipeline_microbatches=4, seed=rank)
        if td.cluster.is_chief():
            model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                   np.load("init.npz").items()})
        if compiled:
            model.compile(loss=loss_fn, optimizer=optimizers.Adam(LR),
                          metrics=["accuracy"], device="cpu")
    return model


def gathered(model, tensors):
    _, layout, owners = model._tensor_parallel
    return {n: (tensor.gather_leaf(t, layout[n][0], owners[n])
                if n in layout else t).numpy().tolist()
            for n, t in tensors.items()}


# GPipe: one forward and backward.
model = lm()
model.train()
x, y = torch.from_numpy(XS[:16]), torch.from_numpy(YS[:16])
loss = loss_fn(model(x), y)
loss.backward()
out["gpipe_loss"] = float(loss)
out["gpipe_grads"] = gathered(model, {n: p.grad for n, p in
                                      model.named_parameters()})
out["shapes"] = {n: list(p.shape) for n, p in model.named_parameters()}
out["staging"] = dict(pipeline_parallel.staging)

# 1F1B from the same weights: loss and gradients, the stash's counts.
one = lm(compiled=False)
step = make_1f1b_train_step(one, loss_fn, strategy=strategy)
loss1, grads1 = step(x, y)
out["f1b_loss"] = float(loss1)
out["f1b_grads"] = gathered(one, grads1)
out["f1b_stats"] = dict(step.stats)
try:
    step(x[:10], y[:10])
except ValueError as e:
    out["f1b_indivisible"] = str(e)
opt = optimizers.SGD(0.1)
params = list(one.parameters())
names = [n for n, _ in one.named_parameters()]
state = opt.init(params)
out["f1b_sgd"] = []
for _ in range(8):
    loss1, grads1 = step(x, y)
    opt.update([grads1[n] for n in names], state, params)
    out["f1b_sgd"].append(float(loss1))

# A batch the microbatches do not divide: the sequential path, warned.
records = []
handler = logging.Handler()
handler.emit = records.append
logging.getLogger("tpu_dist_torch.pipeline").addHandler(handler)
with torch.no_grad():
    model.eval()
    out["odd_batch"] = model(torch.from_numpy(XS[:6])).numpy().tolist()
out["warnings"] = [r.getMessage() for r in records]

# fit, its checkpoint and a saved model.
model = lm()
ds = td.data.Dataset.from_tensor_slices((XS, YS)).batch(16).repeat()
out["fit_loss"] = model.fit(ds, epochs=%(epochs)d, steps_per_epoch=%(steps)d,
                            verbose=0).history["loss"]
out["fit_params"] = gathered(model, {n: p.detach() for n, p in
                                     model.named_parameters()})
_, layout, _ = model._tensor_parallel
out["layout"] = sorted(layout)
out["replicated"] = {n: p.detach().numpy().tolist()
                     for n, p in model.named_parameters() if n not in layout}
out["preds"] = model.predict(XS[:4]).tolist()
checkpoint.save("pipe_ckpt", model, step=%(steps)d)
model.save("pipe_saved")

from tpu_dist_torch.examples import pipeline_parallel_lm

out["example"] = pipeline_parallel_lm.main(
    ["--device", "cpu", "--vocab", "31", "--seq-len", "8", "--d-model",
     "16", "--depth", "2", "--epochs", "1", "--steps", "2"])
print(json.dumps(out))
''' % {"vocab": VOCAB, "seq": SEQ, "lr": LR, "epochs": EPOCHS,
       "steps": STEPS}


def _data():
    seq = np.arange(256) * 3 % VOCAB
    xs = np.stack([seq[i:i + SEQ] for i in range(0, 192, 4)])
    ys = np.stack([seq[i + 1:i + SEQ + 1] for i in range(0, 192, 4)])
    return xs.astype(np.int64), ys.astype(np.int64)


def _jlm():
    return jlm(VOCAB, SEQ, d_model=32, depth=4, num_heads=4,
               pipeline_stages=2, pipeline_microbatches=4)


def _port_lm():
    return build_transformer_lm(VOCAB, SEQ, d_model=32, depth=4,
                                num_heads=4, pipeline_stages=2,
                                pipeline_microbatches=4)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    jmodel = _jlm()
    init = jax.tree_util.tree_map(np.asarray, jmodel.init(0))
    np.savez(tmp / "init.npz", **{k: v.numpy() for k, v in
                                  variables_from_jax(init).items()})
    (tmp / "worker.py").write_text(WORKER)
    procs = _spawn(2, tmp / "worker.py", tmp)
    # The reference (one device: its sequential fallback) while they run.
    xs, ys = _data()
    jloss = tdj.ops.SparseCategoricalCrossentropy(from_logits=True)

    def objective(p):
        logits, _ = jmodel.apply(p, init["state"], jnp.asarray(xs[:16]),
                                 training=True)
        return jloss(logits, jnp.asarray(ys[:16]))

    value, grads = jax.value_and_grad(objective)(init["params"])
    ref = {"loss": float(value), "grads": params_from_jax(
        jax.tree_util.tree_map(np.asarray, grads))}
    ref["odd_batch"], _ = jmodel.apply(init["params"], init["state"],
                                       jnp.asarray(xs[:6]))
    jmodel.compile(loss=jloss, optimizer=tdj.ops.Adam(LR),
                   metrics=["accuracy"])
    ds = tdj.data.Dataset.from_tensor_slices((xs, ys)).batch(16).repeat()
    ref["fit_loss"] = jmodel.fit(ds, epochs=EPOCHS, steps_per_epoch=STEPS,
                                 verbose=0).history["loss"]
    outs = _finish(procs)
    # The checkpoint and the saved model in one process, no pipe axis.
    reader = _port_lm()
    reader.compile(loss=losses.SparseCategoricalCrossentropy(
        from_logits=True), optimizer=optimizers.Adam(LR), device="cpu")
    restored = {"step": checkpoint.restore_model(tmp / "pipe_ckpt", reader),
                "params": {n: p.detach().numpy() for n, p in
                           reader.named_parameters()},
                "preds": reader.predict(xs[:4])}
    saved = load_model(tmp / "pipe_saved", device="cpu")
    restored["saved_preds"] = saved.predict(xs[:4])
    restored["saved_kind"] = type(saved.layers[2]).__name__
    # The reference loads the port's directory too.
    restored["jax_preds"] = np.asarray(tdj.models.load_model(
        tmp / "pipe_saved").predict(xs[:4]))
    return outs, ref, restored


# -- one process -------------------------------------------------------------------

def _stage_block(width, mods):
    return mods.Residual(main=(mods.Dense(width * 2, activation="gelu"),
                               mods.Dense(width)), shortcut=(),
                         activation=None)


def test_sequential_path_matches_the_references_fallback_value_and_grad():
    width = 16
    jpb = JPB(block=_stage_block(width, jlayers), num_stages=4,
              microbatches=2)
    params, state, _ = jpb.init(jax.random.PRNGKey(0), (width,))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, width)).astype(np.float32)
    tgt = rng.normal(size=(8, width)).astype(np.float32)

    def objective(p):
        y, _ = jpb.apply(p, state, jnp.asarray(x))
        return ((y - tgt) ** 2).mean()

    value, grads = jax.value_and_grad(objective)(params)
    pb = PipelinedBlocks(block=_stage_block(width, layers), num_stages=4,
                         microbatches=2)
    assert pb.init(torch.Generator().manual_seed(0), (width,)) == (width,)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    pb.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    got = ((pb(torch.from_numpy(x)) - torch.from_numpy(tgt)) ** 2).mean()
    got.backward()
    np.testing.assert_allclose(got.item(), float(value), rtol=1e-5)
    assert sorted(want) == sorted(n for n, _ in pb.named_parameters())
    for n, p in pb.named_parameters():
        assert p.shape[0] == 4
        np.testing.assert_allclose(p.grad.numpy(), want[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_rejects_shape_changing_block():
    pb = PipelinedBlocks(block=layers.Dense(32), num_stages=2)
    with pytest.raises(ValueError, match="preserve shape"):
        pb.init(torch.Generator().manual_seed(0), (16,))


@pytest.mark.parametrize("kind", ["batchnorm", "moe"])
def test_rejects_stateful_block(kind):
    # Running statistics and a mixture's aux loss are state a pipeline
    # cannot thread (the reference's stateless check).
    inner = (layers.BatchNormalization() if kind == "batchnorm" else
             MixtureOfExperts(num_experts=2, ff_dim=8, top_k=1))
    shape = (4, 4, 3) if kind == "batchnorm" else (4, 8)
    pb = PipelinedBlocks(block=layers.Block(layers=(inner,)), num_stages=2)
    with pytest.raises(ValueError, match="stateless"):
        pb.init(torch.Generator().manual_seed(0), shape)


def test_stages_have_distinct_init():
    pb = PipelinedBlocks(block=_stage_block(8, layers), num_stages=3)
    pb.init(torch.Generator().manual_seed(0), (8,))
    kernels = [p for p in pb.parameters() if p.dim() == 3]
    assert kernels and all(k.shape[0] == 3 for k in kernels)
    assert not torch.allclose(kernels[0][0], kernels[0][1])


def test_dropout_block_draws_per_stage():
    blk = layers.Block(layers=(layers.Dense(8, activation="gelu"),
                               layers.Dropout(0.5), layers.Dense(8)))
    pb = PipelinedBlocks(block=blk, num_stages=2, microbatches=2)
    pb.init(torch.Generator().manual_seed(0), (8,))
    pb.generator = torch.Generator().manual_seed(3)
    pb.train()
    y1, y2 = pb(torch.ones(8, 8)), pb(torch.ones(8, 8))
    assert torch.isfinite(y1).all() and not torch.equal(y1, y2)
    pb.eval()
    assert torch.equal(pb(torch.ones(8, 8)), pb(torch.ones(8, 8)))


def test_pipelined_lm_logits_match_the_reference():
    jmodel = _jlm()
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(0))
    model = _port_lm()
    assert sorted(n for n, _ in model.named_parameters()) == sorted(
        params_from_jax(variables["params"]))
    model.load_jax_variables(variables)
    x = np.random.default_rng(4).integers(0, VOCAB, size=(8, SEQ))
    want, _ = jmodel.apply(variables["params"], variables["state"],
                           jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_build_checks_depth_and_exclusivity():
    with pytest.raises(ValueError, match="not divisible by pipeline_stages"):
        build_transformer_lm(VOCAB, SEQ, d_model=16, depth=3, num_heads=2,
                             pipeline_stages=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_transformer_lm(VOCAB, SEQ, d_model=16, depth=2, num_heads=2,
                             moe_experts=4, pipeline_stages=2)


def test_1f1b_timeline_holds_min_s_m_stage_inputs():
    # The O(S) memory claim by counting: at M = 16, S = 4 no stage holds
    # more than min(S, M) = 4 stage inputs at any tick (the reference's
    # GPipe scan holds M + S - 1 = 19 ticks of residuals).
    m, s_count = 16, 4
    held = []
    for s in range(s_count):
        live, most = 0, 0
        for t in range(2 * (m + s_count - 1)):
            if pipeline_1f1b._valid(s, t, m):
                live += 1
            elif pipeline_1f1b._valid(2 * s_count - 1 - s, t, m):
                live -= 1
            most = max(most, live)
        assert live == 0
        held.append(most)
    assert held == [4, 3, 2, 1] and max(held) == min(s_count, m)


def test_split_needs_exactly_one_pipelined_layer():
    pre, _, pb, name, post, _ = pipeline_1f1b.split_pipelined_model(
        _port_lm())
    assert isinstance(pb, PipelinedBlocks) and name == "pipelinedblocks"
    assert len(pre) == 2 and len(post) == 2
    with pytest.raises(ValueError, match="exactly one PipelinedBlocks"):
        pipeline_1f1b.split_pipelined_model(build_transformer_lm(
            VOCAB, SEQ, d_model=16, depth=2, num_heads=2))


def test_1f1b_requires_a_pipe_axis():
    model = _port_lm()
    with pytest.raises(ValueError, match="pipe"):
        make_1f1b_train_step(
            model, losses.SparseCategoricalCrossentropy(from_logits=True),
            strategy=MirroredStrategy(device="cpu"))


# -- two processes -------------------------------------------------------------------

@pytest.mark.multiprocess
def test_gpipe_value_and_grad_match_the_references_fallback(run):
    outs, ref, _ = run
    for o in outs:
        np.testing.assert_allclose(o["gpipe_loss"], ref["loss"], **TOL)
        assert sorted(o["gpipe_grads"]) == sorted(ref["grads"])
        for n, g in ref["grads"].items():
            np.testing.assert_allclose(o["gpipe_grads"][n], g, err_msg=n,
                                       **TOL)
    assert outs[0]["gpipe_grads"] == outs[1]["gpipe_grads"]
    stage = [n for n in outs[0]["shapes"] if ".stages." in n]
    assert stage and all(outs[0]["shapes"][n][0] == 1 for n in stage)
    # Activations and their cotangents crossed the stage boundary.
    assert outs[0]["staging"]["shifts"] > 0


@pytest.mark.multiprocess
def test_1f1b_matches_the_sequential_value_and_grad(run):
    outs, ref, _ = run
    for o in outs:
        np.testing.assert_allclose(o["f1b_loss"], ref["loss"], **TOL_1F1B)
        for n, g in ref["grads"].items():
            np.testing.assert_allclose(o["f1b_grads"][n], g, err_msg=n,
                                       **TOL_1F1B)
        # M = 4, S = 2: a stash of min(S, M) = 2 slots, never more held.
        assert o["f1b_stats"] == {"slots": 2, "max_live": 2 - o["rank"]}
    assert outs[0]["f1b_grads"] == outs[1]["f1b_grads"]
    assert outs[0]["f1b_loss"] == outs[1]["f1b_loss"]


@pytest.mark.multiprocess
def test_1f1b_trains_with_an_optimizer_and_checks_the_batch(run):
    outs, _, _ = run
    for o in outs:
        losses_ = o["f1b_sgd"]
        assert losses_[-1] < losses_[0] * 0.9, losses_
        assert "batch 10 must divide by data axis 1 x microbatches 4" in \
            o["f1b_indivisible"]
    assert outs[0]["f1b_sgd"] == outs[1]["f1b_sgd"]


@pytest.mark.multiprocess
def test_indivisible_batch_falls_back_with_one_warning(run):
    outs, ref, _ = run
    for o in outs:
        np.testing.assert_allclose(o["odd_batch"], np.asarray(
            ref["odd_batch"]), **TOL)
        assert len(o["warnings"]) == 1
        assert "SEQUENTIAL fallback" in o["warnings"][0]


@pytest.mark.multiprocess
def test_fit_matches_the_references_pipeless_fit(run):
    outs, ref, _ = run
    for o in outs:
        np.testing.assert_allclose(o["fit_loss"], ref["fit_loss"], **TOL)
    # Stage leaves split over the axis; replicated leaves bit for bit.
    assert outs[0]["layout"] == sorted(
        n for n in outs[0]["shapes"] if ".stages." in n)
    assert outs[0]["replicated"] == outs[1]["replicated"]
    assert outs[0]["fit_loss"] == outs[1]["fit_loss"]


@pytest.mark.multiprocess
def test_checkpoint_and_saved_model_restore_without_a_pipe_axis(run):
    outs, _, restored = run
    assert restored["step"] == STEPS
    for n, v in outs[0]["fit_params"].items():
        np.testing.assert_array_equal(restored["params"][n], np.asarray(
            v, np.float32), err_msg=n)
    np.testing.assert_allclose(restored["preds"], outs[0]["preds"], **TOL)
    assert restored["saved_kind"] == "PipelinedBlocks"
    np.testing.assert_allclose(restored["saved_preds"], outs[0]["preds"],
                               **TOL)
    np.testing.assert_allclose(restored["jax_preds"], outs[0]["preds"],
                               **TOL)


@pytest.mark.multiprocess
def test_the_pipeline_example_runs(run):
    outs, _, _ = run
    for o in outs:
        ex = o["example"]
        assert ex["stage_local"][0] == 1
        assert ex["stats"] == {"slots": 2, "max_live": 2 - o["rank"]}
        assert all(np.isfinite(ex["loss"] + ex["loss_1f1b"]))
    assert outs[0]["example"]["loss"] == outs[1]["example"]["loss"]
