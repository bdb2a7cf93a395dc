"""Expert parallelism (an ``expert`` mesh axis): the port against the
reference.

The bar is the reference's (``tests/test_expert.py``): with a fixed
``groups`` the all_to_all path equals the local einsum math on any
topology, drops included; the experts shard over the axis; capacity drops
follow the GShard queue rule; the Switch aux loss reaches the objective.

* one process: ``_route`` against the reference's on seeded gates
  (shapes, mass, drops by token order), a dropped token's zero
  contribution, the layer's local math against the reference's on bridged
  weights in value and gradient, ``moe_every``, the MoE LM's fit against
  the reference's (the aux loss in both objectives), a save/load round
  trip;
* two gloo workers, ``{"data": 1, "expert": 2}``, one spawn: the layer
  with forced drops against the reference's local math in value and
  gradient (the experts' gradients gathered over the axis), a group count
  the mesh does not divide (the local fallback, one warning), the MoE LM's
  fit against the reference's local fit with the experts ``[E / 2, ...]``
  a rank and the router bit for bit across the ranks, a saved model loaded
  in one process, the example at a tiny size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_dist as tdj
from tpu_dist.models.transformer import build_transformer_lm as jlm
from tpu_dist.parallel.expert import MixtureOfExperts as JMoE
from tpu_dist.parallel.expert import _route as jroute
from tpu_dist_torch.models.bridge import params_from_jax, variables_from_jax
from tpu_dist_torch.models.serialize import load_model
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.parallel import MixtureOfExperts
from tpu_dist_torch.parallel.expert import _route
from test_torch_tensor_parallel import _finish, _spawn

#: The reference's bar for the mesh against the local math (outputs), and
#: its bar for gradients of a placement change (``tests/
#: test_pipeline_parallel.py:73``; its expert tests compare none): the
#: router's gradient is two processes' partial sums on the mesh.
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
V, L, LR = 61, 8, 1e-2
LAYER = dict(num_experts=8, ff_dim=64, top_k=2, groups=8,
             capacity_factor=0.6)

WORKER = '''
import json, logging
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.models.model import Sequential
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import losses, optimizers
from tpu_dist_torch.parallel import MixtureOfExperts, tensor

V, L, LR = %(v)d, %(l)d, %(lr)r
strategy = td.MultiWorkerMirroredStrategy(
    axis_shapes={"data": 1, "expert": 2}, device="cpu")
rank = td.cluster.process_index()
out = {"rank": rank}
loss_fn = losses.SparseCategoricalCrossentropy(from_logits=True)


def gathered(model, tensors):
    _, layout, owners = model._tensor_parallel
    return {n: (tensor.gather_leaf(t, layout[n][0], owners[n])
                if n in layout else t).numpy().tolist()
            for n, t in tensors.items()}


def placed(layer, weights, shape):
    with strategy.scope():
        model = Sequential([layer], input_shape=shape, seed=rank)
        if td.cluster.is_chief():
            model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                   np.load(weights).items()}, strict=False)
        model.compile(loss=loss_fn, optimizer="sgd", device="cpu")
    return model


# The layer with forced drops, value and gradient.
case = np.load("layer.npz")
model = placed(MixtureOfExperts(**%(layer)r), "layer_w.npz", (8, 32))
x = torch.from_numpy(case["x"]).requires_grad_()
y = model(x)
(y * torch.from_numpy(case["dy"])).sum().backward()
out["layer_y"] = y.detach().numpy().tolist()
out["layer_grads"] = gathered(model, {"x": x.grad, **{
    n: p.grad for n, p in model.named_parameters()}})
out["layer_aux"] = float(model.layers[0].aux_loss)
out["layout"] = sorted(model._tensor_parallel[1])
out["w1_local"] = list(model.layers[0].w1.shape)

# A group count the mesh does not divide: the local math, warned once.
records = []
handler = logging.Handler()
handler.emit = records.append
logging.getLogger("tpu_dist_torch.expert").addHandler(handler)
odd = placed(MixtureOfExperts(num_experts=8, ff_dim=64, top_k=2, groups=3),
             "odd_w.npz", (6, 32))
with torch.no_grad():
    for _ in range(2):
        out["odd_y"] = odd(torch.from_numpy(case["x_odd"])).numpy().tolist()
out["warnings"] = [r.getMessage() for r in records]

# The MoE LM's fit with fixed groups.
rng = np.random.default_rng(0)
xs = rng.integers(0, V, (64, L)).astype(np.int64)
ys = np.roll(xs, -1, axis=1)
with strategy.scope():
    lm = build_transformer_lm(V, L, d_model=32, depth=2, num_heads=2,
                              ff_dim=64, moe_experts=8, moe_groups=8,
                              seed=rank)
    if td.cluster.is_chief():
        lm.load_state_dict({k: torch.from_numpy(v) for k, v in
                            np.load("lm.npz").items()})
    lm.compile(loss=loss_fn, optimizer=optimizers.Adam(LR), device="cpu")
ds = td.data.Dataset.from_tensor_slices((xs, ys)).batch(16).repeat()
out["fit_loss"] = lm.fit(ds, epochs=2, steps_per_epoch=4,
                         verbose=0).history["loss"]
named = dict(lm.named_parameters())
out["lm_layout"] = sorted(lm._tensor_parallel[1])
out["lm_shapes"] = {n: list(p.shape) for n, p in named.items()}
out["replicated"] = {n: p.detach().numpy().tolist() for n, p in named.items()
                     if n not in lm._tensor_parallel[1]}
out["aux"] = {n: float(b) for n, b in lm.named_buffers()}
out["preds"] = lm.predict(xs[:4]).tolist()
lm.save("moe_saved")

from tpu_dist_torch.examples import moe_expert_parallel_lm

out["example"] = moe_expert_parallel_lm.main(
    ["--device", "cpu", "--vocab", "31", "--seq-len", "8", "--d-model",
     "16", "--epochs", "1", "--steps", "2"])
print(json.dumps(out))
''' % {"v": V, "l": L, "lr": LR, "layer": LAYER}


def _layer_case(seed=0):
    """The reference layer's params (bridged) and seeded inputs."""
    jlayer = JMoE(**LAYER)
    params, state, _ = jlayer.init(jax.random.PRNGKey(1), (8, 32))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(16, 8, 32)).astype(np.float32)
    dy = rng.normal(size=(16, 8, 32)).astype(np.float32)
    return jlayer, jax.tree_util.tree_map(np.asarray, params), x, dy


def _jax_layer(jlayer, params, x, dy):
    def objective(p, x):
        y, st = jlayer.apply(p, {}, x)
        return (y * dy).sum(), (y, st)

    (gp, gx), (y, st) = jax.grad(objective, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    return {"y": np.asarray(y), "aux": float(st["aux_loss"]),
            "grads": {"x": np.asarray(gx), **{
                f"mixtureofexperts.{n}": g for n, g in grads.items()}}}


def _lm_pair():
    jmodel = jlm(V, L, d_model=32, depth=2, num_heads=2, ff_dim=64,
                 moe_experts=8, moe_groups=8)
    init = jax.tree_util.tree_map(np.asarray, jmodel.init(0))
    return jmodel, init


def _lm_data():
    rng = np.random.default_rng(0)
    xs = rng.integers(0, V, (64, L)).astype(np.int64)
    return xs, np.roll(xs, -1, axis=1)


def _reference_fit(jmodel):
    xs, ys = _lm_data()
    jmodel.compile(loss=tdj.ops.SparseCategoricalCrossentropy(
        from_logits=True), optimizer=tdj.ops.Adam(LR))
    ds = tdj.data.Dataset.from_tensor_slices((xs, ys)).batch(16).repeat()
    loss = jmodel.fit(ds, epochs=2, steps_per_epoch=4,
                      verbose=0).history["loss"]
    return loss, jmodel


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert")
    jlayer, params, x, dy = _layer_case()
    x_odd = np.random.default_rng(5).normal(size=(4, 6, 32)).astype(
        np.float32)
    np.savez(tmp / "layer.npz", x=x, dy=dy, x_odd=x_odd)
    weights = {f"mixtureofexperts.{k}": v.numpy()
               for k, v in params_from_jax(params).items()}
    np.savez(tmp / "layer_w.npz", **weights)
    jodd = JMoE(num_experts=8, ff_dim=64, top_k=2, groups=3)
    odd_params, _, _ = jodd.init(jax.random.PRNGKey(2), (6, 32))
    odd_params = jax.tree_util.tree_map(np.asarray, odd_params)
    np.savez(tmp / "odd_w.npz", **{f"mixtureofexperts.{k}": v.numpy()
                                   for k, v in params_from_jax(
                                       odd_params).items()})
    jmodel, init = _lm_pair()
    np.savez(tmp / "lm.npz", **{k: v.numpy() for k, v in
                                variables_from_jax(init).items()})
    (tmp / "worker.py").write_text(WORKER)
    procs = _spawn(2, tmp / "worker.py", tmp)
    ref = {"layer": _jax_layer(jlayer, params, x, dy)}
    ref["odd_y"], _ = jodd.apply(odd_params, {}, jnp.asarray(x_odd))
    ref["fit_loss"], jfit = _reference_fit(jmodel)
    ref["aux"] = {k: float(v) for k, v in variables_from_jax(
        jax.tree_util.tree_map(np.asarray, jfit.variables)).items()
        if k.endswith("aux_loss")}
    outs = _finish(procs)
    saved = load_model(tmp / "moe_saved", device="cpu")
    xs, _ = _lm_data()
    return outs, ref, {"preds": saved.predict(xs[:4])}


# -- one process -------------------------------------------------------------------

def _gates(shape, seed=0):
    logits = np.random.default_rng(seed).normal(size=shape).astype(
        np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("top_k, capacity", [(2, 16), (1, 3), (2, 5)])
def test_route_matches_the_reference(top_k, capacity):
    gates = _gates((2, 16, 4))
    want = jroute(jnp.asarray(gates), top_k, capacity)
    got = _route(torch.tensor(gates), top_k, capacity)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_dispatch_combine_shapes_and_mass():
    dispatch, combine, aux = _route(torch.from_numpy(_gates((2, 16, 4))),
                                    2, capacity=16)
    assert dispatch.shape == (2, 16, 4, 16)
    # Capacity 16 is the worst case: nothing drops, every token dispatches
    # top_k times and its combine weights sum to 1.
    assert float(dispatch.sum()) == 2 * 16 * 2
    np.testing.assert_allclose(combine.sum(dim=(2, 3)).numpy(), 1.0,
                               rtol=1e-5)
    assert aux.shape == (2,)


def test_capacity_drops_by_token_order():
    gates = torch.softmax(torch.tensor([[[9.0, 0.0]] * 3]), dim=-1)
    dispatch, _, _ = _route(gates, 1, capacity=2)
    np.testing.assert_array_equal(dispatch[0, :, 0, :].sum(-1).numpy(),
                                  [1.0, 1.0, 0.0])


def test_dropped_token_passes_through_with_zero_contribution():
    layer = MixtureOfExperts(groups=1, num_experts=2, ff_dim=8, top_k=1,
                             capacity_factor=0.26)
    layer.init(torch.Generator().manual_seed(0), (4,))
    with torch.no_grad():
        out = layer(torch.ones(8, 1, 4)).reshape(8, 4)
    assert torch.allclose(out[2:], torch.zeros(6, 4))
    assert not torch.allclose(out[:1], torch.zeros(1, 4))


def test_local_layer_matches_the_reference_value_and_grad():
    jlayer, params, x, dy = _layer_case()
    want = _jax_layer(jlayer, params, x, dy)
    layer = MixtureOfExperts(**LAYER)
    layer.init(torch.Generator().manual_seed(0), (8, 32))
    layer.load_state_dict({**params_from_jax(params),
                           "aux_loss": torch.zeros(())}, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = layer(xt)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want["y"], **TOL)
    np.testing.assert_allclose(float(layer.aux_loss), want["aux"], rtol=1e-5)
    got = {"x": xt.grad, **{f"mixtureofexperts.{n}": p.grad
                            for n, p in layer.named_parameters()}}
    assert sorted(got) == sorted(want["grads"])
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got[n].numpy(), g, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_moe_every_spacing():
    model = build_transformer_lm(32, 8, d_model=16, depth=4, num_heads=2,
                                 ff_dim=32, moe_experts=4, moe_every=2)
    moe = [n for n, m in model.named_modules()
           if isinstance(m, MixtureOfExperts)]
    assert moe == ["block.residual_1.main.mixtureofexperts",
                   "block_2.residual_1.main.mixtureofexperts"]


def test_lm_fit_adds_the_aux_loss_as_the_reference_does():
    jmodel, init = _lm_pair()
    want, _ = _reference_fit(jmodel)
    model = build_transformer_lm(V, L, d_model=32, depth=2, num_heads=2,
                                 ff_dim=64, moe_experts=8, moe_groups=8)
    model.load_jax_variables(init)
    model.compile(loss=losses.SparseCategoricalCrossentropy(
        from_logits=True), optimizer=optimizers.Adam(LR), device="cpu")
    xs, ys = _lm_data()
    from tpu_dist_torch import data

    ds = data.Dataset.from_tensor_slices((xs, ys)).batch(16).repeat()
    got = model.fit(ds, epochs=2, steps_per_epoch=4, verbose=0).history[
        "loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    aux = [float(b) for n, b in model.named_buffers()
           if n.endswith("aux_loss")]
    assert len(aux) == 2 and all(np.isfinite(aux)) and min(aux) > 0


def test_lm_save_load_round_trip(tmp_path):
    model = build_transformer_lm(V, L, d_model=32, depth=2, num_heads=2,
                                 ff_dim=64, moe_experts=8, moe_groups=8)
    model.compile(loss=losses.SparseCategoricalCrossentropy(
        from_logits=True), optimizer=optimizers.Adam(LR), device="cpu")
    xs, ys = _lm_data()
    model.fit((xs[:32], ys[:32]), epochs=1, verbose=0)
    model.save(tmp_path / "moe_lm")
    loaded = load_model(tmp_path / "moe_lm", device="cpu")
    np.testing.assert_array_equal(model.predict(xs[:8]),
                                  loaded.predict(xs[:8]))
    jloaded = tdj.models.load_model(tmp_path / "moe_lm")
    np.testing.assert_allclose(np.asarray(jloaded.predict(xs[:8])),
                               model.predict(xs[:8]), rtol=1e-5, atol=1e-5)


# -- two processes -------------------------------------------------------------------

@pytest.mark.multiprocess
def test_expert_mesh_layer_matches_the_local_math(run):
    outs, ref, _ = run
    want = ref["layer"]
    for o in outs:
        np.testing.assert_allclose(o["layer_y"], want["y"], **TOL)
        np.testing.assert_allclose(o["layer_aux"], want["aux"], rtol=1e-5)
        for n, g in want["grads"].items():
            np.testing.assert_allclose(o["layer_grads"][n], g, err_msg=n,
                                       **GRAD_TOL)
        assert o["w1_local"] == [4, 32, 64]
        assert o["layout"] == [f"mixtureofexperts.{n}" for n in
                               ("b1", "b2", "w1", "w2")]
    assert outs[0]["layer_grads"] == outs[1]["layer_grads"]


@pytest.mark.multiprocess
def test_indivisible_groups_fall_back_with_one_warning(run):
    outs, ref, _ = run
    for o in outs:
        np.testing.assert_allclose(o["odd_y"], np.asarray(ref["odd_y"]),
                                   **TOL)
        assert len(o["warnings"]) == 1
        assert "LOCAL fallback" in o["warnings"][0]


@pytest.mark.multiprocess
def test_moe_lm_fit_matches_the_references_local_fit(run):
    outs, ref, _ = run
    for o in outs:
        np.testing.assert_allclose(o["fit_loss"], ref["fit_loss"],
                                   rtol=1e-5, atol=1e-5)
        for n, v in ref["aux"].items():
            np.testing.assert_allclose(o["aux"][n], v, rtol=1e-4, err_msg=n)
        experts = [n for n in o["lm_shapes"] if n.rsplit(".", 1)[-1] in
                   ("w1", "b1", "w2", "b2")]
        assert o["lm_layout"] == sorted(experts) and len(experts) == 8
        assert all(o["lm_shapes"][n][0] == 4 for n in experts)
    # The router (and every replicated leaf) bit for bit across the ranks.
    assert any(n.endswith("router") for n in outs[0]["replicated"])
    assert outs[0]["replicated"] == outs[1]["replicated"]
    assert outs[0]["fit_loss"] == outs[1]["fit_loss"]


@pytest.mark.multiprocess
def test_saved_moe_lm_loads_in_one_process(run):
    outs, _, saved = run
    np.testing.assert_allclose(saved["preds"], outs[0]["preds"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.multiprocess
def test_the_moe_example_runs(run):
    outs, _, _ = run
    for o in outs:
        ex = o["example"]
        assert ex["w1_local"][0] == 4
        assert all(np.isfinite(ex["loss"])) and all(np.isfinite(ex["aux"]))
    assert outs[0]["example"]["loss"] == outs[1]["example"]["loss"]
