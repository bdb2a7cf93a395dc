"""The port's transformer LM against the reference, on bridged weights.

Each layer kind and the whole LM get the same weights (the reference's
``init`` output, perturbed with numpy so LayerNorm scales and biases are
not trivial, then bridged with ``params_from_jax``) and the same inputs
(numpy, from a seed); outputs agree in fp32 at 1e-5. JAX's and torch's
generators give different numbers from one seed, so no test re-derives the
reference's weights from its RNG.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_dist.models import layers as jlayers
from tpu_dist.models import transformer as jtr
from tpu_dist_torch.models import layers, transformer as tr
from tpu_dist_torch.models.bridge import params_from_jax
from tpu_dist_torch.ops import initializers

# ``models.policy`` is the function, as in the reference's package: the
# module is imported by its full name.
policy = importlib.import_module("tpu_dist_torch.models.policy")

ATOL = 1e-5
VOCAB, SEQ = 32, 32


def _perturbed(tree, seed):
    """Reference params with every leaf moved by seeded noise."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.2 * rng.standard_normal(a.shape).astype(np.float32), tree)


def _lm_pair(seed=0):
    jmodel = jtr.build_transformer_lm(VOCAB, SEQ, d_model=32, depth=2,
                                      num_heads=2)
    params = _perturbed(jmodel.init(0)["params"], seed)
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=32, depth=2,
                                    num_heads=2)
    model.load_jax_params(params)
    return jmodel, params, model


def _layer_cases():
    return {
        "embedding": (lambda m: m.Embedding(VOCAB, 16), (8,), "tokens"),
        "positional": (lambda m: m.PositionalEmbedding(max_len=16),
                       (8, 16), "float"),
        "layernorm": (lambda m: m.LayerNormalization(), (8, 16), "float"),
        "dense_gelu": (lambda m: m.Dense(24, activation="gelu"),
                       (8, 16), "float"),
        "mha_causal": (lambda m: m.MultiHeadAttention(
            num_heads=2, key_dim=8, causal=True), (8, 16), "float"),
        "mha_full": (lambda m: m.MultiHeadAttention(
            num_heads=2, key_dim=8, causal=False), (8, 16), "float"),
        "block": (lambda m: m.TransformerBlock(16, 2, 64, causal=True),
                  (8, 16), "float"),
    }


class _JaxMods:
    """Layer constructors of the reference under the port's names."""
    Embedding = jtr.Embedding
    PositionalEmbedding = jtr.PositionalEmbedding
    LayerNormalization = jtr.LayerNormalization
    MultiHeadAttention = jtr.MultiHeadAttention
    TransformerBlock = staticmethod(jtr.TransformerBlock)
    Dense = jlayers.Dense


class _TorchMods:
    Embedding = tr.Embedding
    PositionalEmbedding = tr.PositionalEmbedding
    LayerNormalization = tr.LayerNormalization
    MultiHeadAttention = tr.MultiHeadAttention
    TransformerBlock = staticmethod(tr.TransformerBlock)
    Dense = layers.Dense


@pytest.mark.parametrize("case", sorted(_layer_cases()))
def test_layer_matches_reference(case):
    make, in_shape, kind = _layer_cases()[case]
    jlayer = make(_JaxMods)
    params, _, out_shape = jlayer.init(jax.random.PRNGKey(1), in_shape)
    params = _perturbed(params, 2)
    rng = np.random.default_rng(3)
    if kind == "tokens":
        x = rng.integers(0, VOCAB, size=(2, *in_shape)).astype(np.int32)
    else:
        x = rng.standard_normal((2, *in_shape)).astype(np.float32)
    ref, _ = jlayer.apply(params, {}, jnp.asarray(x))

    tlayer = make(_TorchMods)
    assert tlayer.init(torch.Generator().manual_seed(0), in_shape) == \
        tuple(out_shape)
    tlayer.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = tlayer(torch.from_numpy(x).long() if kind == "tokens"
                     else torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_lm_logits_match_reference():
    jmodel, params, model = _lm_pair()
    tokens = np.random.default_rng(4).integers(0, VOCAB, size=(2, SEQ))
    ref, _ = jmodel.apply(params, {}, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, SEQ, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


def test_parameter_names_and_shapes_match_reference_tree():
    jmodel = jtr.build_transformer_lm(VOCAB, SEQ, d_model=32, depth=2,
                                      num_heads=2)
    ref = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jmodel.init(0)["params"]))
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=32, depth=2,
                                    num_heads=2)
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    assert all(tuple(got[k].shape) == tuple(ref[k].shape) for k in ref)
    assert model.layer_names == jmodel.layer_names
    variables = model.variables
    assert variables["state"] == {}
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, variables["params"])) == \
        jax.tree_util.tree_structure(jmodel.init(0)["params"])


def test_load_jax_params_rejects_a_missing_leaf():
    _, params, model = _lm_pair()
    del params["dense"]["bias"]
    with pytest.raises(RuntimeError, match="dense.bias"):
        model.load_jax_params(params)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = layers._activation("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), atol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - exact)) > 1e-4


def test_unique_layer_names_match_reference():
    mk = lambda m: [m.LayerNormalization(), m.Dense(4), m.Dense(4),
                    m.LayerNormalization(), m.Dense(2)]
    assert layers.unique_layer_names(mk(_TorchMods)) == \
        jlayers.unique_layer_names(mk(_JaxMods))


@pytest.mark.parametrize("kwargs, kind", [
    ({"moe_experts": 2}, "MixtureOfExperts"),
    ({"pipeline_stages": 2}, "PipelinedBlocks")])
def test_pipeline_and_moe_lm_options_build(kwargs, kind):
    # Ported with the pipe and expert axes: the reference's layer kinds
    # under its parameter names.
    model = tr.build_transformer_lm(VOCAB, SEQ, **kwargs)
    jmodel = jtr.build_transformer_lm(VOCAB, SEQ, **kwargs)
    assert kind in {type(m).__name__ for m in model.modules()}
    assert sorted(n for n, _ in model.named_parameters()) == sorted(
        params_from_jax(jax.tree_util.tree_map(
            np.asarray, jmodel.init(0)["params"])))


def test_init_is_seeded():
    a = tr.build_transformer_lm(VOCAB, SEQ, d_model=16, num_heads=2, seed=5)
    b = tr.build_transformer_lm(VOCAB, SEQ, d_model=16, num_heads=2, seed=5)
    c = tr.build_transformer_lm(VOCAB, SEQ, d_model=16, num_heads=2, seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embedding.table"], sc["embedding.table"])


def test_initializers():
    gen = torch.Generator().manual_seed(0)
    w = initializers.glorot_uniform(gen, (30, 50))
    assert w.shape == (30, 50) and float(w.abs().max()) <= (6 / 80) ** 0.5
    assert torch.equal(initializers.get("zeros")(gen, (3,)), torch.zeros(3))
    assert torch.equal(initializers.get("ones")(gen, (3,)), torch.ones(3))
    with pytest.raises(ValueError, match="unknown initializer"):
        initializers.get("orthogonal")


def test_bfloat16_policy_runs_and_returns_fp32_logits():
    _, _, model = _lm_pair()
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, VOCAB, size=(1, 16)))
    with torch.no_grad():
        ref = model(tokens)
        policy.set_policy("mixed_bfloat16")
        try:
            assert policy.compute_dtype() == torch.bfloat16
            got = model(tokens)
        finally:
            policy.set_policy("float32")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=0.15)
    with pytest.raises(ValueError, match="unknown policy"):
        policy.set_policy("float16")


# -- the attention_fn contract (the reference's tests/test_transformer.py
#    :86, :102, :111), each against the JAX layer on bridged weights.

def _mha_pair(causal, jfn, tfn):
    """The reference's and the port's ``MultiHeadAttention(2, 8)`` on the
    same perturbed weights, with the given attention functions."""
    jlayer = jtr.MultiHeadAttention(num_heads=2, key_dim=8, causal=causal,
                                    attention_fn=jfn)
    params, _, _ = jlayer.init(jax.random.PRNGKey(0), (8, 16))
    params = _perturbed(params, 7)
    tlayer = tr.MultiHeadAttention(num_heads=2, key_dim=8, causal=causal,
                                   attention_fn=tfn)
    tlayer.init(torch.Generator().manual_seed(0), (8, 16))
    tlayer.load_state_dict(params_from_jax(params), strict=True)
    x = np.random.default_rng(8).standard_normal((2, 8, 16)).astype(
        np.float32)
    return jlayer, params, tlayer, x


def _jax_dense(q, k, v, causal, scale):
    s = jnp.einsum("...qd,...kd->...qk", q, k) * scale
    if causal:
        ln = q.shape[-2]
        s = jnp.where(np.tril(np.ones((ln, ln), bool)), s, -jnp.inf)
    return jnp.einsum("...qk,...kd->...qd", jax.nn.softmax(s, -1), v)


def test_attention_fn_causal_forwarded_when_unbound():
    # def attn(q, k, v, causal): no scale parameter, causal from the layer.
    seen = {}

    def jattn(q, k, v, causal):
        seen["jax"] = causal
        return _jax_dense(q, k, v, causal, 0.25)

    def tattn(q, k, v, causal):
        seen["torch"] = causal
        return tr._dense_attention(q, k, v, causal=causal, scale=0.25)

    jlayer, params, tlayer, x = _mha_pair(True, jattn, tattn)
    ref, _ = jlayer.apply(params, {}, jnp.asarray(x))
    with torch.no_grad():
        got = tlayer(torch.from_numpy(x))
    assert seen == {"jax": True, "torch": True}
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("nested", [False, True])
def test_attention_fn_causal_conflict_raises(nested):
    tattn = functools.partial(lambda q, k, v, causal: q, causal=False)
    if nested:
        tattn = functools.partial(tattn, unused=None)
    layer = tr.MultiHeadAttention(num_heads=2, key_dim=8, causal=True,
                                  attention_fn=tattn)
    layer.init(torch.Generator().manual_seed(0), (8, 16))
    with pytest.raises(ValueError, match="conflicts"):
        layer(torch.zeros(1, 8, 16))


def test_attention_fn_nested_partial_causal_and_scale_respected():
    # An inner partial binds causal=True, an outer one scale=0.125: the
    # layer must see causal through the chain (a causal=False layer
    # raises), pass no causal= itself, and the bound scale reaches the
    # function (not 1 / sqrt(key_dim)).
    seen = []

    def jfn(q, k, v, causal, scale):
        return _jax_dense(q, k, v, causal, scale)

    def tfn(q, k, v, causal, scale):
        seen.append((causal, scale))
        return tr._dense_attention(q, k, v, causal=causal, scale=scale)

    jouter = functools.partial(functools.partial(jfn, causal=True),
                               scale=0.125)
    touter = functools.partial(functools.partial(tfn, causal=True),
                               scale=0.125)
    bad = tr.MultiHeadAttention(num_heads=2, key_dim=8, causal=False,
                                attention_fn=touter)
    bad.init(torch.Generator().manual_seed(0), (8, 16))
    with pytest.raises(ValueError, match="conflicts"):
        bad(torch.zeros(1, 8, 16))
    jlayer, params, tlayer, x = _mha_pair(True, jouter, touter)
    ref, _ = jlayer.apply(params, {}, jnp.asarray(x))
    with torch.no_grad():
        got = tlayer(torch.from_numpy(x))
    assert seen == [(True, 0.125)]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=ATOL)
