"""The port's transformer LM against the reference, on bridged weights.

Each layer kind and the whole LM get the same weights (the reference's
``init`` output, perturbed with numpy so LayerNorm scales and biases are
not trivial, then bridged with ``params_from_jax``) and the same inputs
(numpy, from a seed); outputs agree in fp32 at 1e-5. JAX's and torch's
generators give different numbers from one seed, so no test re-derives the
reference's weights from its RNG.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_dist.models import layers as jlayers
from tpu_dist.models import transformer as jtr
from tpu_dist_torch.models import layers, policy, transformer as tr
from tpu_dist_torch.models.bridge import params_from_jax
from tpu_dist_torch.ops import initializers

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


@pytest.mark.parametrize("kwargs", [{"moe_experts": 2},
                                    {"pipeline_stages": 2}])
def test_unported_lm_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.build_transformer_lm(VOCAB, SEQ, **kwargs)


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
