"""The port's fused cross-entropy against the reference's Pallas kernels.

The same logits and labels, made with numpy from a seed, go through
``tpu_dist.ops.pallas_kernels.fused_sparse_cross_entropy(...,
interpret=True)`` (the TPU kernels ``_ce_fwd_kernel`` / ``_ce_bwd_kernel``
in the Pallas interpreter, their gradient through ``jax.vjp``) and the
port's plain versions, which CPU tensors take. fp32 losses, log-sum-exps
and gradients agree at atol = rtol = 1e-5 (the same fp32 math, summed in
another order); a bf16 gradient is rounded to bf16 on both sides from fp32
values that agree to ~1e-7, so the two are equal or one bf16 ulp apart
(rtol 2**-7).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.ops import pallas_kernels as jpk
from tpu_dist_torch.ops import fused
from tpu_dist_torch.ops import losses

TOL = dict(atol=1e-5, rtol=1e-5)
#: The chip phase's shapes, less the LM's [32768, 8192].
SHAPES = [(64, 10), (37, 10), (2, 16, 64), (1000, 1000)]


def _inputs(shape, seed, out_of_range=False):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    labels = rng.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)
    if out_of_range:   # no column matches: loss = lse, empty one-hot row
        labels.reshape(-1)[::5] = -1
        labels.reshape(-1)[1::7] = shape[-1]
    g = rng.uniform(0.5, 1.5, size=shape[:-1]).astype(np.float32)
    return logits, labels, g


def _reference(logits, labels, g):
    """Losses and dlogits of the reference's Pallas kernels (interpreted)."""
    fn = lambda x: jpk.fused_sparse_cross_entropy(x, jnp.asarray(labels),
                                                  interpret=True)
    loss, vjp = jax.vjp(fn, jnp.asarray(logits))
    (dlogits,) = vjp(jnp.asarray(g))
    return np.asarray(loss), np.asarray(dlogits.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_ce_matches_reference_kernels(shape):
    logits, labels, g = _inputs(shape, seed=len(shape) * 1000 + shape[-1],
                                out_of_range=shape == (37, 10))
    want_loss, want_dlogits = _reference(logits, labels, g)
    x = torch.from_numpy(logits).requires_grad_()
    y = torch.from_numpy(labels)
    before = (fused.fused_ce_fwd.launches, fused.fused_ce_bwd.launches)
    loss = fused.fused_sparse_cross_entropy(x, y)
    assert loss.shape == shape[:-1] and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, **TOL)
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(x.grad.numpy(), want_dlogits, **TOL)
    # The forward's lse and the backward on its own, as the kernels see them.
    x2, y2 = x.detach().reshape(-1, shape[-1]), y.reshape(-1)
    per, lse = fused.fused_ce_fwd_plain(x2, y2)
    picked = np.where((labels >= 0) & (labels < shape[-1]),
                      np.take_along_axis(
                          logits, np.clip(labels, 0, shape[-1] - 1)[..., None],
                          -1)[..., 0], 0.0)
    np.testing.assert_allclose(lse.numpy(), (want_loss + picked).reshape(-1),
                               **TOL)
    np.testing.assert_allclose(per.numpy(), want_loss.reshape(-1), **TOL)
    dx = fused.fused_ce_bwd_plain(x2, y2, lse, torch.from_numpy(g).reshape(-1))
    np.testing.assert_allclose(dx.numpy(), want_dlogits.reshape(dx.shape),
                               **TOL)
    # CPU tensors take the plain versions: no launch is counted.
    assert (fused.fused_ce_fwd.launches,
            fused.fused_ce_bwd.launches) == before


@pytest.mark.parametrize("shape", [(64, 10), (1000, 1000)], ids=str)
def test_bf16_gradient_within_one_ulp_of_reference(shape):
    logits, labels, g = _inputs(shape, seed=7)
    bf = jnp.asarray(logits).astype(jnp.bfloat16)
    want_loss, want_dlogits = _reference(bf, labels, g)
    x = torch.from_numpy(np.array(bf.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    loss = fused.fused_sparse_cross_entropy(x, torch.from_numpy(labels))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, **TOL)
    loss.backward(torch.from_numpy(g))
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(x.grad.float().numpy(), want_dlogits,
                               rtol=2.0 ** -7, atol=1e-30)


def test_fused_loss_object_matches_unfused():
    logits, labels, _ = _inputs((32, 10), seed=3)
    x1 = torch.from_numpy(logits).requires_grad_()
    x2 = torch.from_numpy(logits).requires_grad_()
    y = torch.from_numpy(labels).long()
    fused_loss = losses.SparseCategoricalCrossentropy(from_logits=True,
                                                      fused=True)
    plain_loss = losses.SparseCategoricalCrossentropy(from_logits=True)
    assert fused_loss.fused and not plain_loss.fused
    a, b = fused_loss(x1, y), plain_loss(x2, y)
    np.testing.assert_allclose(a.item(), b.item(), **TOL)
    a.backward()
    b.backward()
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), **TOL)


def test_envelope_is_stated_and_checked():
    y = torch.zeros(4, dtype=torch.long)
    # CPU tensors are outside the kernels' envelope (they take the plain
    # versions); each other limit is named.
    assert not fused.supported(torch.zeros(4, 10), y)
    for x, lab, match in (
            (torch.zeros(4, 10, dtype=torch.float16), y, "fp32 or bf16"),
            (torch.zeros(4, 10), y.float(), "int32 or int64"),
            (torch.zeros(2, 2, 10), y, r"\[B, C\]"),
            (torch.zeros(10, 4).t(), y, "contiguous"),
            (torch.zeros(4, 10), y, "one CUDA device")):
        assert fused._ce_mismatch(x, lab) is not None
        assert re.search(match, fused._ce_mismatch(x, lab))
