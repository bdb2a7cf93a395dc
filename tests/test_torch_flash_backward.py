"""The port's flash-attention backward against the reference's Pallas kernels.

The same inputs, made with numpy from a seed, go through ``jax.grad`` of
the reference's ``flash_attention(..., interpret=True)`` (the exact Pallas
kernel logic in the interpreter, as ``tests/test_flash_attention.py`` runs
it on the CPU) and through the port's autograd path
(``FlashAttention``), whose backward on CPU tensors is
``flash_attention_bwd_plain``:

* L = 128 is one 128-row tile, so the reference runs
  ``_dqkv_single_kernel``;
* L = 256 with ``tile_q = tile_k = 128`` runs ``_dq_kernel`` and
  ``_dkv_kernel``.

fp32: the reference's own gradient tolerance (atol 5e-5, rtol 5e-4). bf16
inputs are compared in fp32 at the reference's bf16 tolerance (3e-2 of
the largest gradient), since the two forwards round O differently (the
TPU kernel rounds P before P·V, the port's plain forward only O).

The CUDA kernels themselves run only on the card: their tests are in
``tests/test_torch_gpu.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.ops import flash_attention as jfa
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import fused


def _inputs(seed, ln):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, 2, ln, 32)).astype(np.float32)
               for _ in range(3))
    # A non-uniform downstream cotangent so dO exercises the delta term.
    w = np.linspace(0.5, 1.5, 32).astype(np.float32)
    return q, k, v, w


def _reference_grads(q, k, v, w, *, causal, dtype, tiles):
    scale = 1.0 / math.sqrt(q.shape[-1])
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, scale=scale,
                                interpret=True, tile_q=tiles, tile_k=tiles)
        return jnp.sum(o.astype(jnp.float32) * w)

    args = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, w, *, causal, dtype):
    scale = 1.0 / math.sqrt(q.shape[-1])
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention(*ts, causal=causal, scale=scale)
    (o.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("ln,tiles,causal,dtype", [
    (128, None, False, torch.float32),   # _dqkv_single_kernel
    (128, None, True, torch.float32),
    (128, None, True, torch.bfloat16),
    (256, 128, False, torch.float32),    # _dq_kernel + _dkv_kernel
    (256, 128, True, torch.float32),
    (256, 128, True, torch.bfloat16),
])
def test_port_grads_match_reference_kernels(ln, tiles, causal, dtype):
    q, k, v, w = _inputs(ln + causal, ln)
    counts = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd.launches, fused.fused_adam_apply.launches)
    got = _port_grads(q, k, v, w, causal=causal, dtype=dtype)
    want = _reference_grads(q, k, v, w, causal=causal, dtype=dtype,
                            tiles=tiles)
    for name, g, r in zip("qkv", got, want):
        if dtype == torch.float32:
            np.testing.assert_allclose(g, r, atol=5e-5, rtol=5e-4,
                                       err_msg=f"d{name}")
        else:
            np.testing.assert_allclose(g, r, rtol=3e-2,
                                       atol=3e-2 * np.abs(r).max(),
                                       err_msg=f"d{name}")
    # The CPU path is the plain version: no kernel launch is counted.
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
            fused.fused_adam_apply.launches) == counts


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plain_matches_reference_bwd_on_the_same_residuals(causal,
                                                               dtype):
    # The reference's _bwd (interpret mode, 64-row tiles: _dq_kernel and
    # _dkv_kernel over 3 tiles) and the port's plain version on the SAME
    # q, k, v, o, lse, dO: only the summation order differs. bf16 rounds P
    # and dS at the same places on both sides; the outputs may land one
    # bf16 ulp apart (2**-7 of a value) and a rounding boundary may flip
    # (2**-8 of the largest).
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal((2, 192, 32)).astype(np.float32)
                   for _ in range(4))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    scale = 0.2
    o, lse = jfa._fwd(jq, jk, jv, causal, scale, True, 1, 64, 64)
    want = jfa._bwd(jq, jk, jv, o, lse, jdo, causal, scale, True, 1, 64, 64)
    tt = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        dtype)
    got = fa.flash_attention_bwd(
        tt(jq), tt(jk), tt(jv), tt(o),
        torch.from_numpy(np.array(lse)), tt(jdo), causal=causal,
        scale=scale)
    for g, r in zip(got, want):
        assert g.dtype == dtype
        r = np.asarray(r.astype(jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), r, atol=2e-5, rtol=2e-5)
        else:
            np.testing.assert_allclose(g.float().numpy(), r, rtol=2.0 ** -7,
                                       atol=2.0 ** -8 * np.abs(r).max())


def test_bwd_wrapper_takes_the_plain_version_for_cpu_tensors():
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(1, 2, 40, 64, generator=gen)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                 scale=0.125)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                        scale=0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fa.flash_attention_bwd.launches == before


def test_bwd_plain_is_the_gradient_of_the_plain_forward():
    # Against autograd of the dense forward (the plain version must not
    # call autograd itself: it recomputes P from lse).
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 2, 70, 32, generator=gen, dtype=torch.float64)
               .requires_grad_() for _ in range(3))
    do = torch.randn(2, 2, 70, 32, generator=gen, dtype=torch.float64)
    o, lse = fa.flash_attention_plain(q, k, v, causal=True, scale=0.3)
    want = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        o64 = torch.softmax(
            (q @ k.transpose(-1, -2) * 0.3).masked_fill(
                ~torch.ones(70, 70, dtype=torch.bool).tril(), -math.inf),
            dim=-1) @ v
    got = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                       o64, lse.double(), do, causal=True,
                                       scale=0.3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, atol=1e-5, rtol=1e-5)


def _tf32_rna(x):
    """``cvt.rna.tf32.f32``: fp32 rounded to nearest (ties away from zero)
    on its low 13 mantissa bits, kept as an fp32 value."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_einsum(eq, a, b, *, terms):
    """An fp32 product as the CUDA kernel does it on the tensor cores: each
    operand split into TF32 ``big = rna(x)`` and ``small = rna(x - big)``,
    and the three products that matter summed (``terms=3``), or the big
    parts alone (``terms=1``, plain TF32)."""
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    out = torch.einsum(eq, a_big, b_big)
    if terms == 3:
        a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)
        out = (torch.einsum(eq, a_small, b_big)
               + torch.einsum(eq, a_big, b_small) + out)
    return out


def _bwd_tf32(q, k, v, o, lse, do, *, causal, scale, terms):
    """``flash_attention_bwd_plain`` (fp32 inputs) with its five products
    done as :func:`_tf32_einsum`."""
    mm = lambda eq, a, b: _tf32_einsum(eq, a, b, terms=terms)
    s = mm("...qd,...kd->...qk", q, k) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse)
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = p * (mm("...qd,...kd->...qk", do, v) - delta) * scale
    return (mm("...qk,...kd->...qd", ds, k), mm("...qk,...qd->...kd", ds, q),
            mm("...qk,...qd->...kd", p, do))


def _bwd_residuals(ln, d, causal, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 2, ln, d))
                                    .astype(np.float32)) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    return (q, k, v, o, lse, do), scale


def test_tf32_rounding_emulates_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -12, 3.0e-3], dtype=torch.float32)
    got = _tf32_rna(x)
    # 10 stored mantissa bits: a tie (2**-11 past 1) rounds away from zero.
    assert got[:5].tolist() == [1.0, 1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10),
                                1.0 + 2 ** -10]
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2 ** -11


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ln,d", [(77, 32), (77, 64), (128, 32), (128, 64)])
def test_3xtf32_products_keep_fp32_accuracy(ln, d, causal):
    # The fp32 kernel's numeric design against the plain version, at the
    # chip check's fp32 tolerance (atol = rtol = 1e-4).
    args, scale = _bwd_residuals(ln, d, causal, seed=ln + d + causal)
    got = _bwd_tf32(*args, causal=causal, scale=scale, terms=3)
    want = fa.flash_attention_bwd_plain(*args, causal=causal, scale=scale)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_tf32_products_are_measurably_worse(causal):
    # A kernel that dropped the small terms (plain TF32, 10-bit mantissas)
    # is at least 10x further from the plain version than 3xTF32.
    args, scale = _bwd_residuals(128, 64, causal, seed=11 + causal)
    want = fa.flash_attention_bwd_plain(*args, causal=causal, scale=scale)
    err = {terms: max(float((g - w).abs().max()) for g, w in zip(
        _bwd_tf32(*args, causal=causal, scale=scale, terms=terms), want))
        for terms in (1, 3)}
    assert err[1] >= 10 * err[3], err
    assert err[1] > 1e-4, err


def test_inference_mode_runs_the_forward_only():
    q = torch.randn(1, 2, 16, 32)
    with torch.inference_mode():
        o = fa.flash_attention(q, q, q, causal=True, scale=0.2)
    assert not o.requires_grad
    assert torch.equal(o, fa.flash_attention_plain(q, q, q, causal=True,
                                                   scale=0.2)[0])
