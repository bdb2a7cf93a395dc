"""The port's flash-attention forward against the reference's Pallas kernel.

The same inputs, made with numpy from a seed, go through the reference's
``_fwd`` (the exact Pallas kernel logic, in interpret mode with 64-row
tiles, as ``tests/test_flash_attention.py`` runs it on the CPU) and through
the port's plain version, which is what the port's wrapper computes for CPU
tensors. O and lse must agree at 2e-5, the reference's own tolerance.

The CUDA kernel itself runs only on the card: its tests are in
``tests/test_torch_gpu.py``. Here its numeric design is emulated in torch
(:func:`_fwd_emulated`: 64-row query tiles, an online softmax over 32-key
tiles in base 2, 3xTF32 products for fp32 inputs, P rounded to bf16 before
P·V for bf16 inputs, and the split over keys with its merge) and held to
the plain version and to the reference's ``_fwd`` in interpret mode.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.ops import flash_attention as jfa
from tpu_dist_torch.ops import flash_attention as fa

ATOL = 2e-5  # tests/test_flash_attention.py's tolerance


def _inputs(seed, shape=(1, 2, 128, 32)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_reference_kernel_interpret(causal):
    q, k, v = _inputs(0)
    b, h, ln, d = q.shape
    scale = 1.0 / math.sqrt(d)
    fold = lambda x: jnp.asarray(x.reshape(b * h, ln, d))
    o_ref, lse_ref = jfa._fwd(fold(q), fold(k), fold(v), causal, scale,
                              True, 1, 64, 64)
    o, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=scale)
    np.testing.assert_allclose(o.numpy().reshape(b * h, ln, d),
                               np.asarray(o_ref), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, ln, 1),
                               np.asarray(lse_ref), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_wrapper_takes_plain_version_without_counting(causal):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, (2, 2, 40, 64)))
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=0.125)
    o_plain, lse_plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                                  scale=0.125)
    assert torch.equal(o, o_plain) and torch.equal(lse, lse_plain)
    assert torch.equal(fa.flash_attention(q, k, v, causal=causal,
                                          scale=0.125), o_plain)
    assert lse.shape == (2, 2, 40, 1) and lse.dtype == torch.float32
    assert fa.flash_attention_fwd.launches == before


def test_plain_bf16_keeps_dtype_and_fp32_lse():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(2))
    o, lse = fa.flash_attention_plain(q, k, v, causal=True, scale=0.2)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32


@pytest.mark.parametrize("shape,dtype,ok", [
    ((8, 512, 64), torch.float32, False),       # not [B, H, L, D]
    ((1, 8, 512, 64), torch.float32, True),     # the serving shape
    ((1, 8, 200, 64), torch.float32, True),     # ragged L
    ((1, 8, 1, 32), torch.bfloat16, True),
    ((1, 2, 64, 128), torch.float32, True),
    ((1, 2, 64, 48), torch.float32, False),     # no D=48 instantiation
    ((1, 2, 64, 64), torch.float16, False),
    ((1, 2, 0, 64), torch.float32, False),
])
def test_supported_envelope(shape, dtype, ok):
    assert fa.supported(torch.empty(shape, dtype=dtype, device="meta")) is ok


def test_use_flash_is_false_for_cpu_tensors():
    assert not fa.use_flash(torch.zeros(1, 8, 128, 64))


def test_non_cpu_non_cuda_tensors_raise():
    q = torch.empty(1, 2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="must all be on CUDA"):
        fa.flash_attention_fwd(q, q, q, causal=True, scale=0.125)


# -- the CUDA kernel's numeric design (csrc/flash_fwd.cu), emulated --------


def _tf32_rna(x):
    """``cvt.rna.tf32.f32``: fp32 rounded to nearest (ties away from zero)
    on its low 13 mantissa bits, kept as an fp32 value."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """fp32 with its low 13 mantissa bits cleared: a TF32 value."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32x3(eq, a, b):
    """An fp32 product as the kernel does it on the tensor cores: each
    operand split into TF32 ``big = trunc(x)`` and ``small = rna(x - big)``,
    and small*big + big*small + big*big summed."""
    a_big, b_big = _tf32_trunc(a), _tf32_trunc(b)
    a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)
    return (torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def _fwd_emulated(q, k, v, *, causal, scale, bf16=False, splits=1,
                  drop_tile=None):
    """``(O, lse)`` of ``[..., L, D]`` fp32 tensors computed as the kernel
    computes them, :func:`fa.block_rows` query rows a tile. ``bf16``: the
    inputs hold bf16 values; products are exact
    fp32 sums of bf16 products, P is rounded to bf16 before P·V (l sums the
    unrounded p) and O is rounded to bf16. ``splits``: each query tile's
    live key tiles go to that many runs, merged as the merge kernel does.
    ``drop_tile``: a mutation that skips that key tile everywhere."""
    mm = (lambda eq, a, b: torch.einsum(eq, a, b)) if bf16 else _tf32x3
    ln, rows_per_tile = q.shape[-2], fa.block_rows(q.shape[-1])
    sl = scale * math.log2(math.e)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1] + (1,))
    for q0 in range(0, ln, rows_per_tile):
        qt = q[..., q0:q0 + rows_per_tile, :]
        rows = torch.arange(q0, q0 + qt.shape[-2])[:, None]
        kend = min(ln, q0 + rows_per_tile) if causal else ln
        ntiles = -(-kend // 32)
        runs = []
        for z in range(splits):
            m = torch.full(qt.shape[:-1] + (1,), -math.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(qt)
            for tile in range(z * ntiles // splits, (z + 1) * ntiles // splits):
                if tile == drop_tile:
                    continue
                kt = k[..., tile * 32:tile * 32 + 32, :]
                vt = v[..., tile * 32:tile * 32 + 32, :]
                s = mm("...qd,...kd->...qk", qt, kt)
                if causal:
                    keys = torch.arange(tile * 32, tile * 32 + kt.shape[-2])
                    s = s.masked_fill(keys[None, :] > rows, -math.inf)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                ms = torch.where(m_new == -math.inf, 0.0, m_new * sl)
                corr = torch.exp2(m * sl - ms)
                p = torch.exp2(s * sl - ms)
                l = l * corr + p.sum(-1, keepdim=True)
                if bf16:
                    pv = mm("...qk,...kd->...qd", p.bfloat16().float(), vt)
                else:
                    pv = mm("...qk,...kd->...qd", p, vt)
                acc = acc * corr + pv
                m = m_new
            runs.append((m, l, acc))
        if splits == 1:
            m, l, acc = runs[0]
        else:  # the merge kernel, in run order; a run with m = -inf skipped
            m = torch.stack([r[0] for r in runs]).amax(0)
            l, acc = torch.zeros_like(m), torch.zeros_like(qt)
            for m_z, l_z, acc_z in runs:
                w = torch.where(m_z == -math.inf, 0.0,
                                torch.exp2((m_z - m) * sl))
                l = l + w * l_z
                acc = acc + w * acc_z
        l_safe = torch.clamp(l, min=1e-30)
        o[..., q0:q0 + rows_per_tile, :] = acc / l_safe
        lse[..., q0:q0 + rows_per_tile, :] = m * scale + torch.log(l_safe)
    if bf16:
        o = o.bfloat16().float()
    return o, lse


def _bf16_bound(q, k, v, *, causal, scale):
    """The elementwise limit of a bf16 kernel's O against the plain fp32
    version on the same (bf16-valued) inputs.

    O = sum_i p_i v_i / l with l = sum_i p_i (fp32, unrounded p). The kernel
    rounds each p_i to bf16 before P·V, as the TPU kernel does: p~_i = p_i
    (1 + d_i) with |d_i| <= 2**-8 (round to nearest, 8 significant bits), so
    O moves by sum_i p_i d_i v_i / l, at most 2**-8 (P_ref @ |V|) with P_ref
    the plain softmax. Rounding O itself to bf16 moves it by at most 2**-8
    |O|. The fp32 arithmetic (summation order, ex2.approx) adds well under
    1e-4. So |O - O_ref| <= 1e-4 + 2**-8 (|O_ref| + P_ref @ |V|)."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal:
        ln = s.shape[-1]
        keep = torch.ones(ln, ln, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o_ref = p @ v.float()
    return o_ref, 1e-4 + 2.0 ** -8 * (o_ref.abs() + p @ v.float().abs())


def _jax_fwd(q, k, v, *, causal, scale, dtype=jnp.float32):
    """The reference's Pallas ``_fwd`` in interpret mode on ``[B, H, L, D]``
    numpy inputs: one tile when L is not a multiple of 64."""
    b, h, ln, d = q.shape
    tile = 64 if ln % 64 == 0 else ln
    fold = lambda x: jnp.asarray(x.reshape(b * h, ln, d)).astype(dtype)
    o, lse = jfa._fwd(fold(q), fold(k), fold(v), causal, scale, True, 1,
                      tile, tile)
    return (np.asarray(o.astype(jnp.float32)).reshape(b, h, ln, d),
            np.asarray(lse).reshape(b, h, ln, 1))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ln,d", [(77, 32), (77, 64), (128, 32), (128, 64)])
def test_flash_fwd_3xtf32_design_keeps_fp32_accuracy(ln, d, causal):
    # The fp32 kernel's design against the plain version and the reference
    # kernel, at the chip check's fp32 tolerance (atol = rtol = 1e-4).
    q, k, v = _inputs(ln + d + causal, (1, 2, ln, d))
    scale = d ** -0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = _fwd_emulated(tq, tk, tv, causal=causal, scale=scale)
    o_plain, lse_plain = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                                  scale=scale)
    torch.testing.assert_close(o, o_plain, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, lse_plain, atol=1e-4, rtol=1e-4)
    o_jax, lse_jax = _jax_fwd(q, k, v, causal=causal, scale=scale)
    np.testing.assert_allclose(o.numpy(), o_jax, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), lse_jax, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ln", [77, 128])
def test_flash_fwd_bf16_design_within_the_stated_bound(ln, causal):
    q, k, v = (a.astype(jnp.bfloat16).astype(np.float32)
               for a in _inputs(ln + causal, (1, 2, ln, 64)))
    scale = 0.125
    tq, tk, tv = (torch.from_numpy(np.asarray(a)) for a in (q, k, v))
    o, lse = _fwd_emulated(tq, tk, tv, causal=causal, scale=scale, bf16=True)
    o_ref, bound = _bf16_bound(tq, tk, tv, causal=causal, scale=scale)
    assert bool(((o - o_ref).abs() <= bound).all())
    torch.testing.assert_close(lse, fa.flash_attention_plain(
        tq, tk, tv, causal=causal, scale=scale)[1], atol=1e-4, rtol=1e-4)
    # The reference rounds P per its own 64-key tiles: each side lies within
    # the bound of the exact O, so the two lie within twice it.
    o_jax, lse_jax = _jax_fwd(np.asarray(q), np.asarray(k), np.asarray(v),
                              causal=causal, scale=scale, dtype=jnp.bfloat16)
    assert bool(((o - torch.tensor(o_jax)).abs() <= 2 * bound).all())
    np.testing.assert_allclose(lse.numpy(), lse_jax, atol=1e-4, rtol=1e-4)
    # A kernel that skipped one key tile falls well outside the bound.
    dropped, _ = _fwd_emulated(tq, tk, tv, causal=causal, scale=scale,
                               bf16=True, drop_tile=1)
    assert not bool(((dropped - o_ref).abs() <= bound).all())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("splits", [2, 3, 4])
@pytest.mark.parametrize("ln", [77, 128])
def test_flash_fwd_split_over_keys_matches_unsplit(ln, splits, causal):
    # One 128-row query tile. At L = 77 its three key tiles leave a run
    # empty when split 4 ways; causal at L = 128 in 4 runs, the run over
    # keys 96-127 has no live key for rows 0-95. Each such run contributes
    # m = -inf, l = 0 and must not turn into NaN in the merge.
    q, k, v = (torch.from_numpy(a) for a in _inputs(splits, (1, 2, ln, 32)))
    whole = _fwd_emulated(q, k, v, causal=causal, scale=0.2)
    split = _fwd_emulated(q, k, v, causal=causal, scale=0.2, splits=splits)
    for a, b in zip(split, whole):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bh,ln,d,want", [
    (512, 512, 64, 1),    # the training shape: 2048 blocks, no split
    (8, 512, 64, 4),      # serving's pads on 132 SMs
    (8, 256, 64, 8),
    (8, 128, 64, 4),
    (8, 1, 64, 1),        # one key tile: nothing to split
    (1, 4096, 64, 4),
    (8, 512, 128, 2),     # 64-row query tiles at D = 128
])
def test_split_count(bh, ln, d, want):
    got = fa.split_count(bh, ln, d, 132)
    assert got == want
    assert got & (got - 1) == 0 and got <= max(1, -(-ln // 32))


def test_cuda_wrapper_takes_only_a_positive_scale(monkeypatch):
    # The kernel takes its running max over the raw scores.
    monkeypatch.setattr(fa, "_on_cuda", lambda *t: True)
    q = torch.empty(1, 2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="positive scale"):
        fa.flash_attention_fwd(q, q, q, causal=True, scale=0.0)
