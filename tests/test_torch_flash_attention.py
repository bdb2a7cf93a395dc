"""The port's flash-attention forward against the reference's Pallas kernel.

The same inputs, made with numpy from a seed, go through the reference's
``_fwd`` (the exact Pallas kernel logic, in interpret mode with 64-row
tiles, as ``tests/test_flash_attention.py`` runs it on the CPU) and through
the port's plain version, which is what the port's wrapper computes for CPU
tensors. O and lse must agree at 2e-5, the reference's own tolerance.

The CUDA kernel itself runs only on the card: its tests are in
``tests/test_torch_gpu.py``.
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
