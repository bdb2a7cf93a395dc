"""Tests of the PyTorch port that need a CUDA device; they skip without one.

This file imports torch and the port only (no JAX), so it also runs on a
GPU machine that has no JAX installed, without the JAX conftest:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the card; the
serving test shows the engine's prefills went through the kernel.
"""

import numpy as np
import pytest
import torch

from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.serve.engine import ServeEngine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ln,d,dtype,tol", [
    (128, 64, torch.float32, 1e-4), (200, 64, torch.float32, 1e-4),
    (512, 64, torch.float32, 1e-4), (96, 128, torch.float32, 1e-4),
    (77, 32, torch.float32, 1e-4), (1, 64, torch.float32, 1e-4),
    (256, 64, torch.bfloat16, 2.0 ** -8),
])
def test_flash_kernel_matches_plain(cuda_device, causal, ln, d, dtype, tol):
    # Against the plain version in fp32 on the same inputs. atol 1e-4: the
    # summation order and exp differ; a bf16 O is also rounded to nearest,
    # at most half a bf16 ulp (rtol 2**-8).
    gen = torch.Generator().manual_seed(ln * d)
    q, k, v = (torch.randn(2, 4, ln, d, generator=gen).to(cuda_device, dtype)
               for _ in range(3))
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=0.125)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and lse.shape == (2, 4, ln, 1)
    o_ref, lse_ref = fa.flash_attention_plain(
        q.float(), k.float(), v.float(), causal=causal, scale=0.125)
    torch.testing.assert_close(o.float(), o_ref, atol=1e-4, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 64, 48, device=cuda_device)  # no D=48 build
    with pytest.raises(ValueError, match="kernel takes"):
        fa.flash_attention_fwd(q, q, q, causal=True, scale=0.1)
    q = torch.zeros(1, 2, 64, 64, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q, q, q, causal=True, scale=0.1)


@pytest.mark.gpu
def test_engine_prefills_go_through_the_kernel(cuda_device):
    model = build_transformer_lm(64, 128, d_model=64, depth=2, num_heads=2)
    engine = ServeEngine(model, max_batch=4, max_len=128)
    assert engine.device.type == "cuda"
    rng = np.random.default_rng(0)
    fa.flash_attention_fwd.launches = 0
    reqs = [engine.submit(rng.integers(0, 64, size=n).tolist(),
                          max_new_tokens=6) for n in (5, 17, 40, 90, 3)]
    engine.run_until_idle()
    assert fa.flash_attention_fwd.launches == 2 * len(reqs)
    assert all(len(r.generated) == 6 for r in reqs)
    cpu = ServeEngine(build_transformer_lm(64, 128, d_model=64, depth=2,
                                           num_heads=2),
                      max_batch=4, max_len=128, device="cpu")
    ref = [cpu.submit(r.prompt, max_new_tokens=6) for r in reqs]
    cpu.run_until_idle()
    assert [r.generated for r in reqs] == [r.generated for r in ref]


@pytest.mark.gpu
def test_cuda_model_raises_on_a_head_dim_the_kernel_does_not_take(
        cuda_device):
    # key_dim 16: nothing on a CUDA model falls back to the plain version.
    model = build_transformer_lm(64, 32, d_model=32, depth=1, num_heads=2)
    model = model.to(cuda_device)
    tokens = torch.zeros(1, 32, dtype=torch.long, device=cuda_device)
    before = fa.flash_attention_fwd.launches
    with torch.inference_mode(), pytest.raises(ValueError,
                                                match="kernel takes"):
        model(tokens)
    assert fa.flash_attention_fwd.launches == before
