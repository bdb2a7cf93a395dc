"""Tests of the PyTorch port that need a CUDA device; they skip without one.

This file imports torch and the port only (no JAX), so it also runs on a
GPU machine that has no JAX installed, without the JAX conftest:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the card; the
serving test shows the engine's prefills went through the forward kernel
(and the paged engine's, which compute dense attention as the
reference's do, streams on the card as on the CPU),
the training test that a train step went through the forward, backward
and fused Adam kernels, and the CNN test that a fused ``fit`` went through
the fused cross-entropy and SGD kernels. The captured programs (CUDA
graphs, ``utils/graphs.py``) replay as their eager functions, bit for bit,
and their replays count the kernels they launch.
"""

import time

import numpy as np
import pytest
import torch

from tpu_dist_torch.data import Dataset, load_arrays
from tpu_dist_torch.models.cnn import build_cnn_model
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import fused
from tpu_dist_torch.ops.losses import SparseCategoricalCrossentropy
from tpu_dist_torch.ops.optimizers import SGD, Adam
from tpu_dist_torch.ops.schedules import ExponentialDecay
from tpu_dist_torch.serve.engine import ServeEngine
from tpu_dist_torch.training import Callback


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_fwd_close(q, k, v, o, lse, *, causal, scale):
    """The forward kernel's (O, lse) against the plain version in fp32 on
    the same (upcast) inputs. fp32: the summation order and exp differ (atol
    = rtol = 1e-4). bf16: the kernel rounds each p to bf16 before P·V, as
    the TPU kernel does (2**-8 of each term p·|v|, at most 2**-8 (P_ref @
    |V|) with P_ref the plain softmax), and rounds O to bf16 (2**-8 |O|):
    |O - O_ref| <= 1e-4 + 2**-8 (|O_ref| + P_ref @ |V|). lse is fp32 on both
    sides either way."""
    qf, kf, vf = q.float(), k.float(), v.float()
    o_ref, lse_ref = fa.flash_attention_plain(qf, kf, vf, causal=causal,
                                              scale=scale)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
    if q.dtype == torch.float32:
        torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=1e-4)
        return
    s = torch.einsum("...qd,...kd->...qk", qf, kf) * scale
    if causal:
        ln = s.shape[-1]
        keep = torch.ones(ln, ln, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    bound = 1e-4 + 2.0 ** -8 * (o_ref.abs() + torch.softmax(s, -1) @ vf.abs())
    err = (o.float() - o_ref).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


def _fwd_inputs(shape, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device, dtype)
            for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ln,d,dtype", [
    (128, 64, torch.float32), (200, 64, torch.float32),
    (512, 64, torch.float32), (96, 128, torch.float32),
    (77, 32, torch.float32), (1, 64, torch.float32),
    (256, 64, torch.bfloat16),
])
def test_flash_kernel_matches_plain(cuda_device, causal, ln, d, dtype):
    q, k, v = _fwd_inputs((2, 4, ln, d), dtype, cuda_device, seed=ln * d)
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=0.125)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and lse.shape == (2, 4, ln, 1)
    assert_fwd_close(q, k, v, o, lse, causal=causal, scale=0.125)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,ln", [(1, 128), (1, 256), (1, 512), (33, 128)])
def test_flash_fwd_split_and_unsplit_regimes(cuda_device, b, ln, causal,
                                             dtype):
    # Serving's prefill (8 instances) splits each query tile's keys into
    # runs merged by a second kernel; 264 instances fill the card unsplit.
    q, k, v = _fwd_inputs((b, 8, ln, 64), dtype, cuda_device, seed=ln + b)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits = fa.split_count(b * 8, ln, 64, sms)
    assert (splits > 1) == (b == 1)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=0.125)
    torch.cuda.synchronize()
    assert_fwd_close(q, k, v, o, lse, causal=causal, scale=0.125)
    if splits > 1 and dtype == torch.float32:
        # The same numbers as one run, to fp32 rounding. (In bf16 each run
        # rounds P against its own running max: both sides are held to the
        # bound above instead.)
        o1, lse1 = torch.empty_like(o), torch.empty_like(lse)
        fa._launch_fwd(q, k, v, o1, lse1, causal=causal, scale=0.125,
                       splits=1)
        torch.cuda.synchronize()
        torch.testing.assert_close(o1, o, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(lse1, lse, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 33])
def test_flash_fwd_is_deterministic(cuda_device, b):
    # No atomics; the merge sums the runs in a fixed order: two calls on the
    # same inputs give the same bits, split (b = 1) or not.
    q, k, v = _fwd_inputs((b, 8, 512, 64), torch.float32, cuda_device,
                          seed=3)
    first = fa.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    second = fa.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_at_the_largest_shared_memory_footprint(cuda_device,
                                                          dtype):
    # D = 128 takes the most shared memory per block (fp32 135 KB: Q's two
    # planes and the double-buffered K and V); L = 1024 streams 32 key
    # tiles through the buffers.
    q, k, v = _fwd_inputs((1, 8, 1024, 128), dtype, cuda_device, seed=6)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                    scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    assert_fwd_close(q, k, v, o, lse, causal=True, scale=128 ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_takes_views_off_a_16_byte_boundary(cuda_device, dtype):
    # The kernel copies 16-byte chunks; the wrapper copies a misaligned view
    # once rather than handing it to it.
    n = 2 * 4 * 77 * 64
    gen = torch.Generator().manual_seed(9)
    flat = torch.randn(3 * n + 1, generator=gen).to(cuda_device, dtype)
    q, k, v = (flat[1 + i * n:][:n].view(2, 4, 77, 64) for i in range(3))
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    torch.cuda.synchronize()
    assert_fwd_close(q, k, v, o, lse, causal=True, scale=0.125)


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
@pytest.mark.parametrize("kv_dtype,chunk", [("fp32", 0), ("int8", 0),
                                            ("fp32", 32)])
def test_paged_engine_on_the_card_streams_as_on_the_cpu(cuda_device,
                                                        kv_dtype, chunk):
    """The paged engine (prefix hits, copy on write, int8 pages, chunked
    prefill) on the card streams the same greedy tokens as on the CPU."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 64, size=37).tolist()
    prompts = [shared + rng.integers(0, 64, size=n).tolist()
               for n in (3, 20, 1, 9)]
    prompts += [rng.integers(0, 64, size=n).tolist() for n in (5, 70)]
    streams, hits = [], []
    for device in ("cuda", "cpu"):
        model = build_transformer_lm(64, 128, d_model=64, depth=2,
                                     num_heads=2)
        engine = ServeEngine(model, max_batch=3, max_len=128, paged=True,
                             page_size=16, kv_dtype=kv_dtype,
                             prefill_chunk=chunk, device=device)
        assert engine.cache["k"].device.type == device
        fa.flash_attention_fwd.launches = 0
        reqs = [engine.submit(p, max_new_tokens=8) for p in prompts]
        engine.run_until_idle()
        assert fa.flash_attention_fwd.launches == 0
        assert all(len(r.generated) == 8 for r in reqs)
        streams.append([r.generated for r in reqs])
        hits.append(engine._paging.prefix.hits)
        engine._paging.allocator.check()
    assert streams[0] == streams[1]
    assert hits[0] == hits[1] > 0


@pytest.mark.gpu
def test_init_page_pool_lands_on_the_card(cuda_device):
    from tpu_dist_torch.serve import kv_cache

    plan = kv_cache.build_plan(build_transformer_lm(64, 128, d_model=64,
                                                    depth=2, num_heads=2))
    for dtype in (torch.float32, torch.int8):
        pool = kv_cache.init_page_pool(plan, num_pages=4, page_size=16,
                                       dtype=dtype)
        assert all(a.is_cuda for a in pool.values())
        assert sorted(pool) == (["k", "k_scale", "v", "v_scale"]
                                if dtype == torch.int8 else ["k", "v"])


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


def _bwd_inputs(shape, dtype, causal, scale, device, seed):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen).to(device, dtype)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    return q, k, v, o, lse, do


def assert_grads_close(got, want, dtype):
    """fp32: both sides sum fp32 products in another order (atol = rtol =
    1e-4). bf16: either side may round an output to the neighbouring bf16
    value (one ulp, at most 2**-7 of it), and a P or dS value that lies
    within the fp32 difference of a bf16 rounding boundary may round the
    other way on one side (2**-8 of one term, at most of the largest)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        want = want.float()
        torch.testing.assert_close(
            got.float(), want, rtol=2.0 ** -7,
            atol=2.0 ** -8 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ln,d,dtype", [
    (128, 64, torch.float32), (512, 64, torch.float32),
    (200, 64, torch.float32), (77, 32, torch.float32),
    (96, 128, torch.float32), (1, 64, torch.float32),
    (256, 64, torch.bfloat16), (130, 128, torch.bfloat16),
])
def test_flash_bwd_kernels_match_plain(cuda_device, causal, ln, d, dtype):
    q, k, v, o, lse, do = _bwd_inputs((2, 4, ln, d), dtype, causal, 0.125,
                                      cuda_device, seed=ln * d)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 scale=0.125)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        scale=0.125)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == q.shape
        assert_grads_close(g, w, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_are_deterministic(cuda_device, dtype):
    # Each block writes only rows it owns and sums in a fixed order (no
    # atomics): two calls on the same inputs give the same bits.
    args = _bwd_inputs((2, 4, 200, 64), dtype, True, 0.125, cuda_device,
                       seed=5)
    first = fa.flash_attention_bwd(*args, causal=True, scale=0.125)
    second = fa.flash_attention_bwd(*args, causal=True, scale=0.125)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_bwd_bf16_at_the_largest_shared_memory_footprint(cuda_device):
    # D = 128 takes the most shared memory per block; L = 1024 streams 16
    # query tiles of 64 (dQ) and 32 tiles of 32 (dK/dV) through the double
    # buffers.
    args = _bwd_inputs((1, 8, 1024, 128), torch.bfloat16, True, 128 ** -0.5,
                       cuda_device, seed=6)
    got = fa.flash_attention_bwd(*args, causal=True, scale=128 ** -0.5)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(*args, causal=True,
                                        scale=128 ** -0.5)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == args[0].shape
        assert_grads_close(g, w, torch.bfloat16)


@pytest.mark.gpu
def test_flash_bwd_takes_views_off_a_16_byte_boundary(cuda_device):
    # The kernels copy 16-byte chunks; the wrapper copies a misaligned view
    # once rather than handing it to them.
    gen = torch.Generator().manual_seed(8)
    flat = torch.randn(4 * 2 * 4 * 77 * 32 + 1, generator=gen).to(cuda_device)
    q, k, v, do = (flat[1 + i * 2 * 4 * 77 * 32:][:2 * 4 * 77 * 32]
                   .view(2, 4, 77, 32) for i in range(4))
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    o, lse = fa.flash_attention_fwd(q.clone(), k.clone(), v.clone(),
                                    causal=False, scale=0.2)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False,
                                 scale=0.2)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False,
                                        scale=0.2)
    for g, w in zip(got, want):
        assert_grads_close(g, w, torch.float32)


@pytest.mark.gpu
def test_flash_bwd_raises_on_a_head_dim_the_kernels_do_not_take(
        cuda_device):
    q = torch.zeros(1, 2, 64, 48, device=cuda_device)  # no D=48 build
    lse = torch.zeros(1, 2, 64, 1, device=cuda_device)
    before = fa.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="kernel takes"):
        fa.flash_attention_bwd(q, q, q, q, lse, q, causal=True, scale=0.1)
    assert fa.flash_attention_bwd.launches == before


def _adam_leaves(device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    shapes = [(4097,), (1,), (33, 65), (3, 4096), (8192 + 5,)]
    return [[torch.randn(s, generator=gen).to(device) for s in shapes]
            for _ in range(3)]


@pytest.mark.gpu
def test_fused_adam_matches_plain(cuda_device):
    # Same arithmetic in the same order with round-to-nearest on both
    # sides: expected bit for bit; rtol 1e-6 allows a division or square
    # root that rounds the other way.
    params, grads, mu = _adam_leaves(cuda_device)
    mu = [m.abs() * 0.1 for m in mu]
    nu = [m * m for m in mu]
    ref = [[t.clone() for t in ts] for ts in (params, mu, nu)]
    before = fused.fused_adam_apply.launches
    for t in range(1, 4):
        step = torch.tensor(t, dtype=torch.int32, device=cuda_device)
        fused.fused_adam_apply(params, grads, mu, nu, step=step,
                               learning_rate=1e-3)
        fused.fused_adam_plain(*ref[:1], grads, *ref[1:], step=step,
                               learning_rate=1e-3)
    torch.cuda.synchronize()
    assert fused.fused_adam_apply.launches == before + 3
    for got, want in zip((params, mu, nu), ref):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_fused_adam_follows_fresh_grads_and_skips_empty_leaves(cuda_device):
    # New grad tensors every step (as backward allocates them) and an empty
    # leaf among the others: the grads' addresses go with each launch, so
    # each step reads that step's grads on the one table built. Tolerance
    # as in the test above.
    params, _, mu = _adam_leaves(cuda_device)
    params.insert(2, torch.empty(0, device=cuda_device))
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    ref = [[t.clone() for t in ts] for ts in (params, mu, nu)]
    tables = fused.adam_tables()
    for t in range(1, 4):
        grads = [torch.randn_like(p) for p in params]
        step = torch.tensor(t, dtype=torch.int32, device=cuda_device)
        fused.fused_adam_apply(params, grads, mu, nu, step=step,
                               learning_rate=1e-3, tables=tables)
        fused.fused_adam_plain(*ref[:1], grads, *ref[1:], step=step,
                               learning_rate=1e-3)
        del grads
    assert tables.builds == 1
    torch.cuda.synchronize()
    for got, want in zip((params, mu, nu), ref):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", ["constant", "schedule"])
def test_fused_adam_scale_matches_plain_at_every_step_count(cuda_device,
                                                            rate):
    # The kernel computes lr sqrt(1 - b2^t) / (1 - b1^t) from the device
    # counter with the plain version's fp32 operations (powf, a correctly
    # rounded sqrt and quotient): bit for bit at each of many counts, with
    # a float rate and with a schedule's tensor, from the same state.
    gen = torch.Generator().manual_seed(7)
    params, grads, mu = ([torch.randn(4099, generator=gen).to(cuda_device)]
                         for _ in range(3))
    nu = [mu[0] * mu[0]]
    lr = (1e-3 if rate == "constant" else
          ExponentialDecay(2e-3, 3, 0.9)(torch.tensor(
              5, dtype=torch.int32, device=cuda_device)))
    tables = fused.adam_tables()
    for t in [*range(1, 65), 1000, 12345, 10 ** 6, 2 ** 31 - 1]:
        step = torch.tensor(t, dtype=torch.int32, device=cuda_device)
        got = [[x.clone() for x in xs] for xs in (params, mu, nu)]
        want = [[x.clone() for x in xs] for xs in (params, mu, nu)]
        fused.fused_adam_apply(got[0], grads, got[1], got[2], step=step,
                               learning_rate=lr, tables=tables)
        fused.fused_adam_plain(want[0], grads, want[1], want[2], step=step,
                               learning_rate=lr)
        assert all(torch.equal(a, b) for a, b in zip(sum(got, []),
                                                     sum(want, []))), t


@pytest.mark.gpu
def test_fused_adam_raises_on_what_the_kernel_does_not_take(cuda_device):
    p = torch.zeros(10, device=cuda_device, dtype=torch.bfloat16)
    step = torch.ones((), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="fp32"):
        fused.fused_adam_apply([p], [p], [p], [p], step=step,
                               learning_rate=0.1)
    p = torch.zeros(10, device=cuda_device)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused.fused_adam_apply([p], [p], [p], [p], step=step.cpu(),
                               learning_rate=0.1)
    with pytest.raises(ValueError, match="int32"):
        fused.fused_adam_apply([p], [p], [p], [p], step=step.float(),
                               learning_rate=0.1)


@pytest.mark.gpu
def test_cuda_train_step_launches_each_kernel(cuda_device):
    # depth 2, key_dim 32; the CPU twin takes the plain versions. Losses
    # agree to 1e-4: fp32 on both sides, sums in another order.
    def make(device):
        model = build_transformer_lm(64, 64, d_model=64, depth=2, num_heads=2,
                                     seed=3)
        model.compile(optimizer=Adam(learning_rate=1e-3, fused=True),
                      loss=SparseCategoricalCrossentropy(from_logits=True),
                      device=device)
        return model

    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, size=(4, 64))
    y = np.roll(x, -1, axis=1)
    losses = {}
    for device in ("cpu", cuda_device):
        model = make(device)
        fn, state = model.make_train_function(), model.train_state()
        fa.flash_attention_fwd.launches = 0
        fa.flash_attention_bwd.launches = 0
        fused.fused_adam_apply.launches = 0
        losses[str(device)] = [float(fn(*state, x, y)) for _ in range(3)]
        launches = (fa.flash_attention_fwd.launches,
                    fa.flash_attention_bwd.launches,
                    fused.fused_adam_apply.launches)
        assert launches == ((0, 0, 0) if device == "cpu" else (6, 6, 3))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 10), (37, 10), (2, 16, 64),
                                   (300, 1000), (8, 8192), (5, 7)], ids=str)
def test_fused_ce_kernels_match_plain(cuda_device, shape, dtype):
    # The same fp32 math; the kernel sums exp(x - max) with an online
    # rescale (atol = rtol = 1e-5 on loss and lse). The backward gets the
    # kernel's lse on both sides: fp32 equal to 1e-5, a bf16 gradient
    # equal or one bf16 ulp apart (rtol 2**-7).
    gen = torch.Generator().manual_seed(shape[-1] + len(shape))
    x = (3 * torch.randn(shape, generator=gen)).to(cuda_device, dtype)
    y = torch.randint(-1, shape[-1] + 1, shape[:-1], generator=gen).to(
        cuda_device)                     # some labels out of range
    g = (torch.rand(shape[:-1], generator=gen) + 0.5).to(cuda_device)
    x2, y2 = x.reshape(-1, shape[-1]), y.reshape(-1)
    before = (fused.fused_ce_fwd.launches, fused.fused_ce_bwd.launches)
    loss, lse = fused.fused_ce_fwd(x2, y2)
    dx = fused.fused_ce_bwd(x2, y2, lse, g.reshape(-1))
    torch.cuda.synchronize()
    assert (fused.fused_ce_fwd.launches,
            fused.fused_ce_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_loss, want_lse = fused.fused_ce_fwd_plain(x2, y2)
    want_dx = fused.fused_ce_bwd_plain(x2, y2, lse, g.reshape(-1))
    torch.testing.assert_close(loss, want_loss, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    assert dx.dtype == dtype
    # Both sides start from the kernel's lse and do the same fp32
    # operations and the same round to nearest: bit for bit.
    assert torch.equal(dx, want_dx)


@pytest.mark.gpu
def test_fused_ce_raises_on_what_the_kernels_do_not_take(cuda_device):
    y = torch.zeros(4, dtype=torch.long, device=cuda_device)
    before = fused.fused_ce_fwd.launches
    for x, lab, match in (
            (torch.zeros(4, 10, dtype=torch.float16, device=cuda_device), y,
             "fp32 or bf16"),
            (torch.zeros(10, 4, device=cuda_device).t(), y, "contiguous"),
            (torch.zeros(4, 10, device=cuda_device), y.cpu(),
             "one CUDA device")):
        with pytest.raises(ValueError, match=match):
            fused.fused_ce_fwd(x, lab)
    assert fused.fused_ce_fwd.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_fused_sgd_matches_plain_bit_for_bit(cuda_device, momentum,
                                             nesterov):
    # The same fp32 operations in the same order, rounded to nearest with
    # no contraction; an empty leaf among the others is skipped.
    params, grads, vel = _adam_leaves(cuda_device, seed=1)
    params.insert(1, torch.empty(0, device=cuda_device))
    grads.insert(1, torch.empty(0, device=cuda_device))
    vel = [torch.zeros_like(p) for p in params] if momentum else None
    ref_p = [p.clone() for p in params]
    ref_v = [v.clone() for v in vel] if momentum else None
    before = fused.fused_sgd_apply.launches
    for _ in range(3):
        fused.fused_sgd_apply(params, grads, vel, learning_rate=0.01,
                              momentum=momentum, nesterov=nesterov)
        fused.fused_sgd_plain(ref_p, grads, ref_v, learning_rate=0.01,
                              momentum=momentum, nesterov=nesterov)
    torch.cuda.synchronize()
    assert fused.fused_sgd_apply.launches == before + 3
    for got, want in zip(params + (vel or []), ref_p + (ref_v or [])):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_fused_sgd_raises_on_what_the_kernel_does_not_take(cuda_device):
    p = torch.zeros(10, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fp32"):
        fused.fused_sgd_apply([p], [p], learning_rate=0.1)
    p = torch.zeros(10, device=cuda_device)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused.fused_sgd_apply([p], [torch.zeros(10)], learning_rate=0.1)
    with pytest.raises(ValueError, match="one value"):
        fused.fused_sgd_apply([p], [p], learning_rate=torch.ones(2))


@pytest.mark.gpu
def test_scheduled_fused_sgd_launches_the_kernel(cuda_device):
    # A schedule's rate stays on the card and the kernel reads it there:
    # SGD(fused=True) launches once per step and matches the plain update
    # bit for bit.
    params, _, _ = _adam_leaves(cuda_device, seed=2)
    ref = [p.clone() for p in params]
    decay = lambda: ExponentialDecay(0.01, decay_steps=1, decay_rate=0.5)
    fused_opt = SGD(learning_rate=decay(), momentum=0.9, fused=True)
    plain_opt = SGD(learning_rate=decay(), momentum=0.9)
    fs, ps = fused_opt.init(params), plain_opt.init(ref)
    before = fused.fused_sgd_apply.launches
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=gen).to(cuda_device)
                 for p in params]
        fs = fused_opt.update(grads, fs, params)
        ps = plain_opt.update(grads, ps, ref)
    torch.cuda.synchronize()
    assert fused.fused_sgd_apply.launches == before + 3
    assert int(fs.step) == 3
    for got, want in zip(params + fs.velocity, ref + ps.velocity):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_cnn_fused_fit_launches_the_kernels(cuda_device):
    # The CNN's fit with the fused CE and SGD on the card against the same
    # fit on the CPU (plain versions): losses agree to 1e-4 (fp32, cuDNN's
    # convolutions sum in another order than the CPU's, over 6 steps).
    images, labels = load_arrays("mnist", synthetic_size=256)
    x, y = images.astype(np.float32) / 255.0, labels
    histories = {}
    for device in ("cpu", cuda_device):
        model = build_cnn_model(seed=1)
        model.compile(optimizer=SGD(learning_rate=0.01, fused=True),
                      loss=SparseCategoricalCrossentropy(from_logits=True,
                                                         fused=True),
                      device=device)
        fused.fused_ce_fwd.launches = fused.fused_ce_bwd.launches = 0
        fused.fused_sgd_apply.launches = 0
        histories[str(device)] = model.fit(
            Dataset.from_tensor_slices((x, y)).batch(32), epochs=2,
            steps_per_epoch=3, verbose=0).history["loss"]
        launches = (fused.fused_ce_fwd.launches, fused.fused_ce_bwd.launches,
                    fused.fused_sgd_apply.launches)
        assert launches == ((0, 0, 0) if device == "cpu" else (6, 6, 6))
    np.testing.assert_allclose(histories["cuda"], histories["cpu"],
                               atol=1e-4)


# -- the fused optimizers' vector and scalar paths, cache and CUDA graphs -----

#: (shape, columns starting one float past a 16-byte boundary): whole
#: chunks, ragged last chunks, lengths that are not a multiple of 4 (the
#: vector path's scalar tail), a one-element leaf, an empty leaf, leaves off
#: the boundary in every column or in the grad's alone (the scalar path).
MIXED_LEAVES = (((3 * 4096,), ()), ((4097,), "all"), ((1,), ()),
                ((33, 65), (1,)), ((8197,), ()), ((0,), ()),
                ((130,), "all"), ((4099,), ()))


def _mixed(device, gen, column: int, scale: float = 1.0):
    """One column (0 params, 1 grads, 2+ state) of MIXED_LEAVES."""
    out = []
    for shape, off in MIXED_LEAVES:
        n = int(np.prod(shape))
        shift = off == "all" or column in off
        base = torch.randn(n + shift, generator=gen).to(device) * scale
        out.append(base[shift:].reshape(shape))
    return out


def _rate(kind):
    return (0.01 if kind == "constant" else
            ExponentialDecay(0.02, decay_steps=1, decay_rate=0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("rate", ["constant", "schedule"])
@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_fused_sgd_vector_and_scalar_paths_bit_for_bit(cuda_device, momentum,
                                                       nesterov, rate):
    # Fresh grads at new addresses each step; the fused optimizer's cached
    # table follows them. The same fp32 operations in the same order on
    # both paths: bit for bit with the plain update.
    gen = torch.Generator().manual_seed(4)
    params = _mixed(cuda_device, gen, 0)
    assert any(p.data_ptr() % 16 for p in params)
    ref = [p.clone() for p in params]
    fused_opt = SGD(learning_rate=_rate(rate), momentum=momentum,
                    nesterov=nesterov, fused=True)
    plain_opt = SGD(learning_rate=_rate(rate), momentum=momentum,
                    nesterov=nesterov)
    fs, ps = fused_opt.init(params), plain_opt.init(ref)
    before = fused.fused_sgd_apply.launches
    for _ in range(3):
        grads = _mixed(cuda_device, gen, 1)
        fs = fused_opt.update(grads, fs, params)
        ps = plain_opt.update(grads, ps, ref)
    torch.cuda.synchronize()
    assert fused.fused_sgd_apply.launches == before + 3
    vel = fs.velocity if rate == "schedule" else fs
    ref_vel = ps.velocity if rate == "schedule" else ps
    for got, want in zip(params + list(vel), ref + list(ref_vel)):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", ["constant", "schedule"])
def test_fused_adam_vector_and_scalar_paths_bit_for_bit(cuda_device, rate):
    # As above for Adam; its moments start off the boundary in some leaves
    # too. The plain version does the same operations with round to nearest
    # (division and square root included): bit for bit.
    gen = torch.Generator().manual_seed(5)
    params = _mixed(cuda_device, gen, 0)
    ref = [p.clone() for p in params]
    lr = (1e-3 if rate == "constant" else
          ExponentialDecay(2e-3, decay_steps=1, decay_rate=0.5))
    fused_opt, plain_opt = Adam(learning_rate=lr, fused=True), Adam(
        learning_rate=lr)
    fs, ps = fused_opt.init(params), plain_opt.init(ref)
    # Moments that start off a 16-byte boundary where MIXED_LEAVES says.
    fs = fs._replace(mu=[m.copy_(g.abs()) for m, g in
                         zip(_mixed(cuda_device, gen, 2), fs.mu)],
                     nu=[v.copy_(g * g) for v, g in
                         zip(_mixed(cuda_device, gen, 3), fs.nu)])
    ps = ps._replace(mu=[m.clone() for m in fs.mu],
                     nu=[v.clone() for v in fs.nu])
    before = fused.fused_adam_apply.launches
    for _ in range(3):
        grads = _mixed(cuda_device, gen, 1)
        fs = fused_opt.update(grads, fs, params)
        ps = plain_opt.update(grads, ps, ref)
    torch.cuda.synchronize()
    assert fused.fused_adam_apply.launches == before + 3
    for got, want in zip(params + fs.mu + fs.nu, ref + ps.mu + ps.nu):
        assert torch.equal(got, want)


def _state_tensors(state):
    """Every tensor of an optimizer state, in order."""
    if isinstance(state, list):
        return state
    return [t for part in state
            for t in (part if isinstance(part, list) else [part])]


@pytest.mark.gpu
@pytest.mark.parametrize("make", [
    lambda: SGD(learning_rate=0.01, fused=True),
    lambda: SGD(learning_rate=0.01, momentum=0.9, fused=True),
    lambda: SGD(learning_rate=0.01, momentum=0.9, nesterov=True, fused=True),
    lambda: SGD(learning_rate=ExponentialDecay(0.02, 1, 0.5), momentum=0.9,
                fused=True),
    lambda: Adam(learning_rate=1e-3, fused=True),
], ids=["sgd", "momentum", "nesterov", "schedule", "adam"])
def test_fused_update_is_captured_and_replays_as_eager(cuda_device, make):
    # On a cached table the update copies nothing from the host and
    # allocates nothing of its own, so a CUDA graph captures it (with the
    # schedule's rate, Adam's step counter and scale); three replays give
    # the bits of three eager updates.
    gen = torch.Generator().manual_seed(6)
    params = _mixed(cuda_device, gen, 0)
    grads = _mixed(cuda_device, gen, 1, scale=0.1)
    twin_params = [p.clone() for p in params]
    optimizer, twin = make(), make()
    state, twin_state = optimizer.init(params), twin.init(twin_params)
    side = torch.cuda.Stream()              # warm up off the default stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        state = optimizer.update(grads, state, params)
    torch.cuda.current_stream().wait_stream(side)
    twin_state = twin.update(grads, twin_state, twin_params)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        optimizer.update(grads, state, params)
    for _ in range(3):
        graph.replay()
        twin_state = twin.update(grads, twin_state, twin_params)
    torch.cuda.synchronize()
    assert optimizer._tables.builds == 1
    for got, want in zip(params + _state_tensors(state),
                         twin_params + _state_tensors(twin_state)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_fused_update_refuses_to_build_a_table_while_capturing(cuda_device):
    # A miss needs a copy from the host, which a capture cannot hold: the
    # wrapper says so instead of breaking the capture.
    params = [torch.zeros(8, device=cuda_device)]
    grads = [torch.ones(8, device=cuda_device)]
    optimizer = SGD(learning_rate=0.1, fused=True)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="eagerly first"):
        with torch.cuda.graph(graph):
            optimizer.update(grads, optimizer.init(params), params)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [
    lambda: SGD(learning_rate=0.01, fused=True),
    lambda: SGD(learning_rate=0.01, momentum=0.9, fused=True),
    lambda: Adam(learning_rate=1e-3, fused=True)], ids=["sgd", "momentum",
                                                       "adam"])
def test_steady_fit_builds_no_new_table(cuda_device, make):
    # backward hands out new grads every step, at addresses that move; the
    # table holds only the params and the state, so the first step builds
    # it and no later one does.
    images, labels = load_arrays("mnist", synthetic_size=512)
    x, y = images.astype(np.float32) / 255.0, labels
    model = build_cnn_model(seed=2)
    optimizer = make()
    model.compile(optimizer=optimizer,
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=True),
                  device=cuda_device)
    builds = []

    class Record(Callback):
        wants_batches = True

        def on_batch_end(self, step, logs):
            builds.append(optimizer._tables.builds)

    model.fit(Dataset.from_tensor_slices((x, y)).batch(32), epochs=2,
              steps_per_epoch=6, verbose=0, callbacks=[Record()])
    assert builds == [1] * 12


# -- CUDA graphs: serving's and training's captured programs -----------------


def _graph_lm():
    from tpu_dist_torch.serve import kv_cache

    model = build_transformer_lm(64, 128, d_model=64, depth=2, num_heads=2,
                                 seed=3).cuda().eval()
    return model, kv_cache.build_plan(model)


@pytest.mark.gpu
def test_a_prefill_replay_equals_the_eager_prefill(cuda_device):
    # The first call runs eagerly, the second captures and replays, the
    # third replays: every call's logits and the cache bytes are the eager
    # function's on the same inputs, bit for bit, and each call counts its
    # depth flash launches once (the capture counts none).
    from functools import partial

    from tpu_dist_torch.serve import kv_cache
    from tpu_dist_torch.utils.graphs import CapturedProgram, spec_of

    _, plan = _graph_lm()
    caches = [kv_cache.init_cache(plan, max_batch=3, max_len=128,
                                  device=cuda_device) for _ in range(2)]
    rng = np.random.default_rng(4)
    calls = [dict(tokens=rng.integers(0, 64, size=32), length=n, slot=s)
             for n, s in ((29, 0), (7, 2), (32, 1))]
    prog = CapturedProgram(partial(kv_cache.prefill, plan, caches[1]),
                           {n: spec_of(v) for n, v in calls[0].items()},
                           device=cuda_device)
    fa.flash_attention_fwd.launches = 0
    with torch.inference_mode():
        for i, call in enumerate(calls):
            got = prog(**call).clone()
            counted = fa.flash_attention_fwd.launches
            want = kv_cache.prefill(plan, caches[0],
                                    torch.from_numpy(call["tokens"]).cuda(),
                                    call["length"], call["slot"])
            assert fa.flash_attention_fwd.launches == counted + 2
            assert counted == 2 * (2 * i + 1)
            assert torch.equal(got, want)
            assert all(torch.equal(caches[0][k], caches[1][k])
                       for k in caches[0])
    assert prog.graph is not None and prog.replays == 2


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8])
def test_a_ragged_decode_replay_equals_the_eager_step(cuda_device, kv_dtype):
    from functools import partial

    from tpu_dist_torch.serve import kv_cache
    from tpu_dist_torch.utils.graphs import CapturedProgram, spec_of

    _, plan = _graph_lm()
    pools = [kv_cache.init_page_pool(plan, num_pages=16, page_size=16,
                                     dtype=kv_dtype, device=cuda_device)
             for _ in range(2)]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for name, a in pools[0].items():
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=gen,
                                  device=cuda_device))
        else:
            a.copy_(torch.rand(a.shape, generator=gen, device=cuda_device))
        pools[1][name].copy_(a)
    tables = np.full((4, 8), 16, np.int32)
    tables[0, :3], tables[1, :2], tables[2, :2] = [4, 1, 9], [2, 7], [3, 5]
    host = dict(page_tables=tables, tokens=np.array([1, 2, 3, 4]),
                lengths=np.array([40, 20, 17, 0]),
                active=np.array([True, False, True, False]))
    prog = CapturedProgram(
        partial(kv_cache.paged_decode_ragged, plan, pools[1]),
        {n: spec_of(v) for n, v in host.items()}, device=cuda_device)
    with torch.inference_mode():
        for _ in range(3):
            got = prog(**host).clone()
            want = kv_cache.paged_decode_ragged(
                plan, pools[0], *(torch.from_numpy(host[n]).cuda() for n in
                                  ("page_tables", "tokens", "lengths",
                                   "active")))
            assert torch.equal(got, want)
            assert all(torch.equal(pools[0][k], pools[1][k])
                       for k in pools[0])
            host["tokens"] = got.argmax(-1).cpu().numpy()
            host["lengths"] = host["lengths"] + host["active"]
    assert prog.replays == 2


@pytest.mark.gpu
def test_engine_captures_each_program_on_the_card_and_never_on_the_cpu(
        cuda_device):
    # The ragged engine holds one decode program, replayed every step but
    # the first; every key used twice is captured; the CPU engine holds
    # none. Both stream the same tokens.
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 64, size=n).tolist() for n in (5, 30, 9, 12)]
    streams = []
    for device in (cuda_device, "cpu"):
        model = build_transformer_lm(64, 128, d_model=64, depth=2,
                                     num_heads=2)
        engine = ServeEngine(model, max_batch=4, max_len=128, paged=True,
                             ragged=True, device=device)
        reqs = [engine.submit(p, max_new_tokens=8) for p in prompts]
        engine.run_until_idle()
        streams.append([r.generated for r in reqs])
        if device == "cpu":
            assert engine.programs == {} and engine.capture_seconds == 0.0
            continue
        decode = [p for (family, _), p in engine.programs.items()
                  if family == "paged_decode"]
        assert len(decode) == 1 and decode[0].replays == decode[0].calls - 1
        assert all((p.graph is not None) == (p.calls > 1)
                   for p in engine.programs.values())
        assert engine.capture_seconds > 0
    assert streams[0] == streams[1]


@pytest.mark.gpu
def test_a_capture_that_fails_raises_and_runs_nothing_eagerly(cuda_device):
    # A fused update whose leaf table is new at every call: the first call
    # runs eagerly and builds its table; the second must capture, meets a
    # table it cannot build inside a capture, and raises — the parameter
    # keeps the first call's value.
    from tpu_dist_torch.utils.graphs import CapturedProgram

    params = [torch.zeros(8, device=cuda_device)]
    grads = [torch.ones(8, device=cuda_device)]

    def update(lr):
        optimizer = SGD(learning_rate=0.1, fused=True)
        optimizer.update(grads, optimizer.init(params), params)
        return params[0].sum()

    prog = CapturedProgram(update, {"lr": ((), torch.float32)},
                           device=cuda_device)
    fused.fused_sgd_apply.launches = 0
    prog(lr=np.float32(0.1))
    after_one = params[0].clone()
    with pytest.raises(RuntimeError, match="eagerly first"):
        prog(lr=np.float32(0.1))
    torch.cuda.synchronize()
    assert torch.equal(params[0], after_one)
    assert prog.graph is None and fused.fused_sgd_apply.launches == 1
    with pytest.raises(ValueError, match="CUDA device"):
        CapturedProgram(update, {}, device="cpu")


@pytest.mark.gpu
def test_cnn_fit_on_graphs_equals_k1_and_counts_replays(cuda_device):
    # steps_per_execution = 3 on the card: each window after the first is
    # a replay of one captured graph of 3 steps. Losses and parameters
    # equal k = 1's, and the kernels count every step (cuDNN set
    # deterministic, so the convolutions' sums do not move between runs).
    images, labels = load_arrays("mnist", synthetic_size=512)
    x, y = images.astype(np.float32) / 255.0, labels
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    try:
        for k in (1, 3):
            model = build_cnn_model(seed=1)
            model.compile(optimizer=SGD(learning_rate=0.01, fused=True),
                          loss=SparseCategoricalCrossentropy(
                              from_logits=True, fused=True),
                          steps_per_execution=k, device=cuda_device)
            fused.fused_ce_fwd.launches = fused.fused_ce_bwd.launches = 0
            fused.fused_sgd_apply.launches = 0
            history = model.fit(Dataset.from_tensor_slices((x, y)).batch(32),
                                epochs=3, steps_per_epoch=6, verbose=0)
            out[k] = (history.history["loss"],
                      [p.detach().clone() for p in model.parameters()],
                      (fused.fused_ce_fwd.launches,
                       fused.fused_ce_bwd.launches,
                       fused.fused_sgd_apply.launches),
                      model._trainer)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    assert out[3][2] == out[1][2] == (18, 18, 18)
    assert out[3][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[3][1], out[1][1]))
    (graphed,) = out[3][3]._graphed.values()
    ((prog, _),) = graphed.programs.values()
    assert prog.calls == 6 and prog.replays == 5


# -- the input pipeline (data/) on the card -----------------------------------


def _scale_div(image, label):
    return np.asarray(image, np.float32) / 255.0, label


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["mul", "div"])
def test_device_scale_is_numpys_bits_on_cuda(cuda_device, op):
    # Every byte value through the device transform: a CUDA division by a
    # host scalar would multiply by the reciprocal and miss numpy's
    # quotient by an ulp for some bytes; the 0-d device divisor does not.
    from tpu_dist_torch.data.vectorize import device_scale_fn

    k = 255.0 if op == "div" else 1.0 / 255.0
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = device_scale_fn(k, op)(torch.from_numpy(x).to(cuda_device))
    xf = x.astype(np.float32)
    want = xf / np.float32(k) if op == "div" else xf * np.float32(k)
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["mul", "div"])
def test_device_dataset_on_cuda_equals_cpu(cuda_device, op):
    from tpu_dist_torch.data import DeviceDataset

    x, y = load_arrays("mnist", synthetic_size=512)
    kw = dict(global_batch_size=64, seed=4, scale_op=op,
              scale=255.0 if op == "div" else 1.0 / 255.0)
    gpu = DeviceDataset(x, y, device=cuda_device, **kw)
    cpu = DeviceDataset(x, y, device="cpu", **kw)
    for _ in range(10):   # across an epoch boundary
        for a, b in zip(gpu.next_batch(), cpu.next_batch()):
            assert a.device.type == "cuda"
            assert torch.equal(a.cpu(), b)
    for a, b in zip(gpu.next_stack(3), cpu.next_stack(3)):
        assert torch.equal(a.cpu(), b)
    for (ga, gb), (ca, cb) in zip(gpu, cpu):
        assert torch.equal(ga.cpu(), ca) and torch.equal(gb.cpu(), cb)
    assert gpu._dx.dtype == torch.uint8 and gpu.uploads == 1


@pytest.mark.gpu
def test_device_prefetcher_places_batches_on_its_own_stream(cuda_device):
    from tpu_dist_torch.data import DevicePrefetcher

    x, y = load_arrays("mnist", synthetic_size=256)
    host = [(x[i:i + 32], y[i:i + 32]) for i in range(0, 256, 32)]
    pf = DevicePrefetcher(iter(host), depth=2, device=cuda_device)
    got = list(pf)
    assert len(got) == len(host) and pf.hits + pf.misses == len(host)
    for (gx, gy), (hx, hy) in zip(got, host):
        assert gx.device.type == "cuda" and gx.dtype == torch.uint8
        assert torch.equal(gx.cpu(), torch.from_numpy(hx))
        assert torch.equal(gy.cpu(), torch.from_numpy(hy))
    pf.close()
    assert pf.closed


@pytest.mark.gpu
def test_fit_promotes_the_reference_chain_and_gathers_in_the_program(
        cuda_device):
    # The reference program's chain (unseeded shuffle) is promoted on
    # CUDA: one upload, and at k = 4 one captured program whose only input
    # is the index vector; its losses equal the same chain's at k = 1 when
    # the order is fixed (no shuffle).
    from tpu_dist_torch.data import DeviceDataset, load

    def chain(shuffle):
        ds = load("mnist", split="train", synthetic_size=512).map(
            _scale_div).cache()
        return (ds.shuffle(10000) if shuffle else ds).batch(32)

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    try:
        for k, shuffle in ((1, True), (1, False), (4, False)):
            model = build_cnn_model(seed=2)
            model.compile(optimizer=SGD(learning_rate=0.01, fused=True),
                          loss=SparseCategoricalCrossentropy(
                              from_logits=True, fused=True),
                          steps_per_execution=k, device=cuda_device)
            ds = chain(shuffle)
            h = model.fit(ds, epochs=2, steps_per_epoch=8, verbose=0)
            promoted = ds._device_promoted
            assert isinstance(promoted, DeviceDataset)
            assert promoted.uploads == 1 and promoted.device.type == "cuda"
            out[k, shuffle] = (h.history["loss"],
                               [p.detach().clone()
                                for p in model.parameters()],
                               model._trainer)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    assert np.isfinite(out[1, True][0]).all()
    np.testing.assert_allclose(out[4, False][0], out[1, False][0], rtol=0,
                               atol=1e-5)
    for a, b in zip(out[4, False][1], out[1, False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    (graphed,) = out[4, False][2]._graphed.values()
    ((key, (prog, _)),) = graphed.programs.items()
    assert key[0] == "indices" and list(prog.static) == ["idx"]
    assert prog.calls == 4 and prog.replays == 3


@pytest.mark.gpu
def test_prefetch_to_device_equals_no_prefetch(cuda_device):
    from tpu_dist_torch.data import load

    losses = []
    for depth in (0, 2):
        model = build_cnn_model(seed=2)
        model.compile(optimizer=SGD(learning_rate=0.01),
                      loss=SparseCategoricalCrossentropy(from_logits=True),
                      prefetch_to_device=depth, device=cuda_device)
        ds = (load("mnist", split="train", synthetic_size=256)
              .map(_scale_div).shuffle(256, seed=1).batch(32))
        h = model.fit(ds, epochs=2, steps_per_epoch=8, verbose=0)
        losses.append(h.history["loss"])
        assert model._trainer._prefetcher is None   # closed by fit
    np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=1e-5)


# -- the ResNets, BatchNorm state, Dropout, predict and the policy ------------


@pytest.fixture
def deterministic_cudnn():
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags


def _small_resnet(fused_on: bool, k: int, device, lr: float = 0.01):
    """A narrow residual net from the ResNet helpers (BatchNorm in every
    block, a projecting and an identity shortcut) on 12x12x1 images."""
    from tpu_dist_torch.models import layers, resnet
    from tpu_dist_torch.models.model import Sequential

    model = Sequential([*resnet._conv_bn(16, 3),
                        resnet._stage(resnet._basic_block, 16, 2, 2, True),
                        layers.GlobalAveragePooling2D(), layers.Dense(10)],
                       input_shape=(12, 12, 1), name="small_resnet", seed=3)
    model.compile(optimizer=SGD(learning_rate=lr, fused=fused_on),
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=fused_on),
                  steps_per_execution=k, device=device)
    return model


def _small_batches(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 12, 12, 1)).astype(np.float32),
            rng.integers(0, 10, n))


def _params(model) -> list:
    return [p.detach().clone() for p in model.parameters()]


def _variables(model) -> list:
    return [t.detach().clone() for t in (*model.parameters(),
                                         *model.buffers())]


@pytest.mark.gpu
def test_resnet18_fused_fit_equals_unfused_on_the_card(cuda_device,
                                                        deterministic_cudnn):
    # Full-width ResNet-18, one step at a batch of 32: the fused CE and SGD
    # kernels launch, the loss and the BatchNorm update (the same forward)
    # equal the unfused twin's, and the parameters stay within the CE
    # kernel's rounding (~1e-7 of a gradient, times lr). Over many steps a
    # BatchNorm net carries such rounding far (chip_smoke.py phase 22
    # measures that drift against a twin started one ulp off).
    from tpu_dist_torch.models import ResNet18

    x, y = load_arrays("fashion_mnist", synthetic_size=64)
    x = x.astype(np.float32) / 255.0
    out = {}
    for fused_on in (True, False):
        model = ResNet18(input_shape=(28, 28, 1))
        model.compile(optimizer=SGD(learning_rate=0.001, fused=fused_on),
                      loss=SparseCategoricalCrossentropy(from_logits=True,
                                                         fused=fused_on),
                      device=cuda_device)
        fused.fused_ce_fwd.launches = fused.fused_ce_bwd.launches = 0
        fused.fused_sgd_apply.launches = 0
        h = model.fit(Dataset.from_tensor_slices((x, y)).batch(32),
                      epochs=1, steps_per_epoch=1, verbose=0)
        out[fused_on] = (h.history["loss"], _params(model),
                         [b.clone() for b in model.buffers()],
                         (fused.fused_ce_fwd.launches,
                          fused.fused_ce_bwd.launches,
                          fused.fused_sgd_apply.launches))
    assert out[True][3] == (1, 1, 1) and out[False][3] == (0, 0, 0)
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=0,
                               atol=1e-5)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(out[True][2], out[False][2]))
    assert not all(torch.equal(a, b) for a, b in zip(
        out[True][1], ResNet18(input_shape=(28, 28, 1)).to(
            cuda_device).parameters()))


@pytest.mark.gpu
def test_resnet_capture_k2_equals_eager_with_bn_state(cuda_device,
                                                      deterministic_cudnn):
    x, y = _small_batches()
    out = {}
    for k in (1, 2):
        model = _small_resnet(True, k, cuda_device)
        h = model.fit(Dataset.from_tensor_slices((x, y)).batch(32),
                      epochs=2, steps_per_epoch=4, verbose=0)
        out[k] = (h.history["loss"], _variables(model), model)
    assert out[2][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[2][1], out[1][1]))
    # The running statistics moved inside the captured executions.
    model = out[2][2]
    assert not torch.equal(model.batchnormalization.mean,
                           torch.zeros_like(model.batchnormalization.mean))
    (graphed,) = model._trainer._graphed.values()
    ((prog, _),) = graphed.programs.values()
    assert prog.calls == 4 and prog.replays == 3


@pytest.mark.gpu
def test_dropout_masks_differ_across_replays(cuda_device):
    from tpu_dist_torch.models import layers
    from tpu_dist_torch.models.model import Sequential

    model = Sequential([layers.Dense(64, activation="relu"),
                        layers.Dropout(0.5), layers.Dense(3)],
                       input_shape=(16,), name="dropout", seed=0)
    model.compile(optimizer=SGD(learning_rate=0.0),
                  loss=SparseCategoricalCrossentropy(from_logits=True),
                  steps_per_execution=2, device=cuda_device)
    fn, state = model.make_train_function(), model.train_state()
    trainer = model._trainer
    assert trainer._graph_generators() == (trainer.rng,)
    assert trainer.rng.device.type == "cuda"
    rng = np.random.default_rng(0)
    xs = np.stack([rng.standard_normal((32, 16)).astype(np.float32)] * 2)
    ys = np.stack([rng.integers(0, 3, 32)] * 2)
    # lr 0: the weights never move, so a loss changes only with its mask.
    losses = [float(fn(*state, xs, ys)) for _ in range(4)]
    (prog, _), = fn.programs.values()
    assert prog.replays == 3
    assert len(set(losses)) == 4, losses


@pytest.mark.gpu
def test_predict_captures_one_program_for_a_ragged_pass(cuda_device,
                                                        deterministic_cudnn):
    model = _small_resnet(True, 1, cuda_device)
    x, y = _small_batches(80)
    model.fit(Dataset.from_tensor_slices((x, y)).batch(32), epochs=1,
              steps_per_epoch=2, verbose=0)
    batches = [(x[i:i + 32], y[i:i + 32]) for i in range(0, 80, 32)]
    pred = model.predict(batches)
    assert pred.shape == (80, 10) and pred.dtype == np.float32
    ((key, (prog, _)),) = model._trainer._predict_programs.items()
    assert key[0] == "float32"
    assert prog.calls == 3 and prog.replays == 2
    assert model.training is False
    with torch.no_grad():
        for i, (xb, _) in enumerate(batches):
            ref = model(torch.from_numpy(xb).to(cuda_device)).cpu().numpy()
            got = pred[32 * i:32 * i + len(xb)]
            if len(xb) == 32:
                np.testing.assert_array_equal(got, ref)
            else:   # padded to 32 rows: cuDNN may choose otherwise
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_fit_after_set_policy_captures_a_bf16_program(cuda_device):
    import importlib

    tpolicy = importlib.import_module("tpu_dist_torch.models.policy")
    model = _small_resnet(True, 2, cuda_device)
    x, y = _small_batches(128)
    ds = Dataset.from_tensor_slices((x, y)).batch(32)
    seen = []
    model.conv2d.register_forward_hook(
        lambda m, i, o: seen.append(i[0].dtype))
    model.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    model.fit(ds, epochs=1, steps_per_epoch=4, verbose=0)
    before = tpolicy.policy()
    try:
        tpolicy.set_policy("mixed_bfloat16")
        h = model.fit(ds, epochs=1, steps_per_epoch=4, verbose=0)
    finally:
        tpolicy.set_policy(before)
    graphed = model._trainer._graphed
    assert sorted(key[0] for key in graphed) == ["float32", "mixed_bfloat16"]
    for key, g in graphed.items():
        ((prog, _),) = g.programs.values()
        assert prog.calls == 2 and prog.replays == 1, key
    # Hooks fire on eager runs and captures (replays run no Python): the
    # fp32 program's first call and capture (2 steps each), then the bf16
    # program's.
    conv_in, logits = seen[0::2], seen[1::2]
    assert conv_in == [torch.float32] * 4 + [torch.bfloat16] * 4, conv_in
    assert logits == [torch.float32] * 8
    assert np.isfinite(h.history["loss"]).all()
    assert all(b.dtype == torch.float32 for b in model.buffers())


# -- checkpoints, resume, predict over a DeviceDataset ------------------------

@pytest.mark.gpu
def test_predict_over_a_cuda_device_dataset_equals_the_host_chain(
        cuda_device, deterministic_cudnn):
    # F3: a DeviceDataset's batches are CUDA tensors; predict takes them on
    # the card (np.asarray on them raised) and equals predict over the
    # same batches from the host.
    from tpu_dist_torch.data.device import DeviceDataset

    model = _small_resnet(True, 1, cuda_device)
    x, y = _small_batches(96)
    ds = DeviceDataset(x, y, global_batch_size=32, shuffle=False, scale=1.0,
                       device=cuda_device)
    got = model.predict(ds)
    want = model.predict([(x[i:i + 32], y[i:i + 32])
                          for i in range(0, 96, 32)])
    assert got.shape == (96, 10) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    one = model.predict(torch.from_numpy(x[:32]).to(cuda_device))
    np.testing.assert_array_equal(one, want[:32])


@pytest.mark.gpu
def test_restore_onto_cuda_tensors_keeps_programs_and_leaf_tables(
        cuda_device, deterministic_cudnn, tmp_path):
    from tpu_dist_torch.models import bridge
    from tpu_dist_torch.training import checkpoint

    model = _small_resnet(True, 2, cuda_device)
    model.compile(optimizer=SGD(learning_rate=0.01, momentum=0.9, fused=True),
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=True),
                  steps_per_execution=2, device=cuda_device)
    trainer = model._get_trainer("")
    x, y = _small_batches(128)
    ds = Dataset.from_tensor_slices((x, y)).batch(32)
    model.fit(ds, epochs=1, steps_per_epoch=4, verbose=0)
    checkpoint.save(tmp_path, model, step=0)
    saved = dict(np.load(tmp_path / "ckpt-0" / "arrays.npz"))
    model.fit(ds, epochs=1, steps_per_epoch=4, verbose=0)
    (graphed,) = trainer._graphed.values()
    ((prog, _),) = graphed.programs.values()
    builds, captured = model.optimizer._tables.builds, prog.capture_s
    live = bridge.checkpoint_tensors(model, trainer.variables["opt"])
    held = {k: (id(t), t.data_ptr()) for k, t in live.items()}
    assert checkpoint.restore_model(tmp_path, model) == 0
    for k, t in live.items():
        assert t.is_cuda
        np.testing.assert_array_equal(t.detach().cpu().numpy(), saved[k])
    model.fit(ds, epochs=1, steps_per_epoch=4, verbose=0)
    after = bridge.checkpoint_tensors(model, trainer.variables["opt"])
    assert {k: (id(t), t.data_ptr()) for k, t in after.items()} == held
    ((prog2, _),) = graphed.programs.values()
    assert prog2 is prog and prog.capture_s == captured and prog.replays >= 4
    assert model.optimizer._tables.builds == builds == 1


@pytest.mark.gpu
def test_resumed_fit_with_dropout_on_graphs_equals_the_uninterrupted_fit(
        cuda_device, tmp_path):
    # Each epoch reseeds the trainer's generator from (seed, epoch); the
    # captured programs read its seed and offset at replay, so a resumed
    # fit (whose first execution runs eagerly) draws what the uninterrupted
    # one's replays draw.
    from tpu_dist_torch.models import layers
    from tpu_dist_torch.models.model import Sequential

    def make():
        model = Sequential([layers.Dense(64, activation="relu"),
                            layers.Dropout(0.5), layers.Dense(3)],
                           input_shape=(16,), name="dropout", seed=0)
        model.compile(optimizer=Adam(0.01, fused=True),
                      loss=SparseCategoricalCrossentropy(from_logits=True),
                      steps_per_execution=2, device=cuda_device)
        return model

    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 16)).astype(np.float32)
    y = rng.integers(0, 3, 128)
    data = lambda: Dataset.from_tensor_slices((x, y)).batch(32)
    straight = make()
    hs = straight.fit(data(), epochs=3, verbose=0, seed=4).history
    make().fit(data(), epochs=2, verbose=0, seed=4,
               checkpoint_dir=str(tmp_path))
    resumed = make()
    h = resumed.fit(data(), epochs=3, verbose=0, seed=4,
                    checkpoint_dir=str(tmp_path)).history
    assert h["loss"] == hs["loss"][2:]
    assert all(torch.equal(a, b) for a, b in zip(resumed.parameters(),
                                                 straight.parameters()))


@pytest.mark.gpu
def test_async_snapshot_holds_its_steps_values(cuda_device, tmp_path):
    # The snapshot clones on the compute stream: a step queued after
    # save_async changes the parameters in place, not the checkpoint.
    from tpu_dist_torch.training import AsyncCheckpointer

    model = build_transformer_lm(64, 32, d_model=64, depth=2, num_heads=2)
    model.compile(optimizer=Adam(0.01, fused=True),
                  loss=SparseCategoricalCrossentropy(from_logits=True),
                  device=cuda_device)
    want = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    with AsyncCheckpointer(tmp_path) as ckpt:
        ckpt.save_async(model, step=0)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    saved = np.load(tmp_path / "ckpt-0" / "arrays.npz")
    for n, value in want.items():
        key = "['params']" + "".join(f"[{part!r}]" for part in n.split("."))
        np.testing.assert_array_equal(saved[key], value.numpy(), err_msg=n)


@pytest.mark.gpu
def test_profiler_records_cuda_kernels_and_captures_inside_a_trace(
        cuda_device, tmp_path):
    # fit(profile_dir=) at k = 2: the second execution captures a CUDA
    # graph inside the trace and the later ones replay it; the losses and
    # the parameters equal an untraced fit's, and the trace holds the
    # card's kernels.
    import json

    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 16)).astype(np.float32)
    y = rng.integers(0, 3, 128)
    runs = []
    for profile_dir in (None, tmp_path / "p"):
        from tpu_dist_torch.models.layers import Dense
        from tpu_dist_torch.models.model import Sequential

        model = Sequential([Dense(32, activation="relu"), Dense(3)],
                           input_shape=(16,))
        model.compile(optimizer=SGD(0.1, fused=True),
                      loss=SparseCategoricalCrossentropy(from_logits=True),
                      steps_per_execution=2, device=cuda_device)
        h = model.fit(Dataset.from_tensor_slices((x, y)).batch(16),
                      epochs=2, verbose=0, profile_dir=profile_dir).history
        (graphed,) = model._trainer._graphed.values()
        (prog, _), = graphed.programs.values()
        assert prog.replays >= 1
        runs.append((h["loss"], [p.detach().clone()
                                 for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    (trace,) = (tmp_path / "p").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert any("sgd" in e["name"].lower() for e in kernels), \
        sorted({e["name"] for e in kernels})[:20]


@pytest.mark.gpu
def test_bucketed_all_reduce_on_cuda_tensors_at_world_size_one(cuda_device):
    from tpu_dist_torch.parallel import collectives

    tree = {"w": torch.randn(7, 5, device=cuda_device),
            "b": [torch.randn(3, device=cuda_device, dtype=torch.float64)]}
    want = [t.clone() for t in collectives.tree_leaves(tree)]
    before = collectives.bucketed_all_reduce.launches
    assert collectives.bucketed_all_reduce(tree, "mean",
                                           bucket_bytes=16) is tree
    assert collectives.bucketed_all_reduce.launches == before
    assert all(torch.equal(a, b) for a, b in
               zip(collectives.tree_leaves(tree), want))
    stacked = collectives.all_gather(tree["w"])
    assert stacked.device.type == "cuda" and stacked.shape == (1, 7, 5)


@pytest.mark.gpu
def test_two_ring_workers_reduce_cuda_tensors_on_one_card(cuda_device,
                                                          tmp_path):
    # CollectiveCommunication.RING is gloo: two processes share the card
    # and reduce, gather and broadcast CUDA tensors.
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from tpu_dist_torch.cluster import make_local_cluster

    script = tmp_path / "worker.py"
    script.write_text('''
import json
import torch
import tpu_dist_torch as td
from tpu_dist_torch.parallel import collectives as c

strategy = td.MultiWorkerMirroredStrategy(communication="ring")
rank = td.cluster.process_index()
t = {"a": torch.full((5,), rank + 1.0, device="cuda"),
     "b": torch.full((3,), rank + 1.0, device="cuda", dtype=torch.float64)}
c.bucketed_all_reduce(t, "mean", bucket_bytes=8)
g = c.all_gather(torch.tensor([rank], device="cuda"))
p = c.broadcast_from_chief([torch.full((2,), rank + 7.0, device="cuda")])
print(json.dumps({"rank": rank, "device": str(strategy.device),
                  "a": t["a"].tolist(), "b": t["b"].tolist(),
                  "g": g.tolist(), "p": p[0].tolist(),
                  "host": int(c.host_all_reduce_sum(rank + 1))}))
''')
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen(
        [sys.executable, str(script)], cwd=tmp_path, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, TF_CONFIG=json.dumps(cfg), PYTHONPATH=str(root)))
        for cfg in make_local_cluster(2, base_port=port)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, o in enumerate(outs):
        assert o["rank"] == rank and o["device"] == "cuda:0"
        assert o["a"] == [1.5] * 5 and o["b"] == [1.5] * 3
        assert o["g"] == [[0], [1]] and o["p"] == [7.0, 7.0]
        assert o["host"] == 3


_RESILIENT_KINDS = {"contiguous": {},
                    "int8_ragged": dict(paged=True, page_size=16,
                                        kv_dtype="int8", ragged=True)}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(_RESILIENT_KINDS))
def test_journal_recovery_on_the_card_under_the_tie_rule(cuda_device,
                                                         tmp_path, kind):
    """An engine abandoned mid-run with its unflushed journal tail lost,
    then a second one recovering from the journal: every request finishes
    and each stream equals the uninterrupted one, or leaves it only at a
    certified tie of the full forward (recovery batches requests in other
    buckets and re-prefills the replayed ones). The contiguous engines'
    flash forward launches equal depth x the prefills, re-prefills
    included."""
    from tpu_dist_torch.observe import metrics
    from tpu_dist_torch.serve import chaos, journal

    kw = _RESILIENT_KINDS[kind]
    model = build_transformer_lm(64, 128, d_model=64, depth=2, num_heads=2)
    rng = np.random.default_rng(3)
    specs = [(rng.integers(0, 64, size=int(rng.integers(3, 40))).tolist(),
              int(rng.integers(4, 12))) for _ in range(8)]
    base = ServeEngine(model, max_batch=4, max_len=128, **kw)
    want = [base.submit(p, max_new_tokens=m) for p, m in specs]
    base.run_until_idle()
    metrics.get_registry().reset()
    metrics.enable()
    try:
        fa.flash_attention_fwd.launches = 0
        first = ServeEngine(model, max_batch=4, max_len=128,
                            journal=tmp_path / "j", **kw)
        for p, m in specs:
            first.submit(p, max_new_tokens=m)
        for _ in range(4):
            first.step()
        first.journal._buf.clear()
        del first
        second = ServeEngine(model, max_batch=4, max_len=128,
                             journal=tmp_path / "j", **kw)
        assert second.last_replay["active"]
        second.run_until_idle()
        second.close()
        prefills = metrics.get_registry().counter("serve.prefills").value
    finally:
        metrics.disable()
    state = journal.load(tmp_path / "j" / journal.JOURNAL_NAME)
    ties = 0
    for r in want:
        jr = state.requests[r.rid]
        assert jr.finished and len(jr.tokens) == len(r.generated)
        if jr.tokens != r.generated:
            assert chaos._certified_tie(model, cuda_device, r.prompt,
                                        r.generated, jr.tokens) is not None
            ties += 1
    assert ties <= 1
    assert prefills > len(specs)   # the replayed requests re-prefilled
    assert fa.flash_attention_fwd.launches == (
        0 if kw else 2 * prefills)


@pytest.mark.gpu
def test_stall_watchdog_fires_around_a_captured_decode_replay(cuda_device):
    """The watchdog's window spans a decode step that replays its captured
    graph: a stall injected between the replay and the host read of the
    logits trips the (injected) stall action once, with the step's bucket;
    healthy eager, capturing and replaying steps do not."""
    tripped, seen = [], []
    engine = None

    class StallOnReplay:
        def on_decode(self):
            prog = engine.programs.get(("decode", 1))
            if prog is not None and prog.replays == 2 and not seen:
                seen.append(prog.replays)
                time.sleep(3.0)

        def on_step_end(self, done_count):
            pass

    model = build_transformer_lm(64, 128, d_model=64, depth=2, num_heads=2)
    engine = ServeEngine(model, max_batch=1, max_len=128,
                         stall_timeout_s=2.0, stall_action=tripped.append,
                         fault_injector=StallOnReplay())
    req = engine.submit([5, 6, 7], max_new_tokens=8)
    engine.run_until_idle()
    assert req.status == "done" and len(req.generated) == 8
    assert seen == [2]
    assert tripped == [{"timeout_s": 2.0, "bucket": 1, "active": 1}]
    assert engine.programs[("decode", 1)].graph is not None


@pytest.mark.gpu
def test_launch_counts_stay_exact_across_a_concurrent_capture(cuda_device):
    """One thread captures a program that launches the forward kernel and
    holds its capture open while another thread launches the kernel
    eagerly: every eager launch stays counted, and each replay adds the
    capture's launches."""
    import threading

    from tpu_dist_torch.utils.graphs import CapturedProgram

    q, k, v = _fwd_inputs((1, 2, 64, 64), torch.float32, cuda_device, 7)
    inside, release = threading.Event(), threading.Event()

    def fn(x):
        out = fa.flash_attention_fwd(x, k, v, causal=True, scale=0.125)[0]
        if not inside.is_set() and torch.cuda.is_current_stream_capturing():
            inside.set()
            assert release.wait(60.0)
        return out

    prog = CapturedProgram(fn, {"x": ((1, 2, 64, 64), torch.float32)},
                           device=cuda_device)
    fa.flash_attention_fwd.launches = 0
    prog(x=q)                                   # eager: 1 launch
    capturer = threading.Thread(target=prog, kwargs={"x": q})
    capturer.start()                            # capture, then 1 replay
    assert inside.wait(60.0)
    eager = [fa.flash_attention_fwd(q, k, v, causal=True, scale=0.125)[0]
             for _ in range(5)]
    # This stream's work only: a device-wide synchronize would wait on the
    # capturing stream and invalidate its capture.
    torch.cuda.current_stream().synchronize()
    release.set()
    capturer.join(60.0)
    assert not capturer.is_alive() and prog.graph is not None
    for _ in range(3):
        out = prog(x=q)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == 1 + 5 + 1 + 3
    torch.testing.assert_close(out, eager[0], atol=0, rtol=0)


@pytest.mark.gpu
def test_a_fleet_of_two_replicas_fails_over_on_the_card(cuda_device,
                                                        tmp_path):
    """Two replicas of a tiny LM share the card, each capturing its own
    programs on its own thread; a kill fails over onto the survivor. The
    streams equal a solo engine's (greedy, certified ties aside: none at
    these margins), the forward kernel launched depth x prefills over the
    solo run and both replicas, and each replica replayed its graphs."""
    from tpu_dist_torch.observe import metrics
    from tpu_dist_torch.resilience.faults import FaultPlan
    from tpu_dist_torch.serve.fleet import ServeFleet

    model = build_transformer_lm(64, 64, d_model=64, depth=2, num_heads=2,
                                 seed=0)

    def engine(**kw):
        return ServeEngine(model, max_batch=4, max_len=64, seed=0,
                           device=cuda_device, **kw)

    rng = np.random.default_rng(0)
    prefixes = [rng.integers(0, 64, size=16).tolist() for _ in range(2)]
    work = [(prefixes[i % 2] + rng.integers(0, 64, size=3 + i).tolist(),
             4 + i % 3) for i in range(8)]
    metrics.get_registry().reset()
    metrics.enable()
    try:
        fa.flash_attention_fwd.launches = 0
        solo = engine()
        reqs = [solo.submit(p, max_new_tokens=n) for p, n in work]
        solo.run_until_idle()
        want = [list(r.generated) for r in reqs]
        fleet = ServeFleet(
            lambda i, *, journal, fault_injector: engine(
                journal=journal, fault_injector=fault_injector),
            replicas=2, page_size=16, journal_root=str(tmp_path),
            plan=FaultPlan.parse("replica_kill@req1:replica0"))
        fleet.start()
        frs = [fleet.submit(p, max_new_tokens=n) for p, n in work]
        fleet.drain(timeout_s=120.0)
        fleet.close()
        torch.cuda.synchronize()
        prefills = metrics.get_registry().snapshot()["counters"][
            "serve.prefills"]
    finally:
        metrics.disable()
    assert [fr.tokens for fr in frs] == want
    assert [(d["replica"], d["killed"]) for d in fleet.deaths] == [(0, True)]
    assert fleet.failover_replayed >= 1
    assert fa.flash_attention_fwd.launches == 2 * prefills
    stats = fleet.graph_stats()
    assert all(s["captured"] > 0 and s["replays"] > 0
               for s in stats.values())


@pytest.mark.gpu
def test_step_timer_puts_a_device_bound_step_in_device_time(cuda_device):
    """A step of wide fp32 matmuls keeps the card far longer than the host
    takes to launch it. The timer's blocking wait on each execution's end
    puts that time in device_block_s, not in dispatch_s, and each
    execution's split sums to its total."""
    from tpu_dist_torch.models import Dense, Sequential
    from tpu_dist_torch.observe.metrics import MetricsRegistry
    from tpu_dist_torch.observe.telemetry import Telemetry

    # ~0.8 TFLOP a step of fp32 matmuls: tens of ms on the card.
    model = Sequential([Dense(8192, activation="relu"),
                        Dense(8192, activation="relu"), Dense(10)],
                       input_shape=(256,))
    model.compile(loss=SparseCategoricalCrossentropy(from_logits=True),
                  optimizer=SGD(learning_rate=0.01), device=cuda_device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6 * 2048, 256), dtype=np.float32)
    y = rng.integers(0, 10, size=len(x)).astype(np.int32)
    reg = MetricsRegistry(enabled=False)
    model.fit(Dataset.from_tensor_slices((x, y)).batch(2048), epochs=1,
              verbose=0, callbacks=[Telemetry(registry=reg)])
    d = reg.snapshot()["distributions"]
    assert reg.snapshot()["counters"]["step.count"] == 6
    assert d["step.device_block_s"]["p50"] > 2 * d["step.dispatch_s"]["p50"]
    assert d["step.device_block_s"]["sum"] > d["step.dispatch_s"]["sum"]
    parts = sum(d[f"step.{p}_s"]["sum"]
                for p in ("data_wait", "dispatch", "device_block"))
    assert parts == pytest.approx(d["step.total_s"]["sum"], rel=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pipeline", "moe"])
def test_pipelined_and_moe_lms_launch_the_kernels_and_equal_the_cpu(
        cuda_device, kind):
    # One process: the stacked stages run in sequence, the experts locally;
    # each block's attention launches the flash pair, the loss the fused CE,
    # the update fused Adam. Losses agree with the CPU plain-path run to
    # 1e-4 (fp32 on both sides, sums in another order).
    kw = ({"pipeline_stages": 2, "pipeline_microbatches": 2}
          if kind == "pipeline" else {"moe_experts": 4, "moe_groups": 4})

    def make(device):
        model = build_transformer_lm(64, 64, d_model=64, depth=2,
                                     num_heads=2, seed=3, **kw)
        model.compile(optimizer=Adam(learning_rate=1e-3, fused=True),
                      loss=SparseCategoricalCrossentropy(from_logits=True,
                                                         fused=True),
                      device=device)
        return model

    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, size=(4, 64))
    y = np.roll(x, -1, axis=1)
    losses = {}
    counted = ((fa, "flash_attention_fwd"), (fa, "flash_attention_bwd"),
               (fused, "fused_adam_apply"), (fused, "fused_ce_fwd"),
               (fused, "fused_ce_bwd"))
    for device in ("cpu", cuda_device):
        model = make(device)
        fn, state = model.make_train_function(), model.train_state()
        for mod, name in counted:
            getattr(mod, name).launches = 0
        losses[str(device)] = [float(fn(*state, x, y)) for _ in range(3)]
        launches = tuple(getattr(mod, name).launches for mod, name in counted)
        assert launches == ((0,) * 5 if device == "cpu"
                            else (6, 6, 3, 3, 3)), launches
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-4)


# -- the integrity guard on the card (training/integrity.py) --------------------

def _guard_lm(k, fused_ce, device):
    model = build_transformer_lm(64, 16, d_model=64, depth=2, num_heads=2,
                                 seed=0)
    model.compile(optimizer=Adam(fused=True),
                  loss=SparseCategoricalCrossentropy(from_logits=True,
                                                     fused=fused_ce),
                  steps_per_execution=k, device=device)
    return model


def _guard_fit(model, tmp_path=None):
    stream = (np.arange(32 * 16 + 1) * 2654435761) % 64
    x = stream[:-1].reshape(32, 16).astype(np.int64)
    y = stream[1:].reshape(32, 16).astype(np.int64)
    h = model.fit(Dataset.from_tensor_slices((x, y)).batch(8), epochs=2,
                  verbose=0, checkpoint_dir=None if tmp_path is None
                  else str(tmp_path))
    torch.cuda.synchronize()
    return h.history["loss"], [p.detach().clone() for p in model.parameters()]


@pytest.mark.gpu
def test_armed_step_health_matches_its_plain_version_on_the_card(
        cuda_device):
    """The armed step's health vector (a copy before the fused Adam's
    in-place update, then ``old − new`` and the gradients reduced on the
    card) against ``health_summary`` of the same step's trees."""
    from tpu_dist_torch.training import integrity

    model = _guard_lm(1, True, cuda_device)
    tr = model._get_trainer("optimizer loss")
    tr.ensure_variables()
    v = tr.variables
    step = tr._step(None, None, integrity.StepHealth(v["params"]))
    x = torch.randint(0, 64, (8, 16), device=cuda_device)
    for _ in range(3):
        before = [p.detach().clone() for p in v["params"]]
        loss, h = step(v["params"], v["state"], v["opt"], v["metrics"],
                       tr._init_loss_acc(), x, x)
        want = integrity.health_summary(
            loss, [p.grad for p in v["params"]], before, v["params"])
        assert h.is_cuda and float(h[0]) == float(want[0]) == 0.0
        torch.testing.assert_close(h[1:], want[1:], rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
def test_an_armed_fit_adds_no_synchronize_and_changes_nothing(
        cuda_device, monkeypatch, k):
    """The armed fit reads each health vector one execution behind through
    an event, never a device or stream synchronize: it makes the unarmed
    fit's synchronizes (a k-step program's capture) and no more, and
    trains to the same bits with the same launches."""
    syncs = []
    plain_sync, plain_stream_sync = torch.cuda.synchronize, \
        torch.cuda.Stream.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: (syncs.append(1), plain_sync(*a))[1])
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        lambda self: (syncs.append(1),
                                      plain_stream_sync(self))[1])
    runs = {}
    for armed in (False, True):
        if armed:
            monkeypatch.setenv("TPU_DIST_INTEGRITY", "1")
        model = _guard_lm(k, True, cuda_device)
        fa.flash_attention_fwd.launches = fused.fused_adam_apply.launches = 0
        syncs.clear()
        out = _guard_fit(model)
        runs[armed] = (out, len(syncs) - 1,  # _guard_fit's own
                       (fa.flash_attention_fwd.launches,
                        fused.fused_adam_apply.launches))
    (loss_off, params_off), syncs_off, counts_off = runs[False]
    (loss_on, params_on), syncs_on, counts_on = runs[True]
    assert syncs_on == syncs_off
    assert loss_on == loss_off and counts_on == counts_off == (16, 8)
    assert all(torch.equal(a, b) for a, b in zip(params_on, params_off))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
def test_a_rolled_back_fit_equals_the_clean_fit_bit_for_bit(
        cuda_device, monkeypatch, tmp_path, k):
    """``nan_loss`` at step 5 (a token batch's labels out of range: the
    plain CE's NaN): one rollback to epoch 0's checkpoint, and the replayed
    epoch, on graphs at k = 2, ends on the clean fit's bits."""
    from tpu_dist_torch.resilience import read_events

    clean = _guard_fit(_guard_lm(k, False, cuda_device), tmp_path / "clean")
    monkeypatch.setenv("TPU_DIST_INTEGRITY", "1")
    monkeypatch.setenv("TPU_DIST_FAULT_PLAN", "nan_loss@step5")
    monkeypatch.setenv("TPU_DIST_EVENT_LOG", str(tmp_path / "events.jsonl"))
    chaos = _guard_fit(_guard_lm(k, False, cuda_device), tmp_path / "chaos")
    (rb,) = read_events(tmp_path / "events.jsonl", "integrity_rollback")
    assert rb["restored_step"] == 0 and rb["next_epoch"] == 1
    assert chaos[0] == clean[0]
    assert all(torch.equal(a, b) for a, b in zip(chaos[1], clean[1]))


# -- elasticity on the card (item 18b) ------------------------------------------------

_ELASTIC_WORKER = '''
import json, os, sys
import numpy as np
import torch
import tpu_dist_torch as td
from tpu_dist_torch.cluster import bootstrap
from tpu_dist_torch.models.transformer import build_transformer_lm
from tpu_dist_torch.ops import fused
from tpu_dist_torch.ops.losses import SparseCategoricalCrossentropy
from tpu_dist_torch.ops.optimizers import Adam
from tpu_dist_torch.training import checkpoint
from tpu_dist_torch.training.callbacks import ModelCheckpoint

strategy = td.MultiWorkerMirroredStrategy(
    communication="ring", axis_shapes={"data": 1, "model": 2})
rank = bootstrap.process_index()
with strategy.scope():
    model = build_transformer_lm(64, 16, d_model=64, depth=2, num_heads=2,
                                 seed=0)
    model.compile(optimizer=Adam(fused=True), loss=
                  SparseCategoricalCrossentropy(from_logits=True,
                                                fused=True))
stream = (np.arange(16 * 16 + 1) * 2654435761) % 64
x = stream[:-1].reshape(16, 16).astype(np.int64)
y = stream[1:].reshape(16, 16).astype(np.int64)
fused.fused_adam_apply.launches = 0
model.fit(td.data.Dataset.from_tensor_slices((x, y)).batch(8), epochs=2,
          verbose=0, callbacks=[ModelCheckpoint("v2", sharded=True),
                                ModelCheckpoint("v1", async_save=False)])
out = {"adam": fused.fused_adam_apply.launches}
dev = bootstrap.group_device()
a = torch.full((3,), float(rank + 1), device=dev)
torch.distributed.all_reduce(a)
out["generation"] = bootstrap.reinitialize()
b = torch.full((3,), float(rank + 1), device=dev)
torch.distributed.all_reduce(b)
out.update(before=a.tolist(), after=b.tolist(), reinit=bootstrap.last_reinit)
print(json.dumps(out))
'''


def _two_card_workers(tmp_path, script):
    import json
    import os
    import pathlib
    import socket
    import subprocess
    import sys

    from tpu_dist_torch.cluster import make_local_cluster

    root = pathlib.Path(__file__).resolve().parents[1]
    (tmp_path / "worker.py").write_text(script)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "worker.py"], cwd=tmp_path, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, TF_CONFIG=json.dumps(cfg), PYTHONPATH=str(root)))
        for cfg in make_local_cluster(2, base_port=port)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


@pytest.mark.gpu
def test_sharded_checkpoint_and_reinitialize_on_two_gloo_ranks_of_the_card(
        cuda_device, tmp_path):
    # Two ranks under {model: 2} on one card (gloo on CUDA tensors): the
    # v2 step's stitched leaves equal the gathered v1 step's bit for bit,
    # one process resumes either to the same bytes, and the group
    # re-dials on the next port with an all-reduce before and after.
    from tpu_dist_torch.models import bridge
    from tpu_dist_torch.training import checkpoint

    outs = _two_card_workers(tmp_path, _ELASTIC_WORKER)
    for out in outs:
        assert out["adam"] == 4 and out["generation"] == 1
        assert out["before"] == out["after"] == [3.0] * 3
        assert out["reinit"]["teardown_s"] < 5.0
    assert len({out["reinit"]["port"] for out in outs}) == 1
    with np.load(tmp_path / "v1" / "ckpt-1" / "arrays.npz") as z:
        v1 = {k: z[k] for k in z.files}
    leaves = dict(checkpoint._iter_sharded_leaves(tmp_path / "v2" / "ckpt-1"))
    assert set(leaves) == set(v1)
    for key, assemble in leaves.items():
        assert assemble().tobytes() == v1[key].tobytes(), key
    got = []
    for d in ("v2", "v1"):
        model = build_transformer_lm(64, 16, d_model=64, depth=2,
                                     num_heads=2, seed=5)
        model.compile(optimizer=Adam(fused=True), loss=
                      SparseCategoricalCrossentropy(from_logits=True,
                                                    fused=True),
                      device=cuda_device)
        assert checkpoint.restore_model(tmp_path / d, model) == 1
        got.append({k: t.detach().cpu().numpy() for k, t in
                    bridge.checkpoint_tensors(
                        model, model._trainer.variables["opt"]).items()})
    for key in v1:
        assert got[0][key].tobytes() == got[1][key].tobytes() \
            == v1[key].tobytes(), key


def _small_lm(optimizer, device):
    model = build_transformer_lm(64, 64, d_model=64, depth=1, num_heads=2,
                                 seed=0)
    model.compile(optimizer=optimizer,
                  loss=SparseCategoricalCrossentropy(from_logits=True),
                  device=device)
    return model


@pytest.mark.gpu
def test_ps_server_applies_through_fused_adam_as_its_plain_version(
        cuda_device, tmp_path):
    """A PSServer on the card applies pushed packets through the fused
    Adam kernel (one launch an apply), and ends where Adam(fused=False)
    applying the same gradients does (the same arithmetic in the same
    order: rtol 1e-6, as chip_smoke.py's phase 8)."""
    from tpu_dist_torch.cluster.ps_transport import PSDir
    from tpu_dist_torch.models.bridge import keypath
    from tpu_dist_torch.parallel.ps_strategy import PSServer

    model = _small_lm(Adam(learning_rate=1e-2, fused=True), cuda_device)
    twin = _small_lm(Adam(learning_rate=1e-2, fused=False), cuda_device)
    psdir = PSDir(tmp_path / "ps").ensure()
    rng = np.random.default_rng(0)
    packets = []
    for seq in range(3):
        grads = {keypath(n): rng.standard_normal(tuple(p.shape)).astype(
            np.float32) for n, p in model.named_parameters()}
        psdir.push_grad(grads, rank=0, seq=seq, meta={"base_version": 0})
        packets.append(grads)
    before = fused.fused_adam_apply.launches
    stats = PSServer(model, psdir, num_workers=1, budget=3, seed=0).run()
    assert stats["applies"] == 3
    assert fused.fused_adam_apply.launches - before == 3
    params = list(twin.parameters())
    opt = twin.optimizer.init(params)
    with torch.no_grad():
        for grads in packets:
            twin.optimizer.update(
                [torch.from_numpy(grads[keypath(n)]).to(cuda_device)
                 for n, _ in twin.named_parameters()], opt, params)
    for (name, p), q in zip(model.named_parameters(), params):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=name)


@pytest.mark.gpu
def test_a_job_scoped_engine_keeps_its_captured_programs_in_the_runtime(
        cuda_device):
    """Under a job scope the engine serves on the job's slot and its
    captured programs live in the MeshRuntime's cache, keyed by the job;
    its streams are a solo engine's, which leaves the runtime alone."""
    from tpu_dist_torch.jobs import JobSpec, MeshRuntime, job_scope

    model = build_transformer_lm(64, 64, d_model=64, depth=1, num_heads=2,
                                 seed=0)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]

    def serve(engine):
        outs = []
        for _ in range(2):   # the second pass replays the captures
            reqs = [engine.submit(p, max_new_tokens=6) for p in prompts]
            engine.run_until_idle()
            outs.append([r.generated for r in reqs])
        engine.close()
        return outs

    runtime = MeshRuntime([cuda_device])
    with job_scope(runtime, JobSpec(name="serve-a", kind="serve")) as ctx:
        engine = ServeEngine(model, max_batch=2, max_len=64)
        assert engine.device == ctx.strategy.device
        scoped = serve(engine)
    keys = runtime.program_keys()
    assert keys and {k[0] for k in keys} == {"serve-a"}
    assert {(k[3], k[4]) for k in keys} == set(engine.programs)
    assert sum(p.graph is not None for p in engine.programs.values()) > 0
    solo = serve(ServeEngine(model, max_batch=2, max_len=64))
    assert runtime.program_keys() == keys
    assert scoped == solo
