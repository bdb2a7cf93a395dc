#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dist_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Drives the port's serving and training paths end to end on the card and
holds every kernel on them against its plain PyTorch version. Phases:

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi``); turn TF32 off for matmuls and cuDNN;
2. build: compile the kernels from the checkout's sources (one ``nvcc``
   per source, all at once), printing ptxas registers and spills;
3. kernel vs plain version on the card, fp32 and bf16 inputs, causal and
   not: O and lse against the plain version in fp32 at atol = rtol = 1e-4
   (the summation order and ``exp`` differ), a bf16 O at rtol 2**-8 (half
   a bf16 ulp) plus atol 1e-4;
4. serve the benchmark LM at full width (vocab 8192, d_model 512, depth 4,
   8 heads, 512 positions, fp32, random weights from seed 0): 16 seeded
   requests through ``ServeEngine``; every request must finish, the flash
   kernel must have launched ``depth x prefills`` times, each prefill's
   logits must match a re-run with the plain attention (atol 1e-3), and
   every generated token must be the full forward's greedy choice (a
   top-2 gap under 1e-4 counts as a certified tie);
5. the CLI (``python -m tpu_dist_torch.serve --bench``) at full width;
   its flash launches must be ``depth x`` the prefills it counted;
6. times at the serving shape [8, 512, 64] fp32 causal: kernel, plain
   version and ``F.scaled_dot_product_attention`` (a yardstick only, never
   used by the port), beside the kernel's lower bound;
7. backward kernels vs their plain version: dQ, dK, dV for L in {77, 128,
   200, 512, 1024} (512 is the TPU's one-tile case), D in {32, 64, 128},
   fp32 and bf16, causal and not (tolerances at ``assert_grads_close``);
8. fused Adam vs its plain version over the full-width LM's 21.3 M
   parameters for 3 steps (rtol 1e-6: the same arithmetic in the same
   order);
9. train the benchmark LM at full width through ``make_train_function`` /
   ``train_state`` (``bench.py:63-68``, ``:101-106``, ``:120``: batch 64,
   L 512, SGD lr 0.001, the bench token stream), 3 steps: flash forward
   and backward launches must be depth x steps, every loss must match a
   twin with the same initial weights and the plain attention
   (``_dense_attention``) within ``LOSS_ATOL``, and the parameters must
   move, each leaf within ``PARAM_RTOL`` of its step plus ``PARAM_ATOL``
   of the twin's (SGD); then the same with ``Adam(fused=True)``, whose
   launches must be the steps, against a twin on ``Adam(fused=False)``;
10. ``Model.fit((x, y), epochs=1, steps_per_epoch=4, verbose=0)`` at full
    width: a finite History loss and depth x 4 launches of each flash
    kernel;
11. at the training shape [64, 8, 512, 64] fp32 causal, the forward and
    backward kernels against their plain versions on the same inputs (the
    errors the kernel line reports); then times at the training shapes,
    each beside its bound: the backward there (kernels, plain version,
    SDPA's backward as fwd+bwd minus fwd), fused Adam over the 21.3 M
    parameters (kernel, plain version,
    ``torch.optim.Adam(fused=True).step()``), and the full training step
    in ms and tokens/s. Library calls are yardsticks only, never used by
    the port.

Prints one JSON line of kernel records, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpu_dist_torch.models.transformer import (MultiHeadAttention,
                                               _dense_attention,
                                               build_transformer_lm)
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.ops import _build
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import fused
from tpu_dist_torch.ops.losses import SparseCategoricalCrossentropy
from tpu_dist_torch.ops.metrics import SparseCategoricalAccuracy
from tpu_dist_torch.ops.optimizers import SGD, Adam
from tpu_dist_torch.serve import cli, kv_cache
from tpu_dist_torch.serve.engine import ServeEngine, _pad_to_pow2
from tpu_dist_torch.serve.scheduler import DONE

#: bench.py's TRANSFORMER_LM at its 512-token sequence length.
LM = dict(vocab_size=8192, seq_len=512, d_model=512, depth=4, num_heads=8)
#: bench.py:63's transformer_lm global batch.
TRAIN_BATCH = 64
TRAIN_STEPS = 3
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "fused_adam.cu")

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense fp32 (CUDA-core,
#: no tensor cores) peak, both at the 700 W power limit. The kernel does
#: its arithmetic in fp32 on the CUDA cores, so fp32 is its peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

TIE_GAP = 1e-4
#: Kernel vs plain version: fp32 arithmetic on both sides, different
#: summation order and exp.
FP32_TOL = 1e-4
#: A bf16 output rounded to nearest is within half a bf16 ulp of its fp32
#: value: 2**-8 of its magnitude (8 significant bits).
BF16_RTOL = 2.0 ** -8
#: Train step vs the plain-attention twin: losses near ln(8192) = 9.01,
#: where one fp32 ulp is 2**-20 = 9.5e-7, and the two attentions agree to
#: ~1e-6 — 1e-5 is about ten ulps of the loss.
LOSS_ATOL = 1e-5
#: SGD parameters vs the twin's after the 3 steps, leaf by leaf: within
#: PARAM_RTOL of the leaf's own step plus PARAM_ATOL. Measured on an H100:
#: the gaps are at most one fp32 ulp of the weights (2**-27 = 7.5e-9 for
#: |w| < 0.125), where p - lr g rounds the other way, and at most 2.4 % of
#: a leaf's step (the attention projections step by 1.3e-7 to 2.3e-6). A
#: backward that dropped dQ, dK or dV would leave wq, wk or wv where it
#: was: a gap of its whole step.
PARAM_RTOL = 0.05
PARAM_ATOL = 1e-8


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        "TF32 off for matmul and cuDNN")
    return card


def build_phase() -> None:
    t0 = time.monotonic()
    _build.build(SOURCES)
    for source in SOURCES:
        _build.load(source)
    log(f"[2 build] {', '.join(SOURCES)} ready in "
        f"{time.monotonic() - t0:.2f} s (built in parallel)")
    for source in SOURCES:
        info = _build.build_info.get(source, {})
        log(f"[2 build] {source}: nvcc {info.get('seconds', 0.0):.2f} s")
        for line in info.get("log", "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")


def _qkv(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to("cuda", dtype)
            for _ in range(3)]


def kernel_check_phase() -> float:
    """Kernel vs plain version; returns the largest fp32 |difference|.

    The plain version runs in fp32 on the same (upcast) inputs. Both sides
    do fp32 arithmetic, so O and lse agree to FP32_TOL; a bf16 O is further
    rounded to nearest by the kernel, at most half a bf16 ulp, i.e.
    2**-8 of its magnitude (BF16_RTOL)."""
    cases = [(ln, 64) for ln in (128, 256, 512, 200)] + [(256, 128),
                                                          (77, 32)]
    worst_fp32 = 0.0
    for ln, d in cases:
        for dtype, rtol in ((torch.float32, FP32_TOL),
                            (torch.bfloat16, BF16_RTOL)):
            for causal in (True, False):
                q, k, v = _qkv((1, 8, ln, d), dtype, seed=ln * d)
                scale = d ** -0.5
                o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                                scale=scale)
                torch.cuda.synchronize()
                o_ref, lse_ref = fa.flash_attention_plain(
                    q.float(), k.float(), v.float(), causal=causal,
                    scale=scale)
                torch.cuda.synchronize()
                torch.testing.assert_close(o.float(), o_ref, atol=FP32_TOL,
                                           rtol=rtol)
                torch.testing.assert_close(lse, lse_ref, atol=FP32_TOL,
                                           rtol=FP32_TOL)
                err = max(float((o.float() - o_ref).abs().max()),
                          float((lse - lse_ref).abs().max()))
                if dtype == torch.float32:
                    worst_fp32 = max(worst_fp32, err)
                log(f"[3 kernel] [8, {ln}, {d}] {str(dtype)[6:]} "
                    f"causal={causal}: max |kernel - plain| {err:.3e} "
                    f"(atol {FP32_TOL:g}, rtol {rtol:g})")
    return worst_fp32


def _certified(logits: torch.Tensor, token: int) -> bool:
    """``token`` is the argmax of ``logits``, or ties it within TIE_GAP."""
    return float(logits.max() - logits[token]) < TIE_GAP


def serve_phase() -> int:
    model = build_transformer_lm(LM["vocab_size"], LM["seq_len"],
                                 d_model=LM["d_model"], depth=LM["depth"],
                                 num_heads=LM["num_heads"], seed=0)
    engine = ServeEngine(model, max_batch=8, max_len=LM["seq_len"])
    rng = np.random.default_rng(0)
    specs = [(rng.integers(0, LM["vocab_size"],
                           size=int(rng.integers(65, 449))).tolist(),
              int(rng.integers(16, 33))) for _ in range(16)]

    fa.flash_attention_fwd.launches = 0
    t0 = time.monotonic()
    reqs = [engine.submit(p, max_new_tokens=m) for p, m in specs]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = fa.flash_attention_fwd.launches

    if not all(r.status == DONE and len(r.generated) == r.max_new_tokens
               for r in reqs):
        raise AssertionError("not every request finished with its budget: "
                             f"{[(r.status, len(r.generated)) for r in reqs]}")
    want = LM["depth"] * len(reqs)
    if launches != want:
        raise AssertionError(f"flash kernel launched {launches} times in "
                             f"the serve run; expected depth x prefills = "
                             f"{want}")
    tokens = sum(len(r.generated) for r in reqs)
    ttft = statistics.median(r.ttft_s for r in reqs)
    lat = statistics.median(r.latency_s for r in reqs)
    log(f"[4 serve] full-width LM, 16 requests (prompts "
        f"{min(len(p) for p, _ in specs)}-{max(len(p) for p, _ in specs)}):"
        f" all done; {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tok/s; TTFT p50 {ttft * 1e3:.2f} ms; "
        f"latency p50 {lat * 1e3:.2f} ms; flash launches {launches} "
        f"= depth {LM['depth']} x {len(reqs)} prefills; pads "
        f"{engine.compiled_programs()['prefill']}, buckets "
        f"{engine.compiled_programs()['decode']}")

    # Correctness, after the counted run: prefill logits against the plain
    # attention, and every generated token against the full forward.
    plan = engine.plan
    worst, first_agree, ties, decode_ok = 0.0, 0, 0, 0
    with torch.inference_mode():
        for r in reqs:
            plen = len(r.prompt)
            padded = torch.zeros(_pad_to_pow2(plen, hi=LM["seq_len"]),
                                 dtype=torch.long)
            padded[:plen] = torch.tensor(r.prompt)
            padded = padded.cuda()
            scratch = kv_cache.init_cache(plan, max_batch=1,
                                          max_len=LM["seq_len"],
                                          device="cuda")
            lg = kv_cache.prefill(plan, scratch, padded, plen, 0)
            lg_plain = kv_cache.prefill(plan, scratch, padded, plen, 0,
                                        attention_fn=_dense_attention)
            if not (torch.isfinite(lg).all() and lg.shape == (
                    LM["vocab_size"],)):
                raise AssertionError(f"request {r.rid}: bad prefill logits")
            torch.testing.assert_close(lg, lg_plain, atol=1e-3, rtol=0)
            worst = max(worst, float((lg - lg_plain).abs().max()))
            first = r.generated[0]
            if int(lg_plain.argmax()) == first:
                first_agree += 1
            elif _certified(lg_plain, first):
                ties += 1
            else:
                raise AssertionError(
                    f"request {r.rid}: first token {first} is not the plain "
                    f"path's greedy choice {int(lg_plain.argmax())}")
            seq = torch.tensor(r.prompt + r.generated[:-1]).cuda()
            full = model(seq[None])[0]
            for t, tok in enumerate(r.generated):
                if not _certified(full[plen - 1 + t], tok):
                    raise AssertionError(
                        f"request {r.rid}: token {t} ({tok}) differs from "
                        f"the full forward's {int(full[plen - 1 + t].argmax())}")
            decode_ok += 1
    torch.cuda.synchronize()
    log(f"[4 serve] prefill logits kernel vs plain: max |diff| {worst:.3e} "
        f"(atol 1e-3); first greedy token: {first_agree}/16 agree, {ties} "
        f"certified ties (top-2 gap < {TIE_GAP:g}); generated tokens match "
        f"the full forward for {decode_ok}/16 requests")
    return launches


def cli_phase() -> None:
    argv = ["--bench", "--requests", "8", "--max-len", str(LM["seq_len"]),
            "--vocab", str(LM["vocab_size"]), "--d-model",
            str(LM["d_model"]), "--depth", str(LM["depth"]), "--num-heads",
            str(LM["num_heads"]), "--min-new", "8", "--max-new", "16"]
    out = io.StringIO()
    fa.flash_attention_fwd.launches = 0
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    launches = fa.flash_attention_fwd.launches
    report = json.loads(out.getvalue())
    if rc != 0 or not report["ok"] or report["completed"] != 8:
        raise AssertionError(f"serve CLI bench failed: rc {rc}, {report}")
    prefills = metrics.get_registry().snapshot()["counters"]["serve.prefills"]
    if prefills != 8 or launches != LM["depth"] * prefills:
        raise AssertionError(
            f"serve CLI bench: flash kernel launched {launches} times for "
            f"{prefills} prefills; expected depth x prefills = "
            f"{LM['depth']} x 8")
    log(f"[5 cli] python -m tpu_dist_torch.serve --bench (full width, 8 "
        f"requests): {report['throughput_tok_s']} tok/s, TTFT p50 "
        f"{report['ttft_s']['p50']} s on {report['device']}; flash launches "
        f"{launches} = depth {LM['depth']} x {prefills} prefills")


def _time_ms(fn, *, runs: int = 21, per_run: int = 10) -> float:
    """Median over ``runs`` CUDA-event windows of ``per_run`` calls each."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def timing_phase(launches: int, max_abs_err: float) -> dict:
    bh, ln, d = 8, 512, 64
    q, k, v = _qkv((1, bh, ln, d), torch.float32, seed=1)
    scale = d ** -0.5
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True,
                                                 scale=scale))
    plain_ms = _time_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=True, scale=scale))
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale))
    nbytes = 4 * bh * ln * d * 4 + bh * ln * 4   # q, k, v, O + lse, fp32
    flops = 4 * bh * d * ln * (ln + 1) // 2      # QK^T and PV, causal pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    record = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpu_dist_torch/csrc/flash_fwd.cu",
        "replaces": "tpu_dist/ops/flash_attention.py:148",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    log(f"[6 times] [{bh}, {ln}, {d}] fp32 causal, median of 21 windows x 10 "
        f"calls: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {record['bound_ms']:.4f} ms "
        f"({record['bound_by']}: {nbytes} B at 3.35 TB/s, {flops} FLOP at "
        f"67 TFLOP/s fp32)")
    return record


def assert_grads_close(got, want, dtype) -> float:
    """A backward kernel's output against the plain version's; returns the
    largest |difference|. fp32: both sides sum fp32 products in another
    order (atol = rtol = 1e-4). bf16: either side may round an output to
    the neighbouring bf16 value (one ulp, at most 2**-7 of it), and a P or
    dS value lying within the fp32 difference of a bf16 rounding boundary
    may round the other way on one side (2**-8 of one term, at most of the
    largest output)."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=2.0 ** -7,
                                   atol=2.0 ** -8 * float(want.abs().max()))
    return float((got - want).abs().max())


def _bwd_inputs(shape, dtype, causal, seed):
    """q, k, v, dO and the forward kernel's (o, lse) for a backward call."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen).to("cuda", dtype)
                   for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    return (q, k, v, o, lse, do), scale


def bwd_check_phase() -> float:
    """Backward kernels vs their plain version on the same residuals;
    returns the largest fp32 |difference| over dQ, dK, dV."""
    worst_fp32 = 0.0
    for ln in (77, 128, 200, 512, 1024):
        for d in (32, 64, 128):
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                for causal in (True, False):
                    args, scale = _bwd_inputs((1, 8, ln, d), dtype, causal,
                                              seed=ln * d + causal)
                    got = fa.flash_attention_bwd(*args, causal=causal,
                                                 scale=scale)
                    torch.cuda.synchronize()
                    want = fa.flash_attention_bwd_plain(*args, causal=causal,
                                                        scale=scale)
                    torch.cuda.synchronize()
                    err = max(assert_grads_close(g, w, dtype)
                              for g, w in zip(got, want))
                    errs[(str(dtype)[6:], causal)] = err
                    if dtype == torch.float32:
                        worst_fp32 = max(worst_fp32, err)
            log(f"[7 bwd] [8, {ln}, {d}] max |kernel - plain| over dq, dk, "
                f"dv: " + ", ".join(f"{t}{' causal' if c else ''} {e:.2e}"
                                    for (t, c), e in errs.items()))
    log(f"[7 bwd] 60 cases within tolerance (fp32 atol = rtol = 1e-4; bf16 "
        f"rtol 2**-7 + atol 2**-8 max|plain|); worst fp32 {worst_fp32:.3e}")
    return worst_fp32


def _lm_params_and_grads():
    """The full-width LM's parameters on the card and seeded gradients of
    the same shapes, fp32."""
    model = build_transformer_lm(LM["vocab_size"], LM["seq_len"],
                                 d_model=LM["d_model"], depth=LM["depth"],
                                 num_heads=LM["num_heads"], seed=0)
    params = [p.detach().to("cuda") for p in model.parameters()]
    gen = torch.Generator().manual_seed(1)
    grads = [1e-3 * torch.randn(p.shape, generator=gen).to("cuda")
             for p in params]
    return params, grads


def _adam_scale(t: int, lr: float = 1e-3) -> torch.Tensor:
    step = torch.tensor(float(t), device="cuda")
    return lr * torch.sqrt(1 - torch.pow(0.999, step)) / (
        1 - torch.pow(0.9, step))


def adam_check_phase() -> tuple[float, int]:
    """Fused Adam vs its plain version over the full-width LM's parameters
    for 3 steps; returns (largest |difference|, parameter count). rtol
    1e-6: both sides do the same fp32 operations in the same order with
    round-to-nearest (expected bit for bit); the tolerance allows a
    division or square root that rounds the other way."""
    params, grads = _lm_params_and_grads()
    n = sum(p.numel() for p in params)
    kernel = [[p.clone() for p in params],
              [torch.zeros_like(p) for p in params],
              [torch.zeros_like(p) for p in params]]
    plain = [[t.clone() for t in ts] for ts in kernel]
    for t in range(1, 4):
        scale = _adam_scale(t)
        fused.fused_adam_apply(kernel[0], grads, kernel[1], kernel[2],
                               scale=scale, epsilon=1e-7)
        fused.fused_adam_plain(plain[0], grads, plain[1], plain[2],
                               scale=scale, epsilon=1e-7)
    torch.cuda.synchronize()
    worst, exact = 0.0, True
    for got, want in zip(kernel, plain):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-12)
            worst = max(worst, float((g - w).abs().max()))
            exact = exact and torch.equal(g, w)
    moved = max(float((a - b).abs().max()) for a, b in zip(kernel[0], params))
    if not moved > 0:
        raise AssertionError("fused Adam left the parameters unchanged")
    log(f"[8 adam] {len(params)} leaves, {n} parameters, 3 steps: max "
        f"|kernel - plain| over p, m, v {worst:.3e} (rtol 1e-6; bit for bit: "
        f"{exact}); params moved by up to {moved:.3e}")
    return worst, n


def _bench_tokens(global_batch: int):
    """bench.py:120's deterministic next-token batch, on the card."""
    ln, vocab = LM["seq_len"], LM["vocab_size"]
    stream = (np.arange(global_batch * ln + 1) * 2654435761) % vocab
    x = stream[:-1].reshape(global_batch, ln).astype(np.int64)
    y = stream[1:].reshape(global_batch, ln).astype(np.int64)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def _compiled_lm(optimizer, *, plain_attention: bool = False):
    """bench.py:101-106's compile of the full-width LM, on the card; the
    twin's attention is the plain version."""
    model = build_transformer_lm(LM["vocab_size"], LM["seq_len"],
                                 d_model=LM["d_model"], depth=LM["depth"],
                                 num_heads=LM["num_heads"], seed=0)
    if plain_attention:
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.attention_fn = _dense_attention
    model.compile(optimizer=optimizer,
                  loss=SparseCategoricalCrossentropy(from_logits=True),
                  metrics=[SparseCategoricalAccuracy()])
    return model


def _reset_counts() -> None:
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = 0
    fused.fused_adam_apply.launches = 0


def _counts() -> tuple[int, int, int]:
    return (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
            fused.fused_adam_apply.launches)


def _train_steps(model, x, y) -> list[float]:
    fn, state = model.make_train_function(), model.train_state()
    losses = [fn(*state, x, y) for _ in range(TRAIN_STEPS)]
    return [float(v) for v in losses]


def train_phase() -> dict:
    """Full-width training through make_train_function/train_state: SGD,
    then Adam(fused=True), each against its plain-attention twin. Returns
    the launch counts of the two runs together."""
    x, y = _bench_tokens(TRAIN_BATCH)
    depth = LM["depth"]
    totals = [0, 0, 0]
    for name, make, fused_adam in (
            ("SGD(learning_rate=0.001)", lambda f: SGD(learning_rate=0.001),
             False),
            ("Adam(fused=True)", lambda f: Adam(fused=f), True)):
        model = _compiled_lm(make(True))
        before = [p.detach().clone() for p in model.parameters()]
        _reset_counts()
        t0 = time.monotonic()
        losses = _train_steps(model, x, y)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
        want = (depth * TRAIN_STEPS, depth * TRAIN_STEPS,
                TRAIN_STEPS if fused_adam else 0)
        if counts != want:
            raise AssertionError(
                f"{name}: launches (flash fwd, flash bwd, fused Adam) "
                f"{counts}; expected {want}")
        totals = [a + b for a, b in zip(totals, counts)]
        twin = _compiled_lm(make(False), plain_attention=True)
        _reset_counts()
        twin_losses = _train_steps(twin, x, y)
        if _counts() != (0, 0, 0):
            raise AssertionError(f"the plain twin launched {_counts()}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        np.testing.assert_allclose(losses, twin_losses, atol=LOSS_ATOL,
                                   rtol=0, err_msg=name)
        moved = max(float((p.detach() - b).abs().max())
                    for p, b in zip(model.parameters(), before))
        if not moved > 0:
            raise AssertionError(f"{name}: the parameters did not move")
        # (|params - twin's|, the twin's own step, name) per leaf.
        leaves = [(float((p - q).detach().abs().max()),
                   float((q.detach() - b).abs().max()), n)
                  for (n, p), q, b in zip(model.named_parameters(),
                                          twin.parameters(), before)]
        param_diff = max(gap for gap, _, _ in leaves)
        gap, step, leaf = max(
            leaves, key=lambda r: r[0] / (PARAM_RTOL * r[1] + PARAM_ATOL))
        qkv_step = min(step for _, step, n in leaves
                       if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv"))
        limit = ("" if fused_adam else
                 f" (per leaf <= {PARAM_RTOL:g} x step + {PARAM_ATOL:g}; "
                 f"nearest its limit {leaf}: {gap:.3e} for a step of "
                 f"{step:.3e}; least wq/wk/wv step {qkv_step:.3e})")
        if not fused_adam:
            # SGD is linear in the gradients: the two models' parameters
            # differ by lr x the gradients' differences.
            over = [f"{n}: {gap:.3e} (step {step:.3e})"
                    for gap, step, n in leaves
                    if gap > PARAM_RTOL * step + PARAM_ATOL]
            if over:
                raise AssertionError(
                    f"{name}: parameters differ from the twin's by more than "
                    f"{PARAM_RTOL:g} x their step + {PARAM_ATOL:g}: "
                    f"{'; '.join(over[:8])}")
        log(f"[9 train] {name}, batch {TRAIN_BATCH} x L {LM['seq_len']}, "
            f"{TRAIN_STEPS} steps in {wall:.3f} s: losses "
            f"{[round(v, 6) for v in losses]}; plain-attention twin "
            f"{[round(v, 6) for v in twin_losses]} (max |diff| "
            f"{max(abs(a - b) for a, b in zip(losses, twin_losses)):.2e}, "
            f"atol {LOSS_ATOL:g}); params moved by up to {moved:.3e}, max "
            f"|params - twin's| {param_diff:.3e}"
            f"{limit}; launches fwd {counts[0]}, "
            f"bwd {counts[1]} (= depth {depth} x {TRAIN_STEPS}), fused Adam "
            f"{counts[2]}")
        del model, twin
        torch.cuda.empty_cache()
    return {"fwd": totals[0], "bwd": totals[1], "adam": totals[2]}


def fit_phase() -> None:
    model = _compiled_lm(SGD(learning_rate=0.001))
    x, y = _bench_tokens(4 * 32)
    _reset_counts()
    t0 = time.monotonic()
    history = model.fit((x.cpu().numpy(), y.cpu().numpy()), epochs=1,
                        steps_per_epoch=4, verbose=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = _counts()
    loss = history.history["loss"]
    if len(loss) != 1 or not np.isfinite(loss[0]):
        raise AssertionError(f"fit: History loss {loss}")
    if counts != (LM["depth"] * 4, LM["depth"] * 4, 0):
        raise AssertionError(f"fit: launches {counts}; expected "
                             f"({LM['depth'] * 4}, {LM['depth'] * 4}, 0)")
    log(f"[10 fit] Model.fit((x, y), epochs=1, steps_per_epoch=4) at full "
        f"width (batches of 32) in {wall:.3f} s: loss {loss[0]:.6f}, "
        f"accuracy {history.history['accuracy'][0]:.6f}; launches fwd "
        f"{counts[0]}, bwd {counts[1]} (= depth {LM['depth']} x 4)")


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def train_shape_check(args, scale) -> tuple[float, float]:
    """The forward and backward kernels against their plain versions on
    the training path's own shape and inputs ([64, 8, 512, 64] fp32
    causal, the residuals the timing uses); returns (forward, backward)
    largest |difference|."""
    q, k, v, o, lse, do = args
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=True,
                                              scale=scale)
    torch.testing.assert_close(o, o_ref, atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(lse, lse_ref, atol=FP32_TOL, rtol=FP32_TOL)
    fwd_err = max(float((o - o_ref).abs().max()),
                  float((lse - lse_ref).abs().max()))
    del o_ref, lse_ref
    got = fa.flash_attention_bwd(*args, causal=True, scale=scale)
    want = fa.flash_attention_bwd_plain(*args, causal=True, scale=scale)
    bwd_err = max(assert_grads_close(g, w, torch.float32)
                  for g, w in zip(got, want))
    log(f"[11 times] training shape {list(q.shape)} fp32 causal, kernel vs "
        f"plain on the same inputs: forward O and lse {fwd_err:.3e} (atol = "
        f"rtol = {FP32_TOL:g}), backward dq, dk, dv {bwd_err:.3e} (atol = "
        f"rtol = 1e-4)")
    return fwd_err, bwd_err


def bwd_timing_phase(launches: int,
                     check_err: float) -> tuple[dict, float]:
    """Checks and times the backward at the training shape; returns its
    kernel record and the forward's error at that shape."""
    b, h, ln, d = TRAIN_BATCH, LM["num_heads"], LM["seq_len"], 64
    bh = b * h
    args, scale = _bwd_inputs((b, h, ln, d), torch.float32, True, seed=2)
    fwd_err, bwd_err = train_shape_check(args, scale)
    q, k, v, o, lse, do = args
    ms = _time_ms(lambda: fa.flash_attention_bwd(*args, causal=True,
                                                 scale=scale))
    delta = (do * o).sum(-1)
    outs = [torch.empty_like(q) for _ in range(3)]
    part_ms = {name: _time_ms(lambda parts=parts: fa._launch_bwd(
        q, k, v, do, lse, delta, *outs, causal=True, scale=scale,
        parts=parts)) for name, parts in (("dkv", 1), ("dq", 2))}
    plain_ms = _time_ms(lambda: fa.flash_attention_bwd_plain(
        *args, causal=True, scale=scale), runs=11, per_run=2)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                              scale=scale)

    def sdpa_fwd_bwd():
        qg.grad = kg.grad = vg.grad = None
        sdpa().backward(do)

    fwd_bwd_ms = _time_ms(sdpa_fwd_bwd)
    fwd_ms = _time_ms(sdpa)
    library_ms = fwd_bwd_ms - fwd_ms
    kernel_fwd_ms = _time_ms(lambda: fa.flash_attention_fwd(
        q, k, v, causal=True, scale=scale))
    pairs = bh * ln * (ln + 1) // 2              # causal (query, key) pairs
    # q, k, v, o, dO read and dq, dk, dv written, fp32; lse read.
    nbytes = 8 * bh * ln * d * 4 + bh * ln * 4
    flops = 5 * 2 * d * pairs                    # S, dP, dV, dK, dQ products
    bound_ms, bound_by = _bound(nbytes, flops)
    # Each kernel alone: dK/dV reads q, k, v, dO, lse, delta and writes dk,
    # dv (products S, dP, dV, dK); dQ writes dq (products S, dP, dQ).
    part_bound = {
        "dkv": _bound(6 * bh * ln * d * 4 + 2 * bh * ln * 4, 8 * d * pairs),
        "dq": _bound(5 * bh * ln * d * 4 + 2 * bh * ln * 4, 6 * d * pairs)}
    log(f"[11 times] flash backward kernels alone: dK/dV bound "
        f"{part_bound['dkv'][0]:.4f} ms ({part_bound['dkv'][1]}), dQ bound "
        f"{part_bound['dq'][0]:.4f} ms ({part_bound['dq'][1]})")
    log(f"[11 times] flash backward [{bh}, {ln}, {d}] fp32 causal, median "
        f"of CUDA-event windows: kernels {ms:.4f} ms (dK/dV kernel "
        f"{part_ms['dkv']:.4f} ms, dQ kernel {part_ms['dq']:.4f} ms), plain "
        f"{plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms (fwd+bwd "
        f"{fwd_bwd_ms:.4f} - fwd {fwd_ms:.4f}), bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} B at 3.35 TB/s, {flops} FLOP at 67 TFLOP/s "
        f"fp32); the forward kernel at this shape {kernel_fwd_ms:.4f} ms")
    return {"name": "flash_bwd", "route": "cuda",
            "source": "tpu_dist_torch/csrc/flash_bwd.cu",
            "replaces": "tpu_dist/ops/flash_attention.py:245",
            "also_replaces": ["tpu_dist/ops/flash_attention.py:285",
                              "tpu_dist/ops/flash_attention.py:332"],
            "launches": launches, "max_abs_err": bwd_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "dkv_ms": part_ms["dkv"],
            "dq_ms": part_ms["dq"],
            "max_abs_err_check_cases": check_err}, fwd_err


def adam_timing_phase(launches: int, max_abs_err: float) -> dict:
    params, grads = _lm_params_and_grads()
    n = sum(p.numel() for p in params)
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    scale = _adam_scale(1)
    ms = _time_ms(lambda: fused.fused_adam_apply(params, grads, mu, nu,
                                                 scale=scale))
    # The kernel alone, on a table built once: the wrapper's time also
    # holds its per-call checks and table, which bound it whenever the host
    # takes longer than the card.
    rows, chunks = fused._leaf_table(0, list(zip(params, grads, mu, nu)))
    table = torch.tensor(rows, dtype=torch.int64).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    kernel_ms = _time_ms(lambda: fused._kernel()(
        table.data_ptr(), len(rows), chunks, scale.data_ptr(), 0.9, 1 - 0.9,
        0.999, 1 - 0.999, 1e-7, stream))
    plain_ms = _time_ms(lambda: fused.fused_adam_plain(params, grads, mu, nu,
                                                       scale=scale))
    leaves = [p.clone().requires_grad_() for p in params]
    for p, g in zip(leaves, grads):
        p.grad = g
    torch_adam = torch.optim.Adam(leaves, lr=1e-3, eps=1e-7, fused=True)
    library_ms = _time_ms(torch_adam.step)
    nbytes = 7 * 4 * n + 4          # read p, g, m, v; write p, m, v; scale
    flops = 12 * n                  # 3 for m, 4 for v, 5 for p
    bound_ms, bound_by = _bound(nbytes, flops)
    log(f"[11 times] fused Adam over {n} parameters ({len(params)} leaves), "
        f"median of CUDA-event windows: wrapper {ms:.4f} ms (the kernel "
        f"alone on a prebuilt table {kernel_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, torch.optim.Adam(fused=True).step() "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes} B at 3.35 TB/s, {flops} FLOP at 67 TFLOP/s fp32)")
    return {"name": "fused_adam", "route": "cuda",
            "source": "tpu_dist_torch/csrc/fused_adam.cu",
            "replaces": "tpu_dist/ops/pallas_kernels.py:359",
            "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "kernel_alone_ms": kernel_ms}


def step_timing_phase() -> None:
    x, y = _bench_tokens(TRAIN_BATCH)
    for name, optimizer in (("SGD", SGD(learning_rate=0.001)),
                            ("Adam(fused=True)", Adam(fused=True))):
        model = _compiled_lm(optimizer)
        fn, state = model.make_train_function(), model.train_state()
        ms = _time_ms(lambda: fn(*state, x, y), runs=5, per_run=4)
        tokens = TRAIN_BATCH * LM["seq_len"]
        log(f"[11 times] full train step, {name}, batch {TRAIN_BATCH} x L "
            f"{LM['seq_len']} fp32, median of 5 windows x 4 steps: "
            f"{ms:.3f} ms = {tokens / ms * 1e3:.1f} tokens/s")
        del model, fn, state
        torch.cuda.empty_cache()


def main() -> int:
    t0 = time.monotonic()
    card = device_phase()
    build_phase()
    max_abs_err = kernel_check_phase()
    launches = serve_phase()
    cli_phase()
    record = timing_phase(launches, max_abs_err)
    bwd_err = bwd_check_phase()
    adam_err, _ = adam_check_phase()
    train_launches = train_phase()
    record["launches_by_path"] = {"serve": launches,
                                  "train": train_launches["fwd"]}
    fit_phase()
    bwd_record, fwd_train_err = bwd_timing_phase(train_launches["bwd"],
                                                 bwd_err)
    # The forward runs at the serving shapes (phase 3) and the training
    # shape: its error is the larger of the two.
    record["max_abs_err"] = max(record["max_abs_err"], fwd_train_err)
    records = [record, bwd_record,
               adam_timing_phase(train_launches["adam"], adam_err)]
    step_timing_phase()
    log(f"done in {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
