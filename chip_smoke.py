#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dist_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Drives the port's serving path end to end on the card and holds every
kernel on that path against its plain PyTorch version. Phases:

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi``); turn TF32 off for matmuls and cuDNN;
2. build: compile the kernels from the checkout's sources (``nvcc``);
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
   used by the port), beside the kernel's lower bound.

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

from tpu_dist_torch.models.transformer import (_dense_attention,
                                               build_transformer_lm)
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.ops import _build
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.serve import cli, kv_cache
from tpu_dist_torch.serve.engine import ServeEngine, _pad_to_pow2
from tpu_dist_torch.serve.scheduler import DONE

#: bench.py's TRANSFORMER_LM at its 512-token sequence length.
LM = dict(vocab_size=8192, seq_len=512, d_model=512, depth=4, num_heads=8)

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
    _build.load("flash_fwd.cu")
    info = _build.build_info.get("flash_fwd.cu", {})
    log(f"[2 build] flash_fwd.cu ready in {time.monotonic() - t0:.2f} s "
        f"(nvcc {info.get('seconds', 0.0):.2f} s)")
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


def main() -> int:
    t0 = time.monotonic()
    card = device_phase()
    build_phase()
    max_abs_err = kernel_check_phase()
    launches = serve_phase()
    cli_phase()
    record = timing_phase(launches, max_abs_err)
    log(f"done in {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
