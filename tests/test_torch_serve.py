"""The port's serving path against the reference, plus the package rules.

The KV-cache functions and whole ``ServeEngine`` runs get the same weights
(the reference's ``init``, bridged) and the same requests (numpy, from a
seed): prefill/decode logits and cache contents agree at 1e-5 in fp32, and
the two engines emit identical greedy token streams over a backlog that
forces slot reuse and compaction. On the CPU the port's attention dispatch
takes the plain version, as the reference's takes dense attention there.
"""

import ast
import io
import json
import pathlib
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.models.transformer import build_transformer_lm as jbuild
from tpu_dist.observe import metrics as jmetrics
from tpu_dist.serve import kv_cache as jkv
from tpu_dist.serve import scheduler as jsched
from tpu_dist.serve.engine import ServeEngine as JServeEngine
from tpu_dist_torch.models import transformer as tr
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.serve import cli, kv_cache, scheduler
from tpu_dist_torch.serve.engine import ServeEngine

ATOL = 1e-5
VOCAB, SEQ = 32, 32
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _pair(d_model=16, depth=2, num_heads=2):
    jmodel = jbuild(VOCAB, SEQ, d_model=d_model, depth=depth,
                    num_heads=num_heads)
    params = jmodel.init(0)["params"]
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=d_model,
                                    depth=depth, num_heads=num_heads)
    model.load_jax_params(params)
    return jmodel, params, model


def _cache_close(got, ref):
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=ATOL, rtol=ATOL)


def _prefilled(slot=2, plen=5, pad=8):
    jmodel, params, model = _pair()
    jplan, plan = jkv.build_plan(jmodel), kv_cache.build_plan(model)
    prompt = np.zeros(pad, np.int32)
    prompt[:plen] = np.random.default_rng(1).integers(0, VOCAB, size=plen)
    jcache = jkv.init_cache(jplan, max_batch=4, max_len=SEQ)
    jcache, jlg = jkv.prefill(jplan, params, jcache, jnp.asarray(prompt),
                              jnp.int32(plen), jnp.int32(slot))
    cache = kv_cache.init_cache(plan, max_batch=4, max_len=SEQ)
    with torch.no_grad():
        lg = kv_cache.prefill(plan, cache, torch.from_numpy(prompt).long(),
                              plen, slot)
    return (jplan, params, jcache, jlg), (plan, cache, lg)


def test_prefill_matches_reference():
    (_, _, jcache, jlg), (_, cache, lg) = _prefilled()
    assert lg.shape == (VOCAB,)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL,
                               rtol=ATOL)
    _cache_close(cache, jcache)


def test_decode_steps_match_reference():
    (jplan, params, jcache, jlg), (plan, cache, lg) = _prefilled(slot=2)
    tokens = np.zeros(4, np.int32)
    lengths = np.zeros(4, np.int32)
    tokens[:3] = [3, 7, int(np.argmax(np.asarray(jlg)))]
    lengths[:3] = [2, 0, 5]
    for _ in range(3):
        jcache, jout = jkv.decode_step(jplan, params, jcache,
                                       jnp.asarray(tokens),
                                       jnp.asarray(lengths), bucket=3)
        with torch.no_grad():
            out = kv_cache.decode_step(plan, cache,
                                       torch.from_numpy(tokens).long(),
                                       torch.from_numpy(lengths).long(),
                                       bucket=3)
        assert out.shape == (3, VOCAB) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=ATOL, rtol=ATOL)
        tokens[:3] = np.argmax(np.asarray(jout), axis=-1)
        lengths[:3] += 1
    _cache_close(cache, jcache)


def test_swap_slots_matches_reference():
    (_, _, jcache, _), (_, cache, _) = _prefilled(slot=2)
    jcache = jkv.swap_slots(jcache, jnp.int32(0), jnp.int32(2))
    kv_cache.swap_slots(cache, 0, 2)
    _cache_close(cache, jcache)


def test_cache_sizing_matches_reference():
    jmodel, _, model = _pair()
    jplan, plan = jkv.build_plan(jmodel), kv_cache.build_plan(model)
    assert kv_cache.cache_nbytes(plan, max_batch=8, max_len=SEQ) == \
        jkv.cache_nbytes(jplan, max_batch=8, max_len=SEQ)
    assert (plan.num_layers, plan.num_heads, plan.key_dim,
            plan.max_position, plan.vocab_size) == (
        jplan.num_layers, jplan.num_heads, jplan.key_dim,
        jplan.max_position, jplan.vocab_size)
    with pytest.raises(ValueError, match="positional table"):
        kv_cache.init_cache(plan, max_batch=1, max_len=SEQ + 1)


def test_unservable_models_rejected():
    from tpu_dist_torch.models.layers import Dense
    from tpu_dist_torch.models.model import Sequential

    with pytest.raises(TypeError, match="Sequential"):
        kv_cache.build_plan(Dense(4))
    model = Sequential([tr.Embedding(VOCAB, 8),
                        tr.MultiHeadAttention(num_heads=2, key_dim=4),
                        Dense(VOCAB)], input_shape=(SEQ,))
    with pytest.raises(TypeError, match="non-causal"):
        kv_cache.build_plan(model)


def _recording(engine):
    seen = []
    pick = engine._pick

    def record(logits):
        seen.append(np.asarray(logits, np.float32).copy())
        return pick(logits)

    engine._pick = record
    return seen


def _backlog(engine):
    rng = np.random.default_rng(7)
    return [engine.submit(rng.integers(0, VOCAB, size=int(n)).tolist(),
                          max_new_tokens=int(m))
            for n, m in zip(rng.integers(3, 13, size=6),
                            rng.integers(4, 11, size=6))]


def test_engines_stream_identical_greedy_tokens():
    jmodel, _, model = _pair()
    jeng = JServeEngine(jmodel, max_batch=4, max_len=SEQ)
    eng = ServeEngine(model, max_batch=4, max_len=SEQ, device="cpu")
    jseen, seen = _recording(jeng), _recording(eng)
    jreqs, reqs = _backlog(jeng), _backlog(eng)
    jeng.run_until_idle()
    eng.run_until_idle()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert all(r.status == scheduler.DONE for r in reqs)
    assert [r.rid for r in eng.finished] == [r.rid for r in jeng.finished]
    assert len(seen) == len(jseen) == sum(len(r.generated) for r in reqs)
    for a, b in zip(seen, jseen):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL)
    assert eng.compiled_programs() == jeng.compiled_programs()


def test_engine_rejects_a_prompt_that_fills_the_slot():
    _, _, model = _pair()
    eng = ServeEngine(model, max_batch=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit(list(range(8)))
    assert eng.generate([1, 2, 3], max_new_tokens=3) == eng.finished[0].generated


def test_engine_without_device_raises_on_a_machine_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, _, model = _pair()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, max_batch=2, max_len=SEQ)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((ROOT / "tpu_dist_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "tpu_dist")]
    assert bad == []


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_scheduler_copy_behaves_like_reference(policy):
    def drive(mod):
        s = mod.Scheduler(4, policy=policy)
        trace = []
        reqs = [mod.Request(prompt=[1] * (i + 1), max_new_tokens=2 + i % 3,
                            deadline_s=(0.5 if i == 4 else None))
                for i in range(6)]
        for i, r in enumerate(reqs):
            s.submit(r, now=0.1 * i)
        for step in range(12):
            now = 0.2 * step
            trace.append(("evict", [(r.rid, sw) for r, sw in
                                    s.evict_deadline(now=now)]))
            trace.append(("admit", [(r.rid, r.slot) for r in s.admit()]))
            trace.append(("bucket", s.bucket(), s.num_active))
            for r in sorted(s.active(), key=lambda r: r.slot,
                            reverse=True):
                if s.record_token(r, 5, now=now):
                    trace.append(("finish", r.rid, s.finish(r, now=now)))
        trace.append([(r.rid, r.status, r.finish_reason, r.generated)
                      for r in reqs])
        return trace

    assert drive(scheduler) == drive(jsched)
    assert scheduler.default_buckets(6) == jsched.default_buckets(6)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.95, 0.99, 1.0])
def test_metrics_quantile_matches_reference(q):
    vals = sorted(np.random.default_rng(8).standard_normal(37).tolist())
    assert metrics.quantile(vals, q) == jmetrics.quantile(vals, q)


def test_metrics_registry_snapshot_matches_reference():
    def fill(mod):
        reg = mod.MetricsRegistry()
        for i in range(50):
            reg.counter("c").inc()
            reg.gauge("g").set(i)
            reg.distribution("d").observe(i * 0.5)
        return reg.snapshot()

    assert fill(metrics) == fill(jmetrics)


def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_cli_bench_closed_loop_on_cpu():
    rc, out = _run_cli(["--bench", "--device", "cpu", "--requests", "5",
                        "--max-len", "32", "--vocab", "32", "--d-model",
                        "16", "--max-new", "6"])
    report = json.loads(out)
    assert rc == 0 and report["ok"] and report["completed"] == 5
    assert report["device"] == "cpu" and report["mode"] == "closed-loop"
    assert report["latency_s"]["p50"] > 0
    assert report["batch_occupancy"]["count"] > 0
    assert report["compiled_programs"]["decode"]


def test_cli_demo_on_cpu():
    rc, out = _run_cli(["--device", "cpu", "--requests", "3"])
    assert rc == 0 and out.count("req ") == 3
