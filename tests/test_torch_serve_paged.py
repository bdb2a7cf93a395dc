"""The port's paged KV pool and paged engine against the reference.

The paged functions get the reference's weights (bridged) and the same
page tables and tokens: ``paged_prefill`` cold and after a cached prefix
(its ``start`` at a page boundary and inside a page), then
``paged_decode_step`` over several steps — logits and every pool entry
but the scratch row agree at 1e-5 (an int8 pool's payload to one step at
no more than 0.1 % of the written values, its scales to 1e-5 of the rows
they scale). Whole paged
engines stream the same greedy tokens as the reference's over a backlog
that reuses and compacts slots, hits the prefix cache, copies on write,
defers admission under a small pool and evicts by deadline, with equal
page metrics and allocator state.
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.models.transformer import build_transformer_lm as jbuild
from tpu_dist.observe import metrics as jmetrics
from tpu_dist.serve import kv_cache as jkv
from tpu_dist.serve.engine import ServeEngine as JServeEngine
from tpu_dist_torch.models import transformer as tr
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.serve import cli, kv_cache, scheduler
from tpu_dist_torch.serve.engine import ServeEngine

ATOL = 1e-5
VOCAB, SEQ, PS = 32, 32, 4


def _pair(d_model=16, depth=2, num_heads=2):
    jmodel = jbuild(VOCAB, SEQ, d_model=d_model, depth=depth,
                    num_heads=num_heads)
    params = jmodel.init(0)["params"]
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=d_model,
                                    depth=depth, num_heads=num_heads)
    model.load_jax_params(params)
    return jmodel, params, model


def assert_pools_close(pool, jpool):
    """Every pool entry but the scratch row (padding's unordered writes
    land there): floats at 1e-5; an int8 payload within one step at no
    more than 0.1 % of the written values; scales, amax / 127 of rows
    held at 1e-5, at rtol 1e-5 and atol 1e-5 / 127."""
    assert sorted(pool) == sorted(jpool)
    for name in pool:
        got = pool[name][:, :-1].numpy()
        want = np.asarray(jpool[name])[:, :-1]
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            written = np.count_nonzero(np.asarray(jpool[name + "_scale"])
                                       [:, :-1]) * got.shape[-1]
            assert diff.max() <= 1, name
            assert np.count_nonzero(diff) <= 1e-3 * written, name
        elif name.endswith("_scale"):
            # scale = amax / 127 of K/V rows that agree at 1e-5.
            np.testing.assert_allclose(got, want, rtol=ATOL,
                                       atol=ATOL / 127)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("start", [0, 8, 6])
def test_paged_prefill_and_decode_match_reference(start, dtype):
    """A prompt prefilled through a scattered page table (cold, or its
    suffix after ``start`` cached positions), then 3 decode steps over a
    bucket of 3 slots (the third inactive, all scratch)."""
    jdt, dt = _DTYPES[dtype]
    jmodel, params, model = _pair()
    jplan, plan = jkv.build_plan(jmodel), kv_cache.build_plan(model)
    num_pages, max_pages = 12, SEQ // PS
    jpool = jkv.init_page_pool(jplan, num_pages=num_pages, page_size=PS,
                               dtype=jdt)
    pool = kv_cache.init_page_pool(plan, num_pages=num_pages, page_size=PS,
                                   dtype=dt, device="cpu")
    tables = np.full((3, max_pages), num_pages, np.int32)
    tables[0, :4] = [7, 2, 9, 0]
    tables[1, :2] = [5, 11]
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, VOCAB, size=13)

    def prefill(slot, lo, hi, pad):
        nonlocal jpool
        tokens = np.zeros(pad, np.int64)
        tokens[:hi - lo] = prompt[lo:hi] if slot == 0 else prompt[:hi - lo]
        jout = jkv.paged_prefill(jplan, params, jpool,
                                 jnp.asarray(tables[slot]),
                                 jnp.asarray(tokens, jnp.int32),
                                 jnp.int32(hi), jnp.int32(lo))
        jpool = jout[0]
        with torch.no_grad():
            out = kv_cache.paged_prefill(plan, pool,
                                         torch.from_numpy(tables[slot]),
                                         torch.from_numpy(tokens), hi, lo)
        if dtype == "int8":
            out, qerr = out
            assert abs(float(qerr) - float(jout[2])) <= 1e-6
            assert 0 < float(qerr) < 0.1
        assert out.shape == (VOCAB,)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout[1]),
                                   atol=ATOL, rtol=ATOL)
        return int(np.argmax(np.asarray(jout[1])))

    if start:
        prefill(0, 0, start, 8)
    first = prefill(0, start, 13, 8 if start else 16)
    second = prefill(1, 0, 6, 8)
    assert_pools_close(pool, jpool)

    tokens = np.array([first, second, 3], np.int64)
    lengths = np.array([13, 6, 0], np.int64)
    for _ in range(3):
        jpool, jout = jkv.paged_decode_step(
            jplan, params, jpool, jnp.asarray(tables),
            jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths, jnp.int32),
            bucket=3)
        with torch.no_grad():
            out = kv_cache.paged_decode_step(
                plan, pool, torch.from_numpy(tables),
                torch.from_numpy(tokens), torch.from_numpy(lengths),
                bucket=3)
        assert out.shape == (3, VOCAB) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=ATOL, rtol=ATOL)
        tokens = np.argmax(np.asarray(jout), axis=-1).astype(np.int64)
        lengths[:2] += 1
    assert_pools_close(pool, jpool)


def test_suffix_prefill_equals_whole_prefill():
    """Cached prefix + suffix gives the whole prompt's logits (the
    identity a prefix hit rests on), at a start inside a page."""
    _, _, model = _pair()
    plan = kv_cache.build_plan(model)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, VOCAB, size=16))
    row = torch.tensor([3, 0, 4, 1, 6, 6, 6, 6])
    with torch.no_grad():
        whole = kv_cache.paged_prefill(
            plan, kv_cache.init_page_pool(plan, num_pages=6, page_size=PS,
                                          device="cpu"), row, prompt, 14, 0)
        pool = kv_cache.init_page_pool(plan, num_pages=6, page_size=PS,
                                       device="cpu")
        kv_cache.paged_prefill(plan, pool, row, prompt[:8], 5, 0)
        suffix = kv_cache.paged_prefill(plan, pool, row, prompt[5:], 14, 5)
    np.testing.assert_allclose(suffix.numpy(), whole.numpy(), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_copy_page_matches_reference(dtype):
    jdt, dt = _DTYPES[dtype]
    jmodel, _, model = _pair()
    jplan, plan = jkv.build_plan(jmodel), kv_cache.build_plan(model)
    pool = kv_cache.init_page_pool(plan, num_pages=4, page_size=PS,
                                   dtype=dt, device="cpu")
    jpool = jkv.init_page_pool(jplan, num_pages=4, page_size=PS, dtype=jdt)
    rng = np.random.default_rng(6)
    for name in pool:
        vals = rng.integers(-127, 128, size=tuple(pool[name].shape))
        vals = vals.astype(np.int8 if pool[name].dtype == torch.int8
                           else np.float32)
        pool[name].copy_(torch.from_numpy(vals))
        jpool[name] = jnp.asarray(vals)
    kv_cache.copy_page(pool, 1, 3)
    jpool = jkv.copy_page(jpool, jnp.int32(1), jnp.int32(3))
    for name in pool:
        np.testing.assert_array_equal(pool[name].numpy(),
                                      np.asarray(jpool[name]))
        np.testing.assert_array_equal(pool[name][:, 3].numpy(),
                                      pool[name][:, 1].numpy())


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _recording(engine):
    seen = []
    pick = engine._pick

    def record(logits):
        seen.append(np.asarray(logits, np.float32).copy())
        return pick(logits)

    engine._pick = record
    return seen


#: Page metrics the two engines must agree on.
_COUNTERS = ("serve.prefix.hits", "serve.prefix.misses",
             "serve.prefix.bytes_saved", "serve.prefills",
             "serve.decode.steps", "serve.tokens.generated",
             "serve.requests.completed", "serve.requests.evicted")
_GAUGES = ("serve.pages.in_use", "serve.pages.free",
           "serve.pages.bytes_per_slot")


def _page_metrics(mod):
    snap = mod.get_registry().snapshot()
    dist = snap["distributions"]["serve.prefill.skipped_tokens"]
    return ({k: snap["counters"].get(k) for k in _COUNTERS},
            {k: snap["gauges"].get(k) for k in _GAUGES},
            {k: dist[k] for k in ("count", "sum", "min", "max")})


def _shared_prefix_backlog(engine, rng):
    """A deadline-bound request first; then a 10-token prompt (two full
    pages and a partial) that finishes at once, and later prompts that
    repeat it or extend it (hits on its full pages and, copied on write,
    its partial tail page), among unrelated ones."""
    base = rng.integers(0, VOCAB, size=10).tolist()
    other = lambda: rng.integers(0, VOCAB, size=int(
        rng.integers(3, 12))).tolist()
    sfx = lambda: rng.integers(0, VOCAB, size=int(
        rng.integers(1, 6))).tolist()
    specs = [(rng.integers(0, VOCAB, size=5).tolist(), 20, 1.1),
             (base, 2, None), (other(), 6, None), (other(), 4, None),
             (base, 5, None), (base + sfx(), 6, None), (other(), 3, None),
             (base + sfx(), 7, None), (base, 4, None), (other(), 5, None)]
    return [engine.submit(p, max_new_tokens=m, deadline_s=d)
            for p, m, d in specs]


def test_paged_engine_streams_match_reference():
    jmodel, _, model = _pair()
    clock = _FakeClock()
    kw = dict(max_batch=3, max_len=SEQ, paged=True, page_size=PS,
              num_pages=20, clock=clock)
    jeng = JServeEngine(jmodel, **kw)
    eng = ServeEngine(model, device="cpu", **kw)
    jseen, seen = _recording(jeng), _recording(eng)
    copies = []
    copy_page = kv_cache.copy_page
    eng_copy = lambda pool, src, dst: (copies.append((src, dst)),
                                       copy_page(pool, src, dst))
    deferred = 0
    for mod in (jmetrics, metrics):
        mod.get_registry().reset()
        mod.enable()
    try:
        kv_cache.copy_page = eng_copy
        jreqs = _shared_prefix_backlog(jeng, np.random.default_rng(3))
        reqs = _shared_prefix_backlog(eng, np.random.default_rng(3))
        for step in range(1, 300):
            if jeng.scheduler.idle() and eng.scheduler.idle():
                break
            clock.t = 0.25 * step
            jeng.step()
            eng.step()
            deferred += (eng.scheduler.queue_depth() > 0
                         and eng.scheduler.num_active < 3)
            assert (eng._paging.allocator.table.tolist()
                    == jeng._paging.allocator.table.tolist())
        jm, m = _page_metrics(jmetrics), _page_metrics(metrics)
    finally:
        kv_cache.copy_page = copy_page
        for mod in (jmetrics, metrics):
            mod.disable()
            mod.get_registry().reset()
    assert eng.scheduler.idle() and jeng.scheduler.idle()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [(r.rid, r.status, r.finish_reason) for r in eng.finished] == \
        [(r.rid, r.status, r.finish_reason) for r in jeng.finished]
    assert len(seen) == len(jseen)
    for a, b in zip(seen, jseen):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL)
    assert m == jm
    assert eng.compiled_programs() == jeng.compiled_programs()
    alloc, jalloc = eng._paging.allocator, jeng._paging.allocator
    assert (list(alloc._free), alloc.refcount.tolist()) == \
        (list(jalloc._free), jalloc.refcount.tolist())
    alloc.check()
    # The backlog reached every path it was built for.
    evicted = reqs[0]
    assert evicted.status == scheduler.EVICTED and evicted.generated
    assert m[0]["serve.prefix.hits"] >= 4 and copies and deferred
    assert m[2]["max"] > 0
    assert max(r.rid for r in eng.finished[:3]) >= 3  # slots were reused


@pytest.mark.parametrize("kwargs", [
    dict(kv_dtype="int8"),
    dict(paged=True, kv_dtype="int4"),
    dict(prefill_chunk=12),
    dict(prefill_chunk=4),
    dict(prefill_chunk=-8),
    dict(max_len=24, prefill_chunk=16),
    dict(prefill_chunk=8, prefill_interleave=0),
    dict(budget_bytes=3000),
    dict(paged=True, budget_bytes=1000),
    dict(paged=True, num_pages=8, budget_bytes=5000),
    dict(max_len=SEQ + 1, paged=True),
])
def test_engine_validation_matches_reference(kwargs):
    jmodel, _, model = _pair()
    with pytest.raises(ValueError) as want:
        JServeEngine(jmodel, max_batch=2, **{"max_len": SEQ, **kwargs})
    with pytest.raises(ValueError) as got:
        ServeEngine(model, max_batch=2, device="cpu",
                    **{"max_len": SEQ, **kwargs})
    assert str(got.value) == str(want.value)


def test_paged_submit_and_budget_sizing_match_reference():
    jmodel, _, model = _pair()
    kw = dict(max_batch=4, max_len=SEQ, paged=True, page_size=PS)
    jeng = JServeEngine(jmodel, num_pages=3, **kw)
    eng = ServeEngine(model, num_pages=3, device="cpu", **kw)
    texts = []
    for e in (eng, jeng):
        with pytest.raises(ValueError) as err:
            e.submit(list(range(1, 12)), max_new_tokens=8)
        texts.append(str(err.value))
    assert texts[0] == texts[1] and "pages" in texts[0]
    plan = kv_cache.build_plan(model)
    budget = kv_cache.cache_nbytes(plan, max_batch=2, max_len=SEQ)
    for dtype in (None, "bf16", "int8"):
        got = ServeEngine(model, budget_bytes=budget, kv_dtype=dtype,
                          device="cpu", **kw)
        want = JServeEngine(jmodel, budget_bytes=budget, kv_dtype=dtype,
                            **kw)
        assert got.num_pages == want.num_pages
        assert got.cache["k"].dtype == {None: torch.float32,
                                        "bf16": torch.bfloat16,
                                        "int8": torch.int8}[dtype]
    assert ServeEngine(model, budget_bytes=budget, device="cpu",
                       **kw).num_pages == 2 * SEQ // PS - 1


def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, json.loads(out.getvalue())


@pytest.mark.parametrize("kv_dtype", [[], ["--kv-dtype", "int8"]])
def test_cli_bench_paged_on_cpu(kv_dtype):
    rc, report = _run_cli(["--bench", "--device", "cpu", "--paged",
                           "--requests", "6", "--max-len", "32", "--vocab",
                           "32", "--d-model", "16", "--max-new", "6",
                           "--page-size", "4", *kv_dtype])
    assert rc == 0 and report["ok"] and report["completed"] == 6
    assert report["config"]["paged"] is True
    assert report["config"]["kv_dtype"] == (kv_dtype[1] if kv_dtype
                                            else None)
    progs = report["compiled_programs"]
    assert progs["paged_decode"] and progs["paged_prefill"]
    assert progs["decode"] == progs["prefill"] == []
