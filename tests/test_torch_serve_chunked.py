"""The port's chunked prefill and int8 pages against the reference.

``prefill_chunk_step`` chunk by chunk against the reference's (logits and
cache at 1e-5, and against one whole-prompt prefill); chunked engines,
contiguous and paged at ``prefill_interleave`` 1 and 2, stream the
reference's greedy tokens; a request evicted by deadline in the middle of
its chunked prefill leaves no page behind and registers no unwritten page
in the prefix cache; and int8-paged engines stream the reference's int8
tokens, with ``serve.kv.quant_error`` within 1e-6 of the reference's and
pools within the int8 bound of ``test_torch_serve_paged``.
"""

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
from tpu_dist_torch.serve import kv_cache, scheduler
from tpu_dist_torch.serve.engine import ServeEngine

from test_torch_serve_paged import assert_pools_close

ATOL = 1e-5
VOCAB, SEQ = 32, 32


def _pair(d_model=16, depth=2, num_heads=2):
    jmodel = jbuild(VOCAB, SEQ, d_model=d_model, depth=depth,
                    num_heads=num_heads)
    params = jmodel.init(0)["params"]
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=d_model,
                                    depth=depth, num_heads=num_heads)
    model.load_jax_params(params)
    return jmodel, params, model


def test_prefill_chunk_step_matches_reference():
    jmodel, params, model = _pair()
    jplan, plan = jkv.build_plan(jmodel), kv_cache.build_plan(model)
    jcache = jkv.init_cache(jplan, max_batch=2, max_len=SEQ)
    cache = kv_cache.init_cache(plan, max_batch=2, max_len=SEQ, device="cpu")
    prompt = np.random.default_rng(2).integers(0, VOCAB, size=21)
    for start, end in ((0, 8), (8, 16), (16, 21)):
        tokens = np.zeros(8, np.int64)
        tokens[:end - start] = prompt[start:end]
        jcache, jlg = jkv.prefill_chunk_step(
            jplan, params, jcache, jnp.asarray(tokens, jnp.int32),
            jnp.int32(end), jnp.int32(1), jnp.int32(start))
        with torch.no_grad():
            lg = kv_cache.prefill_chunk_step(plan, cache,
                                             torch.from_numpy(tokens), end,
                                             1, start)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=ATOL,
                                   rtol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=ATOL,
                                   rtol=ATOL)
    # The last chunk's logits are the whole prompt's.
    padded = np.zeros(SEQ, np.int64)
    padded[:21] = prompt
    with torch.no_grad():
        whole = kv_cache.prefill(plan, kv_cache.init_cache(
            plan, max_batch=1, max_len=SEQ, device="cpu"),
            torch.from_numpy(padded), 21, 0)
    np.testing.assert_allclose(lg.numpy(), whole.numpy(), atol=ATOL,
                               rtol=ATOL)
    with pytest.raises(ValueError, match="runs past"):
        kv_cache.prefill_chunk_step(plan, cache, torch.zeros(16).long(),
                                    30, 0, 24)


def _backlog(engine, seed=11, n=7):
    rng = np.random.default_rng(seed)
    return [engine.submit(rng.integers(0, VOCAB, size=int(
        rng.integers(3, 27))).tolist(), max_new_tokens=int(
        rng.integers(2, 6))) for _ in range(n)]


def _run(engine, reqs_fn):
    metrics.get_registry().reset()
    metrics.enable()
    try:
        reqs = reqs_fn(engine)
        engine.run_until_idle()
        return reqs, metrics.get_registry().snapshot()
    finally:
        metrics.disable()
        metrics.get_registry().reset()


@pytest.mark.parametrize("interleave", [1, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_chunked_streams_match_reference(paged, interleave):
    jmodel, _, model = _pair()
    kw = dict(max_batch=3, max_len=SEQ, prefill_chunk=8,
              prefill_interleave=interleave)
    if paged:
        kw.update(paged=True, page_size=4)
    jeng = JServeEngine(jmodel, **kw)
    eng = ServeEngine(model, device="cpu", **kw)
    jreqs = _backlog(jeng)
    jeng.run_until_idle()
    reqs, snap = _run(eng, _backlog)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert all(r.status == scheduler.DONE for r in reqs)
    assert [r.rid for r in eng.finished] == [r.rid for r in jeng.finished]
    assert eng.compiled_programs() == jeng.compiled_programs()
    assert snap["counters"]["serve.prefill.chunks"] == sum(
        -(-len(r.prompt) // 8) for r in reqs)
    # Chunked streams are the whole-prompt streams.
    kw.pop("prefill_chunk")
    whole = ServeEngine(model, device="cpu", **kw)
    wreqs = _backlog(whole)
    whole.run_until_idle()
    assert [r.generated for r in wreqs] == [r.generated for r in reqs]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_deadline_eviction_mid_prefill_matches_reference():
    """A request evicted by deadline between two of its chunks frees its
    pages and registers only the pages it wrote; an identical request
    afterwards streams like a cold engine's."""
    jmodel, _, model = _pair()
    prompt = np.random.default_rng(9).integers(1, VOCAB, size=22).tolist()
    out = []
    for name, make in (
            ("reference", lambda **kw: JServeEngine(jmodel, **kw)),
            ("port", lambda **kw: ServeEngine(model, device="cpu", **kw))):
        clock = _FakeClock()
        engine = make(max_batch=1, max_len=SEQ, paged=True, page_size=4,
                      prefill_chunk=8, clock=clock)
        stuck = engine.submit(prompt, max_new_tokens=4, deadline_s=5.0)
        engine.step()  # admit + first chunk only
        assert engine.scheduler.is_prefilling(stuck), name
        assert stuck.prefill_pos == 8, (name, stuck.prefill_pos)
        clock.t = 6.0  # blow the deadline mid-prefill
        engine.run_until_idle()
        assert (stuck.status, stuck.finish_reason) == ("evicted",
                                                       "deadline"), name
        alloc = engine._paging.allocator
        assert alloc.count.sum() == 0, (name, alloc.count.tolist())
        assert alloc.pages_in_use == engine._paging.prefix.pages_held == 2, (
            name, alloc.pages_in_use, engine._paging.prefix.pages_held)
        again = engine.generate(prompt, max_new_tokens=4)
        out.append((again, list(alloc._free), alloc.refcount.tolist(),
                    engine._paging.prefix.hits))
    cold = ServeEngine(model, max_batch=1, max_len=SEQ,
                       device="cpu").generate(prompt, max_new_tokens=4)
    # (tokens, free list, refcounts, prefix hits) of each engine.
    assert out[1] == out[0], f"port {out[1]} != reference {out[0]}"
    assert out[1][0] == cold and out[1][3] == 1, (out[1], cold)


def _quant_metric(mod):
    d = mod.get_registry().snapshot()["distributions"]["serve.kv.quant_error"]
    return d["count"], d["max"], d["sum"]


@pytest.mark.parametrize("chunk", [0, 8])
def test_int8_engine_matches_reference(chunk):
    jmodel, _, model = _pair()
    kw = dict(max_batch=3, max_len=SEQ, paged=True, page_size=4,
              kv_dtype="int8", prefill_chunk=chunk)
    jeng = JServeEngine(jmodel, **kw)
    eng = ServeEngine(model, device="cpu", **kw)
    got = []
    for mod, engine in ((jmetrics, jeng), (metrics, eng)):
        mod.get_registry().reset()
        mod.enable()
        try:
            reqs = _backlog(engine, seed=12)
            engine.run_until_idle()
            got.append(([r.generated for r in reqs], _quant_metric(mod)))
        finally:
            mod.disable()
            mod.get_registry().reset()
    (want_streams, want_q), (streams, q) = got
    assert streams == want_streams
    assert q[0] == want_q[0] > 0
    assert abs(q[1] - want_q[1]) <= 1e-6 and 0 < q[1] < 0.1
    assert abs(q[2] - want_q[2]) <= 1e-6 * q[0]
    assert eng.cache["k"].dtype == torch.int8
    assert_pools_close(eng.cache, jeng.cache)
    # int8 pages stream the float pool's tokens on these short horizons.
    kw.pop("kv_dtype")
    fp32 = ServeEngine(model, device="cpu", **kw)
    freqs = _backlog(fp32, seed=12)
    fp32.run_until_idle()
    assert [r.generated for r in freqs] == streams
