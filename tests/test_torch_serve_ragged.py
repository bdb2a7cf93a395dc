"""The port's ragged single-program decode against the reference.

``paged_decode_ragged`` gets the reference's weights (bridged) and the
same pool, page tables, tokens, lengths and active mask: the active rows'
logits and every pool entry but the scratch row agree at 1e-5 (an int8
pool within the bound of ``test_torch_serve_paged``), and a row in the
middle of a chunked prefill, whose table row holds real pages, leaves them
as they were. Ragged engines stream the tokens of the bucketed engines
and of the reference's own ragged engine, for fp32 and int8 pools and
with chunked prefill, keep one decode program over two backlogs and
measure occupancy against the whole slot capacity. The prefills' scalar
arguments as 0-d tensors (one CUDA graph a pad serves every request)
give the bits of the int forms.
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
from tpu_dist_torch.serve import cli, kv_cache
from tpu_dist_torch.serve.engine import ServeEngine
from tpu_dist_torch.utils import graphs

from test_torch_serve_paged import assert_pools_close

ATOL = 1e-5
VOCAB, SEQ, PS = 32, 32, 4
_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "int8": (jnp.int8, torch.int8)}


def _pair(d_model=16, depth=2, num_heads=2):
    jmodel = jbuild(VOCAB, SEQ, d_model=d_model, depth=depth,
                    num_heads=num_heads)
    params = jmodel.init(0)["params"]
    model = tr.build_transformer_lm(VOCAB, SEQ, d_model=d_model,
                                    depth=depth, num_heads=num_heads)
    model.load_jax_params(params)
    return jmodel, params, model


def _random_pool(pool, rng):
    """Fill every entry with seeded values (int8 payloads, positive
    scales, floats); returns the same values as numpy arrays."""
    out = {}
    for name, a in pool.items():
        if a.dtype == torch.int8:
            vals = rng.integers(-127, 128, size=tuple(a.shape)).astype(
                np.int8)
        elif name.endswith("_scale"):
            vals = rng.uniform(0.005, 0.02, size=tuple(a.shape)).astype(
                np.float32)
        else:
            vals = rng.standard_normal(tuple(a.shape)).astype(np.float32)
        a.copy_(torch.from_numpy(vals))
        out[name] = vals
    return out


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_paged_decode_ragged_matches_reference(dtype):
    """Four slots over a seeded pool: two decoding (active), one in the
    middle of a chunked prefill (inactive, real pages), one empty
    (inactive, all scratch); three steps."""
    jdt, dt = _DTYPES[dtype]
    jmodel, params, model = _pair()
    jplan, plan = jkv.build_plan(jmodel), kv_cache.build_plan(model)
    num_pages, max_pages = 12, SEQ // PS
    pool = kv_cache.init_page_pool(plan, num_pages=num_pages, page_size=PS,
                                   dtype=dt, device="cpu")
    jpool = {k: jnp.asarray(v) for k, v in
             _random_pool(pool, np.random.default_rng(7)).items()}
    tables = np.full((4, max_pages), num_pages, np.int32)
    tables[0, :4] = [7, 2, 9, 0]
    tables[1, :2] = [5, 11]      # mid-chunk: real pages, not decoding
    tables[2, :2] = [3, 4]
    lengths = np.array([13, 6, 5, 0], np.int64)
    tokens = np.array([1, 2, 3, 4], np.int64)
    active = np.array([True, False, True, False])
    mid = {k: v[:, [5, 11]].clone() for k, v in pool.items()}
    for _ in range(3):
        jpool, jout = jkv.paged_decode_ragged(
            jplan, params, jpool, jnp.asarray(tables),
            jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths, jnp.int32),
            jnp.asarray(active))
        with torch.no_grad():
            out = kv_cache.paged_decode_ragged(
                plan, pool, torch.from_numpy(tables),
                torch.from_numpy(tokens), torch.from_numpy(lengths),
                torch.from_numpy(active))
        assert out.shape == (4, VOCAB) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy()[active],
                                   np.asarray(jout)[active], atol=ATOL,
                                   rtol=ATOL)
        tokens[active] = np.argmax(np.asarray(jout), axis=-1)[active]
        lengths[active] += 1
    assert_pools_close(pool, jpool)
    for name, before in mid.items():
        assert torch.equal(pool[name][:, [5, 11]], before), name


def test_paged_decode_ragged_equals_the_bucketed_step():
    """The active rows of a ragged step are the bucketed step's, bit for
    bit, when the inactive rows' tables are all scratch (the bucketed
    path's invariant) and both cover the same slots."""
    _, _, model = _pair()
    plan = kv_cache.build_plan(model)
    pools = [kv_cache.init_page_pool(plan, num_pages=12, page_size=PS,
                                     device="cpu") for _ in range(2)]
    for p in pools:
        _random_pool(p, np.random.default_rng(8))
    tables = torch.full((3, SEQ // PS), 12, dtype=torch.int32)
    tables[0, :3] = torch.tensor([4, 1, 6])
    tables[1, :2] = torch.tensor([2, 9])
    tokens, lengths = torch.tensor([5, 6, 7]), torch.tensor([9, 6, 0])
    with torch.no_grad():
        ragged = kv_cache.paged_decode_ragged(
            plan, pools[0], tables, tokens, lengths,
            torch.tensor([True, True, False]))
        bucketed = kv_cache.paged_decode_step(plan, pools[1], tables,
                                              tokens, lengths, bucket=3)
    assert torch.equal(ragged[:2], bucketed[:2])
    for name in pools[0]:
        assert torch.equal(pools[0][name][:, :-1], pools[1][name][:, :-1])


def _workload(n, *, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, VOCAB, size=int(rng.integers(2, 14))).tolist(),
             int(rng.integers(3, 11))) for _ in range(n)]


def _drive(engine, workload):
    reqs = [engine.submit(p, max_new_tokens=m) for p, m in workload]
    engine.run_until_idle()
    return [list(r.generated) for r in reqs]


def _occupancy(mod):
    dist = mod.get_registry().snapshot()["distributions"][
        "serve.batch.occupancy"]
    return {k: dist[k] for k in ("count", "sum", "min", "max")}


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8"},
                                {"prefill_chunk": 8}],
                         ids=["fp32", "int8", "chunked"])
def test_ragged_streams_match_bucketed_and_reference(kw):
    jmodel, _, model = _pair()
    base = dict(max_batch=4, max_len=SEQ, paged=True, page_size=PS, **kw)
    work = _workload(10)
    want = _drive(ServeEngine(model, device="cpu", **base), work)
    for mod in (jmetrics, metrics):
        mod.get_registry().reset()
        mod.enable()
    try:
        jeng = JServeEngine(jmodel, ragged=True, **base)
        eng = ServeEngine(model, ragged=True, device="cpu", **base)
        jgot, got = _drive(jeng, work), _drive(eng, work)
        jocc, occ = _occupancy(jmetrics), _occupancy(metrics)
    finally:
        for mod in (jmetrics, metrics):
            mod.disable()
            mod.get_registry().reset()
    assert got == want
    assert got == jgot
    # Occupancy against the whole capacity, every step, as the reference.
    assert occ["count"] == jocc["count"]
    for key in ("sum", "min", "max"):
        np.testing.assert_allclose(occ[key], jocc[key], rtol=1e-6)
    assert eng.compiled_programs() == jeng.compiled_programs()
    assert eng.compiled_programs()["paged_decode"] == [4]


def test_ragged_engine_keeps_one_decode_program():
    _, _, model = _pair()
    engine = ServeEngine(model, max_batch=4, max_len=SEQ, paged=True,
                         page_size=PS, ragged=True, device="cpu")
    _drive(engine, _workload(12))
    assert engine.compiled_programs()["paged_decode"] == [4]
    _drive(engine, _workload(8, seed=11))
    assert engine.compiled_programs()["paged_decode"] == [4]
    # The CPU runs eagerly: nothing is captured.
    assert engine.programs == {} and engine.capture_seconds == 0.0


def test_ragged_requires_paged_as_in_the_reference():
    jmodel, _, model = _pair()
    with pytest.raises(ValueError) as want:
        JServeEngine(jmodel, max_batch=2, max_len=SEQ, ragged=True)
    with pytest.raises(ValueError) as got:
        ServeEngine(model, max_batch=2, max_len=SEQ, ragged=True,
                    device="cpu")
    assert str(got.value) == str(want.value)


def test_cli_bench_paged_ragged_on_cpu():
    out = io.StringIO()
    argv = ["--bench", "--device", "cpu", "--paged", "--ragged",
            "--requests", "6", "--max-len", "32", "--max-batch", "4"]
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    report = json.loads(out.getvalue())
    assert rc == 0 and report["ok"] and report["completed"] == 6
    assert report["config"]["ragged"] is True
    assert report["compiled_programs"]["paged_decode"] == [4]


def _scalar_forms(name, plan, rng):
    """(int-form call, tensor-form call, fresh state) for one prefill."""
    tokens = torch.from_numpy(rng.integers(0, VOCAB, size=16))
    t = torch.tensor
    if name == "prefill":
        return (lambda c: kv_cache.prefill(plan, c, tokens, 11, 2),
                lambda c: kv_cache.prefill(plan, c, tokens, t(11), t(2)),
                lambda: kv_cache.init_cache(plan, max_batch=3, max_len=SEQ,
                                            device="cpu"))
    if name == "chunk":
        def chunk(c, length, slot, start):
            kv_cache.prefill(plan, c, tokens, 8, 1)
            return kv_cache.prefill_chunk_step(plan, c, tokens[:8], length,
                                               slot, start)
        return (lambda c: chunk(c, 13, 1, 8),
                lambda c: chunk(c, t(13), t(1), t(8)),
                lambda: kv_cache.init_cache(plan, max_batch=3, max_len=SEQ,
                                            device="cpu"))
    dt = torch.int8 if name == "paged_int8" else torch.float32
    row = t([3, 1, 5, 0, 8, 8, 8, 8])

    def paged(c, length, start):
        kv_cache.paged_prefill(plan, c, row, tokens[:8], 6, 0)
        return kv_cache.paged_prefill(plan, c, row, tokens, length, start)
    return (lambda c: paged(c, 15, 6), lambda c: paged(c, t(15), t(6)),
            lambda: kv_cache.init_page_pool(plan, num_pages=8,
                                            page_size=PS, dtype=dt,
                                            device="cpu"))


@pytest.mark.parametrize("name", ["prefill", "chunk", "paged_fp32",
                                  "paged_int8"])
def test_device_scalar_forms_equal_the_int_forms(name):
    _, _, model = _pair()
    plan = kv_cache.build_plan(model)
    ints, tensors, fresh = _scalar_forms(name, plan,
                                         np.random.default_rng(9))
    a, b = fresh(), fresh()
    with torch.no_grad():
        want, got = ints(a), tensors(b)
    if name == "paged_int8":
        assert torch.equal(got[1], want[1])   # quant_error
        want, got = want[0], got[0]
    assert torch.equal(got, want)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_captured_program_refuses_the_cpu_and_sizes_its_inputs():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.CapturedProgram(lambda: None, {}, device="cpu")
    assert graphs.spec_of(np.zeros((3, 4), np.int32)) == ((3, 4),
                                                          torch.int32)
    assert graphs.spec_of(np.zeros(5, bool)) == ((5,), torch.bool)
    assert graphs.spec_of(7) == ((), torch.int64)
    with pytest.raises(TypeError, match="numpy arrays and ints"):
        graphs.spec_of(1.5)
