"""The port's host-side paging (``tpu_dist_torch/serve/paging.py``) and the
paged pool's sizing against the reference.

One seeded random sequence of operations — allocator, prefix cache and the
``PagedKVState`` facade mixed — drives both modules; every result, error
text and state snapshot (page tables, free lists, refcounts,
reservations, the prefix cache's nodes, digests, metrics) must be
identical. The sizing functions and the budget guards' messages must
match for fp32, bf16 and int8.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist.models.transformer import build_transformer_lm as jbuild
from tpu_dist.observe import metrics as jmetrics
from tpu_dist.serve import kv_cache as jkv
from tpu_dist.serve import paging as jpaging
from tpu_dist_torch.models import transformer as tr
from tpu_dist_torch.observe import metrics
from tpu_dist_torch.serve import kv_cache, paging

PS, PAGES, SLOTS, MAX_PAGES = 4, 14, 4, 6
#: Three base prompts; most drawn prompts extend one, so lookups hit.
_BASES = ([3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1, 8, 2, 8], [1, 1, 2, 3])
_OPS = ("admit", "begin", "extend", "register_prefill", "prepare_append",
        "finish", "swap", "alloc", "attach", "retain", "release", "cow",
        "reserve", "bind", "lookup", "register_full", "register_partial",
        "evict", "digest", "check", "note_usage")


def _prompt(rng):
    base = list(_BASES[int(rng.integers(len(_BASES)))])
    if rng.random() < 0.2:
        base = base[:int(rng.integers(1, len(base) + 1))]
    return base + rng.integers(0, 6, size=int(rng.integers(0, 8))).tolist()


def _snapshot(state):
    a = state.allocator
    nodes = lambda d: sorted((k, (n.page, n.parent, n.tokens, n.children,
                                  n.tick)) for k, n in d.items())
    return (a.table.tolist(), list(a._free), a.refcount.tolist(),
            a.count.tolist(), a.reserved.tolist(), a.pending_reserved,
            a.headroom(), nodes(state.prefix._full),
            nodes(state.prefix._partial), state.prefix.hits,
            state.prefix.misses, state.prefix.pages_held)


def _drive(mod, metrics_mod, seed, steps=320):
    """Run one seeded op sequence on ``mod``'s ``PagedKVState``; returns
    the trace of (op, arguments, result or error text, state)."""
    metrics_mod.get_registry().reset()
    metrics_mod.enable()
    try:
        rng = np.random.default_rng(seed)
        state = mod.PagedKVState(num_pages=PAGES, page_size=PS,
                                 slots=SLOTS, max_pages=MAX_PAGES,
                                 bytes_per_token=24, prefix_caching=True)
        alloc, prefix = state.allocator, state.prefix
        prompts = {}
        trace = []
        for _ in range(steps):
            op = _OPS[int(rng.integers(len(_OPS)))]
            busy = [s for s in range(SLOTS) if alloc.count[s] > 0]
            empty = [s for s in range(SLOTS) if alloc.count[s] == 0]
            held = [p for p in range(PAGES) if alloc.refcount[p] > 0]
            slot = int(rng.integers(SLOTS))
            args, out = None, None
            try:
                if op == "admit":
                    args = (int(rng.integers(1, 24)),)
                    out = state.try_admit(*args)
                elif op == "begin" and empty:
                    slot = empty[int(rng.integers(len(empty)))]
                    seq = _prompt(rng)
                    chunk = int(rng.choice([0, 0, 4, 8]))
                    args = (slot, seq, len(seq) + int(rng.integers(0, 6)),
                            chunk)
                    setup = state.begin(slot, seq, args[2], chunk=chunk)
                    prompts[slot] = seq
                    out = (setup.start, setup.copies)
                elif op == "extend" and busy:
                    slot = busy[int(rng.integers(len(busy)))]
                    args = (slot, int(rng.integers(1, PS * MAX_PAGES)))
                    state.extend_prefill(*args)
                elif op == "register_prefill" and busy:
                    slot = busy[int(rng.integers(len(busy)))]
                    args = (slot,)
                    state.register_prefill(slot, prompts.get(slot) or [1])
                elif op == "prepare_append" and busy:
                    slot = busy[int(rng.integers(len(busy)))]
                    n = int(alloc.count[slot]) * PS
                    args = (slot, int(rng.integers(max(n - PS, 0), n + 1)))
                    out = state.prepare_append(*args)
                elif op == "finish" and busy:
                    slot = busy[int(rng.integers(len(busy)))]
                    upto = (None if rng.random() < 0.5
                            else int(rng.integers(0, 20)))
                    args = (slot, upto)
                    state.finish(slot, prompts.get(slot) or [1], upto=upto)
                elif op == "swap":
                    args = (slot, int(rng.integers(SLOTS)))
                    state.swap_slots(*args)
                    prompts[args[0]], prompts[args[1]] = (
                        prompts.get(args[1]), prompts.get(args[0]))
                elif op == "alloc":
                    args = (slot,)
                    out = alloc.alloc(slot)
                elif op == "attach" and held:
                    pages = [int(p) for p in rng.choice(
                        held, size=int(rng.integers(1, 3)))]
                    args = (slot, pages, bool(rng.random() < 0.7))
                    alloc.attach(slot, pages, full=args[2])
                elif op == "retain" and held:
                    args = (int(rng.choice(held)),)
                    alloc.retain(*args)
                elif op == "release" and held:
                    args = (int(rng.choice(held)),)
                    alloc.release_page(*args)
                elif op == "cow" and busy:
                    slot = busy[int(rng.integers(len(busy)))]
                    args = (slot, int(rng.integers(alloc.count[slot])))
                    out = alloc.cow(*args)
                elif op == "reserve":
                    args = (int(rng.integers(1, 6)),)
                    alloc.reserve_pending(*args)
                elif op == "bind":
                    args = (slot, int(rng.integers(0, 4)))
                    alloc.bind_reservation(*args)
                elif op == "lookup":
                    args = (_prompt(rng),)
                    out = prefix.lookup(*args)
                elif op == "register_full":
                    seq = prompts.get(slot) or _prompt(rng)
                    args = (slot, seq, int(rng.integers(0, len(seq) + 1)))
                    prefix.register_full(seq, alloc.table[slot],
                                         upto=args[2])
                elif op == "register_partial":
                    seq = prompts.get(slot) or _prompt(rng)
                    args = (slot, seq)
                    prefix.register_partial(seq, alloc.table[slot])
                elif op == "evict":
                    args = (int(rng.integers(1, 5)),)
                    out = prefix.evict(*args)
                elif op == "digest":
                    args = (_prompt(rng), int(rng.integers(1, 6)))
                    out = mod.PrefixCache.prompt_digest(*args)
                elif op == "check":
                    args = ()
                    alloc.check()
                elif op == "note_usage":
                    args = ()
                    state.note_usage()
            except (mod.PageExhaustedError, ValueError,
                    AssertionError) as e:
                out = (type(e).__name__, str(e))
            trace.append((op, repr(args), repr(out), _snapshot(state)))
        return trace, metrics_mod.get_registry().snapshot()
    finally:
        metrics_mod.disable()
        metrics_mod.get_registry().reset()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_operation_sequence_matches_reference(seed):
    got, got_metrics = _drive(paging, metrics, seed)
    want, want_metrics = _drive(jpaging, jmetrics, seed)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"step {i} ({a[0]}) differs"
    assert len(got) == len(want)
    assert got_metrics == want_metrics
    # The sequence ran every op, hit the prefix cache, copied on write
    # and raised.
    assert {t[0] for t in got if t[1] != "None"} == set(_OPS)
    assert any(t[0] == "lookup" and not t[2].startswith("([]")
               for t in got)
    assert any(t[0] == "cow" and re.fullmatch(r"\(\d+, \d+\)", t[2])
               for t in got)
    assert any("Error" in t[2] for t in got)


def test_exhaustion_texts_match_reference():
    def run(mod):
        a = mod.PageAllocator(num_pages=2, page_size=4, slots=2,
                              max_pages=2)
        texts = []
        for fn in (lambda: [a.alloc(0) for _ in range(3)],
                   lambda: a.reserve_pending(5),
                   lambda: a.attach(0, [0]),
                   lambda: mod.PagedKVState(
                       num_pages=1, page_size=4, slots=1, max_pages=2,
                       bytes_per_token=8).check_fits(9),
                   lambda: mod.PageAllocator(num_pages=0, page_size=4,
                                             slots=1, max_pages=1),
                   lambda: mod.PrefixCache.prompt_digest([1], 0)):
            with pytest.raises((mod.PageExhaustedError, ValueError)) as e:
                fn()
            texts.append((type(e.value).__name__, str(e.value)))
        return texts

    assert run(paging) == run(jpaging)


def _plans(d_model=16, depth=2, num_heads=2, seq=32):
    jmodel = jbuild(32, seq, d_model=d_model, depth=depth,
                    num_heads=num_heads)
    model = tr.build_transformer_lm(32, seq, d_model=d_model, depth=depth,
                                    num_heads=num_heads)
    return jkv.build_plan(jmodel), kv_cache.build_plan(model)


_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16),
           "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_sizing_matches_reference(dtype):
    jdt, dt = _DTYPES[dtype]
    for dims in ((16, 2, 2), (128, 1, 2), (512, 4, 8)):
        jplan, plan = _plans(*dims)
        for ps in (4, 16):
            assert kv_cache.page_nbytes(plan, page_size=ps, dtype=dt) == \
                jkv.page_nbytes(jplan, page_size=ps, dtype=jdt)
            assert kv_cache.page_pool_nbytes(
                plan, num_pages=9, page_size=ps, dtype=dt) == \
                jkv.page_pool_nbytes(jplan, num_pages=9, page_size=ps,
                                     dtype=jdt)
            for budget in (0, 1000, 2**20, 64 * 2**20):
                assert kv_cache.pages_for_budget(
                    plan, page_size=ps, budget_bytes=budget, dtype=dt) == \
                    jkv.pages_for_budget(jplan, page_size=ps,
                                         budget_bytes=budget, dtype=jdt)
        if dtype != "int8":
            assert kv_cache.cache_nbytes(plan, max_batch=8, max_len=32,
                                         dtype=dt) == \
                jkv.cache_nbytes(jplan, max_batch=8, max_len=32, dtype=jdt)


def _error_text(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_budget_errors_match_reference(dtype):
    jdt, dt = _DTYPES[dtype]
    jplan, plan = _plans()
    per_page = kv_cache.page_nbytes(plan, page_size=4, dtype=dt)
    got = _error_text(lambda: kv_cache.init_page_pool(
        plan, num_pages=8, page_size=4, dtype=dt,
        budget_bytes=per_page * 4, device="cpu"))
    assert got == _error_text(lambda: jkv.init_page_pool(
        jplan, num_pages=8, page_size=4, dtype=jdt,
        budget_bytes=per_page * 4))
    assert "fits 3 page" in got
    pool = kv_cache.init_page_pool(plan, num_pages=3, page_size=4, dtype=dt,
                                   budget_bytes=per_page * 4, device="cpu")
    jpool = jkv.init_page_pool(jplan, num_pages=3, page_size=4, dtype=jdt)
    assert sorted(pool) == sorted(jpool)
    for name in pool:
        assert tuple(pool[name].shape) == jpool[name].shape
        assert str(pool[name].dtype)[6:] == str(jpool[name].dtype)[:8]
        assert not pool[name].any()
    if dtype == "int8":
        got = _error_text(lambda: kv_cache.init_cache(
            plan, max_batch=2, max_len=16, dtype=dt, device="cpu"))
        assert got == _error_text(lambda: jkv.init_cache(
            jplan, max_batch=2, max_len=16, dtype=jdt))
        return
    per_slot = kv_cache.cache_nbytes(plan, max_batch=1, max_len=32, dtype=dt)
    got = _error_text(lambda: kv_cache.init_cache(
        plan, max_batch=4, max_len=32, dtype=dt, budget_bytes=per_slot * 2,
        device="cpu"))
    assert got == _error_text(lambda: jkv.init_cache(
        jplan, max_batch=4, max_len=32, dtype=jdt,
        budget_bytes=per_slot * 2))
    assert "fits 2 slot" in got


@pytest.mark.parametrize("kwargs", [dict(num_pages=0, page_size=4),
                                    dict(num_pages=2, page_size=0)])
def test_pool_shape_errors_match_reference(kwargs):
    jplan, plan = _plans()
    assert _error_text(lambda: kv_cache.init_page_pool(
        plan, device="cpu", **kwargs)) == _error_text(
        lambda: jkv.init_page_pool(jplan, **kwargs))


def test_init_page_pool_defaults_to_the_card():
    """With no ``device`` the pool goes on ``cuda``; without a card that
    raises and never returns a CPU pool."""
    _, plan = _plans()
    if torch.cuda.is_available():
        pool = kv_cache.init_page_pool(plan, num_pages=2, page_size=4,
                                       dtype=torch.int8)
        assert all(a.is_cuda for a in pool.values())
    else:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            kv_cache.init_page_pool(plan, num_pages=2, page_size=4)
    with pytest.raises(ValueError, match="num_pages"):
        kv_cache.init_page_pool(plan, num_pages=0, page_size=4)
