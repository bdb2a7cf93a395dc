"""Preallocated KV cache + incremental decode for the transformer LM family.

Counterpart of the contiguous half of ``tpu_dist/serve/kv_cache.py``:

* **prefill** — one full causal forward over the (padded) prompt, routed
  through the same attention dispatch as the model's forward
  (``transformer._default_attention``: the hand-written flash kernel for
  CUDA tensors, its plain version for CPU tensors), writing every
  layer's K/V into one cache slot as it goes. Returns the logits of the
  last *valid* prompt position — the first generated token.
* **decode_step** — one token per slot of a bucket: Q/K/V for the new
  position only, K/V appended at each slot's current length, attention
  against the cached keys/values under the per-slot mask
  ``key_pos <= pos``, so rows left over from an earlier request or from
  prompt padding are never read.

The cache is ``{"k": [layers, slots, heads, max_len, key_dim], "v": ...}``
on the model's device. Where the reference donates the cache buffer into
each compiled program, the port **updates it in place** (slice and index
assignment): :func:`prefill`, :func:`decode_step` and :func:`swap_slots`
mutate the dict's tensors and return no new cache.

The interpreter is built from a :func:`build_plan` walk over the
``Sequential``'s module tree and reuses each layer's own forward (and
``MultiHeadAttention.qkv``/``out``), so the decode path shares weights and
code with the model's forward.

The second half is the **paged pool** (the reference's paged half of the
same module): ``{"k", "v"}`` of ``[layers, num_pages + 1, heads,
page_size, key_dim]`` addressed through per-slot page tables that
``serve/paging.py`` keeps on the host, plus ``k_scale``/``v_scale`` planes
for an int8 pool. :func:`paged_prefill` (cold, suffix after a prefix hit,
or one chunk), :func:`paged_decode_step` and :func:`copy_page` update the
pool in place; :func:`prefill_chunk_step` is the contiguous cache's chunk
step; :func:`paged_decode_ragged` decodes every slot of the engine at once
under an active mask. As in the reference these compute attention with
dense einsums over the gathered pages under the ``key_pos <= pos`` mask,
not with the flash kernel (the reference's paged path reaches no Pallas
kernel).

The scalar arguments of the prefills (``length``, ``slot``, ``start``) are
Python ints or 0-d integer tensors on the cache's device. Either becomes a
0-d tensor at entry and is used only through index ops, never read on the
host, so one CUDA graph of a prefill at a pad (``utils/graphs.py``) serves
every request.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from tpu_dist_torch.models.layers import Block, Dense, Layer, Residual
from tpu_dist_torch.models.layers import _activation
from tpu_dist_torch.models.model import Sequential
from tpu_dist_torch.models.transformer import (Embedding, LayerNormalization,
                                               MultiHeadAttention,
                                               PositionalEmbedding,
                                               _default_attention)
from tpu_dist_torch.utils.device import DeviceLike, resolve_device

#: Plan ops are tuples: ("embed"|"pos"|"point", layer),
#: ("attn", layer, cache_layer_index), ("res_start",),
#: ("res_end", activation_name).
_POINTWISE = (LayerNormalization, Dense)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Decode description of one servable Sequential."""

    ops: tuple
    num_layers: int  #: attention layers == KV-cache depth
    num_heads: int
    key_dim: int
    max_position: int  #: PositionalEmbedding.max_len — hard cap on length
    vocab_size: int


def _unsupported(layer: Layer, why: str) -> TypeError:
    return TypeError(
        f"serve: {type(layer).__name__} is not servable ({why}); the KV-"
        "cache decode path covers the build_transformer_lm family — "
        "token/positional embeddings, pre-LN blocks with causal attention, "
        "LayerNorm and Dense layers")


def build_plan(model: Sequential) -> DecodePlan:
    """Flatten a Sequential into decode ops, validating servability."""
    if not isinstance(model, Sequential):
        raise TypeError(
            f"serve supports Sequential models, got {type(model).__name__}")
    ops: list = []
    attn_layers: list[MultiHeadAttention] = []
    pos_layers: list[PositionalEmbedding] = []

    def walk(layers):
        for layer in layers:
            if isinstance(layer, Embedding):
                ops.append(("embed", layer))
            elif isinstance(layer, PositionalEmbedding):
                pos_layers.append(layer)
                ops.append(("pos", layer))
            elif isinstance(layer, MultiHeadAttention):
                if not layer.causal:
                    raise _unsupported(
                        layer, "non-causal attention cannot decode "
                        "incrementally — future tokens would change past "
                        "activations")
                ops.append(("attn", layer, len(attn_layers)))
                attn_layers.append(layer)
            elif isinstance(layer, Residual):
                if len(layer.shortcut):
                    raise _unsupported(
                        layer, "projection shortcuts are a ResNet shape, "
                        "not a transformer residual")
                ops.append(("res_start",))
                walk(layer.main.values())
                ops.append(("res_end", layer.activation))
            elif isinstance(layer, Block):
                walk(layer.layers)
            elif isinstance(layer, _POINTWISE):
                ops.append(("point", layer))
            else:
                raise _unsupported(layer, "no decode rule for this layer")

    walk(model.layers)
    if not attn_layers:
        raise TypeError("serve: model has no attention layers to cache")
    heads = {(l.num_heads, l.key_dim) for l in attn_layers}
    if len(heads) > 1:
        raise TypeError(
            f"serve: attention layers disagree on (num_heads, key_dim) "
            f"({sorted(heads)}); a stacked KV cache needs uniform shapes")
    last = model.layers[-1]
    if not isinstance(last, Dense):
        raise TypeError(
            "serve: expected a Dense vocabulary head as the final layer, "
            f"got {type(last).__name__}")
    (num_heads, key_dim), = heads
    max_position = min((l.max_len for l in pos_layers), default=2 ** 30)
    return DecodePlan(ops=tuple(ops), num_layers=len(attn_layers),
                      num_heads=num_heads, key_dim=key_dim,
                      max_position=max_position, vocab_size=last.units)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def cache_nbytes(plan: DecodePlan, *, max_batch: int, max_len: int,
                 dtype=torch.float32) -> int:
    """Device memory the cache will pin, for capacity planning / logs."""
    n = (2 * plan.num_layers * max_batch * plan.num_heads * max_len
         * plan.key_dim)
    return n * _itemsize(dtype)


def init_cache(plan: DecodePlan, *, max_batch: int, max_len: int,
               dtype=torch.float32, budget_bytes: Optional[int] = None,
               device: DeviceLike = None) -> dict:
    """Zeros cache: ``k``/``v`` of
    ``[num_layers, max_batch, num_heads, max_len, key_dim]`` on ``device``
    (``None`` means ``cuda``, which must exist; pass ``device="cpu"`` for
    the CPU), as the reference allocates on its default accelerator.

    ``budget_bytes`` turns the advisory :func:`cache_nbytes` math into a
    hard guard: when the cache would not fit, raise a loud error naming
    how many slots DO fit instead of running out of memory later.
    """
    if dtype == torch.int8:
        raise ValueError(
            "serve: int8 KV is a paged-pool feature (the quantized pages "
            "carry per-page scale rows the contiguous cache has no layout "
            "for) — use ServeEngine(paged=True, kv_dtype='int8')")
    if max_len > plan.max_position:
        raise ValueError(
            f"max_len {max_len} exceeds the model's positional table "
            f"({plan.max_position})")
    if budget_bytes is not None:
        need = cache_nbytes(plan, max_batch=max_batch, max_len=max_len,
                            dtype=dtype)
        if need > budget_bytes:
            per_slot = need // max_batch
            fits = int(budget_bytes // per_slot)
            raise ValueError(
                f"serve: contiguous KV cache needs {need} B for "
                f"{max_batch} slots x {max_len} positions but "
                f"budget_bytes={budget_bytes} — at this max_len the "
                f"budget fits {fits} slot(s). Lower max_batch/max_len, "
                "raise the budget, or switch to the paged cache "
                "(ServeEngine(paged=True)), which allocates per page "
                "instead of max_len per slot.")
    device = resolve_device(device)
    shape = (plan.num_layers, max_batch, plan.num_heads, max_len,
             plan.key_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _scalar(v, device) -> torch.Tensor:
    """A prefill's scalar argument (an int or a 0-d integer tensor) as a
    0-d int64 tensor on ``device``; the prefills use it only through index
    ops, never read on the host."""
    return torch.as_tensor(v, dtype=torch.long, device=device)


def _take(x, i):
    """``x[i]`` along dim 0 for a 0-d integer tensor ``i``: an index op
    (PyTorch reads a 0-d tensor index on the host)."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def _last(n):
    """``max(n - 1, 0)`` of a 0-d integer tensor: the index of the last of
    ``n`` positions."""
    return torch.clamp(n - 1, min=0)


def prefill(plan: DecodePlan, cache: dict, tokens, length, slot, *,
            attention_fn: Optional[Callable] = None):
    """Full causal forward over one padded prompt, filling cache slot
    ``slot`` in place.

    Args:
      tokens: int ``[pad_len]`` prompt on the cache's device, padded past
        ``length`` with any token id (padded positions' K/V land in the
        cache but decode's validity mask never reads them before they are
        overwritten).
      length: number of valid prompt tokens (>= 1), an int or a 0-d
        integer tensor on the cache's device (as ``slot``).
      slot: cache row to fill.
      attention_fn: override for the prefill attention inner loop
        (signature ``fn(q, k, v, causal=..., scale=...)``); defaults to the
        model's dispatch — the flash kernel for CUDA tensors.

    Returns:
      logits ``[vocab]`` of position ``length - 1``, i.e. the
      distribution over the first generated token.
    """
    attend = attention_fn or _default_attention
    length = _scalar(length, tokens.device)
    slot = _scalar(slot, tokens.device)
    x = tokens[None]  # [1, pad_len]
    pad_len = tokens.shape[0]
    residuals: list = []
    for op in plan.ops:
        tag = op[0]
        if tag == "res_start":
            residuals.append(x)
        elif tag == "res_end":
            x = _activation(op[1])(residuals.pop() + x)
        elif tag == "attn":
            _, layer, idx = op
            q, k, v = layer.qkv(x)  # [1, H, pad_len, dk]
            out = attend(q, k, v, causal=True,
                         scale=1.0 / math.sqrt(layer.key_dim))
            for name, new in (("k", k), ("v", v)):
                cache[name][idx, :, :, :pad_len].index_copy_(
                    0, slot.reshape(1), new.to(cache[name].dtype))
            x = layer.out(out)
        else:  # "embed" / "pos" / "point": the layer's own forward
            x = op[1](x)
    return _take(x[0], _last(length))


def _abs_positions(op, x, pos):
    """The positional table at absolute positions ``pos`` (clamped into
    the table), added to ``x`` — a suffix or a chunk starts past 0."""
    table = op[1].table
    at = torch.clamp(pos, max=table.shape[0] - 1)
    return x + table[at].to(x.dtype)


def _masked_attention(q, keys, vals, mask, key_dim: int):
    """fp32 softmax attention of ``q`` ``[.., H, Lq, dk]`` over gathered
    ``keys``/``vals`` ``[.., H, S, dk]`` under ``mask`` (broadcast to
    ``[.., H, Lq, S]``); returns ``[.., H, Lq, dk]`` in ``q``'s dtype."""
    s = torch.einsum("...qd,...kd->...qk", q.float(),
                     keys.float()) * (1.0 / math.sqrt(key_dim))
    s = s.masked_fill(~mask, float("-inf"))
    prob = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", prob,
                        vals.float()).to(q.dtype)


def prefill_chunk_step(plan: DecodePlan, cache: dict, tokens, length, slot,
                       start):
    """Causal forward over ONE chunk of a prompt — the contiguous-cache
    half of chunked prefill; the cache is updated in place.

    The first ``start`` positions' K/V are already in cache slot ``slot``
    (written by earlier chunks); this pass computes positions ``start ..
    length - 1``, writes their K/V at window ``[start, start + pad)`` and
    attends each chunk query over the whole cached row under the
    absolute-position causal mask — what a full prefill computes for
    those positions, so chunked and whole-prompt prefill stay
    token-identical.

    Args:
      tokens: int ``[chunk_pad]`` chunk tokens for absolute positions
        ``start .. length - 1``, padded past ``length - start``. Padded
        positions write garbage K/V at ``[length, start + chunk_pad)``,
        beyond every mask until a later chunk or a decode append
        overwrites them. ``start + chunk_pad`` must not pass ``max_len``.
      length: total valid positions through the end of this chunk.
      slot: cache row.
      start: already-cached positions (``< length``). ``length``, ``slot``
        and ``start`` are ints or 0-d integer tensors on the cache's
        device; the window check below needs an int ``start`` (the
        engine's windows never run past the row: its chunk divides
        ``max_len``).

    Returns:
      logits ``[vocab]`` of position ``length - 1``.
    """
    pad = tokens.shape[0]
    max_len = cache["k"].shape[3]
    if not isinstance(start, torch.Tensor) and start + pad > max_len:
        raise ValueError(
            f"serve: chunk window [{start}, {start + pad}) runs past the "
            f"{max_len}-position cache row")
    dev = tokens.device
    length, slot, start = (_scalar(a, dev) for a in (length, slot, start))
    x = tokens[None]                       # [1, pad]
    pos = start + torch.arange(pad, device=dev)
    mask = (torch.arange(max_len, device=dev)[None, :]
            <= pos[:, None])               # [pad, S]
    residuals: list = []
    for op in plan.ops:
        tag = op[0]
        if tag == "res_start":
            residuals.append(x)
        elif tag == "res_end":
            x = _activation(op[1])(residuals.pop() + x)
        elif tag == "pos":
            x = _abs_positions(op, x, pos[None])
        elif tag == "attn":
            _, layer, idx = op
            q, k, v = layer.qkv(x)         # [1, H, pad, dk]
            for name, new in (("k", k), ("v", v)):
                # The window's positions as an index: [pad, H, dk].
                _write_rows(cache, name, idx, slot.reshape(1), pos,
                            new[0].movedim(1, 0))
            out = _masked_attention(q[0], _take(cache["k"][idx], slot),
                                    _take(cache["v"][idx], slot), mask,
                                    layer.key_dim)
            x = layer.out(out[None])
        else:  # "embed" / "point"
            x = op[1](x)
    return _take(x[0], _last(length - start))


def decode_step(plan: DecodePlan, cache: dict, tokens, lengths, *,
                bucket: int):
    """One generated token for the first ``bucket`` cache slots; the cache
    is updated in place.

    Args:
      tokens: int ``[cap]`` — each slot's most recent token (prompt tail or
        last generated); only ``[:bucket]`` is read.
      lengths: int ``[cap]`` — tokens already cached per slot; the new
        token is written at this position. Only ``[:bucket]`` is read.
      bucket: slot count this step covers (a scheduler bucket).

    Returns:
      logits ``[bucket, vocab]`` fp32.
    """
    x = tokens[:bucket][:, None]          # [b, 1]
    pos = lengths[:bucket].long()         # [b]
    rows = torch.arange(bucket, device=pos.device)
    max_len = cache["k"].shape[3]
    valid = (torch.arange(max_len, device=pos.device)[None, :]
             <= pos[:, None])             # [b, S]: cached prefix + new key
    residuals: list = []
    for op in plan.ops:
        tag = op[0]
        if tag == "res_start":
            residuals.append(x)
        elif tag == "res_end":
            x = _activation(op[1])(residuals.pop() + x)
        elif tag == "pos":
            x = _abs_positions(op, x, pos[:, None])
        elif tag == "attn":
            _, layer, idx = op
            q, k, v = layer.qkv(x)        # [b, H, 1, dk]
            # Append at each slot's length.
            _write_rows(cache, "k", idx, rows, pos, k[:, :, 0, :])
            _write_rows(cache, "v", idx, rows, pos, v[:, :, 0, :])
            out = _masked_attention(q, cache["k"][idx, :bucket],
                                    cache["v"][idx, :bucket],
                                    valid[:, None, None, :], layer.key_dim)
            x = layer.out(out)
        else:  # "embed" / "point"
            x = op[1](x)
    return x[:, 0, :].float()  # [b, vocab]


def swap_slots(cache: dict, i: int, j: int) -> None:
    """Exchange cache rows ``i`` and ``j`` (every layer, k and v) in place —
    the scheduler's compaction move, keeping active slots a contiguous
    prefix so smaller buckets stay usable."""
    for a in cache.values():
        row = a[:, i].clone()
        a[:, i] = a[:, j]
        a[:, j] = row


# -- paged cache --------------------------------------------------------------
#
# The pool replaces the contiguous [layers, slots, heads, max_len, key_dim]
# preallocation with fixed-size pages — [layers, num_pages + 1, heads,
# page_size, key_dim] — addressed through a per-slot page table of page
# indices (host-managed by serve/paging.py). Row ``num_pages`` is a
# reserved scratch page: every index computed for an invalid position
# (prompt padding, inactive decode slots) is routed there, so garbage
# writes land where nothing ever reads. A key at flattened gather position
# j of a slot's table is absolute sequence position j, so the contiguous
# validity mask ``arange <= pos`` carries over unchanged.
#
# int8 pool (``dtype=torch.int8``): pages store K/V as int8 with fp32
# per-position scale ROWS — ``k_scale``/``v_scale`` of ``[num_layers,
# num_pages + 1, num_heads, page_size]``, one amax-derived symmetric scale
# per written position per head. Quantization happens at write time and
# dequantization inside the page gather, so the fp32 attention downstream
# is the float path on the dequantized values. Scaling per position makes
# a position's stored bytes depend only on its own K/V projection, never
# on what else landed in the page, so chunked prefill reproduces
# whole-prompt prefill byte for byte.

#: Symmetric int8 range; scale = amax / _QMAX, values in [-127, 127].
_QMAX = 127.0


def _quantized(pool: dict) -> bool:
    """True for an int8 pool (fp32 scale planes present)."""
    return "k_scale" in pool


def _quant_rows(x):
    """Quantize ``[..., dk]`` rows to (int8 ``[..., dk]``, fp32 scale
    ``[...]``) — one symmetric amax scale per row. All-zero rows get
    scale 1 so they round-trip to exact zeros. The order is the
    reference's: divide by the scale, round half to even, clip, cast."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / _QMAX
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def page_nbytes(plan: DecodePlan, *, page_size: int,
                dtype=torch.float32) -> int:
    """Device memory one page pins across every layer, k and v. An int8
    page also carries its fp32 scale rows (k and v, per head per
    position)."""
    n = 2 * plan.num_layers * plan.num_heads * page_size * plan.key_dim
    if dtype == torch.int8:
        scales = 2 * plan.num_layers * plan.num_heads * page_size * 4
        return n * _itemsize(dtype) + scales
    return n * _itemsize(dtype)


def page_pool_nbytes(plan: DecodePlan, *, num_pages: int, page_size: int,
                     dtype=torch.float32) -> int:
    """Device memory the pool will pin, scratch page included."""
    return page_nbytes(plan, page_size=page_size, dtype=dtype) \
        * (num_pages + 1)


def pages_for_budget(plan: DecodePlan, *, page_size: int, budget_bytes: int,
                     dtype=torch.float32) -> int:
    """Largest ``num_pages`` whose pool (plus scratch) fits the budget."""
    per = page_nbytes(plan, page_size=page_size, dtype=dtype)
    return max(int(budget_bytes // per) - 1, 0)


def init_page_pool(plan: DecodePlan, *, num_pages: int, page_size: int,
                   dtype=torch.float32, budget_bytes: Optional[int] = None,
                   device: DeviceLike = None) -> dict:
    """Zeros page pool: ``k``/``v`` of
    ``[num_layers, num_pages + 1, num_heads, page_size, key_dim]`` on
    ``device`` (``None`` means ``cuda``, which must exist) — the extra
    row is the write-off scratch page. An int8 pool adds fp32
    ``k_scale``/``v_scale`` of ``[num_layers, num_pages + 1, num_heads,
    page_size]``.

    Like :func:`init_cache`, ``budget_bytes`` raises a loud sizing error
    (how many pages DO fit) instead of running out of memory later.
    """
    if num_pages < 1:
        raise ValueError(f"num_pages must be >= 1, got {num_pages}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if budget_bytes is not None:
        need = page_pool_nbytes(plan, num_pages=num_pages,
                                page_size=page_size, dtype=dtype)
        if need > budget_bytes:
            fits = pages_for_budget(plan, page_size=page_size,
                                    budget_bytes=budget_bytes, dtype=dtype)
            raise ValueError(
                f"serve: page pool needs {need} B for {num_pages} pages of "
                f"{page_size} positions (plus the scratch page) but "
                f"budget_bytes={budget_bytes} — the budget fits {fits} "
                "page(s). Lower num_pages/page_size or raise the budget.")
    device = resolve_device(device)
    shape = (plan.num_layers, num_pages + 1, plan.num_heads, page_size,
             plan.key_dim)
    pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        # Zero pages decode to exact zeros under any scale; real scales
        # are written alongside every K/V write.
        pool["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
        pool["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    return pool


def _gather_pages(pool_arr, layer_idx: int, page_rows):
    """Flatten one layer's pages into position order.

    ``pool_arr``: ``[L, P, H, ps, dk]``; ``page_rows``: int
    ``[..., max_pages]`` page-table row(s). Returns
    ``[..., H, max_pages * ps, dk]`` where flattened index j holds
    absolute position j of that slot's sequence (unallocated entries
    point at scratch, whose garbage the caller's mask never admits).
    """
    g = pool_arr[layer_idx][page_rows]     # [..., max_pages, H, ps, dk]
    g = g.movedim(-3, -4)                  # [..., H, max_pages, ps, dk]
    *lead, h, mp, ps, dk = g.shape
    return g.reshape(*lead, h, mp * ps, dk)


def _gather_kv(pool: dict, name: str, layer_idx: int, page_rows):
    """Position-ordered gather of ``pool[name]``, dequantized for int8
    pools (int8 payload x per-position fp32 scale row -> fp32); float
    pools pass straight through :func:`_gather_pages`."""
    g = _gather_pages(pool[name], layer_idx, page_rows)
    if not _quantized(pool):
        return g
    s = pool[name + "_scale"][layer_idx][page_rows]  # [..., mp, H, ps]
    s = s.movedim(-2, -3)                            # [..., H, mp, ps]
    *lead, h, mp, ps = s.shape
    return g.float() * s.reshape(*lead, h, mp * ps)[..., None]


def _write_rows(pool: dict, name: str, layer_idx: int, pg, off, rows):
    """Scatter ``rows`` ``[n, H, dk]`` to (page or slot ``pg[i]``,
    position ``off[i]``) of one layer of a pool or cache (the advanced
    indices around the head slice put the ``[n]`` dim first), quantizing
    for an int8 pool. Returns the int8 payload and scales (None for a
    float pool)."""
    if _quantized(pool):
        qv, sc = _quant_rows(rows)
        pool[name][layer_idx][pg, :, off] = qv
        pool[name + "_scale"][layer_idx][pg, :, off] = sc
        return qv, sc
    pool[name][layer_idx][pg, :, off] = rows.to(pool[name].dtype)
    return None, None


def paged_prefill(plan: DecodePlan, pool: dict, page_row, tokens, length,
                  start):
    """Causal forward over the UNCACHED suffix of one prompt, writing K/V
    through the page table into ``pool`` in place.

    With a prefix-cache hit the first ``start`` positions' K/V already sit
    in (shared) pages referenced by ``page_row``; only the suffix is
    computed, attending over the gathered cached prefix plus its own
    causally-masked keys, so the result equals a full prefill. ``start=0``
    is the cold path; under chunked prefill ``start`` is the chunk
    cursor.

    Args:
      pool: page pool from :func:`init_page_pool`.
      page_row: int ``[max_pages]`` — this slot's page-table row, on the
        pool's device. Entries covering ``[0, length)`` must be real pages
        (suffix pages writable, i.e. unshared); the rest point at scratch.
      tokens: int ``[pad]`` suffix tokens for absolute positions
        ``start .. length - 1``, padded past ``length - start``.
      length: total valid positions (prefix + suffix).
      start: cached-prefix length (``< length``). ``length`` and ``start``
        are ints or 0-d integer tensors on the pool's device.

    Returns:
      logits ``[vocab]`` of position ``length - 1`` for a float pool; an
      int8 pool returns ``(logits, quant_error)``, the max-abs
      dequantization error over this call's valid suffix positions (an
      fp32 scalar tensor — the ``serve.kv.quant_error`` datum).
    """
    num_pages = pool["k"].shape[1] - 1     # last row is scratch
    ps = pool["k"].shape[3]
    max_pages = page_row.shape[0]
    pad = tokens.shape[0]
    dev = tokens.device
    length, start = _scalar(length, dev), _scalar(start, dev)
    x = tokens[None]                       # [1, pad]
    suffix = length - start
    ar = torch.arange(pad, device=dev)
    pos = start + ar                       # absolute positions [pad]
    valid_q = ar < suffix                  # [pad]
    mask = (torch.arange(max_pages * ps, device=dev)[None, :]
            <= pos[:, None])               # [pad, S]
    row = page_row.long()
    # Each suffix position's (page, offset); padding goes to scratch.
    pg = torch.where(valid_q, row[torch.clamp(pos // ps, max=max_pages - 1)],
                     num_pages)            # [pad]
    off = pos % ps
    quant = _quantized(pool)
    qerr = torch.zeros((), dtype=torch.float32, device=dev)
    residuals: list = []
    for op in plan.ops:
        tag = op[0]
        if tag == "res_start":
            residuals.append(x)
        elif tag == "res_end":
            x = _activation(op[1])(residuals.pop() + x)
        elif tag == "pos":
            x = _abs_positions(op, x, pos[None])
        elif tag == "attn":
            _, layer, idx = op
            q, k, v = layer.qkv(x)         # [1, H, pad, dk]
            for name, new in (("k", k), ("v", v)):
                rows = new[0].movedim(1, 0)              # [pad, H, dk]
                if quant:
                    rows = rows.float()
                qv, sc = _write_rows(pool, name, idx, pg, off, rows)
                if quant:
                    err = (rows - qv.float() * sc[..., None]).abs().amax(
                        dim=(1, 2))                      # [pad]
                    qerr = torch.maximum(qerr, torch.where(
                        valid_q, err, torch.zeros_like(err)).max())
            out = _masked_attention(q[0], _gather_kv(pool, "k", idx, row),
                                    _gather_kv(pool, "v", idx, row), mask,
                                    layer.key_dim)
            x = layer.out(out[None])
        else:  # "embed" / "point"
            x = op[1](x)
    last = _take(x[0], _last(suffix))
    return (last, qerr) if quant else last


def _paged_decode_core(plan: DecodePlan, pool: dict, tables, tokens, pos,
                       route):
    """Shared body of the paged decode steps; ``pool`` is updated in place.

    ``route(pg)`` maps each slot's computed tail page to its write
    destination — the identity for the bucketed path (inactive slots carry
    all-scratch table rows by host invariant); :func:`paged_decode_ragged`
    routes inactive slots to scratch instead.
    """
    ps = pool["k"].shape[3]
    max_pages = tables.shape[1]
    b = tokens.shape[0]
    dev = tokens.device
    pos = pos.long()
    tables = tables.long()
    rows = torch.arange(b, device=dev)
    valid = (torch.arange(max_pages * ps, device=dev)[None, :]
             <= pos[:, None])              # [b, S]
    # Tail-page append: clamping the table column keeps the gather in
    # range; ``route`` decides where garbage writes go.
    pg = route(tables[rows, torch.clamp(pos // ps, max=max_pages - 1)])
    off = pos % ps
    x = tokens[:, None]                    # [b, 1]
    residuals: list = []
    for op in plan.ops:
        tag = op[0]
        if tag == "res_start":
            residuals.append(x)
        elif tag == "res_end":
            x = _activation(op[1])(residuals.pop() + x)
        elif tag == "pos":
            x = _abs_positions(op, x, pos[:, None])
        elif tag == "attn":
            _, layer, idx = op
            q, k, v = layer.qkv(x)         # [b, H, 1, dk]
            _write_rows(pool, "k", idx, pg, off, k[:, :, 0, :])
            _write_rows(pool, "v", idx, pg, off, v[:, :, 0, :])
            out = _masked_attention(q, _gather_kv(pool, "k", idx, tables),
                                    _gather_kv(pool, "v", idx, tables),
                                    valid[:, None, None, :], layer.key_dim)
            x = layer.out(out)
        else:  # "embed" / "point"
            x = op[1](x)
    return x[:, 0, :].float()  # [b, vocab]


def paged_decode_step(plan: DecodePlan, pool: dict, page_tables, tokens,
                      lengths, *, bucket: int):
    """One generated token for the first ``bucket`` slots through the page
    tables; the pool is updated in place.

    The new K/V land at offset ``length % page_size`` of the slot's tail
    page ``page_tables[slot, length // page_size]``; attention then runs
    over the gathered pages under the same ``arange <= pos`` mask as the
    contiguous path. Inactive slots inside the bucket must have
    all-scratch table rows so their garbage writes are absorbed.

    Args:
      page_tables: int ``[cap, max_pages]`` on the pool's device; only
        ``[:bucket]`` is read.
      tokens / lengths / bucket: as :func:`decode_step`.

    Returns:
      logits ``[bucket, vocab]`` fp32.
    """
    return _paged_decode_core(plan, pool, page_tables[:bucket],
                              tokens[:bucket], lengths[:bucket],
                              lambda pg: pg)


def paged_decode_ragged(plan: DecodePlan, pool: dict, page_tables, tokens,
                        lengths, active):
    """One generated token for every ACTIVE slot, the whole slot capacity
    in one program; the pool is updated in place.

    The ragged replacement for the bucketed decode family: the page-table
    gather has already erased contiguity, so the batch can be every slot
    of the engine with per-slot masking — one decode program, and on CUDA
    one captured graph. Inactive rows (empty slots, and slots in the
    middle of a chunked prefill, whose table rows hold REAL pages) write
    their tail K/V to the scratch page, and their logits are never read;
    active rows compute exactly what :func:`paged_decode_step` computes for
    them, so ragged and bucketed streams are token-identical.

    Args:
      page_tables: int ``[cap, max_pages]`` on the pool's device.
      tokens / lengths: int ``[cap]``; every row is read, inactive rows'
        values are ignored.
      active: bool ``[cap]`` — the slots that really decode.

    Returns:
      logits ``[cap, vocab]`` fp32.
    """
    num_pages = pool["k"].shape[1] - 1     # last row is scratch
    return _paged_decode_core(plan, pool, page_tables, tokens, lengths,
                              lambda pg: torch.where(active, pg, num_pages))


def copy_page(pool: dict, src: int, dst: int) -> None:
    """Copy page row ``src`` over ``dst`` in place (every layer and every
    entry of the pool: k, v and an int8 pool's scale rows) — the device
    half of copy-on-write."""
    for a in pool.values():
        a[:, dst] = a[:, src]
