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
code with the model's forward. The paged pool, chunked prefill and int8
pages come later in the port.
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


def cache_nbytes(plan: DecodePlan, *, max_batch: int, max_len: int,
                 dtype=torch.float32) -> int:
    """Device memory the cache will pin, for capacity planning / logs."""
    n = (2 * plan.num_layers * max_batch * plan.num_heads * max_len
         * plan.key_dim)
    return n * torch.empty((), dtype=dtype).element_size()


def init_cache(plan: DecodePlan, *, max_batch: int, max_len: int,
               dtype=torch.float32, device="cpu") -> dict:
    """Zeros cache: ``k``/``v`` of
    ``[num_layers, max_batch, num_heads, max_len, key_dim]`` on ``device``.
    """
    if max_len > plan.max_position:
        raise ValueError(
            f"max_len {max_len} exceeds the model's positional table "
            f"({plan.max_position})")
    shape = (plan.num_layers, max_batch, plan.num_heads, max_len,
             plan.key_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(plan: DecodePlan, cache: dict, tokens, length: int, slot: int,
            *, attention_fn: Optional[Callable] = None):
    """Full causal forward over one padded prompt, filling cache slot
    ``slot`` in place.

    Args:
      tokens: int ``[pad_len]`` prompt on the cache's device, padded past
        ``length`` with any token id (padded positions' K/V land in the
        cache but decode's validity mask never reads them before they are
        overwritten).
      length: number of valid prompt tokens (>= 1).
      slot: cache row to fill.
      attention_fn: override for the prefill attention inner loop
        (signature ``fn(q, k, v, causal=..., scale=...)``); defaults to the
        model's dispatch — the flash kernel for CUDA tensors.

    Returns:
      logits ``[vocab]`` of position ``length - 1``, i.e. the
      distribution over the first generated token.
    """
    attend = attention_fn or _default_attention
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
                cache[name][idx, slot, :, :pad_len] = new[0]
            x = layer.out(out)
        else:  # "embed" / "pos" / "point": the layer's own forward
            x = op[1](x)
    return x[0, max(length - 1, 0)]


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
            x = x + op[1].table[pos].to(x.dtype)[:, None, :]
        elif tag == "attn":
            _, layer, idx = op
            q, k, v = layer.qkv(x)        # [b, H, 1, dk]
            # Append at each slot's length: advanced indices around the
            # head slice put the [b] dim first -> [b, H, dk].
            cache["k"][idx][rows, :, pos] = k[:, :, 0, :].to(
                cache["k"].dtype)
            cache["v"][idx][rows, :, pos] = v[:, :, 0, :].to(
                cache["v"].dtype)
            keys = cache["k"][idx, :bucket]   # [b, H, S, dk]
            vals = cache["v"][idx, :bucket]
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                             keys.float()) * (1.0 / math.sqrt(layer.key_dim))
            s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
            prob = torch.softmax(s, dim=-1)
            out = torch.einsum("bhqk,bhkd->bhqd", prob,
                               vals.float()).to(q.dtype)
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
