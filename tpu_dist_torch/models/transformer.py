"""Transformer layers and the causal LM — the subset serving and training need.

Counterpart of ``tpu_dist/models/transformer.py``: token and positional
embeddings, LayerNorm, multi-head attention behind the
:func:`_default_attention` dispatch, the pre-LN block and
:func:`build_transformer_lm`. The dispatch sends every CUDA tensor to the
hand-written Hopper kernels of ``ops/flash_attention.py`` (the forward,
and under autograd the backward pair), which raise on what they do not
take; CPU tensors get their plain PyTorch versions.

Under a model axis (``parallel/tensor.py``) a multi-head attention layer
holds this process's heads, ``num_heads / M`` of them, and the dispatch
launches the flash kernels on ``[B, H / M, L, dk]``: the port's
counterpart of the reference's ``_mesh_mapped_flash``. Each process holds
only its own shard, so the raw kernel is always safe here, where the
reference must keep GSPMD from gathering around it. ``attention_fn``
takes another attention function, e.g. ``parallel.RingAttention()`` for
ring attention over a ``seq`` axis. :func:`build_transformer_lm` stacks
its blocks into ``parallel.PipelinedBlocks`` stages (a ``pipe`` axis) or
makes them Switch blocks of ``parallel.MixtureOfExperts`` (an ``expert``
axis).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from tpu_dist_torch.models.layers import Block, Dense, Layer, Residual
from tpu_dist_torch.models.model import Sequential
from tpu_dist_torch.models.policy import compute_dtype
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import initializers


class Embedding(Layer):
    """Token embedding: int ``[.., L]`` -> float ``[.., L, dim]``."""

    def __init__(self, vocab_size: int, dim: int, init_scale: float = 0.02):
        super().__init__()
        self.vocab_size = vocab_size
        self.dim = dim
        self.init_scale = init_scale

    def init(self, gen, in_shape):
        table = self.init_scale * torch.randn(
            (self.vocab_size, self.dim), generator=gen)
        self._set_params(table=table)
        return (*in_shape, self.dim)

    def forward(self, x):
        return self.table.to(compute_dtype())[x]


class PositionalEmbedding(Layer):
    """Learned absolute positions, added to a ``[.., L, D]`` stream."""

    def __init__(self, max_len: int, init_scale: float = 0.02):
        super().__init__()
        self.max_len = max_len
        self.init_scale = init_scale

    def init(self, gen, in_shape):
        ln, d = in_shape[-2], in_shape[-1]
        if ln > self.max_len:
            raise ValueError(
                f"sequence length {ln} exceeds max_len {self.max_len}")
        self._set_params(table=self.init_scale * torch.randn(
            (self.max_len, d), generator=gen))
        return in_shape

    def forward(self, x):
        ln = x.shape[-2]
        return x + self.table[:ln].to(x.dtype)


class LayerNormalization(Layer):
    """LayerNorm over the last axis (population variance); statistics in
    float32 always."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def init(self, gen, in_shape):
        d = in_shape[-1]
        self._set_params(gamma=initializers.ones(gen, (d,)),
                         beta=initializers.zeros(gen, (d,)))
        return in_shape

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.gamma + self.beta
        return y.to(x.dtype)


def _dense_attention(q, k, v, *, causal: bool,
                     scale: Optional[float] = None):
    """Dense softmax attention on any device: the plain version, for a
    caller that asks for it (e.g. ``kv_cache.prefill``'s ``attention_fn``,
    or a layer's: ``scale`` defaults to ``1 / sqrt(key_dim)``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)[0]


def _default_attention(q, k, v, *, causal: bool,
                       scale: Optional[float] = None):
    """Attention dispatch: :func:`fa.flash_attention`, which launches the
    flash kernels on CUDA tensors (and raises on a shape or dtype they do
    not take) and computes the plain versions on CPU tensors. ``scale``
    defaults to ``1 / sqrt(key_dim)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, scale=scale)


def _bound_kwargs(fn) -> dict:
    """The keywords a ``functools.partial`` chain binds, innermost first
    with outer bindings winning (as they do at call time)."""
    chain = []
    while isinstance(fn, functools.partial):
        chain.append(fn.keywords or {})
        fn = fn.func
    bound: dict = {}
    for kw in reversed(chain):
        bound.update(kw)
    return bound


class MultiHeadAttention(Layer):
    """Multi-head self-attention on a ``[.., L, D]`` stream; ``causal``
    applies the autoregressive mask. ``attention_fn(q, k, v, causal=...)
    -> out`` (``None``: :func:`_default_attention`, the only one given
    ``scale=``) swaps the attention inner loop, e.g.
    :func:`_dense_attention` for a plain-attention twin or
    ``functools.partial(parallel.ring_attention, mesh=...)``. The layer
    forwards its own ``causal``; a partial chain that binds ``causal=``
    must agree with it (the call then passes none) or the forward raises.
    As in the reference, a model holding one does not serialize, but for a
    ``parallel.RingAttention``. Under a model axis :attr:`shard`
    (``parallel/tensor.ModelShard``) is set: the projections hold this
    process's heads, the input's gradient and the output's partial sums
    are reduced over the axis."""

    def __init__(self, num_heads: int, key_dim: int, causal: bool = False,
                 use_bias: bool = True,
                 kernel_initializer: str = "glorot_uniform",
                 attention_fn: Optional[Callable] = None):
        super().__init__()
        self.attention_fn = attention_fn or _default_attention
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.causal = causal
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.shard = None

    def config(self) -> dict:
        fn = self.attention_fn
        return {**super().config(),
                "attention_fn": None if fn is _default_attention else fn}

    def init(self, gen, in_shape):
        d = in_shape[-1]
        hd = self.num_heads * self.key_dim
        mk = initializers.get(self.kernel_initializer)
        self._set_params(wq=mk(gen, (d, hd)), wk=mk(gen, (d, hd)),
                         wv=mk(gen, (d, hd)), wo=mk(gen, (hd, d)))
        if self.use_bias:
            self._set_params(bq=torch.zeros(hd), bk=torch.zeros(hd),
                             bv=torch.zeros(hd), bo=torch.zeros(d))
        return in_shape

    def _heads(self, x, w, b):
        """``[.., L, D] -> [.., H, L, key_dim]``: the ``H * key_dim``
        projection columns split as ``(H, key_dim)``, heads before L (H
        this process's heads under a model axis)."""
        y = x @ w.to(x.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        *lead, ln, _ = y.shape
        y = y.reshape(*lead, ln, -1, self.key_dim)
        return y.movedim(-2, -3)

    def qkv(self, x):
        """The three head tensors of ``x``."""
        b = (lambda n: getattr(self, n)) if self.use_bias else (lambda n: None)
        return (self._heads(x, self.wq, b("bq")),
                self._heads(x, self.wk, b("bk")),
                self._heads(x, self.wv, b("bv")))

    def out(self, o):
        """``[.., H, L, key_dim]`` attention output -> ``[.., L, D]``."""
        o = o.movedim(-3, -2)
        *lead, ln, h, dk = o.shape
        y = o.reshape(*lead, ln, h * dk) @ self.wo.to(o.dtype)
        if self.shard is not None:
            y = self.shard.reduce(y)
        if self.use_bias:
            y = y + self.bo.to(y.dtype)
        return y

    def forward(self, x):
        if self.shard is not None:
            x = self.shard.copy(x)
        q, k, v = self.qkv(x)
        fn = self.attention_fn
        if fn is _default_attention:
            o = fn(q, k, v, causal=self.causal,
                   scale=1.0 / math.sqrt(self.key_dim))
        else:
            bound = _bound_kwargs(fn)
            if "causal" not in bound:
                o = fn(q, k, v, causal=self.causal)
            elif bool(bound["causal"]) != bool(self.causal):
                raise ValueError(
                    f"MultiHeadAttention(causal={self.causal}) conflicts "
                    f"with attention_fn binding causal={bound['causal']}")
            else:
                o = fn(q, k, v)
        return self.out(o)


def TransformerBlock(d_model: int, num_heads: int, ff_dim: int,
                     key_dim: Optional[int] = None, causal: bool = False,
                     activation: str = "gelu",
                     attention_fn: Optional[Callable] = None,
                     epsilon: float = 1e-5, moe=None) -> Block:
    """Pre-LN block: ``x + MHA(LN(x))``, then ``x + MLP(LN(x))``;
    ``attention_fn`` is the attention layer's. ``moe`` (a
    ``parallel.MixtureOfExperts``) replaces the dense MLP with the
    expert-parallel FFN, the Switch-transformer block."""
    if key_dim is None:
        if d_model % num_heads:
            raise ValueError(
                f"d_model {d_model} not divisible by num_heads {num_heads}; "
                "pass key_dim explicitly")
        key_dim = d_model // num_heads
    attn = Residual(
        main=(LayerNormalization(epsilon=epsilon),
              MultiHeadAttention(num_heads=num_heads, key_dim=key_dim,
                                 causal=causal, attention_fn=attention_fn)),
        shortcut=(), activation=None)
    ffn = ((moe,) if moe is not None
           else (Dense(ff_dim, activation=activation), Dense(d_model)))
    mlp = Residual(main=(LayerNormalization(epsilon=epsilon), *ffn),
                   shortcut=(), activation=None)
    return Block(layers=(attn, mlp))


def build_transformer_lm(vocab_size: int, seq_len: int, *, d_model: int = 128,
                         depth: int = 2, num_heads: int = 4,
                         ff_dim: Optional[int] = None,
                         attention_fn: Optional[Callable] = None,
                         pipeline_stages: Optional[int] = None,
                         pipeline_microbatches: int = 4,
                         moe_experts: Optional[int] = None,
                         moe_top_k: int = 2,
                         moe_capacity_factor: float = 1.25,
                         moe_groups: Optional[int] = None,
                         moe_every: int = 1,
                         seed: int = 0) -> Sequential:
    """A causal (GPT-style) LM: token + position embeddings, ``depth``
    pre-LN blocks, final LN, vocab head. Int token ids ``[B, L]`` ->
    logits ``[B, L, vocab]``. ``attention_fn`` is every block's attention
    function (e.g. ``parallel.RingAttention()``). Parameters are
    initialized from ``seed`` on the CPU; ``compile`` (or a
    ``ServeEngine``) moves the model to the CUDA device unless the caller
    asks for the CPU.

    ``pipeline_stages=S`` wraps the blocks in a ``parallel.PipelinedBlocks``
    (``depth`` must divide by S): on a mesh with a ``pipe`` axis of size S
    the stages pipeline with ``pipeline_microbatches`` microbatches;
    elsewhere the same stacked weights run in sequence.
    ``moe_experts=E`` makes every ``moe_every``-th block a Switch block
    (``parallel.MixtureOfExperts`` in place of the dense MLP; ``ff_dim``
    sizes each expert): on a mesh with an ``expert`` axis the experts shard
    and tokens travel by ``all_to_all``; elsewhere the same stacked experts
    run locally. The two are mutually exclusive (the aux loss is state a
    pipeline cannot thread)."""
    from tpu_dist_torch.parallel.expert import MixtureOfExperts
    from tpu_dist_torch.parallel.pipeline_parallel import PipelinedBlocks

    ff_dim = ff_dim or 4 * d_model
    if moe_experts and pipeline_stages:
        raise ValueError("moe_experts and pipeline_stages are mutually "
                         "exclusive (see docstring)")
    layers = [Embedding(vocab_size, d_model),
              PositionalEmbedding(max_len=seq_len)]

    def mk_block(i: int = 0):
        moe = (MixtureOfExperts(
            num_experts=moe_experts, ff_dim=ff_dim, top_k=moe_top_k,
            capacity_factor=moe_capacity_factor, groups=moe_groups)
            if moe_experts and i % max(moe_every, 1) == 0 else None)
        return TransformerBlock(d_model, num_heads, ff_dim, causal=True,
                                attention_fn=attention_fn, moe=moe)

    if pipeline_stages:
        if depth % pipeline_stages:
            raise ValueError(
                f"depth {depth} not divisible by pipeline_stages "
                f"{pipeline_stages}")
        per_stage = depth // pipeline_stages
        stage = (mk_block() if per_stage == 1
                 else Block(layers=tuple(mk_block()
                                         for _ in range(per_stage))))
        layers.append(PipelinedBlocks(block=stage,
                                      num_stages=pipeline_stages,
                                      microbatches=pipeline_microbatches))
    else:
        layers += [mk_block(i) for i in range(depth)]
    layers += [LayerNormalization(), Dense(vocab_size)]
    return Sequential(layers, input_shape=(seq_len,), name="transformer_lm",
                      seed=seed)
