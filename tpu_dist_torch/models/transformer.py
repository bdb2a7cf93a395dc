"""Transformer layers and the causal LM — the subset serving needs.

Counterpart of ``tpu_dist/models/transformer.py``: token and positional
embeddings, LayerNorm, multi-head attention behind the
:func:`_default_attention` dispatch, the pre-LN block and
:func:`build_transformer_lm`. The dispatch sends every CUDA tensor to the
hand-written Hopper kernel of ``ops/flash_attention.py``, which raises on
what it does not take; CPU tensors get its plain PyTorch version. Single
device only: the reference's mesh-mapped flash, ring attention hooks,
pipeline stages and mixture-of-experts blocks come with the parallel-axes
slice of the port.
"""

from __future__ import annotations

import math
from typing import Optional

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


def _dense_attention(q, k, v, *, causal: bool, scale: float):
    """Dense softmax attention on any device: the plain version, for a
    caller that asks for it (e.g. ``kv_cache.prefill``'s ``attention_fn``)."""
    return fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)[0]


def _default_attention(q, k, v, *, causal: bool, scale: float):
    """Attention dispatch: :func:`fa.flash_attention`, which launches the
    flash kernel on CUDA tensors (and raises on a shape or dtype the kernel
    does not take) and computes the plain version on CPU tensors."""
    return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, scale=scale)


class MultiHeadAttention(Layer):
    """Multi-head self-attention on a ``[.., L, D]`` stream; ``causal``
    applies the autoregressive mask."""

    def __init__(self, num_heads: int, key_dim: int, causal: bool = False,
                 use_bias: bool = True,
                 kernel_initializer: str = "glorot_uniform"):
        super().__init__()
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.causal = causal
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer

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
        projection columns split as ``(H, key_dim)``, heads before L."""
        y = x @ w.to(x.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        *lead, ln, _ = y.shape
        y = y.reshape(*lead, ln, self.num_heads, self.key_dim)
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
        if self.use_bias:
            y = y + self.bo.to(y.dtype)
        return y

    def forward(self, x):
        q, k, v = self.qkv(x)
        o = _default_attention(q, k, v, causal=self.causal,
                               scale=1.0 / math.sqrt(self.key_dim))
        return self.out(o)


def TransformerBlock(d_model: int, num_heads: int, ff_dim: int,
                     key_dim: Optional[int] = None, causal: bool = False,
                     activation: str = "gelu",
                     epsilon: float = 1e-5) -> Block:
    """Pre-LN block: ``x + MHA(LN(x))``, then ``x + MLP(LN(x))``."""
    if key_dim is None:
        if d_model % num_heads:
            raise ValueError(
                f"d_model {d_model} not divisible by num_heads {num_heads}; "
                "pass key_dim explicitly")
        key_dim = d_model // num_heads
    attn = Residual(
        main=(LayerNormalization(epsilon=epsilon),
              MultiHeadAttention(num_heads=num_heads, key_dim=key_dim,
                                 causal=causal)),
        shortcut=(), activation=None)
    mlp = Residual(
        main=(LayerNormalization(epsilon=epsilon),
              Dense(ff_dim, activation=activation), Dense(d_model)),
        shortcut=(), activation=None)
    return Block(layers=(attn, mlp))


def build_transformer_lm(vocab_size: int, seq_len: int, *, d_model: int = 128,
                         depth: int = 2, num_heads: int = 4,
                         ff_dim: Optional[int] = None,
                         pipeline_stages: Optional[int] = None,
                         moe_experts: Optional[int] = None,
                         seed: int = 0) -> Sequential:
    """A causal (GPT-style) LM: token + position embeddings, ``depth``
    pre-LN blocks, final LN, vocab head. Int token ids ``[B, L]`` ->
    logits ``[B, L, vocab]``. Parameters are initialized from ``seed`` on
    the CPU."""
    if pipeline_stages:
        raise NotImplementedError(
            "pipeline_stages: pipelined blocks come with the port's "
            "parallel-axes slice (ROADMAP.md, 'Slices of the port', item 4)")
    if moe_experts:
        raise NotImplementedError(
            "moe_experts: mixture-of-experts blocks come with the port's "
            "parallel-axes slice (ROADMAP.md, 'Slices of the port', item 4)")
    ff_dim = ff_dim or 4 * d_model
    layers = [Embedding(vocab_size, d_model),
              PositionalEmbedding(max_len=seq_len)]
    layers += [TransformerBlock(d_model, num_heads, ff_dim, causal=True)
               for _ in range(depth)]
    layers += [LayerNormalization(), Dense(vocab_size)]
    return Sequential(layers, input_shape=(seq_len,), name="transformer_lm",
                      seed=seed)
