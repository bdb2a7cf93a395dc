"""Model layer: layers, containers and the reference model builders."""

from tpu_dist_torch.models.cnn import (build_and_compile_cnn_model,
                                       build_cnn_model)
from tpu_dist_torch.models.layers import (Block, Conv2D, Dense, Flatten,
                                          Layer, MaxPooling2D, Residual)
from tpu_dist_torch.models.model import Sequential
from tpu_dist_torch.models.policy import compute_dtype, policy, set_policy
from tpu_dist_torch.models.transformer import (Embedding, LayerNormalization,
                                               MultiHeadAttention,
                                               PositionalEmbedding,
                                               TransformerBlock,
                                               build_transformer_lm)

__all__ = [
    "Block", "Conv2D", "Dense", "Flatten", "Layer", "MaxPooling2D",
    "Residual", "Sequential", "Embedding", "LayerNormalization",
    "MultiHeadAttention", "PositionalEmbedding", "TransformerBlock",
    "build_transformer_lm", "build_and_compile_cnn_model", "build_cnn_model",
    "compute_dtype", "policy", "set_policy",
]
