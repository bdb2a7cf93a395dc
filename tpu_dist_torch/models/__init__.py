"""Model layer: layers, containers and the reference model builders."""

from tpu_dist_torch.models.cnn import (build_and_compile_cnn_model,
                                       build_cnn_model)
from tpu_dist_torch.models.layers import (Activation, AveragePooling2D,
                                          BatchNormalization, Block, Conv2D,
                                          Dense, Dropout, Flatten,
                                          GlobalAveragePooling2D, Layer,
                                          MaxPooling2D, ReLU, Residual)
from tpu_dist_torch.models.model import Model, Sequential
from tpu_dist_torch.models.policy import compute_dtype, policy, set_policy
from tpu_dist_torch.models.resnet import ResNet18, ResNet50
from tpu_dist_torch.models.serialize import load_model, save_model
from tpu_dist_torch.models.transformer import (Embedding, LayerNormalization,
                                               MultiHeadAttention,
                                               PositionalEmbedding,
                                               TransformerBlock,
                                               build_transformer_lm)

__all__ = [
    "Activation", "AveragePooling2D", "BatchNormalization", "Block",
    "Conv2D", "Dense", "Dropout", "Flatten", "GlobalAveragePooling2D",
    "Layer", "MaxPooling2D", "ReLU", "Residual", "Model", "Sequential",
    "Embedding", "LayerNormalization", "MultiHeadAttention",
    "PositionalEmbedding", "TransformerBlock", "build_transformer_lm",
    "ResNet18", "ResNet50", "build_and_compile_cnn_model", "build_cnn_model",
    "compute_dtype", "policy", "set_policy", "load_model", "save_model",
]
