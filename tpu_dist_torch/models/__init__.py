"""Model layer: layers, containers and the reference model builders."""

from tpu_dist_torch.models.cnn import (build_and_compile_cnn_model,
                                       build_cnn_model)
from tpu_dist_torch.models.layers import (Conv2D, Dense, Flatten, Layer,
                                          MaxPooling2D)
from tpu_dist_torch.models.model import Sequential
from tpu_dist_torch.models.transformer import build_transformer_lm

__all__ = [
    "Conv2D", "Dense", "Flatten", "Layer", "MaxPooling2D", "Sequential",
    "build_and_compile_cnn_model", "build_cnn_model", "build_transformer_lm",
]
