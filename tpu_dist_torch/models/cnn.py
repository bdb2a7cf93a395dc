"""The reference MNIST CNN as a port model.

Counterpart of ``tpu_dist/models/cnn.py``: Conv2D(32, 3, relu) -> MaxPool
-> Conv2D(64, 3, relu) -> MaxPool -> Flatten -> Dense(128, relu) ->
Dense(10) over 28 x 28 x 1 NHWC images, 225,034 parameters in 8 leaves;
compiled with SparseCategoricalCrossentropy(from_logits=True),
SGD(learning_rate) and SparseCategoricalAccuracy.
"""

from __future__ import annotations

from tpu_dist_torch.models.layers import Conv2D, Dense, Flatten, MaxPooling2D
from tpu_dist_torch.models.model import Sequential
from tpu_dist_torch.ops.losses import SparseCategoricalCrossentropy
from tpu_dist_torch.ops.metrics import SparseCategoricalAccuracy
from tpu_dist_torch.ops.optimizers import SGD
from tpu_dist_torch.utils.device import DeviceLike


def build_cnn_model(num_classes: int = 10, input_shape: tuple = (28, 28, 1),
                    seed: int = 0) -> Sequential:
    return Sequential([
        Conv2D(32, 3, activation="relu"),
        MaxPooling2D(),
        Conv2D(64, 3, activation="relu"),
        MaxPooling2D(),
        Flatten(),
        Dense(128, activation="relu"),
        Dense(num_classes),
    ], input_shape=input_shape, name="mnist_cnn", seed=seed)


def build_and_compile_cnn_model(learning_rate: float = 0.001, *,
                                device: DeviceLike = None) -> Sequential:
    """The reference's ``build_and_compile_cnn_model``. The model trains on
    ``device`` if given, else on the scoped strategy's device (the CUDA
    device by default; see ``Sequential.compile``)."""
    model = build_cnn_model()
    model.compile(
        loss=SparseCategoricalCrossentropy(from_logits=True),
        optimizer=SGD(learning_rate=learning_rate),
        metrics=[SparseCategoricalAccuracy()],
        device=device,
    )
    return model
