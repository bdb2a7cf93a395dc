"""ResNet-18 / ResNet-50, the repo's second model family.

Counterpart of ``tpu_dist/models/resnet.py``, built from the same helpers
under the same names, so the two packages' trees (and so the bridged
variables) line up leaf for leaf:

* ResNet-18: basic blocks (3x3 + 3x3), stages [2, 2, 2, 2], widths 64-512.
* ResNet-50: bottleneck blocks (1x1 -> 3x3 -> 1x1 x 4), stages [3, 4, 6, 3].

Inputs of at most 64 pixels get the small-image stem (one 3x3 stride-1
conv, no pool), larger ones the 7x7/2 conv and a SAME 3x3/2 max pool.
Every conv has no bias and a He-normal kernel and is followed by
``BatchNormalization(momentum=0.9, epsilon=1e-5)``. Under
``set_policy("mixed_bfloat16")`` activations run in bfloat16, parameters
and BatchNorm statistics stay float32.
"""

from __future__ import annotations

from tpu_dist_torch.models.layers import (Activation, BatchNormalization,
                                          Block, Conv2D, Dense,
                                          GlobalAveragePooling2D,
                                          MaxPooling2D, Residual)
from tpu_dist_torch.models.model import Sequential


def _conv_bn(filters: int, kernel: int, strides: int = 1,
             activation: str | None = "relu") -> list:
    layers = [
        Conv2D(filters, kernel, strides=strides, padding="same",
               use_bias=False, kernel_initializer="he_normal"),
        BatchNormalization(momentum=0.9, epsilon=1e-5),
    ]
    if activation:
        layers.append(Activation(activation))
    return layers


def _basic_block(filters: int, strides: int, project: bool) -> Residual:
    main = (*_conv_bn(filters, 3, strides),
            *_conv_bn(filters, 3, activation=None))
    shortcut = tuple(_conv_bn(filters, 1, strides, activation=None)
                     ) if project else ()
    return Residual(main=main, shortcut=shortcut)


def _bottleneck_block(filters: int, strides: int, project: bool) -> Residual:
    out = filters * 4
    main = (*_conv_bn(filters, 1),
            *_conv_bn(filters, 3, strides),
            *_conv_bn(out, 1, activation=None))
    shortcut = tuple(_conv_bn(out, 1, strides, activation=None)
                     ) if project else ()
    return Residual(main=main, shortcut=shortcut)


def _stage(block_fn, filters: int, blocks: int, first_strides: int,
           first_projects: bool) -> Block:
    layers = [block_fn(filters, first_strides, first_projects)]
    layers += [block_fn(filters, 1, False) for _ in range(blocks - 1)]
    return Block(layers)


def _resnet(block_fn, stage_blocks: list[int], num_classes: int,
            input_shape: tuple, name: str, seed: int = 0) -> Sequential:
    small = input_shape[0] <= 64
    if small:
        stem = _conv_bn(64, 3)
    else:
        stem = [*_conv_bn(64, 7, strides=2),
                MaxPooling2D(pool_size=3, strides=2, padding="same")]
    # Stage 1 keeps stride 1; bottleneck widening means even stage 1
    # projects.
    projects_first = block_fn is _bottleneck_block
    stages = [
        _stage(block_fn, 64, stage_blocks[0], 1, projects_first),
        _stage(block_fn, 128, stage_blocks[1], 2, True),
        _stage(block_fn, 256, stage_blocks[2], 2, True),
        _stage(block_fn, 512, stage_blocks[3], 2, True),
    ]
    return Sequential(
        [*stem, *stages, GlobalAveragePooling2D(),
         Dense(num_classes, kernel_initializer="glorot_uniform")],
        input_shape=input_shape, name=name, seed=seed)


def ResNet18(num_classes: int = 10, input_shape: tuple = (32, 32, 3),
             seed: int = 0) -> Sequential:
    return _resnet(_basic_block, [2, 2, 2, 2], num_classes, input_shape,
                   "resnet18", seed)


def ResNet50(num_classes: int = 10, input_shape: tuple = (32, 32, 3),
             seed: int = 0) -> Sequential:
    return _resnet(_bottleneck_block, [3, 4, 6, 3], num_classes,
                   input_shape, "resnet50", seed)
