"""Model container: ``Sequential`` — init, forward and the training surface.

Counterpart of ``tpu_dist/models/model.py`` (``Sequential``): init from a
seed, the forward pass, and the Keras-style ``compile`` / ``fit`` /
``evaluate`` / ``make_train_function`` / ``train_state`` surface over
``training/trainer.py``. ``save``/``load_weights`` come with the port's
checkpoint work. Children are registered under the reference's layer
names, so the dotted names of :meth:`state_dict` are the reference's
params-tree paths.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpu_dist_torch.models.layers import (Layer, apply_chain, init_chain,
                                          unique_layer_names)
from tpu_dist_torch.models.policy import compute_dtype
from tpu_dist_torch.ops import losses as losses_lib
from tpu_dist_torch.ops import metrics as metrics_lib
from tpu_dist_torch.ops import optimizers as optimizers_lib
from tpu_dist_torch.utils.device import DeviceLike, resolve_device
from tpu_dist_torch.utils.errors import unported


class Sequential(nn.Module):
    """Linear layer stack. Parameters are created at construction from
    ``seed`` when ``input_shape`` is known (on the CPU; move the model with
    ``.to(device)``)."""

    def __init__(self, layers: Sequence[Layer], *,
                 input_shape: Optional[tuple] = None,
                 name: str = "sequential", seed: int = 0):
        super().__init__()
        if not layers:
            raise ValueError("Sequential needs at least one layer")
        for lname, layer in zip(unique_layer_names(layers), layers):
            self.add_module(lname, layer)
        self.input_shape = input_shape
        self.name = name
        self.output_shape = None
        # Set by compile():
        self.optimizer = None
        self.loss = None
        self.metrics: list = []
        self.steps_per_execution = 1
        self.prefetch_to_device = 0
        self.strategy = None
        self._trainer = None
        if input_shape is not None:
            self.init(seed)

    @property
    def layers(self) -> list[Layer]:
        return list(self._modules.values())

    @property
    def layer_names(self) -> list[str]:
        return list(self._modules.keys())

    def init(self, seed: int = 0) -> dict:
        """(Re)create every parameter from ``seed``; the model keeps the
        device its parameters were on. Returns :attr:`variables`."""
        if self.input_shape is None:
            raise ValueError(f"{self.name}: input_shape unknown")
        device = next((p.device for p in self.parameters()), None)
        gen = torch.Generator().manual_seed(int(seed))
        self.output_shape = init_chain(self.layers, gen,
                                       tuple(self.input_shape))
        if device is not None:
            self.to(device)
        return self.variables

    def forward(self, x):
        # Mixed-precision entry/exit casts (policy.py): activations run in
        # the compute dtype, the returned logits in float32.
        dtype = compute_dtype()
        if x.is_floating_point() and x.dtype != dtype:
            x = x.to(dtype)
        y = apply_chain(self.layers, x)
        return y.float() if y.is_floating_point() else y

    @property
    def variables(self) -> dict:
        """``{'params': nested dict of tensors, 'state': {}}`` — the
        reference's variables layout."""
        params: dict = {}
        for dotted, p in self.named_parameters():
            *path, leaf = dotted.split(".")
            node = params
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = p.detach()
        return {"params": params, "state": {}}

    def load_jax_params(self, tree: dict) -> None:
        """Load the reference model's ``variables['params']`` (nested dicts
        of numpy arrays) into this model, in place."""
        from tpu_dist_torch.models.bridge import params_from_jax

        self.load_state_dict(params_from_jax(tree), strict=True)

    # -- Keras-style training surface -----------------------------------------

    def compile(self, optimizer="sgd", loss=None, metrics=(),
                steps_per_execution: int = 1, gradient_bucket_bytes: int = 0,
                prefetch_to_device: int = 0, *,
                device: DeviceLike = None) -> None:
        """Record loss/optimizer/metrics, capture the scoped strategy
        (``get_strategy()``, as the JAX package does) and move the model to
        ``device``: by default the strategy's device, else the CUDA device
        unless the caller asks for the CPU (``device="cpu"``, as the CPU
        tests do); without a GPU the default raises. The model trains where
        its parameters are. Recompiling keeps the weights and rebuilds the
        optimizer state.

        ``steps_per_execution = k`` runs k train steps per execution (on
        CUDA in one process, one captured CUDA graph; see
        ``training/trainer.py``). ``prefetch_to_device = d > 0`` places
        the host pipeline's next ``d`` batches on the device from a
        background thread (``data.DevicePrefetcher``) while a step runs.
        ``gradient_bucket_bytes`` comes with a later slice of the port and
        raises ``NotImplementedError`` until then."""
        from tpu_dist_torch.parallel.strategy import get_strategy

        if steps_per_execution < 1:
            raise ValueError(
                f"steps_per_execution must be >= 1, got {steps_per_execution}")
        if gradient_bucket_bytes < 0:
            raise ValueError(
                f"gradient_bucket_bytes must be >= 0, got "
                f"{gradient_bucket_bytes}")
        if prefetch_to_device < 0:
            raise ValueError(
                f"prefetch_to_device must be >= 0, got {prefetch_to_device}")
        if gradient_bucket_bytes:
            raise unported("compile(gradient_bucket_bytes=)")
        strategy = get_strategy()
        target = resolve_device(device if device is not None
                                else strategy.device)
        if strategy.device is not None:
            if target.type != strategy.device.type:
                raise ValueError(
                    f"compile(device={target}) under {strategy!r}, whose "
                    f"replica trains on {strategy.device}")
            target = strategy.device
        self.to(target)
        self.strategy = strategy
        self.optimizer = optimizers_lib.get(optimizer)
        self.loss = losses_lib.get(loss) if loss is not None else None
        self.metrics = [metrics_lib.get(m) for m in metrics]
        self.steps_per_execution = int(steps_per_execution)
        self.prefetch_to_device = int(prefetch_to_device)
        self._trainer = None

    def _get_trainer(self, needs: str):
        from tpu_dist_torch.training.trainer import Trainer

        missing = [n for n in needs.split() if getattr(self, n) is None]
        if missing:
            raise RuntimeError(
                f"{self.name} must be compile()d with a "
                f"{' and '.join(missing)} first")
        if self._trainer is None:
            self._trainer = Trainer(self)
        return self._trainer

    def fit(self, x, epochs: int = 1, steps_per_epoch: Optional[int] = None,
            verbose: int = 1, callbacks: Sequence = (), initial_epoch: int = 0,
            seed: int = 0, profile_dir: Optional[str] = None,
            validation_data=None, validation_steps: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            class_weight: Optional[dict] = None):
        """Run the epoch/step loop over a ``DeviceDataset``, a
        ``Dataset`` (on CUDA promoted to a ``DeviceDataset`` where it can
        be), a ``DistributedDataset`` or ``(x, y)`` arrays (batches of 32
        in order); returns the ``History``. ``validation_data`` runs a
        validation pass each epoch, reported as ``val_``-prefixed logs;
        ``class_weight`` scales each sample's loss by its class's weight.
        ``profile_dir`` and ``checkpoint_dir`` raise
        ``NotImplementedError`` until their slice (``ROADMAP.md``)."""
        return self._get_trainer("loss optimizer").fit(
            x, epochs=epochs, steps_per_epoch=steps_per_epoch,
            verbose=verbose, callbacks=callbacks, initial_epoch=initial_epoch,
            seed=seed, profile_dir=profile_dir,
            validation_data=validation_data,
            validation_steps=validation_steps,
            checkpoint_dir=checkpoint_dir, class_weight=class_weight)

    def evaluate(self, x, steps: Optional[int] = None, verbose: int = 1):
        """Loss and metrics over a dataset or ``(x, y)`` arrays, as a dict
        of floats."""
        return self._get_trainer("loss").evaluate(x, steps=steps,
                                                  verbose=verbose)

    def make_train_function(self, steps_per_execution: Optional[int] = None):
        """The train step — see ``Trainer.make_train_function`` for the
        callable's contract and how it differs from the JAX package's."""
        return self._get_trainer("loss optimizer").make_train_function(
            steps_per_execution)

    def train_state(self) -> tuple:
        """The ``(params, state, opt, metrics, loss_acc)`` the
        ``make_train_function`` callable takes."""
        return self._get_trainer("loss optimizer").train_state()
