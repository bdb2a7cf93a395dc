"""Model containers: ``Model`` and ``Sequential`` — init, forward and the
training surface.

Counterpart of ``tpu_dist/models/model.py``. ``Model`` is the reference's
container: a named ``(init_fn, apply_fn)`` pair with the Keras-style
``compile`` / ``fit`` / ``evaluate`` / ``predict`` / ``make_train_function``
/ ``train_state`` surface over ``training/trainer.py``; ``Sequential``,
the linear layer stack, is its subclass. Where the reference's model holds
no arrays (the trainer owns its pytrees), the port's is an ``nn.Module``
that owns its parameters and its state (BatchNorm's running statistics) as
buffers, registered under the reference's tree paths, so the dotted names
of :meth:`state_dict` are the reference's ``variables['params']`` and
``variables['state']`` paths. A model is built in eval mode: like the
reference's ``model(variables, x)``, a call outside the trainer is an
inference call until the caller sets ``.train()``.

The reference's functional core is here too, beside the module's own
forward: ``init(seed, input_shape)`` returns fresh variables and leaves
the model as it is, ``apply(params, state, x, training=, rng=)`` returns
``(outputs, new_state)`` for the given trees without touching the model's
tensors, and ``model(variables, x)`` is ``apply``'s output. ``apply`` with
one callable and nothing else is still ``nn.Module.apply``.
``save_weights``/``load_weights`` write and read ``training/checkpoint.py``
directories, ``save`` a ``models/serialize.py`` one.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpu_dist_torch.models.layers import (Layer, apply_chain, init_chain,
                                          unique_layer_names)
from tpu_dist_torch.models.policy import compute_dtype
from tpu_dist_torch.ops import losses as losses_lib
from tpu_dist_torch.ops import metrics as metrics_lib
from tpu_dist_torch.ops import optimizers as optimizers_lib
from tpu_dist_torch.utils.device import DeviceLike, resolve_device


def _nest(named, detach: bool = True) -> dict:
    """``(dotted name, tensor)`` pairs -> nested dicts of tensors (detached
    unless asked otherwise), the reference's tree layout."""
    tree: dict = {}
    for dotted, t in named:
        *path, leaf = dotted.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach() if detach else t
    return tree


def _flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> ``{dotted name: leaf}``."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


class _Tree(nn.Module):
    """One node of a functional model's params and state trees."""


def _detached_copy(layers, device: str = "meta") -> list:
    """A deep copy of ``layers`` whose parameters and buffers are stand-ins
    on ``device`` (nothing is copied for them) and which shares the
    originals' random generators and process groups; its ``init`` makes
    new tensors."""
    tensors = [t for layer in layers
               for t in (*layer.parameters(), *layer.buffers())]
    memo = {id(t): t.to(device) for t in tensors}
    memo.update((id(g), g) for layer in layers for m in layer.modules()
                for attr in ("generator", "sync_group")
                if (g := getattr(m, attr, None)) is not None)
    return copy.deepcopy(list(layers), memo)


@contextlib.contextmanager
def _functional(model: nn.Module, training: bool, rng):
    """The model in ``training`` mode, with every Dropout drawing from
    ``rng`` when one is given, for the block; then as it was."""
    was = model.training
    draws = [m for m in model.modules() if hasattr(m, "generator")
             and m is not model]
    before = [m.generator for m in draws]
    model.train(training)
    if rng is not None:
        for m in draws:
            m.generator = rng
    try:
        yield
    finally:
        model.train(was)
        for m, g in zip(draws, before):
            m.generator = g


class Model(nn.Module):
    """A named pair of functions plus the compile/fit surface:

        init_fn(gen, input_shape) -> (params, state)
        apply_fn(params, state, x, training, rng) -> (outputs, new_state)

    ``params`` and ``state`` are nested dicts of tensors. :meth:`init`
    registers the params as parameters and the state as buffers, under
    their tree paths. The forward calls ``apply_fn`` on them with
    ``training`` from the module's mode and ``rng`` from
    :attr:`generator` (the trainer's), and copies ``new_state`` into the
    buffers in place, so a captured program that ran the forward stays
    valid. Parameters are created from ``seed`` at construction when
    ``input_shape`` is known (on the CPU; move the model with
    ``.to(device)``)."""

    def __init__(self, init_fn: Optional[Callable] = None,
                 apply_fn: Optional[Callable] = None,
                 input_shape: Optional[tuple] = None, name: str = "model",
                 *, seed: int = 0):
        super().__init__()
        self._init_fn = init_fn
        self._apply_fn = apply_fn
        self._configure(input_shape, name, seed)

    def _configure(self, input_shape, name: str, seed: int) -> None:
        self.input_shape = input_shape
        self.name = name
        self.output_shape = None
        #: The trainer's random generator (``fit(seed=)``), read by the
        #: functional forward's ``rng`` and handed to every Dropout.
        self.generator: Optional[torch.Generator] = None
        # Set by compile():
        self.optimizer = None
        self.loss = None
        self.metrics: list = []
        self.steps_per_execution = 1
        self.gradient_bucket_bytes = 0
        self.prefetch_to_device = 0
        self.strategy = None
        self._trainer = None
        #: The mesh ``compile`` placed the model on (one with a model or
        #: sequence axis), and under a model axis ``(ModelShard, {name:
        #: (dim, size, index)})`` (``parallel/tensor.shard_model``).
        self._parallel_mesh = None
        self._tensor_parallel = None
        #: The summed ``aux_loss`` leaves of the last forward's new state,
        #: with their autograd graph (the trainer adds them to the loss).
        self._aux_loss: Optional[torch.Tensor] = None
        if input_shape is not None:
            self._init_from(torch.Generator().manual_seed(int(seed)),
                            tuple(input_shape))
        self.train(False)

    # -- functional core -------------------------------------------------------

    def init(self, seed: int = 0, input_shape: Optional[tuple] = None) -> dict:
        """Fresh ``{'params': …, 'state': …}`` (nested dicts of CPU tensors)
        from ``seed``, the values a model built with that seed starts
        from; the model itself is left as it is (the reference's
        ``Model.init``)."""
        shape = input_shape or self.input_shape
        if shape is None:
            raise ValueError(
                f"{self.name}: input_shape unknown; pass it to init() or set "
                "it on the model")
        params, state = self._fresh(torch.Generator().manual_seed(int(seed)),
                                    tuple(shape))
        return {"params": params, "state": state}

    def _fresh(self, gen: torch.Generator, shape: tuple) -> tuple:
        """New ``(params, state)`` trees from ``gen`` for ``shape``."""
        return self._init_fn(gen, shape)

    def apply(self, *args, **kwargs):
        """The reference's functional apply, ``apply(params, state, x, *,
        training=False, rng=None) -> (outputs, new_state)``: the forward
        over the given trees (gradients flow to their tensors), in
        ``training`` mode, Dropout drawing from ``rng`` (a generator); the
        model's own tensors and mode are left as they were, and
        ``new_state`` holds new tensors. Called with one callable and
        nothing else, it is ``nn.Module.apply(fn)``."""
        if len(args) == 1 and not kwargs and callable(args[0]):
            return super().apply(args[0])
        return self._apply_variables(*args, **kwargs)

    def _apply_variables(self, params, state, x, *, training: bool = False,
                         rng=None):
        return self._apply_fn(params, state, x, training, rng)

    def __call__(self, *args, **kwargs):
        """``model(variables, x, *, training=False, rng=None)`` is the
        reference's call, the outputs of :meth:`apply`; ``model(x)`` is the
        module's forward."""
        if args and isinstance(args[0], dict):
            variables, x = args
            return self.apply(variables["params"], variables["state"], x,
                              **kwargs)[0]
        return super().__call__(*args, **kwargs)

    def _init_from(self, gen: torch.Generator, shape: tuple) -> None:
        params, state = self._init_fn(gen, shape)
        self._modules.clear()
        self._parameters.clear()
        self._buffers.clear()
        self._attach(self, params, state)

    @staticmethod
    def _attach(node: nn.Module, params: dict, state: dict) -> None:
        for key in dict.fromkeys([*params, *state]):
            p, s = params.get(key), state.get(key)
            if isinstance(p, dict) or isinstance(s, dict):
                child = _Tree()
                Model._attach(child, p or {}, s or {})
                node.add_module(key, child)
                continue
            if p is not None:
                node.register_parameter(key, nn.Parameter(torch.as_tensor(p)))
            if s is not None:
                node.register_buffer(key, torch.as_tensor(s))

    def forward(self, x):
        buffers = dict(self.named_buffers())
        out, new_state = self._apply_fn(
            _nest(self.named_parameters(), detach=False),
            _nest(buffers.items()), x, self.training, self.generator)
        new = _flatten(new_state or {})
        # The reference adds every state leaf keyed ``aux_loss`` to the
        # training objective; the buffers below keep only its value.
        aux = [v for name, v in new.items()
               if name.rsplit(".", 1)[-1] == "aux_loss"]
        self._aux_loss = sum(v.float() for v in aux) if aux else None
        with torch.no_grad():
            for name, value in new.items():
                if value is not buffers[name]:
                    buffers[name].copy_(value)
        return out

    @property
    def variables(self) -> dict:
        """``{'params': …, 'state': …}``, nested dicts of (detached, live)
        tensors in the reference's tree layout (under a model axis, this
        process's blocks: ``parallel/tensor.gather_params`` gathers
        them)."""
        return {"params": _nest(self.named_parameters()),
                "state": _nest(self.named_buffers())}

    def load_jax_variables(self, variables: dict) -> None:
        """Load the reference model's ``variables`` (``{'params': …,
        'state': …}``, nested dicts of numpy arrays) into this model, in
        place; strict on names and shapes. Under a model axis each process
        loads its shards."""
        from tpu_dist_torch.models.bridge import variables_from_jax

        self.load_state_dict(self._local(variables_from_jax(variables)),
                             strict=True)

    def load_jax_params(self, tree: dict) -> None:
        """Load the reference model's ``variables['params']`` into this
        model's parameters, in place, strict on names and shapes; the state
        buffers keep their values."""
        from tpu_dist_torch.models.bridge import params_from_jax

        loaded = params_from_jax(tree)
        names = {n for n, _ in self.named_parameters()}
        if set(loaded) != names:
            raise RuntimeError(
                f"{self.name}: the params do not match the model's: missing "
                f"{sorted(names - set(loaded))}, unexpected "
                f"{sorted(set(loaded) - names)}")
        self.load_state_dict(self._local(loaded), strict=False)

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
        ``gradient_bucket_bytes``: 0 (default) keeps the step's one flat
        all-reduce of the gradients; > 0 switches a multi-process step to
        the JAX package's bucketed schedule: each process's BatchNorm
        takes its own shard's moments, the gradients are reduced in
        reverse-order buckets of about this many bytes
        (``collectives.bucketed_all_reduce``) and the running state is
        averaged after the step (``training/trainer.py``). Without
        BatchNorm the two schedules take the same mean of the same
        gradients; with it, the moments are the shard's, not the global
        batch's, as in the JAX package's bucketed step."""
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
        self._place_on(strategy.parallel_mesh)
        self.strategy = strategy
        self.optimizer = optimizers_lib.get(optimizer)
        if self._tensor_parallel is not None and (
                self.optimizer.clipnorm is not None
                or self.optimizer.global_clipnorm is not None):
            raise ValueError(
                "clipnorm and global_clipnorm need the norms of whole "
                "tensors; under a model axis each process holds slices")
        self.loss = losses_lib.get(loss) if loss is not None else None
        self.metrics = [metrics_lib.get(m) for m in metrics]
        self.steps_per_execution = int(steps_per_execution)
        self.gradient_bucket_bytes = int(gradient_bucket_bytes)
        self.prefetch_to_device = int(prefetch_to_device)
        self._trainer = None

    def _place_on(self, mesh) -> None:
        """Put the model on a mesh with a model or sequence axis (None:
        nothing to do): process 0's parameters and state on every process
        (the mirrored variables' initial broadcast, made before any
        slicing), then this process's shards under a model axis
        (``parallel/tensor.shard_model``). A model placed on one mesh is
        not placed on another."""
        placed = self._parallel_mesh
        if placed is not None or mesh is None:
            if placed is not None and placed != mesh:
                raise ValueError(
                    f"{self.name} is placed on the mesh {dict(placed.shape)};"
                    f" build the model anew for another")
            return
        from tpu_dist_torch.parallel import collectives, tensor

        collectives.broadcast_from_chief([list(self.parameters()),
                                          list(self.buffers())])
        tensor.shard_model(self, mesh)
        self._parallel_mesh = mesh

    def _local(self, tensors: dict) -> dict:
        """``{name: tensor}`` of whole tensors as this process holds them:
        each sharded leaf's block under a model axis."""
        from tpu_dist_torch.models.bridge import local_shards

        tp = self._tensor_parallel
        return tensors if tp is None else local_shards(tensors, tp[1])

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
        ``checkpoint_dir`` resumes from the newest complete checkpoint
        there and saves every epoch (``training/trainer.py``).
        ``profile_dir`` records a ``torch.profiler`` trace of the epochs
        there, on the chief (``utils/profiler.py``)."""
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

    def predict(self, x) -> np.ndarray:
        """Eval-mode outputs for an array (one batch) or an iterable of
        batches or of ``(x, y)`` tuples, as one numpy array (see
        ``Trainer.predict``)."""
        return self._get_trainer("").predict(x)

    def make_train_function(self, steps_per_execution: Optional[int] = None):
        """The train step — see ``Trainer.make_train_function`` for the
        callable's contract and how it differs from the JAX package's."""
        return self._get_trainer("loss optimizer").make_train_function(
            steps_per_execution)

    def train_state(self) -> tuple:
        """The ``(params, state, opt, metrics, loss_acc)`` the
        ``make_train_function`` callable takes."""
        return self._get_trainer("loss optimizer").train_state()

    # -- saving ----------------------------------------------------------------

    def save(self, directory) -> None:
        """Architecture, weights and (when it serializes) the compile
        config in one directory, the reference's format; reload with
        ``tpu_dist_torch.models.load_model``. Only the chief writes."""
        from tpu_dist_torch.models import serialize

        return serialize.save_model(self, directory)

    def save_weights(self, directory, step: int = 0):
        """Checkpoint ``step`` of the training variables (parameters,
        state, optimizer state), written by the chief
        (``training/checkpoint.py``); returns its path."""
        from tpu_dist_torch.training import checkpoint

        return checkpoint.save(directory, self, step=step)

    def load_weights(self, directory, step: Optional[int] = None) -> int:
        """Restore the training variables in place from the newest complete
        (or the given) checkpoint step; returns the step."""
        from tpu_dist_torch.training import checkpoint

        return checkpoint.restore_model(directory, self, step=step)


class Sequential(Model):
    """Linear layer stack — the reference model container. Parameters are
    created at construction from ``seed`` when ``input_shape`` is known (on
    the CPU; move the model with ``.to(device)``)."""

    def __init__(self, layers: Sequence[Layer], *,
                 input_shape: Optional[tuple] = None,
                 name: str = "sequential", seed: int = 0):
        if not layers:
            raise ValueError("Sequential needs at least one layer")
        nn.Module.__init__(self)
        for lname, layer in zip(unique_layer_names(layers), layers):
            self.add_module(lname, layer)
        self._init_fn = self._apply_fn = None
        self._configure(input_shape, name, seed)

    @property
    def layers(self) -> list[Layer]:
        return list(self._modules.values())

    @property
    def layer_names(self) -> list[str]:
        return list(self._modules.keys())

    def _init_from(self, gen: torch.Generator, shape: tuple) -> None:
        self.output_shape = init_chain(self.layers, gen, shape)

    def _fresh(self, gen: torch.Generator, shape: tuple) -> tuple:
        layers = nn.ModuleDict(zip(self.layer_names,
                                   _detached_copy(self.layers)))
        init_chain(layers.values(), gen, shape)
        return _nest(layers.named_parameters()), _nest(layers.named_buffers())

    def _apply_variables(self, params, state, x, *, training: bool = False,
                         rng=None):
        # BatchNorm updates its buffers in place: the forward gets copies
        # of the state, which become the new state.
        new_state = {name: t.clone() for name, t in _flatten(state).items()}
        tensors = {**_flatten(params), **new_state}
        with _functional(self, training, rng):
            out = torch.func.functional_call(self, tensors, (x,),
                                             strict=True)
        return out, _nest(new_state.items(), detach=False)

    def forward(self, x):
        # Mixed-precision entry/exit casts (policy.py): activations run in
        # the compute dtype, the returned logits in float32.
        dtype = compute_dtype()
        if x.is_floating_point() and x.dtype != dtype:
            x = x.to(dtype)
        y = apply_chain(self.layers, x)
        return y.float() if y.is_floating_point() else y

    def summary(self) -> str:
        """Keras-style layer table: name, type, output shape, param count,
        the reference's text. Shapes and counts need a known
        ``input_shape``; each layer's are read off a dry ``init`` of a copy
        of it on the ``meta`` device, which allocates nothing."""
        header = (f"{'Layer (name)':<26}{'Type':<22}{'Output shape':<18}"
                  f"{'Params':>10}")
        lines = [f'Model: "{self.name}"', "=" * len(header), header,
                 "-" * len(header)]
        if self.input_shape is None:
            for name, layer in zip(self.layer_names, self.layers):
                lines.append(f"{name:<26}{type(layer).__name__:<22}"
                             f"{'?':<18}{'?':>10}")
            lines.append("-" * len(header))
            lines.append("(input_shape unknown — shapes/params unavailable)")
        else:
            gen = torch.Generator().manual_seed(0)
            shape = tuple(self.input_shape)
            total = total_state = 0
            for name, layer in zip(self.layer_names, self.layers):
                (dry,) = _detached_copy([layer])
                with torch.device("meta"):
                    shape = dry.init(gen, shape)
                n = sum(math.prod(p.shape) for p in dry.parameters())
                total += n
                total_state += sum(math.prod(b.shape) for b in dry.buffers())
                lines.append(f"{name:<26}{type(layer).__name__:<22}"
                             f"{str(tuple(shape)):<18}{n:>10,}")
            lines.append("-" * len(header))
            lines.append(f"Trainable params: {total:,}")
            if total_state:
                lines.append(f"Non-trainable state: {total_state:,}")
        out = "\n".join(lines)
        print(out)
        return out
