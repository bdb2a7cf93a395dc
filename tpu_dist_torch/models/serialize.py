"""Full-model save/load: architecture and weights in one directory.

Counterpart of ``tpu_dist/models/serialize.py``, in its format
(``tpu_dist.sequential.v1``): ``model.json`` holds the architecture (each
layer's class and the reference's dataclass fields, nested layers
recursively) and the compile config (the loss's, optimizer's and metrics'
public attributes); the weights are checkpoint step 0 in the same
directory (``training/checkpoint.py``). So a directory either package
saved loads in the other.

The reference's layers are frozen dataclasses; the port's are
``nn.Module``s that record their constructor's arguments under the
reference's field names (``Layer.config``). Its optimizers, losses,
metrics and schedules keep the reference's public attribute names and
their private state (leaf tables) private, so ``vars()`` reads the same
config in both. An attention layer's ``parallel.RingAttention`` is saved
as its fields (the reference's ``__attention__`` record), never its mesh.

    model.save("saved/mnist")                 # the chief writes
    model2 = tpu_dist_torch.models.load_model("saved/mnist", device="cpu")
    model2.predict(x)                         # the same outputs
"""

from __future__ import annotations

import inspect
import json
import os
import pathlib
from typing import Optional

CONFIG_NAME = "model.json"
FORMAT = "tpu_dist.sequential.v1"


def _encode_value(v):
    from tpu_dist_torch.models.layers import Layer
    from tpu_dist_torch.parallel.sequence import RingAttention

    if isinstance(v, Layer):
        return {"__layer__": layer_config(v)}
    if isinstance(v, RingAttention):
        # The declarative attention spec: its fields, never a mesh (the
        # restoring job's strategy scope provides one).
        return {"__attention__": {
            "class": "RingAttention",
            "config": {k: getattr(v, k)
                       for k in ("axis_name", "batch_axis", "scale",
                                 "kv_chunk")}}}
    if isinstance(v, (tuple, list)):
        return [_encode_value(e) for e in v]
    if callable(v):
        raise TypeError(
            f"cannot serialize layer field holding a callable ({v!r}); use "
            "the declarative spec (RingAttention(axis_name=...)) for ring "
            "attention, or save_weights()/load_weights and rebuild the "
            "architecture in code for other attention_fn hooks")
    return v


def _decode_value(v):
    if isinstance(v, dict) and "__layer__" in v:
        return layer_from_config(v["__layer__"])
    if isinstance(v, dict) and "__attention__" in v:
        from tpu_dist_torch.parallel.sequence import RingAttention

        spec = v["__attention__"]
        # An allowlist: a crafted model.json must reach nothing else.
        cls = {"RingAttention": RingAttention}.get(spec["class"])
        if cls is None:
            raise ValueError(
                f"unknown attention spec class {spec['class']!r}")
        return cls(**spec["config"])
    if isinstance(v, list):
        return tuple(_decode_value(e) for e in v)
    return v


def layer_config(layer) -> dict:
    """``{"class": …, "config": {fields}}``, nested layers encoded
    recursively, as the reference writes it."""
    from tpu_dist_torch.models.layers import Layer

    if not isinstance(layer, Layer):
        raise TypeError(f"cannot serialize {type(layer).__name__}: not a "
                        "Layer")
    cfg = {name: _encode_value(value)
           for name, value in layer.config().items()}
    return {"class": type(layer).__name__, "config": cfg}


def layer_from_config(spec: dict):
    from tpu_dist_torch.models import layers as layers_mod
    from tpu_dist_torch.models import transformer as transformer_mod
    from tpu_dist_torch.parallel import expert, pipeline_parallel

    cls = None
    for module in (layers_mod, transformer_mod, pipeline_parallel, expert):
        cls = cls or getattr(module, spec["class"], None)
    # Layer subclasses only: a crafted model.json must reach nothing else.
    if (cls is None or not isinstance(cls, type)
            or not issubclass(cls, layers_mod.Layer)):
        raise ValueError(f"unknown layer class {spec['class']!r}")
    return cls(**{k: _decode_value(v) for k, v in spec["config"].items()})


def _obj_config(obj) -> Optional[dict]:
    """``{"class", "config"}`` from an object's public attributes; None
    when one cannot round-trip through JSON."""
    from tpu_dist_torch.ops.schedules import LearningRateSchedule

    cfg = {}
    for k, v in vars(obj).items():
        if k.startswith("_"):
            continue
        if isinstance(v, LearningRateSchedule):
            inner = _obj_config(v)
            if inner is None:
                return None
            v = {"__schedule__": inner}
        elif callable(v):
            return None
        elif isinstance(v, (list, tuple)):
            if not all(isinstance(e, (int, float, str, bool, type(None)))
                       for e in v):
                return None
            v = list(v)
        elif not isinstance(v, (int, float, str, bool, type(None))):
            return None
        cfg[k] = v
    return {"class": type(obj).__name__, "config": cfg}


def _obj_from_config(spec: dict, module):
    from tpu_dist_torch.ops import schedules as schedules_mod

    cls = getattr(module, spec["class"], None)
    if cls is None or not isinstance(cls, type):
        raise ValueError(
            f"unknown {module.__name__.rsplit('.', 1)[-1]} class "
            f"{spec['class']!r}")
    # A config carries every public attribute; a constructor may take a
    # subset (a Loss sets its name itself).
    accepted = set(inspect.signature(cls.__init__).parameters) - {"self"}
    kwargs = {}
    for k, v in spec["config"].items():
        if k not in accepted:
            continue
        if isinstance(v, dict) and "__schedule__" in v:
            v = _obj_from_config(v["__schedule__"], schedules_mod)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def _compile_config(model) -> Optional[dict]:
    """The loss, optimizer and metrics configs, or None when one does not
    serialize (``load_model`` then returns the model uncompiled)."""
    if model.loss is None or model.optimizer is None:
        return None
    loss = _obj_config(model.loss)
    opt = _obj_config(model.optimizer)
    mets = [_obj_config(m) for m in model.metrics]
    if loss is None or opt is None or any(m is None for m in mets):
        return None
    return {"loss": loss, "optimizer": opt, "metrics": mets,
            "steps_per_execution": model.steps_per_execution}


def model_config(model) -> dict:
    from tpu_dist_torch.models.model import Sequential

    if not isinstance(model, Sequential):
        raise TypeError(
            f"save/load supports Sequential models, got {type(model).__name__}")
    cfg = {
        "format": FORMAT,
        "name": model.name,
        "input_shape": list(model.input_shape) if model.input_shape else None,
        "layers": [layer_config(layer) for layer in model.layers],
    }
    compiled = _compile_config(model)
    if compiled:
        cfg["compile"] = compiled
    return cfg


def save_model(model, directory) -> None:
    """The architecture (``model.json``, written by the chief) and the
    weights (checkpoint step 0). Every process of a group must call it:
    the checkpoint ends in a barrier."""
    from tpu_dist_torch.cluster import bootstrap
    from tpu_dist_torch.training import checkpoint

    directory = pathlib.Path(directory)
    # Encode on every process before any write, so a model that does not
    # serialize raises everywhere and no peer waits at the barrier.
    encoded = json.dumps(model_config(model), indent=2)
    if bootstrap.is_chief():
        directory.mkdir(parents=True, exist_ok=True)
        tmp = directory / f".{CONFIG_NAME}.tmp.{os.getpid()}"
        tmp.write_text(encoded)
        os.replace(tmp, directory / CONFIG_NAME)
    checkpoint.save(directory, model, step=0)


def load_model(directory, *, compile: bool = True, device=None):
    """Rebuild the ``Sequential`` from ``model.json``, restore its weights
    (step 0) and, by default, compile it from the saved loss, optimizer
    and metrics. The model lands on ``device``: the CUDA device unless
    the caller asks for the CPU (``device="cpu"``), compiled or not."""
    from tpu_dist_torch.models.model import Sequential
    from tpu_dist_torch.training import checkpoint
    from tpu_dist_torch.utils.device import resolve_device

    directory = pathlib.Path(directory)
    target = resolve_device(device)
    spec = json.loads((directory / CONFIG_NAME).read_text())
    if spec.get("format") != FORMAT:
        raise ValueError(f"unrecognized saved-model format in {directory}")
    model = Sequential(
        [layer_from_config(layer) for layer in spec["layers"]],
        input_shape=tuple(spec["input_shape"]) if spec["input_shape"]
        else None,
        name=spec.get("name", "sequential"))
    if compile and spec.get("compile"):
        from tpu_dist_torch.ops import losses as losses_mod
        from tpu_dist_torch.ops import metrics as metrics_mod
        from tpu_dist_torch.ops import optimizers as optimizers_mod

        c = spec["compile"]
        model.compile(
            loss=_obj_from_config(c["loss"], losses_mod),
            optimizer=_obj_from_config(c["optimizer"], optimizers_mod),
            metrics=[_obj_from_config(m, metrics_mod)
                     for m in c.get("metrics", [])],
            steps_per_execution=c.get("steps_per_execution", 1),
            device=target)
    else:
        model.to(target)
    checkpoint.restore_model(directory, model, step=0)
    return model
