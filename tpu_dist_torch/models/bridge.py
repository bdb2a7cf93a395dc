"""Weights bridge from the reference package to the port.

The only place where parameter names or layouts are translated. The port's
layers register their children under the reference's layer names and keep
its layouts (Dense kernels ``[in, out]``, Conv2D kernels HWIO ``[kh, kw,
in, out]``, embedding tables ``[vocab, dim]``, attention projections
``[d, heads * key_dim]``), and their state (BatchNorm's ``mean`` and
``var``) as buffers at the state tree's paths, so the translation is the
identity on layouts and a join of each tree's path with ``.`` on names.
Reads numpy only.

The optimizer state and the checkpoint keys are translated here too. The
reference's checkpoint (``tpu_dist/training/checkpoint.py``) keys each
array by its ``jax.tree_util.keystr`` path in ``{'params', 'state',
'opt'}``: a dict key as ``['name']`` (dicts flatten in sorted key order),
a NamedTuple field as ``.field``, a sequence entry as ``[i]``. So a kernel
is ``['params']['conv2d']['kernel']``, a BatchNorm mean
``['state'][...]['mean']``, Adam's first moment of it
``['opt'].mu['conv2d']['kernel']`` and its step ``['opt'].step``; a
constant-rate momentum SGD's velocity tree is the whole ``opt``
(``['opt']['conv2d']['kernel']``), a scheduled SGD's is
``['opt'].velocity[...]`` beside ``['opt'].step``, and plain SGD keeps no
``opt`` leaf. The port keeps each per-parameter state as a list in its
parameter order, so it is mapped to those keys by the parameters' names,
never by position (the reference's sorted order puts ``conv2d_10`` before
``conv2d_2``).

Under a model axis a process holds blocks of some parameters
(``parallel/tensor.py``): :func:`local_shards` takes whole tensors (the
reference's, or a checkpoint's) to this process's blocks, and
:func:`checkpoint_names` names the parameter each checkpoint key follows,
so a checkpoint gathers and restores each block by its parameter's
layout.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference ``variables['params']`` (nested dicts of arrays) -> the
    port's parameters (float32 CPU tensors keyed by dotted path)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + (str(key),))
            return
        arr = np.asarray(node, dtype=np.float32)
        out[".".join(path)] = torch.from_numpy(arr.copy())

    walk(tree, ())
    return out


def state_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Reference ``variables['state']`` -> the port's buffers (CPU tensors
    keyed by dotted path, in the arrays' own dtypes)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + (str(key),))
            return
        out[".".join(path)] = torch.from_numpy(np.array(node))

    walk(tree, ())
    return out


def variables_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """Reference ``variables`` (``{'params': …, 'state': …}``) -> the
    port's whole ``state_dict``: parameters and buffers."""
    return {**params_from_jax(variables["params"]),
            **state_from_jax(variables.get("state") or {})}


def local_shards(tensors: dict, layout: dict) -> dict:
    """``{name: tensor}`` with every tensor ``layout`` names (``{name:
    (dim, axis size, coordinate)}``, ``parallel/tensor.shard_model``'s)
    cut to this process's block along its dimension; the rest as they
    are. With the layout of a model on a mesh, ``local_shards(
    variables_from_jax(v), layout)`` is what that process loads."""
    out = dict(tensors)
    for name, (dim, size, index) in layout.items():
        if name in out:
            t = out[name]
            per = t.shape[dim] // size
            out[name] = t.narrow(dim, index * per, per).clone()
    return out


def keypath(dotted: str) -> str:
    """A dotted port name as the reference's ``keystr`` of the same dict
    path: ``"conv2d.kernel"`` -> ``"['conv2d']['kernel']"``."""
    return "".join(f"[{part!r}]" for part in dotted.split("."))


def flatten_keys(tree, prefix: str = "") -> dict:
    """``{keystr path: leaf}`` of a tree of dicts, NamedTuples, lists and
    tuples, in ``jax.tree_util.keystr``'s spelling (see the module
    docstring); works on the reference's trees and on the port's alike."""
    out: dict = {}
    if isinstance(tree, dict):
        for key in sorted(tree):
            out.update(flatten_keys(tree[key], f"{prefix}[{key!r}]"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field in tree._fields:
            out.update(flatten_keys(getattr(tree, field),
                                    f"{prefix}.{field}"))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            out.update(flatten_keys(sub, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out


def opt_keys(opt_state, names: list[str], prefix: str = "") -> dict:
    """``{keystr path: tensor}`` of the port's optimizer state (the
    tensors themselves), in the reference's layout: every list of
    per-parameter tensors becomes the params tree, keyed through
    ``names`` (the parameters' dotted names, in the state's order); a
    NamedTuple keeps its fields; ``()`` holds nothing."""
    out: dict = {}
    if isinstance(opt_state, tuple) and hasattr(opt_state, "_fields"):
        for field in opt_state._fields:
            out.update(opt_keys(getattr(opt_state, field), names,
                                f"{prefix}.{field}"))
    elif isinstance(opt_state, (list, tuple)):
        if opt_state and len(opt_state) != len(names):
            raise ValueError(
                f"optimizer state holds {len(opt_state)} per-parameter "
                f"tensors for {len(names)} parameters")
        for name, t in zip(names, opt_state):
            out[prefix + keypath(name)] = t
    else:
        out[prefix] = opt_state
    return out


def checkpoint_tensors(model, opt_state) -> dict[str, torch.Tensor]:
    """The live tensors a checkpoint of ``model`` holds, keyed as the
    reference's ``arrays.npz`` keys them: the parameters under
    ``['params']``, the state buffers under ``['state']``, ``opt_state``
    (the trainer's, for ``model.parameters()`` in order) under
    ``['opt']``."""
    names = [n for n, _ in model.named_parameters()]
    out = {"['params']" + keypath(n): p for n, p in model.named_parameters()}
    out.update(("['state']" + keypath(n), b)
               for n, b in model.named_buffers())
    out.update(opt_keys(opt_state, names, "['opt']"))
    return out


def _names_like(opt_state, names: list[str]):
    """``opt_state`` with every list of per-parameter tensors replaced by
    the parameters' names and every other leaf by None."""
    if isinstance(opt_state, tuple) and hasattr(opt_state, "_fields"):
        return type(opt_state)(*(_names_like(getattr(opt_state, f), names)
                                 for f in opt_state._fields))
    if isinstance(opt_state, (list, tuple)):
        return list(names) if opt_state else []
    return None


def checkpoint_names(model, opt_state) -> dict:
    """``{checkpoint key: parameter name or None}`` over the keys of
    :func:`checkpoint_tensors`: a parameter's key and its optimizer
    states' keys name it, a buffer's and a step counter's None."""
    names = [n for n, _ in model.named_parameters()]
    out = {"['params']" + keypath(n): n for n in names}
    out.update(("['state']" + keypath(n), None)
               for n, _ in model.named_buffers())
    out.update(opt_keys(_names_like(opt_state, names), names, "['opt']"))
    return out


def opt_state_to_jax(opt_state, names: list[str]) -> dict[str, np.ndarray]:
    """The port's optimizer state as ``{keystr: numpy array}``, the keys
    ``jax.tree_util.keystr`` gives the reference's state of the same
    optimizer over the same params."""
    return {k: t.detach().cpu().numpy()
            for k, t in opt_keys(opt_state, names).items()}


def load_jax_opt_state(tree, opt_state, names: list[str]) -> None:
    """Copy the reference's optimizer state ``tree`` (its NamedTuples and
    dicts of arrays) into the port's ``opt_state`` in place, by key; the
    key sets must be equal."""
    want = opt_keys(opt_state, names)
    got = flatten_keys(tree)
    if set(got) != set(want):
        raise KeyError(
            f"optimizer state keys differ: missing "
            f"{sorted(set(want) - set(got))[:3]}, unexpected "
            f"{sorted(set(got) - set(want))[:3]}")
    with torch.no_grad():
        for key, t in want.items():
            t.copy_(torch.from_numpy(np.array(got[key])))
