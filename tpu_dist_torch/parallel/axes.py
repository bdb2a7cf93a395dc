"""Canonical mesh axis names, the port's own copy of
``tpu_dist/parallel/axes.py``.

An axis name is part of the user-visible contract: ``axis_shapes={'data':
2}`` on a strategy, ``batch_sharded(mesh, 'data')`` on a batch. The port
runs one replica per process, so only the data axis carries processes
today (``parallel/mesh.py``); the other names are declared so that code
written against the JAX package reads the same here. Dependency-free.
"""

from __future__ import annotations

#: Data-parallel axis: batches shard over it, gradients all-reduce over it
#: (the reference's MultiWorkerMirroredStrategy semantics).
DATA_AXIS = "data"

#: Tensor-parallel axis (ROADMAP queue 1, item 17).
MODEL_AXIS = "model"

#: Sequence-parallel axis: ring attention (item 17).
SEQ_AXIS = "seq"

#: Pipeline-parallel axis (item 17).
PIPE_AXIS = "pipe"

#: Expert-parallel axis (item 17).
EXPERT_AXIS = "expert"

#: Every axis name the framework declares.
CANONICAL_AXES = frozenset(
    (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS))

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "EXPERT_AXIS",
    "CANONICAL_AXES",
]
