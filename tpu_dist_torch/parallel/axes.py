"""Canonical mesh axis names, the port's own copy of
``tpu_dist/parallel/axes.py``.

An axis name is part of the user-visible contract: ``axis_shapes={'data':
2}`` on a strategy, ``batch_sharded(mesh, 'data')`` on a batch. The port
runs one device per process, so an axis carries processes
(``parallel/mesh.py``): the data, model, seq, pipe and expert axes.
Dependency-free.
"""

from __future__ import annotations

#: Data-parallel axis: batches shard over it, gradients all-reduce over it
#: (the reference's MultiWorkerMirroredStrategy semantics).
DATA_AXIS = "data"

#: Tensor-parallel axis (``parallel/tensor.py``).
MODEL_AXIS = "model"

#: Sequence-parallel axis: ring attention (``parallel/sequence.py``).
SEQ_AXIS = "seq"

#: Pipeline-parallel axis (``parallel/pipeline_parallel.py``).
PIPE_AXIS = "pipe"

#: Expert-parallel axis (``parallel/expert.py``).
EXPERT_AXIS = "expert"

#: Every axis name the framework declares.
CANONICAL_AXES = frozenset(
    (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS))

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "EXPERT_AXIS",
    "CANONICAL_AXES",
]
