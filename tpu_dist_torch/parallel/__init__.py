"""Parallelism layer: axis names, meshes, collectives, distribution
strategies (the parameter server's among them), tensor parallelism, ring
attention, the pipeline schedules and the mixture of experts."""

from tpu_dist_torch.parallel.axes import (CANONICAL_AXES, DATA_AXIS,
                                          EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS,
                                          SEQ_AXIS)
from tpu_dist_torch.parallel.collectives import (CollectiveCommunication,
                                                 ReduceOp, all_gather,
                                                 all_reduce,
                                                 broadcast_from_chief,
                                                 bucketed_all_reduce,
                                                 host_all_reduce_sum,
                                                 partition_buckets,
                                                 set_collective_logging)
from tpu_dist_torch.parallel.expert import MixtureOfExperts
from tpu_dist_torch.parallel.mesh import (batch_sharded, make_mesh,
                                          replicate, replicated, shard_batch)
from tpu_dist_torch.parallel.pipeline_1f1b import (make_1f1b_train_step,
                                                   one_f_one_b)
from tpu_dist_torch.parallel.pipeline_parallel import (PipelinedBlocks,
                                                       gpipe_schedule)
from tpu_dist_torch.parallel.ps_strategy import ParameterServerStrategy
from tpu_dist_torch.parallel.sequence import (RingAttention, ring_attention,
                                              sequence_sharding)
from tpu_dist_torch.parallel.strategy import (DefaultStrategy, InputContext,
                                              MirroredStrategy,
                                              MultiWorkerMirroredStrategy,
                                              Strategy, get_strategy,
                                              has_strategy)
from tpu_dist_torch.parallel.tensor import tensor_parallel_specs

__all__ = [
    "CANONICAL_AXES", "DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPE_AXIS",
    "SEQ_AXIS",
    "batch_sharded", "make_mesh", "replicate", "replicated", "shard_batch",
    "CollectiveCommunication", "ReduceOp", "all_gather", "all_reduce",
    "broadcast_from_chief", "bucketed_all_reduce", "host_all_reduce_sum",
    "partition_buckets", "set_collective_logging",
    "DefaultStrategy", "InputContext", "MirroredStrategy",
    "MultiWorkerMirroredStrategy", "ParameterServerStrategy", "Strategy",
    "get_strategy", "has_strategy",
    "RingAttention", "ring_attention", "sequence_sharding",
    "tensor_parallel_specs",
    "PipelinedBlocks", "gpipe_schedule", "make_1f1b_train_step",
    "one_f_one_b", "MixtureOfExperts",
]
