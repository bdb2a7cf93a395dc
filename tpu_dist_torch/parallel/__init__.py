"""Parallelism layer: collectives and distribution strategies."""

from tpu_dist_torch.parallel.collectives import (CollectiveCommunication,
                                                 ReduceOp, all_reduce,
                                                 broadcast_from_chief)
from tpu_dist_torch.parallel.strategy import (DefaultStrategy,
                                              MirroredStrategy,
                                              MultiWorkerMirroredStrategy,
                                              Strategy, get_strategy,
                                              has_strategy)

__all__ = [
    "CollectiveCommunication", "ReduceOp", "all_reduce",
    "broadcast_from_chief",
    "DefaultStrategy", "MirroredStrategy", "MultiWorkerMirroredStrategy",
    "Strategy", "get_strategy", "has_strategy",
]
