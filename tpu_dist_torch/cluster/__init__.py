"""Cluster layer: TF_CONFIG-shaped config + ``torch.distributed`` bring-up."""

from tpu_dist_torch.cluster.bootstrap import (barrier, cluster_config,
                                              initialize, is_chief,
                                              is_initialized, process_count,
                                              process_index)
from tpu_dist_torch.cluster.config import (TF_CONFIG_ENV, ClusterConfig,
                                           ClusterConfigError, ClusterSpec,
                                           TaskInfo, make_local_cluster)

__all__ = [
    "TF_CONFIG_ENV", "ClusterConfig", "ClusterConfigError", "ClusterSpec",
    "TaskInfo", "make_local_cluster", "barrier", "cluster_config",
    "initialize", "is_chief", "is_initialized", "process_count",
    "process_index",
]
