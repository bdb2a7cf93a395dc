"""Cluster layer: TF_CONFIG-shaped config, ``torch.distributed`` bring-up
and peer liveness."""

from tpu_dist_torch.cluster.bootstrap import (barrier, cluster_config,
                                              initialize, is_chief,
                                              is_initialized, process_count,
                                              process_index)
from tpu_dist_torch.cluster.config import (TF_CONFIG_ENV, ClusterConfig,
                                           ClusterConfigError, ClusterSpec,
                                           TaskInfo, make_local_cluster)
from tpu_dist_torch.cluster.liveness import (LivenessMonitor,
                                             PeerUnavailableError,
                                             check_peer_health)

__all__ = [
    "LivenessMonitor", "PeerUnavailableError", "check_peer_health",
    "TF_CONFIG_ENV", "ClusterConfig", "ClusterConfigError", "ClusterSpec",
    "TaskInfo", "make_local_cluster", "barrier", "cluster_config",
    "initialize", "is_chief", "is_initialized", "process_count",
    "process_index",
]
