"""Input-pipeline layer: datasets, combinators, shard policies, distribution."""

from tpu_dist_torch.data.distribute import DistributedDataset
from tpu_dist_torch.data.pipeline import AutoShardPolicy, Dataset, Options
from tpu_dist_torch.data.sharding import resolve_policy, shard_dataset
from tpu_dist_torch.data.sources import (DatasetInfo, SplitInfo,
                                         disable_progress_bar, load,
                                         load_arrays)

__all__ = [
    "AutoShardPolicy", "Dataset", "DatasetInfo", "DistributedDataset",
    "Options", "SplitInfo", "disable_progress_bar", "load", "load_arrays",
    "resolve_policy", "shard_dataset",
]
