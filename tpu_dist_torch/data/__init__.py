"""Input-pipeline layer: datasets, combinators, shard policies, distribution,
device-resident datasets."""

from tpu_dist_torch.data.device import DeviceDataset, device_pipeline
from tpu_dist_torch.data.distribute import DistributedDataset
from tpu_dist_torch.data.pipeline import (AutoShardPolicy, Dataset,
                                          DevicePrefetcher, Options)
from tpu_dist_torch.data.sharding import resolve_policy, shard_dataset
from tpu_dist_torch.data.sources import (DatasetInfo, SplitInfo,
                                         disable_progress_bar, image_shape,
                                         load, load_arrays, num_classes,
                                         write_sharded)

__all__ = [
    "AutoShardPolicy", "Dataset", "DatasetInfo", "DeviceDataset",
    "DevicePrefetcher", "DistributedDataset", "Options", "SplitInfo",
    "device_pipeline", "disable_progress_bar", "image_shape", "load",
    "load_arrays", "num_classes", "resolve_policy", "shard_dataset",
    "write_sharded",
]
