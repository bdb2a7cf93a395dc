"""Utilities: progress bar, profiling."""

from tpu_dist_torch.utils import profiler
from tpu_dist_torch.utils.progbar import ProgressBar

__all__ = ["ProgressBar", "profiler"]
