"""Runtime bootstrap: cluster bring-up on ``torch.distributed``.

Counterpart of the bring-up part of ``tpu_dist/cluster/bootstrap.py``
(``initialize``, ``process_index``, ``process_count``, ``is_chief``,
``barrier``, ``cluster_config``). The JAX package dials the JAX
coordination service; here :func:`initialize` parses the same TF_CONFIG
and calls ``torch.distributed.init_process_group``:

* the rendezvous is process 0's declared address
  (``init_method="tcp://host:port"``), the rank is the task's global
  process id, the world size the number of tasks;
* the backend follows the communication mode (:func:`backend_for`): AUTO is NCCL when the process
  trains on CUDA and gloo when it trains on the CPU (``device="cpu"``),
  RING is gloo on either (gloo takes CUDA tensors, staging them through
  the host), NCCL is NCCL and raises on the CPU; never switched silently;
* on CUDA a process takes the local device whose index is the number of
  tasks declared before it on its host. NCCL cannot place two ranks on one
  device, so under NCCL more ranks on a host than it has cards raises;
  under gloo they share the cards in turn (index modulo the card count),
  which is how two workers train on one card;
* one process without a cluster (no TF_CONFIG, or a single task) creates no
  process group: the one-worker local mode, where every collective is the
  identity.

The call blocks until every process has joined, the reference's "training
begins when all servers are ready".
"""

from __future__ import annotations

import atexit
import logging
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from tpu_dist_torch.cluster.config import ClusterConfig
from tpu_dist_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger("tpu_dist_torch")

_STATE_LOCK = threading.Lock()
_CONFIG: Optional[ClusterConfig] = None
#: The device this process trains on once a process group is up.
_DEVICE: Optional[torch.device] = None


def local_device_index(config: ClusterConfig) -> int:
    """The CUDA device index of this task on its host: the number of tasks
    declared before it (in global process order) at the same host."""
    mine = config.task_address.rsplit(":", 1)[0]
    addrs = config.cluster.all_addresses()
    return sum(1 for a in addrs[:config.process_id]
               if a.rsplit(":", 1)[0] == mine)


def backend_for(communication: str, device: torch.device) -> str:
    """The ``torch.distributed`` backend of a ``CollectiveCommunication``
    mode (by name) for a process training on ``device``: RING is TF's
    collective implementation that does not use NCCL, here gloo (on CUDA
    tensors too); NCCL needs CUDA; AUTO is NCCL on CUDA, gloo on the CPU."""
    mode = communication.upper()
    if mode == "RING":
        return "gloo"
    if mode == "NCCL":
        if device.type != "cuda":
            raise ValueError(
                f"CollectiveCommunication.NCCL needs a CUDA device; this "
                f"process trains on {device} (use AUTO or RING for gloo)")
        return "nccl"
    if mode != "AUTO":
        raise ValueError(f"unknown CollectiveCommunication {communication!r}")
    return "nccl" if device.type == "cuda" else "gloo"


def _cuda_device(config: ClusterConfig,
                 backend: str = "nccl") -> torch.device:
    index = local_device_index(config)
    count = torch.cuda.device_count()
    if backend == "gloo":
        return torch.device("cuda", index % count)
    if index >= count:
        raise RuntimeError(
            f"task ({config.task.type}, {config.task.index}) is rank "
            f"{index + 1} on host {config.task_address.rsplit(':', 1)[0]}, "
            f"which has {count} CUDA device(s): NCCL cannot run two ranks on "
            f"one device. Declare at most one worker per card on each host, "
            f"or use the gloo backend (communication='ring', or "
            f"device='cpu')")
    return torch.device("cuda", index)


def initialize(config: ClusterConfig | None = None, *,
               device: DeviceLike = None,
               communication: str = "AUTO") -> torch.device:
    """Bring up the cluster runtime and return the device this process
    trains on. ``config`` defaults to ``TF_CONFIG``; ``device`` is the
    entry points' rule (CUDA unless ``"cpu"``); ``communication`` names a
    ``CollectiveCommunication`` mode, which chooses the backend. With more
    than one task a process group is created once (later calls return its
    device); with one task or none, nothing is brought up."""
    global _CONFIG, _DEVICE
    with _STATE_LOCK:
        if dist.is_available() and dist.is_initialized():
            want = resolve_device(device)
            if want.type != _DEVICE.type:
                raise ValueError(
                    f"the process group is up on {_DEVICE}; cannot train on "
                    f"{want} in the same process")
            return _DEVICE
        if config is None:
            config = ClusterConfig.from_env()
        dev = resolve_device(device)
        _CONFIG = config
        if config is None or config.num_processes < 2:
            logger.info("tpu_dist_torch: single-process local mode on %s",
                        dev)
            return dev
        backend = backend_for(communication, dev)
        if dev.type == "cuda":
            dev = _cuda_device(config, backend)
            torch.cuda.set_device(dev)
        logger.info(
            "tpu_dist_torch: initializing %d-process cluster from TF_CONFIG; "
            "task=(%s, %d) rank=%d chief=%s rendezvous=%s backend=%s "
            "device=%s", config.num_processes, config.task.type,
            config.task.index, config.process_id, config.is_chief,
            config.coordinator_address, backend, dev)
        dist.init_process_group(
            backend, init_method=f"tcp://{config.coordinator_address}",
            world_size=config.num_processes, rank=config.process_id)
        _DEVICE = dev
        atexit.register(_shutdown)
        logger.info("tpu_dist_torch: cluster up — process %d/%d on %s",
                    dist.get_rank(), dist.get_world_size(), dev)
        return dev


def _shutdown() -> None:
    """Leave the process group at exit: the servers shut down when training
    ends. The liveness threads stop first: they use the group's store."""
    from tpu_dist_torch.cluster import liveness

    liveness.stop_shared()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def group_device() -> Optional[torch.device]:
    """The device this process trains on in its process group (None
    without a group)."""
    return _DEVICE if is_initialized() else None


def device_of_group() -> torch.device:
    """The device host data crosses in the process group's collectives:
    this process's card under NCCL, the CPU under gloo (and with no
    group)."""
    if is_initialized() and dist.get_backend() == "nccl":
        return _DEVICE
    return torch.device("cpu")


def is_initialized() -> bool:
    """True once a process group is up."""
    return dist.is_available() and dist.is_initialized()


def cluster_config() -> Optional[ClusterConfig]:
    """The parsed TF_CONFIG for this process, if any."""
    return _CONFIG


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_chief() -> bool:
    """Chief duty holder: explicit TF_CONFIG chief, else process 0."""
    if _CONFIG is not None:
        return _CONFIG.is_chief
    return process_index() == 0


def barrier(name: str = "tpu_dist_barrier") -> None:
    """Cluster-wide rendezvous (a no-op for one process): the reference's
    startup barrier. Fires the collectives' fault hook before and their
    observe hook after, with the seconds it waited (the cluster's skew)."""
    from tpu_dist_torch.parallel.collectives import (fire_fault_hook,
                                                     fire_observe_hook)

    fire_fault_hook("barrier")
    t0 = time.perf_counter()
    if process_count() > 1:
        logger.debug("tpu_dist_torch: barrier %s", name)
        dist.barrier()
    fire_observe_hook("barrier", seconds=time.perf_counter() - t0)
