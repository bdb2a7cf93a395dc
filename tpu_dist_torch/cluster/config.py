"""Cluster configuration: TF_CONFIG-shaped JSON -> cluster spec + task identity.

Counterpart of ``tpu_dist/cluster/config.py``, copied: the reference's
whole cluster-config surface is the ``TF_CONFIG`` environment variable, a
JSON object with

* ``cluster``: map of role -> list of ``host:port`` strings (``chief``,
  ``worker``, ``ps``, ``evaluator``);
* ``task``: ``{"type": <role>, "index": <0-based int>}`` naming this
  process (the ``cluster`` map is identical on every node).

This module parses it into an immutable :class:`ClusterConfig`, which the
port's bootstrap (``tpu_dist_torch.cluster.bootstrap``) maps onto
``torch.distributed.init_process_group``: process 0's declared address is
the rendezvous, the global process id is the rank. Chief semantics: an
explicit ``chief`` task if declared, otherwise worker 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Mapping, Sequence

TF_CONFIG_ENV = "TF_CONFIG"

#: Roles of TF_CONFIG, in the global order that assigns process ids: chief
#: first (it is the rendezvous and checkpoint writer), then workers, then
#: parameter servers, then evaluators.
KNOWN_ROLES = ("chief", "worker", "ps", "evaluator")

_ADDR_RE = re.compile(r"^(?P<host>[^:]+|\[[0-9a-fA-F:]+\]):(?P<port>\d{1,5})$")


class ClusterConfigError(ValueError):
    """Raised when a TF_CONFIG-shaped payload is malformed or inconsistent."""


@dataclasses.dataclass(frozen=True)
class TaskInfo:
    """This process's role and 0-based index within that role."""

    type: str
    index: int

    def __post_init__(self) -> None:
        if self.index < 0:
            raise ClusterConfigError(f"task index must be >= 0, got {self.index}")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Role -> ordered list of ``host:port`` addresses, identical on every
    node."""

    jobs: Mapping[str, tuple[str, ...]]

    def __post_init__(self) -> None:
        frozen = {}
        for role, addrs in dict(self.jobs).items():
            if isinstance(addrs, str):
                raise ClusterConfigError(
                    f"cluster role {role!r} must map to a list of addresses, "
                    f"got a bare string {addrs!r}"
                )
            addr_tuple = tuple(addrs)
            for a in addr_tuple:
                if not isinstance(a, str) or not _ADDR_RE.match(a):
                    raise ClusterConfigError(
                        f"cluster role {role!r} has malformed address {a!r}; "
                        "expected 'host:port'"
                    )
            frozen[role] = addr_tuple
        object.__setattr__(self, "jobs", frozen)

    @property
    def roles(self) -> tuple[str, ...]:
        """Roles in canonical order (known roles first, then extras sorted)."""
        known = [r for r in KNOWN_ROLES if r in self.jobs]
        extra = sorted(r for r in self.jobs if r not in KNOWN_ROLES)
        return tuple(known + extra)

    def num_tasks(self, role: str) -> int:
        return len(self.jobs.get(role, ()))

    @property
    def num_processes(self) -> int:
        return sum(len(a) for a in self.jobs.values())

    def task_address(self, role: str, index: int) -> str:
        try:
            return self.jobs[role][index]
        except (KeyError, IndexError):
            raise ClusterConfigError(
                f"task ({role!r}, {index}) is not an entry of the cluster spec "
                f"{dict(self.jobs)!r}"
            ) from None

    def global_index(self, role: str, index: int) -> int:
        """Flat 0-based process id: roles in canonical order, index within role.

        With no explicit chief, worker 0 gets global index 0, the "worker 0
        defaults to chief" rule.
        """
        self.task_address(role, index)  # validates membership
        offset = 0
        for r in self.roles:
            if r == role:
                return offset + index
            offset += self.num_tasks(r)
        raise AssertionError("unreachable")

    def all_addresses(self) -> tuple[str, ...]:
        return tuple(
            addr for role in self.roles for addr in self.jobs.get(role, ())
        )


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Parsed cluster spec + this process's task identity."""

    cluster: ClusterSpec
    task: TaskInfo

    def __post_init__(self) -> None:
        # The task must name an entry of the cluster map.
        self.cluster.task_address(self.task.type, self.task.index)

    # -- identity ------------------------------------------------------------

    @property
    def is_chief(self) -> bool:
        """Chief = explicit 'chief' task, else worker 0."""
        if "chief" in self.cluster.jobs:
            return self.task.type == "chief" and self.task.index == 0
        return self.task.type == "worker" and self.task.index == 0

    @property
    def process_id(self) -> int:
        return self.cluster.global_index(self.task.type, self.task.index)

    @property
    def num_processes(self) -> int:
        return self.cluster.num_processes

    @property
    def task_address(self) -> str:
        return self.cluster.task_address(self.task.type, self.task.index)

    @property
    def coordinator_address(self) -> str:
        """Address of global process 0 — the rendezvous every process dials
        (``init_method="tcp://<address>"``). The declared ``host:port`` is
        used verbatim: no TF gRPC servers exist here, so the TF_CONFIG ports
        are ours to bind."""
        first_role = self.cluster.roles[0]
        return self.cluster.task_address(first_role, 0)

    # -- parsing -------------------------------------------------------------

    @classmethod
    def from_json(cls, payload: str | Mapping) -> "ClusterConfig":
        if isinstance(payload, str):
            try:
                payload = json.loads(payload)
            except json.JSONDecodeError as e:
                raise ClusterConfigError(f"TF_CONFIG is not valid JSON: {e}") from e
        if not isinstance(payload, Mapping):
            raise ClusterConfigError(
                f"TF_CONFIG must be a JSON object, got {type(payload).__name__}"
            )
        cluster = payload.get("cluster")
        task = payload.get("task")
        if cluster is None:
            raise ClusterConfigError("TF_CONFIG missing required 'cluster' key")
        if task is None:
            raise ClusterConfigError("TF_CONFIG missing required 'task' key")
        if not isinstance(task, Mapping) or "type" not in task or "index" not in task:
            raise ClusterConfigError(
                "TF_CONFIG 'task' must be an object with 'type' and 'index'"
            )
        return cls(
            cluster=ClusterSpec(jobs=dict(cluster)),
            task=TaskInfo(type=str(task["type"]), index=int(task["index"])),
        )

    @classmethod
    def from_env(cls, environ: Mapping[str, str] | None = None) -> "ClusterConfig | None":
        """Parse TF_CONFIG from the environment; None when unset/empty.

        An absent or empty TF_CONFIG means "no cluster": the single-worker
        local mode.
        """
        environ = os.environ if environ is None else environ
        raw = environ.get(TF_CONFIG_ENV, "").strip()
        if not raw:
            return None
        return cls.from_json(raw)


def make_local_cluster(num_workers: int, base_port: int = 23456,
                       host: str = "127.0.0.1") -> list[dict]:
    """Synthesize per-worker TF_CONFIG dicts for an N-process loopback cluster.

    Used by the multi-process tests and by local launch scripts.
    """
    if num_workers < 1:
        raise ClusterConfigError("num_workers must be >= 1")
    workers = [f"{host}:{base_port + i}" for i in range(num_workers)]
    return [
        {"cluster": {"worker": workers}, "task": {"type": "worker", "index": i}}
        for i in range(num_workers)
    ]
