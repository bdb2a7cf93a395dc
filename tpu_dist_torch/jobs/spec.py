"""JobSpec: one declarative unit of work for the multi-tenant job runtime.

Counterpart of ``tpu_dist/jobs/spec.py``, the same wire format and seeds
(:func:`derive_job_seed` equals the reference's integer for integer), so
either package's pool can run the other's specs. A job's ``devices``
counts processes here: the port drives one device a process, so a job of
N devices is a gang of N processes (ROADMAP item 12b for several devices
in one).

The paper's subject assumes one training job owns the whole cluster; a
production pool packs N small jobs onto one device mesh. A
:class:`JobSpec` names everything the runtime needs to place and run one
of them — what it is (``kind``: train or serve), how big a submesh slice
it wants (``devices``), how urgently (``priority``), and how much work it
does (step budget for training, request/token budget for serving) — and a
:class:`JobNamespace` derives every per-job resource from the spec alone:

* **RNG stream** — :func:`derive_job_seed` folds the job *name* into the
  base seed (CRC-32 of the name, mixed with the same multiplicative
  constant the trainer's epoch fold-in uses), so two jobs never share a
  key stream and — because the fold depends only on (name, seed), never
  on placement or neighbors — a job's stream is bit-identical whether it
  runs alone on the pool or packed beside others. That placement
  independence is the isolation property the jobs tests pin.
* **checkpoint directory** — ``<root>/jobs/<name>/ckpt``: restarts of job
  A can never resume from (or tear) job B's manifests.
* **observe metric prefix** — ``job.<name>.``: one shared metrics
  registry serves the whole pool without series colliding.
* **resilience event log** — ``<root>/jobs/<name>/events.jsonl``: each
  job's fault/restart/recovery trail reads like a solo run's, which is
  what lets the blast-radius gate assert a neighbor's log is untouched.

Specs are JSON round-trippable (the JobPool ships them to worker
processes through ``$TPU_DIST_JOB_SPEC``) and frozen — scheduling state
lives in the scheduler's :class:`~tpu_dist_torch.jobs.scheduler.JobRecord`,
never on the spec, so one spec can be submitted, re-run solo for a parity
baseline, and compared across runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import zlib
from typing import Optional

#: Environment variable carrying a job's JSON spec into its worker gang.
JOB_SPEC_ENV = "TPU_DIST_JOB_SPEC"

#: Environment variable carrying the pool's namespace root directory.
JOB_ROOT_ENV = "TPU_DIST_JOB_ROOT"

#: Valid job kinds.
KINDS = ("train", "serve")

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]*$")

#: The job-domain fold constant. Deliberately DISTINCT from the
#: trainer's per-epoch fold (100003 in training/trainer.py): two derive
#: domains sharing a multiplier can land on the same stream for small
#: coordinate pairs (SC604). Each domain owns its own prime.
_FOLD = 1000003


def derive_job_seed(name: str, base_seed: int = 0) -> int:
    """The job-name-derived RNG fold-in: a stable 31-bit seed from
    ``(name, base_seed)`` only. Placement, neighbors, and submission
    order do not enter — the whole point is that a packed job's stream
    equals its solo stream bit for bit."""
    digest = zlib.crc32(name.encode("utf-8")) & 0xFFFFFFFF
    return (base_seed * _FOLD + digest) % (2 ** 31)


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One job: identity, shape request, priority, and workload budget.

    ``devices`` is the submesh slice size the job asks the pool for; the
    runtime validates it divides the pool (static partition, the same
    divisor rule reshape-on-restore enforces). ``priority`` orders
    admission (higher first, FIFO within a priority). The workload knobs
    size the built-in deterministic demo workloads
    (:mod:`tpu_dist_torch.jobs.worker`): train jobs run ``epochs x
    steps_per_epoch`` compiled steps at global batch ``batch``; serve
    jobs decode ``requests`` greedy streams of up to ``max_new`` tokens.
    """

    name: str
    kind: str = "train"
    devices: int = 1
    priority: int = 0
    seed: int = 0
    # -- train budget --------------------------------------------------------
    epochs: int = 2
    steps_per_epoch: int = 4
    batch: int = 8
    # -- serve budget --------------------------------------------------------
    requests: int = 4
    max_new: int = 8
    #: Inter-arrival pacing (seconds) for the serve workload: request i
    #: is submitted no earlier than ``i * arrival_s`` after the first.
    #: 0 = an instantaneous burst. Paced serve jobs are what give a
    #: packed pool its makespan win — their idle gaps are exactly the
    #: capacity train jobs backfill (decoded token streams are pacing-
    #: independent, so the parity gates are untouched).
    arrival_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown job kind {self.kind!r}; valid: {list(KINDS)}")
        if not _NAME_RE.match(self.name or ""):
            raise ValueError(
                f"job name {self.name!r} must match {_NAME_RE.pattern} "
                f"(it names checkpoint dirs and metric series)")
        for field in ("devices", "epochs", "steps_per_epoch", "batch",
                      "requests", "max_new"):
            if int(getattr(self, field)) < 1:
                raise ValueError(
                    f"job {self.name!r}: {field} must be >= 1, "
                    f"got {getattr(self, field)}")
        if float(self.arrival_s) < 0:
            raise ValueError(
                f"job {self.name!r}: arrival_s must be >= 0, "
                f"got {self.arrival_s}")

    # -- budgets -------------------------------------------------------------

    @property
    def total_steps(self) -> int:
        return self.epochs * self.steps_per_epoch

    # -- wire format ---------------------------------------------------------

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @classmethod
    def from_json(cls, obj: dict) -> "JobSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown JobSpec field(s) {sorted(unknown)}")
        return cls(**obj)

    @classmethod
    def from_env(cls) -> Optional["JobSpec"]:
        raw = os.environ.get(JOB_SPEC_ENV)
        if not raw or not raw.strip():
            return None
        return cls.from_json(json.loads(raw))


class JobNamespace:
    """Every per-job resource, derived from (spec, root) and nothing else.

    ``root`` may be None (a caller that needs only the
    RNG/metric halves of the namespace); the path properties then raise
    if touched, loudly, instead of scattering files into the cwd.
    """

    def __init__(self, spec: JobSpec, root: Optional[str | os.PathLike]):
        self.spec = spec
        self.root = None if root is None else pathlib.Path(root)

    # -- RNG -----------------------------------------------------------------

    @property
    def seed(self) -> int:
        """The job's isolated RNG seed (job-name-derived fold-in)."""
        return derive_job_seed(self.spec.name, self.spec.seed)

    # -- observe -------------------------------------------------------------

    @property
    def metric_prefix(self) -> str:
        return f"job.{self.spec.name}."

    def metric(self, name: str) -> str:
        """``job.<name>.<metric>`` — the namespaced series name."""
        return self.metric_prefix + name

    # -- filesystem ----------------------------------------------------------

    def _dir(self, leaf: str) -> pathlib.Path:
        if self.root is None:
            raise RuntimeError(
                f"job {self.spec.name!r}: namespace has no root directory "
                f"(pass root= to JobNamespace for filesystem resources)")
        return self.root / "jobs" / self.spec.name / leaf

    @property
    def job_dir(self) -> pathlib.Path:
        return self._dir("")

    @property
    def checkpoint_dir(self) -> pathlib.Path:
        return self._dir("ckpt")

    @property
    def event_log(self) -> pathlib.Path:
        return self._dir("events.jsonl")

    @property
    def observe_dir(self) -> pathlib.Path:
        return self._dir("observe")

    @property
    def log_dir(self) -> pathlib.Path:
        return self._dir("logs")

    @property
    def journal_dir(self) -> pathlib.Path:
        """Serve jobs: the request journal's directory."""
        return self._dir("journal")
