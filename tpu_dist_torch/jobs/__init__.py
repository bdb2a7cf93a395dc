"""tpu_dist_torch.jobs — the multi-tenant job runtime on one device pool.

Counterpart of ``tpu_dist/jobs``: N training and serving jobs packed onto
one pool with nothing shared but devices.

* :class:`~tpu_dist_torch.jobs.spec.JobSpec` declares one job (kind,
  slice request, priority, workload budget); its
  :class:`~tpu_dist_torch.jobs.spec.JobNamespace` derives every per-job
  resource (seed, checkpoint directory, ``job.<name>.*`` metric prefix,
  event log) from the spec alone, so a job's outputs are the same solo or
  packed.
* :class:`~tpu_dist_torch.jobs.runtime.MeshRuntime` owns the pool and the
  program cache; jobs lease static slices through
  :func:`~tpu_dist_torch.jobs.runtime.job_scope`, and Trainer and
  ServeEngine take their programs through it (nothing changes for a solo
  run).
* :class:`~tpu_dist_torch.jobs.scheduler.PackingScheduler` admits by
  priority (FIFO within, with backfilling);
  :class:`~tpu_dist_torch.jobs.scheduler.JobPool` runs each admitted job
  as its own supervised gang of processes, one a slot: per-job fault
  domains, so ``job_kill@jobN`` restarts only job N.

``python -m tpu_dist_torch.jobs --bench`` packs the seeded mix and reports
makespan against serial; ``--chaos`` runs the gated multi-job fault suite.
"""

from tpu_dist_torch.jobs.runtime import (JobContext, MeshRuntime,
                                         SubmeshLease, current_job,
                                         job_scope)
from tpu_dist_torch.jobs.scheduler import (DONE, FAILED, QUEUED, RUNNING,
                                           JobPool, JobRecord,
                                           PackingScheduler)
from tpu_dist_torch.jobs.spec import (JOB_ROOT_ENV, JOB_SPEC_ENV,
                                      JobNamespace, JobSpec, derive_job_seed)

__all__ = [
    "JobSpec", "JobNamespace", "derive_job_seed",
    "JOB_SPEC_ENV", "JOB_ROOT_ENV",
    "MeshRuntime", "SubmeshLease", "JobContext", "current_job", "job_scope",
    "PackingScheduler", "JobPool", "JobRecord",
    "QUEUED", "RUNNING", "DONE", "FAILED",
]
