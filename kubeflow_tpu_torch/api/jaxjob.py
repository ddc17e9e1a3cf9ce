"""JaxJob — the flagship training-job kind.

Capability target: the union of the reference's PyTorchJob / TFJob / MPIJob /
JAXJob CRDs [upstream: kubeflow/training-operator ->
pkg/apis/kubeflow.org/v1/{pytorch,tensorflow,mpi,jax}job_types.go], collapsed
into the one shape TPU training actually needs:

- a single logical ``worker`` replica role (rank 0 doubles as the
  ``jax.distributed`` coordinator — the JAXJob-controller precedent), with
  optional extra roles for heterogenous jobs (e.g. a ``dataset`` role);
- gang semantics by construction (``SchedulingPolicy.min_available`` defaults
  to the full worker count, the Volcano PodGroup ``minMember`` analog);
- the rendezvous contract is the ``jax.distributed.initialize`` triple, not
  MASTER_ADDR/RANK/WORLD_SIZE or an ssh hostfile;
- an ``ElasticPolicy`` analog that means what elasticity *can* mean on TPU
  slices: checkpoint-restart reshape between allowed world sizes (Tenplex
  pattern, PAPERS.md), not in-place c10d rejoin.

The port's copy of ``kubeflow_tpu/api/jaxjob.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

from typing import Optional

from pydantic import Field, field_validator, model_validator

from .common import (
    JobCondition,
    ReplicaSpec,
    ReplicaStatus,
    RunPolicy,
    TypedObject,
    _Model,
)

WORKER = "worker"
KIND_JAXJOB = "JaxJob"


class ElasticPolicy(_Model):
    """Checkpoint-restart elasticity [reference analog: PyTorchJob
    ElasticPolicy, upstream: pkg/controller.v1/pytorch/].  TPU slices cannot
    grow in place, so elasticity = save, re-admit at a new world size in
    [min_replicas, max_replicas], reshape-restore (orbax)."""

    min_replicas: int = 1
    max_replicas: int = 1
    # restart budget consumed by reshape events (distinct from failure backoff)
    max_restarts: int = 3

    @model_validator(mode="after")
    def _ordered(self) -> "ElasticPolicy":
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        return self


class JaxJobSpec(_Model):
    run_policy: RunPolicy = Field(default_factory=RunPolicy)
    replica_specs: dict[str, ReplicaSpec] = Field(default_factory=dict)
    # 0 = let the controller allocate a port at gang-bind time (the safe
    # default: submit-time allocation races with other gangs on the host,
    # r1 verdict weak #6); a fixed value pins it (real slices, known VIPs).
    coordinator_port: int = 0
    elastic_policy: Optional[ElasticPolicy] = None
    # Mesh axis sizes requested for the job, e.g. {"data": 4, "model": 2};
    # validated against the chip count by kubeflow_tpu_torch.parallel.mesh.
    mesh: dict[str, int] = Field(default_factory=dict)

    @field_validator("replica_specs")
    @classmethod
    def _roles(cls, v: dict[str, ReplicaSpec]) -> dict[str, ReplicaSpec]:
        for role in v:
            if role != role.lower():
                raise ValueError(f"replica role {role!r} must be lowercase")
        return v

    @property
    def worker_count(self) -> int:
        spec = self.replica_specs.get(WORKER)
        return spec.replicas if spec else 0

    @property
    def total_replicas(self) -> int:
        return sum(s.replicas for s in self.replica_specs.values())


class JaxJobStatus(_Model):
    conditions: list[JobCondition] = Field(default_factory=list)
    replica_statuses: dict[str, ReplicaStatus] = Field(default_factory=dict)
    start_time: Optional[float] = None
    completion_time: Optional[float] = None
    restart_count: int = 0
    # Recovery probes (scripts/recovery_bench.py): when the last gang
    # restart was decided, and how long that restart took to bring every
    # worker back to Running (restart decision -> gang re-running).
    last_restart_time: Optional[float] = None
    last_recovery_seconds: Optional[float] = None
    # Gang-startup probe: wall-clock seconds from job creation to every
    # process past its first collective barrier (a headline BASELINE metric).
    gang_startup_seconds: Optional[float] = None
    # Coordinator port the controller resolved for this job (when
    # spec.coordinator_port == 0); stable across gang restarts.
    coordinator_port: Optional[int] = None


class JaxJob(TypedObject):
    kind: str = KIND_JAXJOB
    spec: JaxJobSpec = Field(default_factory=JaxJobSpec)
    status: JaxJobStatus = Field(default_factory=JaxJobStatus)
