"""Common API types shared by every job kind in the control plane.

Capability parity with the reference's shared CRD vocabulary
[upstream: kubeflow/training-operator -> pkg/apis/kubeflow.org/v1/common_types.go]:
``RunPolicy``, ``ReplicaSpec``, ``ReplicaStatus``, ``JobCondition``,
``SchedulingPolicy``.  The reference expresses these as Kubernetes CRD Go
structs validated by OpenAPI schemas and admission webhooks; here they are
typed pydantic models validated at construction time, with defaulting exposed
as explicit pure functions (``kubeflow_tpu_torch.api.validation``) so tests can
exercise the webhook-equivalent logic directly.

Divergences from the upstream operator:

- Rendezvous config is the ``jax.distributed.initialize`` triple
  (coordinator address / num processes / process id) instead of
  ``MASTER_ADDR``/``RANK``/``WORLD_SIZE`` — see
  ``kubeflow_tpu_torch.runtime.bootstrap``.

The port's copy of ``kubeflow_tpu/api/common.py``, device-free like it,
with the same names except one: a pod's accelerators are NVIDIA cards,
``Resources.gpu`` (the ``nvidia.com/gpu`` count), where the reference
counts TPU chips (``tpu`` and a ``TpuTopology``). A spec that asks for
``tpu`` is refused when it is parsed, naming ``gpu``: the port has no TPU
to give, and reading the count as cards would hide the mistake. It
imports nothing of the reference package.
"""

from __future__ import annotations

import enum
import re
import time
from typing import Any, Optional

from pydantic import (
    BaseModel,
    ConfigDict,
    Field,
    field_validator,
    model_validator,
)

API_GROUP = "kubeflow-tpu.dev"
API_VERSION = "v1"


class _Model(BaseModel):
    """Base config: reject unknown fields (the OpenAPI-schema equivalent)."""

    model_config = ConfigDict(extra="forbid", validate_assignment=True)


# ---------------------------------------------------------------------------
# Object metadata (the k8s ObjectMeta analog, trimmed to what the plane uses)
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


class ObjectMeta(_Model):
    name: str
    namespace: str = "default"
    labels: dict[str, str] = Field(default_factory=dict)
    annotations: dict[str, str] = Field(default_factory=dict)
    uid: Optional[str] = None
    resource_version: int = 0
    creation_timestamp: Optional[float] = None
    deletion_timestamp: Optional[float] = None
    owner_references: list["OwnerReference"] = Field(default_factory=list)

    @field_validator("name")
    @classmethod
    def _dns1123(cls, v: str) -> str:
        if len(v) > 253 or not _NAME_RE.match(v):
            raise ValueError(
                f"name {v!r} must be a DNS-1123 label "
                "(lowercase alphanumerics and '-', start/end alphanumeric)"
            )
        return v


class OwnerReference(_Model):
    kind: str
    name: str
    uid: Optional[str] = None
    controller: bool = True


# ---------------------------------------------------------------------------
# Conditions and status vocabulary
# ---------------------------------------------------------------------------


class JobConditionType(str, enum.Enum):
    """Lifecycle conditions, same vocabulary as the reference's JobCondition
    [upstream: kubeflow/training-operator -> pkg/apis/kubeflow.org/v1]."""

    CREATED = "Created"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    SUSPENDED = "Suspended"


class JobCondition(_Model):
    type: JobConditionType
    status: bool = True
    reason: str = ""
    message: str = ""
    last_transition_time: float = Field(default_factory=time.time)


def set_condition(conditions: list[JobCondition], cond: JobCondition) -> list[JobCondition]:
    """Upsert ``cond``; terminal conditions flip the other terminals off.

    Mirrors the reference's status-aggregation helpers
    [upstream: training-operator -> pkg/controller.v1/common/status.go]:
    at most one condition per type, Running is set False when a terminal
    condition lands, timestamps only bump on actual transitions.
    """
    out: list[JobCondition] = []
    replaced = False
    for existing in conditions:
        if existing.type == cond.type:
            if existing.status == cond.status and existing.reason == cond.reason:
                cond = existing  # no transition -> keep original timestamp
            out.append(cond)
            replaced = True
        elif cond.type in (JobConditionType.SUCCEEDED, JobConditionType.FAILED) and existing.type in (
            JobConditionType.RUNNING,
            JobConditionType.RESTARTING,
        ):
            if existing.status:
                out.append(
                    JobCondition(
                        type=existing.type,
                        status=False,
                        reason=cond.reason,
                        message=cond.message,
                    )
                )
            else:
                out.append(existing)
        else:
            out.append(existing)
    if not replaced:
        out.append(cond)
    return out


def get_condition(
    conditions: list[JobCondition], ctype: JobConditionType
) -> Optional[JobCondition]:
    for c in conditions:
        if c.type == ctype:
            return c
    return None


def has_condition(conditions: list[JobCondition], ctype: JobConditionType) -> bool:
    c = get_condition(conditions, ctype)
    return c is not None and c.status


class ReplicaStatus(_Model):
    """Pod-phase rollup per replica type [upstream: common_types.go ReplicaStatus]."""

    active: int = 0
    succeeded: int = 0
    failed: int = 0


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


class CleanPodPolicy(str, enum.Enum):
    ALL = "All"
    RUNNING = "Running"
    NONE = "None"


class RestartPolicy(str, enum.Enum):
    ALWAYS = "Always"
    ON_FAILURE = "OnFailure"
    NEVER = "Never"
    # Retry only on retryable exit codes (128+ = killed by signal, plus an
    # allowlist) — the reference's ExitCode policy.
    EXIT_CODE = "ExitCode"


#: Exit codes treated as retryable under RestartPolicy.EXIT_CODE.  The
#: reference treats 1-127 as permanent and 128+ (signal deaths) as retryable;
#: we add 42 (conventional "retry me" in kubeflow examples).
RETRYABLE_EXIT_CODES = frozenset({42}) | frozenset(range(128, 256))


def is_retryable_exit(code: int) -> bool:
    return code in RETRYABLE_EXIT_CODES


class SchedulingPolicy(_Model):
    """Gang-scheduling knobs [upstream: common_types.go SchedulingPolicy]."""

    min_available: Optional[int] = None
    queue: str = "default"
    priority_class: Optional[str] = None
    # Seconds a gang may sit Pending before the job is marked Failed
    # (the Volcano `pod-group.scheduling.sigs.k8s.io` timeout analog).
    schedule_timeout_seconds: Optional[float] = None


class RunPolicy(_Model):
    """Job-level execution policy [upstream: common_types.go RunPolicy]."""

    clean_pod_policy: CleanPodPolicy = CleanPodPolicy.NONE
    ttl_seconds_after_finished: Optional[float] = None
    active_deadline_seconds: Optional[float] = None
    backoff_limit: int = 0
    scheduling_policy: Optional[SchedulingPolicy] = None
    suspend: bool = False
    # Gang-restart pacing: the delay before restart #n is
    # ``min(restart_backoff_seconds * 2**(n-1), restart_backoff_max_seconds)``
    # with +-50% deterministic jitter, so a flapping node cannot drive a
    # fixed-interval restart storm (ISSUE 1: the 0.05 s requeue was the
    # storm).
    restart_backoff_seconds: float = 0.1
    restart_backoff_max_seconds: float = 5.0
    # Restart-budget window: after this many seconds of stable running,
    # ``status.restart_count`` resets to 0 — a long-lived job is judged by
    # its recent behavior, not by backoff_limit accumulated over weeks.
    # None = the classic lifetime budget.
    restart_window_seconds: Optional[float] = None


# ---------------------------------------------------------------------------
# Replica / pod template
# ---------------------------------------------------------------------------


class Resources(_Model):
    cpu: float = 1.0
    memory_gb: float = 1.0
    gpu: int = Field(default=0, ge=0)  # nvidia.com/gpu card count per pod

    @model_validator(mode="before")
    @classmethod
    def _no_tpu(cls, v):
        if isinstance(v, dict) and ({"tpu", "tpu_topology"} & set(v)):
            raise ValueError(
                "resources.tpu: this platform's accelerators are NVIDIA "
                "cards; ask for them as resources.gpu (nvidia.com/gpu "
                "cards per pod)")
        return v


class Container(_Model):
    """What runs inside a replica.  The reference carries a full k8s
    PodTemplateSpec; this plane runs local processes, so the template is a
    command + env + resources.  ``entrypoint`` may name a registered python
    callable (``module:function``) instead of an argv, which is how the
    runtime launches trainers without docker images.
    """

    command: list[str] = Field(default_factory=list)
    entrypoint: Optional[str] = None  # "pkg.module:func" python target
    args: list[str] = Field(default_factory=list)
    env: dict[str, str] = Field(default_factory=dict)
    resources: Resources = Field(default_factory=Resources)
    working_dir: Optional[str] = None

    @field_validator("env", mode="before")
    @classmethod
    def _stringify_env(cls, v):
        # env vars are strings by nature; numbers arrive here via typed
        # trial-parameter substitution (${trialParameters.x} in a template)
        if isinstance(v, dict):
            return {k: str(val) for k, val in v.items()}
        return v


class ReplicaSpec(_Model):
    """[upstream: common_types.go ReplicaSpec] — replicas of one role."""

    replicas: int = 1
    restart_policy: RestartPolicy = RestartPolicy.NEVER
    template: Container = Field(default_factory=Container)

    @field_validator("replicas")
    @classmethod
    def _pos(cls, v: int) -> int:
        if v < 0:
            raise ValueError("replicas must be >= 0")
        return v


def object_key(namespace: str, name: str) -> str:
    return f"{namespace}/{name}"


def replica_pod_name(job_name: str, replica_type: str, index: int) -> str:
    """Stable pod naming ``<job>-<type>-<index>`` — the DNS contract every
    rendezvous scheme relies on [upstream: training-operator headless
    Services, pkg/controller.v1/common/service.go]."""
    return f"{job_name}-{replica_type.lower()}-{index}"


def replica_service_dns(job_name: str, replica_type: str, index: int, namespace: str) -> str:
    return f"{replica_pod_name(job_name, replica_type, index)}.{namespace}.svc"


class TypedObject(_Model):
    """Base for every API object stored in the control plane."""

    api_version: str = f"{API_GROUP}/{API_VERSION}"
    kind: str = ""
    metadata: ObjectMeta

    @property
    def key(self) -> str:
        return object_key(self.metadata.namespace, self.metadata.name)
