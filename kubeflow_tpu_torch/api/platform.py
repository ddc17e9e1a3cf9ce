"""Platform-UX API objects: Profile, Notebook, PodDefault.

The kubeflow/kubeflow shell tier (SURVEY.md §2.4) [upstream:
kubeflow/kubeflow -> components/profile-controller (Profile CRD: namespace-
per-user multi-tenancy + ResourceQuota), components/notebook-controller
(Notebook CRD: a stateful per-user workbench pod with stable URL + idle
culling), components/admission-webhook (PodDefault: label-selected env/
volume injection)].  Divergences: quotas are enforced by the gang
scheduler at admission (so a whole gang either fits the profile's quota or
stays Pending — quota overcommit can't strand half a gang's cards), and
notebooks are plain entrypoint pods on the same kubelet contract as jobs.

The port's copy of ``kubeflow_tpu/api/platform.py``, device-free like
it, with the same names; a quota counts cards as ``gpu``, and one that
names ``tpu`` is refused (``Resources``). It imports nothing of the
reference package.
"""

from __future__ import annotations

from typing import Optional

from pydantic import Field, field_validator

from .common import Container, TypedObject, _Model

KIND_PROFILE = "Profile"
KIND_NOTEBOOK = "Notebook"
KIND_PODDEFAULT = "PodDefault"

#: annotation a culler (or user) stamps on a Notebook to stop its pod; the
#: kubeflow analog is ``kubeflow-resource-stopped``
STOPPED_ANNOTATION = "kft-stopped"


class ProfileSpec(_Model):
    #: owning user (email in upstream kubeflow; an opaque id here)
    owner: str = ""
    contributors: list[str] = Field(default_factory=list)
    #: hard caps for the profile's namespace, enforced gang-atomically by
    #: the scheduler: {"cpu": ..., "memory_gb": ..., "gpu": ...}
    resource_quota: dict[str, float] = Field(default_factory=dict)
    #: bearer token authenticating AS this profile on the REST API —
    #: mutations scope to the profile's namespace (apiserver authz;
    #: the reference's Profile RBAC binding analog)
    api_token: Optional[str] = None
    #: request-plane QoS for this tenant (ISSUE 9; serving/traffic.py
    #: ``validate_qos`` shape): ``{"rate": req/s, "burst": n,
    #: "priority": "high"|"normal"|"low", "max_concurrent": n,
    #: "queue_depth": n}``.  The ISvc controller merges every Profile's
    #: qos into each front door's traffic plane (tenant id = profile
    #: name); resource_quota stays the gang scheduler's concern —
    #: this is the REQUEST-RATE half the platform lacked.  Validated
    #: by the Profile controller (a bad spec is one Failed status),
    #: kept a plain dict so the api layer stays serving-agnostic.
    qos: Optional[dict] = None

    @field_validator("resource_quota")
    @classmethod
    def _quota_counts_cards(cls, v: dict) -> dict:
        if "tpu" in v:
            raise ValueError(
                "resource_quota.tpu: this platform's accelerators are "
                "NVIDIA cards; cap them as resource_quota.gpu")
        return v


class ProfileStatus(_Model):
    phase: str = "Pending"  # Pending | Ready | Failed
    #: live resource usage of non-terminal pods in the namespace
    usage: dict[str, float] = Field(default_factory=dict)
    message: str = ""


class Profile(TypedObject):
    """A Profile's name IS the tenant namespace (upstream convention)."""

    kind: str = KIND_PROFILE
    spec: ProfileSpec = Field(default_factory=ProfileSpec)
    status: ProfileStatus = Field(default_factory=ProfileStatus)


class NotebookSpec(_Model):
    #: the workbench process (``module:function(ctx)`` entrypoint or command)
    template: Container = Field(default_factory=Container)
    #: stop the pod after this long without activity; 0 disables culling
    idle_cull_seconds: float = 0.0


class NotebookStatus(_Model):
    phase: str = "Pending"  # Pending | Running | Stopped | Failed
    url: Optional[str] = None
    #: wall-clock of the last observed activity (pod start or heartbeat)
    last_activity: Optional[float] = None
    message: str = ""


class Notebook(TypedObject):
    kind: str = KIND_NOTEBOOK
    spec: NotebookSpec = Field(default_factory=NotebookSpec)
    status: NotebookStatus = Field(default_factory=NotebookStatus)


class PodDefaultSpec(_Model):
    #: pods whose labels include every (k, v) here get the injection;
    #: empty selector matches nothing (upstream matchLabels semantics)
    selector: dict[str, str] = Field(default_factory=dict)
    env: dict[str, str] = Field(default_factory=dict)
    annotations: dict[str, str] = Field(default_factory=dict)


class PodDefault(TypedObject):
    """Namespace-scoped injection defaults [upstream: kubeflow/kubeflow ->
    components/admission-webhook PodDefault CRD]."""

    kind: str = KIND_PODDEFAULT
    spec: PodDefaultSpec = Field(default_factory=PodDefaultSpec)
