"""InferenceService / ServingRuntime — the serving plane's API objects.

Capability parity with KServe [upstream: kserve/kserve ->
pkg/apis/serving/v1beta1/inference_service.go and
pkg/apis/serving/v1alpha1/servingruntime_types.go]: an InferenceService with
predictor / transformer / explainer components, model-format -> runtime
auto-selection against a registry of ServingRuntimes, a storage URI resolved
by a storage initializer, and autoscaling targets.  The TPU-first divergence:
runtimes name an in-process JAX predictor class (an XLA AOT-compiled
callable) rather than a Triton/GPU container image — the north star's ``tpu``
ServingRuntime [local: BASELINE.json].

The port's copy of ``kubeflow_tpu/api/inference.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import enum
from typing import Any, Optional

from pydantic import Field, model_validator

from .common import Resources, TypedObject, _Model

KIND_INFERENCE_SERVICE = "InferenceService"
KIND_SERVING_RUNTIME = "ServingRuntime"


class ModelFormat(_Model):
    name: str  # e.g. "jax", "flax-msgpack", "sklearn-json", "bert"
    version: Optional[str] = None


class GangSpec(_Model):
    """Multi-HOST predictor placement (serving/gang.py).

    A TPU pod slice is hosts x chips — a predictor whose tensor-parallel
    mesh exceeds one host's chips must run as a gang of cooperating
    processes (the multi-host jit contract), placed and restarted like a
    JaxJob.  ``mesh_axes`` is the GLOBAL serving mesh (its product must
    equal hosts * chips_per_host); ``chips_per_host`` doubles as the
    virtual-device count for the local CPU stand-in runtime.
    """

    hosts: int = Field(default=2, ge=1)
    mesh_axes: dict[str, int] = Field(default_factory=dict)
    chips_per_host: int = Field(default=4, ge=1)
    #: gang-restart budget (JaxJob run_policy.backoff_limit)
    backoff_limit: int = 16

    @model_validator(mode="after")
    def _mesh_covers_gang(self) -> "GangSpec":
        # reject at admission, not after backoff_limit whole-gang crash
        # loops: every member builds this exact global mesh
        import math

        if not self.mesh_axes:
            raise ValueError("gang.mesh_axes must name the serving mesh")
        n = math.prod(self.mesh_axes.values())
        if n != self.hosts * self.chips_per_host:
            raise ValueError(
                f"gang mesh {self.mesh_axes} covers {n} chips but "
                f"{self.hosts} hosts x {self.chips_per_host} chips/host "
                f"= {self.hosts * self.chips_per_host}")
        return self


class LoggerSpec(_Model):
    """Inference payload logging [upstream: kserve -> pkg/agent/logger,
    the ISvc ``logger`` field]: every request/response POSTs to ``url``
    with CloudEvents binary-mode headers, asynchronously (a dead sink
    drops events, never backpressures predicts)."""

    url: str
    #: "all" | "request" | "response"
    mode: str = "all"

    @model_validator(mode="after")
    def _mode_ok(self) -> "LoggerSpec":
        # reject at admission, not deep inside reconcile (or a gang pod)
        if self.mode not in ("all", "request", "response"):
            raise ValueError(
                f"logger mode {self.mode!r}: all|request|response")
        return self


class ComponentSpec(_Model):
    """One serving component (predictor/transformer/explainer)."""

    model_format: Optional[ModelFormat] = None
    storage_uri: Optional[str] = None  # file:// | mem:// | gs:// (stubbed)
    runtime: Optional[str] = None  # explicit ServingRuntime name override
    # "module:Class" for custom python components (transformer/explainer)
    handler: Optional[str] = None
    min_replicas: int = 1
    max_replicas: int = 1
    # target concurrent requests per replica before scaling out (knative
    # KPA concurrency-target analog)
    scale_target_concurrency: float = 4.0
    resources: Resources = Field(default_factory=Resources)
    batch_max_size: int = 8
    batch_timeout_ms: float = 2.0
    config: dict[str, Any] = Field(default_factory=dict)
    #: place the predictor as a multi-host gang instead of in-process
    #: replicas (predictor only; see GangSpec)
    gang: Optional[GangSpec] = None
    #: payload logging to a collector sink (see LoggerSpec)
    logger: Optional[LoggerSpec] = None


class InferenceServiceSpec(_Model):
    predictor: ComponentSpec = Field(default_factory=ComponentSpec)
    transformer: Optional[ComponentSpec] = None
    explainer: Optional[ComponentSpec] = None
    #: KServe canary rollout [upstream: kserve ->
    #: pkg/apis/serving/v1beta1/inference_service.go CanaryTrafficPercent]:
    #: when set and the spec changes, the previous revision keeps serving
    #: (100 - p)% of traffic while the new revision gets p%.  100 (or
    #: None) rolls the change out fully; reverting the spec rolls back.
    canary_traffic_percent: Optional[int] = Field(default=None, ge=0, le=100)


class InferenceServicePhase(str, enum.Enum):
    PENDING = "Pending"
    LOADING = "Loading"
    READY = "Ready"
    #: serving, but below strength: some replica (e.g. a gang re-forming
    #: after a member loss) is not taking traffic; healthy replicas are
    DEGRADED = "Degraded"
    FAILED = "Failed"


class InferenceServiceStatus(_Model):
    phase: InferenceServicePhase = InferenceServicePhase.PENDING
    url: Optional[str] = None
    active_replicas: int = 0
    message: str = ""
    #: revision bookkeeping (KServe's latestRolledOutRevision /
    #: latestCreatedRevision analog): monotonically increasing ints
    stable_revision: int = 0
    canary_revision: Optional[int] = None
    #: live traffic share of the canary revision (0 when no canary)
    canary_traffic: int = 0
    #: the stable revision's spec (minus traffic split) — what the SDK's
    #: ``rollback`` verb restores
    stable_spec: Optional[dict] = None


class InferenceService(TypedObject):
    kind: str = KIND_INFERENCE_SERVICE
    spec: InferenceServiceSpec = Field(default_factory=InferenceServiceSpec)
    status: InferenceServiceStatus = Field(default_factory=InferenceServiceStatus)


KIND_INFERENCE_GRAPH = "InferenceGraph"


class GraphStep(_Model):
    """One step of a graph node [upstream: kserve ->
    pkg/apis/serving/v1alpha1/inference_graph_types.go InferenceStep]."""

    #: target InferenceService (exactly one of service_name/node_name)
    service_name: Optional[str] = None
    #: target nested node in the same graph
    node_name: Optional[str] = None
    #: Switch: simple predicate on the request JSON — ``key == value``,
    #: ``key != value``, ``key > value``, ``key < value`` (kserve uses
    #: gjson expressions; this is the same capability, simpler syntax)
    condition: Optional[str] = None
    #: Sequence: what the step receives — "$response" (previous step's
    #: output, default) or "$request" (the original graph input)
    data: str = "$response"
    #: Ensemble: key for this step's output in the merged response
    #: (defaults to the service/node name); Splitter: ignored
    name: Optional[str] = None
    #: Splitter: relative traffic weight (defaults to 1)
    weight: Optional[int] = None


class GraphNode(_Model):
    #: "Sequence" (steps chained in order), "Switch" (first step whose
    #: condition matches handles it), "Ensemble" (all steps run in
    #: parallel on the same input; outputs merged under step names), or
    #: "Splitter" (one step picked by traffic weight)
    router_type: str = "Sequence"
    steps: list[GraphStep] = Field(default_factory=list)


class InferenceGraphSpec(_Model):
    #: node name -> node; "root" is the entrypoint
    nodes: dict[str, GraphNode] = Field(default_factory=dict)


class InferenceGraphStatus(_Model):
    phase: InferenceServicePhase = InferenceServicePhase.PENDING
    url: Optional[str] = None
    message: str = ""


class InferenceGraph(TypedObject):
    kind: str = KIND_INFERENCE_GRAPH
    spec: InferenceGraphSpec = Field(default_factory=InferenceGraphSpec)
    status: InferenceGraphStatus = Field(default_factory=InferenceGraphStatus)


class SupportedModelFormat(_Model):
    name: str
    version: Optional[str] = None
    auto_select: bool = True
    priority: int = 1


class ServingRuntimeSpec(_Model):
    supported_model_formats: list[SupportedModelFormat] = Field(default_factory=list)
    # python target "module:Class" implementing kubeflow_tpu_torch.serving.model.Model
    server_class: str = ""
    # runtime-level defaults merged under component config
    config: dict[str, Any] = Field(default_factory=dict)


class ServingRuntime(TypedObject):
    kind: str = KIND_SERVING_RUNTIME
    spec: ServingRuntimeSpec = Field(default_factory=ServingRuntimeSpec)


def select_runtime(
    fmt: ModelFormat, runtimes: list[ServingRuntime]
) -> Optional[ServingRuntime]:
    """Model-format -> runtime auto-selection [upstream: kserve ->
    pkg/apis/serving/v1beta1/predictor_model.go GetSupportingRuntimes]:
    highest-priority runtime whose supported formats include the requested
    name (and version when both specify one), auto_select only."""
    best: tuple[int, Optional[ServingRuntime]] = (-1, None)
    for rt in runtimes:
        for sf in rt.spec.supported_model_formats:
            if not sf.auto_select or sf.name != fmt.name:
                continue
            if fmt.version and sf.version and fmt.version != sf.version:
                continue
            if sf.priority > best[0]:
                best = (sf.priority, rt)
    return best[1]
