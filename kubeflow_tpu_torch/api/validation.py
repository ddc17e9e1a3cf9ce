"""Defaulting + validation as pure functions — the admission-webhook layer.

The reference splits this across OpenAPI schema validation, defaulting
webhooks, and validating webhooks [upstream: kubeflow/training-operator ->
pkg/webhooks/, kserve -> pkg/apis/serving/v1beta1/*_validation.go].  pydantic
covers the schema tier at construction; these functions are the mutating
(default_*) and validating (validate_*) webhook equivalents, called by the
control plane on admission so tests can exercise them directly.

The port's copy of ``kubeflow_tpu/api/validation.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

from .common import ReplicaSpec, SchedulingPolicy
from .experiment import Experiment
from .inference import InferenceService
from .jaxjob import WORKER, JaxJob


class AdmissionError(ValueError):
    """Rejection from the validating-webhook equivalent."""


# ---------------------------------------------------------------------------
# JaxJob
# ---------------------------------------------------------------------------


def default_jaxjob(job: JaxJob) -> JaxJob:
    """Mutating defaults: ensure a worker role exists, gang min_available
    covers the full gang, and the mesh (if any) defaults to pure DP."""
    spec = job.spec
    if WORKER not in spec.replica_specs:
        spec.replica_specs[WORKER] = ReplicaSpec()
    rp = spec.run_policy
    if rp.scheduling_policy is None:
        rp.scheduling_policy = SchedulingPolicy()
    if rp.scheduling_policy.min_available is None:
        # all-or-nothing by default: the whole gang (Volcano minMember analog)
        rp.scheduling_policy.min_available = spec.total_replicas
    elif rp.scheduling_policy.min_available > spec.total_replicas:
        # elastic resize shrinks the gang: a min_available stamped for the
        # old world size would make the spec permanently inadmissible, so
        # defaulting re-clamps it (mutating webhooks run on UPDATE too)
        rp.scheduling_policy.min_available = spec.total_replicas
    workers = spec.replica_specs[WORKER]
    # one process a card: a pod of k cards runs k ranks (pod_main)
    cards_per_pod = max(1, workers.template.resources.gpu or 1)
    total_cards = workers.replicas * cards_per_pod
    if (
        job.metadata.creation_timestamp is not None
        and set(spec.mesh) == {"data"}
        and spec.mesh["data"] != total_cards
    ):
        # UPDATE of a live job whose pure-DP default mesh was stamped for an
        # old world size (elastic resize): re-derive.  On CREATE (no
        # creation_timestamp yet) a mismatched mesh is the user's own input
        # and must fail validation, not be silently rewritten; custom
        # (non-"data") meshes are always left to validation.
        spec.mesh = {}
    if not spec.mesh:
        spec.mesh = {"data": total_cards}
    return job


def validate_jaxjob(job: JaxJob) -> None:
    spec = job.spec
    workers = spec.replica_specs.get(WORKER)
    if workers is None or workers.replicas < 1:
        raise AdmissionError("JaxJob needs a 'worker' replica spec with replicas >= 1")
    sp = spec.run_policy.scheduling_policy
    if sp and sp.min_available is not None and sp.min_available > spec.total_replicas:
        raise AdmissionError(
            f"min_available {sp.min_available} exceeds total replicas {spec.total_replicas}"
        )
    if spec.run_policy.backoff_limit < 0:
        raise AdmissionError("backoff_limit must be >= 0")
    if not (0 <= spec.coordinator_port < 65536):  # 0 = controller-allocated
        raise AdmissionError(f"coordinator_port {spec.coordinator_port} out of range")
    if spec.elastic_policy and spec.elastic_policy.max_replicas < workers.replicas:
        raise AdmissionError("elastic_policy.max_replicas < worker replicas")
    if spec.mesh:
        mesh_devices = 1
        for ax, size in spec.mesh.items():
            if size < 1:
                raise AdmissionError(f"mesh axis {ax!r} has non-positive size {size}")
            mesh_devices *= size
        cards_per_pod = max(1, workers.template.resources.gpu or 1)
        total_devices = workers.replicas * cards_per_pod
        if mesh_devices != total_devices:
            raise AdmissionError(
                f"mesh {spec.mesh} covers {mesh_devices} devices but the job "
                f"provides {total_devices} ({workers.replicas} workers x "
                f"{cards_per_pod} cards)"
            )


# ---------------------------------------------------------------------------
# Experiment
# ---------------------------------------------------------------------------


def default_experiment(exp: Experiment) -> Experiment:
    s = exp.spec
    if s.parallel_trial_count < 1:
        s.parallel_trial_count = 1
    if s.max_trial_count < s.parallel_trial_count:
        s.max_trial_count = s.parallel_trial_count
    if s.trial_template and not s.trial_template.trial_parameters:
        s.trial_template.trial_parameters = {p.name: p.name for p in s.parameters}
    return exp


def validate_experiment(exp: Experiment) -> None:
    s = exp.spec
    if not s.parameters:
        raise AdmissionError("Experiment needs at least one parameter")
    if s.trial_template is None:
        raise AdmissionError("Experiment needs a trial_template")
    if s.trial_template.job_manifest.get("kind") not in ("JaxJob",):
        raise AdmissionError("trial_template.job_manifest must be a JaxJob manifest")
    names = [p.name for p in s.parameters]
    if len(names) != len(set(names)):
        raise AdmissionError("duplicate parameter names")
    if not s.objective.objective_metric_name:
        raise AdmissionError("objective_metric_name is required")


# ---------------------------------------------------------------------------
# InferenceService
# ---------------------------------------------------------------------------


def default_inference_service(isvc: InferenceService) -> InferenceService:
    p = isvc.spec.predictor
    if p.min_replicas < 0:
        p.min_replicas = 0  # 0 = scale-to-zero allowed (knative KPA analog)
    if p.max_replicas < max(p.min_replicas, 1):
        p.max_replicas = max(p.min_replicas, 1)
    return isvc


def validate_inference_service(isvc: InferenceService) -> None:
    p = isvc.spec.predictor
    if p.model_format is None and p.handler is None and p.runtime is None:
        raise AdmissionError(
            "predictor needs a model_format (for runtime auto-selection), "
            "an explicit runtime, or a custom handler"
        )
    if p.storage_uri is not None:
        scheme = p.storage_uri.split("://", 1)[0] if "://" in p.storage_uri else ""
        if scheme not in ("file", "mem", "gs", "s3", "hf", "pvc"):
            raise AdmissionError(f"unsupported storage_uri scheme {scheme!r}")
