"""Typed API objects (the CRD layer) for the TPU-native control plane.

The port's copy of ``kubeflow_tpu/api/__init__.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from .common import (
    API_GROUP,
    API_VERSION,
    CleanPodPolicy,
    Container,
    JobCondition,
    JobConditionType,
    ObjectMeta,
    OwnerReference,
    ReplicaSpec,
    ReplicaStatus,
    Resources,
    RestartPolicy,
    RunPolicy,
    SchedulingPolicy,
    TypedObject,
    get_condition,
    has_condition,
    is_retryable_exit,
    object_key,
    replica_pod_name,
    replica_service_dns,
    set_condition,
)
from .experiment import (
    AlgorithmSpec,
    Experiment,
    ExperimentSpec,
    FeasibleSpace,
    ObjectiveSpec,
    ObjectiveType,
    ParameterSpec,
    ParameterType,
    Suggestion,
    SuggestionSpec,
    SuggestionStatus,
    Trial,
    TrialAssignment,
    TrialSpec,
    TrialTemplate,
    substitute_parameters,
)
from .inference import (
    ComponentSpec,
    InferenceService,
    InferenceServicePhase,
    InferenceServiceSpec,
    ModelFormat,
    ServingRuntime,
    ServingRuntimeSpec,
    SupportedModelFormat,
    select_runtime,
)
from .jaxjob import WORKER, ElasticPolicy, JaxJob, JaxJobSpec, JaxJobStatus
from .validation import (
    AdmissionError,
    default_experiment,
    default_inference_service,
    default_jaxjob,
    validate_experiment,
    validate_inference_service,
    validate_jaxjob,
)
from .yaml_io import dump_yaml, from_dict, load_yaml, load_yaml_file, to_dict

__all__ = [k for k in dir() if not k.startswith("_")]
