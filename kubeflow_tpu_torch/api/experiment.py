"""Experiment / Suggestion / Trial — the HPO plane's API objects.

Capability parity with Katib's CRD triple [upstream: kubeflow/katib ->
pkg/apis/controller/{experiments,suggestions,trials}/v1beta1/]: an objective
(metric + goal + direction), a typed search space, an algorithm name,
parallelism budgets, and a trial template that is a real ``JaxJob`` with
``${trialParameters.x}`` placeholders substituted per trial — so the HPO
outer loop composes with the training control plane exactly the way Katib
composes with the training-operator (SURVEY.md §3.4).

The port's copy of ``kubeflow_tpu/api/experiment.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import enum
import re
from typing import Any, Optional, Union

from pydantic import Field, model_validator

from .common import TypedObject, _Model

KIND_EXPERIMENT = "Experiment"
KIND_TRIAL = "Trial"
KIND_SUGGESTION = "Suggestion"


class ObjectiveType(str, enum.Enum):
    MINIMIZE = "minimize"
    MAXIMIZE = "maximize"


class ObjectiveSpec(_Model):
    type: ObjectiveType = ObjectiveType.MAXIMIZE
    objective_metric_name: str = "accuracy"
    additional_metric_names: list[str] = Field(default_factory=list)
    goal: Optional[float] = None


class ParameterType(str, enum.Enum):
    DOUBLE = "double"
    INT = "int"
    CATEGORICAL = "categorical"
    DISCRETE = "discrete"


class FeasibleSpace(_Model):
    min: Optional[float] = None
    max: Optional[float] = None
    list_: list[Union[str, float]] = Field(default_factory=list, alias="list")
    step: Optional[float] = None
    log_scale: bool = False

    model_config = {"populate_by_name": True, "extra": "forbid"}


class ParameterSpec(_Model):
    name: str
    parameter_type: ParameterType
    feasible_space: FeasibleSpace

    @model_validator(mode="after")
    def _space_ok(self) -> "ParameterSpec":
        fs = self.feasible_space
        if self.parameter_type in (ParameterType.DOUBLE, ParameterType.INT):
            if fs.min is None or fs.max is None or fs.min > fs.max:
                raise ValueError(f"parameter {self.name}: need min <= max")
        else:
            if not fs.list_:
                raise ValueError(f"parameter {self.name}: need a non-empty list")
        return self


class AlgorithmSpec(_Model):
    algorithm_name: str = "random"
    # string KV settings passed through to the suggestion service, exactly the
    # reference's AlgorithmSetting shape [upstream: katib api.proto].
    settings: dict[str, str] = Field(default_factory=dict)


class TrialTemplate(_Model):
    """A JaxJob manifest (as a plain dict) containing
    ``${trialParameters.<name>}`` placeholders."""

    job_manifest: dict[str, Any]
    # maps placeholder name -> parameter name (identity by default)
    trial_parameters: dict[str, str] = Field(default_factory=dict)


_PLACEHOLDER_RE = re.compile(r"\$\{trialParameters\.([A-Za-z0-9_]+)\}")


def substitute_parameters(obj: Any, assignments: dict[str, Any]) -> Any:
    """Deep-substitute ``${trialParameters.x}`` in a manifest tree.

    A string that is exactly one placeholder becomes the typed value; strings
    with embedded placeholders get string substitution — matching Katib's
    trial-template mutation semantics [upstream: katib ->
    pkg/controller.v1beta1/trial/].
    """
    if isinstance(obj, dict):
        return {k: substitute_parameters(v, assignments) for k, v in obj.items()}
    if isinstance(obj, list):
        return [substitute_parameters(v, assignments) for v in obj]
    if isinstance(obj, str):
        m = _PLACEHOLDER_RE.fullmatch(obj)
        if m:
            name = m.group(1)
            if name not in assignments:
                raise KeyError(f"unresolved trial parameter {name!r}")
            return assignments[name]
        return _PLACEHOLDER_RE.sub(
            lambda mm: str(assignments[mm.group(1)]), obj
        )
    return obj


class EarlyStoppingSpec(_Model):
    """Early-stopping policy [upstream: Katib EarlyStopping CRD field;
    algorithms in pkg/earlystopping/].  ``asha`` implemented natively
    (hpo/early_stopping.py); settings are string KV like AlgorithmSpec."""

    algorithm_name: str = "asha"
    settings: dict[str, str] = Field(default_factory=dict)


class ExperimentSpec(_Model):
    objective: ObjectiveSpec = Field(default_factory=ObjectiveSpec)
    algorithm: AlgorithmSpec = Field(default_factory=AlgorithmSpec)
    parameters: list[ParameterSpec] = Field(default_factory=list)
    parallel_trial_count: int = 1
    max_trial_count: int = 1
    max_failed_trial_count: int = 0
    trial_template: Optional[TrialTemplate] = None
    early_stopping: Optional[EarlyStoppingSpec] = None


class TrialAssignment(_Model):
    name: str
    value: Union[str, float, int]


class ExperimentStatus(_Model):
    conditions: list = Field(default_factory=list)
    trials_created: int = 0
    trials_succeeded: int = 0
    trials_failed: int = 0
    trials_early_stopped: int = 0
    trials_running: int = 0
    current_optimal_trial: Optional[str] = None
    current_optimal_value: Optional[float] = None
    current_optimal_assignments: list[TrialAssignment] = Field(default_factory=list)
    completed: bool = False
    #: set once observations from a previous control-plane incarnation have
    #: been replayed from the durable store (hpo/db.py)
    replayed: bool = False


class Experiment(TypedObject):
    kind: str = KIND_EXPERIMENT
    spec: ExperimentSpec = Field(default_factory=ExperimentSpec)
    status: ExperimentStatus = Field(default_factory=ExperimentStatus)


class SuggestionSpec(_Model):
    """Request for parameter assignments [upstream: katib ->
    pkg/apis/controller/suggestions/v1beta1]: the experiment controller bumps
    ``requests``; the suggestion controller (running the algorithm service)
    appends to ``status.assignments`` until it catches up."""

    experiment_name: str = ""
    algorithm: AlgorithmSpec = Field(default_factory=AlgorithmSpec)
    requests: int = 0


class SuggestionStatus(_Model):
    assignments: list[dict[str, Any]] = Field(default_factory=list)
    service_address: Optional[str] = None
    exhausted: bool = False  # algorithm cannot produce more (grid walked out)


class Suggestion(TypedObject):
    kind: str = KIND_SUGGESTION
    spec: SuggestionSpec = Field(default_factory=SuggestionSpec)
    status: SuggestionStatus = Field(default_factory=SuggestionStatus)


class TrialSpec(_Model):
    experiment_name: str = ""
    assignments: list[TrialAssignment] = Field(default_factory=list)
    job_manifest: dict[str, Any] = Field(default_factory=dict)
    objective_metric_name: str = ""


class TrialStatus(_Model):
    conditions: list = Field(default_factory=list)
    observation: Optional[float] = None  # final objective metric value
    metrics: dict[str, float] = Field(default_factory=dict)
    phase: str = "Pending"  # Pending | Running | Succeeded | Failed | EarlyStopped
    #: ASHA rung -> objective value recorded when the trial crossed that
    #: resource milestone (str keys: the status round-trips through JSON)
    rung_values: dict[str, float] = Field(default_factory=dict)


class Trial(TypedObject):
    kind: str = KIND_TRIAL
    spec: TrialSpec = Field(default_factory=TrialSpec)
    status: TrialStatus = Field(default_factory=TrialStatus)
