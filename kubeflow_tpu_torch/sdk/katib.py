"""KatibClient — the HPO plane's Python SDK.

Capability parity with the reference's katib SDK [upstream: kubeflow/katib
-> sdk/python/v1beta1 KatibClient]: ``create_experiment``,
``get_experiment``, ``wait_for_experiment_condition``, ``list_trials``,
``get_optimal_hyperparameters``, ``delete_experiment``, and the one-call
``tune()`` UX that builds the Experiment from a search space + objective
and drives JaxJob trials.

The port's copy of ``kubeflow_tpu/sdk/katib.py``, device-free like it,
with the same names; ``tune`` takes ``gpus_per_worker``, the NVIDIA cards
each trial worker asks for. It imports nothing of the reference package.
"""

from __future__ import annotations

import time
from typing import Optional, Union

from ..api import from_dict, load_yaml
from ..api.experiment import (
    AlgorithmSpec,
    EarlyStoppingSpec,
    Experiment,
    ExperimentSpec,
    FeasibleSpace,
    KIND_EXPERIMENT,
    KIND_TRIAL,
    ObjectiveSpec,
    ObjectiveType,
    ParameterSpec,
    ParameterType,
    Trial,
    TrialTemplate,
)
from ..api.common import ObjectMeta
from ..runtime.platform import LocalPlatform


class ExperimentTimeoutError(TimeoutError):
    pass


def search_double(min: float, max: float, log: bool = False) -> dict:
    """Search-space shorthand: continuous range (`katib.search.double`)."""
    return {"type": ParameterType.DOUBLE, "min": min, "max": max, "log": log}


def search_int(min: int, max: int) -> dict:
    return {"type": ParameterType.INT, "min": min, "max": max}


def search_categorical(values: list) -> dict:
    return {"type": ParameterType.CATEGORICAL, "list": list(values)}


def _param(name: str, spec: dict) -> ParameterSpec:
    ptype = ParameterType(spec["type"])
    if ptype in (ParameterType.DOUBLE, ParameterType.INT):
        fs = FeasibleSpace(min=spec["min"], max=spec["max"],
                           log_scale=bool(spec.get("log", False)))
    else:
        fs = FeasibleSpace(list=spec["list"])
    return ParameterSpec(name=name, parameter_type=ptype, feasible_space=fs)


class KatibClient:
    def __init__(self, platform: LocalPlatform) -> None:
        self.platform = platform

    # -- CRUD -----------------------------------------------------------------

    def create_experiment(
        self, experiment: Union[Experiment, dict, str]
    ) -> Experiment:
        if isinstance(experiment, str):
            objs = load_yaml(experiment)
            if len(objs) != 1 or not isinstance(objs[0], Experiment):
                raise ValueError("expected exactly one Experiment document")
            experiment = objs[0]
        elif isinstance(experiment, dict):
            obj = from_dict(experiment)
            if not isinstance(obj, Experiment):
                raise ValueError(f"manifest is a {obj.kind}, not an Experiment")
            experiment = obj
        created = self.platform.store.create(experiment)
        assert isinstance(created, Experiment)
        return created

    def get_experiment(
        self, name: str, namespace: str = "default"
    ) -> Optional[Experiment]:
        e = self.platform.store.try_get(KIND_EXPERIMENT, name, namespace)
        assert e is None or isinstance(e, Experiment)
        return e

    def delete_experiment(self, name: str, namespace: str = "default") -> None:
        self.platform.store.try_delete(KIND_EXPERIMENT, name, namespace)

    def list_trials(self, name: str, namespace: str = "default") -> list[Trial]:
        return sorted(
            (
                t for t in self.platform.store.list(KIND_TRIAL, namespace)
                if isinstance(t, Trial) and t.spec.experiment_name == name
            ),
            key=lambda t: t.metadata.name,
        )

    # -- waiting / results ----------------------------------------------------

    def wait_for_experiment(
        self, name: str, namespace: str = "default",
        timeout: float = 300.0, poll: float = 0.1,
    ) -> Experiment:
        deadline = time.time() + timeout
        while time.time() < deadline:
            e = self.get_experiment(name, namespace)
            if e is not None and e.status.completed:
                return e
            time.sleep(poll)
        raise ExperimentTimeoutError(
            f"experiment {name}: not completed within {timeout}s")

    def get_optimal_hyperparameters(
        self, name: str, namespace: str = "default"
    ) -> dict:
        """{"value": best objective, "assignments": {param: value}} — the
        reference client's optimal-trial read."""
        e = self.get_experiment(name, namespace)
        if e is None or e.status.current_optimal_value is None:
            return {"value": None, "assignments": {}}
        return {
            "value": e.status.current_optimal_value,
            "trial": e.status.current_optimal_trial,
            "assignments": {
                a.name: a.value for a in e.status.current_optimal_assignments},
        }

    # -- one-call UX ----------------------------------------------------------

    def tune(
        self,
        name: str,
        entrypoint: str,
        parameters: dict[str, dict],
        objective_metric: str = "score",
        objective_type: ObjectiveType = ObjectiveType.MAXIMIZE,
        goal: Optional[float] = None,
        algorithm: str = "random",
        algorithm_settings: Optional[dict[str, str]] = None,
        max_trials: int = 8,
        parallel_trials: int = 2,
        early_stopping: Optional[str] = None,
        num_workers: int = 1,
        base_env: Optional[dict[str, str]] = None,
        namespace: str = "default",
        wait: bool = True,
        timeout: float = 600.0,
        gpus_per_worker: int = 0,
    ) -> Experiment:
        """Build + submit an Experiment in one call [reference analog:
        KatibClient.tune].  ``parameters`` maps env-var-ish parameter names
        to search specs (see ``search_double``/``search_int``/
        ``search_categorical``); each trial's JaxJob gets
        ``KFT_<NAME>=${trialParameters.<name>}`` injected. Each trial
        worker asks ``gpus_per_worker`` NVIDIA cards (a pod sees only the
        cards it asked for).
        """
        env = dict(base_env or {})
        for pname in parameters:
            env[f"KFT_{pname.upper()}"] = "${trialParameters.%s}" % pname
        exp = Experiment(
            metadata=ObjectMeta(name=name, namespace=namespace),
            spec=ExperimentSpec(
                objective=ObjectiveSpec(
                    type=objective_type,
                    objective_metric_name=objective_metric,
                    goal=goal,
                ),
                algorithm=AlgorithmSpec(
                    algorithm_name=algorithm,
                    settings=algorithm_settings or {},
                ),
                parameters=[_param(n, s) for n, s in parameters.items()],
                parallel_trial_count=parallel_trials,
                max_trial_count=max_trials,
                early_stopping=(
                    EarlyStoppingSpec(algorithm_name=early_stopping)
                    if early_stopping else None
                ),
                trial_template=TrialTemplate(job_manifest={
                    "kind": "JaxJob",
                    "metadata": {"name": "placeholder"},
                    "spec": {
                        "replica_specs": {
                            "worker": {
                                "replicas": num_workers,
                                "template": {
                                    "entrypoint": entrypoint,
                                    "env": env,
                                    **({"resources": {
                                        "gpu": gpus_per_worker}}
                                       if gpus_per_worker else {}),
                                },
                            }
                        }
                    },
                }),
            ),
        )
        created = self.create_experiment(exp)
        if wait:
            return self.wait_for_experiment(name, namespace, timeout=timeout)
        return created
