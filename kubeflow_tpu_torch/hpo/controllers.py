"""HPO reconcilers: Experiment -> Suggestion -> Trial -> JaxJob.

Katib's controller triple rebuilt on this control plane (SURVEY.md §2.3,
§3.4) [upstream: kubeflow/katib -> pkg/controller.v1beta1/{experiment,
suggestion,trial}]:

- ExperimentController keeps ``parallel_trial_count`` trials in flight until
  ``max_trial_count`` or the objective goal is reached; tracks the optimum.
- SuggestionController "deploys" the algorithm service (a real gRPC server
  per experiment, kubeflow_tpu_torch.hpo.service) and fills assignment
  requests, feeding back completed-trial observations — the GetSuggestions
  loop.
- TrialController materializes each trial's JaxJob from the experiment's
  trial template (``${trialParameters.x}`` substituted), follows its
  conditions, and scrapes the objective metric the way Katib's metrics
  collector does: from the pods' metric streams (status-dir jsonl written by
  ``bootstrap.emit_metric``; stdout ``name=value`` lines as fallback).

The port's copy of ``kubeflow_tpu/hpo/controllers.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Callable, Optional

from ..api.common import (
    JobCondition,
    JobConditionType,
    ObjectMeta,
    OwnerReference,
    has_condition,
    replica_pod_name,
    set_condition,
)
from ..api.experiment import (
    KIND_EXPERIMENT,
    KIND_SUGGESTION,
    KIND_TRIAL,
    Experiment,
    ObjectiveType,
    Suggestion,
    SuggestionSpec,
    Trial,
    TrialAssignment,
    TrialSpec,
    substitute_parameters,
)
from ..api.jaxjob import KIND_JAXJOB, JaxJob
from ..api.yaml_io import from_dict
from ..controlplane.controller import Controller, Result
from ..controlplane.store import AlreadyExists, NotFound, Store
from . import algorithms
from .db import DbManagerClient
from .early_stopping import Asha
from .service import SuggestionClient, SuggestionServer

log = logging.getLogger("kubeflow_tpu_torch.hpo")

_METRIC_LINE_RE = re.compile(r"^([A-Za-z0-9_.\-]+)=([-+0-9.eE]+)\s*$")


def _trial_name(exp: str, index: int) -> str:
    return f"{exp}-t{index:04d}"


class ExperimentController(Controller):
    kind = KIND_EXPERIMENT
    owned_kinds = (KIND_TRIAL, KIND_SUGGESTION)

    def __init__(self, store: Store, db: Optional["DbManagerClient"] = None) -> None:
        super().__init__(store)
        self.db = db

    def reconcile(self, namespace: str, name: str) -> Optional[Result]:
        exp = self.store.try_get(KIND_EXPERIMENT, name, namespace)
        if exp is None:
            return None
        assert isinstance(exp, Experiment)
        if exp.status.completed:
            return None

        if self.db is not None and not exp.status.replayed:
            exp = self._replay_observations(exp)

        trials = [
            t
            for t in self.store.list(KIND_TRIAL, namespace)
            if isinstance(t, Trial) and t.spec.experiment_name == name
        ]
        succeeded = [t for t in trials if t.status.phase == "Succeeded"]
        failed = [t for t in trials if t.status.phase == "Failed"]
        early = [t for t in trials if t.status.phase == "EarlyStopped"]
        running = [t for t in trials if t.status.phase in ("Pending", "Running")]

        optimal_name, optimal_value, optimal_assign = self._optimum(exp, succeeded)

        done_reason = self._done_reason(
            exp, len(trials), succeeded, failed, early, optimal_value)
        if done_reason and not running:
            self._finish(
                exp, done_reason, trials, succeeded, failed, early,
                optimal_name, optimal_value, optimal_assign)
            return None

        # how many fresh trials to keep the pipeline full
        want = 0
        if not done_reason:
            budget = exp.spec.max_trial_count - len(trials)
            slots = exp.spec.parallel_trial_count - len(running)
            want = max(0, min(budget, slots))

        sugg = self._ensure_suggestion(exp, requests=len(trials) + want)
        available = sugg.status.assignments
        created = 0
        for i in range(len(trials), min(len(trials) + want, len(available))):
            if self._create_trial(exp, i, available[i]):
                created += 1

        self._update_status(
            exp, trials, succeeded, failed, early, running,
            optimal_name, optimal_value, optimal_assign)
        # requeue while in flight: metric scraping + suggestion fills are async
        return Result(requeue_after=0.05 if (running or want > created) else None)

    # -- pieces ---------------------------------------------------------------

    def _replay_observations(self, exp: Experiment) -> Experiment:
        """Rebuild Succeeded Trials from the durable observation store.

        After a control-plane restart the in-memory Trial objects are gone
        but the db-manager still has every completed observation; recreating
        them as terminal Trials restores full history — counters, optimum
        tracking, and algorithm history all work unchanged — without
        re-running finished trials (katib-db-manager capability, SURVEY
        §2.3)."""
        ns, name = exp.metadata.namespace, exp.metadata.name
        replayed = 0
        try:
            records = self.db.get_observations(name, ns)
        except Exception:  # noqa: BLE001 — db unavailable: retry next pass
            return exp
        for rec in records:
            if (
                rec.get("phase") not in ("Succeeded", "EarlyStopped")
                or rec.get("value") is None
            ):
                continue
            if self.store.try_get(KIND_TRIAL, rec["trial"], ns) is not None:
                continue
            trial = Trial(
                metadata=ObjectMeta(
                    name=rec["trial"], namespace=ns,
                    owner_references=[
                        OwnerReference(kind=KIND_EXPERIMENT, name=name,
                                       uid=exp.metadata.uid)],
                ),
                spec=TrialSpec(
                    experiment_name=name,
                    assignments=[
                        TrialAssignment(name=k, value=v)
                        for k, v in rec["assignments"].items()
                    ],
                    objective_metric_name=exp.spec.objective.objective_metric_name,
                ),
            )
            trial.status.phase = rec["phase"]
            trial.status.observation = rec["value"]
            try:
                self.store.create(trial)
                replayed += 1
            except AlreadyExists:
                pass

        def mut(o):
            assert isinstance(o, Experiment)
            o.status.replayed = True

        try:
            exp = self.store.update_with_retry(KIND_EXPERIMENT, name, ns, mut)
        except NotFound:
            pass
        if replayed:
            self.emit_event(
                exp, "ObservationsReplayed",
                f"{replayed} completed trials restored from the observation store")
        assert isinstance(exp, Experiment)
        return exp

    def _optimum(self, exp: Experiment, succeeded: list[Trial]):
        best_name, best_val, best_assign = None, None, []
        sign = 1.0 if exp.spec.objective.type == ObjectiveType.MAXIMIZE else -1.0
        for t in succeeded:
            if t.status.observation is None:
                continue
            v = t.status.observation
            if best_val is None or sign * v > sign * best_val:
                best_name, best_val, best_assign = t.metadata.name, v, t.spec.assignments
        return best_name, best_val, best_assign

    def _done_reason(self, exp, n_trials, succeeded, failed, early, optimal_value) -> str:
        goal = exp.spec.objective.goal
        terminal = len(succeeded) + len(failed) + len(early)
        if goal is not None and optimal_value is not None:
            if exp.spec.objective.type == ObjectiveType.MAXIMIZE and optimal_value >= goal:
                return "GoalReached"
            if exp.spec.objective.type == ObjectiveType.MINIMIZE and optimal_value <= goal:
                return "GoalReached"
        if exp.spec.max_failed_trial_count and len(failed) >= exp.spec.max_failed_trial_count:
            return "MaxFailedTrialsReached"
        if terminal >= exp.spec.max_trial_count:
            return "MaxTrialsReached"
        sugg = self.store.try_get(KIND_SUGGESTION, exp.metadata.name, exp.metadata.namespace)
        if (
            isinstance(sugg, Suggestion)
            and sugg.status.exhausted
            and terminal >= len(sugg.status.assignments)
        ):
            return "SearchSpaceExhausted"
        return ""

    def _ensure_suggestion(self, exp: Experiment, requests: int) -> Suggestion:
        ns, name = exp.metadata.namespace, exp.metadata.name
        sugg = self.store.try_get(KIND_SUGGESTION, name, ns)
        if sugg is None:
            sugg = Suggestion(
                metadata=ObjectMeta(
                    name=name, namespace=ns,
                    owner_references=[
                        OwnerReference(kind=KIND_EXPERIMENT, name=name,
                                       uid=exp.metadata.uid)],
                ),
                spec=SuggestionSpec(
                    experiment_name=name,
                    algorithm=exp.spec.algorithm,
                    requests=requests,
                ),
            )
            try:
                created = self.store.create(sugg)
                self.emit_event(exp, "SuggestionCreated",
                                f"algorithm {exp.spec.algorithm.algorithm_name}")
                return created  # type: ignore[return-value]
            except AlreadyExists:
                sugg = self.store.try_get(KIND_SUGGESTION, name, ns)
        assert isinstance(sugg, Suggestion)
        if sugg.spec.requests < requests:
            def bump(o):
                assert isinstance(o, Suggestion)
                o.spec.requests = max(o.spec.requests, requests)

            try:
                sugg = self.store.update_with_retry(KIND_SUGGESTION, name, ns, bump)
            except NotFound:
                pass
        return sugg

    def _create_trial(self, exp: Experiment, index: int, assignment: dict) -> bool:
        ns = exp.metadata.namespace
        tname = _trial_name(exp.metadata.name, index)
        tmpl = exp.spec.trial_template
        manifest = substitute_parameters(tmpl.job_manifest, assignment) if tmpl else {}
        trial = Trial(
            metadata=ObjectMeta(
                name=tname, namespace=ns,
                owner_references=[
                    OwnerReference(kind=KIND_EXPERIMENT, name=exp.metadata.name,
                                   uid=exp.metadata.uid)],
            ),
            spec=TrialSpec(
                experiment_name=exp.metadata.name,
                assignments=[
                    TrialAssignment(name=k, value=v) for k, v in assignment.items()
                ],
                job_manifest=manifest,
                objective_metric_name=exp.spec.objective.objective_metric_name,
            ),
        )
        try:
            self.store.create(trial)
            self.emit_event(exp, "TrialCreated", f"{tname}: {assignment}")
            return True
        except AlreadyExists:
            return False

    def _finish(
        self, exp, reason, trials, succeeded, failed, early,
        opt_name, opt_value, opt_assign,
    ) -> None:
        def mut(o):
            assert isinstance(o, Experiment)
            o.status.completed = True
            o.status.trials_created = len(trials)
            o.status.trials_succeeded = len(succeeded)
            o.status.trials_failed = len(failed)
            o.status.trials_early_stopped = len(early)
            o.status.trials_running = 0
            o.status.current_optimal_trial = opt_name
            o.status.current_optimal_value = opt_value
            o.status.current_optimal_assignments = list(opt_assign)

        try:
            self.store.update_with_retry(
                KIND_EXPERIMENT, exp.metadata.name, exp.metadata.namespace, mut)
            self.emit_event(
                exp, reason,
                f"optimal {opt_name}={opt_value} {[(a.name, a.value) for a in opt_assign]}")
        except NotFound:
            pass
        # delete the Suggestion: its deletion event reaches the suggestion
        # controller, which tears down the algorithm gRPC server (otherwise
        # one server+channel+port leaks per finished experiment)
        self.store.try_delete(
            KIND_SUGGESTION, exp.metadata.name, exp.metadata.namespace)

    def _update_status(
        self, exp, trials, succeeded, failed, early, running,
        opt_name, opt_value, opt_assign,
    ) -> None:
        def mut(o):
            assert isinstance(o, Experiment)
            o.status.trials_created = len(trials)
            o.status.trials_succeeded = len(succeeded)
            o.status.trials_failed = len(failed)
            o.status.trials_early_stopped = len(early)
            o.status.trials_running = len(running)
            o.status.current_optimal_trial = opt_name
            o.status.current_optimal_value = opt_value
            o.status.current_optimal_assignments = list(opt_assign)

        try:
            self.store.update_with_retry(
                KIND_EXPERIMENT, exp.metadata.name, exp.metadata.namespace, mut)
        except NotFound:
            pass


class SuggestionController(Controller):
    """Runs the algorithm services and answers assignment requests.

    The Katib suggestion controller deploys a gRPC Deployment per experiment
    and calls GetSuggestions on it; here the "Deployment" is an in-process
    grpc server (real socket, real RPC) whose address lands in
    ``Suggestion.status.service_address``.
    """

    kind = KIND_SUGGESTION

    def __init__(self, store: Store, db: Optional[DbManagerClient] = None) -> None:
        super().__init__(store)
        self.db = db
        self._servers: dict[str, SuggestionServer] = {}
        self._clients: dict[str, SuggestionClient] = {}

    def stop(self) -> None:
        super().stop()
        for c in self._clients.values():
            c.close()
        for s in self._servers.values():
            s.stop()
        self._servers.clear()
        self._clients.clear()

    def reconcile(self, namespace: str, name: str) -> Optional[Result]:
        key = f"{namespace}/{name}"
        sugg = self.store.try_get(KIND_SUGGESTION, name, namespace)
        if sugg is None:
            self._teardown(key)
            return None
        assert isinstance(sugg, Suggestion)
        exp = self.store.try_get(KIND_EXPERIMENT, sugg.spec.experiment_name, namespace)
        if exp is None or (isinstance(exp, Experiment) and exp.status.completed):
            self._teardown(key)
            return None
        assert isinstance(exp, Experiment)

        server = self._servers.get(key)
        if server is None:
            server = SuggestionServer().start()
            self._servers[key] = server
            self._clients[key] = SuggestionClient(server.address)

        have = len(sugg.status.assignments)
        need = sugg.spec.requests - have
        if need <= 0 and sugg.status.service_address:
            return None

        new: list[dict] = []
        exhausted = sugg.status.exhausted
        if need > 0 and not exhausted:
            history = self._history(namespace, sugg.spec.experiment_name)
            new = self._clients[key].get_suggestions(
                algorithm=sugg.spec.algorithm.algorithm_name,
                parameters=exp.spec.parameters,
                objective_type=exp.spec.objective.type,
                history=history,
                count=need,
                settings=sugg.spec.algorithm.settings,
                issued=have,
            )
            if len(new) < need:
                exhausted = True  # finite space walked out (grid)

        def mut(o):
            assert isinstance(o, Suggestion)
            o.status.service_address = server.address
            o.status.assignments = o.status.assignments + new
            o.status.exhausted = exhausted

        try:
            self.store.update_with_retry(KIND_SUGGESTION, name, namespace, mut)
        except NotFound:
            self._teardown(key)
        return None

    def _history(self, namespace: str, exp_name: str) -> list[algorithms.Observation]:
        # EarlyStopped trials carry a real observation (their value at the
        # cut) and feed the optimizer like Katib's early-stopped trials do;
        # only observation-less Failed trials are invisible to it
        observed = ("Succeeded", "EarlyStopped")
        seen: dict[str, algorithms.Observation] = {}
        for t in self.store.list(KIND_TRIAL, namespace):
            if (
                isinstance(t, Trial)
                and t.spec.experiment_name == exp_name
                and t.status.phase in observed
                and t.status.observation is not None
            ):
                seen[t.metadata.name] = algorithms.Observation(
                    assignments={a.name: a.value for a in t.spec.assignments},
                    value=t.status.observation,
                    trial=t.metadata.name,
                )
        # fold in the durable store (keyed by trial name, live objects win):
        # after a restart the algorithm keeps its full optimization history
        if self.db is not None:
            try:
                for rec in self.db.get_observations(exp_name, namespace):
                    if (
                        rec.get("phase") in observed
                        and rec.get("value") is not None
                        and rec["trial"] not in seen
                    ):
                        seen[rec["trial"]] = algorithms.Observation(
                            assignments=rec["assignments"], value=rec["value"],
                            trial=rec["trial"])
            except Exception:  # noqa: BLE001 — db unavailable: use live view
                pass
        # issue order (trial names are zero-padded, so name order == issue
        # order): generation-replay algorithms (cmaes) need history in the
        # order assignments were handed out, restart or not
        return [seen[k] for k in sorted(seen)]

    def _teardown(self, key: str) -> None:
        client = self._clients.pop(key, None)
        if client:
            client.close()
        server = self._servers.pop(key, None)
        if server:
            server.stop()


class TrialController(Controller):
    """Trial -> JaxJob -> observation (SURVEY.md §3.4 inner composition)."""

    kind = KIND_TRIAL
    owned_kinds = (KIND_JAXJOB,)

    def __init__(
        self,
        store: Store,
        metrics_root: Optional[str] = None,
        log_path_for: Optional[Callable[[str, str], str]] = None,
        db: Optional[DbManagerClient] = None,
    ) -> None:
        super().__init__(store)
        #: root of the kubelet's per-pod status dirs (metrics.jsonl files)
        self.metrics_root = metrics_root
        #: (namespace, pod_name) -> stdout log path (Katib stdout collector)
        self.log_path_for = log_path_for
        #: durable observation store client (katib-db-manager analog)
        self.db = db

    def reconcile(self, namespace: str, name: str) -> Optional[Result]:
        trial = self.store.try_get(KIND_TRIAL, name, namespace)
        if trial is None:
            self.store.try_delete(KIND_JAXJOB, name, namespace)
            return None
        assert isinstance(trial, Trial)
        # EarlyStopped is terminal too: its reconcile fires once more when
        # ASHA deletes the owned job, and recreating the job here would
        # resurrect the trial and overwrite the phase with Succeeded
        if trial.status.phase in ("Succeeded", "Failed", "EarlyStopped"):
            return None

        job = self.store.try_get(KIND_JAXJOB, name, namespace)
        if job is None:
            manifest = dict(trial.spec.job_manifest)
            manifest.setdefault("kind", KIND_JAXJOB)
            manifest.setdefault("metadata", {})
            manifest["metadata"].update({"name": name, "namespace": namespace})
            obj = from_dict(manifest)
            assert isinstance(obj, JaxJob)
            obj.metadata.owner_references = [
                OwnerReference(kind=KIND_TRIAL, name=name, uid=trial.metadata.uid)
            ]
            try:
                self.store.create(obj)
                self.emit_event(trial, "JobCreated", name)
            except AlreadyExists:
                pass
            self._set_phase(trial, "Running")
            return Result(requeue_after=0.05)
        assert isinstance(job, JaxJob)

        if has_condition(job.status.conditions, JobConditionType.SUCCEEDED):
            # one pass over the metric streams: final values AND the
            # objective's per-step series (re-reading the jsonl for the
            # series would double the reconcile-thread IO on long runs)
            metrics, series = self._scrape_with_series(
                namespace, job, trial.spec.objective_metric_name)
            objective = metrics.get(trial.spec.objective_metric_name)
            if objective is None:
                # grace period for scrape latency; then fail loudly rather
                # than count a metric-less trial as Succeeded (Katib's
                # MetricsUnavailable semantics)
                completed = job.status.completion_time or time.time()
                if time.time() - completed < 2.0:
                    return Result(requeue_after=0.1)
                self._set_phase(trial, "Failed", metrics=metrics)
                self.emit_event(
                    trial, "MetricsUnavailable",
                    f"objective {trial.spec.objective_metric_name!r} never "
                    "observed in any worker's metrics", type_="Warning")
                return None
            # report to the db BEFORE the phase moves: the experiment
            # completes on its trials' phases, so a reader at completion
            # must already find every trial's observation and curve there
            if self.db is not None:
                try:
                    assignments = {
                        a.name: a.value for a in trial.spec.assignments}
                    self.db.report_observation(
                        experiment=trial.spec.experiment_name,
                        trial=name,
                        assignments=assignments,
                        value=objective,
                        namespace=namespace,
                    )
                    # per-step series of the objective behind the
                    # experiment-curves view (Katib's observation log) —
                    # ONE batched RPC, not one per step
                    if series:
                        self.db.report_observation_series(
                            experiment=trial.spec.experiment_name,
                            trial=name,
                            assignments=assignments,
                            series=series,
                            namespace=namespace,
                        )
                except Exception:  # noqa: BLE001 — db down: trial still valid
                    self.emit_event(
                        trial, "ObservationReportFailed",
                        "db-manager unreachable", type_="Warning")
            self._set_phase(trial, "Succeeded", observation=objective, metrics=metrics)
            self.emit_event(
                trial, "TrialSucceeded",
                f"{trial.spec.objective_metric_name}={objective}")
            return None
        if has_condition(job.status.conditions, JobConditionType.FAILED):
            self._set_phase(trial, "Failed")
            self.emit_event(trial, "TrialFailed", "job failed", type_="Warning")
            return None
        if self._maybe_early_stop(namespace, name, trial, job):
            return None
        self._set_phase(trial, "Running")
        return Result(requeue_after=0.05)

    # -- ASHA early stopping (SURVEY §2.3 suggestion/early-stopping zoo) ------

    def _maybe_early_stop(
        self, namespace: str, name: str, trial: Trial, job: JaxJob
    ) -> bool:
        """Record rung crossings and stop under-performing trials.

        Returns True when the trial was early-stopped (job deleted, phase
        EarlyStopped with the last observation recorded)."""
        exp = self.store.try_get(
            KIND_EXPERIMENT, trial.spec.experiment_name, namespace)
        if (
            not isinstance(exp, Experiment)
            or exp.spec.early_stopping is None
            or exp.spec.early_stopping.algorithm_name != "asha"
        ):
            return False
        asha = Asha.from_spec(exp.spec.early_stopping)
        metrics, steps = self._scrape_with_steps(namespace, job)
        value = metrics.get(trial.spec.objective_metric_name)
        step = steps.get(trial.spec.objective_metric_name)
        if value is None or step is None:
            return False
        rung = asha.rung_for(int(step))
        if rung is None or str(rung) in trial.status.rung_values:
            return False
        rkey = str(rung)

        def mut(o):
            assert isinstance(o, Trial)
            o.status.rung_values[rkey] = value

        try:
            trial = self.store.update_with_retry(KIND_TRIAL, name, namespace, mut)
        except NotFound:
            return False
        # asynchronous decision: judge against whatever peers have recorded
        # at this rung so far (no bracket synchronization)
        peers = [
            t.status.rung_values[rkey]
            for t in self.store.list(KIND_TRIAL, namespace)
            if isinstance(t, Trial)
            and t.spec.experiment_name == trial.spec.experiment_name
            and t.metadata.name != name
            and rkey in t.status.rung_values
        ]
        if not asha.should_stop(exp.spec.objective.type, rung, value, peers):
            return False
        self.store.try_delete(KIND_JAXJOB, name, namespace)
        self._set_phase(trial, "EarlyStopped", observation=value, metrics=metrics)
        if self.db is not None:
            try:
                self.db.report_observation(
                    experiment=trial.spec.experiment_name,
                    trial=name,
                    assignments={a.name: a.value for a in trial.spec.assignments},
                    value=value,
                    namespace=namespace,
                    phase="EarlyStopped",
                )
            except Exception:  # noqa: BLE001 — db unavailable: the stop
                # decision stands, only the durable record is lost
                log.debug("early-stop observation report for %s failed",
                          name, exc_info=True)
        self.emit_event(
            trial, "TrialEarlyStopped",
            f"ASHA rung {rung} (step {step}): "
            f"{trial.spec.objective_metric_name}={value} below promotion cut")
        return True

    # -- metrics collection (SURVEY.md §5 observability) ----------------------

    def _scrape(self, namespace: str, job: JaxJob) -> dict[str, float]:
        """Last value wins per metric name, scanning every worker pod:
        structured jsonl first, stdout ``name=value`` lines as fallback."""
        return self._scrape_with_steps(namespace, job)[0]

    def _scrape_with_steps(
        self, namespace: str, job: JaxJob
    ) -> tuple[dict[str, float], dict[str, int]]:
        """(metrics, steps): steps carries each metric's latest ``step``
        extra from the jsonl stream — the resource axis ASHA rungs use."""
        metrics: dict[str, float] = {}
        steps: dict[str, int] = {}
        for rtype, rspec in job.spec.replica_specs.items():
            for idx in range(rspec.replicas):
                pod = replica_pod_name(job.metadata.name, rtype, idx)
                if self.metrics_root:
                    path = os.path.join(
                        self.metrics_root, "status", namespace, pod, "metrics.jsonl")
                    vals, stps, _ = self._read_jsonl(path)
                    metrics.update(vals)
                    steps.update(stps)
                if self.log_path_for:
                    metrics.update(
                        self._read_stdout(self.log_path_for(namespace, pod)))
        return metrics, steps

    def _scrape_with_series(
        self, namespace: str, job: JaxJob, metric_name: str
    ) -> tuple[dict[str, float], list[tuple[int, float]]]:
        """One pass over every worker's metric streams: final metric values
        plus ``metric_name``'s full (step, value) series (the per-step
        observation log; last value wins per step)."""
        metrics: dict[str, float] = {}
        series: dict[int, float] = {}
        for rtype, rspec in job.spec.replica_specs.items():
            for idx in range(rspec.replicas):
                pod = replica_pod_name(job.metadata.name, rtype, idx)
                if self.metrics_root:
                    path = os.path.join(
                        self.metrics_root, "status", namespace, pod,
                        "metrics.jsonl")
                    vals, _, s = self._read_jsonl(path, series_for=metric_name)
                    metrics.update(vals)
                    series.update(s)
                if self.log_path_for:
                    metrics.update(
                        self._read_stdout(self.log_path_for(namespace, pod)))
        return metrics, sorted(series.items())

    @staticmethod
    def _read_jsonl(
        path: str, series_for: Optional[str] = None
    ) -> tuple[dict[str, float], dict[str, int], dict[int, float]]:
        """One pass over a metrics stream: (last values, last steps, and —
        when ``series_for`` names a metric — its full per-step series)."""
        values: dict[str, float] = {}
        steps: dict[str, int] = {}
        series: dict[int, float] = {}
        try:
            with open(path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        name = str(rec["name"])
                        values[name] = float(rec["value"])
                        if "step" in rec:
                            steps[name] = int(rec["step"])
                            if name == series_for:
                                series[int(rec["step"])] = float(rec["value"])
                    except (ValueError, KeyError):
                        continue
        except OSError:
            pass
        return values, steps, series

    @staticmethod
    def _read_stdout(path: str) -> dict[str, float]:
        out: dict[str, float] = {}
        try:
            with open(path) as f:
                for line in f:
                    m = _METRIC_LINE_RE.match(line)
                    if m:
                        try:
                            out[m.group(1)] = float(m.group(2))
                        except ValueError:
                            continue
        except OSError:
            pass
        return out

    def _set_phase(self, trial: Trial, phase: str, observation=None, metrics=None) -> None:
        if trial.status.phase == phase and observation is None:
            return

        def mut(o):
            assert isinstance(o, Trial)
            o.status.phase = phase
            if observation is not None:
                o.status.observation = observation
            if metrics:
                o.status.metrics = dict(metrics)
            ctype = {
                "Running": JobConditionType.RUNNING,
                "Succeeded": JobConditionType.SUCCEEDED,
                "Failed": JobConditionType.FAILED,
            }.get(phase)
            if ctype:
                o.status.conditions = set_condition(
                    o.status.conditions, JobCondition(type=ctype, reason=phase))

        try:
            self.store.update_with_retry(
                KIND_TRIAL, trial.metadata.name, trial.metadata.namespace, mut)
        except NotFound:
            pass
