"""The port's HPO tier (``kubeflow_tpu_torch/hpo/``) against the
reference's ``kubeflow_tpu/hpo/``, in one process on the CPU.

- Every suggester gives the reference's assignments for the same request
  (exact: both sides are numpy and ``random`` only).
- ASHA gives the same stop decisions for the same observation stream.
- The suggestion service and the observation db, each over its gRPC
  socket, answer the same requests as the reference's, errors included.
- An experiment on each package's ``Cluster`` (fake kubelet, an in-process
  metric writer, as ``tests/test_hpo.py`` does) issues the same trials in
  order and finds the same optimum, with and without ASHA.
- (``tests/test_torch_nas.py``) A ``darts`` experiment on the port's
  cluster suggests the reference ``OneShotNas``'s ranking.

Both packages are imported inside the tests.
"""

import importlib
import json
import threading
import time

import numpy as np
import pytest

from tests._torch_resources import add_hosts

PKGS = ("kubeflow_tpu", "kubeflow_tpu_torch")
PARAMS = [
    {"name": "lr", "parameter_type": "double",
     "feasible_space": {"min": 1e-3, "max": 0.1, "log_scale": True}},
    {"name": "layers", "parameter_type": "int",
     "feasible_space": {"min": 1, "max": 4}},
    {"name": "opt", "parameter_type": "categorical",
     "feasible_space": {"list": ["sgd", "adam"]}},
]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _history(alg, n: int = 6, seed: int = 5) -> list:
    """``n`` observations drawn from ``PARAMS`` with a seeded numpy
    generator, named in issue order as the controllers name trials."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = {"lr": float(np.exp(rng.uniform(np.log(1e-3), np.log(0.1)))),
             "layers": int(rng.integers(1, 5)),
             "opt": ["sgd", "adam"][int(rng.integers(0, 2))]}
        value = (a["lr"] - 0.03) ** 2 + 0.01 * a["layers"] + float(
            rng.normal(0, 1e-3))
        out.append(alg.Observation(assignments=a, value=value,
                                   trial=f"sweep-t{i:04d}"))
    return out


def _request(pkg: str, **kw):
    alg, api = _mod(pkg, "hpo.algorithms"), _mod(pkg, "api.experiment")
    return alg.SuggestRequest(
        parameters=[api.ParameterSpec.model_validate(p) for p in PARAMS],
        objective_type=api.ObjectiveType.MINIMIZE, history=_history(alg),
        **kw)


@pytest.mark.parametrize("name", ["random", "grid", "tpe",
                                  "bayesianoptimization", "cmaes", "pbt"])
def test_suggesters_match_reference(name):
    settings = {"population_size": "4"} if name == "pbt" else {}
    got = {}
    for pkg in PKGS:
        alg = _mod(pkg, "hpo.algorithms")
        req = _request(pkg, count=2, seed=3, issued=7, settings=settings)
        got[pkg] = alg.get_suggester(name).suggest(req)
    assert len(got["kubeflow_tpu"]) == 2
    assert got["kubeflow_tpu_torch"] == got["kubeflow_tpu"]


def test_asha_matches_reference():
    rng = np.random.default_rng(11)
    # (trial, step, value): six trials reporting at steps 1..40 in an
    # interleaved order
    stream = [(int(t), int(s), float(rng.normal()))
              for s in range(1, 41) for t in rng.permutation(6)]
    decisions = {}
    for pkg in PKGS:
        es, api = _mod(pkg, "hpo.early_stopping"), _mod(pkg, "api.experiment")
        asha = es.Asha.from_spec(api.EarlyStoppingSpec(
            algorithm_name="asha",
            settings={"min_resource": "3", "reduction_factor": "3"}))
        for kind in (api.ObjectiveType.MAXIMIZE, api.ObjectiveType.MINIMIZE):
            rungs: dict = {}
            out = []
            for trial, step, value in stream:
                rung = asha.rung_for(step)
                if rung is None or trial in rungs.setdefault(rung, {}):
                    continue
                peers = list(rungs[rung].values())
                rungs[rung][trial] = value
                out.append((trial, rung, asha.milestone(rung),
                             asha.should_stop(kind, rung, value, peers)))
            decisions[pkg, kind.value] = out
    for kind in ("maximize", "minimize"):
        want = decisions["kubeflow_tpu", kind]
        assert decisions["kubeflow_tpu_torch", kind] == want
        assert any(d[-1] for d in want) and not all(d[-1] for d in want)


def _rpc_error(fn):
    import grpc

    try:
        fn()
    except grpc.RpcError as e:
        return e.code(), e.details()
    raise AssertionError("no RPC error")


def test_service_and_db_round_trip(tmp_path):
    answers = {}
    for pkg in PKGS:
        svc, db, api = (_mod(pkg, "hpo.service"), _mod(pkg, "hpo.db"),
                        _mod(pkg, "api.experiment"))
        alg = _mod(pkg, "hpo.algorithms")
        params = [api.ParameterSpec.model_validate(p) for p in PARAMS]
        server = svc.SuggestionServer().start()
        db_server = db.DbManagerServer(str(tmp_path / f"{pkg}.sqlite")).start()
        client = svc.SuggestionClient(server.address)
        db_client = db.DbManagerClient(db_server.address)
        try:
            out = []
            # the algorithms whose answer needs no seed (the client sends
            # none: random, tpe and GP-EI draw from OS entropy there)
            for name, settings in (("grid", {}), ("cmaes", {}),
                                   ("pbt", {"population_size": "3"})):
                out.append(client.get_suggestions(
                    algorithm=name, parameters=params,
                    objective_type=api.ObjectiveType.MINIMIZE,
                    history=_history(alg), count=3, settings=settings,
                    issued=6))
            out.append(_rpc_error(lambda: client.get_suggestions(
                algorithm="nope", parameters=params,
                objective_type=api.ObjectiveType.MINIMIZE, history=[],
                count=1)))
            db_client.report_observation("e1", "e1-t0000", {"lr": 0.1}, 0.5,
                                         step=10)
            db_client.report_observation_series(
                "e1", "e1-t0000", {"lr": 0.1}, [(20, 0.7), (30, 0.6)])
            db_client.report_observation("e1", "e1-t0000", {"lr": 0.1}, 0.6)
            db_client.report_observation("e1", "e1-t0001", {"lr": 0.01}, 0.3,
                                         phase="EarlyStopped")
            db_client.report_observation("e2", "e2-t0000", {"lr": 0.2}, None,
                                         namespace="team", phase="Failed")
            out.append(db_client.get_observations("e1"))
            out.append(db_client.get_observation_log("e1"))
            out.append(db_client.get_observations("e2", namespace="team"))
            out.append(db_client.get_observations("e2"))
            answers[pkg] = out
        finally:
            client.close()
            db_client.close()
            server.stop()
            db_server.stop()
    want = answers["kubeflow_tpu"]
    assert want[3][1].startswith("ValueError: unknown algorithm 'nope'")
    assert len(want[4]) == 2 and len(want[5]) == 5 and len(want[6]) == 1
    assert answers["kubeflow_tpu_torch"] == want


def _seeded_suggestions(pkg: str, monkeypatch) -> None:
    """Give every GetSuggestions call of ``pkg``'s controllers the seed
    ``issued``: the controllers send none, so ``random`` draws from OS
    entropy, and two packages' experiments could not be held equal."""
    svc = _mod(pkg, "hpo.service")
    init = svc.SuggestionClient.__init__

    def seeded_init(self, address):
        init(self, address)
        call = self._call

        def seeded(request, timeout=None):
            return call({**request, "seed": request["issued"]},
                        timeout=timeout)
        self._call = seeded

    monkeypatch.setattr(svc.SuggestionClient, "__init__", seeded_init)


def _score(lr: float) -> float:
    return 1.0 - (lr - 0.03) ** 2 * 100.0


def _run_experiment(pkg: str, root, early_stopping: bool) -> dict:
    """A four-trial ``random`` experiment, one trial at a time, on
    ``pkg``'s cluster with the fake kubelet; a thread writes each trial
    pod's score from its ``KFT_LR`` (at step 3, ASHA's first rung, when
    ``early_stopping``)."""
    api = _mod(pkg, "api.experiment")
    cluster_mod = _mod(pkg, "controlplane.cluster")
    fk = _mod(pkg, "controlplane.fake_kubelet")
    objects = _mod(pkg, "controlplane.objects")
    cluster = cluster_mod.Cluster()
    add_hosts(pkg, cluster, "slice-0", 1, 4)
    cluster.enable_hpo(metrics_root=str(root))
    kubelet = fk.FakeKubelet(
        cluster.store, script=lambda pod: fk.PodScript(run_seconds=0.3))
    stop = threading.Event()

    def metric_writer():
        while not stop.is_set():
            for pod in cluster.store.list(objects.KIND_POD):
                lr = pod.spec.container.env.get("KFT_LR")
                d = root / "status" / pod.metadata.namespace / pod.metadata.name
                if lr is None or (d / "metrics.jsonl").exists():
                    continue
                d.mkdir(parents=True, exist_ok=True)
                row = {"name": "score", "value": _score(float(lr)), "step": 3}
                (d / "metrics.jsonl").write_text(json.dumps(row) + "\n")
            stop.wait(0.01)

    exp = api.Experiment.model_validate({
        "metadata": {"name": "sweep"},
        "spec": {
            "objective": {"type": "maximize",
                          "objective_metric_name": "score"},
            "algorithm": {"algorithm_name": "random"},
            "parameters": [PARAMS[0]],
            "parallel_trial_count": 1, "max_trial_count": 4,
            "early_stopping": ({"algorithm_name": "asha", "settings": {
                "min_resource": "3", "reduction_factor": "2"}}
                if early_stopping else None),
            "trial_template": {"job_manifest": {
                "kind": "JaxJob", "metadata": {"name": "placeholder"},
                "spec": {"replica_specs": {"worker": {"replicas": 1,
                         "template": {"entrypoint": "none:main", "env": {
                             "KFT_LR": "${trialParameters.lr}"}}}}}}}}})
    writer = threading.Thread(target=metric_writer, daemon=True)
    with cluster:
        kubelet.start()
        writer.start()
        try:
            cluster.store.create(exp)
            deadline = time.time() + 60
            while time.time() < deadline:
                got = cluster.store.try_get("Experiment", "sweep")
                if got is not None and got.status.completed:
                    break
                time.sleep(0.05)
            assert got is not None and got.status.completed, got
            trials = sorted(cluster.store.list("Trial"),
                            key=lambda t: t.metadata.name)
            events = sorted(e.reason for e in _mod(
                pkg, "controlplane.controller").events_for(
                    cluster.store, "Experiment", "sweep"))
        finally:
            stop.set()
            kubelet.stop()
    st = got.status
    return {
        "trials": [(t.metadata.name, {a.name: a.value
                                      for a in t.spec.assignments},
                    t.status.phase) for t in trials],
        "optimal": (st.current_optimal_trial, st.current_optimal_value,
                    [(a.name, a.value) for a in st.current_optimal_assignments]),
        "counts": (st.trials_succeeded, st.trials_early_stopped,
                   st.trials_failed),
        "conditions": [c.type for c in st.conditions],
        "events": events,
    }


@pytest.mark.parametrize("early_stopping", [False, True],
                         ids=["random", "asha"])
def test_experiment_matches_reference(early_stopping, tmp_path, monkeypatch):
    runs = {}
    for pkg in PKGS:
        _seeded_suggestions(pkg, monkeypatch)
        runs[pkg] = _run_experiment(pkg, tmp_path / pkg, early_stopping)
    want = runs["kubeflow_tpu"]
    assert runs["kubeflow_tpu_torch"] == want
    assert len(want["trials"]) == 4
    # the four lrs differ: the seed really moves with the trial index
    assert len({a["lr"] for _, a, _ in want["trials"]}) == 4
    stopped = [name for name, _, phase in want["trials"]
               if phase == "EarlyStopped"]
    assert bool(stopped) == early_stopping, want
    assert want["events"] == sorted(
        ["MaxTrialsReached", "SuggestionCreated"] + ["TrialCreated"] * 4)



class _PhaseRecordingDb:
    """A db-manager stub that records, at each report, the phase the
    trial has in the store at that moment (``fail`` makes every report
    raise, as an unreachable db does)."""

    def __init__(self, store, fail: bool = False):
        self.store, self.fail = store, fail
        self.phases: list[tuple[str, str]] = []

    def _record(self, what: str, namespace: str, trial: str) -> None:
        t = self.store.try_get("Trial", trial, namespace)
        self.phases.append((what, t.status.phase))
        if self.fail:
            raise ConnectionError("db-manager unreachable")

    def report_observation(self, *, experiment, trial, assignments, value,
                           namespace):
        self._record("observation", namespace, trial)

    def report_observation_series(self, *, experiment, trial, assignments,
                                  series, namespace):
        self._record("series", namespace, trial)


def _succeeded_trial(tmp_path, fail: bool):
    """The port's ``TrialController`` reconciling one trial whose job has
    succeeded and whose pod wrote a three-step objective curve, with a
    ``_PhaseRecordingDb``; returns (db, trial after the reconcile, the
    trial's event reasons)."""
    api_exp = _mod("kubeflow_tpu_torch", "api.experiment")
    common = _mod("kubeflow_tpu_torch", "api.common")
    yaml_io = _mod("kubeflow_tpu_torch", "api.yaml_io")
    store_mod = _mod("kubeflow_tpu_torch", "controlplane.store")
    ctl = _mod("kubeflow_tpu_torch", "hpo.controllers")
    events_for = _mod("kubeflow_tpu_torch",
                      "controlplane.controller").events_for
    store = store_mod.Store()
    manifest = {"kind": "JaxJob", "metadata": {"name": "t0"},
                "spec": {"replica_specs": {"worker": {"replicas": 1,
                         "template": {"entrypoint": "none:main"}}}}}
    trial = api_exp.Trial.model_validate({
        "metadata": {"name": "t0"},
        "spec": {"experiment_name": "sweep", "objective_metric_name": "loss",
                 "assignments": [{"name": "lr", "value": "0.01"}],
                 "job_manifest": manifest},
        "status": {"phase": "Running"}})
    store.create(trial)
    job = yaml_io.from_dict(manifest)
    job.status.conditions = [common.JobCondition(
        type=common.JobConditionType.SUCCEEDED)]
    store.create(job)
    d = tmp_path / "status" / "default" / common.replica_pod_name(
        "t0", "worker", 0)
    d.mkdir(parents=True)
    (d / "metrics.jsonl").write_text("".join(
        json.dumps({"name": "loss", "value": v, "step": s}) + "\n"
        for s, v in ((1, 3.0), (2, 2.5), (3, 2.0))))
    db = _PhaseRecordingDb(store, fail=fail)
    ctl.TrialController(store, metrics_root=str(tmp_path),
                        db=db).reconcile("default", "t0")
    return (db, store.try_get("Trial", "t0", "default"),
            [e.reason for e in events_for(store, "Trial", "t0")])


def test_trial_reports_to_the_db_before_it_succeeds(tmp_path):
    """The experiment completes on its trials' phases, so a reader at
    completion reads the db: every report of a trial must be in the db
    before the trial turns Succeeded."""
    db, trial, events = _succeeded_trial(tmp_path, fail=False)
    assert db.phases == [("observation", "Running"), ("series", "Running")]
    assert trial.status.phase == "Succeeded"
    assert trial.status.observation == 2.0
    assert "ObservationReportFailed" not in events


def test_trial_succeeds_when_the_db_is_down(tmp_path):
    db, trial, events = _succeeded_trial(tmp_path, fail=True)
    assert db.phases == [("observation", "Running")]
    assert trial.status.phase == "Succeeded"
    assert "ObservationReportFailed" in events
    assert "TrialSucceeded" in events
