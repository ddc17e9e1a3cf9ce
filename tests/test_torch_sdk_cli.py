"""The port's SDK (``kubeflow_tpu_torch/sdk/``), CLI (``cli.py``,
``python -m kubeflow_tpu_torch``) and ``LocalPlatform`` against the
reference's, on the CPU.

- The CLI's ``apply/get/describe/logs/delete/api-resources`` against each
  package's ``serve_api`` print the same columns and rows for the same
  manifest (ages masked), the port's through ``python -m`` once.
- ``KServeClient`` serves one echo service in each package with the same
  answers.
- One ``LocalPlatform`` of the port with real pod processes
  (``KFT_POD_DEVICE=cpu``) runs a ``KatibClient.tune`` sweep, a
  ``TrainingClient`` job and a Notebook whose ``notebook_server`` answers
  ``/execute``: the only pods these files spawn.

Both packages are imported inside the tests.
"""

import importlib
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import pytest
import yaml

from tests._torch_resources import add_hosts, as_port

PKGS = ("kubeflow_tpu", "kubeflow_tpu_torch")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = """
kind: JaxJob
metadata:
  name: cli-job
spec:
  replicaSpecs:
    worker:
      replicas: 1
      template:
        entrypoint: none:main
        env:
          KFT_STEPS: "3"
---
kind: Profile
metadata:
  name: team-cli
spec:
  owner: cli@corp
"""
POD = "cli-job-worker-0"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _table(out: str) -> list[list[str]]:
    """A ``get`` table's rows, its AGE column masked."""
    rows = [re.split(r"\s{2,}", line.strip()) for line in out.splitlines()]
    return [r[:3] for r in rows]


def _cli_session(pkg: str, tmp_path, capsys) -> dict:
    cli = _mod(pkg, "cli")
    cluster_mod = _mod(pkg, "controlplane.cluster")
    fk = _mod(pkg, "controlplane.fake_kubelet")
    logs = tmp_path / pkg
    logs.mkdir()
    (logs / f"{POD}.log").write_text("loss=1.5\nloss=1.25\n")
    manifest = tmp_path / f"{pkg}.yaml"
    manifest.write_text(MANIFEST)
    cluster = cluster_mod.Cluster()
    add_hosts(pkg, cluster, "slice-0", 1, 4)
    cluster.enable_hpo(log_path_for=lambda ns, pod: str(logs / f"{pod}.log"))
    kubelet = fk.FakeKubelet(cluster.store)
    out = {}

    def run(*argv):
        rc = cli.main(["--server", url, *argv])
        got = capsys.readouterr()
        return rc, got.out, got.err

    with cluster:
        kubelet.start()
        try:
            url = cluster.serve_api()
            out["apply"] = run("apply", "-f", str(manifest))
            deadline = time.time() + 30
            while time.time() < deadline:
                job = cluster.store.try_get("JaxJob", "cli-job")
                if job.status.conditions and job.status.conditions[-1].type \
                        == "Succeeded":
                    break
                time.sleep(0.05)
            rc, table, _ = run("get", "jaxjobs")
            out["get"] = rc, _table(table)
            rc, text, _ = run("get", "profile", "team-cli", "-o", "yaml")
            out["get_yaml"] = rc, yaml.safe_load(text)["spec"]
            rc, text, _ = run("describe", "jaxjob", "cli-job")
            body, _, events = text.partition("Events:\n")
            obj = yaml.safe_load(body)
            out["describe"] = (rc, sorted(obj), obj["spec"],
                               obj["status"]["conditions"][-1]["type"],
                               bool(events.strip()))
            out["logs"] = run("logs", POD)
            out["reapply"] = run("apply", "-f", str(manifest))
            out["delete"] = run("delete", "jaxjob", "cli-job")
            out["gone"] = run("get", "jaxjob", "cli-job")[0]
            out["kinds"] = run("api-resources")
            if pkg == "kubeflow_tpu_torch":
                # the module entry, in a process of its own
                proc = subprocess.run(
                    [sys.executable, "-m", "kubeflow_tpu_torch", "--server",
                     url, "get", "profiles"], capture_output=True, text=True,
                    timeout=60, cwd=ROOT)
                out["module"] = proc.returncode, _table(proc.stdout)
        finally:
            kubelet.stop()
    return out


def test_cli_matches_reference(tmp_path, capsys):
    got = {pkg: _cli_session(pkg, tmp_path, capsys) for pkg in PKGS}
    want, port = got["kubeflow_tpu"], got["kubeflow_tpu_torch"]
    assert port.pop("module") == (0, [["NAMESPACE", "NAME", "PHASE"],
                                      ["default", "team-cli", "Pending"]])
    # the job's resources count the port's cards as the reference's chips
    assert port == as_port(want)
    assert want["apply"][1] == "jaxjob/cli-job created\nprofile/team-cli created\n"
    assert want["get"] == (0, [["NAMESPACE", "NAME", "PHASE"],
                               ["default", "cli-job", "Succeeded"]])
    assert want["logs"] == (0, "loss=1.5\nloss=1.25\n", "")
    assert "configured" in want["reapply"][1] and want["gone"] == 1
    assert "Experiment" in want["kinds"][1]


def test_kserve_client_echo_matches_reference():
    answers = {}
    for pkg in PKGS:
        cluster = _mod(pkg, "controlplane.cluster").Cluster()
        add_hosts(pkg, cluster, "s0", 1, 4)
        cluster.enable_serving()
        with cluster:
            client = _mod(pkg, "sdk").KServeClient(cluster)
            client.create({
                "kind": "InferenceService", "metadata": {"name": "echo"},
                "spec": {"predictor": {"modelFormat": {"name": "echo"}}}})
            isvc = client.wait_isvc_ready("echo", timeout=30)
            answers[pkg] = (isvc.status.phase,
                            client.predict("echo", [[1.0, 2.0], [3.5]]))
            client.delete("echo")
            assert client.get("echo") is None
    assert answers["kubeflow_tpu_torch"] == answers["kubeflow_tpu"]


@pytest.fixture(scope="module")
def platform(tmp_path_factory):
    """One port ``LocalPlatform``: real pod processes on the CPU, the ux
    tier on."""
    from kubeflow_tpu_torch.runtime.platform import LocalPlatform

    p = LocalPlatform(root_dir=str(tmp_path_factory.mktemp("platform")),
                      env_overrides={"KFT_POD_DEVICE": "cpu"})
    p.cluster.enable_platform_ux()
    with p:
        yield p


def test_katib_client_tune_runs_trial_pods(platform):
    from kubeflow_tpu_torch.api.experiment import ObjectiveType
    from kubeflow_tpu_torch.sdk import KatibClient, search_double

    client = KatibClient(platform)
    exp = client.tune(
        name="lr-sweep", entrypoint="tests._torch_hpo_objective:objective_main",
        parameters={"lr": search_double(0.001, 0.1, log=True)},
        objective_metric="score", objective_type=ObjectiveType.MAXIMIZE,
        algorithm="random", max_trials=3, parallel_trials=2, timeout=120)
    assert exp.status.completed and exp.status.trials_succeeded == 3
    trials = client.list_trials("lr-sweep")
    scores = {t.metadata.name: t.status.observation for t in trials}
    assert all(t.status.phase == "Succeeded" for t in trials)
    for t in trials:
        lr = {a.name: a.value for a in t.spec.assignments}["lr"]
        assert scores[t.metadata.name] == 1.0 - (lr - 0.03) ** 2 * 100.0
    best = client.get_optimal_hyperparameters("lr-sweep")
    assert exp.status.current_optimal_trial == max(scores, key=scores.get)
    assert best["value"] == max(scores.values())


def test_training_client_job(platform):
    from kubeflow_tpu_torch.sdk import TrainingClient

    client = TrainingClient(platform)
    job = client.train(name="sdk-job",
                       entrypoint="tests._torch_hpo_objective:objective_main",
                       env={"KFT_LR": "0.05"}, timeout=120)
    assert job.status.conditions[-1].type == "Succeeded"
    logs = client.get_job_logs("sdk-job")
    assert list(logs) == ["sdk-job-worker-0"]
    assert f"score={1.0 - (0.05 - 0.03) ** 2 * 100.0}" in logs["sdk-job-worker-0"]
    client.delete_job("sdk-job")
    assert client.get_job("sdk-job") is None


def test_notebook_pod_answers_execute(platform):
    from kubeflow_tpu_torch.api.common import Container, ObjectMeta, Resources
    from kubeflow_tpu_torch.api.platform import Notebook, NotebookSpec

    store = platform.store
    store.create(Notebook(
        metadata=ObjectMeta(name="wb"),
        spec=NotebookSpec(template=Container(
            entrypoint="kubeflow_tpu_torch.ux.notebook_server:main",
            resources=Resources(cpu=1)))))
    port_file = os.path.join(platform.root_dir, "status", "default",
                             "wb-notebook-0", "notebook_port")
    deadline = time.time() + 60
    while time.time() < deadline and not (
            os.path.exists(port_file)
            and store.try_get("Notebook", "wb").status.phase == "Running"):
        time.sleep(0.1)
    nb = store.try_get("Notebook", "wb")
    assert nb.status.phase == "Running" and "wb-notebook-0" in nb.status.url
    with open(port_file) as f:
        url = f"http://127.0.0.1:{int(f.read())}"

    def execute(code):
        req = urllib.request.Request(
            f"{url}/execute", data=json.dumps({"code": code}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    assert execute("x = 20") == {"result": None, "stdout": ""}
    assert execute("print(x + 1); x * 2") == {"result": None, "stdout": "21\n"}
    assert execute("x * 2") == {"result": "40", "stdout": ""}
    store.try_delete("Notebook", "wb")
    deadline = time.time() + 30
    while time.time() < deadline and store.try_get("Pod", "wb-notebook-0"):
        time.sleep(0.05)
    assert store.try_get("Pod", "wb-notebook-0") is None
