"""JaxJobs through the port's ``Cluster`` and its ``LocalKubelet``
(``kubeflow_tpu_torch/runtime/{launcher,pod_main}.py``): real pod
processes running ``python -m kubeflow_tpu_torch.runtime.pod_main``.

- ``examples/01-jaxjob-mnist.yaml`` with the port's entrypoint
  (``kubeflow_tpu_torch.models.mnist:train_main``) and
  ``KFT_POD_DEVICE=cpu`` reaches ``Succeeded``, its pod passed the gang
  barrier (``gang_startup_seconds``), and its log holds ``loss=`` and the
  device it trained on;
- a two-worker ResNet job (``examples/02``'s shape) ends ``Failed``, not
  hung, with a message naming ROADMAP A5 (the pods' termination message);
- a pod with no ``KFT_POD_DEVICE`` on a machine with no card fails in its
  barrier instead of running on the CPU.

Only the test process imports the port here; the pods import it
themselves.
"""

import os
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120


def _run_job(tmp_path, monkeypatch, example, name, entrypoint, replicas,
             env):
    """Submit ``examples/<example>`` as ``name`` with the port's
    ``entrypoint``, ``replicas`` workers and ``env``; wait until it
    succeeds or fails. Returns (job, the kubelet's log path function)."""
    from kubeflow_tpu_torch.api.common import JobConditionType, has_condition
    from kubeflow_tpu_torch.api.yaml_io import load_yaml_file
    from kubeflow_tpu_torch.controlplane.cluster import Cluster
    from kubeflow_tpu_torch.runtime.launcher import LocalKubelet

    monkeypatch.delenv("KFT_POD_DEVICE", raising=False)
    (job,) = load_yaml_file(os.path.join(ROOT, "examples", example))
    job.metadata.name = name
    worker = job.spec.replica_specs["worker"]
    worker.replicas = replicas
    worker.template.entrypoint = entrypoint
    worker.template.env = {**worker.template.env, **env}
    cluster = Cluster()
    cluster.add_tpu_slice("s0", 2, 4)
    kubelet = LocalKubelet(cluster.store, str(tmp_path))
    done = (JobConditionType.SUCCEEDED, JobConditionType.FAILED)
    with cluster:
        kubelet.start()
        try:
            cluster.store.create(job)
            deadline = time.time() + WAIT_S
            while time.time() < deadline:
                got = cluster.store.get("JaxJob", name)
                if any(has_condition(got.status.conditions, c)
                       for c in done):
                    break
                time.sleep(0.1)
        finally:
            kubelet.stop()
    return got, kubelet.pod_log_path


def _condition(job, ctype):
    from kubeflow_tpu_torch.api.common import get_condition

    return get_condition(job.status.conditions, ctype)


def test_mnist_jaxjob_succeeds_on_cpu(tmp_path, monkeypatch):
    from kubeflow_tpu_torch.api.common import JobConditionType

    job, log_path = _run_job(
        tmp_path, monkeypatch, "01-jaxjob-mnist.yaml", "mnist-smoke",
        "kubeflow_tpu_torch.models.mnist:train_main", 1,
        {"KFT_POD_DEVICE": "cpu", "KFT_STEPS": "4", "KFT_BATCH": "16"})
    cond = _condition(job, JobConditionType.SUCCEEDED)
    assert cond is not None and cond.status, job.status
    assert job.status.gang_startup_seconds is not None
    with open(log_path("default", "mnist-smoke-worker-0")) as f:
        log = f.read()
    assert "loss=" in log and "accuracy=" in log
    assert "mnist: training on cpu" in log


def test_two_worker_resnet_job_fails_naming_a5(tmp_path, monkeypatch):
    from kubeflow_tpu_torch.api.common import JobConditionType

    job, _ = _run_job(
        tmp_path, monkeypatch, "02-jaxjob-resnet-ddp.yaml", "resnet-ddp",
        "kubeflow_tpu_torch.models.resnet:train_main", 2,
        {"KFT_POD_DEVICE": "cpu", "KFT_RESNET": "tiny"})
    cond = _condition(job, JobConditionType.FAILED)
    assert cond is not None and cond.status, job.status
    assert "A5" in cond.message and "NotImplementedError" in cond.message


def test_pod_without_a_device_fails_without_a_card(tmp_path, monkeypatch):
    import torch

    from kubeflow_tpu_torch.api.common import JobConditionType

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the pod would run on it")
    job, log_path = _run_job(
        tmp_path, monkeypatch, "01-jaxjob-mnist.yaml", "mnist-nocard",
        "kubeflow_tpu_torch.models.mnist:train_main", 1,
        {"KFT_STEPS": "1", "KFT_BATCH": "4"})
    cond = _condition(job, JobConditionType.FAILED)
    assert cond is not None and cond.status, job.status
    assert "no CUDA device" in cond.message
    with open(log_path("default", "mnist-nocard-worker-0")) as f:
        assert "loss=" not in f.read()
