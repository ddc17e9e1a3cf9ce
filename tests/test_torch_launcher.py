"""JaxJobs through the port's ``Cluster`` and its ``LocalKubelet``
(``kubeflow_tpu_torch/runtime/{launcher,pod_main}.py``): real pod
processes running ``python -m kubeflow_tpu_torch.runtime.pod_main``.

- ``examples/01-jaxjob-mnist.yaml`` with the port's entrypoint
  (``kubeflow_tpu_torch.models.mnist:train_main``) and
  ``KFT_POD_DEVICE=cpu`` reaches ``Succeeded``, its pod passed the gang
  barrier (``gang_startup_seconds``), and its log holds ``loss=`` and the
  device it trained on;
- the two-worker ResNet DDP job of ``examples/02`` (gloo on CPU pods)
  reaches ``Succeeded``; both ranks print the same ``loss=`` lines, within
  1e-5 of one process trained on the two ranks' batches joined together;
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


def _losses(log_path, ns, pod) -> list[float]:
    with open(log_path(ns, pod)) as f:
        return [float(line.split("=", 1)[1]) for line in f
                if line.startswith("loss=")]


def _joined_resnet_losses(steps: int, batch: int) -> list[float]:
    """One process trained on both ranks' batches of each step (keys
    2i and 2i + 1), joined: the losses two DDP ranks must print."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models import resnet

    torch.set_num_threads(1)
    cfg = resnet.tiny(num_classes=10)
    model = resnet.ResNet(cfg, device="cpu")
    model.init_weights(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    out = []
    for i in range(steps):
        parts = [resnet.synthetic_batch(2 * i + r, batch // 2, 10)
                 for r in range(2)]
        x = torch.from_numpy(np.concatenate([p[0] for p in parts]))
        y = torch.from_numpy(np.concatenate([p[1] for p in parts]))
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        out.append(float(loss.detach()))
    return out


def test_two_worker_resnet_job_fails_naming_a5(tmp_path, monkeypatch):
    """(Named when such a job was refused.) The two-worker DDP job of
    ``examples/02`` now trains: both ranks print one global loss per step,
    the joined single-process run's."""
    from kubeflow_tpu_torch.api.common import JobConditionType

    job, log_path = _run_job(
        tmp_path, monkeypatch, "02-jaxjob-resnet-ddp.yaml", "resnet-ddp",
        "kubeflow_tpu_torch.models.resnet:train_main", 2,
        {"KFT_POD_DEVICE": "cpu", "KFT_RESNET": "tiny"})
    cond = _condition(job, JobConditionType.SUCCEEDED)
    assert cond is not None and cond.status, job.status
    assert job.status.gang_startup_seconds is not None
    ranks = [_losses(log_path, "default", f"resnet-ddp-worker-{r}")
             for r in range(2)]
    assert len(ranks[0]) == 2 and ranks[0] == ranks[1]
    import numpy as np

    np.testing.assert_allclose(ranks[0], _joined_resnet_losses(2, 16),
                               atol=1e-5)


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
