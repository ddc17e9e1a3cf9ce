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
  barrier instead of running on the CPU;
- a pod sees only the cards the scheduler bound to it
  (``CUDA_VISIBLE_DEVICES``, ``KFT_POD_CARDS``), never this process's;
- one worker with ``gpu: 2`` runs two local ranks (gloo on CPU pods):
  both print the same ``loss=`` lines of ``train/llm.py``'s trainer,
  within rtol 1e-4 of the reference trainer's ``{"data": 2}`` curve on
  two virtual devices from the same snapshot, and the pod passes its
  barrier once both did;
- a pod whose local rank 1 fails ends its other rank and fails with that
  rank's exit code and message.

Only the test process imports the port here; the pods import it
themselves.
"""

import os
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120


def _run_job(tmp_path, monkeypatch, example, name, entrypoint, replicas,
             env, gpu=0):
    """Submit ``examples/<example>`` as ``name`` with the port's
    ``entrypoint``, ``replicas`` workers of ``gpu`` cards and ``env``; wait
    until it succeeds or fails. Returns (job, the kubelet's log path
    function)."""
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
    worker.template.resources.gpu = gpu
    cluster = Cluster()
    cluster.add_gpu_hosts("s0", 2, 4)
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


def test_a_pod_sees_only_its_own_cards(tmp_path, monkeypatch):
    """The kubelet makes the bound cards, and only they, visible: a
    time-sliced card (an id bound twice) is one device, each local rank
    of a two-card pod computes on its own card, and this process's
    ``CUDA_VISIBLE_DEVICES`` does not pass through."""
    from kubeflow_tpu_torch.api.common import ObjectMeta
    from kubeflow_tpu_torch.controlplane.objects import Pod
    from kubeflow_tpu_torch.controlplane.store import Store
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.runtime.launcher import LocalKubelet

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")
    monkeypatch.delenv("KFT_POD_DEVICE", raising=False)
    kubelet = LocalKubelet(Store(), str(tmp_path))
    for ids, visible in (([2, 5], "2,5"), ([0, 0], "0"), ([], "")):
        pod = Pod(metadata=ObjectMeta(name="p"))
        pod.spec.device_ids = ids
        env = kubelet._build_env(pod, str(tmp_path))
        assert env["CUDA_VISIBLE_DEVICES"] == visible
        ctx = bootstrap.PodContext.from_env(env)
        assert ctx.cards == ids
    ctx = bootstrap.PodContext(process_id=1, num_processes=3, cards=[2, 5])
    ranks = [bootstrap.local_rank_env(ctx, j, env={}) for j in range(2)]
    assert [(r["JAX_PROCESS_ID"], r["JAX_NUM_PROCESSES"], r["KFT_POD_DEVICE"],
             r["KFT_LOCAL_RANK"]) for r in ranks] == [
        ("2", "6", "cuda:0", "0"), ("3", "6", "cuda:1", "1")]
    # a pod that names its device keeps it on every local rank
    cpu = bootstrap.PodContext(cards=[0, 1], device="cpu")
    assert [bootstrap.local_rank_env(cpu, j, env={"KFT_POD_DEVICE": "cpu"})[
        "KFT_POD_DEVICE"] for j in range(2)] == ["cpu", "cpu"]
    sliced = bootstrap.PodContext(cards=[0, 0])
    assert [bootstrap.local_rank_env(sliced, j, env={})["KFT_POD_DEVICE"]
            for j in range(2)] == ["cuda:0", "cuda:0"]


def _ref_llm_losses(monkeypatch, env: dict, mesh: dict) -> list[float]:
    """The reference ``train/llm.py`` trainer's losses under ``env`` on
    ``mesh``, over as many virtual devices."""
    import math

    import jax

    from kubeflow_tpu.runtime import bootstrap as ref_boot
    from kubeflow_tpu.train import llm as ref_llm
    from kubeflow_tpu.train import trainer as ref_train

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = ref_llm.config_from_env(ref_boot.PodContext(mesh_axes=mesh))
    t = ref_train.Trainer(cfg, devices=jax.devices()[:math.prod(
        mesh.values())])
    losses: list[float] = []
    t.train(source=ref_llm.source_from_env(cfg),
            on_metrics=lambda m: losses.append(float(m.loss)))
    return losses


def test_a_two_card_worker_runs_two_ranks_on_the_reference_curve(
        tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from flax import linen as nn

    from kubeflow_tpu.models import llama as ref_llama
    from kubeflow_tpu_torch.api.common import JobConditionType

    cfg = ref_llama.tiny()
    params = ref_llama.Llama(cfg).init(jax.random.PRNGKey(0),
                                       jnp.ones((1, 8), jnp.int32))["params"]
    snap = str(tmp_path / "base")
    ref_llama.save_pretrained(snap, cfg, jax.tree.map(
        np.asarray, nn.meta.unbox(params)))
    env = {"KFT_INIT_FROM": f"file://{snap}", "KFT_STEPS": "3",
           "KFT_BATCH": "4", "KFT_SEQ_LEN": "16", "KFT_WARMUP": "1",
           "KFT_LOG_EVERY": "1"}
    job, log_path = _run_job(
        tmp_path, monkeypatch, "05-jaxjob-llm.yaml", "llm-cards",
        "tests._torch_pod_entry:train_main", 1,
        {**env, "KFT_POD_DEVICE": "cpu"}, gpu=2)
    cond = _condition(job, JobConditionType.SUCCEEDED)
    assert cond is not None and cond.status, job.status
    # the default mesh is one device a card: {"data": 1 pod x 2 cards}
    assert job.spec.mesh == {"data": 2}
    assert job.status.gang_startup_seconds is not None
    with open(log_path("default", "llm-cards-worker-0")) as f:
        log = f.read()
    assert "pod_main: process 1 of 2, local rank 1 on cpu; the pod's " \
        "cards 0,1" in log
    ranks: dict = {}
    for line in log.splitlines():
        if line.startswith("loss="):
            loss, proc = line.split()
            ranks.setdefault(proc, []).append(float(loss.split("=")[1]))
    assert sorted(ranks) == ["process=0", "process=1"]
    assert ranks["process=0"] == ranks["process=1"]
    want = _ref_llm_losses(monkeypatch, env, {"data": 2})
    assert len(want) == 3
    np.testing.assert_allclose(ranks["process=0"], want, rtol=1e-4)


def test_a_failed_local_rank_fails_its_pod_with_its_message(
        tmp_path, monkeypatch):
    from kubeflow_tpu_torch.api.common import JobConditionType

    t0 = time.time()
    job, log_path = _run_job(
        tmp_path, monkeypatch, "01-jaxjob-mnist.yaml", "rank-fails",
        "tests._torch_pod_entry:fail_on_local_1", 1,
        {"KFT_POD_DEVICE": "cpu"}, gpu=2)
    cond = _condition(job, JobConditionType.FAILED)
    assert cond is not None and cond.status, job.status
    # local rank 0 sleeps 120 s unless its pod ends it
    assert time.time() - t0 < 60
    assert "RuntimeError: local rank 1 fails on purpose" in cond.message
    with open(log_path("default", "rank-fails-worker-0")) as f:
        log = f.read()
    assert "pod_main: local rank 1 exited 1; the pod's other ranks ended" \
        in log
