"""TrainingClient — the Python SDK over the control plane.

Capability parity with the reference SDK [upstream:
kubeflow/training-operator -> sdk/python/kubeflow/training/api/
training_client.py]: ``create_job``, ``get_job``, ``wait_for_job_conditions``,
``get_job_logs``, ``delete_job``, and the one-call ``train()`` UX (the v1.9
LLM fine-tune entry named in the north star — here it emits a JaxJob whose
pods run the port's packaged trainer instead of a torch/peft container).

The port's copy of ``kubeflow_tpu/sdk/client.py``, device-free like it,
with the same names but one: ``train()`` asks for ``gpus_per_worker``
NVIDIA cards where the reference asks ``chips_per_worker`` TPU chips. It
imports nothing of the reference package.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

from ..api import (
    Container,
    JaxJob,
    ObjectMeta,
    ReplicaSpec,
    Resources,
    RestartPolicy,
    RunPolicy,
    from_dict,
    load_yaml,
)
from ..api.common import JobConditionType, has_condition, replica_pod_name
from ..api.jaxjob import KIND_JAXJOB, WORKER
from ..runtime.platform import LocalPlatform


class JobTimeoutError(TimeoutError):
    pass


class TrainingClient:
    def __init__(self, platform: LocalPlatform) -> None:
        self.platform = platform

    # -- CRUD -----------------------------------------------------------------

    def create_job(self, job: Union[JaxJob, dict, str]) -> JaxJob:
        if isinstance(job, str):
            objs = load_yaml(job)
            if len(objs) != 1 or not isinstance(objs[0], JaxJob):
                raise ValueError("expected exactly one JaxJob document")
            job = objs[0]
        elif isinstance(job, dict):
            obj = from_dict(job)
            if not isinstance(obj, JaxJob):
                raise ValueError(f"manifest is a {obj.kind}, not a JaxJob")
            job = obj
        created = self.platform.store.create(job)
        assert isinstance(created, JaxJob)
        return created

    def get_job(self, name: str, namespace: str = "default") -> Optional[JaxJob]:
        job = self.platform.store.try_get(KIND_JAXJOB, name, namespace)
        assert job is None or isinstance(job, JaxJob)
        return job

    def delete_job(self, name: str, namespace: str = "default") -> None:
        self.platform.store.try_delete(KIND_JAXJOB, name, namespace)

    def list_jobs(self, namespace: Optional[str] = None) -> list[JaxJob]:
        return [j for j in self.platform.store.list(KIND_JAXJOB, namespace)]  # type: ignore[misc]

    # -- waiting / logs -------------------------------------------------------

    def wait_for_job_conditions(
        self,
        name: str,
        namespace: str = "default",
        expected: Sequence[JobConditionType] = (JobConditionType.SUCCEEDED,),
        timeout: float = 120.0,
        poll: float = 0.05,
    ) -> JaxJob:
        """Block until the job reaches one of ``expected``; raises on FAILED
        unless FAILED is itself expected (the reference SDK's semantics)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            job = self.get_job(name, namespace)
            if job is not None:
                for c in expected:
                    if has_condition(job.status.conditions, c):
                        return job
                if JobConditionType.FAILED not in expected and has_condition(
                    job.status.conditions, JobConditionType.FAILED
                ):
                    raise RuntimeError(
                        f"job {name} failed: "
                        + "; ".join(
                            f"{c.reason}: {c.message}" for c in job.status.conditions
                        )
                    )
            time.sleep(poll)
        raise JobTimeoutError(f"job {name}: no {list(expected)} within {timeout}s")

    def get_job_logs(
        self, name: str, namespace: str = "default"
    ) -> dict[str, str]:
        """Pod name -> captured stdout/stderr (the kubectl-logs surface)."""
        out: dict[str, str] = {}
        job = self.get_job(name, namespace)
        if job is None:
            return out
        for rtype, rspec in job.spec.replica_specs.items():
            for idx in range(rspec.replicas):
                pod_name = replica_pod_name(name, rtype, idx)
                path = self.platform.kubelet.pod_log_path(namespace, pod_name)
                try:
                    with open(path) as f:
                        out[pod_name] = f.read()
                except OSError:
                    pass
        return out

    # -- one-call UX ----------------------------------------------------------

    def train(
        self,
        name: str,
        entrypoint: str,
        num_workers: int = 1,
        gpus_per_worker: int = 0,
        env: Optional[dict[str, str]] = None,
        mesh: Optional[dict[str, int]] = None,
        model: Optional[str] = None,
        lora_rank: int = 0,
        publish_to: Optional[str] = None,
        backoff_limit: int = 0,
        namespace: str = "default",
        wait: bool = True,
        timeout: float = 300.0,
    ) -> JaxJob:
        """Build + submit a JaxJob in one call [reference analog:
        TrainingClient.train, the north-star fine-tune UX].

        ``model``: pretrained snapshot URI (``hf://org/name[@rev]`` or
        ``file:///path``) to fine-tune from — the literal v1.9 LLM path:
        the trainer resolves it through the storage initializer, takes the
        architecture from the snapshot's config.json, and loads the
        weights before step 0 (train/llm.py KFT_INIT_FROM).

        ``lora_rank``: > 0 trains rank-r LoRA adapters on the snapshot's
        q/v projections with the base FROZEN (the reference's peft path,
        SURVEY §3.5) — checkpoints and the published artifact shrink to
        adapter size.  ``publish_to``: directory the coordinator writes
        the trained snapshot to (save_adapter under LoRA, save_pretrained
        otherwise) — the train -> publish -> serve loop's publish step.

        ``gpus_per_worker``: NVIDIA cards each worker pod asks for; a pod
        of k cards runs k ranks, one a card (``runtime/pod_main``).
        """
        if model:
            env = {**(env or {}), "KFT_INIT_FROM": model}
        if lora_rank:
            env = {**(env or {}), "KFT_LORA_RANK": str(int(lora_rank))}
        if publish_to:
            env = {**(env or {}), "KFT_PUBLISH_TO": publish_to}
        job = JaxJob(
            metadata=ObjectMeta(name=name, namespace=namespace),
            spec={
                # coordinator_port defaults to 0 = allocated by the
                # controller at gang-bind time (r1 weak #6)
                "run_policy": RunPolicy(backoff_limit=backoff_limit),
                **({"mesh": mesh} if mesh else {}),
                "replica_specs": {
                    WORKER: ReplicaSpec(
                        replicas=num_workers,
                        restart_policy=RestartPolicy.EXIT_CODE,
                        template=Container(
                            entrypoint=entrypoint,
                            env=env or {},
                            resources=Resources(gpu=gpus_per_worker),
                        ),
                    )
                },
            },
        )
        created = self.create_job(job)
        if wait:
            return self.wait_for_job_conditions(name, namespace, timeout=timeout)
        return created
