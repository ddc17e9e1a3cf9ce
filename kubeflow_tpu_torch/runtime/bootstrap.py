"""In-pod runtime bootstrap: the env contract of a job's process.

The port's copy of ``kubeflow_tpu/runtime/bootstrap.py`` for a one-process
job: ``PodContext`` parsed from the same environment variables the JaxJob
controller injects (plus ``KFT_POD_DEVICE``, the device the pod computes
on: the CUDA card when unset), the coordinator test, the gang-startup probe
``barrier`` (it synchronizes the pod's device and stamps ``BARRIER_FILE``),
the metric stream (stdout ``name=value`` and the status dir's
``metrics.jsonl``) and the coordinator address mapping. A job of several
processes needs ``torch.distributed``'s rendezvous and a collective
barrier, which are ROADMAP A5: ``initialize`` and ``barrier`` raise for it.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

#: Env contract — the JaxJob controller's names, as in the reference.
ENV_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_JOB_NAME = "KFT_JOB_NAME"
ENV_JOB_NAMESPACE = "KFT_JOB_NAMESPACE"
ENV_REPLICA_TYPE = "KFT_REPLICA_TYPE"
ENV_REPLICA_INDEX = "KFT_REPLICA_INDEX"
ENV_MESH = "KFT_MESH"
ENV_STATUS_DIR = "KFT_STATUS_DIR"
ENV_ENTRYPOINT = "KFT_ENTRYPOINT"
#: the device a pod computes on ("cpu", "cuda", "cuda:1"); unset = the card
ENV_POD_DEVICE = "KFT_POD_DEVICE"

BARRIER_FILE = "barrier"
METRICS_FILE = "metrics.jsonl"


@dataclass
class PodContext:
    """Everything a training process knows about itself, parsed from env."""

    job_name: str = "local"
    namespace: str = "default"
    replica_type: str = "worker"
    replica_index: int = 0
    process_id: int = 0
    num_processes: int = 1
    coordinator_address: Optional[str] = None
    mesh_axes: dict[str, int] = field(default_factory=dict)
    status_dir: Optional[str] = None
    #: ``KFT_POD_DEVICE``; None means the CUDA card (``resolve_device``)
    device: Optional[str] = None

    @classmethod
    def from_env(cls, env: Optional[dict[str, str]] = None) -> "PodContext":
        e = dict(os.environ if env is None else env)
        mesh = {}
        if e.get(ENV_MESH):
            mesh = {k: int(v) for k, v in json.loads(e[ENV_MESH]).items()}
        return cls(
            job_name=e.get(ENV_JOB_NAME, "local"),
            namespace=e.get(ENV_JOB_NAMESPACE, "default"),
            replica_type=e.get(ENV_REPLICA_TYPE, "worker"),
            replica_index=int(e.get(ENV_REPLICA_INDEX, "0")),
            process_id=int(e.get(ENV_PROCESS_ID, "0")),
            num_processes=int(e.get(ENV_NUM_PROCESSES, "1")),
            coordinator_address=e.get(ENV_COORDINATOR_ADDRESS),
            mesh_axes=mesh,
            status_dir=e.get(ENV_STATUS_DIR),
            device=e.get(ENV_POD_DEVICE) or None,
        )

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def resolve_coordinator(address: str) -> str:
    """Map cluster DNS to something dialable: in-cluster the headless
    Service name resolves; under the local process runtime every
    ``<pod>.<ns>.svc`` host is this machine -> 127.0.0.1."""
    host, _, port = address.rpartition(":")
    if host.endswith(".svc") or host.endswith(".svc.cluster.local"):
        host = "127.0.0.1"
    return f"{host}:{port}"


def initialize(ctx: Optional[PodContext] = None) -> PodContext:
    """The context of this process's job. A one-process job needs no
    rendezvous; several processes raise until ROADMAP A5 brings
    ``torch.distributed.init_process_group`` and the gang barrier."""
    ctx = ctx or PodContext.from_env()
    _one_process(ctx)
    return ctx


def _one_process(ctx: PodContext) -> None:
    if ctx.num_processes > 1:
        raise NotImplementedError(
            f"a job of {ctx.num_processes} processes needs the "
            "torch.distributed rendezvous and barrier, which are not "
            "ported yet (ROADMAP A5)")


def pod_device(ctx: PodContext, device=None):
    """The ``torch.device`` a pod's work runs on: ``device`` when given,
    else the context's ``KFT_POD_DEVICE``, else the CUDA card (no card
    raises: there is no silent CPU path)."""
    from ..device import resolve_device

    return resolve_device(device if device is not None else ctx.device)


def barrier(ctx: PodContext) -> float:
    """The gang-startup probe of a one-process job: the pod's device is
    reached and synchronized (a pod that cannot reach its card fails here,
    before the user function), then the probe file is stamped."""
    import torch

    _one_process(ctx)
    dev = pod_device(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.time()
    if ctx.status_dir:
        os.makedirs(ctx.status_dir, exist_ok=True)
        with open(os.path.join(ctx.status_dir, BARRIER_FILE), "w") as f:
            f.write(repr(t))
    return t


def emit_metric(ctx: PodContext, name: str, value: float, **extra) -> None:
    """Append a metric line to the pod's status stream AND stdout: stdout
    is the Katib-style collector contract (``name=value``), the status
    dir's jsonl the structured channel the metrics collector scrapes."""
    print(f"{name}={value}", flush=True)
    if ctx.status_dir:
        os.makedirs(ctx.status_dir, exist_ok=True)
        with open(os.path.join(ctx.status_dir, METRICS_FILE), "a") as f:
            f.write(json.dumps({"name": name, "value": value,
                                "ts": time.time(), **extra}) + "\n")
