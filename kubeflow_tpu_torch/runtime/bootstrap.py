"""In-pod runtime bootstrap: env contract -> torch.distributed -> barrier.

The port of ``kubeflow_tpu/runtime/bootstrap.py``: ``PodContext`` parsed
from the environment variables the JaxJob controller injects (plus
``KFT_POD_DEVICE``, the device the pod computes on: the CUDA card when
unset, and ``KFT_DIST_BACKEND``), the coordinator address mapping, the
metric stream (stdout ``name=value`` and the status dir's
``metrics.jsonl``) and:

- ``initialize``: a job of several processes joins
  ``torch.distributed.init_process_group`` at the coordinator address (the
  ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``
  triple is PyTorchJob's ``MASTER_ADDR:MASTER_PORT``/``WORLD_SIZE``/
  ``RANK``; process 0 hosts the store). The backend is ``nccl`` when the
  pod computes on a CUDA card and ``gloo`` on the CPU; ``KFT_DIST_BACKEND``
  overrides it (two processes sharing one card need ``gloo``: NCCL refuses
  two ranks of one communicator on one device). A backend that fails to
  start raises: nothing switches to another by itself.
- ``barrier``: the gang-startup probe. A process in a group runs one
  collective over every process on the pod's device; a process alone
  synchronizes its device. Then ``BARRIER_FILE`` is stamped.

A pod's cards are the ones the scheduler gave it: the kubelet names their
ids in ``KFT_POD_CARDS`` (as bound, a time-sliced card repeated) and
makes only those visible (``CUDA_VISIBLE_DEVICES``, ``visible_cards``),
so the CUDA card a pod computes on when ``KFT_POD_DEVICE`` is unset is
its first own card. A pod of k cards in the job's process group runs k
local ranks (``runtime/pod_main``), each marked by ``KFT_LOCAL_RANK`` and
computing on its own card (``local_rank_env``); a local rank stamps its
status files under its own name (``status_file``), and only local rank
0's metrics reach the pod's ``METRICS_FILE``.
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
#: the torch.distributed backend ("nccl", "gloo"); unset = by the device
ENV_DIST_BACKEND = "KFT_DIST_BACKEND"
#: the card ids the scheduler gave the pod, comma-separated, as bound
ENV_POD_CARDS = "KFT_POD_CARDS"
#: a pod's local rank, set on each of the k processes of a k-card pod
ENV_LOCAL_RANK = "KFT_LOCAL_RANK"
#: seconds a rendezvous or collective may wait for the other processes
DIST_TIMEOUT_S = 300

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
    #: ``KFT_DIST_BACKEND``; None means nccl on a card, gloo on the CPU
    dist_backend: Optional[str] = None
    #: ``KFT_POD_CARDS``: the pod's card ids, as the scheduler bound them
    cards: list[int] = field(default_factory=list)
    #: ``KFT_LOCAL_RANK``: this process's rank inside a k-card pod
    local_rank: Optional[int] = None

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
            dist_backend=e.get(ENV_DIST_BACKEND) or None,
            cards=[int(c) for c in e.get(ENV_POD_CARDS, "").split(",") if c],
            local_rank=(int(e[ENV_LOCAL_RANK]) if e.get(ENV_LOCAL_RANK)
                        else None),
        )

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def visible_cards(cards: list[int]) -> list[int]:
    """The ``CUDA_VISIBLE_DEVICES`` of a pod bound to ``cards``: each card
    once, in bound order (a time-sliced card is one device)."""
    return list(dict.fromkeys(cards))


def local_rank_env(ctx: PodContext, local: int,
                   env: Optional[dict[str, str]] = None) -> dict[str, str]:
    """The env of local rank ``local`` of a pod of ``k = len(ctx.cards)``
    cards: global process ``pod index * k + local`` of ``pods * k``, on
    its own card (``cuda:<i>``, ``i`` its card's place among the pod's
    visible cards) unless the pod names a device (``KFT_POD_DEVICE``)."""
    k = len(ctx.cards)
    out = dict(os.environ if env is None else env)
    out[ENV_PROCESS_ID] = str(ctx.process_id * k + local)
    out[ENV_NUM_PROCESSES] = str(ctx.num_processes * k)
    out[ENV_LOCAL_RANK] = str(local)
    if not ctx.device:
        i = visible_cards(ctx.cards).index(ctx.cards[local])
        out[ENV_POD_DEVICE] = f"cuda:{i}"
    return out


def status_file(ctx: PodContext, name: str) -> Optional[str]:
    """Where this process stamps status file ``name``: the pod's status
    dir, the name suffixed ``.local-<j>`` on local rank ``j`` (the pod's
    own file is written once every local rank has its own); None without
    a status dir."""
    if not ctx.status_dir:
        return None
    if ctx.local_rank is not None:
        name = f"{name}.local-{ctx.local_rank}"
    return os.path.join(ctx.status_dir, name)


def resolve_coordinator(address: str) -> str:
    """Map cluster DNS to something dialable: in-cluster the headless
    Service name resolves; under the local process runtime every
    ``<pod>.<ns>.svc`` host is this machine -> 127.0.0.1."""
    host, _, port = address.rpartition(":")
    if host.endswith(".svc") or host.endswith(".svc.cluster.local"):
        host = "127.0.0.1"
    return f"{host}:{port}"


def dist_backend(ctx: PodContext) -> str:
    """The process group's backend: ``KFT_DIST_BACKEND``, else ``nccl``
    for a pod on a CUDA card and ``gloo`` for one on the CPU."""
    if ctx.dist_backend:
        return ctx.dist_backend
    return "nccl" if pod_device(ctx).type == "cuda" else "gloo"


def initialize(ctx: Optional[PodContext] = None) -> PodContext:
    """Join the job's process group: ``torch.distributed.
    init_process_group`` over TCP at the coordinator, rank = process id.
    A one-process job needs no rendezvous, unless its pod names a backend
    (``KFT_DIST_BACKEND``): then it forms a group of one, as a job with one
    card per process does. A CUDA pod binds its device first, so NCCL's
    communicator lands on it."""
    ctx = ctx or PodContext.from_env()
    if ctx.num_processes > 1 or ctx.dist_backend:
        import datetime

        import torch
        import torch.distributed as dist

        if not ctx.coordinator_address:
            raise RuntimeError("multi-process job missing coordinator address")
        if not dist.is_initialized():
            dev = pod_device(ctx)
            if dev.type == "cuda" and dev.index is not None:
                torch.cuda.set_device(dev.index)
            dist.init_process_group(
                backend=dist_backend(ctx),
                init_method=f"tcp://{resolve_coordinator(ctx.coordinator_address)}",
                world_size=ctx.num_processes,
                rank=ctx.process_id,
                timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    return ctx


def pod_device(ctx: PodContext, device=None):
    """The ``torch.device`` a pod's work runs on: ``device`` when given,
    else the context's ``KFT_POD_DEVICE``, else the CUDA card, which is
    the pod's first own card (only its cards are visible; no card raises:
    there is no silent CPU path)."""
    from ..device import resolve_device

    return resolve_device(device if device is not None else ctx.device)


def barrier(ctx: PodContext) -> float:
    """The gang-startup probe: in a process group, one all-reduce over
    every process on the pod's device (the gang's collectives work, not
    just its store); alone, the pod's device is reached and
    synchronized. A pod that cannot reach its card fails here, before the
    user function. Then the probe file is stamped."""
    import torch

    import torch.distributed as dist

    dev = pod_device(ctx)
    if dist.is_initialized():
        one = torch.ones((), device=dev)
        dist.all_reduce(one)
        if int(one.item()) != ctx.num_processes:
            raise RuntimeError(
                f"gang barrier: {int(one.item())} of {ctx.num_processes} "
                "processes answered")
    elif dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.time()
    path = status_file(ctx, BARRIER_FILE)
    if path:
        os.makedirs(ctx.status_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(repr(t))
    return t


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def emit_metric(ctx: PodContext, name: str, value: float, **extra) -> None:
    """Append a metric line to the pod's status stream AND stdout: stdout
    is the Katib-style collector contract (``name=value``), the status
    dir's jsonl the structured channel the metrics collector scrapes (a
    k-card pod's stream is its local rank 0's)."""
    print(f"{name}={value}", flush=True)
    if ctx.status_dir and not ctx.local_rank:
        os.makedirs(ctx.status_dir, exist_ok=True)
        with open(os.path.join(ctx.status_dir, METRICS_FILE), "a") as f:
            f.write(json.dumps({"name": name, "value": value,
                                "ts": time.time(), **extra}) + "\n")
