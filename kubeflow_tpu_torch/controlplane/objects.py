"""Core (non-CRD) cluster objects: Node, Pod, Service, PodGroup, Event.

These are the Kubernetes primitives the reference's reconcilers emit
[upstream: kubeflow/training-operator -> pkg/controller.v1/common/{pod,service}.go;
volcano-sh/volcano -> PodGroup CRD].  The in-process cluster (SURVEY.md §4's
envtest analog) stores them in the same typed store as the CRDs; the gang
scheduler binds Pods to Nodes; the process runtime plays kubelet.

The port's copy of ``kubeflow_tpu/controlplane/objects.py``, device-free
like it, with the same names; it imports nothing of the reference
package. Its accelerators are NVIDIA cards: a node's capacity counts
``gpu`` and lists the card ids it exposes (``NodeSpec.device_ids``), its
nodes are grouped by NVLink domain where the reference groups them by TPU
slice, and a bound pod records the ids of the cards it was given
(``PodSpec.device_ids``, the device plugin's ``Allocate``).
"""

from __future__ import annotations

import enum
import time
from typing import Optional

from pydantic import Field, model_validator

from ..api.common import Container, TypedObject, _Model

KIND_POD = "Pod"
KIND_SERVICE = "Service"
KIND_PODGROUP = "PodGroup"
KIND_NODE = "Node"
KIND_EVENT = "Event"

#: Pod annotation naming its gang [reference analog: the
#: ``scheduling.k8s.io/group-name`` annotation Volcano keys on].
GROUP_NAME_ANNOTATION = "scheduling.kubeflow-tpu.dev/group-name"
#: Label keys the controllers stamp on pods for selector queries
#: [reference analog: training.kubeflow.org/job-name etc.].
LABEL_JOB_NAME = "job-name"
LABEL_REPLICA_TYPE = "replica-type"
LABEL_REPLICA_INDEX = "replica-index"


class PodPhase(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


class PodSpec(_Model):
    container: Container = Field(default_factory=Container)
    node_name: Optional[str] = None  # set by the scheduler (binding)
    #: the node's card ids this pod owns, set with ``node_name`` at bind
    #: time (one per ``nvidia.com/gpu`` asked for; freed when the pod
    #: ends or is deleted)
    device_ids: list[int] = Field(default_factory=list)
    scheduler_name: str = "gang"  # "gang" | "default"
    restart_policy: str = "Never"


class PodStatus(_Model):
    phase: PodPhase = PodPhase.PENDING
    exit_code: Optional[int] = None
    message: str = ""
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    # Wall-clock when the in-pod runtime reported passing its first
    # collective barrier — source for the gang-startup metric.
    barrier_time: Optional[float] = None
    # Wall-clock of the pod's last self-reported activity heartbeat
    # (status-dir ``activity`` file) — the notebook culler's signal.
    last_activity: Optional[float] = None
    pid: Optional[int] = None


class Pod(TypedObject):
    kind: str = KIND_POD
    spec: PodSpec = Field(default_factory=PodSpec)
    status: PodStatus = Field(default_factory=PodStatus)

    @property
    def terminal(self) -> bool:
        return self.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED)


class ServiceSpec(_Model):
    """Headless service: stable DNS for one pod [upstream:
    training-operator -> pkg/controller.v1/common/service.go]."""

    selector: dict[str, str] = Field(default_factory=dict)
    ports: list[int] = Field(default_factory=list)
    cluster_ip: Optional[str] = None  # None == headless


class Service(TypedObject):
    kind: str = KIND_SERVICE
    spec: ServiceSpec = Field(default_factory=ServiceSpec)


class PodGroupPhase(str, enum.Enum):
    PENDING = "Pending"
    INQUEUE = "Inqueue"
    RUNNING = "Running"  # admitted: all min_member pods bound
    UNSCHEDULABLE = "Unschedulable"


class PodGroupSpec(_Model):
    min_member: int = 1
    queue: str = "default"
    priority_class: Optional[str] = None
    # aggregate resources the gang needs (for all-or-nothing fit checks)
    min_resources: dict[str, float] = Field(default_factory=dict)


class PodGroupStatus(_Model):
    phase: PodGroupPhase = PodGroupPhase.PENDING
    admitted_time: Optional[float] = None
    message: str = ""


class PodGroup(TypedObject):
    kind: str = KIND_PODGROUP
    spec: PodGroupSpec = Field(default_factory=PodGroupSpec)
    status: PodGroupStatus = Field(default_factory=PodGroupStatus)


class NodeSpec(_Model):
    capacity: dict[str, float] = Field(default_factory=dict)  # cpu/memory_gb/gpu
    labels: dict[str, str] = Field(default_factory=dict)
    # NVLink wiring: the cards of nodes in one domain talk over NVLink,
    # those of different domains over the network.  The gang scheduler
    # packs a gang into one domain before it spills.
    nvlink_domain: str = "domain-0"
    #: the card ids the node exposes, one per ``gpu`` of its capacity
    #: (empty = ``range(gpu)``).  An id may repeat: time-slicing
    #: advertises one card as several ``nvidia.com/gpu``.
    device_ids: list[int] = Field(default_factory=list)

    @model_validator(mode="after")
    def _one_id_a_card(self) -> "NodeSpec":
        gpus = int(self.capacity.get("gpu", 0))
        if self.device_ids and len(self.device_ids) != gpus:
            raise ValueError(
                f"node lists {len(self.device_ids)} device_ids for a "
                f"capacity of {gpus} gpu")
        return self


class Node(TypedObject):
    kind: str = KIND_NODE
    spec: NodeSpec = Field(default_factory=NodeSpec)


class Event(TypedObject):
    kind: str = KIND_EVENT
    involved_kind: str = ""
    involved_name: str = ""
    reason: str = ""
    message: str = ""
    type: str = "Normal"  # Normal | Warning
    timestamp: float = Field(default_factory=time.time)


def pod_resources(pod: Pod) -> dict[str, float]:
    r = pod.spec.container.resources
    return {"cpu": r.cpu, "memory_gb": r.memory_gb, "gpu": float(r.gpu)}


def node_device_ids(node: Node) -> list[int]:
    """The card ids ``node`` exposes: ``device_ids``, else one id a card
    of its ``gpu`` capacity."""
    if node.spec.device_ids:
        return list(node.spec.device_ids)
    return list(range(int(node.spec.capacity.get("gpu", 0))))


# Make the cluster-substrate kinds YAML/REST-addressable (the api layer's
# KIND_REGISTRY must not import upward, so registration happens here).
from ..api.yaml_io import KIND_REGISTRY as _KIND_REGISTRY  # noqa: E402

_KIND_REGISTRY.update({
    KIND_POD: Pod,
    KIND_SERVICE: Service,
    KIND_PODGROUP: PodGroup,
    KIND_NODE: Node,
    KIND_EVENT: Event,
})
