"""In-process control plane: store, gang scheduler, reconcilers.

The port's copy of ``kubeflow_tpu/controlplane/__init__.py``, device-
free like it, with the same names; it imports nothing of the reference
package.
"""

from .cluster import Cluster
from .controller import Controller, Result, WorkQueue, events_for
from .expectations import Expectations
from .fake_kubelet import FakeKubelet, PodScript, ScriptPhase
from .jaxjob_controller import JaxJobController
from .objects import (
    GROUP_NAME_ANNOTATION,
    KIND_EVENT,
    KIND_NODE,
    KIND_POD,
    KIND_PODGROUP,
    KIND_SERVICE,
    LABEL_JOB_NAME,
    LABEL_REPLICA_INDEX,
    LABEL_REPLICA_TYPE,
    Event,
    Node,
    Pod,
    PodGroup,
    PodGroupPhase,
    PodPhase,
    Service,
)
from .scheduler import GangScheduler
from .store import (
    ADDED,
    DELETED,
    MODIFIED,
    AlreadyExists,
    ApiError,
    Conflict,
    NotFound,
    Rejected,
    Store,
    WatchEvent,
)

__all__ = [k for k in dir() if not k.startswith("_")]
