"""Fault injection for the control plane and the serving gang.

``FaultPlan`` is the one entry point: build a seeded plan, then hand it
to ``FakeKubelet(..., chaos=plan)`` (pod crashes, kubelet stalls, node
drains), to ``GangChannel`` via ``plan.socket_wrapper(role)``
(control-stream drops/delays), and/or to a durable ``Cluster`` via
``Cluster(data_dir=..., wal_crashpoint=plan.wal_crashpoint())`` (kill -9
the control plane at a seeded WAL offset).  See chaos/plan.py for the
fault model and tests/test_chaos.py for the recovery paths it exercises.

The port's copy of ``kubeflow_tpu/chaos/__init__.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from .net import ChaosSocket
from .plan import PREEMPTION_EXIT_CODE, Fault, FaultKind, FaultPlan

__all__ = [
    "ChaosSocket",
    "Fault",
    "FaultKind",
    "FaultPlan",
    "PREEMPTION_EXIT_CODE",
]
