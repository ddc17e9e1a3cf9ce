"""Platform-UX tier (SURVEY.md §2.4): profiles, notebooks, pod defaults,
central dashboard — the kubeflow/kubeflow shell rebuilt on this cluster.

The port's copy of ``kubeflow_tpu/ux/__init__.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from .dashboard import Dashboard
from .notebooks import NotebookController
from .poddefaults import pod_default_mutator
from .profiles import ProfileController

__all__ = [
    "Dashboard",
    "NotebookController",
    "ProfileController",
    "pod_default_mutator",
]
