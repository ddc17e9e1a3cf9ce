"""Python SDK — the three reference clients rebuilt over this platform:
TrainingClient (kubeflow-training), KatibClient (kubeflow-katib),
KServeClient (kserve).

The port's copy of ``kubeflow_tpu/sdk/__init__.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from .client import JobTimeoutError, TrainingClient
from .katib import (
    ExperimentTimeoutError,
    KatibClient,
    search_categorical,
    search_double,
    search_int,
)
from .kserve import IsvcTimeoutError, KServeClient

__all__ = [
    "ExperimentTimeoutError",
    "IsvcTimeoutError",
    "JobTimeoutError",
    "KServeClient",
    "KatibClient",
    "TrainingClient",
    "search_categorical",
    "search_double",
    "search_int",
]
