"""Model lifecycle: the kserve.Model analog.

[upstream: kserve/kserve -> python/kserve/kserve/model.py]: a model has
``load() -> ready``, ``preprocess -> predict -> postprocess``, and is hosted
by a ModelServer speaking the V1/V2 inference protocols.  TPU-first
divergence: ``predict`` receives a *batch* (the server micro-batches
concurrent requests before dispatch — XLA-compiled callables want large
batches, and per-request dispatch would waste the MXU).

The port's copy of ``kubeflow_tpu/serving/model.py``, device-free like
it, with the same names; it imports nothing of the reference package.
``metadata`` reports the platform as ``kubeflow-tpu-torch``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

Instances = list[Any]


class Model:
    """Base model. Subclass and override load() and predict_batch()."""

    def __init__(self, name: str, config: Optional[dict[str, Any]] = None):
        self.name = name
        self.config = dict(config or {})
        self.ready = False
        self.load_time_s: Optional[float] = None

    # -- lifecycle --------------------------------------------------------

    def load(self) -> None:
        """Load weights / compile; must set self.ready = True."""
        self.ready = True

    def start(self) -> None:
        t0 = time.perf_counter()
        self.load()
        self.load_time_s = time.perf_counter() - t0
        if not self.ready:
            raise RuntimeError(f"model {self.name}: load() did not set ready")

    def stop(self) -> None:
        self.ready = False

    # -- inference --------------------------------------------------------

    def preprocess(self, instances: Instances) -> Instances:
        return instances

    def predict_batch(self, instances: Instances) -> Instances:
        raise NotImplementedError

    def postprocess(self, predictions: Instances) -> Instances:
        return predictions

    def explain_batch(self, instances: Instances) -> Instances:
        """Per-instance explanations (the ``:explain`` verb); only
        explainer components implement this."""
        raise NotImplementedError(f"model {self.name} does not explain")

    def __call__(self, instances: Instances) -> Instances:
        return self.postprocess(self.predict_batch(self.preprocess(instances)))

    # -- metadata (V2 model metadata endpoint) ----------------------------

    def metadata(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "platform": "kubeflow-tpu-torch",
            "ready": self.ready,
            "load_time_s": self.load_time_s,
        }
