"""Transformer component: user pre/post-processing in front of a predictor.

[upstream: kserve/kserve -> python/kserve transformer examples]: a
Transformer is a Model whose predict step is an HTTP call to the predictor
service, with user preprocess/postprocess around it — the same composition
here, over the in-cluster replica URLs the controller injects.

The port's copy of ``kubeflow_tpu/serving/transformer.py``, device-free
like it, with the same names; it imports nothing of the reference
package.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Optional

from .model import Model


class Transformer(Model):
    """Base transformer: override preprocess/postprocess; predict proxies."""

    def __init__(self, name: str, config: Optional[dict[str, Any]] = None):
        super().__init__(name, config)
        self.predictor_urls: list[str] = list(self.config.get("predictor_urls", []))
        self.model_name = self.config.get("model_name", name)
        self._rr = 0

    def load(self) -> None:
        if not self.predictor_urls:
            raise RuntimeError(f"transformer {self.name}: no predictor_urls")
        self.ready = True

    def predict_batch(self, instances):
        self._rr = (self._rr + 1) % len(self.predictor_urls)
        url = f"{self.predictor_urls[self._rr]}/v1/models/{self.model_name}:predict"
        body = json.dumps({"instances": instances}).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())["predictions"]
