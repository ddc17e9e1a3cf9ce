"""Explainer component: model explanations next to a predictor.

[upstream: kserve/kserve -> python/kserve explainer examples +
pkg/apis/serving/v1beta1/explainer.go]: KServe's explainer is a third
serving component that answers ``:explain`` by calling the *predictor* for
model outputs and computing attributions around it (Alibi anchors, ART
gradients).  Same topology here: an Explainer is a Model that proxies
``:predict`` to the predictor replicas and implements ``explain_batch`` by
perturbing inputs and scoring them through batched predictor calls — so the
predictor's micro-batcher still sees real batches and the XLA callable runs
full tiles even during explanation.

Built-in method: occlusion saliency (model-agnostic, black-box): mask one
feature segment at a time to a baseline and report the score drop.  It needs
nothing from the predictor but the V1 protocol, which is exactly the
coupling KServe's black-box explainers have.

The port's copy of ``kubeflow_tpu/serving/explainer.py``, device-free
like it, with the same names; it imports nothing of the reference
package.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Optional

from .model import Instances, Model


class Explainer(Model):
    """Base explainer: black-box access to the predictor over V1 HTTP."""

    def __init__(self, name: str, config: Optional[dict[str, Any]] = None):
        super().__init__(name, config)
        self.predictor_urls: list[str] = list(self.config.get("predictor_urls", []))
        self.model_name = self.config.get("model_name", name)
        self._rr = 0

    def load(self) -> None:
        if not self.predictor_urls:
            raise RuntimeError(f"explainer {self.name}: no predictor_urls")
        self.ready = True

    def _predict_remote(self, instances: Instances) -> Instances:
        if not self.predictor_urls:
            # predictors scaled to zero; the router's activator path owns
            # wake-up, so surface a retryable error instead of crashing
            raise RuntimeError(
                f"explainer {self.name}: no live predictor replicas")
        self._rr = (self._rr + 1) % len(self.predictor_urls)
        url = f"{self.predictor_urls[self._rr]}/v1/models/{self.model_name}:predict"
        body = json.dumps({"instances": instances}).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())["predictions"]

    # ``:predict`` through the explainer behaves like a pass-through so one
    # routed URL serves both verbs (KServe routes the verbs to different
    # components; our router does the same via explain backends)
    def predict_batch(self, instances: Instances) -> Instances:
        return self._predict_remote(instances)

    def explain_batch(self, instances: Instances) -> Instances:
        raise NotImplementedError


def _score(pred: Any, class_index: Optional[int]) -> tuple[float, Optional[int]]:
    """Scalar score of one prediction; returns (score, class used)."""
    if isinstance(pred, (int, float)):
        return float(pred), None
    probs = list(pred)
    idx = class_index if class_index is not None else max(
        range(len(probs)), key=lambda i: probs[i])
    return float(probs[idx]), idx


class OcclusionExplainer(Explainer):
    """Occlusion saliency: attribution[i] = score(x) - score(x with segment i
    masked to ``baseline``).  Config:

    - ``num_segments``: feature groups to occlude (default 16, clamped to
      the feature count) — one predictor call of num_segments+1 instances
      per explained instance;
    - ``baseline``: mask value (default 0.0);
    - ``class_index``: fixed output class to score; default = the model's
      top class for the unmasked input.
    """

    def explain_batch(self, instances: Instances) -> Instances:
        out = []
        for inst in instances:
            x = [float(v) for v in inst]
            n_seg = min(int(self.config.get("num_segments", 16)), len(x)) or 1
            baseline = float(self.config.get("baseline", 0.0))
            class_index = self.config.get("class_index")
            bounds = [
                (len(x) * s // n_seg, len(x) * (s + 1) // n_seg)
                for s in range(n_seg)
            ]
            batch: list[list[float]] = [x]
            for lo, hi in bounds:
                masked = list(x)
                masked[lo:hi] = [baseline] * (hi - lo)
                batch.append(masked)
            preds = self._predict_remote(batch)
            base_score, cls = _score(preds[0], class_index)
            attributions = [
                base_score - _score(p, cls if class_index is None else class_index)[0]
                for p in preds[1:]
            ]
            out.append({
                "prediction": preds[0],
                "class_index": cls,
                "base_score": base_score,
                "segments": bounds,
                "attributions": attributions,
            })
        return out
