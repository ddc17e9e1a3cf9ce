"""KServeClient — the serving plane's Python SDK.

Capability parity with the reference's kserve SDK [upstream: kserve/kserve
-> python/kserve KServeClient]: ``create``, ``get``, ``delete``,
``wait_isvc_ready``, and data-plane calls ``predict``/``explain`` against
the InferenceService's routed URL (V1 protocol).

The port's copy of ``kubeflow_tpu/sdk/kserve.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Any, Optional, Union

from ..api import from_dict, load_yaml
from ..api.inference import (
    InferenceService,
    InferenceServicePhase,
    KIND_INFERENCE_SERVICE,
)
from ..controlplane.cluster import Cluster


class IsvcTimeoutError(TimeoutError):
    pass


class KServeClient:
    def __init__(self, cluster: Cluster) -> None:
        self.cluster = cluster

    # -- CRUD -----------------------------------------------------------------

    def create(
        self, isvc: Union[InferenceService, dict, str]
    ) -> InferenceService:
        if isinstance(isvc, str):
            objs = load_yaml(isvc)
            if len(objs) != 1 or not isinstance(objs[0], InferenceService):
                raise ValueError("expected exactly one InferenceService document")
            isvc = objs[0]
        elif isinstance(isvc, dict):
            obj = from_dict(isvc)
            if not isinstance(obj, InferenceService):
                raise ValueError(f"manifest is a {obj.kind}, not an InferenceService")
            isvc = obj
        created = self.cluster.store.create(isvc)
        assert isinstance(created, InferenceService)
        return created

    def get(
        self, name: str, namespace: str = "default"
    ) -> Optional[InferenceService]:
        isvc = self.cluster.store.try_get(KIND_INFERENCE_SERVICE, name, namespace)
        assert isvc is None or isinstance(isvc, InferenceService)
        return isvc

    def delete(self, name: str, namespace: str = "default") -> None:
        self.cluster.store.try_delete(KIND_INFERENCE_SERVICE, name, namespace)

    # -- waiting --------------------------------------------------------------

    def wait_isvc_ready(
        self, name: str, namespace: str = "default",
        timeout: float = 120.0, poll: float = 0.1,
    ) -> InferenceService:
        deadline = time.time() + timeout
        isvc = None
        while time.time() < deadline:
            isvc = self.get(name, namespace)
            if isvc is not None:
                if isvc.status.phase == InferenceServicePhase.READY:
                    return isvc
                if isvc.status.phase == InferenceServicePhase.FAILED:
                    raise RuntimeError(
                        f"InferenceService {name} failed: {isvc.status.message}")
            time.sleep(poll)
        raise IsvcTimeoutError(
            f"InferenceService {name}: not Ready within {timeout}s "
            f"(last: {isvc.status if isvc else None})")

    # -- canary rollout (KServe canaryTrafficPercent verbs) -------------------

    def _update_spec(self, name: str, namespace: str, mut) -> InferenceService:
        from ..api.inference import KIND_INFERENCE_SERVICE as KIND

        def apply(o):
            assert isinstance(o, InferenceService)
            mut(o)

        out = self.cluster.store.update_with_retry(KIND, name, namespace, apply)
        assert isinstance(out, InferenceService)
        return out

    def rollout(
        self, name: str, spec_update: dict, traffic_percent: int,
        namespace: str = "default",
    ) -> InferenceService:
        """Deploy a spec change as a canary at ``traffic_percent``%; the
        current revision keeps serving the rest.  ``spec_update`` is a
        partial spec dict merged over the current one (e.g.
        ``{"predictor": {...}}`` replaces the predictor)."""
        from ..api.inference import InferenceServiceSpec

        def mut(o: InferenceService) -> None:
            merged = o.spec.model_dump(mode="json")
            merged.update(spec_update)
            merged["canary_traffic_percent"] = traffic_percent
            o.spec = InferenceServiceSpec.model_validate(merged)

        return self._update_spec(name, namespace, mut)

    def promote(self, name: str, namespace: str = "default") -> InferenceService:
        """Roll the canary revision out fully (it becomes the stable
        revision; the old one drains)."""
        def mut(o: InferenceService) -> None:
            o.spec.canary_traffic_percent = None

        return self._update_spec(name, namespace, mut)

    def rollback(self, name: str, namespace: str = "default") -> InferenceService:
        """Abandon the canary: restore the stable revision's spec (recorded
        in status.stable_spec by the controller)."""
        from ..api.inference import InferenceServiceSpec

        isvc = self.get(name, namespace)
        if isvc is None:
            raise RuntimeError(f"InferenceService {name} not found")
        if not isvc.status.stable_spec:
            raise RuntimeError(f"InferenceService {name} has no recorded stable spec")
        restored = InferenceServiceSpec.model_validate(isvc.status.stable_spec)

        def mut(o: InferenceService) -> None:
            o.spec = restored.model_copy(deep=True)
            o.spec.canary_traffic_percent = None

        return self._update_spec(name, namespace, mut)

    # -- data plane (V1 protocol) ---------------------------------------------

    def _post(self, url: str, payload: dict, timeout: float) -> dict:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())

    def _routed(self, name: str, namespace: str) -> str:
        isvc = self.get(name, namespace)
        if isvc is None or not isvc.status.url:
            raise RuntimeError(f"InferenceService {name} has no routed URL")
        return isvc.status.url

    def predict(
        self, name: str, instances: list[Any],
        namespace: str = "default", timeout: float = 60.0,
    ) -> list[Any]:
        url = self._routed(name, namespace)
        out = self._post(
            f"{url}/v1/models/{name}:predict", {"instances": instances}, timeout)
        return out["predictions"]

    def explain(
        self, name: str, instances: list[Any],
        namespace: str = "default", timeout: float = 120.0,
    ) -> list[Any]:
        url = self._routed(name, namespace)
        out = self._post(
            f"{url}/v1/models/{name}:explain", {"instances": instances}, timeout)
        return out["explanations"]
