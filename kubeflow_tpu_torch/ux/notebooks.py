"""Notebook controller: per-user workbench pods with stable URLs + culling.

[upstream: kubeflow/kubeflow -> components/notebook-controller]: a Notebook
CRD reconciles to a StatefulSet (one pod) + Service, exposes a stable URL
behind the dashboard, and an idle culler stops notebooks by stamping the
``kubeflow-resource-stopped`` annotation.  Same shape here: Notebook ->
one pod (``<name>-notebook-0``) on the ordinary kubelet contract + headless
Service; ``spec.idle_cull_seconds`` of inactivity stamps the
``kft-stopped`` annotation and deletes the pod (state lives outside the
pod, like upstream's PVC); removing the annotation resumes it.

The port's copy of ``kubeflow_tpu/ux/notebooks.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import time
from typing import Optional

from ..api.common import ObjectMeta, OwnerReference, replica_service_dns
from ..api.platform import (
    KIND_NOTEBOOK,
    Notebook,
    STOPPED_ANNOTATION,
)
from ..controlplane.controller import Controller, Result
from ..controlplane.objects import (
    KIND_POD,
    KIND_SERVICE,
    Pod,
    PodPhase,
    PodSpec,
    Service,
    ServiceSpec,
)
from ..controlplane.store import AlreadyExists, NotFound, Store


def notebook_pod_name(name: str) -> str:
    return f"{name}-notebook-0"


class NotebookController(Controller):
    kind = KIND_NOTEBOOK
    owned_kinds = (KIND_POD, KIND_SERVICE)

    def reconcile(self, namespace: str, name: str) -> Optional[Result]:
        nb = self.store.try_get(KIND_NOTEBOOK, name, namespace)
        pod_name = notebook_pod_name(name)
        if nb is None:
            self.store.try_delete(KIND_POD, pod_name, namespace)
            self.store.try_delete(KIND_SERVICE, pod_name, namespace)
            return None
        assert isinstance(nb, Notebook)

        stopped = STOPPED_ANNOTATION in nb.metadata.annotations
        pod = self.store.try_get(KIND_POD, pod_name, namespace)

        if stopped:
            if pod is not None:
                self.store.try_delete(KIND_POD, pod_name, namespace)
                self.emit_event(nb, "NotebookStopped",
                                nb.metadata.annotations.get(STOPPED_ANNOTATION, ""))
            self._set_status(nb, phase="Stopped", url=None)
            return None

        if pod is None:
            pod = Pod(
                metadata=ObjectMeta(
                    name=pod_name,
                    namespace=namespace,
                    labels={"kft-notebook": name},
                    owner_references=[OwnerReference(
                        kind=KIND_NOTEBOOK, name=name, uid=nb.metadata.uid)],
                ),
                spec=PodSpec(
                    container=nb.spec.template.model_copy(deep=True),
                    scheduler_name="default",  # notebooks are not gangs
                ),
            )
            try:
                self.store.create(pod)
                self.emit_event(nb, "PodCreated", pod_name)
            except AlreadyExists:
                pass
            self._ensure_service(nb, pod_name, namespace)
            self._set_status(nb, phase="Pending")
            return Result(requeue_after=0.05)

        assert isinstance(pod, Pod)
        url = f"http://{replica_service_dns(name, 'notebook', 0, namespace)}"
        if pod.status.phase == PodPhase.RUNNING:
            # activity = the pod's own heartbeat (notebook_server stamps it
            # per request, surfaced by the kubelet), falling back to start
            last = (pod.status.last_activity
                    or pod.status.start_time or time.time())
            cull = nb.spec.idle_cull_seconds
            if cull > 0 and time.time() - last > cull:
                # the culler half of the controller: stamp + stop
                def stamp(o):
                    assert isinstance(o, Notebook)
                    o.metadata.annotations[STOPPED_ANNOTATION] = "idle-culled"

                try:
                    self.store.update_with_retry(
                        KIND_NOTEBOOK, name, namespace, stamp)
                except NotFound:
                    return None
                return Result(requeue_after=0.0)
            self._set_status(nb, phase="Running", url=url, last_activity=last)
            return Result(requeue_after=0.25 if cull > 0 else None)
        if pod.status.phase == PodPhase.FAILED:
            self._set_status(nb, phase="Failed",
                             message=pod.status.message or "notebook pod failed")
            return None
        self._set_status(nb, phase="Pending")
        return Result(requeue_after=0.1)

    def _ensure_service(self, nb: Notebook, pod_name: str, namespace: str) -> None:
        try:
            self.store.create(Service(
                metadata=ObjectMeta(
                    name=pod_name, namespace=namespace,
                    owner_references=[OwnerReference(
                        kind=KIND_NOTEBOOK, name=nb.metadata.name,
                        uid=nb.metadata.uid)],
                ),
                spec=ServiceSpec(selector={"kft-notebook": nb.metadata.name}),
            ))
        except AlreadyExists:
            pass

    def _set_status(self, nb: Notebook, phase: str, url=None,
                    last_activity=None, message: str = "") -> None:
        def mut(o):
            assert isinstance(o, Notebook)
            o.status.phase = phase
            o.status.url = url
            if last_activity is not None:
                o.status.last_activity = last_activity
            o.status.message = message

        try:
            self.store.update_with_retry(
                KIND_NOTEBOOK, nb.metadata.name, nb.metadata.namespace, mut)
        except NotFound:
            pass
