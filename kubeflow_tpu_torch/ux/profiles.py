"""Profile controller: namespace-per-user multi-tenancy with live usage.

[upstream: kubeflow/kubeflow -> components/profile-controller]: a Profile
creates the user's namespace, RBAC, and a ResourceQuota.  Here the Profile's
name *is* the tenant namespace; the controller keeps ``status.usage``
current (non-terminal pod consumption in that namespace) and the gang
scheduler enforces ``spec.resource_quota`` atomically at admission — a gang
that would exceed the profile's quota stays Pending whole, so quota pressure
can never strand a partial TPU slice (the upstream ResourceQuota admission
rejects pod-by-pod, which would).

The port's copy of ``kubeflow_tpu/ux/profiles.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

from typing import Optional

from ..api.platform import KIND_PROFILE, Profile
from ..controlplane.controller import Controller, Result
from ..controlplane.objects import KIND_POD, Pod, pod_resources
from ..controlplane.store import NotFound, Store
from ..api.common import TypedObject

#: profiles live in this namespace; their *name* is the tenant namespace
PROFILE_NS = "default"


def namespace_usage(store: Store, namespace: str) -> dict[str, float]:
    usage: dict[str, float] = {}
    for pod in store.list(KIND_POD, namespace):
        assert isinstance(pod, Pod)
        if pod.terminal or not pod.spec.node_name:
            continue
        for k, v in pod_resources(pod).items():
            usage[k] = usage.get(k, 0.0) + v
    return {k: round(v, 9) for k, v in usage.items() if v}


class ProfileController(Controller):
    kind = KIND_PROFILE
    owned_kinds = (KIND_POD,)

    def owner_key_for(self, obj: TypedObject) -> Optional[str]:
        # every pod event in a tenant namespace dirties that namespace's
        # profile (pods carry no owner-ref to profiles, upstream-style)
        if obj.kind == KIND_POD:
            return f"{PROFILE_NS}/{obj.metadata.namespace}"
        return None

    def reconcile(self, namespace: str, name: str) -> Optional[Result]:
        prof = self.store.try_get(KIND_PROFILE, name, namespace)
        if prof is None:
            return None
        assert isinstance(prof, Profile)
        usage = namespace_usage(self.store, name)
        qos_err = ""
        if prof.spec.qos is not None:
            # validate the tenant's QoS contract HERE (one Failed
            # status with the field named — the conf-freeze convention)
            # instead of letting every ISvc front door silently skip a
            # malformed class; lazy import keeps the control plane free
            # of the serving stack until a profile actually uses qos
            from ..serving.traffic import validate_qos

            try:
                validate_qos({name: prof.spec.qos})
            except (TypeError, ValueError) as e:
                # validate_qos promises ValueError, but a Failed status
                # beats a crash-looping reconcile if that ever slips
                qos_err = str(e)

        def mut(o):
            assert isinstance(o, Profile)
            o.status.usage = usage
            o.status.phase = "Failed" if qos_err else "Ready"
            o.status.message = qos_err

        try:
            self.store.update_with_retry(KIND_PROFILE, name, namespace, mut)
        except NotFound:
            pass
        return None
