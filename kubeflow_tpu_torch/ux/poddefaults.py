"""PodDefault injection: the admission-webhook tier of the platform shell.

[upstream: kubeflow/kubeflow -> components/admission-webhook]: PodDefault
objects in a namespace declare env/annotation injections for pods matching
a label selector; a mutating webhook applies them at pod admission.  Here
the same hook is a store mutator registered for the Pod kind — it runs on
every pod CREATE, exactly where the upstream webhook sits.

The port's copy of ``kubeflow_tpu/ux/poddefaults.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

from ..api.platform import KIND_PODDEFAULT, PodDefault
from ..controlplane.objects import Pod
from ..controlplane.store import Store


def _matches(selector: dict[str, str], labels: dict[str, str]) -> bool:
    return bool(selector) and all(labels.get(k) == v for k, v in selector.items())


def pod_default_mutator(store: Store):
    """Returns the mutating hook; bound to the store it reads defaults from."""

    def mutate(pod: Pod) -> Pod:
        for pd in store.list(KIND_PODDEFAULT, pod.metadata.namespace):
            if not isinstance(pd, PodDefault):
                continue
            if not _matches(pd.spec.selector, pod.metadata.labels):
                continue
            # pod's own values win over injected defaults (upstream merges
            # without overwriting existing keys)
            for k, v in pd.spec.env.items():
                pod.spec.container.env.setdefault(k, v)
            for k, v in pd.spec.annotations.items():
                pod.metadata.annotations.setdefault(k, v)
        return pod

    return mutate
