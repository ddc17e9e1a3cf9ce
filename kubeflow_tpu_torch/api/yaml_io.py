"""YAML (de)serialization for API objects — the ``kubectl apply -f`` surface.

The reference's CRD YAMLs are camelCase with ``apiVersion``/``kind``/
``metadata``/``spec``; this module accepts both camelCase and snake_case keys
(converted at load time) so manifests read like the reference's while the
python API stays pythonic.  Kind dispatch mirrors scheme registration in the
operator manager [upstream: kubeflow/training-operator ->
cmd/training-operator.v1/main.go].

The port's copy of ``kubeflow_tpu/api/yaml_io.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import re
from typing import Any, Type

import yaml

from .common import TypedObject
from .experiment import Experiment, Suggestion, Trial
from .inference import InferenceGraph, InferenceService, ServingRuntime
from .jaxjob import JaxJob
from .platform import Notebook, PodDefault, Profile

#: kind -> class; cluster-substrate kinds (Pod/Node/Service/PodGroup/Event)
#: self-register from controlplane.objects at import time — the api layer
#: must not import upward into controlplane.
KIND_REGISTRY: dict[str, Type[TypedObject]] = {
    "JaxJob": JaxJob,
    "Experiment": Experiment,
    "Trial": Trial,
    "Suggestion": Suggestion,
    "InferenceService": InferenceService,
    "ServingRuntime": ServingRuntime,
    "InferenceGraph": InferenceGraph,
    "Profile": Profile,
    "Notebook": Notebook,
    "PodDefault": PodDefault,
}

_CAMEL_RE = re.compile(r"(?<!^)(?=[A-Z])")
#: Only lowerCamelCase identifiers are schema keys worth converting; keys
#: with underscores or leading caps (env var names, label keys) pass through.
_SCHEMA_KEY_RE = re.compile(r"^[a-z][a-zA-Z0-9]*$")
#: Fields whose dict values are user data, not schema — never recursed into
#: (env var names, labels, mesh axes, algorithm settings, raw manifests…).
_DATA_MAP_FIELDS = frozenset(
    {
        "env",
        "labels",
        "annotations",
        "mesh",
        "settings",
        "config",
        "capacity",
        "trial_parameters",
        "job_manifest",
        "metrics",
    }
)


def _snake(key: str) -> str:
    if not _SCHEMA_KEY_RE.match(key):
        return key
    return _CAMEL_RE.sub("_", key).lower()


def _snake_keys(obj: Any) -> Any:
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            nk = _snake(k) if isinstance(k, str) else k
            out[nk] = v if nk in _DATA_MAP_FIELDS else _snake_keys(v)
        return out
    if isinstance(obj, list):
        return [_snake_keys(v) for v in obj]
    return obj


def from_dict(manifest: dict[str, Any]) -> TypedObject:
    """Build a typed object from a (possibly camelCase) manifest dict."""
    kind = manifest.get("kind")
    if not kind:
        raise ValueError("manifest has no 'kind'")
    cls = KIND_REGISTRY.get(str(kind))
    if cls is None:
        raise ValueError(f"unknown kind {kind!r}; known: {sorted(KIND_REGISTRY)}")
    body = _snake_keys({k: v for k, v in manifest.items() if k not in ("apiVersion",)})
    body.pop("api_version", None)
    return cls.model_validate(body)


def to_dict(obj: TypedObject) -> dict[str, Any]:
    d = obj.model_dump(mode="json", exclude_none=True, by_alias=True)
    d["apiVersion"] = obj.api_version
    d.pop("api_version", None)
    return d


def load_yaml(text: str) -> list[TypedObject]:
    """Load one or more objects from a (multi-document) YAML string."""
    out: list[TypedObject] = []
    for doc in yaml.safe_load_all(text):
        if doc is None:
            continue
        out.append(from_dict(doc))
    return out


def load_yaml_file(path: str) -> list[TypedObject]:
    with open(path) as f:
        return load_yaml(f.read())


def dump_yaml(objs: list[TypedObject] | TypedObject) -> str:
    if isinstance(objs, TypedObject):
        objs = [objs]
    return yaml.safe_dump_all([to_dict(o) for o in objs], sort_keys=False)
