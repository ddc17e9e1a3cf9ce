"""Serving: the continuous-batching engine (``continuous.py``) over the
paged KV block economy (``paged.py``), and the serving plane in front of
it: ``ModelServer`` (``server.py``: V1/V2/OpenAI HTTP, ``/metrics``,
``/traces``), ``TextGenerator`` (``text.py``), request tracing
(``trace.py``), the QoS door and preemptor (``traffic.py``) and the
session reaper (``autoscale.py``); the port of ``kubeflow_tpu/serving``.

The serving plane's names below are imported on first use, so importing
this package (or ``serving.server``) loads no model and touches no card.
"""

import importlib

_EXPORTS = {
    "Model": "model",
    "MicroBatcher": "server",
    "ModelServer": "server",
    "ByteTokenizer": "text",
    "TextGenerator": "text",
    "Tracer": "trace",
    "EnginePreemptor": "traffic",
    "QosClass": "traffic",
    "TrafficPlane": "traffic",
    "validate_qos": "traffic",
    "SessionReaper": "autoscale",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
