"""Central dashboard: one URL aggregating every plane's status.

[upstream: kubeflow/kubeflow -> components/centraldashboard (TS web app)]:
the landing surface listing jobs, experiments, inference services,
notebooks, and profiles across the platform.  Here a single HTTP server
over the store: JSON APIs per kind (what the upstream web apps fetch from
their backends) plus a minimal server-rendered HTML index — enough for a
human to see the whole cluster at a glance, with zero JS build tooling.

The port's copy of ``kubeflow_tpu/ux/dashboard.py``, device-free like
it, with the same names; it imports nothing of the reference package.
It listens with ``BurstHTTPServer``, as every HTTP server of the port
does.
"""

from __future__ import annotations

import html
import json
import threading
from http.server import BaseHTTPRequestHandler
from typing import Optional

from ..api.experiment import KIND_EXPERIMENT
from ..api.inference import KIND_INFERENCE_GRAPH, KIND_INFERENCE_SERVICE
from ..api.jaxjob import KIND_JAXJOB
from ..api.platform import KIND_NOTEBOOK, KIND_PROFILE
from ..controlplane.objects import KIND_EVENT, KIND_NODE, KIND_POD
from ..controlplane.store import Store
from ..utils.net import BurstHTTPServer, allocate_port

#: API path segment -> store kind
_SECTIONS = {
    "jaxjobs": KIND_JAXJOB,
    "experiments": KIND_EXPERIMENT,
    "inferenceservices": KIND_INFERENCE_SERVICE,
    "inferencegraphs": KIND_INFERENCE_GRAPH,
    "notebooks": KIND_NOTEBOOK,
    "profiles": KIND_PROFILE,
    "nodes": KIND_NODE,
    "pods": KIND_POD,
    "events": KIND_EVENT,
}


def _summarize(obj) -> dict:
    out = {
        "name": obj.metadata.name,
        "namespace": obj.metadata.namespace,
        "kind": obj.kind,
    }
    status = getattr(obj, "status", None)
    if status is not None:
        out["status"] = status.model_dump(mode="json")
    for attr in ("reason", "message", "type", "involved_kind", "involved_name"):
        v = getattr(obj, attr, None)
        if isinstance(v, str) and v:
            out[attr] = v
    return out


def _phase_of(summary: dict) -> str:
    st = summary.get("status", {})
    if "phase" in st and st["phase"]:
        return str(st["phase"])
    conds = st.get("conditions") or []
    return str(conds[-1]["type"]) if conds else ""


class Dashboard:
    """Serve ``/`` (HTML index), ``/api/overview``, ``/api/<section>``,
    per-object detail ``/api/<section>/<ns>/<name>`` (+ its events, + pod
    logs via ``log_path_for``), and experiment metric curves
    ``/api/experiments/<ns>/<name>/curves`` (the Katib UI's main job,
    read from the observation DB)."""

    def __init__(self, store: Store, port: Optional[int] = None,
                 db=None, log_path_for=None):
        self.store = store
        self.db = db  # hpo.db.DbManagerClient (experiment curves)
        self.log_path_for = log_path_for  # (namespace, pod) -> log path
        self.port = port or allocate_port()
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if self.path == "/":
                        self._send(200, dash.index_html().encode(), "text/html")
                    elif self.path == "/api/overview":
                        self._send(200, json.dumps(dash.overview()).encode(),
                                   "application/json")
                    elif self.path.startswith("/api/"):
                        parts = self.path[len("/api/"):].strip("/").split("/")
                        if parts[0] not in _SECTIONS:
                            self._send(404, b'{"error": "unknown section"}',
                                       "application/json")
                            return
                        if len(parts) == 1:
                            payload = dash.section(parts[0])
                        elif len(parts) == 3:
                            payload = dash.detail(parts[0], parts[1], parts[2])
                        elif (len(parts) == 4 and parts[0] == "experiments"
                              and parts[3] == "curves"):
                            payload = dash.curves(parts[1], parts[2])
                        elif (len(parts) == 4 and parts[0] == "pods"
                              and parts[3] == "logs"):
                            self._send(
                                200, dash.pod_logs(parts[1], parts[2]).encode(),
                                "text/plain")
                            return
                        else:
                            self._send(404, b'{"error": "unknown path"}',
                                       "application/json")
                            return
                        if payload is None:
                            self._send(404, b'{"error": "not found"}',
                                       "application/json")
                            return
                        self._send(200, json.dumps(payload).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:  # noqa: BLE001 — surfaced as 500
                    self._send(500, json.dumps({"error": str(e)}).encode(),
                               "application/json")

        self._httpd = BurstHTTPServer(("127.0.0.1", self.port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dashboard", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)

    # -- data -------------------------------------------------------------

    def section(self, name: str) -> list[dict]:
        return [_summarize(o) for o in self.store.list(_SECTIONS[name])]

    def detail(self, section: str, namespace: str, name: str) -> Optional[dict]:
        """Full object dump + its events (the kubectl-describe surface the
        upstream web apps render per object)."""
        from ..controlplane.controller import events_for

        obj = self.store.try_get(_SECTIONS[section], name, namespace)
        if obj is None:
            return None
        events = [
            {"reason": e.reason, "message": e.message, "type": e.type,
             "timestamp": e.timestamp}
            for e in events_for(self.store, _SECTIONS[section], name)
            if e.metadata.namespace == namespace
        ]
        out = {"object": obj.model_dump(mode="json"), "events": events}
        if section == "experiments" and self.db is not None:
            out["curves"] = self.curves(namespace, name)
        return out

    def curves(self, namespace: str, name: str) -> Optional[dict]:
        """Per-trial objective curves, step-ordered for plotting (the
        Katib UI experiment-curves view); needs the observation DB.
        Returns None (HTTP 404) when no DB is attached — the payload
        schema is trial-name -> points, so an inline error object would
        masquerade as a trial."""
        if self.db is None:
            return None
        rows = self.db.get_observation_log(name, namespace=namespace)
        curves: dict[str, list] = {}
        for r in rows:
            curves.setdefault(r.get("trial", "?"), []).append({
                k: r[k] for k in ("step", "value", "phase", "assignments")
                if k in r
            })
        return curves

    def pod_logs(self, namespace: str, name: str) -> str:
        """Captured stdout/stderr of a pod (the kubectl-logs surface)."""
        if self.log_path_for is None:
            return "(no log source attached)"
        try:
            with open(self.log_path_for(namespace, name)) as f:
                return f.read()
        except OSError as e:
            return f"(no logs: {e})"

    def overview(self) -> dict:
        return {name: len(self.store.list(kind))
                for name, kind in _SECTIONS.items()}

    def index_html(self) -> str:
        parts = ["<html><head><title>kubeflow-tpu</title></head><body>",
                 "<h1>kubeflow-tpu dashboard</h1>"]
        for name in _SECTIONS:
            if name in ("events", "pods"):
                continue  # noisy sections stay API-only, like upstream
            rows = self.section(name)
            parts.append(f"<h2>{name} ({len(rows)})</h2><ul>")
            for r in rows:
                label = html.escape(f"{r['namespace']}/{r['name']}")
                phase = html.escape(_phase_of(r))
                parts.append(f"<li>{label} — {phase}</li>")
            parts.append("</ul>")
        parts.append("</body></html>")
        return "".join(parts)
