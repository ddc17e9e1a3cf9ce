"""InferenceGraph: DAG routing over InferenceServices.

The kserve InferenceGraph capability [upstream: kserve ->
pkg/apis/serving/v1alpha1 InferenceGraph, cmd/router]: a graph CRD whose
router executes the full node set — Sequence (chain steps, each seeing the
previous response or the original request), Switch (first matching
condition wins), Ensemble (steps fan out in parallel, outputs merged under
step names), Splitter (weighted traffic split) — over live
InferenceServices.  The router resolves target URLs from the store at
request time, so ISvc redeploys/scaling never require a graph update.

The port's copy of ``kubeflow_tpu/serving/graph.py``, device-free like
it, with the same names; it imports nothing of the reference package.
Its HTTP server listens with ``BurstHTTPServer``'s backlog.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from concurrent import futures
from http.server import BaseHTTPRequestHandler
from typing import Callable, Optional

from ..api.inference import (
    KIND_INFERENCE_GRAPH,
    KIND_INFERENCE_SERVICE,
    GraphNode,
    InferenceGraph,
    InferenceService,
    InferenceServicePhase,
)
from ..controlplane.controller import Controller, Result
from ..controlplane.store import NotFound, Store
from ..utils.net import BurstHTTPServer, allocate_port


class GraphExecutionError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def eval_condition(condition: str, payload: dict) -> bool:
    """``key == value`` / ``!=`` / ``>`` / ``<`` against the request JSON.

    Values compare as numbers when both sides parse as float, else as
    strings (quotes optional).  Missing keys never match.
    """
    for op in ("==", "!=", ">", "<"):
        if op in condition:
            key, _, raw = condition.partition(op)
            key, raw = key.strip(), raw.strip().strip("'\"")
            if key not in payload:
                return False
            actual = payload[key]
            try:
                a, b = float(actual), float(raw)
            except (TypeError, ValueError):
                a, b = str(actual), raw
            if op == "==":
                return a == b
            if op == "!=":
                return a != b
            if op == ">":
                return a > b
            return a < b
    raise GraphExecutionError(400, f"unparseable condition {condition!r}")


class GraphExecutor:
    """Executes one graph over live ISvc URLs (pure logic, no HTTP server)."""

    def __init__(
        self,
        graph: InferenceGraph,
        url_for: Callable[[str], Optional[str]],
        timeout: float = 60.0,
    ):
        self.graph = graph
        self.url_for = url_for
        self.timeout = timeout
        # shared pool for Ensemble fan-out: the executor is long-lived (one
        # per GraphRouter), so per-request pool churn is avoidable overhead
        self._pool = futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="graph-ensemble")

    def execute(self, payload: dict) -> dict:
        return self._run_node("root", payload, payload)

    def _node(self, name: str) -> GraphNode:
        node = self.graph.spec.nodes.get(name)
        if node is None:
            raise GraphExecutionError(500, f"graph node {name!r} not found")
        return node

    def _run_node(self, name: str, payload: dict, original: dict) -> dict:
        node = self._node(name)
        if node.router_type == "Switch":
            for step in node.steps:
                if step.condition is None or eval_condition(step.condition, payload):
                    return self._run_step(step, payload, original)
            raise GraphExecutionError(404, "no switch condition matched")
        if node.router_type == "Ensemble":
            # all steps see the same input concurrently; response maps step
            # name -> output [upstream: kserve router Ensemble semantics]
            keys = [
                step.name or step.service_name or step.node_name or str(i)
                for i, step in enumerate(node.steps)
            ]
            if len(set(keys)) != len(keys):
                raise GraphExecutionError(
                    500, "ensemble steps need distinct names (set step.name)")
            pending = {
                key: self._pool.submit(self._run_step, step, payload, original)
                for key, step in zip(keys, node.steps)
            }
            return {k: f.result() for k, f in pending.items()}
        if node.router_type == "Splitter":
            weights = [1 if s.weight is None else s.weight for s in node.steps]
            if any(w < 0 for w in weights):
                raise GraphExecutionError(500, "splitter weights must be >= 0")
            total = sum(weights)
            if total <= 0 or not node.steps:
                raise GraphExecutionError(500, "splitter has no weighted steps")
            # strict < so an explicit weight=0 step can never win (kserve
            # semantics: zero weight = drained, no traffic)
            pick = random.random() * total
            acc = 0.0
            for step, w in zip(node.steps, weights):
                acc += w
                if pick < acc:
                    return self._run_step(step, payload, original)
            return self._run_step(
                max(zip(node.steps, weights), key=lambda sw: sw[1])[0],
                payload, original)
        if node.router_type != "Sequence":
            raise GraphExecutionError(
                500, f"unknown router_type {node.router_type!r}")
        out = payload
        for step in node.steps:
            data = original if step.data == "$request" else out
            out = self._run_step(step, data, original)
        return out

    def _run_step(self, step, payload: dict, original: dict) -> dict:
        if step.node_name:
            return self._run_node(step.node_name, payload, original)
        if not step.service_name:
            raise GraphExecutionError(500, "step has neither service nor node")
        url = self.url_for(step.service_name)
        if url is None:
            raise GraphExecutionError(
                503, f"InferenceService {step.service_name!r} not ready")
        # V1 chaining: a previous step's {"predictions": ...} feeds the next
        # step as {"instances": ...}
        if "instances" not in payload and "predictions" in payload:
            payload = {**{k: v for k, v in payload.items() if k != "predictions"},
                       "instances": payload["predictions"]}
        req = urllib.request.Request(
            f"{url}/v1/models/{step.service_name}:predict",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise GraphExecutionError(e.code, e.read().decode()[:500])
        except OSError as e:
            raise GraphExecutionError(502, str(e))


class GraphRouter:
    """HTTP front door for one InferenceGraph."""

    def __init__(self, executor: GraphExecutor, port: Optional[int] = None):
        self.executor = executor
        self.port = port or allocate_port()
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    payload = json.loads(self.rfile.read(length)) if length else {}
                    out = router.executor.execute(payload)
                    body, code = json.dumps(out).encode(), 200
                except GraphExecutionError as e:
                    body, code = json.dumps({"error": str(e)}).encode(), e.code
                except (ValueError, TypeError) as e:
                    body, code = json.dumps({"error": str(e)}).encode(), 400
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                body = json.dumps({"graph": router.executor.graph.metadata.name,
                                   "nodes": list(router.executor.graph.spec.nodes)})
                raw = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        self._httpd = BurstHTTPServer(("127.0.0.1", self.port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"graph-router-{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)
        self.executor._pool.shutdown(wait=False, cancel_futures=True)


class InferenceGraphController(Controller):
    """Reconciles InferenceGraph -> running GraphRouter + status."""

    kind = KIND_INFERENCE_GRAPH

    def __init__(self, store: Store) -> None:
        super().__init__(store)
        self._routers: dict[str, GraphRouter] = {}

    def stop(self) -> None:
        super().stop()
        for r in self._routers.values():
            r.stop()
        self._routers.clear()

    def _url_for(self, namespace: str) -> Callable[[str], Optional[str]]:
        def lookup(service_name: str) -> Optional[str]:
            isvc = self.store.try_get(
                KIND_INFERENCE_SERVICE, service_name, namespace)
            if (
                isinstance(isvc, InferenceService)
                and isvc.status.phase == InferenceServicePhase.READY
            ):
                return isvc.status.url
            return None

        return lookup

    def reconcile(self, namespace: str, name: str) -> Optional[Result]:
        key = f"{namespace}/{name}"
        graph = self.store.try_get(KIND_INFERENCE_GRAPH, name, namespace)
        if graph is None:
            router = self._routers.pop(key, None)
            if router:
                router.stop()
            return None
        assert isinstance(graph, InferenceGraph)

        if "root" not in graph.spec.nodes:
            self._set_status(
                graph, InferenceServicePhase.FAILED, message="no 'root' node")
            return None

        router = self._routers.get(key)
        if router is None:
            executor = GraphExecutor(graph, self._url_for(namespace))
            router = GraphRouter(executor)
            self._routers[key] = router
            self.emit_event(graph, "RouterStarted", router.url)
        else:
            router.executor.graph = graph  # pick up spec edits in place

        # Ready once every referenced service is Ready (services referenced
        # from nested nodes included)
        missing = []
        for node in graph.spec.nodes.values():
            for step in node.steps:
                if step.service_name and self._url_for(namespace)(step.service_name) is None:
                    missing.append(step.service_name)
        if missing:
            self._set_status(
                graph, InferenceServicePhase.LOADING,
                url=router.url, message=f"waiting for {sorted(set(missing))}")
            return Result(requeue_after=0.1)
        self._set_status(graph, InferenceServicePhase.READY, url=router.url)
        return None

    def _set_status(self, graph, phase, url=None, message="") -> None:
        def mut(o):
            assert isinstance(o, InferenceGraph)
            o.status.phase = phase
            o.status.url = url
            o.status.message = message

        try:
            self.store.update_with_retry(
                KIND_INFERENCE_GRAPH, graph.metadata.name,
                graph.metadata.namespace, mut)
        except NotFound:
            pass
