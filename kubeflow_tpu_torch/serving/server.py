"""ModelServer: V1/V2 inference protocols over HTTP with micro-batching.

[upstream: kserve/kserve -> python/kserve/kserve/model_server.py +
protocol/{v1,v2} handlers].  Endpoints:

V1:  POST /v1/models/<name>:predict   {"instances": [...]} -> {"predictions": [...]}
     GET  /v1/models/<name>           readiness per model
V2:  POST /v2/models/<name>/infer     {"inputs": [{name,shape,datatype,data}]}
     GET  /v2/models/<name>           model metadata
     GET  /v2/health/live | /v2/health/ready
Also GET /metrics (request count/latency, Prometheus text format).

TPU-first: a micro-batcher sits between HTTP threads and the model —
concurrent single-instance requests coalesce (up to ``batch_max_size`` or
``batch_timeout_ms``) into one ``predict_batch`` call so the XLA callable
sees real batches.  The reference gets this from Triton's dynamic batcher on
GPU; here it is native.

The port's copy of ``kubeflow_tpu/serving/server.py``, device-free like
it, with the same names; it imports nothing of the reference package.
Its HTTP server listens with ``BurstHTTPServer``'s backlog
(``utils/net.py``), and a process may add POST control routes of its own
(``add_control_route``: a serving gang's rank 0 takes the autoscaler's
TP-degree decisions at ``/v2/gang/resize``, ``serving/gang.py``).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Optional

from ..utils.net import BurstHTTPServer, allocate_port
from .model import Model

log = logging.getLogger("kubeflow_tpu_torch.serving")


@dataclass
class _Pending:
    instances: list
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[list] = None
    error: Optional[Exception] = None


class MicroBatcher:
    """Coalesce concurrent requests into batched predict calls."""

    def __init__(self, model: Model, max_size: int = 8, timeout_ms: float = 2.0):
        self.model = model
        self.max_size = max(1, max_size)
        self.timeout_s = max(timeout_ms, 0.0) / 1e3
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._gate = threading.Lock()  # serializes enqueue vs. shutdown
        self._thread = threading.Thread(
            target=self._loop, name=f"batcher-{model.name}", daemon=True)
        self._thread.start()

    def submit(self, instances: list) -> list:
        p = _Pending(instances)
        # check-and-enqueue under the gate: stop() flips _stop under the
        # same lock, so no submit can slip into the queue after the drain
        with self._gate:
            if self._stop.is_set():
                raise RuntimeError(f"model {self.model.name} is shutting down")
            self._q.put(p)
        p.done.wait()
        if p.error is not None:
            raise p.error
        assert p.result is not None
        return p.result

    def stop(self) -> None:
        with self._gate:
            self._stop.set()
        self._thread.join(timeout=2)
        # fail any requests that raced the shutdown — their HTTP threads
        # are blocked in submit() and would otherwise hang forever
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            p.error = RuntimeError(f"model {self.model.name} shut down")
            p.done.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            n = len(first.instances)
            deadline = time.perf_counter() + self.timeout_s
            while n < self.max_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(nxt)
                n += len(nxt.instances)
            flat: list = []
            for p in batch:
                flat.extend(p.instances)
            try:
                out = self.model(flat)
                if len(out) != len(flat):
                    raise RuntimeError(
                        f"model returned {len(out)} predictions for {len(flat)} instances")
                i = 0
                for p in batch:
                    p.result = out[i : i + len(p.instances)]
                    i += len(p.instances)
            except Exception as e:  # noqa: BLE001 — propagate per request
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.done.set()


#: request-latency histogram bucket upper bounds (seconds), fixed by
#: contract: dynamic buckets cannot be aggregated across replicas by a
#: scrape, and p99 regressions are invisible to a count+sum exposition
#: (the gap this histogram closes — ISSUE 13 satellite)
REQUEST_LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                           1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class ServerMetrics:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.request_count: dict[str, int] = {}
        self.error_count: dict[str, int] = {}
        self.latency_sum: dict[str, float] = {}
        #: model -> per-bucket counts (len(buckets) + 1, last = +Inf)
        self.latency_buckets: dict[str, list[int]] = {}
        self.inflight = 0

    def observe(self, model: str, seconds: float, error: bool) -> None:
        with self.lock:
            self.request_count[model] = self.request_count.get(model, 0) + 1
            self.latency_sum[model] = self.latency_sum.get(model, 0.0) + seconds
            counts = self.latency_buckets.get(model)
            if counts is None:
                counts = self.latency_buckets[model] = \
                    [0] * (len(REQUEST_LATENCY_BUCKETS) + 1)
            for i, b in enumerate(REQUEST_LATENCY_BUCKETS):
                if seconds <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            if error:
                self.error_count[model] = self.error_count.get(model, 0) + 1

    def prometheus(self) -> str:
        from .traffic import prom_histogram_lines, prom_label

        lines = [
            "# TYPE kft_request_count counter",
            "# TYPE kft_error_count counter",
            "# TYPE kft_requests_inflight gauge",
        ]
        with self.lock:
            for m, c in self.request_count.items():
                lines.append(
                    f'kft_request_count{{model="{prom_label(m)}"}} {c}')
            for m, c in self.error_count.items():
                lines.append(
                    f'kft_error_count{{model="{prom_label(m)}"}} {c}')
            lines.append(f"kft_requests_inflight {self.inflight}")
            # request latency as a REAL fixed-bucket histogram
            # (_bucket/_sum/_count): the previous count+sum exposition
            # could only answer "mean", so a p99 regression was
            # invisible to every scrape.  One shared renderer with the
            # trace layer's phase histograms (traffic.py).
            if self.latency_buckets:
                lines.append("# TYPE kft_request_latency_seconds "
                             "histogram")
                for m in sorted(self.latency_buckets):
                    lines.extend(prom_histogram_lines(
                        "kft_request_latency_seconds",
                        f'model="{prom_label(m)}"',
                        REQUEST_LATENCY_BUCKETS,
                        self.latency_buckets[m],
                        self.latency_sum.get(m, 0.0)))
        return "\n".join(lines) + "\n"


class InferenceLogger:
    """Async request/response payload logging to a sink URL [upstream:
    kserve -> pkg/agent/logger — the ISvc ``logger`` field POSTs
    CloudEvents-framed copies of every inference to a collector].
    Fire-and-forget off a bounded queue: a slow or dead sink drops log
    events (counted) instead of backpressuring the predict path."""

    def __init__(self, url: str, mode: str = "all",
                 service: str = "") -> None:
        if mode not in ("all", "request", "response"):
            raise ValueError(f"logger mode {mode!r}: all|request|response")
        self.url = url
        self.mode = mode
        self.service = service
        self.dropped = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=256)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._pump, name="inference-logger", daemon=True)
        self._thread.start()

    def log(self, kind: str, model: str, req_id: str, payload) -> None:
        if self.mode != "all" and self.mode != kind:
            return
        try:
            self._q.put_nowait((kind, model, req_id, payload))
        except queue.Full:
            self.dropped += 1

    def _pump(self) -> None:
        import urllib.request as _rq

        while not self._stop.is_set():
            try:
                kind, model, req_id, payload = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                # one unserializable payload costs ONE event, never the
                # logger thread (json.dumps can raise on exotic outputs)
                body = json.dumps(payload, default=str).encode()
                req = _rq.Request(self.url, data=body, headers={
                    "Content-Type": "application/json",
                    # CloudEvents binary-mode framing (the kserve contract)
                    "ce-specversion": "1.0",
                    "ce-type": f"org.kubeflow.serving.inference.{kind}",
                    "ce-source": self.service or model,
                    "ce-id": req_id,
                    "ce-modelid": model,
                })
                with _rq.urlopen(req, timeout=2.0):
                    pass
            except Exception as e:  # noqa: BLE001 — delivery is best-effort
                log.debug("inference log delivery to %s failed: %s",
                          self.url, e)
                self.dropped += 1

    def stop(self, drain_timeout: float = 2.0) -> None:
        """Graceful shutdown: give the pump up to ``drain_timeout``
        seconds to deliver what is already enqueued BEFORE raising the
        stop flag — stopping immediately silently discarded everything
        still queued.  Whatever still could not be flushed is counted in
        ``dropped``, never silently lost."""
        deadline = time.monotonic() + max(0.0, drain_timeout)
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
        self._stop.set()
        self._thread.join(timeout=2)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
            self.dropped += 1


class ModelServer:
    """Hosts models behind the V1/V2 HTTP protocols (one per replica)."""

    def __init__(self, port: Optional[int] = None):
        self.port = port or allocate_port()
        self._models: dict[str, Model] = {}
        self._batchers: dict[str, MicroBatcher] = {}
        #: name -> (class, config, batch_max, batch_timeout): rebuild specs
        #: for the V2 repository API's unload/load cycle
        self._specs: dict[str, tuple] = {}
        #: serializes repository mutations — load/unload arrive on
        #: concurrent HTTP threads; racing registers would leak batcher
        #: threads and model instances
        self._repo_lock = threading.Lock()
        self.metrics = ServerMetrics()
        #: optional request/response payload logger (set_logger)
        self.logger: Optional[InferenceLogger] = None
        self._httpd: Optional[BurstHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._grpc = None
        #: POST path -> handler(payload, headers) -> (status, body): the
        #: process's own control routes (a gang's resize actuator)
        self._control: dict[str, Callable[[dict, Any], tuple[int, Any]]] = {}

    def add_control_route(
            self, path: str,
            handler: Callable[[dict, Any], tuple[int, Any]]) -> None:
        """Serve POST ``path`` with ``handler(payload, headers)``, which
        returns the response's status and JSON body. The handler
        authenticates its caller itself."""
        self._control[path] = handler

    def enable_grpc(self, port: Optional[int] = None) -> str:
        """Serve the V2 protocol over gRPC too (kserve's grpc_port analog);
        both wire formats share this repository + micro-batcher.  Returns
        the gRPC address."""
        from .grpc_server import GrpcInferenceServer

        if self._grpc is None:
            self._grpc = GrpcInferenceServer(self, port=port).start()
        elif port and self._grpc.port != port:
            raise RuntimeError(
                f"gRPC already serving on port {self._grpc.port}; "
                f"cannot rebind to {port}")
        return self._grpc.address

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- model repository (dynamic load/unload) ---------------------------

    def register(
        self, model: Model, *, batch_max_size: int = 8, batch_timeout_ms: float = 2.0
    ) -> None:
        if not model.ready:  # idempotent: a live model re-registers as-is
            model.start()
        old_batcher = self._batchers.pop(model.name, None)
        if old_batcher is not None:
            # re-registration must not leak the previous batcher's thread
            old_batcher.stop()
        self._models[model.name] = model
        # remember how to rebuild it: the V2 repository API's unload/load
        # cycle re-instantiates from this spec
        self._specs[model.name] = (
            type(model), dict(model.config), batch_max_size, batch_timeout_ms)
        # self-batching models (continuous.py) coalesce requests inside
        # their own decode loop; routing them through the micro-batcher
        # would serialize requests and defeat token-boundary admission
        if not getattr(model, "self_batching", False):
            self._batchers[model.name] = MicroBatcher(
                model, batch_max_size, batch_timeout_ms)

    def unregister(self, name: str) -> None:
        b = self._batchers.pop(name, None)
        if b:
            b.stop()
        m = self._models.pop(name, None)
        if m:
            m.stop()
        self._specs.pop(name, None)

    # -- V2 repository API (dynamic load/unload) --------------------------

    def unload_model(self, name: str) -> bool:
        """Unload but KEEP the spec so a later load can rebuild (the V2
        repository contract: unloaded models stay indexed, not-ready).
        Idempotent: unloading an already-unloaded (but known) model
        succeeds — retry-safe automation depends on it."""
        with self._repo_lock:
            if name not in self._models:
                return name in self._specs  # known-but-unloaded: no-op ok
            spec = self._specs.get(name)
            self.unregister(name)
            if spec is not None:
                self._specs[name] = spec
            return True

    def load_model(self, name: str) -> bool:
        with self._repo_lock:
            if name in self._models:
                return True  # already live
            spec = self._specs.get(name)
            if spec is None:
                return False
            cls, cfg, bmax, btimeout = spec
            self.register(cls(name, cfg), batch_max_size=bmax,
                          batch_timeout_ms=btimeout)
            return True

    def repository_index(self) -> list[dict]:
        out = []
        for name, spec in self._specs.items():
            live = self._models.get(name)
            out.append({
                "name": name,
                "state": "READY" if live is not None and live.ready else "UNAVAILABLE",
                "reason": "" if live is not None else "unloaded",
            })
        return out

    def engines(self) -> dict[str, Any]:
        """Engine-backed models' engines by model name — the surface
        replica drain (ISSUE 8) walks to migrate live paged
        conversations onto a peer replica before this server stops."""
        out: dict[str, Any] = {}
        for name, model in list(self._models.items()):
            engine = getattr(model, "engine", None)
            if engine is not None:
                out[name] = engine
        return out

    def models(self) -> dict[str, Model]:
        return dict(self._models)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ModelServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                log.debug("http: " + fmt, *args)

            def _send(self, code: int, payload: Any, raw: Optional[bytes] = None,
                      content_type: str = "application/json") -> None:
                body = raw if raw is not None else json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                server._handle_get(self)

            def do_POST(self) -> None:
                server._handle_post(self)

        self._httpd = BurstHTTPServer(("127.0.0.1", self.port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"model-server-{self.port}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._grpc is not None:
            self._grpc.stop()
            self._grpc = None
        if self.logger is not None:
            self.logger.stop()
            self.logger = None
        for name in list(self._models):
            self.unregister(name)
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)

    # -- request handling -------------------------------------------------

    def _handle_get(self, h) -> None:
        path = h.path
        if path in ("/v2/health/live", "/healthz"):
            h._send(200, {"live": True})
            return
        if path == "/v2/health/ready":
            ready = all(m.ready for m in self._models.values())
            h._send(200 if ready else 503, {"ready": ready})
            return
        if path == "/traces" or path.startswith("/traces?"):
            # recent completed request traces as JSONL (ISSUE 13):
            # ?slowest=N returns the N slowest retained traces — N
            # TOTAL across models, merged through the shared helper
            # (the router handler uses the same one, so the query
            # contract cannot drift between the two surfaces)
            from .trace import parse_slowest, traces_body

            ok, slowest = parse_slowest(path)
            if not ok:
                h._send(400, {"error": "slowest must be an int"})
                return
            sinks = []
            for _name, model in sorted(self._models.items()):
                tracer = getattr(model, "tracer", None)
                if tracer is not None:
                    tracer.reap()  # finalize adopted (wire) traces
                    sinks.append(tracer.sink)
            h._send(200, None, raw=traces_body(sinks, slowest).encode(),
                    content_type="application/x-ndjson")
            return
        if path == "/metrics":
            # exemplar trace ids are OpenMetrics syntax: attach them
            # ONLY when the scraper negotiated the format (Accept
            # header) — the classic text/plain parser reads the
            # trailer as a malformed timestamp and fails the page
            openmetrics = "application/openmetrics-text" in str(
                h.headers.get("Accept") or "")
            text = self.metrics.prometheus()
            # engine-backed models export their scheduler gauges too
            # (slots, queue depth, prefix-cache economy); one TYPE line
            # per metric family, gauge names without the _total suffix
            # (OpenMetrics reserves it for counters)
            families: dict[str, list[str]] = {}
            for name, model in list(self._models.items()):
                engine = getattr(model, "engine", None)
                stats = getattr(engine, "stats", None)
                if callable(stats):
                    for k, v in stats().items():
                        if isinstance(v, (int, float)):
                            families.setdefault(f"kft_engine_{k}", []).append(
                                f'kft_engine_{k}{{model="{name}"}} {v}')
                # block-registry digest (ISSUE 12): the replica's hot
                # prefixes as chained content keys — the cluster
                # KvBlockRegistry probes these rows (rank-0 for gangs)
                # to route a cold replica's kv_fetch at a peer that
                # already holds the KV
                census = getattr(engine, "prefix_census", None)
                if callable(census) and getattr(engine, "paged", False):
                    from .paged import prefix_digest
                    from .traffic import prom_label

                    try:
                        digest = prefix_digest(census(),
                                               engine.block_size)
                    except Exception as e:  # noqa: BLE001 — a wedged
                        # scheduler must degrade the scrape, not 500 it
                        log.debug("prefix census failed: %s", e)
                        digest = {}
                    for key, depth in sorted(digest.items()):
                        families.setdefault(
                            "kft_kv_prefix_key", []).append(
                            f'kft_kv_prefix_key{{model='
                            f'"{prom_label(name)}",key="{key}"}} '
                            f'{depth}')
                # traffic-plane gauges (QoS admission/shed/preemption
                # accounting — serving/traffic.py) ride the same
                # export; per-class counters carry the class as a
                # LABEL (class names are tenant strings — splicing
                # them into the metric name breaks the exposition)
                plane = getattr(model, "traffic", None)
                if plane is not None:
                    from .traffic import prom_label, prom_stat_lines

                    for fam, lines in prom_stat_lines(
                            plane.stats(), "kft_traffic_",
                            f'model="{prom_label(name)}"').items():
                        families.setdefault(fam, []).extend(lines)
                # AOT program-artifact cache (ISSUE 17): its own
                # kft_aot_* family from the cache itself, dropping the
                # aot_cache_ stat prefix — hit/miss economics + store
                # bytes for the compile-wall dashboards (the engine
                # loop above also exports them as kft_engine_aot_*;
                # these are the canonical names the runbooks use)
                pcache = getattr(engine, "program_cache", None)
                if pcache is not None:
                    from .traffic import prom_label, prom_stat_lines

                    aot_stats = {
                        k[len("aot_cache_"):]: v
                        for k, v in pcache.stats().items()}
                    for fam, lines in prom_stat_lines(
                            aot_stats, "kft_aot_cache_",
                            f'model="{prom_label(name)}"').items():
                        families.setdefault(fam, []).extend(lines)
                # trace-layer gauges ride the same export (sampling
                # accounting); the phase histograms append below as a
                # pre-rendered block — they carry their own TYPE line
                tracer = getattr(model, "tracer", None)
                if tracer is not None:
                    from .traffic import prom_label, prom_stat_lines

                    for fam, lines in prom_stat_lines(
                            tracer.stats(), "kft_trace_",
                            f'model="{prom_label(name)}"').items():
                        families.setdefault(fam, []).extend(lines)
            for fam in sorted(families):
                text += f"# TYPE {fam} gauge\n" + \
                    "\n".join(families[fam]) + "\n"
            # phase-attributed latency histograms
            # (kft_phase_seconds{phase=...} with exemplar trace ids):
            # the scrape-side view of the trace layer — p99s per phase,
            # not just totals (ISSUE 13).  ONE TYPE header across all
            # models: duplicate TYPE lines are an exposition error the
            # promtool-style lint test pins.
            phase_lines: list[str] = []
            for name, model in sorted(self._models.items()):
                tracer = getattr(model, "tracer", None)
                if tracer is not None:
                    from .traffic import prom_label

                    lines = tracer.sink.phase_metrics(
                        base_labels=f'model="{prom_label(name)}"',
                        exemplars=openmetrics)
                    if lines:
                        phase_lines.extend(
                            lines if not phase_lines else lines[1:])
            if phase_lines:
                text += "\n".join(phase_lines) + "\n"
            if openmetrics:
                text += "# EOF\n"
            h._send(200, None, raw=text.encode(),
                    content_type=(
                        "application/openmetrics-text; version=1.0.0; "
                        "charset=utf-8" if openmetrics
                        else "text/plain; version=0.0.4"))
            return
        if path.startswith("/v1/models/"):
            name = path[len("/v1/models/"):]
            m = self._models.get(name)
            if m is None:
                h._send(404, {"error": f"model {name} not found"})
                return
            h._send(200, {"name": name, "ready": m.ready})
            return
        if path.startswith("/v2/models/"):
            name = path[len("/v2/models/"):].split("/")[0]
            m = self._models.get(name)
            if m is None:
                h._send(404, {"error": f"model {name} not found"})
                return
            h._send(200, m.metadata())
            return
        h._send(404, {"error": f"unknown path {path}"})

    def _handle_post(self, h) -> None:
        try:
            length = int(h.headers.get("Content-Length", "0"))
            payload = json.loads(h.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            h._send(400, {"error": f"bad request body: {e}"})
            return
        path = h.path
        control = self._control.get(path)
        if control is not None:
            try:
                code, body = control(payload, h.headers)
            except Exception as e:  # noqa: BLE001 — surfaced as a 500
                code, body = 500, {"error": f"{type(e).__name__}: {e}"}
            h._send(code, body)
            return
        # V1: /v1/models/<name>:predict
        if path.startswith("/v1/models/") and path.endswith(":predict"):
            name = path[len("/v1/models/"):-len(":predict")]
            self._predict_v1(h, name, payload)
            return
        # V1: /v1/models/<name>:explain (explainer components)
        if path.startswith("/v1/models/") and path.endswith(":explain"):
            name = path[len("/v1/models/"):-len(":explain")]
            self._explain_v1(h, name, payload)
            return
        # V2: /v2/models/<name>/infer
        if path.startswith("/v2/models/") and path.endswith("/infer"):
            name = path[len("/v2/models/"):-len("/infer")]
            self._predict_v2(h, name, payload)
            return
        # OpenAI completions + chat completions (huggingfaceserver
        # parity): routed to models implementing openai_completions /
        # openai_chat (serving/text.py)
        if path in ("/openai/v1/completions",
                    "/openai/v1/chat/completions"):
            chat = path.endswith("/chat/completions")
            call_attr = "openai_chat" if chat else "openai_completions"
            stream_attr = ("openai_chat_stream" if chat
                           else "openai_stream")
            name = payload.get("model", "")
            m = self._models.get(name)
            if m is None or not hasattr(m, call_attr):
                h._send(404, {"error": f"no completions model {name!r}"})
                return
            # request-lifecycle trace (ISSUE 13): continue the router's
            # context (X-KFT-Trace) or sample fresh at this door.  The
            # replica.door phase opens HERE so QoS queue wait at this
            # door is attributed; the engine advances the phase track
            # from submit on, and the trace finalizes in the finally
            # below — on THIS HTTP thread, never the scheduler's.
            tracer = getattr(m, "tracer", None)
            trace = None
            if tracer is not None:
                from .trace import TRACE_HEADER

                trace = tracer.start(h.headers.get(TRACE_HEADER))
                if trace is not None:
                    trace.meta["model"] = name
                    trace.phase("replica.door", stream=bool(
                        payload.get("stream")))
            if payload.get("priority") is not None:
                # validate the client field up front: an unknown tier
                # is a 400 (client mistake), not a mid-generation 500
                # that inflates the router's backend-error counters
                from .traffic import priority_tier

                try:
                    priority_tier(payload["priority"])
                except ValueError as e:
                    if tracer is not None:
                        tracer.finish(trace)
                    h._send(400, {"error": str(e)})
                    return
            # per-tenant QoS front door (serving/traffic.py, ISSUE 9):
            # shed with an explicit 429 + Retry-After BEFORE any engine
            # work — on the SSE path this acquire (which may block,
            # bounded, in the class's admission queue) is the
            # backpressure that replaces unbounded buffering.  A router
            # that already charged the tenant's token bucket forwards
            # X-KFT-Admitted so the bucket is charged exactly once.
            plane = getattr(m, "traffic", None)
            ticket = None
            if plane is not None:
                from .traffic import shed_http

                tenant = str(h.headers.get("X-KFT-Tenant")
                             or payload.get("user") or "default")
                # credentialed tenants prove their claim HERE too —
                # replicas bind loopback, but the class contract must
                # not hinge on which door a local client picked.
                # (X-KFT-Admitted skipping the rate charge remains a
                # loopback-trust convenience, consistent with the rest
                # of ModelServer's unauthenticated local surface.)
                if trace is not None:
                    trace.meta["tenant"] = tenant
                if not plane.authenticate(
                        tenant, h.headers.get("Authorization")):
                    if trace is not None:
                        trace.meta["stall"] = "bad_tenant_credential"
                        tracer.finish(trace)
                    h._send(401, {
                        "error": "tenant credential required",
                        "reason": "bad_tenant_credential",
                        "tenant": tenant,
                    })
                    return
                ticket = plane.acquire(
                    tenant,
                    charge_rate=h.headers.get("X-KFT-Admitted") != "1")
                if not ticket.ok:
                    if trace is not None:
                        # the shed REASON is the stall cause the
                        # autoscaler summary aggregates (ISSUE 13)
                        trace.meta["stall"] = f"shed:{ticket.reason}"
                        tracer.finish(trace)
                    shed_http(h, ticket)
                    return
                if trace is not None and ticket.cls is not None:
                    trace.meta["class"] = ticket.cls.name
            # the class tier is the CONTRACT: this plane's ticket (or,
            # when this replica has no class for the tenant, the
            # router's X-KFT-Priority cluster classification) bounds
            # the payload priority — clients may self-demote, never
            # outrank their class (a spoofed "priority": "high" from a
            # bulk tenant would admit ahead of and preempt for gold)
            if ticket is not None or h.headers.get("X-KFT-Priority"):
                from .traffic import bound_priority

                bound_priority(payload, ticket=ticket,
                               header=h.headers.get("X-KFT-Priority"),
                               classed=(plane is not None
                                        and bool(plane.classes())))
            if trace is not None and hasattr(m, "accept_trace"):
                # thread-local handoff to the runtime (same HTTP
                # thread) — NEVER via the payload dict: the async
                # inference logger serializes that dict off-thread,
                # and an internal key would leak into (or race) the
                # CloudEvents log
                m.accept_trace(trace)
            t0 = time.perf_counter()
            req_id = f"{name}-{time.time_ns()}"
            if self.logger is not None:
                # the LoggerSpec contract covers EVERY request, the
                # OpenAI surface included (streams log the request side)
                self.logger.log("request", name, req_id, payload)
            with self.metrics.lock:  # inflight gauge covers completions too
                self.metrics.inflight += 1
            streaming = False  # SSE headers already on the wire?
            try:
                if payload.get("stream") and hasattr(m, stream_attr):
                    # SSE: tokens stream as the engine emits decode chunks
                    h.send_response(200)
                    h.send_header("Content-Type", "text/event-stream")
                    h.send_header("Cache-Control", "no-cache")
                    h.end_headers()
                    streaming = True
                    for chunk in getattr(m, stream_attr)(payload):
                        h.wfile.write(chunk)
                        h.wfile.flush()
                    self.metrics.observe(
                        name, time.perf_counter() - t0, error=False)
                    return
                out = getattr(m, call_attr)(payload)
                self.metrics.observe(name, time.perf_counter() - t0, error=False)
                if self.logger is not None:
                    self.logger.log("response", name, req_id, out)
                h._send(200, out)
            except BrokenPipeError:
                # client hung up mid-stream: not a server error
                self.metrics.observe(name, time.perf_counter() - t0, error=False)
            except Exception as e:  # noqa: BLE001 — surfaced as 500/SSE error
                log.debug("generate %s failed: %s", name, e)
                self.metrics.observe(name, time.perf_counter() - t0, error=True)
                if streaming:
                    # headers are on the wire: a second status line would
                    # corrupt the event stream.  Emit a terminal SSE error
                    # event + [DONE] so clients terminate cleanly.
                    try:
                        err = json.dumps(
                            {"error": f"{type(e).__name__}: {e}"})
                        h.wfile.write(
                            f"data: {err}\n\ndata: [DONE]\n\n".encode())
                        h.wfile.flush()
                    except (BrokenPipeError, OSError):
                        pass
                else:
                    try:
                        h._send(500, {"error": f"{type(e).__name__}: {e}"})
                    except (BrokenPipeError, OSError):
                        pass
            finally:
                with self.metrics.lock:
                    self.metrics.inflight -= 1
                if plane is not None and ticket is not None:
                    plane.release(ticket)
                if tracer is not None:
                    # finalization (histograms + ring) on this HTTP
                    # worker thread — the response is on the wire
                    tracer.finish(trace)
            return
        # V2 repository API: dynamic load/unload + index
        if path == "/v2/repository/index":
            h._send(200, self.repository_index())
            return
        if path.startswith("/v2/repository/models/"):
            rest = path[len("/v2/repository/models/"):]
            name, _, verb = rest.rpartition("/")
            if verb in ("load", "unload") and name:
                try:
                    ok = (self.load_model(name) if verb == "load"
                          else self.unload_model(name))
                except Exception as e:  # noqa: BLE001 — load() may raise
                    h._send(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                h._send(200 if ok else 404,
                        {"ok": ok} if ok else {"error": f"model {name} unknown"})
                return
        h._send(404, {"error": f"unknown path {path}"})

    def _dispatch(self, name: str, instances: list) -> list:
        batcher = self._batchers.get(name)
        if batcher is None:
            model = self._models.get(name)
            if model is None or not getattr(model, "self_batching", False):
                raise KeyError(name)
        with self.metrics.lock:
            self.metrics.inflight += 1
        try:
            if batcher is not None:
                return batcher.submit(instances)
            # self-batching: call from this request thread; concurrency is
            # the model's own scheduler's job (continuous batching engine)
            return model(instances)
        finally:
            with self.metrics.lock:
                self.metrics.inflight -= 1

    def set_logger(self, url: str, mode: str = "all",
                   service: str = "") -> None:
        """Enable payload logging (the ISvc ``logger`` field)."""
        if self.logger is not None:
            self.logger.stop()
        self.logger = InferenceLogger(url, mode, service)

    def _predict_v1(self, h, name: str, payload: dict) -> None:
        t0 = time.perf_counter()
        req_id = f"{name}-{time.time_ns()}"
        if self.logger is not None:
            self.logger.log("request", name, req_id, payload)
        try:
            instances = payload["instances"]
            out = self._dispatch(name, instances)
            self.metrics.observe(name, time.perf_counter() - t0, error=False)
            if self.logger is not None:
                self.logger.log("response", name, req_id,
                                {"predictions": out})
            h._send(200, {"predictions": out})
        except KeyError as e:
            self.metrics.observe(name, time.perf_counter() - t0, error=True)
            h._send(404 if str(e).strip("'") == name else 400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — surfaced to the client as 500
            log.debug("predict %s failed: %s", name, e)
            self.metrics.observe(name, time.perf_counter() - t0, error=True)
            h._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _explain_v1(self, h, name: str, payload: dict) -> None:
        # explanations are per-request heavy (each fans out its own batched
        # predictor calls), so they bypass the micro-batcher
        t0 = time.perf_counter()
        try:
            instances = payload["instances"]
            m = self._models.get(name)
            if m is None:
                raise KeyError(name)
            with self.metrics.lock:
                self.metrics.inflight += 1
            try:
                out = m.explain_batch(m.preprocess(instances))
            finally:
                with self.metrics.lock:
                    self.metrics.inflight -= 1
            self.metrics.observe(name, time.perf_counter() - t0, error=False)
            h._send(200, {"explanations": out})
        except KeyError as e:
            self.metrics.observe(name, time.perf_counter() - t0, error=True)
            h._send(404 if str(e).strip("'") == name else 400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — surfaced to the client as 500
            log.debug("explain %s failed: %s", name, e)
            self.metrics.observe(name, time.perf_counter() - t0, error=True)
            h._send(500, {"error": f"{type(e).__name__}: {e}"})

    @staticmethod
    def v2_to_instances(payload: dict) -> list:
        """V2 request tensors -> row-major instances of the first input
        (shared by the HTTP and gRPC wire formats)."""
        first = payload["inputs"][0]
        data, shape = first["data"], first.get("shape", [len(first["data"])])
        batch = shape[0] if shape else len(data)
        per = max(1, len(data) // max(batch, 1))
        return [
            data[i * per : (i + 1) * per] if per > 1 else data[i]
            for i in range(batch)
        ]

    @staticmethod
    def v2_response(name: str, out: list) -> dict:
        return {
            "model_name": name,
            "outputs": [{
                "name": "output0",
                "shape": [len(out)],
                "datatype": "FP32",
                "data": out,
            }],
        }

    def _predict_v2(self, h, name: str, payload: dict) -> None:
        t0 = time.perf_counter()
        req_id = payload.get("id") or f"{name}-{time.time_ns()}"
        if self.logger is not None:
            self.logger.log("request", name, req_id, payload)
        try:
            instances = self.v2_to_instances(payload)
            out = self._dispatch(name, instances)
            self.metrics.observe(name, time.perf_counter() - t0, error=False)
            resp = self.v2_response(name, out)
            if self.logger is not None:
                self.logger.log("response", name, req_id, resp)
            h._send(200, resp)
        except KeyError as e:
            self.metrics.observe(name, time.perf_counter() - t0, error=True)
            h._send(404 if str(e).strip("'") == name else 400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — surfaced to the client as 500
            log.debug("predict(v2) %s failed: %s", name, e)
            self.metrics.observe(name, time.perf_counter() - t0, error=True)
            h._send(500, {"error": f"{type(e).__name__}: {e}"})
