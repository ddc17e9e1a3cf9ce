"""InferenceService reconciler + router/autoscaler.

The KServe control plane rebuilt on this cluster (SURVEY.md §2.2, §3.3)
[upstream: kserve/kserve -> pkg/controller/v1beta1/inferenceservice]:

- reconcile InferenceService -> resolve ServingRuntime (explicit or
  model-format auto-selection) -> run the storage initializer -> host the
  predictor Model in ModelServer replicas -> phase Ready + url;
- a Router per ISvc gives the stable URL and round-robins replicas (the
  istio/knative routing tier), with knative-activator-style scale-from-zero:
  a request arriving with no live replica triggers scale-up and waits;
- the autoscaler loop (KPA analog) scales replicas between min/max on
  observed concurrency per replica, and to zero after an idle window when
  ``min_replicas == 0``;
- a transformer component chains in front of the predictor over HTTP,
  exactly KServe's transformer -> predictor hop.

The port's copy of ``kubeflow_tpu/serving/controller.py``, device-free
like it, with the same names; it imports nothing of the reference
package. It differs where the port runs one process a card: a gang
predictor runs
``kubeflow_tpu_torch.serving.gang:serve_main`` in one pod for each rank
(``hosts x chips_per_host`` pods, each asking one ``nvidia.com/gpu``),
and an in-process predictor whose
``mesh_axes`` spans more than one card becomes a one-host gang
(``hosts=1``, ``chips_per_host=N``); the autoscaler's TP-degree decisions
reach the gangs through rank 0's resize route (``gang.RESIZE_ROUTE``),
where the reference resizes its in-process engines; ``resolve_class``
refuses the JAX
package's class paths, the Router listens with ``BurstHTTPServer``'s backlog, a request waiting
at the activator keeps the idle clock from running (a cold start longer
than the idle window scaled its own replica away), and a torn-down
deployment's Router is left with no backends.
"""

from __future__ import annotations

import importlib
import json
import logging
import math
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Callable, Optional

from ..api.inference import (
    KIND_INFERENCE_SERVICE,
    KIND_SERVING_RUNTIME,
    ComponentSpec,
    InferenceService,
    InferenceServicePhase,
    ServingRuntime,
    select_runtime,
)
from ..controlplane.controller import Controller, Result
from ..controlplane.store import NotFound, Store
from ..utils.net import BurstHTTPServer, allocate_port
from .model import Model
from .server import ModelServer

SCALE_IDLE_SECONDS = 2.0  # idle window before scale-down (KPA-ish)
ACTIVATION_TIMEOUT = 15.0

log = logging.getLogger("kubeflow_tpu_torch.serving")


class _GangMetrics:
    """Concurrency probe for a gang replica: rank 0's /metrics exposes
    the server's ``kft_requests_inflight`` gauge — the same signal the
    in-process autoscaler reads directly, fetched over HTTP with a short
    cache (the reconcile loop runs at 4 Hz)."""

    def __init__(self, url: str) -> None:
        self._url = url
        self._val = 0
        self._ts = 0.0
        self._fail_ts = -10.0

    @property
    def inflight(self) -> int:
        now = time.monotonic()
        if now - self._fail_ts < 2.0:
            return 0  # negative cache: a booting/restarting gang must
            # not stall the shared reconcile worker on every pass
        if now - self._ts > 0.5:
            self._ts = now
            try:
                with urllib.request.urlopen(
                        self._url + "/metrics", timeout=0.3) as r:
                    val = 0
                    for line in r.read().decode().splitlines():
                        if line.startswith("kft_requests_inflight"):
                            val = int(float(line.split()[-1]))
                            break
                self._val = val
            except (OSError, ValueError):
                self._fail_ts = now
                self._val = 0
        return self._val


class _GangPredictor:
    """ModelServer-shaped handle for a gang-placed predictor.

    The data plane is one process a card, ``hosts x chips_per_host`` of
    them, launched as a JaxJob (serving/gang.py serve_main); rank 0's
    HTTP frontend lives at a port
    this handle allocates and freezes into the job's env, so ``url`` is
    known before the gang is even admitted — readiness is probed, not
    assumed.  Restarts belong to the JaxJob controller (gang semantics);
    this handle only creates/deletes the job.  Gang REPLICAS scale like
    in-process ones (min/max, concurrency via the /metrics probe,
    activator): one handle per gang, ordinal-named.
    """

    def __init__(self, store: Store, isvc, rev: int, gang, cfg: dict,
                 ordinal: int = 0):
        from ..api.common import (
            Container, ObjectMeta, ReplicaSpec, Resources, RestartPolicy,
            RunPolicy,
        )
        from ..api.jaxjob import WORKER, JaxJob, JaxJobSpec
        from .gang import ENV_SERVE_CONFIG

        self.store = store
        self.namespace = isvc.metadata.namespace
        self.job_name = f"{isvc.metadata.name}-gang-r{rev}-g{ordinal}"
        #: the GangSpec this handle placed — the elastic shrink path
        #: reads it to compute the surviving shape
        self.gang = gang
        self.port = allocate_port()
        self.metrics = _GangMetrics(f"http://127.0.0.1:{self.port}")
        self._ready_at: float = 0.0
        self._ready_fail_at: float = -10.0
        import os
        import secrets
        import tempfile

        conf = dict(cfg)
        conf["serve_port"] = self.port
        conf["gang_port"] = allocate_port()
        # per-job shared secret guarding the gang control stream,
        # delivered over a side channel: a 0600 token FILE (the
        # Secret-mount analog), because the JaxJob env is cluster-readable
        # through the API server and an inline token would let any tenant
        # who can GET the job join the stream.  Only the file's PATH
        # enters the env.
        fd, token_path = tempfile.mkstemp(
            prefix=f"kft-gang-{self.job_name}-", suffix=".token")
        try:
            os.fchmod(fd, 0o600)
            os.write(fd, secrets.token_hex(16).encode())
        finally:
            os.close(fd)
        self._token_path = token_path
        conf["gang_token_file"] = token_path
        conf["mesh_axes"] = dict(gang.mesh_axes)
        conf.setdefault("model_name", isvc.metadata.name)
        logger = isvc.spec.predictor.logger
        if logger is not None:
            conf["logger_url"] = logger.url
            conf["logger_mode"] = logger.mode
        env = {ENV_SERVE_CONFIG: json.dumps(conf)}
        if cfg.get("device"):
            # every rank's pod computes there ("cpu"); unset, each pod
            # computes on the card the scheduler gave it
            env["KFT_POD_DEVICE"] = str(cfg["device"])
        job = JaxJob(
            metadata=ObjectMeta(name=self.job_name, namespace=self.namespace),
            spec=JaxJobSpec(
                run_policy=RunPolicy(backoff_limit=gang.backoff_limit),
                replica_specs={
                    # one process drives one card: a pod for each rank
                    WORKER: ReplicaSpec(
                        replicas=gang.hosts * gang.chips_per_host,
                        restart_policy=RestartPolicy.ON_FAILURE,
                        template=Container(
                            entrypoint=("kubeflow_tpu_torch.serving.gang:"
                                        "serve_main"),
                            env=env,
                            resources=Resources(gpu=1),
                        ),
                    )
                },
            ),
        )
        store.create(job)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def tp_degree(self) -> int:
        """The gang's TP degree, as last placed or resized."""
        from .resize import degree_of

        return degree_of(self.gang.mesh_axes)

    @property
    def tp_resizable(self) -> bool:
        """Whether the TP-resize actuator may post to this gang: not with
        an ``expert`` axis (its resizes are refused, ``sharded.
        refuse_expert``)."""
        from .sharded import expert_degree

        return expert_degree(self.gang.mesh_axes) == 1

    def resize_to_degree(self, degree: int) -> bool:
        """The autoscaler's TP-degree decision, posted to rank 0's resize
        route (``gang.post_resize``) with the gang token; records the new
        degree on ``gang``'s ``mesh_axes``. True when the degree changed;
        raises when the gang refused (a target above its live members, a
        resize that aborted with the old degree resumed in place)."""
        from .gang import post_resize

        with open(self._token_path) as f:
            token = f.read().strip()
        out = post_resize(self.url, degree, token)
        if int(out["degree"]) != int(degree):
            raise RuntimeError(
                f"gang {self.job_name} is at TP degree {out['degree']}, "
                f"not {degree}")
        self.gang = self.gang.model_copy(
            update={"mesh_axes": {"model": int(degree)}})
        return bool(out["resized"])

    @property
    def ready(self) -> bool:
        """Rank 0 frontend answering its readiness probe (cached briefly —
        the reconcile loop runs at 4 Hz and a gang is not a thing to poll
        into the ground)."""
        now = time.monotonic()
        if now < self._ready_at + 1.0:
            return True
        if now < self._ready_fail_at + 1.0:
            return False  # negative cache: a booting gang must not stall
            # the shared reconcile worker on every 4 Hz pass
        try:
            with urllib.request.urlopen(
                    self.url + "/v2/health/ready", timeout=0.5) as resp:
                ok = resp.status == 200
        except OSError:
            ok = False
        if ok:
            self._ready_at = now
        else:
            self._ready_fail_at = now
        return ok

    def stop(self) -> None:
        import os

        from ..api.jaxjob import KIND_JAXJOB

        try:
            self.store.delete(KIND_JAXJOB, self.job_name, self.namespace)
        except NotFound:
            pass
        try:
            os.unlink(self._token_path)
        except OSError:
            pass


def resolve_class(ref: str) -> type:
    """'pkg.module:Class' -> class object (ServingRuntime.server_class).

    A class path of the JAX package (``kubeflow_tpu.…``) is refused before
    any import, naming the port's counterpart: importing it would pull jax
    into the port's process."""
    mod, _, cls = ref.partition(":")
    if mod == "kubeflow_tpu" or mod.startswith("kubeflow_tpu."):
        port = "kubeflow_tpu_torch" + mod[len("kubeflow_tpu"):]
        raise ValueError(
            f"server class {ref!r} names the JAX package; the port serves "
            f"{port}:{cls.replace('Jax', 'Torch')}")
    return getattr(importlib.import_module(mod), cls)


class Router:
    """Stable URL in front of N replica servers: traffic-aware routing.

    Baseline behavior is the smooth-WRR + activator tier; with a
    :class:`~.traffic.TrafficPlane` installed (``set_traffic``) the
    router becomes the cluster front door (ISSUE 9):

    - **per-tenant QoS**: token-bucket + bounded-queue admission per
      class; sheds are explicit 429s with ``Retry-After`` and a
      structured reason, never unbounded buffering (the SSE path blocks
      at this door inside the class's queue bound);
    - **prefix-affinity routing**: the prompt's prefix blocks hash to
      block-content keys (``paged.block_keys``) and the request routes
      to the replica that already holds them, least-loaded otherwise —
      the replica prefix caches only pay off when the router feeds
      them;
    - **connection-failure re-route**: a dead backend's affinity
      entries are forgotten and the request retries the surviving
      replicas (bounded by pool size) — a replica crash mid-storm costs
      a re-route, not a hang;
    - **observability**: per-backend request/error/inflight counters on
      the router's own ``/metrics``, with ``no_backend_total`` and the
      plane's shed/affinity gauges.
    """

    def __init__(self, activate: Callable[[], None],
                 port: Optional[int] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 rng=None, serve: bool = True):
        #: ``serve=False`` builds the full policy surface (pools, WRR
        #: state, circuits, budget, domains) WITHOUT the HTTP server —
        #: the digital twin (``sim/``) drives this exact object with a
        #: virtual ``clock``/seeded ``rng``, so routing decisions in
        #: simulation are the production code path by construction.
        self.port = port or (allocate_port() if serve else 0)
        self._clock = clock
        self._rng = rng
        #: weighted backend pools: [(urls, weight)] — one pool per
        #: revision (canary rollout splits traffic here, the
        #: virtualservice-weight analog); single-revision services have
        #: one pool at weight 100
        self._pools: list[tuple[list[str], int]] = []
        self._explain_pools: list[tuple[list[str], int]] = []
        self._rr: list[int] = []   # per-pool round-robin cursors
        self._err: list[int] = []
        self._wrr: list[int] = []  # smooth-WRR current weights
        self._ewrr: list[int] = []
        self._lock = threading.Lock()
        self._activate = activate
        self.last_request_time = 0.0
        #: optional traffic plane (QoS + affinity); None = classic WRR
        self.traffic = None
        #: optional request-lifecycle tracer (ISSUE 13): the router is
        #: the path's ROOT sampling decision — its trace context rides
        #: X-KFT-Trace to the replica, so one sampled request is traced
        #: end to end.  Installed via configure_tracing.
        self.tracer = None
        self._tracing_fp: Optional[str] = None
        #: optional cluster block-registry poller (ISSUE 13 satellite):
        #: scrapes replica /metrics prefix rows on a jittered interval
        #: and exports kft_cluster_prefix_replicas gauges
        self.prefix_poller = None
        #: per-backend counters: url -> {requests, errors, inflight}
        self._backend_stats: dict[str, dict[str, int]] = {}
        self.no_backend_total = 0
        # correlated-failure survival (ISSUE 16): per-backend health
        # circuits + the cluster retry budget.  Always active — with
        # ``domains`` unset every backend sits in one implicit domain
        # and only the circuit/budget behavior applies.
        from .traffic import BackendHealth, RetryBudget

        self.health = BackendHealth(clock=clock, rng=rng)
        self.retry_budget = RetryBudget(clock=clock)
        #: url -> failure-domain label (empty = single implicit domain)
        self._domains: dict[str, str] = {}
        #: domains currently declared down (mass-forget fired once)
        self._domains_down: set[str] = set()
        self.domain_outages_total = 0
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _proxy(self) -> None:
                if self.command == "GET" and self.path == "/metrics":
                    # exemplars only under negotiated OpenMetrics —
                    # the classic parser fails on the trailer
                    om = "application/openmetrics-text" in str(
                        self.headers.get("Accept") or "")
                    body = router.metrics_text(openmetrics=om).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "application/openmetrics-text; version=1.0.0; "
                        "charset=utf-8" if om
                        else "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.command == "GET" and (
                        self.path == "/traces"
                        or self.path.startswith("/traces?")):
                    # router-side trace view — the SAME query contract
                    # helper as the replica's /traces (observability
                    # GETs never tick the idle clock, the /metrics
                    # rule)
                    from .trace import parse_slowest, traces_body

                    ok, slowest = parse_slowest(self.path)
                    if not ok:
                        self._respond(400, json.dumps(
                            {"error": "slowest must be an "
                                      "int"}).encode())
                        return
                    body = ""
                    if router.tracer is not None:
                        router.tracer.reap()
                        body = traces_body([router.tracer.sink],
                                           slowest)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Content-Length",
                                     str(len(body.encode())))
                    self.end_headers()
                    self.wfile.write(body.encode())
                    return
                # the idle clock ticks AFTER the /metrics early-return:
                # a monitoring poller scraping faster than
                # SCALE_IDLE_SECONDS would otherwise pin the
                # deployment's replica count forever (scale-down and
                # scale-to-zero key off this timestamp)
                router.last_request_time = time.time()
                explain = self.path.endswith(":explain")
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length) if length else None
                keys, tenant, session = router._request_context(
                    body, self.headers)
                plane = router.traffic
                ticket = None
                # the QoS door gates INFERENCE POSTs only: readiness /
                # metadata GETs and admin POSTs (repository load/unload
                # through the stable URL) are control-plane traffic —
                # shedding health probes would flap the controller's
                # view of its own replicas, and charging operators to
                # the "default" tenant's bucket couples control
                # operations to tenant rate limits
                infer = (self.path.startswith("/openai/")
                         or self.path.endswith((":predict", ":explain",
                                                "/infer")))
                trace = None
                if (router.tracer is not None and infer
                        and self.command == "POST"):
                    from .trace import TRACE_HEADER

                    # the ROOT sampling decision for the whole path: a
                    # replica honoring X-KFT-Trace inherits it, so one
                    # decision covers router door -> affinity pick ->
                    # replica door -> engine -> handoff -> decode
                    trace = router.tracer.start(
                        self.headers.get(TRACE_HEADER))
                    if trace is not None:
                        trace.meta["tenant"] = tenant
                        trace.phase("router.door")
                if plane is not None and self.command == "POST" and infer:
                    from .traffic import shed_http

                    if not plane.authenticate(
                            tenant, self.headers.get("Authorization")):
                        # a tenant whose Profile carries an api_token
                        # must prove the claim — otherwise any client
                        # could adopt a privileged class's rate and
                        # priority by naming it (the spoof the
                        # no-self-promotion rule exists to stop)
                        body401 = json.dumps({
                            "error": "tenant credential required",
                            "reason": "bad_tenant_credential",
                            "tenant": tenant,
                        }).encode()
                        if trace is not None:
                            trace.meta["stall"] = "bad_tenant_credential"
                            router.tracer.finish(trace)
                            trace = None
                        self._respond(401, body401)
                        return
                    ticket = plane.acquire(tenant)
                    if not ticket.ok:
                        if trace is not None:
                            # shed reason = the stall cause the
                            # autoscaler summary aggregates
                            trace.meta["stall"] = \
                                f"shed:{ticket.reason}"
                            router.tracer.finish(trace)
                            trace = None
                        shed_http(self, ticket)
                        return
                    if trace is not None and ticket.cls is not None:
                        trace.meta["class"] = ticket.cls.name
                try:
                    self._route_and_forward(
                        explain, body, keys, tenant, ticket, session,
                        trace=trace)
                finally:
                    if ticket is not None:
                        plane.release(ticket)
                    if trace is not None:
                        router.tracer.finish(trace)

            def _route_and_forward(self, explain, body, keys, tenant,
                                   ticket, session=None,
                                   trace=None) -> None:
                if trace is not None:
                    # door wait ends here; the pick (affinity lookup,
                    # possibly the scale-from-zero activation wait) is
                    # its own phase
                    trace.phase("router.route")
                backend = router._pick(explain, keys, session=session)
                if backend is None:
                    if trace is not None:
                        trace.meta["stall"] = "activation_wait"
                    router._activate()
                    deadline = time.time() + ACTIVATION_TIMEOUT
                    while backend is None and time.time() < deadline:
                        time.sleep(0.05)
                        # a request waiting at the activator is demand:
                        # a cold start longer than SCALE_IDLE_SECONDS must
                        # not find its new replica idle and scale it away
                        router.last_request_time = time.time()
                        backend = router._pick(explain, keys,
                                               session=session)
                if trace is not None:
                    trace.phase("router.forward",
                                backend=backend or "")
                tried: set[str] = set()
                while backend is not None:
                    headers = {"Content-Type": "application/json"}
                    if trace is not None:
                        # propagate the context: the replica's door
                        # continues THIS trace instead of sampling
                        headers["X-KFT-Trace"] = trace.header()
                    if self.headers.get("Authorization"):
                        # a replica-side plane may hold its own
                        # qos_tenant_tokens: the credential must
                        # survive the hop or routed requests from a
                        # credentialed tenant all 401 at the replica
                        headers["Authorization"] = \
                            self.headers["Authorization"]
                    if router.traffic is not None:
                        # forward the classification only when this
                        # router actually made one — a plane-less
                        # router's "default" must not override the
                        # payload's user field at a QoS-bearing replica
                        headers["X-KFT-Tenant"] = tenant
                    if ticket is not None:
                        # replica-side plane must not double-charge the
                        # tenant's token bucket.  Priority: the class
                        # tier when one classified the tenant; the
                        # "normal" cap when this door HAS classes but
                        # this tenant none (an anonymous caller must
                        # not outrank classed tenants); nothing for a
                        # class-free affinity-only plane (no ordering
                        # contract — the payload stands downstream)
                        headers["X-KFT-Admitted"] = "1"
                        if ticket.cls is not None:
                            headers["X-KFT-Priority"] = \
                                ticket.priority_name
                        elif router.traffic.classes():
                            headers["X-KFT-Priority"] = "normal"
                    elif self.headers.get("X-KFT-Priority"):
                        headers["X-KFT-Priority"] = \
                            self.headers["X-KFT-Priority"]
                    req = urllib.request.Request(
                        backend + self.path, data=body,
                        method=self.command, headers=headers)
                    router._note(backend, delta=+1)
                    try:
                        with urllib.request.urlopen(req, timeout=60) as resp:
                            payload = resp.read()
                            router._note(backend, delta=-1)
                            router._backend_up(backend)
                            self._respond(resp.status, payload)
                            return
                    except urllib.error.HTTPError as e:
                        router._note(backend, delta=-1,
                                     error=e.code >= 500)
                        # circuit evidence: a 5xx is an erroring-but-
                        # alive replica (error-rate trip); anything
                        # else (429 shed, 4xx) proves it answers
                        if e.code >= 500:
                            router.health.note_failure(backend)
                        else:
                            router._backend_up(backend)
                        self._respond(e.code, e.read(),
                                      retry_after=e.headers.get(
                                          "Retry-After"))
                        return
                    except OSError as e:
                        router._note(backend, delta=-1, error=True)
                        # re-route ONLY connection-level death (a
                        # crashed replica: refused/reset/aborted) —
                        # a slow-but-alive replica's read timeout must
                        # NOT re-POST the inference elsewhere (it is
                        # likely still computing; a duplicate doubles
                        # the work and the tokens billed) nor wipe a
                        # healthy replica's affinity
                        reason = getattr(e, "reason", e)
                        if not isinstance(reason, ConnectionError):
                            self._respond(502, json.dumps(
                                {"error": str(e)}).encode())
                            return
                        router._backend_down(backend)
                        tried.add(backend)
                        # the cluster retry budget (ISSUE 16): N dying
                        # replicas must not multiply a 2x storm into a
                        # 2(1+retries)x storm — past the budget, the
                        # client gets the jittered 503 below instead
                        # of another forwarded attempt
                        if not router.retry_budget.try_retry():
                            backend = None
                            break
                        # spread the re-route across SURVIVING domains
                        # with a small jittered backoff: the recovery
                        # herd from a domain-sized outage arrives at
                        # the survivors de-synchronized, not as a wave
                        time.sleep(random.uniform(0.01, 0.05))
                        avoid = {router.domain_of(u) for u in tried
                                 if router.domain_of(u)}
                        backend = router._pick(explain, keys,
                                               exclude=tried,
                                               session=session,
                                               avoid_domains=avoid)
                router.no_backend_total += 1
                from .traffic import jittered_retry_after

                # jittered, load-aware Retry-After (ISSUE 16
                # satellite): the more circuits are open, the longer
                # and more spread out the herd's retry horizon
                ra = jittered_retry_after(
                    1.0, load=len(router.health.open_backends()),
                    rng=router._rng)
                self._respond(
                    503, json.dumps({
                        "error": "no ready replicas",
                        "reason": "no_ready_replicas",
                        "retry_after": round(ra, 3),
                    }).encode(),
                    retry_after=str(max(1, math.ceil(ra))))

            def _respond(self, code: int, body: bytes,
                         retry_after: Optional[str] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                if retry_after:
                    self.send_header("Retry-After", retry_after)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._proxy()

            def do_POST(self):
                self._proxy()

        if not serve:
            self._httpd = None
            self._thread = None
            return
        self._httpd = BurstHTTPServer(("127.0.0.1", self.port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"router-{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def set_traffic(self, plane) -> None:
        """Install (or clear) the traffic plane — QoS admission +
        prefix-affinity routing from the next request on."""
        self.traffic = plane

    def _request_context(self, body: Optional[bytes],
                         headers) -> tuple[list, str, str]:
        """(affinity keys, tenant, session) for one request.  The
        tenant comes from the ``X-KFT-Tenant`` header or the OpenAI
        ``user`` field; the affinity keys hash the prompt's prefix in
        block quanta (byte-token ids — exactly the block-content
        identity for the byte tokenizer, a stable content proxy for
        any other); the session id (``X-KFT-Session`` header or
        payload ``session``, ISSUE 12) routes a durable conversation
        back to the replica still holding its KV."""
        tenant = headers.get("X-KFT-Tenant") or ""
        session = str(headers.get("X-KFT-Session") or "")
        keys: list = []
        plane = self.traffic
        if body and plane is not None:
            try:
                payload = json.loads(body)
            except (ValueError, UnicodeDecodeError):
                payload = None
            if isinstance(payload, dict):
                tenant = tenant or str(payload.get("user") or "")
                session = session or str(payload.get("session") or "")
                prompt = payload.get("prompt")
                if prompt is None and isinstance(
                        payload.get("messages"), list):
                    prompt = "\n".join(
                        f"{m.get('role', 'user')}: {m.get('content', '')}"
                        for m in payload["messages"])
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ""
                if isinstance(prompt, str) and prompt:
                    keys = plane.prefix_keys(list(prompt.encode("utf-8")))
        return keys, tenant or "default", session

    def _note(self, backend: str, delta: int, error: bool = False) -> None:
        with self._lock:
            st = self._backend_stats.setdefault(
                backend, {"requests": 0, "errors": 0, "inflight": 0})
            if delta > 0:
                st["requests"] += 1
            st["inflight"] = max(0, st["inflight"] + delta)
            if error:
                st["errors"] += 1

    def _backend_down(self, backend: str) -> None:
        # feed the health circuit FIRST (ISSUE 16): enough consecutive
        # connection failures open it and routing skips the corpse
        # until a jittered half-open probe proves it back — before the
        # circuit existed this forgot the backend's affinity but kept
        # routing connect attempts at it until membership churn
        self.health.note_failure(backend)
        if self.traffic is not None:
            self.traffic.affinity.forget(backend)
            # its hibernated/live sessions' KV died with it: resumes
            # re-route and thaw from the shared storage tier instead
            self.traffic.sessions.forget(backend)
        self._check_domain_outage(self.domain_of(backend))

    def _backend_up(self, backend: str) -> None:
        """One successful forward: recovery evidence for the circuit,
        a deposit into the cluster retry budget, and — if its domain
        was declared down — the all-clear for the domain."""
        self.health.note_success(backend)
        self.retry_budget.note_success()
        d = self.domain_of(backend)
        if d and d in self._domains_down:
            self._domains_down.discard(d)

    def domain_of(self, backend: str) -> str:
        """Failure-domain label for ``backend`` ('' = the single
        implicit domain when ``domains`` is unconfigured)."""
        return self._domains.get(backend, "")

    def set_domains(self, mapping: dict[str, str]) -> None:
        """Install the url -> failure-domain map (the controller's
        ``_wire`` keeps it in lockstep with the pools).  Domains whose
        members all churned away stop being tracked as down."""
        self._domains = dict(mapping or {})
        self._domains_down &= set(self._domains.values())

    def backends(self) -> list[str]:
        """Flat live data-plane backend list (pool order)."""
        with self._lock:
            return [u for us, _w in self._pools for u in us]

    def _check_domain_outage(self, domain: str) -> None:
        """Declare ``domain`` down when EVERY one of its live backends
        has an open circuit while another domain still serves, and
        mass-forget its sessions/affinity/registry rows in ONE pass —
        the herd of resumes then routes straight to survivors instead
        of each request rediscovering the outage one dead connect at
        a time.  Fires once per outage (re-armed by the first
        successful forward into the domain, or membership churn)."""
        if not domain or domain in self._domains_down:
            return
        members = [u for u in self.backends()
                   if self._domains.get(u, "") == domain]
        others = [u for u in self.backends()
                  if self._domains.get(u, "") != domain]
        # "another domain still serves" means a survivor with a
        # non-open circuit — a TOTAL collapse is not a domain outage
        # (mass-forgetting with nobody to re-route toward just throws
        # away the warm-resume state the comeback would want)
        if not members or not any(
                self.health.state(u) != "open" for u in others):
            return
        if any(self.health.state(u) != "open" for u in members):
            return
        self._domains_down.add(domain)
        self.domain_outages_total += 1
        for u in members:
            # trip is idempotent; the forgets are the mass action
            self.health.trip(u)
            if self.traffic is not None:
                self.traffic.affinity.forget(u)
                self.traffic.sessions.forget(u)
            if self.prefix_poller is not None:
                self.prefix_poller.registry.forget(u)
        log.warning("failure domain %r declared down "
                    "(%d backends, circuits open)", domain, len(members))

    def _inflight(self, backend: str) -> int:
        with self._lock:
            st = self._backend_stats.get(backend)
            return st["inflight"] if st else 0

    def backend_stats(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {b: dict(st) for b, st in self._backend_stats.items()}

    def metrics_text(self, openmetrics: bool = False) -> str:
        """Router observability in Prometheus text format: per-backend
        request/error/inflight gauges + the no-backend counter + the
        traffic plane's shed/affinity/preemption gauges.
        ``openmetrics`` (negotiated by the handler) enables exemplar
        trailers + the ``# EOF`` terminator."""
        from .traffic import prom_label

        lines = []
        for fam in ("requests", "errors", "inflight"):
            lines.append(f"# TYPE kft_router_backend_{fam} gauge")
            for b, st in sorted(self.backend_stats().items()):
                lines.append(
                    f'kft_router_backend_{fam}'
                    f'{{backend="{prom_label(b)}"}} {st[fam]}')
        lines.append("# TYPE kft_router_no_backend_total gauge")
        lines.append(f"kft_router_no_backend_total {self.no_backend_total}")
        # correlated-failure survival gauges (ISSUE 16): circuit
        # states per backend, trip/close/probe counters, the cluster
        # retry budget, and declared domain outages
        lines.append("# TYPE kft_router_circuit_open gauge")
        for b in sorted(self.backends()):
            state = self.health.state(b)
            lines.append(
                f'kft_router_circuit_open{{backend="{prom_label(b)}",'
                f'domain="{prom_label(self.domain_of(b))}"}} '
                f"{1 if state != 'closed' else 0}")
        from .traffic import prom_stat_lines as _psl

        fams = _psl({**self.health.stats(), **self.retry_budget.stats(),
                     "domain_outages_total": self.domain_outages_total},
                    "kft_router_")
        for fam in sorted(fams):
            lines.append(f"# TYPE {fam} gauge")
            lines.extend(fams[fam])
        if self.traffic is not None:
            from .traffic import prom_stat_lines

            fams = prom_stat_lines(self.traffic.stats(), "kft_router_")
            for fam in sorted(fams):
                lines.append(f"# TYPE {fam} gauge")
                lines.extend(fams[fam])
        if self.tracer is not None:
            from .traffic import prom_stat_lines

            fams = prom_stat_lines(self.tracer.stats(), "kft_router_")
            for fam in sorted(fams):
                lines.append(f"# TYPE {fam} gauge")
                lines.extend(fams[fam])
            # router-side phase histograms (door / route / forward) —
            # the scrape half of /traces (exemplar trace ids only on
            # a negotiated OpenMetrics scrape)
            lines.extend(self.tracer.sink.phase_metrics(
                exemplars=openmetrics))
        if self.prefix_poller is not None:
            # cluster prefix heat (ISSUE 13 satellite): how many
            # replicas hold each hot prefix chain — the placement
            # signal the autoscaler loop (ROADMAP item 2) consumes
            lines.extend(self.prefix_poller.metrics_lines())
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def configure_tracing(self, spec) -> None:
        """Install/refresh/clear the router's tracer from the ISvc
        ``tracing`` config (fingerprinted — the 4 Hz reconcile must not
        wipe the ring every pass)."""
        import json as jsonlib

        from .trace import Tracer, validate_tracing

        if not spec:
            self.tracer = None
            self._tracing_fp = None
            return
        kw = validate_tracing(spec)
        fp = jsonlib.dumps(kw, sort_keys=True)
        if fp == self._tracing_fp:
            return
        self.tracer = Tracer(**kw)
        self._tracing_fp = fp

    def start_prefix_poller(self, interval_s: float) -> None:
        """Start (idempotent) the cluster block-registry poller over
        this router's live data-plane backends."""
        if self.prefix_poller is not None:
            self.prefix_poller.interval_s = float(interval_s)
            return
        from .traffic import ClusterPrefixPoller

        def backends() -> list[str]:
            with self._lock:
                return [u for us, _w in self._pools for u in us]

        self.prefix_poller = ClusterPrefixPoller(
            backends, interval_s=float(interval_s))

    def set_backends(self, urls: list[str]) -> None:
        self.set_weighted_backends([(list(urls), 100)])

    def set_weighted_backends(self, pools: list[tuple[list[str], int]]) -> None:
        """Traffic-split backend pools; empty pools and zero weights are
        dropped (an empty stable pool must fall through to the activator,
        not eat the canary's share)."""
        with self._lock:
            new = [(list(u), int(w)) for u, w in pools if u and w > 0]
            if ([w for _, w in new] != [w for _, w in self._pools]
                    or len(self._wrr) != len(new)):
                self._wrr = [0] * len(new)  # weights changed: reset the WRR
            if [u for u, _ in new] != [u for u, _ in self._pools]:
                self._rr = [0] * len(new)  # membership changed: reset RR
            gone = ({u for us, _ in self._pools for u in us}
                    - {u for us, _ in new for u in us})
            self._pools = new
            for u in gone:
                # replica ports never come back: without pruning,
                # autoscale churn grows the per-backend /metrics rows
                # (and the dict behind them) without bound
                self._backend_stats.pop(u, None)
        # a removed replica's KV is gone with it: keep affinity from
        # steering same-prefix traffic at a corpse (outside the lock —
        # the affinity map has its own)
        for u in gone:
            self._backend_down(u)
            # membership churn, not a failure: the circuit record and
            # domain label die with the URL (ports never come back)
            self.health.forget(u)
            self._domains.pop(u, None)

    def set_explain_backends(self, urls: list[str]) -> None:
        """Backends for the ``:explain`` verb (KServe routes the verb to the
        explainer component, everything else to transformer/predictor)."""
        self.set_weighted_explain_backends([(list(urls), 100)])

    def set_weighted_explain_backends(
        self, pools: list[tuple[list[str], int]]
    ) -> None:
        with self._lock:
            new = [(list(u), int(w)) for u, w in pools if u and w > 0]
            if ([w for _, w in new] != [w for _, w in self._explain_pools]
                    or len(self._ewrr) != len(new)):
                self._ewrr = [0] * len(new)
            if [u for u, _ in new] != [u for u, _ in self._explain_pools]:
                self._err = [0] * len(new)
            # same cleanup as the data-plane pools: explain replicas
            # churn ports too, and their stats rows / affinity entries
            # must die with them
            gone = ({u for us, _ in self._explain_pools for u in us}
                    - {u for us, _ in new for u in us})
            self._explain_pools = new
            for u in gone:
                self._backend_stats.pop(u, None)
        for u in gone:
            self._backend_down(u)
            self.health.forget(u)
            self._domains.pop(u, None)

    def _pick(self, explain: bool = False, keys: Optional[list] = None,
              exclude: Optional[set] = None,
              session: Optional[str] = None,
              avoid_domains: Optional[set] = None) -> Optional[str]:
        # the pick pipeline is the pure policy pair in traffic.py
        # (ISSUE 20 extraction): smooth_wrr_pick mutates the cursor
        # state under this lock, live_candidates filters through the
        # health circuits — the sim twin calls the same functions on
        # the same objects
        from .traffic import live_candidates, smooth_wrr_pick

        with self._lock:
            use_explain = explain and self._explain_pools
            pools = self._explain_pools if use_explain else self._pools
            cur = self._ewrr if use_explain else self._wrr
            rrs = self._err if use_explain else self._rr
            if not pools:
                return None
            best = smooth_wrr_pick(pools, cur)

            def live(urls: list) -> list:
                return live_candidates(
                    urls, self.health.routable, exclude=exclude,
                    avoid_domains=avoid_domains,
                    domain_of=lambda u: self._domains.get(u, ""))

            pool = live(pools[best][0])
            if not pool:
                # crash-retry/circuits emptied the WRR-chosen pool:
                # any OTHER pool's live backend beats a 503 — a canary
                # split must not turn one stable-replica crash into
                # "no ready replicas" while the canary serves
                for us, _w in pools:
                    pool = live(us)
                    if pool:
                        break
                if not pool:
                    return None
            plane = self.traffic
            if plane is None or not (keys or session):
                # round-robin WITHIN the chosen pool, cursor per pool — a
                # shared cursor lets a 1-backend pool reset it and starve
                # backends of the other pool during a canary split
                rrs[best] = (rrs[best] + 1) % len(pool)
                choice = pool[rrs[best]]
                self.health.on_routed(choice)
                return choice
        # session/prefix-affinity pick (outside the WRR lock: the plane
        # has its own): a durable session resumes at the replica still
        # holding its KV (ISSUE 12); otherwise the replica already
        # holding this prompt's prefix blocks wins unless it is
        # overloaded vs its peers; least-inflight otherwise, and the
        # choice is recorded so the NEXT same-prefix request sticks
        backend, _depth = plane.route(keys or [], pool,
                                      load=self._inflight,
                                      session=session)
        self.health.on_routed(backend)
        return backend

    def stop(self) -> None:
        if self.prefix_poller is not None:
            self.prefix_poller.stop()
            self.prefix_poller = None
        if self._httpd is None:
            return  # serve=False twin router: nothing to tear down
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)


class _Revision:
    """One immutable rollout of an InferenceService spec.

    Canary rollout (KServe's canaryTrafficPercent over virtualservice
    weights) needs two revisions live at once, each serving the spec it
    was created from — so the resolved runtime + config are frozen here,
    not re-derived from the (possibly newer) object spec."""

    def __init__(self, rev: int, fingerprint: str, spec, runtime_cls, cfg: dict):
        self.rev = rev
        self.fingerprint = fingerprint
        self.spec = spec
        self.runtime_cls = runtime_cls
        self.cfg = cfg
        self.predictors: list[ModelServer] = []
        self.transformers: list[ModelServer] = []
        self.explainers: list[ModelServer] = []
        #: monotonically increasing ordinal for gang-replica job names
        self.gang_counter = 0

    @property
    def servers(self) -> list[ModelServer]:
        return self.explainers + self.transformers + self.predictors


class _Deployment:
    """Live serving state for one InferenceService."""

    def __init__(self) -> None:
        self.router: Optional[Router] = None
        self.stable: Optional[_Revision] = None
        self.canary: Optional[_Revision] = None
        self.rev_counter = 0
        self.pct = 0  # live canary traffic share
        self.wants_scale_up = False
        #: fingerprint of the traffic plane's merged config (cfg qos +
        #: Profile qos): the plane rebuilds only when this changes, so
        #: counters and affinity state survive the 4 Hz reconcile
        self.traffic_fp: Optional[str] = None
        #: Degraded-deadline tracking (ISSUE 10): when the deployment
        #: entered Degraded, and whether this episode already escalated
        #: (one DegradedTimeout + shrink per episode, not per 4 Hz tick)
        self.degraded_since: Optional[float] = None
        self.degraded_escalated = False
        #: predictive autoscaler (ISSUE 15), fingerprint-rebuilt like
        #: the traffic plane so predictor state and cooldown clocks
        #: survive the 4 Hz reconcile; its replica actuators write
        #: ``autoscale_desired`` and ``_desired_replicas`` applies it
        self.autoscaler = None
        self.autoscale_fp: Optional[str] = None
        self.autoscale_desired: Optional[int] = None
        #: mass-recovery thaw cap (ISSUE 16): one shared
        #: ConcurrencyGate attached to every engine's ``thaw_gate``
        #: when the policy sets ``thaw_concurrency`` > 0, so a dead
        #: domain's hibernated sessions re-materialize a few at a time
        #: instead of starving live decode
        self.thaw_gate = None
        #: wake-from-zero cold-start clock: stamped when the loop fires
        #: a placement at n=0, closed when the fleet reports ready —
        #: the measured budget scale-to-zero is held to
        self.cold_start_t0: Optional[float] = None
        #: (monotonic t, cumulative plane sheds) for the shed-rate sensor
        self.shed_mark: tuple[float, float] = (0.0, 0.0)

    @property
    def revisions(self) -> list[_Revision]:
        return [r for r in (self.stable, self.canary) if r is not None]


class InferenceServiceController(Controller):
    kind = KIND_INFERENCE_SERVICE
    # one worker: reconciles mutate live _Deployment state (servers, router
    # backends); the workqueue serializes per key, but one worker keeps the
    # cross-key server/port churn sequential too
    workers = 1

    def __init__(self, store: Store) -> None:
        super().__init__(store)
        self._deployments: dict[str, _Deployment] = {}
        self._lock = threading.Lock()
        # cold-start concurrency gate (ISSUE 16): serialize the
        # pre-warm/compile path so emergency grow-back after a domain
        # outage cannot stampede N simultaneous census+install sweeps
        # through one warm peer
        from .autoscale import ConcurrencyGate
        self._prewarm_gate = ConcurrencyGate(1)

    def stop(self) -> None:
        super().stop()
        for d in list(self._deployments.values()):
            self._teardown_deployment(d)
        self._deployments.clear()

    # -- reconcile --------------------------------------------------------

    @staticmethod
    def _fingerprint(spec) -> str:
        """Spec identity for revision tracking — the traffic split is
        routing config, not a new revision."""
        d = spec.model_dump(mode="json")
        d.pop("canary_traffic_percent", None)
        return json.dumps(d, sort_keys=True)

    #: engine knobs validated at conf-freeze (value below floor -> Failed)
    _ENGINE_KNOBS = ("num_slots", "decode_chunk", "pipeline_depth",
                     "prefill_budget", "spec_k", "spec_ngram",
                     "block_size", "num_blocks", "host_blocks")

    def _new_revision(self, isvc, dep: _Deployment, fingerprint: str) -> _Revision:
        runtime_cls, cfg = self._resolve(isvc)
        if (isvc.spec.predictor.gang is not None
                or any(k in cfg for k in self._ENGINE_KNOBS)
                or "role" in cfg or "disaggregation" in cfg):
            # validate the engine knobs HERE, inside the reconcile's
            # Failed-phase guard, where the revision config freezes: a
            # bad value (prefill_budget: -1, spec_k: -2, ...) otherwise
            # surfaces as N pods crash-looping through JaxJob restarts
            # (gang) or an in-process replica stuck Loading forever;
            # this way it is ONE Failed status with the message
            from .continuous import engine_kwargs

            zero_ok = ("prefill_budget", "spec_k", "block_size",
                       "num_blocks", "host_blocks")
            bad = {k: v for k, v in engine_kwargs(cfg).items()
                   if k in self._ENGINE_KNOBS
                   and v < (0 if k in zero_ok else 1)}
            if bad:
                raise ValueError(f"invalid engine knobs: {bad}")
            # migration/disaggregation knobs (ISSUE 8) freeze here too:
            # a bad role would otherwise be one ValueError per replica
            # process — crash-looping pods instead of ONE Failed status
            role = str(cfg.get("role", "mixed"))
            if role not in ("mixed", "prefill", "decode"):
                raise ValueError(
                    f"invalid engine knobs: role {role!r} "
                    "(mixed|prefill|decode)")
            if role != "mixed" and int(cfg.get("block_size", 0) or 0) <= 0:
                raise ValueError(
                    f"invalid engine knobs: role={role} requires the "
                    "paged pool (block_size > 0)")
            disagg = cfg.get("disaggregation")
            if disagg is not None:
                if not isinstance(disagg, dict):
                    raise ValueError(
                        "invalid engine knobs: disaggregation must be "
                        '{"prefill": n, "decode": m[, "wire": bool]}')
                if (int(disagg.get("prefill", 1)) < 1
                        or int(disagg.get("decode", 1)) < 1):
                    raise ValueError(
                        "invalid engine knobs: disaggregation needs "
                        ">= 1 replica per role")
                if int(cfg.get("block_size", 0) or 0) <= 0:
                    raise ValueError(
                        "invalid engine knobs: disaggregation requires "
                        "the paged pool (block_size > 0)")
        # traffic-plane knobs (ISSUE 9) freeze here too: a negative
        # rate or an unknown priority tier is ONE Failed status at
        # conf-freeze, not a replica exploding at load (the PR 4/7
        # convention); validate_qos is the one shared validator
        if cfg.get("qos") is not None:
            from .traffic import validate_qos

            try:
                validate_qos(cfg["qos"])
            except ValueError as e:
                raise ValueError(f"invalid engine knobs: {e}") from e
        # tenant maps validate even WITHOUT cfg qos: _sync_traffic
        # consumes them when the classes come from Profiles, and a
        # mistyped value would otherwise surface per-request at the
        # router door instead of as ONE Failed status here
        qt = cfg.get("qos_tenants")
        if qt is not None and not (
                isinstance(qt, dict)
                and all(isinstance(v, str) for v in qt.values())):
            raise ValueError(
                "invalid engine knobs: qos_tenants must map "
                "tenant -> class name")
        qtt = cfg.get("qos_tenant_tokens")
        if qtt is not None and not (
                isinstance(qtt, dict)
                and all(isinstance(v, str) for v in qtt.values())):
            raise ValueError(
                "invalid engine knobs: qos_tenant_tokens must map "
                "tenant -> bearer token string")
        ab = cfg.get("affinity_block")
        if ab is not None and int(ab) < 1:
            raise ValueError(
                f"invalid engine knobs: affinity_block {ab} (must be "
                ">= 1)")
        # failure-domain knobs (ISSUE 16) freeze here too: `domains`
        # maps domain name -> stripe weight (replicas are placed
        # round-robin across the weighted stripe, so spread is the
        # default); a mistyped map is ONE Failed status at conf-freeze,
        # not a router mis-labeling backends at the first outage
        doms = cfg.get("domains")
        if doms is not None:
            if not isinstance(doms, dict) or not doms:
                raise ValueError(
                    "invalid engine knobs: domains must be a non-empty "
                    "mapping of domain name -> stripe weight")
            for k, v in doms.items():
                if not isinstance(k, str) or not k:
                    raise ValueError(
                        "invalid engine knobs: domains keys must be "
                        f"non-empty strings (got {k!r})")
                if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                    raise ValueError(
                        f"invalid engine knobs: domains[{k!r}] {v!r} "
                        "(stripe weight must be an int >= 1)")
        # hierarchical KV / durable-session knobs (ISSUE 12) freeze
        # here too — the PR 4/7/8 convention: a mistyped tier config is
        # ONE Failed status, not a replica exploding at load
        if "host_blocks" in cfg and int(cfg.get("host_blocks") or 0) > 0 \
                and int(cfg.get("block_size", 0) or 0) <= 0:
            raise ValueError(
                "invalid engine knobs: host_blocks requires the paged "
                "pool (block_size > 0)")
        hw = cfg.get("host_watermark")
        if hw is not None:
            try:
                ok = 0.0 <= float(hw) <= 1.0
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"invalid engine knobs: host_watermark {hw!r} "
                    "(must be a number in [0, 1])")
        hib = cfg.get("hibernation")
        if hib is not None:
            if not isinstance(hib, dict) or not str(hib.get("root", "")):
                raise ValueError(
                    "invalid engine knobs: hibernation must be "
                    '{"root": dir[, "fsync": bool, "reap_idle_s": s, '
                    '"reap_interval_s": s]}')
            unknown = set(hib) - {"root", "fsync", "reap_idle_s",
                                  "reap_interval_s"}
            if unknown:
                raise ValueError(
                    f"invalid engine knobs: hibernation keys "
                    f"{sorted(unknown)} unknown")
            # idle-session reaper knobs (ISSUE 15 satellite): a zero or
            # negative idle clock would hibernate sessions mid-decode
            for k in ("reap_idle_s", "reap_interval_s"):
                if hib.get(k) is not None:
                    try:
                        ok = float(hib[k]) > 0
                    except (TypeError, ValueError):
                        ok = False
                    if not ok:
                        raise ValueError(
                            f"invalid engine knobs: hibernation.{k} "
                            f"{hib[k]!r} (must be a positive number)")
            if int(cfg.get("block_size", 0) or 0) <= 0:
                raise ValueError(
                    "invalid engine knobs: hibernation requires the "
                    "paged pool (block_size > 0): the spill wire "
                    "format is the block-granular export snapshot")
        # tracing knobs (ISSUE 13) freeze here too — the PR 4/7/8
        # convention: a sample rate of 7 or a zero ring is ONE Failed
        # status at conf-freeze, not a replica (and the router) failing
        # at load; validate_tracing is the one shared validator
        if cfg.get("tracing") is not None:
            from .trace import validate_tracing

            try:
                validate_tracing(cfg["tracing"])
            except ValueError as e:
                raise ValueError(f"invalid engine knobs: {e}") from e
        # predictive autoscaler knobs (ISSUE 15) freeze here too — the
        # PR 4/7/8 convention: inverted hysteresis bands or a negative
        # cooldown is ONE Failed status at conf-freeze, not a decision
        # loop misbehaving at 4 Hz; validate_autoscale is the one
        # shared validator
        if cfg.get("autoscale") is not None:
            from .autoscale import validate_autoscale

            try:
                validate_autoscale(cfg["autoscale"])
            except (TypeError, ValueError) as e:
                raise ValueError(f"invalid engine knobs: {e}") from e
        # program-artifact cache knobs freeze here too: a missing root or
        # a mistyped fsync flag is ONE Failed status at conf-freeze, not
        # every replica failing its warmup at load; validate_aot is the
        # one shared validator
        if cfg.get("aot") is not None:
            from .programs import validate_aot

            try:
                validate_aot(cfg["aot"])
            except (TypeError, ValueError) as e:
                raise ValueError(f"invalid engine knobs: {e}") from e
        pps = cfg.get("prefix_poll_s")
        if pps is not None:
            try:
                ok = float(pps) > 0
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"invalid engine knobs: prefix_poll_s {pps!r} "
                    "(must be a positive number)")
        # elastic resize knobs (ISSUE 10) freeze here too — the PR 4/7/8
        # convention: a mistyped min_degree is ONE Failed status, not N
        # crash-looping gang pods (or a supervisor exploding at runtime).
        # The STANDALONE degraded_deadline_s fallback validates as well:
        # _track_degraded float()s it on every 4 Hz pass
        sddl = cfg.get("degraded_deadline_s")
        if sddl is not None:
            try:
                ok = float(sddl) > 0
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"invalid engine knobs: degraded_deadline_s "
                    f"{sddl!r} (must be a positive number)")
        elastic = cfg.get("elastic")
        if elastic is not None:
            if not isinstance(elastic, dict):
                raise ValueError(
                    "invalid engine knobs: elastic must be "
                    '{"min_degree": n, "resize_deadline_s": s, '
                    '"degraded_deadline_s": s}')
            unknown = set(elastic) - {"min_degree", "resize_deadline_s",
                                      "degraded_deadline_s"}
            if unknown:
                raise ValueError(
                    f"invalid engine knobs: elastic keys {sorted(unknown)}")
            if int(elastic.get("min_degree", 1)) < 1:
                raise ValueError(
                    "invalid engine knobs: elastic.min_degree "
                    f"{elastic['min_degree']} (must be >= 1)")
            for k in ("resize_deadline_s", "degraded_deadline_s"):
                if k in elastic and float(elastic[k]) <= 0:
                    raise ValueError(
                        f"invalid engine knobs: elastic.{k} "
                        f"{elastic[k]} (must be > 0)")
            if int(cfg.get("block_size", 0) or 0) <= 0:
                raise ValueError(
                    "invalid engine knobs: elastic requires the paged "
                    "pool (block_size > 0) — the resize snapshot unit "
                    "is the KV block")
        dep.rev_counter += 1
        spec = isvc.spec.model_copy(deep=True)
        from .resize import degree_of

        n = degree_of(cfg.get("mesh_axes"))
        if spec.predictor.gang is None and n > 1:
            # one process drives one card: a predictor over N cards is a
            # one-host gang of N ranks
            from ..api.inference import GangSpec

            spec.predictor.gang = GangSpec(
                hosts=1, chips_per_host=n, mesh_axes=dict(cfg["mesh_axes"]))
        return _Revision(dep.rev_counter, fingerprint, spec, runtime_cls,
                         cfg)

    def reconcile(self, namespace: str, name: str) -> Optional[Result]:
        key = f"{namespace}/{name}"
        isvc = self.store.try_get(KIND_INFERENCE_SERVICE, name, namespace)
        if isvc is None:
            with self._lock:
                dep = self._deployments.pop(key, None)
            if dep:
                self._teardown_deployment(dep)
            return None
        assert isinstance(isvc, InferenceService)

        with self._lock:
            dep = self._deployments.setdefault(key, _Deployment())
        if dep.router is None:
            dep.router = Router(activate=lambda: self._request_scale_up(key))
            self._set_status(isvc, phase=InferenceServicePhase.LOADING,
                             message="starting predictor")

        fingerprint = self._fingerprint(isvc.spec)
        pct = isvc.spec.canary_traffic_percent
        try:
            if dep.stable is None:
                dep.stable = self._new_revision(isvc, dep, fingerprint)
            elif fingerprint != dep.stable.fingerprint:
                if pct is not None and pct < 100:
                    # canary: new revision serves pct%, stable keeps the rest
                    if dep.canary is None or dep.canary.fingerprint != fingerprint:
                        if dep.canary is not None:
                            self._drain_revision(isvc, dep.canary)
                        dep.canary = self._new_revision(isvc, dep, fingerprint)
                        self.emit_event(
                            isvc, "CanaryDeployed",
                            f"revision {dep.canary.rev} at {pct}%")
                elif dep.canary is not None and dep.canary.fingerprint == fingerprint:
                    # promote: the canary becomes the stable revision; the
                    # old stable drains (no cold start — the promoted
                    # replicas are already serving)
                    old = dep.stable
                    dep.stable, dep.canary = dep.canary, None
                    self._drain_revision(isvc, old)
                    self.emit_event(
                        isvc, "CanaryPromoted", f"revision {dep.stable.rev}")
                else:
                    # full rollout without a canary phase
                    old = dep.stable
                    dep.stable = self._new_revision(isvc, dep, fingerprint)
                    self._drain_revision(isvc, old)
            elif dep.canary is not None:
                # spec reverted to the stable revision: roll the canary back
                rolled = dep.canary
                dep.canary = None
                self._drain_revision(isvc, rolled)
                self.emit_event(
                    isvc, "CanaryRolledBack", f"revision {rolled.rev}")
        except Exception as e:  # noqa: BLE001 — config errors -> Failed phase
            self._set_status(
                isvc, phase=InferenceServicePhase.FAILED,
                message=f"{type(e).__name__}: {e}")
            return None

        dep.pct = max(0, min(100, pct or 0)) if dep.canary is not None else 0
        # predictive autoscaler (ISSUE 15): build/tick BEFORE the
        # scaling pass so this reconcile applies the tick's verdict
        self._sync_autoscaler(isvc, dep)
        for rev in dep.revisions:
            desired = self._desired_replicas(dep, rev)
            before = list(rev.predictors)
            self._scale_predictors(isvc, dep, rev, desired)
            if dep.autoscaler is not None and rev is dep.stable:
                # pre-warm placed replicas from a hot peer's registry
                # BEFORE _wire exposes them to traffic (the r12/r16
                # residual): first admissions hit a warm prefix cache
                for s in rev.predictors:
                    if s not in before:
                        try:
                            self._prewarm_replica(isvc, rev, s)
                        except Exception as e:  # noqa: BLE001 — warm
                            # cache is an optimization, never a gate
                            log.debug("replica pre-warm failed: %s", e)
        self._measure_cold_start(dep)
        self._wire(isvc, dep)
        self._sync_traffic(dep)

        def _up(rev: _Revision) -> bool:
            return any(getattr(s, "ready", True) for s in rev.predictors)

        stable_ready = (
            _up(dep.stable) or dep.stable.spec.predictor.min_replicas == 0)
        canary_ready = dep.canary is None or _up(dep.canary)
        ready = stable_ready and canary_ready
        # Degraded: serving (some replica answers) but below strength — a
        # gang re-forming after a member loss, say.  The router already
        # routes around the non-ready replicas (_wire_revision filters);
        # the phase makes the reduced capacity observable instead of
        # masquerading as fully Ready.
        total_preds = sum(len(r.predictors) for r in dep.revisions)
        ready_preds = sum(
            1 for r in dep.revisions for s in r.predictors
            if getattr(s, "ready", True))
        degraded = ready and ready_preds < total_preds
        self._track_degraded(isvc, dep, degraded)
        if degraded:
            phase = InferenceServicePhase.DEGRADED
        elif ready:
            phase = InferenceServicePhase.READY
        else:
            phase = InferenceServicePhase.LOADING
        stable_spec = dep.stable.spec.model_dump(mode="json")
        stable_spec.pop("canary_traffic_percent", None)
        self._set_status(
            isvc,
            phase=phase,
            url=dep.router.url,
            active_replicas=sum(len(r.predictors) for r in dep.revisions),
            message=(f"{total_preds - ready_preds}/{total_preds} replicas "
                     "re-forming; routing to healthy replicas"
                     if degraded else ""),
            stable_revision=dep.stable.rev,
            canary_revision=dep.canary.rev if dep.canary else None,
            canary_traffic=dep.pct,
            stable_spec=stable_spec,
        )
        # periodic requeue drives the autoscaler loop
        return Result(requeue_after=0.25)

    # -- degraded deadline / elastic escalation (ISSUE 10) ----------------

    def _track_degraded(self, isvc, dep: _Deployment,
                        degraded: bool) -> None:
        """Bound the Degraded phase.  Degraded used to be UNBOUNDED — a
        gang that lost a member permanently parked there forever,
        waiting for a re-form a dead chip can never grant.  With
        ``degraded_deadline_s`` configured (standalone or inside the
        ``elastic`` family), a deployment stuck Degraded past the
        deadline emits a structured ``DegradedTimeout`` event; with
        ``elastic`` configured, it additionally escalates into the
        shrink path — re-placing the degraded gang at the surviving
        degree (floored at ``elastic.min_degree``) and emitting
        ``GangResized`` instead of waiting forever."""
        if dep.stable is None:
            return
        if not degraded:
            dep.degraded_since = None
            dep.degraded_escalated = False
            return
        now = time.monotonic()
        if dep.degraded_since is None:
            dep.degraded_since = now
            return
        cfg = dep.stable.cfg
        elastic = cfg.get("elastic") or {}
        ddl = elastic.get("degraded_deadline_s",
                          cfg.get("degraded_deadline_s"))
        if ddl is None or dep.degraded_escalated:
            return
        try:
            ddl = float(ddl)
        except (TypeError, ValueError):
            return  # conf-freeze rejects this; a hand-rolled config
            # must not turn every 4 Hz reconcile into a raise
        waited = now - dep.degraded_since
        if waited <= ddl:
            return
        dep.degraded_escalated = True
        self.emit_event(
            isvc, "DegradedTimeout",
            f"degraded for {waited:.1f}s (deadline {ddl:.1f}s)",
            type_="Warning")
        if elastic:
            self._escalate_shrink(isvc, dep, elastic)

    def _escalate_shrink(self, isvc, dep: _Deployment,
                         elastic: dict) -> None:
        """Shrink-to-survive at the placement layer: a gang stuck
        Degraded past the deadline is re-placed with one fewer host and
        its TP degree scaled to the surviving shape.  (The in-gang
        weight/KV repartition path — serving/resize.py — handles the
        live-conversation case inside serve_main; this controller path
        is the escalate-or-give-up policy when the gang's own
        supervisor could not, e.g. a member lost before the gang ever
        formed.)"""
        from .resize import degree_of

        min_degree = int(elastic.get("min_degree", 1))
        for rev in dep.revisions:
            for i, handle in enumerate(list(rev.predictors)):
                gang = getattr(handle, "gang", None)
                if gang is None or getattr(handle, "ready", False):
                    continue
                hosts = int(gang.hosts)
                if hosts <= 1:
                    continue
                degree = degree_of(gang.mesh_axes)
                new_hosts = hosts - 1
                # compute the ACTUAL surviving mesh first and gate on
                # its product — gating on degree*new_hosts//hosts could
                # pass a min_degree the placed mesh then violates (the
                # scaling only touches one axis).  Scale the largest
                # axis (TP rides "model" by convention); an uneven
                # split means no clean surviving shape — skip rather
                # than place a mesh whose pods crash-loop (model-dim
                # feasibility itself surfaces at gang start, bounded by
                # backoff_limit; the in-gang resize path checks it at
                # plan time).
                axes = dict(gang.mesh_axes or {})
                if axes:
                    key = max(axes, key=lambda k: axes[k])
                    if (axes[key] * new_hosts) % hosts:
                        self.emit_event(
                            isvc, "ResizeSkipped",
                            f"mesh axis {key}={axes[key]} does not "
                            f"scale evenly to {new_hosts}/{hosts} "
                            "hosts; keeping the degraded gang",
                            type_="Warning")
                        continue
                    axes[key] = max(1, axes[key] * new_hosts // hosts)
                new_degree = degree_of(axes)
                if new_degree < min_degree:
                    self.emit_event(
                        isvc, "ResizeSkipped",
                        f"surviving degree {new_degree} < min_degree "
                        f"{min_degree}; keeping {hosts}-host gang",
                        type_="Warning")
                    continue
                new_gang = gang.model_copy(
                    update={"hosts": new_hosts, "mesh_axes": axes})
                handle.stop()
                rev.gang_counter += 1
                replacement = _GangPredictor(
                    self.store, isvc, rev.rev, new_gang, rev.cfg,
                    ordinal=rev.gang_counter - 1)
                rev.predictors[i] = replacement
                self.emit_event(
                    isvc, "GangResized",
                    f"degraded gang re-placed at the surviving shape: "
                    f"{hosts} hosts / TP {degree} -> {new_hosts} hosts "
                    f"/ TP {new_degree}")
                self._wire(isvc, dep)
                return

    # -- scaling ----------------------------------------------------------

    def _desired_replicas(self, dep: _Deployment, rev: _Revision) -> int:
        # gang replicas use the SAME policy as in-process ones: the unit
        # is just N host processes instead of one server, and inflight
        # concurrency comes from rank 0's /metrics probe (_GangMetrics)
        pred = rev.spec.predictor
        n = len(rev.predictors)
        # during a canary split BOTH revisions must hold the road: a
        # revision idling to zero would silently forfeit its traffic
        # share (the router drops empty pools, and with the other pool
        # still serving, the activator never fires to bring it back)
        floor = max(pred.min_replicas, 1 if dep.canary is not None else 0)
        if pred.gang is not None:
            # gangs do not scale to zero: cold start is a full JaxJob
            # placement + distributed init + model load, far beyond the
            # activator's wait — an idle-scaled gang would answer its
            # next caller with timeouts
            floor = max(floor, 1)
        if (dep.autoscaler is not None and rev is dep.stable
                and pred.gang is None):
            # predictive loop (ISSUE 15): the tick's replica actuators
            # wrote autoscale_desired and this branch REPLACES the
            # reactive idle clock below.  The activator's wake still
            # wins — demand at the door between ticks must not wait a
            # loop interval (a gated wake decision leaves
            # wants_scale_up set for exactly this backstop).
            if dep.wants_scale_up:
                dep.wants_scale_up = False
                dep.autoscale_desired = max(
                    dep.autoscale_desired or 0, 1, floor)
            target = (n if dep.autoscale_desired is None
                      else dep.autoscale_desired)
            return max(min(target, pred.max_replicas), floor)
        if dep.wants_scale_up and rev is dep.stable:
            dep.wants_scale_up = False
            return max(n, 1, floor)
        if n and n < pred.max_replicas:
            # only probe concurrency when another replica could actually
            # be added (the gang probe is an HTTP fetch; pointless work
            # stalls the shared reconcile worker)
            inflight = sum(s.metrics.inflight for s in rev.predictors)
            if inflight / n > pred.scale_target_concurrency:
                return min(n + 1, pred.max_replicas)
        idle = (
            dep.router is not None
            and time.time() - dep.router.last_request_time > SCALE_IDLE_SECONDS
        )
        if idle and n > floor:
            return max(n - 1, floor)
        return max(n, floor)

    @staticmethod
    def _domain_stripe(doms: dict) -> list[str]:
        """Expand the ``domains`` name -> stripe-weight map into an
        INTERLEAVED placement stripe (smooth WRR over sorted names, the
        router's own algorithm) — ``{"a": 2, "b": 1}`` yields
        ``[a, b, a]``, not ``[a, a, b]``, so the first two replicas
        land in different domains and spread is the default, not an
        afterthought."""
        names = sorted(doms)
        weights = {n: max(1, int(doms[n])) for n in names}
        total = sum(weights.values())
        cur = {n: 0 for n in names}
        stripe: list[str] = []
        for _ in range(total):
            for n in names:
                cur[n] += weights[n]
            best = max(names, key=lambda n: cur[n])
            cur[best] -= total
            stripe.append(best)
        return stripe

    def _assign_domain(self, rev: _Revision) -> str:
        """Failure domain for the NEXT replica of ``rev``: the least-
        filled domain relative to its stripe weight (ties: stripe
        order) — a replica placed after an outage grows back into the
        emptied domain first.  '' when ``domains`` is unconfigured
        (the single implicit domain)."""
        doms = rev.cfg.get("domains")
        if not isinstance(doms, dict) or not doms:
            return ""
        stripe = self._domain_stripe(doms)
        counts = {d: 0 for d in stripe}
        for s in rev.predictors:
            d = getattr(s, "domain", "")
            if d in counts:
                counts[d] += 1
        return min(stripe, key=lambda d: (counts[d] / stripe.count(d),
                                          stripe.index(d)))

    def _scale_predictors(
        self, isvc, dep: _Deployment, rev: _Revision, desired: int
    ) -> bool:
        gang = rev.spec.predictor.gang
        if gang is not None:
            changed = False
            while len(rev.predictors) < desired:
                rev.gang_counter += 1
                handle = _GangPredictor(
                    self.store, isvc, rev.rev, gang, rev.cfg,
                    ordinal=rev.gang_counter - 1)
                handle.domain = self._assign_domain(rev)
                rev.predictors.append(handle)
                self.emit_event(
                    isvc, "GangPlaced",
                    f"rev {rev.rev} JaxJob {handle.job_name} "
                    f"x{gang.hosts} hosts")
                changed = True
            while len(rev.predictors) > desired:
                handle = rev.predictors.pop()
                self._wire(isvc, dep)  # drop from router before deleting
                # same drain contract as in-process replicas: in-flight
                # requests (visible via the rank-0 metrics probe) finish
                # before the JaxJob is deleted
                self._drain_stop_server(isvc, handle)
                changed = True
            return changed
        changed = False
        while len(rev.predictors) < desired:
            server = ModelServer()
            model = rev.runtime_cls(isvc.metadata.name, rev.cfg)
            pred = rev.spec.predictor
            server.register(
                model,
                batch_max_size=pred.batch_max_size,
                batch_timeout_ms=pred.batch_timeout_ms,
            )
            if pred.logger is not None:
                # payload logging (kserve agent/logger analog)
                server.set_logger(
                    pred.logger.url, pred.logger.mode,
                    service=isvc.metadata.name)
            server.start()
            server.domain = self._assign_domain(rev)
            rev.predictors.append(server)
            self.emit_event(
                isvc, "ReplicaStarted", f"rev {rev.rev} {server.url}")
            changed = True
        while len(rev.predictors) > desired:
            server = rev.predictors.pop()
            self._wire(isvc, dep)  # drop from router before stopping
            # migrate-then-retire (ISSUE 8): live paged conversations
            # move to a surviving replica of the SAME revision instead
            # of racing the 5s drain deadline — a scale-down (or a node
            # making its replica unhealthy) stops costing long
            # conversations their KV.  Runs INSIDE the async drain
            # thread: per-sequence migration ops carry 60s timeouts,
            # and a wedged replica must not stall the shared reconcile
            # worker (the same invariant the bounded drain holds).
            self._drain_stop_server(isvc, server, migrate_rev=rev)
            changed = True
        return changed

    def _migrate_replica_conversations(self, isvc, rev: _Revision,
                                       server) -> int:
        """Drain a retiring in-process replica's live conversations onto
        a ready peer replica via live paged-KV migration.  The request
        handles are shared in-process, so streams in flight keep reading
        the same objects — the front server re-targets, clients never
        reconnect.  Best-effort: with no paged peer the replica falls
        back to the classic bounded drain (conversations finish or are
        cut at the deadline)."""
        engines = getattr(server, "engines", None)
        if engines is None:
            return 0  # gang handles drain via JaxJob semantics
        peers = [s for s in rev.predictors
                 if s is not server and getattr(s, "ready", True)
                 and getattr(s, "engines", None) is not None]
        moved_total = 0
        for name, eng in engines().items():
            if not getattr(eng, "paged", False):
                continue
            for peer in peers:
                dst = peer.engines().get(name)
                if dst is None or not getattr(dst, "paged", False):
                    continue
                from .continuous import migrate_live_sequences

                moved, failed = migrate_live_sequences(eng, dst)
                moved_total += moved
                if failed == 0:
                    break
        if moved_total:
            self.emit_event(
                isvc, "ConversationsMigrated",
                f"{moved_total} live conversations migrated off a "
                "retiring replica")
        return moved_total

    def _drain_stop_server(self, isvc, server: ModelServer,
                           migrate_rev: Optional[_Revision] = None) -> None:
        """Stop a replica after its in-flight requests finish.

        Drain runs asynchronously: requests already dispatched to this
        replica (or queued in its micro-batcher) finish rather than
        surfacing as 5xx, and the reconcile worker is not blocked for the
        (bounded) drain period.  The initial settle sleep covers requests
        the router already picked this backend for but whose handler has
        not yet reached _dispatch's inflight increment.  With
        ``migrate_rev`` set, live paged conversations first migrate to a
        ready peer of that revision (ISSUE 8) — on this thread, for the
        same reason the drain itself is here."""
        def _drain_stop(srv=server, svc=isvc, rev=migrate_rev):
            time.sleep(0.1)
            if rev is not None:
                try:
                    self._migrate_replica_conversations(svc, rev, srv)
                except Exception as e:  # noqa: BLE001 — migration is
                    # best-effort; the bounded drain below still runs
                    log.debug("drain migration failed: %s", e)
            deadline = time.monotonic() + 5.0
            while srv.metrics.inflight > 0 and time.monotonic() < deadline:
                time.sleep(0.02)
            srv.stop()
            self.emit_event(svc, "ReplicaStopped", srv.url)

        threading.Thread(
            target=_drain_stop, name="replica-drain", daemon=True
        ).start()

    def _drain_revision(self, isvc, rev: _Revision) -> None:
        """Drain-and-stop every server of a retired revision (promote,
        rollback, or full replacement); the router was already rewired."""
        for server in rev.servers:
            self._drain_stop_server(isvc, server)
        rev.predictors.clear()
        rev.transformers.clear()
        rev.explainers.clear()

    def _wire_revision(self, isvc, rev: _Revision) -> tuple[list[str], list[str]]:
        """Build one revision's serving tier; returns (data-plane urls,
        explain urls) — the transformer fronts the predictors when one is
        specified, the ``:explain`` verb routes to the explainer component
        [upstream: kserve routes verbs per component]."""
        # a gang predictor exists before its rank-0 frontend answers; only
        # READY predictors take traffic (in-process ModelServers are ready
        # by construction)
        ready_predictors = [
            s for s in rev.predictors if getattr(s, "ready", True)]
        explain_urls: list[str] = []
        espec = rev.spec.explainer
        if espec and espec.handler:
            if not rev.explainers and rev.predictors:
                cls = resolve_class(espec.handler)
                server = ModelServer()
                model = cls(isvc.metadata.name, {
                    **dict(espec.config),
                    "predictor_urls": [s.url for s in ready_predictors],
                    "model_name": isvc.metadata.name,
                })
                server.register(model, batch_max_size=1, batch_timeout_ms=0.0)
                server.start()
                rev.explainers.append(server)
            if rev.explainers:
                urls = [s.url for s in ready_predictors]
                for es in rev.explainers:
                    for m in es.models().values():
                        if hasattr(m, "predictor_urls"):
                            m.predictor_urls = list(urls)
                # with zero predictors, :explain must fall through to the
                # activator (empty pool -> scale-from-zero) instead of
                # reaching an explainer that has nothing to call
                explain_urls = [s.url for s in rev.explainers] if urls else []
        tspec = rev.spec.transformer
        if tspec and tspec.handler:
            if not rev.transformers and rev.predictors:
                cls = resolve_class(tspec.handler)
                cfg = dict(tspec.config)
                cfg["predictor_url"] = None  # filled per request via backends
                server = ModelServer()
                model = cls(isvc.metadata.name, {
                    **cfg, "predictor_urls": [s.url for s in ready_predictors],
                    "model_name": isvc.metadata.name,
                })
                server.register(model, batch_max_size=tspec.batch_max_size,
                                batch_timeout_ms=tspec.batch_timeout_ms)
                server.start()
                rev.transformers.append(server)
            if rev.transformers:
                # keep the transformer's predictor list current: predictors
                # churn on every scale event and ports never come back
                urls = [s.url for s in ready_predictors]
                for ts in rev.transformers:
                    for m in ts.models().values():
                        if hasattr(m, "predictor_urls"):
                            m.predictor_urls = list(urls)
                return [s.url for s in rev.transformers], explain_urls
        return [s.url for s in ready_predictors], explain_urls

    def _wire(self, isvc, dep: _Deployment) -> None:
        """Point the router at every live revision, weighted by the canary
        split (the virtualservice-weight analog)."""
        if dep.router is None or dep.stable is None:
            return
        stable_urls, stable_explain = self._wire_revision(isvc, dep.stable)
        pools = [(stable_urls, 100 - dep.pct)]
        explain_pools = [(stable_explain, 100 - dep.pct)]
        if dep.canary is not None:
            canary_urls, canary_explain = self._wire_revision(isvc, dep.canary)
            pools.append((canary_urls, dep.pct))
            explain_pools.append((canary_explain, dep.pct))
        dep.router.set_weighted_backends(pools)
        dep.router.set_weighted_explain_backends(explain_pools)
        # failure-domain labels ride the same wiring pass (ISSUE 16):
        # the router's outage detection and re-route spreading key off
        # this map; with ``domains`` unset it stays empty and the
        # router behaves exactly as before (single implicit domain)
        mapping: dict[str, str] = {}
        for r in dep.revisions:
            for s in r.predictors:
                d = getattr(s, "domain", "")
                u = getattr(s, "url", None)
                if d and u:
                    mapping[u] = d
        dep.router.set_domains(mapping)

    def _sync_traffic(self, dep: _Deployment) -> None:
        """Keep the router's traffic plane (ISSUE 9) in sync with the
        stable revision's ``qos``/affinity knobs MERGED with every
        Profile carrying ``spec.qos`` — Profiles are the tenants, so a
        tenant's rate/priority contract follows it to every ISvc
        front door.  The plane rebuilds only when the merged config
        changes (fingerprinted): counters and the affinity map survive
        the 4 Hz reconcile loop."""
        if dep.router is None or dep.stable is None:
            return
        cfg = dep.stable.cfg
        # request tracing (ISSUE 13): the router is the path's root
        # sampling decision; the same cfg knob builds the replica-side
        # tracer inside TextGenerator.load.  Validated at conf-freeze;
        # a racing bad edit here must not stall the reconcile loop.
        try:
            dep.router.configure_tracing(cfg.get("tracing"))
        except ValueError as e:
            log.debug("router tracing config rejected: %s", e)
        if cfg.get("prefix_poll_s"):
            # cluster block-registry poller (ISSUE 13 satellite)
            try:
                dep.router.start_prefix_poller(float(cfg["prefix_poll_s"]))
            except (TypeError, ValueError) as e:
                log.debug("prefix poller config rejected: %s", e)
        qos = dict(cfg.get("qos") or {})
        tenants = dict(cfg.get("qos_tenants") or {})
        from ..api.platform import KIND_PROFILE

        from .traffic import TrafficPlane, validate_qos

        tokens: dict[str, str] = {}
        for prof in self.store.list(KIND_PROFILE):
            pq = getattr(prof.spec, "qos", None)
            if not pq:
                continue
            if prof.spec.api_token:
                # a credentialed Profile's class may only be claimed
                # with its Bearer token (plane.authenticate at the
                # door) — QoS classes are identity-scoped privilege
                tokens[prof.metadata.name] = prof.spec.api_token
            if prof.metadata.name in qos:
                continue  # explicit ISvc config wins over the Profile
            try:
                validate_qos({prof.metadata.name: pq})
            except (TypeError, ValueError):
                continue  # the Profile controller reports it (Failed);
                # _sync_traffic runs OUTSIDE reconcile's Failed-phase
                # guard, so one bad Profile must never break every
                # ISvc's status/scaling loop
            qos[prof.metadata.name] = dict(pq)
        # affinity_block doubles as the affinity-only opt-in: a config
        # with no qos classes but an explicit affinity granularity
        # still wants the prefix-aware router
        enabled = bool(qos) or cfg.get("affinity_block") is not None
        if not enabled:
            if dep.traffic_fp is not None:
                dep.router.set_traffic(None)
                dep.traffic_fp = None
            return
        fp = json.dumps(
            {"qos": qos, "tenants": tenants, "tokens": tokens,
             "block": cfg.get("affinity_block", 32)},
            sort_keys=True, default=str)
        if fp == dep.traffic_fp:
            return
        try:
            plane = TrafficPlane(
                qos, tenants=tenants, tenant_tokens=tokens,
                affinity_block=int(cfg.get("affinity_block", 32)))
        except (TypeError, ValueError) as e:
            # cfg qos was validated at conf-freeze; this can only be a
            # racing Profile edit — keep the previous plane
            log.debug("traffic plane rebuild rejected: %s", e)
            return
        dep.router.set_traffic(plane)
        dep.traffic_fp = fp

    def _request_scale_up(self, key: str) -> None:
        with self._lock:
            dep = self._deployments.get(key)
        if dep is not None:
            dep.wants_scale_up = True
        self.queue.add(key)

    # -- predictive autoscaler (ISSUE 15) ---------------------------------

    def _sync_autoscaler(self, isvc, dep: _Deployment) -> None:
        """Keep the deployment's :class:`~.autoscale.ClusterAutoscaler`
        in sync with the stable revision's ``autoscale:`` knob family
        (fingerprinted like the traffic plane — predictor window,
        cooldown clocks and retry state survive the 4 Hz reconcile),
        then run one tick.  The tick runs HERE, on the reconcile
        worker: this controller is single-worker precisely because
        reconciles mutate live deployment state, and the decision
        loop's actuators (victim ordering, tier rebalance, engine
        resize) are exactly such mutations — a free-running thread
        would race every reconcile.  ``ClusterAutoscaler.start()``
        remains the threaded mode for the bench/standalone path."""
        if dep.stable is None:
            return
        spec = dep.stable.cfg.get("autoscale")
        if spec is None:
            if dep.autoscaler is not None:
                dep.autoscaler = None
                dep.autoscale_fp = None
                dep.autoscale_desired = None
                dep.cold_start_t0 = None
            return
        fp = json.dumps(spec, sort_keys=True, default=str)
        if fp != dep.autoscale_fp:
            from .autoscale import AutoscalePolicy, ClusterAutoscaler

            try:
                policy = AutoscalePolicy.from_config(dict(spec))
            except (TypeError, ValueError) as e:
                # conf-freeze validated this; only a racing edit of a
                # live cfg dict can land here — keep the previous loop
                log.debug("autoscale config rejected: %s", e)
                return
            dep.autoscaler = ClusterAutoscaler(
                policy,
                sensors=lambda: self._autoscale_signals(dep),
                actuators=self._autoscale_actuators(isvc, dep))
            dep.autoscale_fp = fp
            dep.autoscale_desired = None
            from .autoscale import ConcurrencyGate
            dep.thaw_gate = (
                ConcurrencyGate(int(policy.thaw_concurrency))
                if policy.thaw_concurrency > 0 else None)
        # attach the thaw cap to every live engine each pass — engines
        # churn with replica placement, the gate survives via dep
        if dep.thaw_gate is not None and dep.stable is not None:
            for s in dep.stable.predictors:
                engines = getattr(s, "engines", None)
                if engines is None:
                    continue
                for eng in engines().values():
                    eng.thaw_gate = dep.thaw_gate
        dec = dep.autoscaler.tick()
        if dec.action != "none":
            self.emit_event(
                isvc, "AutoscaleDecision", f"{dec.action}: {dec.reason}")

    def _autoscale_signals(self, dep: _Deployment) -> dict:
        """One sensor snapshot for ``autoscale.decide`` — in-process
        stats reads only (plane counters, tracer summary, engine
        ``stats()``/``tier_pressure()``, the router idle clock).  No
        blocking HTTP: this runs on the shared reconcile worker."""
        rev = dep.stable
        pol = dep.autoscaler.policy
        preds = [] if rev is None else list(rev.predictors)
        spec = rev.spec.predictor if rev is not None else None
        n = len(preds)
        inflight = 0
        live = 0.0
        free_ratio = 1.0
        degree = 0
        pp = dp = 0.0
        pn = dn = 0
        for s in preds:
            try:
                inflight += int(s.metrics.inflight)
            except (AttributeError, TypeError):
                pass
            # a serving gang's degree is on its handle (its engines live
            # in its pods)
            degree = max(degree, int(getattr(s, "tp_degree", 0) or 0))
            engines = getattr(s, "engines", None)
            if engines is None:
                continue
            for eng in engines().values():
                tier = getattr(eng, "tier_pressure", None)
                if tier is not None:
                    t = tier()
                    pp += t["prefill_pressure"]
                    dp += t["decode_pressure"]
                    pn += t["prefill_replicas"]
                    dn += t["decode_replicas"]
                st = eng.stats()
                live += float(st.get("slots_live", 0) or 0)
                total = float(st.get("kv_blocks_total", 0) or 0)
                if total > 0:
                    free_ratio = min(
                        free_ratio,
                        float(st.get("kv_blocks_free", 0)) / total)
                mesh = getattr(eng, "mesh", None)
                degree = max(degree,
                             int(mesh.size) if mesh is not None else 1)
        now = time.monotonic()
        shed_rate = 0.0
        plane = dep.router.traffic if dep.router is not None else None
        if plane is not None:
            total_sheds = sum(
                int(c.get("qos_shed_total", 0))
                for c in plane.stats().get("classes", {}).values())
            t0, s0 = dep.shed_mark
            if t0 and now > t0:
                shed_rate = max(0.0, (total_sheds - s0) / (now - t0))
            dep.shed_mark = (now, float(total_sheds))
        qwait = 0.0
        tracer = dep.router.tracer if dep.router is not None else None
        if tracer is not None:
            summary = tracer.sink.summary(pol.window_s)
            for c in summary.get("classes", {}).values():
                if c.get("traces"):
                    qwait = max(qwait,
                                c["queue_wait_sum_s"] / c["traces"])
        idle_s = 0.0
        if dep.router is not None and dep.router.last_request_time:
            idle_s = max(0.0, time.time()
                         - dep.router.last_request_time)
        # Correlated-failure sensor (ISSUE 16): fraction of the
        # router's backend pool whose health circuit is not closed.
        # Feeds the emergency surge rule in ``autoscale.decide`` —
        # absent circuits (no router yet) read as a healthy 0.0.
        unhealthy = 0.0
        if dep.router is not None:
            urls = dep.router.backends()
            if urls:
                bad = sum(1 for u in urls
                          if dep.router.health.state(u) != "closed")
                unhealthy = bad / len(urls)
        return {
            "replicas": n,
            "min_replicas": spec.min_replicas if spec else 0,
            "max_replicas": spec.max_replicas if spec else max(n, 1),
            "util": (inflight / max(n, 1)
                     / max(pol.target_concurrency, 1e-9)),
            "shed_rate": shed_rate,
            "queue_wait_s": qwait,
            "free_block_ratio": free_ratio,
            "idle_s": idle_s,
            "live": live,
            "pending": 1.0 if dep.wants_scale_up else 0.0,
            "degree": degree,
            "prefill_pressure": pp,
            "decode_pressure": dp,
            "prefill_replicas": pn,
            "decode_replicas": dn,
            "unhealthy_frac": unhealthy,
        }

    def _autoscale_actuators(self, isvc, dep: _Deployment) -> dict:
        """The controller's actuator channel map.  Replica channels
        write ``autoscale_desired`` — the SAME ``_scale_predictors``
        machinery the reactive path uses then applies it this pass, so
        scale-down stays the lossless migrate-then-retire drain and
        the canary/gang invariants hold unchanged."""

        def _replica_up(dec) -> None:
            rev = dep.stable
            cur = 0 if rev is None else len(rev.predictors)
            if cur == 0 and dep.cold_start_t0 is None:
                dep.cold_start_t0 = time.monotonic()
            dep.autoscale_desired = max(
                int(dec.replicas if dec.replicas is not None
                    else cur + 1), 1)
            dep.wants_scale_up = False

        def _replica_down(dec) -> None:
            rev = dep.stable
            if rev is None or len(rev.predictors) <= 1:
                raise RuntimeError("no replica to retire")
            self._order_scale_down_victim(dep, rev)
            dep.autoscale_desired = int(
                dec.replicas if dec.replicas is not None
                else len(rev.predictors) - 1)

        def _zero(dec) -> None:
            self._hibernate_for_zero(isvc, dep)
            dep.autoscale_desired = 0

        def _resize(dec) -> None:
            self._resize_replicas_to_degree(isvc, dep, int(dec.degree))

        def _tier(dec) -> None:
            rev = dep.stable
            for s in ([] if rev is None else rev.predictors):
                engines = getattr(s, "engines", None)
                if engines is None:
                    continue
                for eng in engines().values():
                    fn = getattr(eng, "rebalance", None)
                    if fn is None:
                        continue
                    npools = len(eng.pools)
                    fn(max(1, min(int(dec.prefill), npools - 1)))
                    return
            raise RuntimeError("no disaggregated pool to rebalance")

        return {"replica_up": _replica_up, "replica_down": _replica_down,
                "zero": _zero, "resize": _resize, "tier": _tier}

    def _order_scale_down_victim(self, dep: _Deployment,
                                 rev: _Revision) -> None:
        """Reorder ``rev.predictors`` so the least session/prefix-heat
        replica sits LAST — ``_scale_predictors`` pops from the tail,
        so the victim is the replica whose retirement invalidates the
        least cluster KV reuse (poller prefix census) and migrates the
        fewest live conversations.  Domain-spread guard (ISSUE 16):
        a candidate whose retirement would EMPTY its failure domain
        while another domain still holds >= 2 replicas is excluded —
        scale-down must never trade away the last replica of a domain
        the placement stripe deliberately spread into.  With
        ``domains`` unset every replica maps to the implicit ""
        domain and the guard is a no-op."""
        preds = rev.predictors
        if len(preds) < 2:
            return
        poller = (dep.router.prefix_poller
                  if dep.router is not None else None)
        heat = poller.heat_by_backend() if poller is not None else {}

        counts: dict[str, int] = {}
        for s in preds:
            counts[getattr(s, "domain", "")] = counts.get(
                getattr(s, "domain", ""), 0) + 1

        def allowed(s) -> bool:
            d = getattr(s, "domain", "")
            if counts.get(d, 0) > 1:
                return True
            # removing s empties domain d — only allowed when no OTHER
            # domain would keep >= 2 replicas (i.e. spread is already
            # as thin as it can be)
            return not any(c >= 2 for dd, c in counts.items()
                           if dd != d)

        candidates = [s for s in preds if allowed(s)] or preds

        def score(s) -> tuple:
            h = int(heat.get(getattr(s, "url", ""), 0))
            live = 0
            engines = getattr(s, "engines", None)
            if engines is not None:
                for eng in engines().values():
                    try:
                        live += int(eng.stats().get("slots_live", 0))
                    except (AttributeError, TypeError, RuntimeError):
                        pass
            return (h, live)

        victim = min(candidates, key=score)
        if preds[-1] is not victim:
            preds.remove(victim)
            preds.append(victim)

    def _prewarm_replica(self, isvc, rev: _Revision, server) -> int:
        """Warm a freshly placed replica's prefix registry from a hot
        peer before it takes traffic: registry-census the peer
        (``prefix_census``), export its block content
        (``export_prefix_blocks`` — the in-process ``kv_fetch``) and
        ``install_prefix`` into the new pool.  Bounded and best-effort:
        a cold replica that serves its first request un-warmed just
        prefills, exactly as before this path existed."""
        engines = getattr(server, "engines", None)
        if engines is None:
            return 0  # gang replicas warm through serve_main
        peers = [s for s in rev.predictors
                 if s is not server and getattr(s, "ready", True)
                 and getattr(s, "engines", None) is not None]
        installed = 0
        with self._prewarm_gate:
            for name, eng in engines().items():
                if not getattr(eng, "paged", False):
                    continue
                for peer in peers:
                    src = peer.engines().get(name)
                    if src is None or not getattr(src, "paged", False):
                        continue
                    try:
                        census = src.prefix_census(timeout=10.0)
                    except (RuntimeError, TimeoutError):
                        continue
                    # deepest records first; cap the copy budget so
                    # warm-up can never stall the reconcile pass
                    # behind a huge pool
                    census = sorted(census, key=len, reverse=True)[:8]
                    for toks in census:
                        try:
                            covered, blocks = src.export_prefix_blocks(
                                [int(t) for t in toks], timeout=10.0)
                            if covered and blocks and eng.install_prefix(
                                    covered, blocks, timeout=10.0):
                                installed += 1
                        except (RuntimeError, TimeoutError):
                            break
                    break  # one warm peer per engine is enough
        if installed:
            self.emit_event(
                isvc, "ReplicaPrewarmed",
                f"{installed} hot prefixes installed before traffic")
        return installed

    def _hibernate_for_zero(self, isvc, dep: _Deployment) -> int:
        """Scale-to-zero prologue: park every session durably in the
        spill store before the fleet tears down — a zero with live
        sessions would otherwise trade HBM for lost conversations.
        ``idle_sessions(0.0)`` enumerates every session-tagged
        sequence; a failed spill resumes in place (and the teardown
        still drains losslessly via the migrate-then-retire path)."""
        rev = dep.stable
        parked = 0
        for s in ([] if rev is None else rev.predictors):
            engines = getattr(s, "engines", None)
            if engines is None:
                continue
            for eng in engines().values():
                probe = getattr(eng, "idle_sessions", None)
                if (probe is None
                        or getattr(eng, "spill_store", None) is None):
                    continue
                for req in probe(0.0):
                    sid = getattr(req, "session_id", None)
                    if not sid:
                        continue
                    try:
                        if eng.hibernate_sequence(req, sid):
                            parked += 1
                    except (RuntimeError, TimeoutError) as e:
                        log.debug("pre-zero hibernate %s failed: %s",
                                  sid, e)
        if parked:
            self.emit_event(
                isvc, "SessionsHibernated",
                f"{parked} sessions hibernated ahead of scale-to-zero")
        return parked

    def _resize_replicas_to_degree(self, isvc, dep: _Deployment,
                                   degree: int) -> None:
        """TP-degree actuator: post the decision to every serving gang of
        the stable revision (``_GangPredictor.resize_to_degree``: rank 0
        runs the gang's own ``GangResizer``, copy-then-cutover, and the
        handle records the new degree). In-process replicas are skipped:
        one process drives one card, so they are at degree 1
        (``_new_revision`` makes every predictor of a larger degree a
        gang). Raises when nothing resized, when the target is above a
        gang's live members, and when a resize aborted (the old degree
        resumed in place): the decision demanded a shape the fleet cannot
        take, and the loop's bounded-retry backoff must see that, not a
        silent no-op. A gang with an ``expert`` axis is skipped as an
        in-process replica is (``_GangPredictor.tp_resizable``)."""
        rev = dep.stable
        resized = 0
        err: Optional[Exception] = None
        for s in ([] if rev is None else rev.predictors):
            act = getattr(s, "resize_to_degree", None)
            if act is None or not getattr(s, "tp_resizable", True):
                continue
            try:
                if act(int(degree)):
                    resized += 1
            except Exception as e:  # noqa: BLE001 — a refused or aborted
                # resize left the gang at its old degree; surface it to
                # the actuator's retry budget below
                err = e
        if err is not None:
            raise RuntimeError(
                f"TP resize to degree {degree} failed on a replica"
            ) from err
        if not resized:
            raise RuntimeError(
                f"no replica engine accepted a TP resize to {degree}")
        self.emit_event(
            isvc, "GangResized",
            f"{resized} serving gang(s) resized to TP degree {degree}"
            " by the autoscaler")

    def _measure_cold_start(self, dep: _Deployment) -> None:
        """Close the wake-from-zero clock once every stable replica
        reports ready — the measured budget ``decide`` holds
        scale-to-zero to (zero is only cheap if waking is)."""
        if (dep.autoscaler is None or dep.cold_start_t0 is None
                or dep.stable is None):
            return
        preds = dep.stable.predictors
        want = dep.autoscale_desired
        if (preds and (want is None or len(preds) >= want)
                and all(getattr(s, "ready", True) for s in preds)):
            dep.autoscaler.note_cold_start(
                time.monotonic() - dep.cold_start_t0,
                warm=self._wake_was_warm(preds))
            dep.cold_start_t0 = None

    @staticmethod
    def _wake_was_warm(preds) -> bool:
        """Did this wake-from-zero serve its program ladder out of the
        AOT artifact cache?  A build that compiled even one rung sits on
        the cold budget — mixing it into the warm EWMA would let
        ``decide`` scale to zero against a wake time the fleet cannot
        actually hit."""
        saw_cache = False
        for s in preds:
            engines = getattr(s, "engines", None)
            if engines is None:
                continue
            for eng in engines().values():
                try:
                    st = eng.stats()
                except (RuntimeError, TimeoutError):
                    return False
                hits = st.get("aot_cache_hits_total")
                if hits is None:
                    continue
                saw_cache = True
                if st.get("aot_cache_misses_total", 0) > 0 or hits <= 0:
                    return False
        return saw_cache

    # -- resolution -------------------------------------------------------

    def _resolve(self, isvc: InferenceService):
        # the storage initializer's module loads torch: imported here so
        # the Router (and the digital twin over it) stay torch-free
        from .storage import download

        pred = isvc.spec.predictor
        runtime: Optional[ServingRuntime] = None
        if pred.runtime:
            rt = self.store.try_get(KIND_SERVING_RUNTIME, pred.runtime, "default")
            if rt is None:
                raise ValueError(f"runtime {pred.runtime!r} not found")
            assert isinstance(rt, ServingRuntime)
            runtime = rt
        elif pred.model_format is not None:
            runtimes = [
                r for r in self.store.list(KIND_SERVING_RUNTIME)
                if isinstance(r, ServingRuntime)
            ]
            runtime = select_runtime(pred.model_format, runtimes)
            if runtime is None:
                raise ValueError(
                    f"no ServingRuntime supports model format "
                    f"{pred.model_format.name!r}")
        elif pred.handler:
            cfg = dict(pred.config)
            if pred.storage_uri:
                cfg.setdefault("storage_path", download(
                    pred.storage_uri, cache_dir=cfg.get("model_cache_dir"),
                    hf_root=cfg.get("hf_root")))
                cfg.setdefault("storage_uri", pred.storage_uri)
            return resolve_class(pred.handler), cfg
        else:
            raise ValueError("predictor needs runtime, model_format, or handler")

        cfg = {**runtime.spec.config, **pred.config}
        if pred.storage_uri:
            # merged cfg so a ServingRuntime can enable the cache for all
            # of its models, with the component able to override
            cfg.setdefault("storage_path", download(
                    pred.storage_uri, cache_dir=cfg.get("model_cache_dir"),
                    hf_root=cfg.get("hf_root")))
            cfg.setdefault("storage_uri", pred.storage_uri)
        return resolve_class(runtime.spec.server_class), cfg

    # -- teardown / status -------------------------------------------------

    def _teardown_deployment(self, dep: _Deployment) -> None:
        dep.autoscaler = None
        dep.autoscale_fp = None
        dep.autoscale_desired = None
        for rev in dep.revisions:
            for s in rev.servers:
                s.stop()
            rev.predictors.clear()
            rev.transformers.clear()
            rev.explainers.clear()
        dep.stable = dep.canary = None
        if dep.router:
            dep.router.set_backends([])  # its pools name stopped replicas
            dep.router.stop()
            dep.router = None

    def _set_status(self, isvc, phase=None, url=None, active_replicas=None,
                    message=None, stable_revision=None, canary_revision=...,
                    canary_traffic=None, stable_spec=None):
        def mut(o):
            assert isinstance(o, InferenceService)
            if phase is not None:
                o.status.phase = phase
            if url is not None:
                o.status.url = url
            if active_replicas is not None:
                o.status.active_replicas = active_replicas
            if message is not None:
                o.status.message = message
            if stable_revision is not None:
                o.status.stable_revision = stable_revision
            if canary_revision is not ...:  # None is a real value (no canary)
                o.status.canary_revision = canary_revision
            if canary_traffic is not None:
                o.status.canary_traffic = canary_traffic
            if stable_spec is not None:
                o.status.stable_spec = stable_spec

        try:
            self.store.update_with_retry(
                KIND_INFERENCE_SERVICE, isvc.metadata.name, isvc.metadata.namespace, mut)
        except NotFound:
            pass
