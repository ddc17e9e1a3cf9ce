"""REST API server over the object store — the kube-apiserver analog.

SURVEY §1 L0 names the cluster substrate's public interface "the k8s REST
API"; in-process callers use the Store directly, and this server gives the
same objects an HTTP surface so out-of-process clients (the kft CLI,
curl, CI scripts) get the kubectl-equivalent UX [upstream: the reference's
CRDs are served by kube-apiserver; every kubectl verb in SURVEY §3's call
stacks starts here].

Routes (JSON bodies; YAML accepted on writes):

    GET    /healthz
    GET    /apis                          -> served kinds
    GET    /apis/<kind>?namespace=ns      -> list (all namespaces if omitted)
    POST   /apis/<kind>                   -> create (manifest body)
    GET    /apis/<kind>/<ns>/<name>       -> object
    PUT    /apis/<kind>/<ns>/<name>       -> update (optimistic concurrency:
                                             resource_version must match)
    DELETE /apis/<kind>/<ns>/<name>
    GET    /apis/<kind>/<ns>/<name>/events -> events for the object
    GET    /apis/Pod/<ns>/<name>/logs      -> pod stdout (when a log source
                                              is attached)

Error mapping follows the apiserver conventions: 404 NotFound, 409
AlreadyExists/Conflict, 422 admission-rejected.

Authn/authz: a cluster-admin bearer token (``token=`` / $KFT_API_TOKEN)
plus PER-PROFILE tokens (``profile_tokens=`` / $KFT_API_TOKENS
"alice=t1,bob=t2" / ``Profile.spec.api_token``) — the reference's
Profile-controller multi-tenancy [upstream: kubeflow/kubeflow ->
profile-controller RBAC bindings; SURVEY §2.4] mapped onto this plane:
a profile token authenticates as that profile, whose name IS its tenant
namespace (ux/profiles.py), and mutating routes (POST/PUT/DELETE) are
scoped to that namespace — 403 Forbidden elsewhere, which also stops
tenants from editing Profile/PodDefault objects (those live in
kft-profiles).  Reads stay cluster-wide (the dashboard surface).  With
any token configured, every route except ``/healthz`` requires
``Authorization: Bearer <t>``, else 401.  Default (nothing configured)
preserves the open local-dev surface.

The port's copy of ``kubeflow_tpu/controlplane/apiserver.py``, device-
free like it, with the same names; it imports nothing of the reference
package. Its HTTP server listens with ``BurstHTTPServer``'s backlog
(``utils/net.py``).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import yaml

from ..api.yaml_io import KIND_REGISTRY, from_dict, to_dict
from ..utils.net import BurstHTTPServer, allocate_port
from .controller import events_for
from .store import TOO_OLD, AlreadyExists, Conflict, NotFound, Rejected, Store

#: largest request body accepted on writes — the server must not allocate
#: whatever a client's Content-Length header claims (413 past this)
MAX_BODY_BYTES = 4 * 1024 * 1024


class BodyTooLarge(Exception):
    def __init__(self, n: int) -> None:
        super().__init__(
            f"request body {n} bytes exceeds limit {MAX_BODY_BYTES}")

#: case-insensitive kind aliases (kubectl-style shortnames + plurals)
KIND_ALIASES = {
    "jaxjobs": "JaxJob", "jj": "JaxJob",
    "pods": "Pod", "po": "Pod",
    "nodes": "Node", "no": "Node",
    "services": "Service", "svc": "Service",
    "podgroups": "PodGroup", "pg": "PodGroup",
    "events": "Event", "ev": "Event",
    "experiments": "Experiment", "exp": "Experiment",
    "suggestions": "Suggestion",
    "trials": "Trial",
    "inferenceservices": "InferenceService", "isvc": "InferenceService",
    "servingruntimes": "ServingRuntime",
    "inferencegraphs": "InferenceGraph", "ig": "InferenceGraph",
    "notebooks": "Notebook", "nb": "Notebook",
    "profiles": "Profile",
    "poddefaults": "PodDefault",
}


def resolve_kind(token: str) -> str:
    """kubectl-ish kind resolution: exact, alias, lowercase, or
    lowercase-plural."""
    if token in KIND_REGISTRY:
        return token
    low = token.lower()
    if low in KIND_ALIASES:
        return KIND_ALIASES[low]
    for kind in KIND_REGISTRY:
        if low in (kind.lower(), kind.lower() + "s"):
            return kind
    raise KeyError(token)


#: what a scrubbed credential reads back as (a write round-tripping this
#: sentinel preserves the stored secret — the kubectl-apply-a-GET flow)
REDACTED = "**redacted**"


def redact_for_read(d: dict) -> dict:
    """Scrub credential material from an object dict before it leaves on
    a READ.  Reads are cluster-wide (the dashboard surface), so without
    this any profile-token holder could lift every other tenant's bearer
    token from ``GET /apis/profiles`` and impersonate it (ADVICE r5
    high), or a legacy inline gang token from a JaxJob env.  Mutates and
    returns ``d`` (the dict is already a per-response copy)."""
    kind = d.get("kind")
    if kind == "Profile":
        spec = d.get("spec") or {}
        if spec.get("api_token"):
            spec["api_token"] = REDACTED
    elif kind in ("JaxJob", "Pod"):
        for env in _env_blocks(d):
            raw = env.get("KFT_SERVE_CONFIG")
            if not isinstance(raw, str) or "gang_token" not in raw:
                continue
            try:
                conf = json.loads(raw)
                if conf.pop("gang_token", None) is not None:
                    env["KFT_SERVE_CONFIG"] = json.dumps(conf)
            except (TypeError, ValueError):
                continue
    return d


def _env_blocks(d: dict) -> list[dict]:
    """Container env dicts reachable in a JaxJob/Pod manifest."""
    spec = d.get("spec") or {}
    out = []
    container = spec.get("container")
    if isinstance(container, dict) and isinstance(container.get("env"), dict):
        out.append(container["env"])
    for rspec in (spec.get("replica_specs") or {}).values():
        tmpl = rspec.get("template") if isinstance(rspec, dict) else None
        if isinstance(tmpl, dict) and isinstance(tmpl.get("env"), dict):
            out.append(tmpl["env"])
    return out


def _typed_env_blocks(obj) -> dict[str, dict]:
    """Keyed container env dicts on a TYPED JaxJob/Pod (for pairing an
    incoming write against the stored object)."""
    out: dict[str, dict] = {}
    spec = getattr(obj, "spec", None)
    container = getattr(spec, "container", None)
    if container is not None and isinstance(getattr(container, "env", None), dict):
        out["container"] = container.env
    for rtype, rspec in (getattr(spec, "replica_specs", None) or {}).items():
        tmpl = getattr(rspec, "template", None)
        if tmpl is not None and isinstance(getattr(tmpl, "env", None), dict):
            out[f"replica:{rtype}"] = tmpl.env
    return out


def restore_redacted_on_write(kind: str, obj, cur) -> None:
    """A write round-tripping a redacted READ must not destroy the stored
    credential: Profile.api_token carrying the sentinel keeps the stored
    token, and a JaxJob/Pod env whose KFT_SERVE_CONFIG lost its (legacy
    inline) gang_token to redact_for_read gets it re-attached from the
    stored object.  ``cur`` is the stored object (may be None)."""
    if kind == "Profile":
        if getattr(obj.spec, "api_token", None) == REDACTED:
            obj.spec.api_token = (
                getattr(cur.spec, "api_token", None) if cur else None)
        return
    if kind not in ("JaxJob", "Pod") or cur is None:
        return
    stored = _typed_env_blocks(cur)
    for key, env in _typed_env_blocks(obj).items():
        raw, raw_cur = env.get("KFT_SERVE_CONFIG"), stored.get(key, {}).get(
            "KFT_SERVE_CONFIG")
        if not raw or not raw_cur or "gang_token" not in raw_cur:
            continue
        try:
            conf, conf_cur = json.loads(raw), json.loads(raw_cur)
        except (TypeError, ValueError):
            continue
        if "gang_token" not in conf and "gang_token" in conf_cur:
            conf["gang_token"] = conf_cur["gang_token"]
            env["KFT_SERVE_CONFIG"] = json.dumps(conf)


class ApiServer:
    """HTTP facade over a Store (one per cluster)."""

    def __init__(self, store: Optional[Store] = None,
                 port: Optional[int] = None,
                 log_path_for: Optional[Callable[[str, str], str]] = None,
                 token: Optional[str] = None,
                 profile_tokens: Optional[dict[str, str]] = None,
                 data_dir: Optional[str] = None):
        import os

        if store is None:
            if data_dir is None:
                raise ValueError("ApiServer needs a store or a data_dir")
            # standalone durable mode: the server owns (and closes) a
            # WAL-backed store recovered from data_dir — with the same
            # admission webhooks a Cluster registers, or writes through
            # this surface would persist un-defaulted/unvalidated specs
            from .cluster import register_default_admission

            store = Store.open(data_dir)
            register_default_admission(store)
            self._owns_store = True
        else:
            self._owns_store = False
        self.store = store
        self.log_path_for = log_path_for
        self.port = port or allocate_port()
        self.token = token if token is not None else os.environ.get(
            "KFT_API_TOKEN") or None
        #: profile name -> bearer token (per-tenant identity; also fed by
        #: Profile.spec.api_token).  $KFT_API_TOKENS: "alice=t1,bob=t2".
        self.profile_tokens = dict(profile_tokens or {})
        env_tokens = os.environ.get("KFT_API_TOKENS", "")
        for pair in env_tokens.split(","):
            name, _, tok = pair.strip().partition("=")
            if name and tok:
                self.profile_tokens.setdefault(name, tok)
        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, payload, raw: Optional[bytes] = None,
                      ctype: str = "application/json") -> None:
                body = raw if raw is not None else json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", "0"))
                if n > MAX_BODY_BYTES:
                    # reject BEFORE reading: the header is client-
                    # controlled and must not size an allocation
                    self.close_connection = True  # unread body poisons keep-alive
                    raise BodyTooLarge(n)
                raw = self.rfile.read(n) if n > 0 else b"{}"
                text = raw.decode()
                if self.headers.get("Content-Type", "").startswith(
                        "application/yaml") or not text.lstrip().startswith("{"):
                    return yaml.safe_load(text) or {}
                return json.loads(text)

            def do_GET(self):
                api._handle(self, "GET")

            def do_POST(self):
                api._handle(self, "POST")

            def do_PUT(self):
                api._handle(self, "PUT")

            def do_DELETE(self):
                api._handle(self, "DELETE")

        # one persistent store watch feeds a bounded event buffer; watch
        # long-polls resume from a resource_version against this buffer,
        # so events BETWEEN polls are not lost (a per-request store watch
        # would drop anything that happened while no poll was in flight)
        self._events: "deque[tuple[int, object]]" = deque(maxlen=2048)
        self._events_cond = threading.Condition()
        self._event_seq = 0
        #: highest seq EVICTED from the bounded buffer (0 = nothing yet):
        #: a watch cursor at or below this has lost events and must relist
        #: — signalled with 410 Gone, kube-apiserver style, instead of
        #: silently skipping the gap
        self._evicted_seq = 0
        self._stopping = False
        self._store_watch = store.watch(list(KIND_REGISTRY))
        self._pump = threading.Thread(
            target=self._pump_events, name="apiserver-watch-pump", daemon=True)
        self._pump.start()

        self._httpd = BurstHTTPServer(("127.0.0.1", self.port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"apiserver-{self.port}",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self._stopping = True
        self.store.stop_watch(self._store_watch)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)
        with self._events_cond:  # release any parked long-polls
            self._events_cond.notify_all()
        self._pump.join(timeout=2)
        if self._owns_store:
            self.store.close()

    # -- request handling --------------------------------------------------

    #: authenticated-as-cluster-admin sentinel (single-token mode, or no
    #: authn configured at all — the open local-dev surface)
    ADMIN = "__cluster_admin__"

    def _profile_object_tokens(self) -> dict[str, str]:
        """Profile.spec.api_token credentials (the object-driven half of
        per-profile identity; env/ctor tokens need no store objects)."""
        out = {}
        try:
            for prof in self.store.list("Profile"):
                tok = getattr(prof.spec, "api_token", None)
                if tok:
                    out[prof.metadata.name] = tok
        except KeyError:
            pass
        return out

    def _authenticate(self, h) -> Optional[str]:
        """Identity for this request: ADMIN, a profile name (== the
        tenant namespace the identity may mutate), or None (rejected).
        Constant-time compares throughout — a plain != short-circuits at
        the first differing byte, a timing oracle on the credential."""
        import hmac

        tenant_tokens = dict(self.profile_tokens)
        tenant_tokens.update(self._profile_object_tokens())
        if not self.token and not tenant_tokens:
            return self.ADMIN  # no authn configured: open local dev
        got = h.headers.get("Authorization", "")
        if self.token and hmac.compare_digest(got, f"Bearer {self.token}"):
            return self.ADMIN
        for name, tok in sorted(tenant_tokens.items()):
            if hmac.compare_digest(got, f"Bearer {tok}"):
                return name
        return None

    def _handle(self, h, method: str) -> None:
        # errors carry a structured ``reason`` (kube-apiserver Status.reason
        # analog) so clients branch on it, never on message text — substring
        # matching misclassified a 422 whose message contained "exists"
        identity = self.ADMIN
        if urlparse(h.path).path != "/healthz":
            identity = self._authenticate(h)
            if identity is None:
                h._send(401, {"error": "missing or invalid bearer token",
                              "reason": "Unauthorized"})
                return
        try:
            self._route(h, method, identity)
        except NotFound as e:
            h._send(404, {"error": str(e), "reason": "NotFound"})
        except AlreadyExists as e:
            h._send(409, {"error": str(e), "reason": "AlreadyExists"})
        except Conflict as e:
            h._send(409, {"error": str(e), "reason": "Conflict"})
        except Rejected as e:
            h._send(422, {"error": str(e), "reason": "Invalid"})
        except BodyTooLarge as e:
            h._send(413, {"error": str(e), "reason": "RequestEntityTooLarge"})
        except KeyError as e:
            h._send(404, {"error": f"unknown kind {e}", "reason": "NotFound"})
        except Exception as e:  # noqa: BLE001 — surface as 400
            h._send(400, {"error": f"{type(e).__name__}: {e}",
                          "reason": "BadRequest"})

    def _pump_events(self) -> None:
        import queue as queuelib

        while True:
            try:
                ev = self._store_watch.q.get(timeout=0.5)
            except queuelib.Empty:
                if getattr(self._store_watch, "closed", False):
                    return
                continue
            if ev.type == TOO_OLD:
                if self._stopping:
                    return
                # the store-side watch overflowed: re-subscribe, then
                # expire EVERY outstanding cursor — events were dropped
                # before they ever got a seq, so any resume would have a
                # silent hole; clients get 410 and relist
                self._store_watch = self.store.watch(list(KIND_REGISTRY))
                with self._events_cond:
                    self._event_seq += 1
                    self._evicted_seq = self._event_seq
                    self._events.clear()
                    self._events_cond.notify_all()
                continue
            with self._events_cond:
                self._event_seq += 1
                if len(self._events) == self._events.maxlen:
                    self._evicted_seq = self._events[0][0]
                self._events.append((self._event_seq, ev))
                self._events_cond.notify_all()

    def _watch(self, h, kind: str, ns: Optional[str], timeout: float,
               after: Optional[int]) -> None:
        """Long-poll against the buffered event stream.

        ``after`` is the cursor (the ``seq`` of the last event the client
        saw); ABSENT means "only future events".  A cursor of 0 is a real
        resume point (a first poll before any event legitimately returns
        cursor 0), so absence is None, not a 0 sentinel.  Each response
        carries ``seq`` per item and ``cursor`` to pass back — re-polling
        with the cursor recovers everything that happened between polls
        (up to the buffer's retention)."""
        deadline = time.monotonic() + min(max(timeout, 0.0), 300.0)
        expired = None
        with self._events_cond:
            if after is None:
                after = self._event_seq  # "now": only future events
            elif after < self._evicted_seq:
                # the buffer (shared across kinds) rolled past the
                # client's cursor: some events are GONE — tell the client
                # (kube-apiserver's 410 Gone) rather than silently
                # resuming with a hole.  The resync cursor is the
                # EVICTION BOUNDARY, not the head: re-polling with it
                # still delivers the whole retained window.
                expired = {
                    "error": "watch cursor expired: events up to "
                             f"seq {self._evicted_seq} were evicted",
                    "reason": "Expired",
                    "cursor": self._evicted_seq,
                }
        if expired is not None:
            # socket write happens OUTSIDE the condition: a slow client
            # must not stall the pump and every other watcher
            h._send(410, expired)
            return

        def collect():
            return [
                (seq, ev) for seq, ev in self._events
                if seq > after and ev.obj.kind == kind
                and (ns is None or ev.obj.metadata.namespace == ns)
            ]

        with self._events_cond:
            matched = collect()
            while not matched and after >= self._evicted_seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._events_cond.wait(timeout=remaining)
                matched = collect()
            if after < self._evicted_seq:
                # eviction can also happen DURING the wait (a burst rolls
                # the buffer past our cursor while we park, with or
                # without retained matches left) — same 410 contract as
                # at entry; returning retained events here would silently
                # skip the evicted gap
                expired = {
                    "error": "watch cursor expired during poll: events "
                             f"up to seq {self._evicted_seq} were evicted",
                    "reason": "Expired",
                    "cursor": self._evicted_seq,
                }
            cursor = matched[-1][0] if matched else after
        if expired is not None:
            h._send(410, expired)
            return
        h._send(200, {
            "cursor": cursor,
            "items": [
                {"type": ev.type, "seq": seq,
                 "object": redact_for_read(to_dict(ev.obj))}
                for seq, ev in matched
            ],
        })

    def _route(self, h, method: str, identity: Optional[str] = None) -> None:
        identity = self.ADMIN if identity is None else identity
        u = urlparse(h.path)
        parts = [p for p in u.path.split("/") if p]
        q = parse_qs(u.query)

        def forbidden(ns: str) -> bool:
            """Mutations scope to the identity's tenant namespace (a
            Profile's name IS its namespace, ux/profiles.py) — this also
            blocks tenants from mutating Profiles/PodDefaults themselves,
            which live in the kft-profiles namespace."""
            if identity != self.ADMIN and ns != identity:
                h._send(403, {
                    "error": f"profile {identity!r} may not modify "
                             f"namespace {ns!r}",
                    "reason": "Forbidden"})
                return True
            return False
        if u.path == "/healthz":
            h._send(200, {"ok": True})
            return
        if not parts or parts[0] != "apis":
            h._send(404, {"error": f"unknown path {u.path}"})
            return
        if len(parts) == 1:
            h._send(200, {"kinds": sorted(KIND_REGISTRY)})
            return
        kind = resolve_kind(parts[1])
        if len(parts) == 2:
            if method == "POST":
                manifest = h._body()
                manifest.setdefault("kind", kind)
                obj = from_dict(manifest)
                if forbidden(obj.metadata.namespace):
                    return
                if (kind == "Profile"
                        and getattr(obj.spec, "api_token", None) == REDACTED):
                    # a DELETE+POST replace of a redacted GET would store
                    # the PUBLIC sentinel as a live bearer token; with no
                    # stored object left to restore from, reject loudly
                    h._send(422, {
                        "error": "spec.api_token is the redaction "
                                 "sentinel; supply the real credential",
                        "reason": "Invalid"})
                    return
                created = self.store.create(obj)
                h._send(201, redact_for_read(to_dict(created)))
                return
            ns = q.get("namespace", [None])[0]
            if (method == "GET"
                    and q.get("watch", ["false"])[0] in ("true", "1")):
                # kubectl -w analog: long-poll the buffered event stream;
                # pass back the returned ``cursor`` to resume without
                # losing events that land between polls
                cur = q.get("cursor", [None])[0]
                self._watch(h, kind, ns,
                            float(q.get("timeout", ["30"])[0]),
                            int(cur) if cur is not None else None)
                return
            objs = self.store.list(kind, ns)
            h._send(200, {"items": [redact_for_read(to_dict(o)) for o in objs]})
            return
        if len(parts) == 3:
            # /apis/<kind>/<ns> — namespace-scoped list (also the natural
            # exploratory URL; must not 400 on a missing name segment)
            objs = self.store.list(kind, parts[2])
            h._send(200, {"items": [redact_for_read(to_dict(o)) for o in objs]})
            return
        ns, name = parts[2], parts[3]
        if len(parts) == 5 and parts[4] == "events":
            h._send(200, {"items": [to_dict(e) for e in events_for(
                self.store, kind, name) if e.metadata.namespace == ns]})
            return
        if len(parts) == 5 and parts[4] == "logs" and kind == "Pod":
            if self.log_path_for is None:
                h._send(404, {"error": "no log source attached"})
                return
            try:
                with open(self.log_path_for(ns, name)) as f:
                    h._send(200, None, raw=f.read().encode(),
                            ctype="text/plain")
            except OSError as e:
                h._send(404, {"error": f"no logs: {e}"})
            return
        if method == "GET":
            h._send(200, redact_for_read(to_dict(self.store.get(kind, name, ns))))
            return
        if method == "PUT":
            if forbidden(ns):
                return
            manifest = h._body()
            manifest.setdefault("kind", kind)
            obj = from_dict(manifest)
            obj.metadata.name, obj.metadata.namespace = name, ns
            if kind in ("Profile", "JaxJob", "Pod"):
                # GET -> edit -> PUT round-trip: redacted credentials mean
                # "keep the stored secret", never clobber it
                restore_redacted_on_write(
                    kind, obj, self.store.try_get(kind, name, ns))
            h._send(200, redact_for_read(to_dict(self.store.update(obj))))
            return
        if method == "DELETE":
            if forbidden(ns):
                return
            self.store.delete(kind, name, ns)
            h._send(200, {"deleted": f"{kind}/{ns}/{name}"})
            return
        h._send(405, {"error": f"{method} not supported on {u.path}"})
