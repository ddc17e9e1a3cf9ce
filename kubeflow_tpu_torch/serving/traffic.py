"""Traffic plane: prefix-affinity routing, per-tenant QoS, preemption.

The front door ROADMAP item 4 names (ISSUE 9): nothing upstream of the
engines was traffic-aware — the Router smooth-WRRed replicas blind to
which one already holds a request's cached KV blocks, Profiles enforced
resource quotas at gang admission but carried no request-rate or
priority semantics, and overload meant unbounded queue growth inside
the engine.  This module is the missing subsystem, host-side and
stdlib-only on purpose (every decision here runs on router / HTTP
worker threads; the analyzer roots ``*TrafficPlane``/``*Admission``/
``*Preemptor`` classes in ``host-sync-in-dispatch`` so none of this
accounting can creep onto an engine scheduler thread):

- **Per-tenant QoS classes** (:class:`QosClass` / :class:`TrafficPlane`):
  token-bucket rate limiting, a priority tier (``high``/``normal``/
  ``low`` -> the engine's ``Request.priority``), a max-concurrent slot
  count, and a BOUNDED admission queue per class.  ``acquire`` returns
  an explicit shed decision (429 + ``Retry-After``) the HTTP layer
  writes to the client — the SSE path blocks at this front door inside
  the bound, so overload becomes explicit backpressure instead of
  unbounded buffering (the vLLM/apiserver bounded-queue rule the
  control plane already follows).

- **Prefix-affinity routing** (:class:`PrefixAffinity`): hash the
  request's prompt-prefix blocks (``paged.block_keys`` — the block
  economy's content identity) and route to the replica whose allocator
  registry already holds them; the prefix cache is only as good as the
  router that feeds it.  Falls back to least-loaded, and an affinity
  hit is overridden when the target is overloaded relative to its
  peers (a hot shared prefix must not melt one replica).

- **Priority preemption** (:class:`EnginePreemptor`): when a
  high-priority request is waiting and the pool is full of
  lower-priority sequences, export the lowest-priority live sequence
  (PR 7's ``export_sequence`` — tokens stay bit-identical on resume),
  release its slot + blocks, and park the snapshot; it re-imports the
  moment capacity frees and no higher-priority demand waits.
  Evict-and-requeue is cheap exactly because KV is paged and
  migratable — the parked state is the same snapshot a live migration
  ships.

The port's copy of ``kubeflow_tpu/serving/traffic.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import collections
import logging
import random
import threading
import time
from typing import Any, Callable, Optional

log = logging.getLogger("kubeflow_tpu_torch.serving")

#: process-default jitter source.  Every policy object in this module
#: takes ``rng=`` (and ``clock=``) so the digital twin (``sim/``) can
#: inject a seeded stream and a virtual clock; live deployments fall
#: back to this shared instance.  The ``wall-clock-in-policy`` analyzer
#: rule holds the line: policy code never calls module-level
#: ``random.*`` or ``time.*`` directly.
_RNG = random.Random()

#: priority tiers, best first — the names Profiles/configs use; the
#: ints are what the engine's admission sort and the preemptor compare
PRIORITY_TIERS = {"high": 0, "normal": 1, "low": 2}
_TIER_NAMES = {v: k for k, v in PRIORITY_TIERS.items()}


def priority_tier(value, default: int = 1) -> int:
    """Priority spec (name or int) -> tier int; raises on unknown."""
    if value is None:
        return default
    if isinstance(value, str):
        if value not in PRIORITY_TIERS:
            raise ValueError(
                f"unknown priority tier {value!r} "
                f"(one of {sorted(PRIORITY_TIERS)})")
        return PRIORITY_TIERS[value]
    tier = int(value)
    if tier not in _TIER_NAMES:
        raise ValueError(
            f"priority tier {tier} out of range "
            f"({sorted(_TIER_NAMES)})")
    return tier


class QosClass:
    """One tenant class's QoS contract (the Profile ``qos`` shape).

    ``rate``: sustained requests/second through a token bucket (0 =
    unlimited); ``burst``: bucket depth (defaults to max(1, rate));
    ``priority``: tier name; ``max_concurrent``: live requests allowed
    past the door at once (0 = unlimited); ``queue_depth``: how many
    requests may WAIT for a concurrency slot before the class sheds
    (the bounded admission queue — 0 disables waiting entirely).
    """

    FIELDS = ("rate", "burst", "priority", "max_concurrent",
              "queue_depth")

    def __init__(self, name: str, rate: float = 0.0,
                 burst: Optional[float] = None,
                 priority: Any = "normal", max_concurrent: int = 0,
                 queue_depth: int = 64):
        self.name = str(name)
        self.rate = float(rate)
        if self.rate < 0:
            raise ValueError(
                f"qos class {name!r}: rate must be >= 0, got {rate}")
        self.burst = float(burst) if burst is not None else max(
            1.0, self.rate)
        if self.burst < 1:
            raise ValueError(
                f"qos class {name!r}: burst must be >= 1, got {burst}")
        try:
            self.priority = priority_tier(priority)
        except ValueError as e:
            raise ValueError(f"qos class {name!r}: {e}") from e
        self.max_concurrent = int(max_concurrent)
        if self.max_concurrent < 0:
            raise ValueError(
                f"qos class {name!r}: max_concurrent must be >= 0")
        self.queue_depth = int(queue_depth)
        if self.queue_depth < 0:
            raise ValueError(
                f"qos class {name!r}: queue_depth must be >= 0")

    @property
    def priority_name(self) -> str:
        return _TIER_NAMES[self.priority]


def validate_qos(spec) -> dict[str, QosClass]:
    """``{"classname": {rate, burst, priority, max_concurrent,
    queue_depth}}`` -> classes; raises ``ValueError`` with the offending
    class + field named.  The ONE validation site: conf-freeze (the
    ISvc controller), the Profile controller, and plane construction
    all call this, so a negative rate or an unknown priority tier is
    rejected identically everywhere."""
    if not isinstance(spec, dict):
        raise ValueError(
            f"qos must be a mapping of class name -> spec, got "
            f"{type(spec).__name__}")
    out: dict[str, QosClass] = {}
    for name, cls_spec in spec.items():
        if not isinstance(cls_spec, dict):
            raise ValueError(
                f"qos class {name!r}: spec must be a mapping, got "
                f"{type(cls_spec).__name__}")
        unknown = set(cls_spec) - set(QosClass.FIELDS)
        if unknown:
            raise ValueError(
                f"qos class {name!r}: unknown fields {sorted(unknown)} "
                f"(allowed: {list(QosClass.FIELDS)})")
        try:
            out[str(name)] = QosClass(name, **cls_spec)
        except TypeError as e:
            # float(None) / int([...]) and friends raise TypeError —
            # callers are promised ValueError for ANY malformed spec
            # (the Failed-status paths catch exactly that; a TypeError
            # escaping here once stalled every ISvc reconcile)
            raise ValueError(f"qos class {name!r}: {e}") from e
    return out


class TokenBucket:
    """Classic token bucket on the monotonic clock.  ``try_take``
    returns 0.0 on grant, else the seconds until a token accrues (the
    client's ``Retry-After``)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = self.burst
        self._clock = clock
        self._t = clock()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> float:
        if self.rate <= 0:
            return 0.0  # unlimited
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate

    def refund(self, n: float = 1.0) -> None:
        """Return a token taken by a request that did no work (a
        concurrency-path shed after the bucket granted it) — without
        the refund, rejected requests drain the bucket and the tenant's
        ADMITTED throughput falls below its contracted rate."""
        if self.rate <= 0:
            return
        with self._lock:
            self._tokens = min(self.burst, self._tokens + n)


class PrefixAffinity:
    """Block-content-key -> backend map: where a prefix's KV blocks
    last landed.  Keys come from ``paged.block_keys`` (chained hashes,
    so ``keys[i]`` identifies the whole prefix through block ``i``);
    the map remembers the DEEPEST key per chain it has seen per
    backend, bounded LRU.  ``best`` walks a request's chain from the
    deepest key down and returns the first backend still live — the
    replica whose allocator registry (live slots, or the
    free-list-as-cache) holds the longest prefix of this prompt."""

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        #: key -> backend id (LRU: oldest observation evicts first)
        self._map: "collections.OrderedDict[int, str]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits_total = 0
        self.misses_total = 0

    def observe(self, keys: list[int], backend: str) -> None:
        """Record that ``backend`` is about to hold these prefix
        blocks (called after routing — the replica's prefill/registry
        will hold them by the time the next same-prefix request
        arrives)."""
        if not keys:
            return
        with self._lock:
            for k in keys:
                self._map.pop(k, None)
                self._map[k] = backend
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def forget(self, backend: str) -> None:
        """Drop every key pointing at a dead/removed backend — its KV
        is gone; routing to a corpse for affinity would trade a prefill
        for a connection error."""
        with self._lock:
            stale = [k for k, b in self._map.items() if b == backend]
            for k in stale:
                del self._map[k]

    def best(self, keys: list[int], candidates) -> tuple[Optional[str], int]:
        """(backend, matched block depth) for the deepest key any live
        candidate holds; (None, 0) on a miss.  Deepest-first: a chain
        match at depth i implies every shallower block matches too."""
        cand = set(candidates)
        with self._lock:
            for depth in range(len(keys), 0, -1):
                b = self._map.get(keys[depth - 1])
                if b is not None and b in cand:
                    self.hits_total += 1
                    return b, depth
        self.misses_total += 1
        return None, 0


class SessionAffinity:
    """Session id -> backend map: where a durable session's KV lives
    (ISSUE 12).  A resumed conversation routes to the replica whose
    pool (HBM/host tier) still holds its blocks — warm resume.  When
    that replica died, ``forget`` dropped it and the resume routes
    least-loaded instead: ANY replica can thaw the session from the
    shared storage tier, which is exactly the durability contract (the
    affinity is a latency optimization, never a correctness
    dependency).  Bounded LRU, same shape as :class:`PrefixAffinity`."""

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self._map: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits_total = 0
        self.misses_total = 0

    def observe(self, session: str, backend: str) -> None:
        if not session:
            return
        with self._lock:
            self._map.pop(session, None)
            self._map[session] = backend
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def forget(self, backend: str) -> None:
        with self._lock:
            stale = [s for s, b in self._map.items() if b == backend]
            for s in stale:
                del self._map[s]

    def best(self, session: str, candidates) -> Optional[str]:
        if not session:
            return None
        with self._lock:
            b = self._map.get(session)
            if b is not None and b in set(candidates):
                self.hits_total += 1
                return b
        self.misses_total += 1
        return None


class KvBlockRegistry:
    """Cluster-scope content-addressed block registry (ISSUE 12, the
    r12 gang-affinity residual): chained block-content key -> the
    replica whose /metrics block-registry digest (rank-0 for gangs)
    last advertised it, with the advertised chain depth.

    ``probe``/``observe_metrics`` ingest ``kft_kv_prefix_key`` rows
    (serving/server.py renders them from ``paged.prefix_digest``);
    ``locate`` answers "which live replica holds the deepest prefix of
    this prompt" so a cold replica can ``kv_fetch`` the KV from a peer
    (serving/gang.py) and ``install_prefix`` it instead of recomputing
    — prefill-once-per-cluster.  Bounded LRU per the PrefixAffinity
    convention; blocking HTTP probes belong on controller/router
    threads, never an engine scheduler."""

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        #: key (int) -> (backend, depth)
        self._map: "collections.OrderedDict[int, tuple[str, int]]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.probes_total = 0
        self.hits_total = 0
        self.misses_total = 0

    def observe_metrics(self, backend: str, metrics_text: str) -> int:
        """Ingest one replica's /metrics exposition; returns the number
        of registry rows seen."""
        import re

        rows = re.findall(
            r'^kft_kv_prefix_key\{[^}]*key="([0-9a-f]+)"[^}]*\}\s+'
            r'(\d+)', metrics_text, re.MULTILINE)
        with self._lock:
            for key_hex, depth in rows:
                k = int(key_hex, 16)
                self._map.pop(k, None)
                self._map[k] = (backend, int(depth))
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)
        return len(rows)

    def probe(self, backend: str, url: str, timeout: float = 2.0) -> int:
        """Scrape ``url``/metrics and ingest its registry rows (the
        rank-0 probe).  Returns rows seen; 0 on any failure."""
        import urllib.request

        self.probes_total += 1
        try:
            with urllib.request.urlopen(
                    url.rstrip("/") + "/metrics", timeout=timeout) as r:
                return self.observe_metrics(backend, r.read().decode())
        except (OSError, ValueError):
            return 0

    def forget(self, backend: str) -> None:
        """A dead replica's KV died with it."""
        with self._lock:
            stale = [k for k, (b, _d) in self._map.items()
                     if b == backend]
            for k in stale:
                del self._map[k]

    def locate(self, keys: list[int],
               exclude=()) -> tuple[Optional[str], int]:
        """(backend, matched block depth) for the deepest key of this
        chain any known replica advertises; (None, 0) on a miss."""
        skip = set(exclude)
        with self._lock:
            for depth in range(len(keys), 0, -1):
                hit = self._map.get(keys[depth - 1])
                if hit is not None and hit[0] not in skip:
                    self.hits_total += 1
                    return hit[0], depth
        self.misses_total += 1
        return None, 0

    def heat_by_backend(self) -> dict[str, int]:
        """backend -> number of registry entries it advertises — the
        per-replica KV footprint the autoscaler's scale-down victim
        pick consumes (ISSUE 15): retiring the coldest backend
        invalidates the least cluster prefix reuse."""
        with self._lock:
            out: dict[str, int] = {}
            for b, _depth in self._map.values():
                out[b] = out.get(b, 0) + 1
        return out

    def stats(self) -> dict:
        with self._lock:
            entries = len(self._map)
        return {
            "kv_registry_entries": entries,
            "kv_registry_probes_total": self.probes_total,
            "kv_registry_hits_total": self.hits_total,
            "kv_registry_misses_total": self.misses_total,
        }


class BackendHealth:
    """Per-backend health circuit (ISSUE 16): closed -> open ->
    half-open -> closed.

    Before this existed, ``Router._backend_down`` forgot a backend's
    affinity forever and kept ROUTING to it until membership churn
    removed the URL — every request burned a connect attempt on the
    corpse.  The circuit makes death a first-class, RECOVERABLE state:

    - **closed**: traffic flows; failures are counted (consecutive +
      a sliding error-rate window).
    - **open**: ``fail_threshold`` consecutive failures (or the window
      error rate crossing ``error_rate``) trips the circuit; routing
      skips the backend until a JITTERED recovery deadline (jitter so
      N routers probing one recovering replica don't arrive as a
      synchronized wave).
    - **half-open**: past the deadline, exactly ONE live request is
      allowed through as the recovery probe (``on_routed`` arms it);
      success closes the circuit, failure re-opens it with doubled
      backoff up to ``open_cap_s``.

    Selection is two-phase so an unpicked candidate never strands a
    probe: ``routable(candidates)`` is a pure filter (no side
    effects), and the router calls ``on_routed(choice)`` on the ONE
    backend it actually forwards to.  All state sits under one lock;
    every caller is a router/HTTP worker thread."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, fail_threshold: int = 3, error_rate: float = 0.5,
                 window: int = 20, open_s: float = 1.0,
                 open_cap_s: float = 30.0, probe_jitter: float = 0.5,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        if int(fail_threshold) < 1:
            raise ValueError("fail_threshold must be >= 1")
        if not (0.0 < float(error_rate) <= 1.0):
            raise ValueError("error_rate must be in (0, 1]")
        if float(open_s) <= 0 or float(open_cap_s) < float(open_s):
            raise ValueError("need 0 < open_s <= open_cap_s")
        self.fail_threshold = int(fail_threshold)
        self.error_rate = float(error_rate)
        self.window = max(2, int(window))
        self.open_s = float(open_s)
        self.open_cap_s = float(open_cap_s)
        self.probe_jitter = max(0.0, float(probe_jitter))
        self._clock = clock
        self._rng = rng if rng is not None else _RNG
        #: url -> mutable record (state machine per backend)
        self._circuits: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.opens_total = 0
        self.closes_total = 0
        self.probes_total = 0

    def _rec(self, backend: str) -> dict:
        rec = self._circuits.get(backend)
        if rec is None:
            rec = self._circuits[backend] = {
                "state": self.CLOSED, "consec": 0,
                "outcomes": collections.deque(maxlen=self.window),
                "reopen_at": 0.0, "open_for": self.open_s,
                "probe_inflight": False,
            }
        return rec

    def _trip(self, rec: dict, now: float) -> None:
        rec["state"] = self.OPEN
        rec["probe_inflight"] = False
        rec["reopen_at"] = now + rec["open_for"] * (
            1.0 + self._rng.random() * self.probe_jitter)
        self.opens_total += 1

    def note_failure(self, backend: str) -> None:
        now = self._clock()
        with self._lock:
            rec = self._rec(backend)
            rec["consec"] += 1
            rec["outcomes"].append(False)
            if rec["state"] == self.HALF_OPEN:
                # failed probe: re-open with doubled backoff — a
                # replica mid-restart must not eat a probe per open_s
                rec["open_for"] = min(rec["open_for"] * 2.0,
                                      self.open_cap_s)
                self._trip(rec, now)
                return
            if rec["state"] != self.CLOSED:
                return
            outcomes = rec["outcomes"]
            rate_hot = (len(outcomes) >= self.window
                        and outcomes.count(False) / len(outcomes)
                        >= self.error_rate)
            if rec["consec"] >= self.fail_threshold or rate_hot:
                rec["open_for"] = self.open_s
                self._trip(rec, now)

    def note_success(self, backend: str) -> None:
        with self._lock:
            rec = self._circuits.get(backend)
            if rec is None:
                return
            rec["consec"] = 0
            rec["outcomes"].append(True)
            if rec["state"] != self.CLOSED:
                # a successful probe (or an in-flight request that
                # outlived the trip) is recovery evidence either way
                rec["state"] = self.CLOSED
                rec["open_for"] = self.open_s
                rec["probe_inflight"] = False
                self.closes_total += 1

    def trip(self, backend: str) -> None:
        """Force-open one circuit NOW (the domain-outage mass action:
        when a whole domain is declared down, its other members must
        not each burn ``fail_threshold`` connect attempts first)."""
        now = self._clock()
        with self._lock:
            rec = self._rec(backend)
            if rec["state"] != self.OPEN:
                rec["open_for"] = self.open_s
                self._trip(rec, now)

    def forget(self, backend: str) -> None:
        """Membership churn removed the URL — ports never come back,
        so the record must die with it (unbounded growth otherwise)."""
        with self._lock:
            self._circuits.pop(backend, None)

    def state(self, backend: str) -> str:
        with self._lock:
            rec = self._circuits.get(backend)
            return rec["state"] if rec else self.CLOSED

    def routable(self, candidates) -> list:
        """Pure filter: the candidates traffic may reach this instant —
        closed circuits, plus open ones whose jittered recovery
        deadline has passed and half-open ones with no probe already
        in flight.  No side effects: arming the probe is
        :meth:`on_routed`'s job, on the ONE candidate actually
        picked."""
        now = self._clock()
        out = []
        with self._lock:
            for b in candidates:
                rec = self._circuits.get(b)
                if rec is None or rec["state"] == self.CLOSED:
                    out.append(b)
                elif rec["probe_inflight"]:
                    continue  # one probe at a time
                elif rec["state"] == self.HALF_OPEN or now >= rec["reopen_at"]:
                    out.append(b)
        return out

    def on_routed(self, backend: str) -> None:
        """The router picked ``backend``: if its circuit is non-closed
        this request IS the recovery probe — arm it (one at a time)."""
        with self._lock:
            rec = self._circuits.get(backend)
            if rec is None or rec["state"] == self.CLOSED:
                return
            rec["state"] = self.HALF_OPEN
            rec["probe_inflight"] = True
            self.probes_total += 1

    def open_backends(self) -> list[str]:
        with self._lock:
            return [b for b, rec in self._circuits.items()
                    if rec["state"] == self.OPEN]

    def stats(self) -> dict:
        with self._lock:
            states = [rec["state"] for rec in self._circuits.values()]
        return {
            "circuit_open_backends": states.count(self.OPEN),
            "circuit_half_open_backends": states.count(self.HALF_OPEN),
            "circuit_opens_total": self.opens_total,
            "circuit_closes_total": self.closes_total,
            "circuit_probes_total": self.probes_total,
        }


class RetryBudget:
    """Cluster retry budget (ISSUE 16): re-routes are permitted as a
    CAPPED FRACTION of recent successes, token-bucket style.

    The amplification bound the outage bench pins: N dying replicas
    under a 2x open-loop storm must not multiply into a
    2(1+retries)x storm — with the budget, total forwarded attempts
    stay <= (1 + ratio) * successes (plus the small ``floor_rate``
    trickle that keeps single-failure failover alive when the cluster
    is quiet and the success-funded bucket is empty).

    ``note_success`` deposits ``ratio`` tokens (capped at ``burst``);
    ``try_retry`` spends one, falling back to the floor bucket, and
    returns False when the budget is exhausted — the router then
    answers 503 with a jittered ``Retry-After`` instead of amplifying
    the storm."""

    def __init__(self, ratio: float = 0.2, burst: float = 5.0,
                 floor_rate: float = 0.5,
                 clock: Callable[[], float] = time.monotonic):
        if float(ratio) < 0:
            raise ValueError("ratio must be >= 0")
        if float(burst) < 1:
            raise ValueError("burst must be >= 1")
        self.ratio = float(ratio)
        self.burst = float(burst)
        #: start full: the first failure after a quiet period must be
        #: allowed to fail over without waiting for successes
        self._tokens = self.burst
        self._floor = TokenBucket(max(0.0, float(floor_rate)),
                                  burst=1.0, clock=clock)
        self._lock = threading.Lock()
        self.retries_granted_total = 0
        self.retries_denied_total = 0

    def note_success(self) -> None:
        if self.ratio <= 0:
            return
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def try_retry(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.retries_granted_total += 1
                return True
        if self._floor.rate > 0 and self._floor.try_take() == 0.0:
            with self._lock:
                self.retries_granted_total += 1
            return True
        with self._lock:
            self.retries_denied_total += 1
        return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "retry_budget_tokens": round(self._tokens, 3),
                "retries_granted_total": self.retries_granted_total,
                "retries_denied_total": self.retries_denied_total,
            }


def jittered_retry_after(base: float = 1.0, load: float = 0.0,
                         spread: float = 0.5, cap: float = 30.0,
                         rng: Optional[random.Random] = None) -> float:
    """The ONE retry-after hint: a load-aware base, JITTERED so shed /
    503'd clients do not re-arrive as a synchronized wave (the
    constant ``retry_after=1`` at the router's no-ready-replicas path
    meant every client of a dead domain retried in lockstep —
    herd-safe recovery needs the herd spread out).  Uniform in
    ``[hint*(1-spread), hint*(1+spread)]`` where ``hint = base +
    load``, clamped to ``[0.05, cap]``.  Both the plane's concurrency
    shed ETA and the router's 503 ride this helper — one responder,
    no drifting copies (the PR 8 ``shed_http`` lesson)."""
    r = (_RNG if rng is None else rng).random()
    hint = min(float(cap), max(0.05, float(base) + float(load)))
    spread = max(0.0, min(float(spread), 1.0))
    lo = hint * (1.0 - spread)
    hi = hint * (1.0 + spread)
    return min(float(cap), max(0.05, lo + r * (hi - lo)))


def smooth_wrr_pick(pools: list, cur: list[int]) -> int:
    """Smooth weighted round-robin pool selection (nginx-style):
    deterministic, exact proportions over any window, and INTERLEAVED
    — a block split (first 80 of 100 to stable) would starve the
    canary on short request bursts.  ``pools`` is ``[(urls, weight)]``;
    ``cur`` is the per-pool current-weight state, mutated in place
    (the caller holds whatever lock guards it).  Returns the chosen
    pool index.  Extracted from ``Router._pick`` (ISSUE 20) so the
    live router and the sim twin share one pick policy by
    construction — pure arithmetic, no clock, no rng."""
    total = sum(w for _, w in pools)
    best = 0
    for i, (_, w) in enumerate(pools):
        cur[i] += w
        if cur[i] > cur[best]:
            best = i
    cur[best] -= total
    return best


def live_candidates(urls: list[str], routable: Callable[[list], list],
                    exclude=None, avoid_domains=None,
                    domain_of: Optional[Callable[[str], str]] = None
                    ) -> list[str]:
    """The candidate filter of the router pick (ISSUE 16 semantics,
    extracted for ISSUE 20): drop explicitly excluded urls (already
    tried this request), keep only circuit-routable ones (``routable``
    is :meth:`BackendHealth.routable` — a pure filter), then prefer
    SURVIVING domains over the ones that just failed — but only when
    at least one such candidate exists (with domains unset every url
    maps to ``''`` and the spread no-ops).  Pure given its inputs;
    arming a half-open probe stays the caller's job on the ONE
    backend actually picked."""
    out = [u for u in urls if not exclude or u not in exclude]
    out = routable(out)
    if avoid_domains and out and domain_of is not None:
        spread = [u for u in out
                  if domain_of(u) not in avoid_domains]
        if spread:
            out = spread
    return out


class ClusterPrefixPoller:
    """Router-side block-registry poller (ISSUE 13 satellite, the r16
    residual): scrape every live replica's ``/metrics``
    ``kft_kv_prefix_key`` rows on a JITTERED interval (synchronized
    scrapes across routers would thundering-herd the replicas), feed
    the :class:`KvBlockRegistry`, and keep a per-key replica census so
    the router exports cluster prefix-heat gauges
    (``kft_cluster_prefix_replicas{key=...}``) — placement decisions
    become observable before the autoscaler exists (ROADMAP item 2
    consumes exactly this).

    ``backends``: callable returning the live replica URL list (the
    router's pools are the membership truth).  Blocking HTTP runs on
    this poller's own daemon thread — never a scheduler or reconcile
    worker."""

    def __init__(self, backends: Callable[[], list[str]],
                 registry: Optional[KvBlockRegistry] = None,
                 interval_s: float = 5.0, jitter: float = 0.25,
                 capacity: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.jitter = max(0.0, min(float(jitter), 0.9))
        self._clock = clock
        self._rng = rng if rng is not None else _RNG
        self._backends = backends
        self.registry = registry or KvBlockRegistry()
        self.capacity = int(capacity)
        #: key hex -> {backend: depth} — the census behind the gauges
        self._heat: "collections.OrderedDict[str, dict[str, int]]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        #: unreachable-backend backoff (ISSUE 16 satellite): url ->
        #: (skip-until monotonic deadline, consecutive failures).
        #: During a domain outage the sweep used to burn a full scrape
        #: timeout per dead backend per cycle; now a dead backend is
        #: skipped with per-backend jittered exponential backoff and
        #: re-probed cheaply once its deadline passes.
        self._unreachable: dict[str, tuple[float, int]] = {}
        self.polls_total = 0
        self.poll_skips_total = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="prefix-poller", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            # jittered sleep FIRST: construction must not scrape before
            # the router's pools are even wired
            delay = self.interval_s * (
                1.0 + self._rng.uniform(-self.jitter, self.jitter))
            if self._stop.wait(delay):
                return
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — a scrape cycle
                # failing (replica churn mid-walk) costs one interval,
                # never the poller thread
                log.debug("prefix poll failed: %s", e)

    def poll_once(self) -> int:
        """One scrape sweep over the current backends; returns total
        registry rows seen.  Public for tests and operator tooling."""
        import re
        import urllib.request

        self.polls_total += 1
        urls = list(self._backends() or [])
        now = self._clock()
        with self._lock:
            # membership churn prunes the backoff table with the pool
            self._unreachable = {
                u: v for u, v in self._unreachable.items() if u in urls}
            skipping = {u for u, (until, _n) in self._unreachable.items()
                        if now < until}
        seen: dict[str, dict[str, int]] = {}
        reached: set[str] = set()
        rows_total = 0
        for url in urls:
            if url in skipping:
                # unreachable last sweep(s): inside its jittered
                # backoff window — do NOT burn a scrape timeout on it
                self.poll_skips_total += 1
                continue
            try:
                with urllib.request.urlopen(
                        url.rstrip("/") + "/metrics", timeout=2.0) as r:
                    text = r.read().decode()
            except (OSError, ValueError):
                # timed out / down: keep its prior entries, back off
                # exponentially (jittered so N routers re-probe a
                # recovering replica spread out, not as one wave)
                with self._lock:
                    _until, fails = self._unreachable.get(url, (0.0, 0))
                    fails += 1
                    delay = min(self.interval_s * (2.0 ** (fails - 1)),
                                8.0 * self.interval_s)
                    delay *= 1.0 + self._rng.uniform(-self.jitter,
                                                     self.jitter)
                    self._unreachable[url] = (self._clock() + delay,
                                              fails)
                continue
            reached.add(url)
            with self._lock:
                self._unreachable.pop(url, None)
            rows_total += self.registry.observe_metrics(url, text)
            for key_hex, depth in re.findall(
                    r'^kft_kv_prefix_key\{[^}]*key="([0-9a-f]+)"'
                    r'[^}]*\}\s+(\d+)', text, re.MULTILINE):
                seen.setdefault(key_hex, {})[url] = int(depth)
        with self._lock:
            # merge rule per (key, backend): a REACHED backend's truth
            # is this sweep's rows (entries it stopped advertising
            # drop); a live-but-unreached backend (scrape timeout)
            # keeps its prior entries (one flaky scrape must not flap
            # the heat down); a backend no longer in the pool drops
            # everywhere (its KV died with it — phantom heat forever
            # was the alternative)
            live = set(urls)
            merged: "collections.OrderedDict[str, dict[str, int]]" = \
                collections.OrderedDict()
            for key_hex, per_old in self._heat.items():
                kept = {b: d for b, d in per_old.items()
                        if b in live and b not in reached}
                if kept:
                    merged[key_hex] = kept
            for key_hex, per in seen.items():
                cur = merged.pop(key_hex, {})
                cur.update(per)
                merged[key_hex] = cur  # freshly seen keys are MRU
            self._heat = merged
            while len(self._heat) > self.capacity:
                self._heat.popitem(last=False)
        return rows_total

    def heat(self) -> dict[str, int]:
        """key hex -> number of replicas advertising it."""
        with self._lock:
            return {k: len(v) for k, v in self._heat.items()}

    def heat_by_backend(self) -> dict[str, int]:
        """backend URL -> number of prefix keys it advertises — the
        placement-side view of the census (ISSUE 15): the autoscaler
        retires the replica carrying the LEAST heat, so a scale-down
        costs the fewest warm prefixes."""
        with self._lock:
            out: dict[str, int] = {}
            for per in self._heat.values():
                for b in per:
                    out[b] = out.get(b, 0) + 1
        return out

    def hottest(self, n: int = 8) -> list[tuple[str, int]]:
        """Top-``n`` (key hex, replica count) rows, hottest first —
        the pre-warm working set a freshly placed replica should fetch
        before taking traffic."""
        heat = self.heat()
        return sorted(heat.items(), key=lambda kv: (-kv[1], kv[0]))[:n]

    def metrics_lines(self) -> list[str]:
        """The cluster prefix-heat gauge lines for the router's
        /metrics (TYPE header included; empty when nothing scraped)."""
        heat = self.heat()
        if not heat:
            return []
        lines = ["# TYPE kft_cluster_prefix_replicas gauge"]
        for key_hex in sorted(heat):
            lines.append(
                f'kft_cluster_prefix_replicas{{key="{key_hex}"}} '
                f"{heat[key_hex]}")
        lines.append("# TYPE kft_cluster_prefix_keys gauge")
        lines.append(f"kft_cluster_prefix_keys {len(heat)}")
        return lines

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def prom_label(value) -> str:
    """Escape a Prometheus label VALUE (backslash, quote, newline per
    the text exposition format) — class names and model names are
    arbitrary operator strings, and one stray quote must not poison an
    entire /metrics scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prom_histogram_lines(name: str, labels: str, buckets, counts,
                         total: float, exemplar=None) -> list[str]:
    """Render ONE labeled series of a fixed-bucket Prometheus histogram
    (`_bucket` cumulative + `+Inf`, `_count`, `_sum`).  ``counts`` is
    per-bucket (len(buckets) + 1, last = overflow); ``exemplar`` is an
    optional ``(value_seconds, trace_id)`` attached to the +Inf bucket
    in OpenMetrics syntax.  The ONE histogram renderer — ServerMetrics'
    request-latency histograms and the trace sink's phase histograms
    must stay byte-compatible (the prom_stat_lines rule, one shape
    up)."""
    lines = []
    lbl = f"{labels}," if labels else ""
    cum = 0
    for b, c in zip(buckets, counts):
        cum += c
        lines.append(f'{name}_bucket{{{lbl}le="{b:g}"}} {cum}')
    cum += counts[len(buckets)]
    inf = f'{name}_bucket{{{lbl}le="+Inf"}} {cum}'
    if exemplar is not None:
        inf += (f' # {{trace_id="{prom_label(exemplar[1])}"}}'
                f" {exemplar[0]:.6f}")
    lines.append(inf)
    tail = f"{{{labels}}}" if labels else ""
    lines.append(f"{name}_count{tail} {cum}")
    lines.append(f"{name}_sum{tail} {total:.6f}")
    return lines


def prom_stat_lines(stats: dict, prefix: str,
                    base_labels: str = "") -> dict[str, list[str]]:
    """Render a plane's ``stats()`` into Prometheus families: scalar
    gauges as ``<prefix><key>``, per-class counters with the class as
    an ADDED label.  The ONE renderer — the Router and ModelServer
    exporters must emit byte-compatible lines, so neither carries its
    own walk."""
    fams: dict[str, list[str]] = {}
    for k, v in stats.items():
        if isinstance(v, (int, float)):
            fam = f"{prefix}{k}"
            lbl = f"{{{base_labels}}}" if base_labels else ""
            fams.setdefault(fam, []).append(f"{fam}{lbl} {v}")
    for cname, cvals in stats.get("classes", {}).items():
        cl = f'class="{prom_label(cname)}"'
        lbl = f"{{{base_labels},{cl}}}" if base_labels else f"{{{cl}}}"
        for k, v in cvals.items():
            fam = f"{prefix}{k}"
            fams.setdefault(fam, []).append(f"{fam}{lbl} {v}")
    return fams


def bound_priority(payload: dict, ticket=None,
                   header: Optional[str] = None,
                   classed: bool = False) -> None:
    """Apply the no-self-promotion rule to ``payload['priority']`` in
    place — the ONE enforcement site (the ModelServer door calls it
    with whatever contract it has).  The authoritative tier is the
    ticket's CLASS when this plane classified the tenant, else the
    router's ``X-KFT-Priority`` cluster classification.  When the
    door defines classes (``classed``) but could not classify THIS
    tenant, the cap is "normal" — an anonymous caller must not
    outrank the classed tenants the config exists to order.  A client
    may self-demote below its tier, never outrank it.  Only with no
    ordering contract at all (no class anywhere, no header, or a
    class-free affinity/token-only plane) does the payload stand."""
    auth: Optional[int] = None
    if ticket is not None and ticket.cls is not None:
        auth = ticket.priority
    elif header:
        try:
            auth = priority_tier(header)
        except ValueError:
            auth = None
    if auth is None and ticket is not None and classed:
        auth = PRIORITY_TIERS["normal"]  # classless-at-a-QoS-door cap
    if auth is None:
        return
    asked = payload.get("priority")
    if asked is not None:
        try:
            auth = max(auth, priority_tier(asked))
        except ValueError:
            pass
    payload["priority"] = auth


def shed_http(handler, ticket) -> None:
    """Write the explicit-overload 429 to an http.server handler: a
    ``Retry-After`` header (integer seconds, RFC 7231) + a structured
    reason body.  The ONE shed responder — the Router door and the
    ModelServer door must stay byte-compatible, so neither carries its
    own copy."""
    import json
    import math

    body = json.dumps({
        "error": "request shed by QoS admission",
        "reason": ticket.reason,
        "qos_class": ticket.cls.name if ticket.cls else "",
        "retry_after": round(ticket.retry_after, 3),
    }).encode()
    handler.send_response(429)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Retry-After",
                        str(max(1, math.ceil(ticket.retry_after))))
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class _Ticket:
    """One admitted request's pass through the front door."""

    __slots__ = ("ok", "cls", "tenant", "retry_after", "reason",
                 "waiter")

    def __init__(self, ok: bool, cls: Optional[QosClass], tenant: str,
                 retry_after: float = 0.0, reason: str = "",
                 waiter: Any = None):
        self.ok = ok
        self.cls = cls
        self.tenant = tenant
        self.retry_after = retry_after
        self.reason = reason
        #: queue token for a non-blocking offer() still waiting for a
        #: concurrency slot (promote()/abandon() consume it)
        self.waiter = waiter

    @property
    def priority(self) -> int:
        return self.cls.priority if self.cls is not None else 1

    @property
    def priority_name(self) -> str:
        return _TIER_NAMES[self.priority]


#: door verdicts — what the pure admission policy can say
ADMIT, SHED_RATE, SHED_QUEUE_FULL, QUEUE = (
    "admit", "rate_limited", "queue_full", "queue")


def door_decision(rate_wait: float, live: int, max_concurrent: int,
                  waiting: int, queue_depth: int) -> str:
    """The ONE front-door admission policy (ISSUE 20 extraction):
    given a class's instantaneous state, decide ADMIT / SHED_RATE /
    SHED_QUEUE_FULL / QUEUE.  Pure — no clock, no locks, no counters;
    the blocking :meth:`TrafficPlane.acquire` and the event-driven
    :meth:`TrafficPlane.offer` (the sim twin's door) both actuate
    exactly this verdict, so live and simulated admission cannot
    drift.

    Decision order mirrors the reverse of cost: the token bucket sheds
    instantly (``rate_wait`` > 0 is the tenant's contract), then the
    concurrency gate passes (the fast path DEFERS to the queue — a
    fresh arrival must not snipe a freed slot from a waiter), queues
    (bounded by ``queue_depth``) or sheds."""
    if rate_wait > 0.0:
        return SHED_RATE
    if max_concurrent <= 0 or (live < max_concurrent and not waiting):
        return ADMIT
    if waiting >= queue_depth:
        return SHED_QUEUE_FULL
    return QUEUE


class _ClassState:
    """Live accounting for one QoS class (plane-lock-protected)."""

    def __init__(self, cls: QosClass,
                 clock: Callable[[], float] = time.monotonic):
        self.cls = cls
        self.bucket = TokenBucket(cls.rate, cls.burst, clock=clock)
        self.live = 0
        #: FIFO of waiter tokens — admission order for queued
        #: requests; its head owns the next freed slot
        self.queue: "collections.deque" = collections.deque()
        self.cond: Optional[threading.Condition] = None  # set by plane
        self.admitted_total = 0
        self.shed_total = 0
        self.queued_total = 0

    @property
    def waiting(self) -> int:
        return len(self.queue)


class TrafficPlane:
    """Per-tenant QoS admission + prefix-affinity routing state.

    One instance fronts either the cluster Router (HTTP door: sheds
    with 429 + ``Retry-After`` before a request ever reaches a
    replica) or one ModelServer (in-process door: concurrency slots +
    the engine preemptor).  All state is host-side under one lock;
    ``acquire`` may BLOCK (bounded, timed) when the class queues — that
    blocking is the SSE path's backpressure, and it happens on the
    caller's HTTP thread, never a scheduler thread.

    ``classes``: name -> :class:`QosClass`; ``tenants``: tenant id ->
    class name (a tenant with no mapping and no class of its own name
    falls to ``default_class``, or rides unlimited when that class is
    not defined).
    """

    def __init__(self, qos: Optional[dict] = None,
                 tenants: Optional[dict[str, str]] = None,
                 default_class: str = "default",
                 affinity_block: int = 32,
                 affinity_capacity: int = 8192,
                 tenant_tokens: Optional[dict[str, str]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        classes = validate_qos(qos or {})
        self._lock = threading.Lock()
        self._clock = clock
        self._rng = rng if rng is not None else _RNG
        self._classes: dict[str, _ClassState] = {}
        for name, cls in classes.items():
            st = _ClassState(cls, clock=clock)
            st.cond = threading.Condition(self._lock)
            self._classes[name] = st
        self._tenants = {}
        for k, v in (tenants or {}).items():
            if not isinstance(v, str):
                # class_for would .get() an unhashable/mistyped value
                # at REQUEST time — fail construction instead (the
                # conf-freeze/Failed-status paths catch ValueError)
                raise ValueError(
                    f"qos tenants[{k!r}] must name a class (string), "
                    f"got {type(v).__name__}")
            self._tenants[str(k)] = v
        #: tenant -> bearer secret (Profile.spec.api_token): a tenant
        #: with a registered token must PROVE its claim at the door —
        #: QoS classes are identity-scoped, and an unauthenticated
        #: claim would let any client adopt a privileged tenant's rate
        #: and priority.  Tenants without a token stay open (the
        #: hand-wired/test deployments that never minted credentials).
        self._tenant_tokens = {
            k: v for k, v in (tenant_tokens or {}).items() if v}
        self.default_class = default_class
        #: prompt-prefix affinity granularity, in TOKENS of the byte
        #: tokenizer / block-economy quanta (block_keys units)
        self.affinity_block = int(affinity_block)
        self.affinity = PrefixAffinity(affinity_capacity)
        #: durable-session affinity (ISSUE 12): a resume routes to the
        #: replica still holding the session's KV; a dead replica's
        #: entries are forgotten with its prefix affinity, and the
        #: resume then lands anywhere — the storage tier thaws it
        self.sessions = SessionAffinity(affinity_capacity)
        self.preemptors: list[EnginePreemptor] = []

    # -- class resolution --------------------------------------------------

    def class_for(self, tenant: str) -> Optional[_ClassState]:
        name = self._tenants.get(tenant, tenant)
        st = self._classes.get(name)
        if st is None:
            st = self._classes.get(self.default_class)
        return st

    def classes(self) -> dict[str, QosClass]:
        return {n: st.cls for n, st in self._classes.items()}

    def authenticate(self, tenant: str, authorization) -> bool:
        """True when ``tenant``'s claim is acceptable: either no token
        is registered for it (open tenant), or the ``Authorization``
        header carries the matching Bearer secret (constant-time
        compare)."""
        import hmac

        want = self._tenant_tokens.get(tenant)
        if not want:
            return True
        got = str(authorization or "")
        if got.startswith("Bearer "):
            got = got[len("Bearer "):]
        return hmac.compare_digest(got, want)

    # -- admission (the front door) ---------------------------------------

    def acquire(self, tenant: str = "default", *, charge_rate: bool = True,
                wait_timeout: float = 30.0) -> _Ticket:
        """Admit one request for ``tenant``; the caller MUST
        :meth:`release` the returned ticket iff ``ticket.ok``.

        Decision order mirrors the reverse of cost: the token bucket
        sheds instantly (rate is the tenant's contract), then the
        concurrency gate either passes, queues (bounded by the class's
        ``queue_depth``, timed by ``wait_timeout``) or sheds.  A shed
        ticket carries ``retry_after`` seconds and a structured
        ``reason`` for the 429 body."""
        st = self.class_for(tenant)
        if st is None:
            return _Ticket(True, None, tenant)  # no QoS configured
        cls = st.cls
        rate_wait = st.bucket.try_take() if charge_rate else 0.0
        with self._lock:
            verdict = door_decision(rate_wait, st.live,
                                    cls.max_concurrent, st.waiting,
                                    cls.queue_depth)
            if verdict == SHED_RATE:
                st.shed_total += 1
                return _Ticket(False, cls, tenant,
                               retry_after=max(rate_wait, 0.05),
                               reason="rate_limited")
            if verdict == ADMIT:
                st.live += 1
                st.admitted_total += 1
                return _Ticket(True, cls, tenant)
            if verdict == SHED_QUEUE_FULL:
                st.shed_total += 1
                if charge_rate:
                    # the bucket granted a token but no work happened:
                    # refund it, or concurrency sheds drain the rate
                    # a tenant contracted for
                    st.bucket.refund()
                return _Ticket(False, cls, tenant,
                               retry_after=self._slot_eta(st),
                               reason="queue_full")
            # QUEUE: bounded FIFO admission queue — wait (timed) for a
            # slot; this blocking IS the SSE path's backpressure.  Only
            # the HEAD waiter may take a freed slot (release notifies
            # all: a woken non-head waiter just re-waits), so admission
            # order is arrival order within the class.
            me = object()
            st.queue.append(me)
            st.queued_total += 1
            deadline = self._clock() + wait_timeout
            try:
                while not (st.live < cls.max_concurrent
                           and st.queue[0] is me):
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        st.queue.remove(me)
                        # our departure may make the new head eligible
                        st.cond.notify_all()
                        st.shed_total += 1
                        if charge_rate:
                            st.bucket.refund()
                        return _Ticket(False, cls, tenant,
                                       retry_after=self._slot_eta(st),
                                       reason="queue_timeout")
                    st.cond.wait(remaining)
                st.queue.popleft()
                st.live += 1
                st.admitted_total += 1
                return _Ticket(True, cls, tenant)
            except BaseException:
                if me in st.queue:
                    st.queue.remove(me)
                    st.cond.notify_all()
                raise

    def _slot_eta(self, st: _ClassState) -> float:
        """Honest-ish Retry-After for a concurrency shed: with no
        completion-rate estimate, ~1s per queued-ahead requester is a
        bounded hint, never a promise — JITTERED through the shared
        helper so shed clients of one hot class do not re-arrive in a
        synchronized wave (ISSUE 16 satellite)."""
        return jittered_retry_after(1.0, load=st.waiting,
                                    rng=self._rng)

    # -- the event-driven door (the sim twin's admission) -----------------

    def offer(self, tenant: str = "default", *,
              charge_rate: bool = True) -> _Ticket:
        """Non-blocking :meth:`acquire`: the SAME :func:`door_decision`
        policy, but a would-queue arrival gets a WAITING ticket
        (``ok=False``, ``reason="queued"``, ``waiter`` set) instead of
        blocking this thread — the caller owns the wait (the digital
        twin's event loop models it in virtual time, calling
        :meth:`promote` when capacity frees and :meth:`abandon` on its
        own timeout).  Counters move exactly as the blocking path's
        do, so live and simulated stats stay comparable."""
        st = self.class_for(tenant)
        if st is None:
            return _Ticket(True, None, tenant)
        cls = st.cls
        rate_wait = st.bucket.try_take() if charge_rate else 0.0
        with self._lock:
            verdict = door_decision(rate_wait, st.live,
                                    cls.max_concurrent, st.waiting,
                                    cls.queue_depth)
            if verdict == SHED_RATE:
                st.shed_total += 1
                return _Ticket(False, cls, tenant,
                               retry_after=max(rate_wait, 0.05),
                               reason="rate_limited")
            if verdict == ADMIT:
                st.live += 1
                st.admitted_total += 1
                return _Ticket(True, cls, tenant)
            if verdict == SHED_QUEUE_FULL:
                st.shed_total += 1
                if charge_rate:
                    st.bucket.refund()
                return _Ticket(False, cls, tenant,
                               retry_after=self._slot_eta(st),
                               reason="queue_full")
            me = object()
            st.queue.append(me)
            st.queued_total += 1
            return _Ticket(False, cls, tenant, reason="queued",
                           waiter=me)

    def promote(self, ticket: _Ticket) -> bool:
        """Admit a queued :meth:`offer` ticket iff it is HEAD of its
        class queue and a slot is free — the same only-the-head rule
        the blocking path's Condition loop enforces.  True = the
        ticket is now ok/admitted (caller must release() it)."""
        if ticket.waiter is None or ticket.cls is None:
            return False
        st = self._classes.get(ticket.cls.name)
        if st is None:
            return False
        with self._lock:
            if (st.queue and st.queue[0] is ticket.waiter
                    and st.live < st.cls.max_concurrent):
                st.queue.popleft()
                st.live += 1
                st.admitted_total += 1
                ticket.ok = True
                ticket.reason = ""
                ticket.waiter = None
                return True
        return False

    def abandon(self, ticket: _Ticket, *,
                charge_rate: bool = True) -> None:
        """A queued :meth:`offer` ticket gave up (the caller's
        wait_timeout in virtual time): leave the queue with the same
        accounting as the blocking path's ``queue_timeout`` shed."""
        if ticket.waiter is None or ticket.cls is None:
            return
        st = self._classes.get(ticket.cls.name)
        if st is None:
            return
        with self._lock:
            if ticket.waiter in st.queue:
                st.queue.remove(ticket.waiter)
                # our departure may make the new head eligible
                st.cond.notify_all()
                st.shed_total += 1
                if charge_rate:
                    st.bucket.refund()
                ticket.retry_after = self._slot_eta(st)
        ticket.waiter = None
        ticket.reason = "queue_timeout"

    def release(self, ticket: _Ticket) -> None:
        if not ticket.ok or ticket.cls is None:
            return
        st = self._classes.get(ticket.cls.name)
        if st is None:
            return
        with self._lock:
            st.live = max(0, st.live - 1)
            # notify_all: only the HEAD waiter may take the slot, and
            # Condition wakes an arbitrary waiter — waking just one
            # could wake a non-head that re-waits while the head sleeps
            st.cond.notify_all()

    # -- routing -----------------------------------------------------------

    def prefix_keys(self, tokens) -> list[int]:
        """Prompt tokens (byte-token ids at the router, engine token
        ids at a replica) -> chained block-content keys."""
        from .paged import block_keys

        return block_keys(tokens, self.affinity_block)

    def route(self, keys: list[int], backends: list[str],
              load: Optional[Callable[[str], int]] = None,
              session: Optional[str] = None) -> tuple[str, int]:
        """(backend, affinity depth): the replica already holding the
        deepest prefix of this request, unless it is overloaded
        relative to its peers (> 2x the mean load + 1 — a hot shared
        prefix must not melt one replica); otherwise least-loaded
        (``load`` callable; index 0 on ties/no signal).  The choice is
        recorded so the NEXT same-prefix request finds it.

        ``session`` (ISSUE 12) outranks prefix affinity: a durable
        session's resume goes to the replica whose pool still holds
        its blocks — warm, no thaw.  No overload veto here: moving the
        resume elsewhere pays a storage thaw, strictly worse than a
        busy-but-alive replica.  A session whose replica died routes
        like any fresh request (the storage tier thaws anywhere)."""
        if not backends:
            raise ValueError("route needs at least one backend")
        if session:
            sticky = self.sessions.best(session, backends)
            if sticky is not None:
                self.affinity.observe(keys, sticky)
                self.sessions.observe(session, sticky)
                return sticky, 0
        choice, depth = self.affinity.best(keys, backends)
        if choice is not None and load is not None and len(backends) > 1:
            # overload check against the PEERS' mean: including the
            # chosen backend's own load in the mean made the guard
            # unsatisfiable at 2 replicas (L > L + other + 1)
            others = [load(b) for b in backends if b != choice]
            if others and load(choice) > 2 * (sum(others)
                                              / len(others)) + 1:
                choice, depth = None, 0  # overloaded: fall through
        if choice is None:
            if load is not None:
                choice = min(backends, key=lambda b: (load(b),
                                                      backends.index(b)))
            else:
                choice = backends[0]
        self.affinity.observe(keys, choice)
        if session:
            self.sessions.observe(session, choice)
        return choice, depth

    # -- preemption --------------------------------------------------------

    def attach_engine(self, engine, **kw) -> "EnginePreemptor":
        """Start a priority preemptor over ``engine`` (paged pools
        only — eviction is only cheap because sequences are
        exportable).  Idempotent per engine; ``kw`` tunes
        ``preempt_after_s``/``poll_s`` on first attach."""
        for p in self.preemptors:
            if p.engine is engine:
                return p
        p = EnginePreemptor(engine, **kw)
        self.preemptors.append(p)
        return p

    def stop(self) -> None:
        for p in self.preemptors:
            p.stop()
        self.preemptors = []

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Scalar gauges plus a ``classes`` dict (class name -> its
        counters).  Class names are tenant/Profile names — arbitrary
        strings — so exporters must render them as a ``class`` LABEL,
        never splice them into the metric name (a hyphenated tenant
        would produce an invalid Prometheus name and poison the whole
        exposition)."""
        out: dict[str, Any] = {
            "qos_affinity_hits_total": self.affinity.hits_total,
            "qos_affinity_misses_total": self.affinity.misses_total,
            "session_affinity_hits_total": self.sessions.hits_total,
            "session_affinity_misses_total": self.sessions.misses_total,
        }
        with self._lock:
            out["classes"] = {
                name: {
                    "qos_admitted_total": st.admitted_total,
                    "qos_shed_total": st.shed_total,
                    "qos_queued_total": st.queued_total,
                    "qos_live": st.live,
                    "qos_waiting": st.waiting,
                }
                for name, st in self._classes.items()
            }
        if self.preemptors:
            out["qos_preemptions_total"] = sum(
                p.preemptions_total for p in self.preemptors)
            out["qos_preempt_resumes_total"] = sum(
                p.resumes_total for p in self.preemptors)
            out["qos_preempted_parked"] = sum(
                p.parked() for p in self.preemptors)
        return out


def blocks_needed(prompt_len: int, max_new_tokens: int,
                  block_size: int) -> int:
    """Worst-case block span a request may occupy (ceil division) —
    the capacity question both the live preemptor and the sim twin's
    modeled pool ask."""
    return -(-(int(prompt_len) + int(max_new_tokens))
             // int(block_size))


def best_pending(waiting, now: float, preempt_after_s: float,
                 policy: Optional[Callable] = None):
    """(tier, req) of the best-tier submitted-but-unadmitted request
    that has waited past the preemption threshold AND whose wait
    eviction could actually end, else (None, None).  Pure given its
    inputs (``now`` is the caller's injected clock) — the ISSUE 20
    extraction of ``EnginePreemptor._pending_best``.

    A request deferred by the engine's ``admission_policy`` (the tier
    ladder's class quota, say) is blocked by POLICY, not capacity:
    evicting a victim frees nothing it may use, and the freed slot
    would be re-consumed by other traffic — serial eviction churn of
    healthy streams.  The probe requires the policy to be read-only
    host logic; a raising policy skips the demand rather than
    evicting on a guess."""
    best: Optional[int] = None
    best_req = None
    for req in waiting:
        if req.done.is_set():
            continue
        if now - req.submitted_at < preempt_after_s:
            continue
        if policy is not None:
            try:
                if not policy(req):
                    continue  # policy-deferred, not capacity-blocked
            except Exception:  # noqa: BLE001 — never evict on a guess
                continue
        tier = getattr(req, "priority", 1)
        if best is None or tier < best:
            best, best_req = tier, req
    return best, best_req


def choose_victim(slots, better_than: int, frozen=()):
    """The live victim with the WORST tier strictly greater than
    ``better_than`` (ties: fewest generated tokens — the cheapest
    snapshot), or None.  ``slots`` is ``(slot_index, req)`` pairs;
    ``frozen`` slots (mid-migration/resize) are never victims —
    another orchestrator owns their cutover, and evicting one here
    would fork ownership (two snapshots, one handle, double-decode on
    whichever side wins).  Pure — the ISSUE 20 extraction of
    ``EnginePreemptor._live_worst``, shared with the sim twin's
    modeled preemption."""
    frozen = set(frozen)
    worst = None
    key = None
    for slot, req in slots:
        if req is None or req.done.is_set():
            continue
        if slot in frozen:
            continue
        tier = getattr(req, "priority", 1)
        if tier <= better_than:
            continue
        k = (-tier, len(req.tokens))
        if key is None or k < key:
            worst, key = req, k
    return worst


class EnginePreemptor:
    """Evict-and-requeue for priority inversion on a full paged pool.

    A worker thread watches the engine: when a request of tier T waits
    unadmitted past ``preempt_after_s`` while a live sequence of a
    WORSE tier occupies the pool, the worst such victim is exported
    (PR 7 snapshot — the parity suite's guarantee that resumed tokens
    are bit-identical), released (slot + blocks free instantly), and
    PARKED.  The engine's priority-sorted waiting list then admits the
    high request first.  Parked sequences re-import — same Request
    handle, so streams just resume — as soon as no better-tier demand
    waits and the pool has their span again; import-side exhaustion is
    retried, never fatal.  All of this runs on the preemptor thread:
    export/import are the engine's own mailbox ops, so the scheduler
    thread never blocks here (the analyzer's ``*Preemptor`` root walk
    keeps it that way).
    """

    def __init__(self, engine, preempt_after_s: float = 0.05,
                 poll_s: float = 0.01,
                 clock: Callable[[], float] = time.perf_counter):
        if not getattr(engine, "paged", False):
            raise ValueError(
                "priority preemption requires the paged pool "
                "(block_size > 0) — eviction is only cheap when the "
                "sequence is exportable")
        self.engine = engine
        self.preempt_after_s = float(preempt_after_s)
        self.poll_s = float(poll_s)
        self._clock = clock
        #: parked snapshots: (tier, parked_at, req, snapshot)
        self._parked: list[tuple[int, float, Any, dict]] = []
        self._lock = threading.Lock()
        self.preemptions_total = 0
        self.resumes_total = 0
        self._stopping = threading.Event()
        self._thread = threading.Thread(
            target=self._loop_preempt, name="qos-preemptor", daemon=True)
        self._thread.start()

    # -- demand / victim observation (reads scheduler-owned state the
    # same way migrate_live_sequences does: list() copies under the GIL,
    # decisions double-checked by the mailbox ops themselves) ----------

    def _pending_best(self):
        """Delegates to the pure :func:`best_pending` policy with the
        injected clock and this engine's admission-policy probe."""
        return best_pending(
            list(self.engine._waiting), self._clock(),
            self.preempt_after_s,
            policy=getattr(self.engine, "admission_policy", None))

    def _capacity_blocked(self, req) -> bool:
        """True when ``req`` genuinely cannot admit — no free slot, or
        the block pool cannot host its worst-case span.  Without this
        gate the preemptor would evict a victim every poll while the
        scheduler is merely one cycle away from admitting naturally."""
        eng = self.engine
        if not any(r is None for r in list(eng._slots)):
            return True
        need = blocks_needed(len(req.prompt), req.max_new_tokens,
                             eng.block_size)
        return eng._alloc.free_blocks < need

    def _live_worst(self, better_than: int):
        """Delegates to the pure :func:`choose_victim` policy over a
        snapshot of the slot table (list() copies under the GIL; the
        mailbox ops double-check the decision)."""
        return choose_victim(
            enumerate(list(self.engine._slots)), better_than,
            frozen=set(self.engine._migrating))

    # -- the loop ----------------------------------------------------------

    def _loop_preempt(self) -> None:
        # idle backoff: a QoS-enabled but quiet deployment must not
        # burn a 100 Hz poll per engine forever.  Doubling up to the
        # preemption threshold adds at most ~one threshold of extra
        # detection latency — which the demand must wait out anyway —
        # while any action resets to the tight cadence.
        idle_cap = max(self.poll_s, self.preempt_after_s, 0.05)
        wait = self.poll_s
        while not self._stopping.is_set():
            try:
                acted = self._step()
            except Exception as e:  # noqa: BLE001 — a dead engine must
                # not kill the preemptor silently; parked requests are
                # failed by stop()/engine shutdown, new work just waits
                log.debug("preemptor step failed: %s", e)
                acted = False
            if acted:
                wait = self.poll_s
            else:
                busy = bool(self._parked) or bool(self.engine._waiting)
                wait = self.poll_s if busy else min(wait * 2, idle_cap)
                self._stopping.wait(wait)

    def _step(self) -> bool:
        demand, demand_req = self._pending_best()
        if demand is not None and self._capacity_blocked(demand_req):
            victim = self._live_worst(demand)
            if victim is not None:
                return self._preempt(victim)
        return self._try_resume(demand)

    def _preempt(self, victim) -> bool:
        try:
            snap = self.engine.export_sequence(victim)
        except (RuntimeError, TimeoutError) as e:
            log.debug("preempt export failed: %s", e)
            try:
                self.engine.resume_sequence(victim)
            except (RuntimeError, TimeoutError):
                pass
            return False
        if snap is None:
            return False  # finished first — the slot is already free
        self.engine.release_sequence(victim)
        tier = getattr(victim, "priority", 1)
        tr = getattr(victim, "trace", None)
        if tr is not None:
            # parked time is its own phase (a stall CAUSE the trace
            # attributes): ends when the re-import activates the slot
            tr.begin("preempt.park", tier=tier).done()
            tr.phase("engine.preempted", tier=tier)
            tr.meta["stall"] = "preempted"
        with self._lock:
            self._parked.append((tier, self._clock(), victim, snap))
        self.preemptions_total += 1
        log.debug("preempted tier-%d sequence (%d tokens generated) "
                  "for higher-priority demand", tier, len(victim.tokens))
        return True

    def _try_resume(self, pending_tier: Optional[int]) -> bool:
        with self._lock:
            if not self._parked:
                return False
            # best tier first, then FIFO — the inverse of eviction order
            self._parked.sort(key=lambda p: (p[0], p[1]))
            candidates = list(self._parked)
        for entry in candidates:
            tier, _t, req, snap = entry
            if req.done.is_set() or req.cancelled.is_set():
                with self._lock:  # client gave up while parked
                    if entry in self._parked:
                        self._parked.remove(entry)
                if not req.done.is_set():
                    req.done.set()
                continue
            if pending_tier is not None and pending_tier <= tier:
                return False  # better demand still waiting: stay parked
            try:
                self.engine.import_sequence(snap, req=req)
            except RuntimeError:
                return False  # pool still full: retry next poll
            except TimeoutError:
                return False
            with self._lock:
                if entry in self._parked:
                    self._parked.remove(entry)
            tr = getattr(req, "trace", None)
            if tr is not None:
                tr.begin("preempt.unpark", tier=tier).done()
            self.resumes_total += 1
            return True
        return False

    def parked(self) -> int:
        with self._lock:
            return len(self._parked)

    def stats(self) -> dict:
        return {
            "qos_preemptions_total": self.preemptions_total,
            "qos_preempt_resumes_total": self.resumes_total,
            "qos_preempted_parked": self.parked(),
        }

    def stop(self, fail_parked: bool = True) -> None:
        self._stopping.set()
        self._thread.join(timeout=5)
        if not fail_parked:
            return
        with self._lock:
            parked, self._parked = self._parked, []
        for _tier, _t, req, _snap in parked:
            if not req.done.is_set():
                req.error = RuntimeError(
                    "preempted sequence abandoned at shutdown")
                req.done.set()
