"""The modeled half of the twin: replicas, network, cold starts.

Everything that *decides* here is a real production object — the
:class:`~kubeflow_tpu_torch.serving.controller.Router` (smooth-WRR pools,
health circuits, retry budget, domain mass-forget, prefix/session
affinity), the :class:`~kubeflow_tpu_torch.serving.traffic.TrafficPlane`
door (:func:`door_decision` via ``offer``/``promote``/``abandon``),
and the :class:`~kubeflow_tpu_torch.serving.autoscale.ClusterAutoscaler`
(``decide`` + cooldowns + emergency surge), all constructed on the
simulator's virtual clock and seeded rng.  Everything that *costs*
is modeled: request service times come from per-phase distributions
(queue/prefill/decode/handoff — the r17 phase-histogram tiles that
sum to e2e), cold starts from a warm/cold pair of distributions (the
r21 AOT split), and re-route hops from the handler's jitter window.

The fleet mirrors the live wiring faithfully enough that its failure
behavior is the production behavior: a killed replica's in-flight
requests take the handler's retry path (``_backend_down`` -> budget
``try_retry`` -> re-pick with ``exclude``/``avoid_domains``), so PR
16's amplification bound and exactly-once outage detection are
exercised on the REAL circuit/budget/mass-forget code at 100x the
replica count the live harness can afford.

The port's copy of ``kubeflow_tpu/sim/fleet.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional

from ..serving.autoscale import AutoscalePolicy, ClusterAutoscaler
from ..serving.controller import Router
from ..serving.traffic import TrafficPlane, jittered_retry_after
from .core import Simulator


class PhaseCosts:
    """Per-phase service-time model, the r17 histogram tiles as
    distributions: ``handoff`` (queue->slot + detokenize/transfer,
    per request), ``prefill`` (per prompt token), ``decode`` (per
    generated token).  A sample is the tile sum times a lognormal
    noise factor — seeded rng in, deterministic sample out.  The
    defaults approximate the tiny-engine CPU stand-in the serving
    benches run; ``scale`` stretches all tiles together (fleet-scale
    scenarios use slower "replicas" so queueing dynamics dominate)."""

    def __init__(self, handoff_s: float = 0.004,
                 prefill_tok_s: float = 0.0015,
                 decode_tok_s: float = 0.006,
                 sigma: float = 0.25, scale: float = 1.0):
        self.handoff_s = handoff_s * scale
        self.prefill_tok_s = prefill_tok_s * scale
        self.decode_tok_s = decode_tok_s * scale
        self.sigma = sigma

    def sample(self, rng, prompt_tokens: int, new_tokens: int) -> float:
        base = (self.handoff_s + self.prefill_tok_s * prompt_tokens
                + self.decode_tok_s * new_tokens)
        return base * math.exp(rng.gauss(0.0, self.sigma))

    @classmethod
    def from_phase_totals(cls, totals: dict, *, prompt_tokens: int = 8,
                          new_tokens: int = 16,
                          sigma: float = 0.25) -> "PhaseCosts":
        """Calibrate the tiles from a live run's r17 phase totals
        (``phase -> (count, total_seconds)``, the TraceSink histogram
        aggregate): mean queue+handoff per request, prefill/decode
        normalized per token of the workload they were measured on —
        so the twin's e2e tile sum matches the measured histograms."""
        def mean(ph: str) -> float:
            n, s = totals.get(ph, (0, 0.0))
            return s / n if n else 0.0
        return cls(
            handoff_s=mean("handoff") + mean("queue"),
            prefill_tok_s=(mean("prefill") / max(prompt_tokens, 1))
            or 0.0015,
            decode_tok_s=(mean("decode") / max(new_tokens, 1)) or 0.006,
            sigma=sigma)


class SimRequest:
    """One modeled request moving through the REAL door/route policy.
    ``state`` walks pending -> (queued ->) active -> done, or ends in
    shed/failed; anything non-terminal when the run drains is a LEAK
    (a hung request — the invariant PR 16 pins at live scale)."""

    __slots__ = ("rid", "cls", "tenant", "session", "keys", "t_arrive",
                 "t_done", "state", "attempts", "backend", "ticket",
                 "reason", "prompt_tokens", "new_tokens")

    def __init__(self, rid: int, cls: str, tenant: str, t: float, *,
                 session: str = "", keys=None,
                 prompt_tokens: int = 8, new_tokens: int = 16):
        self.rid = rid
        self.cls = cls
        self.tenant = tenant
        self.session = session
        self.keys = keys or []
        self.t_arrive = t
        self.t_done: Optional[float] = None
        self.state = "pending"
        self.attempts = 0
        self.backend: Optional[str] = None
        self.ticket = None
        self.reason = ""
        self.prompt_tokens = prompt_tokens
        self.new_tokens = new_tokens

    @property
    def terminal(self) -> bool:
        return self.state in ("done", "shed", "failed")


class SimReplica:
    """A modeled engine: ``slots`` concurrent requests, FIFO overflow
    queue (the engine-side queue tile), an epoch counter that
    invalidates scheduled completions when the replica dies — the sim
    analog of a connection reset mid-stream."""

    __slots__ = ("url", "domain", "slots", "state", "epoch",
                 "active", "queue")

    def __init__(self, url: str, domain: str, slots: int):
        self.url = url
        self.domain = domain
        self.slots = slots
        self.state = "warming"   # warming -> up -> draining | down
        self.epoch = 0
        self.active: list[SimRequest] = []
        self.queue: deque = deque()

    @property
    def load(self) -> int:
        return len(self.active) + len(self.queue)


class SimFleet:
    """Replica lifecycle + request transport around the real policy
    objects.  The router is a ``serve=False``
    :class:`~kubeflow_tpu_torch.serving.controller.Router` — the production
    pick/circuit/budget/mass-forget object with no HTTP server — and
    the plane is a real :class:`TrafficPlane`; both tick on the
    simulator's clock and draw jitter from its seeded rng."""

    def __init__(self, sim: Simulator, *, max_replicas: int,
                 min_replicas: int = 1, slots_per_replica: int = 4,
                 domains: int = 0, costs: Optional[PhaseCosts] = None,
                 qos: Optional[dict] = None,
                 tenants: Optional[dict] = None,
                 cold_start_s: float = 1.6, warm_start_s: float = 0.3,
                 queue_timeout_s: float = 2.0,
                 request_timeout_s: float = 10.0,
                 reroute_min_s: float = 0.01,
                 reroute_max_s: float = 0.05):
        self.sim = sim
        self.max_replicas = int(max_replicas)
        self.min_replicas = int(min_replicas)
        self.slots = int(slots_per_replica)
        self.costs = costs or PhaseCosts()
        self.domain_names = [f"zone-{i}" for i in range(int(domains))]
        self.cold_start_s = cold_start_s
        self.warm_start_s = warm_start_s
        self.queue_timeout_s = queue_timeout_s
        self.request_timeout_s = request_timeout_s
        self.reroute_min_s = reroute_min_s
        self.reroute_max_s = reroute_max_s

        self.router = Router(lambda: None, clock=sim.clock,
                             rng=sim.rng, serve=False)
        self.plane = TrafficPlane(qos=qos or {}, tenants=tenants,
                                  clock=sim.clock, rng=sim.rng)
        self.router.set_traffic(self.plane)

        self.replicas: dict[str, SimReplica] = {}
        self._made = 0
        self.pending = 0            # replicas warming (capacity-to-be)
        self.warm_cache_seeded = False   # r21: first boot is cache-cold
        self.requests: list[SimRequest] = []
        self._door_waiting: list[SimRequest] = []
        self._unrouted: list[SimRequest] = []
        self.replica_trace: list[tuple] = [(0.0, 0)]
        self.latencies: dict[str, list] = {}
        self.completed = 0
        self.admitted = 0
        self.forwards = 0           # connect attempts (amplification)
        self.retries_granted = 0
        self.failed: dict[str, int] = {}
        self.shed: dict[str, int] = {}
        self.cold_samples: list[tuple] = []   # (seconds, warm)
        self.wakes = 0
        self._last_arrival = 0.0

    # -- replica lifecycle -------------------------------------------------

    def n_up(self) -> int:
        return sum(1 for r in self.replicas.values()
                   if r.state == "up")

    def n_billed(self) -> int:
        return self.n_up() + self.pending

    def _wire(self) -> None:
        """Keep the real router's membership in lockstep with the UP
        fleet — the controller's ``_wire`` analog.  Dead replicas stay
        wired (matching a controller that has not reconciled yet):
        DETECTING them is the circuits' job, which is the behavior
        under test."""
        urls = [u for u, r in self.replicas.items()
                if r.state in ("up", "down")]
        self.router.set_backends(urls)
        if self.domain_names:
            self.router.set_domains(
                {u: self.replicas[u].domain for u in urls})

    def _trace_point(self) -> None:
        n = self.n_billed()
        if n != self.replica_trace[-1][1]:
            self.replica_trace.append((self.sim.now, n))

    def add_replica(self, on_cold_start=None) -> None:
        """Spawn one replica: it warms off the decision path (the
        bench's ``add_replica_async`` shape) and joins the pools when
        ready.  The first boot ever is AOT-cache-cold; every later
        boot takes the warm path — the r21 split ``note_cold_start``
        tags so the scale-to-zero gate budgets the warm EWMA."""
        if self.n_billed() >= self.max_replicas:
            raise RuntimeError("at max replicas")
        self._made += 1
        url = f"sim://replica-{self._made}"
        domain = ""
        if self.domain_names:
            # zone-aware placement: never schedule INTO a domain that
            # is currently down (the live scheduler's unhealthy-zone
            # avoidance) — otherwise a mid-outage scale-up would plant
            # healthy members in the dead zone and the outage detector
            # could never see the domain fully dark
            down = {r.domain for r in self.replicas.values()
                    if r.state == "down"}
            cands = [d for d in self.domain_names if d not in down]
            cands = cands or self.domain_names
            domain = cands[self._made % len(cands)]
        rep = SimReplica(url, domain, self.slots)
        self.replicas[url] = rep
        self.pending += 1
        warm = self.warm_cache_seeded
        base = self.warm_start_s if warm else self.cold_start_s
        cold = base * math.exp(self.sim.rng.gauss(0.0, 0.2))
        self._trace_point()

        def ready():
            self.pending -= 1
            if rep.state != "warming":     # killed while warming
                return
            rep.state = "up"
            self.warm_cache_seeded = True
            self.cold_samples.append((cold, warm))
            self._wire()
            self._trace_point()
            if on_cold_start is not None:
                on_cold_start(cold, warm=warm)
            self._flush_unrouted()
        self.sim.after(cold, ready)

    def remove_replica(self) -> None:
        """Retire the least-loaded UP replica losslessly: it leaves
        the pools now, finishes its in-flight work, then disappears —
        the drain-through-migration semantics of the live fleet."""
        up = [r for r in self.replicas.values() if r.state == "up"]
        if len(up) <= 1:
            raise RuntimeError("at replica floor")
        victim = min(up, key=lambda r: r.load)
        victim.state = "draining"
        self._wire()
        self._trace_point()
        self._reap_drained(victim)

    def scale_to_zero(self) -> None:
        for rep in list(self.replicas.values()):
            if rep.state == "up":
                rep.state = "draining"
                self._reap_drained(rep)
        self._wire()
        self._trace_point()

    def wake(self, on_cold_start=None) -> None:
        self.wakes += 1
        if self.n_billed() == 0:
            self.add_replica(on_cold_start)

    def _reap_drained(self, rep: SimReplica) -> None:
        if rep.state == "draining" and rep.load == 0:
            self.replicas.pop(rep.url, None)

    def kill_domain(self, domain: str) -> None:
        """Correlated failure: every replica of ``domain`` dies at
        once.  In-flight requests hit the handler's retry path — each
        pays a ``_backend_down`` (circuit evidence) and a budgeted
        re-pick that avoids the failing domain, exactly the live
        storm shape from PR 16."""
        for url, rep in list(self.replicas.items()):
            if rep.domain != domain or rep.state in ("down",):
                continue
            was_warming = rep.state == "warming"
            rep.state = "down"
            rep.epoch += 1
            victims = list(rep.active) + list(rep.queue)
            rep.active.clear()
            rep.queue.clear()
            if was_warming:
                # a replica killed mid-warm-up never became ready, so
                # the controller never wired it — it is a failed
                # creation, not a pool member.  Keeping it wired would
                # plant a zero-traffic corpse whose circuit stays
                # closed forever and the outage detector ("EVERY
                # member open") could never fire.
                del self.replicas[url]
                continue
            for req in victims:
                self.router._note(url, -1, error=True)
                req.state = "retrying"
                self._retry(req, url, {url})
        self._wire()
        self._trace_point()

    def revive_domain(self, domain: str) -> None:
        """The outage window closed: the domain's replicas restart
        (fresh epoch, empty queues) and the next successful forward
        re-arms the outage detector via ``_backend_up``."""
        for rep in self.replicas.values():
            if rep.domain == domain and rep.state == "down":
                rep.state = "up"
                rep.epoch += 1
        self._wire()

    # -- autoscaler wiring -------------------------------------------------

    def signals(self, target_concurrency: float) -> dict:
        """The sensor snapshot, MiniFleet.signals' shape plus the
        fleet-scope keys (``unhealthy_frac`` feeds emergency surge,
        ``idle_s``/``pending`` feed scale-to-zero/wake)."""
        up = [r for r in self.replicas.values() if r.state == "up"]
        live = sum(r.load for r in up)
        pool = self.router.backends()
        open_n = sum(1 for u in pool
                     if self.router.health.state(u) == "open")
        n = len(up) + self.pending
        sig = {
            "replicas": n, "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "util": live / max(len(up), 1)
            / max(target_concurrency, 1e-9),
            "free_block_ratio": 1.0,
            "live": float(live),
            "unhealthy_frac": open_n / max(len(pool), 1),
        }
        if self.min_replicas == 0:
            sig["idle_s"] = self.sim.now - self._last_arrival
            sig["pending"] = float(len(self._unrouted)
                                   + len(self._door_waiting))
        return sig

    def make_autoscaler(self, policy: AutoscalePolicy, *,
                        failpoint=None,
                        record: Optional[list] = None
                        ) -> ClusterAutoscaler:
        """A REAL :class:`ClusterAutoscaler` on the virtual clock,
        actuating this fleet.  ``record`` (if given) collects
        ``(now, raw_signals)`` per tick — the parity test replays
        exactly that stream through a fresh autoscaler to prove the
        twin's decisions come from the production ``decide``/``tick``
        and nothing else."""
        def sensors():
            sig = self.signals(policy.target_concurrency)
            if record is not None:
                record.append((self.sim.now, dict(sig)))
            return sig

        auto = ClusterAutoscaler(
            policy, sensors=sensors, clock=self.sim.clock,
            failpoint=failpoint,
            actuators={
                "replica_up": lambda dec: self._grow(
                    dec, auto.note_cold_start),
                "replica_down": lambda dec: self.remove_replica(),
                "zero": lambda dec: self.scale_to_zero(),
            })
        return auto

    def _grow(self, dec, on_cold_start) -> None:
        if dec.action == "wake":
            self.wakes += 1
        want = max(int(dec.replicas or 0) - self.n_billed(), 1)
        for _ in range(want):
            if self.n_billed() >= self.max_replicas:
                break
            self.add_replica(on_cold_start)

    # -- the request path --------------------------------------------------

    def submit(self, cls: str, *, tenant: Optional[str] = None,
               session: str = "", keys=None,
               prompt_tokens: int = 8,
               new_tokens: int = 16) -> SimRequest:
        """One arrival: real door (``offer``), then real route
        (``Router._pick``), then modeled service.  Every request is
        bounded by ``request_timeout_s`` — the client deadline — so a
        hung request shows up as a failed row, never a stuck event."""
        now = self.sim.now
        self._last_arrival = now
        req = SimRequest(len(self.requests), cls, tenant or cls, now,
                         session=session, keys=keys,
                         prompt_tokens=prompt_tokens,
                         new_tokens=new_tokens)
        self.requests.append(req)
        self.latencies.setdefault(cls, [])
        ticket = self.plane.offer(req.tenant)
        req.ticket = ticket
        if ticket.ok:
            self.admitted += 1
            self._route(req)
        elif ticket.reason == "queued":
            req.state = "queued"
            self._door_waiting.append(req)
            self.sim.after(self.queue_timeout_s,
                           lambda: self._door_timeout(req))
        else:
            self._shed(req, ticket.reason)
        if not req.terminal:
            self.sim.after(self.request_timeout_s,
                           lambda: self._client_deadline(req))
        return req

    def _client_deadline(self, req: SimRequest) -> None:
        """The client's end-to-end deadline, enforced at every stage:
        a request still door-queued, unrouted, engine-queued or even
        mid-service when the deadline passes is a hung-up client, not
        a forever-parked event.  Without this, one hotspotted replica
        (sticky sessions all rebinding to the same survivor during an
        outage) parks a queue of requests past the end of the run and
        the leak audit cannot tell a slow drain from a true hang."""
        if req.terminal:
            return
        if req.state == "queued":
            self._door_timeout(req)
            return
        if req in self._unrouted:
            self._unrouted.remove(req)
        rep = self.replicas.get(req.backend) if req.backend else None
        if rep is not None:
            if req in rep.queue:
                rep.queue.remove(req)
                self.router._note(rep.url, -1)
            elif req in rep.active:
                rep.active.remove(req)
                self.router._note(rep.url, -1)
                if rep.queue and rep.state in ("up", "draining"):
                    self._begin(rep, rep.queue.popleft())
                self._reap_drained(rep)
        self._fail(req, "deadline_exceeded")

    def _shed(self, req: SimRequest, reason: str) -> None:
        req.state = "shed"
        req.reason = reason
        req.t_done = self.sim.now
        self.shed[reason] = self.shed.get(reason, 0) + 1
        self.latencies[req.cls].append(float("inf"))

    def _fail(self, req: SimRequest, reason: str) -> None:
        req.state = "failed"
        req.reason = reason
        req.t_done = self.sim.now
        self.failed[reason] = self.failed.get(reason, 0) + 1
        self.latencies[req.cls].append(float("inf"))
        self._release(req)

    def _release(self, req: SimRequest) -> None:
        if req.ticket is not None and req.ticket.ok:
            self.plane.release(req.ticket)
            req.ticket = None
            self._drain_door()

    def _door_timeout(self, req: SimRequest) -> None:
        if req.state != "queued":
            return
        self.plane.abandon(req.ticket)
        if req in self._door_waiting:
            self._door_waiting.remove(req)
        self._shed(req, "queue_timeout")

    def _drain_door(self) -> None:
        """A slot freed: promote door-queued arrivals (head-of-class
        rule enforced by the plane itself) in arrival order."""
        progressed = True
        while progressed:
            progressed = False
            for req in list(self._door_waiting):
                if req.state != "queued":
                    self._door_waiting.remove(req)
                    continue
                if self.plane.promote(req.ticket):
                    self._door_waiting.remove(req)
                    req.state = "pending"
                    self.admitted += 1
                    self._route(req)
                    progressed = True

    def _route(self, req: SimRequest) -> None:
        # only an unrouted request may route: the no-backend client
        # retry and the replica-ready flush can both fire for the same
        # request — whichever lands second must no-op, or the request
        # would be double-forwarded (double-booked slots, torn counts)
        if req.state != "pending":
            return
        backend = self.router._pick(keys=req.keys,
                                    session=req.session or None)
        if backend is None:
            # no ready replicas: the live router 503s with Retry-After
            # and pokes the activator; the modeled client re-tries on
            # that hint until its deadline
            self.router.no_backend_total += 1
            if req not in self._unrouted:
                self._unrouted.append(req)
            if self.sim.now - req.t_arrive >= self.request_timeout_s:
                self._unrouted.remove(req)
                self._fail(req, "no_ready_replicas")
                return
            self.sim.after(
                min(jittered_retry_after(0.2, rng=self.sim.rng), 0.5),
                lambda: self._route(req))
            return
        if req in self._unrouted:
            self._unrouted.remove(req)
        self._forward(req, backend, set())

    def _flush_unrouted(self) -> None:
        for req in list(self._unrouted):
            if not req.terminal:
                self._route(req)

    def _forward(self, req: SimRequest, backend: str,
                 tried: set) -> None:
        """One connect attempt — the Handler forward loop's policy on
        modeled transport."""
        if req.terminal:
            return
        self.forwards += 1
        req.attempts += 1
        self.router._note(backend, +1)
        rep = self.replicas.get(backend)
        if rep is None or rep.state not in ("up", "draining"):
            self.router._note(backend, -1, error=True)
            self._retry(req, backend, tried | {backend})
            return
        req.state = "active"
        req.backend = backend
        if len(rep.active) < rep.slots:
            self._begin(rep, req)
        else:
            rep.queue.append(req)

    def _retry(self, req: SimRequest, failed: str, tried: set) -> None:
        """Connection failure: circuit evidence first, then a budgeted
        re-pick that excludes every corpse tried and avoids their
        failure domains — the Handler's exact policy sequence."""
        self.router._backend_down(failed)
        if not self.router.retry_budget.try_retry():
            self._fail(req, "retry_budget_exhausted")
            return
        self.retries_granted += 1
        avoid = {self.router.domain_of(u) for u in tried
                 if self.router.domain_of(u)}
        nxt = self.router._pick(keys=req.keys,
                                session=req.session or None,
                                exclude=tried, avoid_domains=avoid)
        if nxt is None:
            self._fail(req, "no_ready_replicas")
            return
        req.state = "retrying"
        self.sim.after(
            self.sim.rng.uniform(self.reroute_min_s,
                                 self.reroute_max_s),
            lambda: self._forward(req, nxt, tried))

    def _begin(self, rep: SimReplica, req: SimRequest) -> None:
        rep.active.append(req)
        svc = self.costs.sample(self.sim.rng, req.prompt_tokens,
                                req.new_tokens)
        epoch = rep.epoch
        self.sim.after(svc, lambda: self._finish(rep, req, epoch))

    def _finish(self, rep: SimReplica, req: SimRequest,
                epoch: int) -> None:
        if rep.epoch != epoch or req.state != "active":
            return                      # replica died mid-stream
        rep.active.remove(req)
        self.router._note(rep.url, -1)
        self.router._backend_up(rep.url)
        req.state = "done"
        req.t_done = self.sim.now
        self.completed += 1
        self.latencies[req.cls].append(req.t_done - req.t_arrive)
        self._release(req)
        if rep.queue and rep.state in ("up", "draining"):
            self._begin(rep, rep.queue.popleft())
        self._reap_drained(rep)

    # -- audit -------------------------------------------------------------

    def leaked(self) -> dict:
        """End-of-run leak audit: non-terminal requests (hung), and
        affinity/session rows still pointing at dead replicas (state
        the mass-forget should have reclaimed)."""
        hung = sum(1 for r in self.requests if not r.terminal)
        dead = {u for u, r in self.replicas.items()
                if r.state == "down"}
        stale = 0
        for reg in (self.plane.affinity, self.plane.sessions):
            amap = getattr(reg, "_map", {})
            stale += sum(1 for b in amap.values() if b in dead)
        return {"hung_requests": hung, "stale_affinity_rows": stale}
