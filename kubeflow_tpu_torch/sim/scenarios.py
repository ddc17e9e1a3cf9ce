"""The scenario catalog: seeded outage stories, scored as JSON rows.

Each scenario builds a :class:`~kubeflow_tpu_torch.sim.core.Simulator`, a
:class:`~kubeflow_tpu_torch.sim.fleet.SimFleet` around the real policy
objects, runs a seeded story, and returns one deterministic score
dict (SLO attainment through the shared
:func:`~kubeflow_tpu_torch.sim.traces.slo_attainment` scorer, shed/failed
counts, retry amplification, exactly-once outage detection, leaked
state).  :func:`score_json` serializes a score byte-stably — same
scenario + same seed = the same bytes, which is the twin's regression
contract: a policy change that shifts a score shows up as a diff, not
a flake.

Catalog rows (``scripts/twin_bench.py`` runs them; tests mark the
fleet-scale ones ``slow``):

- ``smoke``        — door -> route -> decide -> actuate in one breath
- ``diurnal``      — the bench's multi-tenant day (4 .. 500 replicas)
- ``domain_outage``— zone loss + thundering-herd re-route at 100+
  replicas: PR 16's amplification <= 1.2 and exactly-once invariants
- ``cold_start_storm`` — scale-to-zero wake storms under the r21
  warm/cold EWMAs
- ``noisy_neighbor``   — one flooding tenant vs the QoS door
- ``chaos_fleet``  — a seeded :class:`FaultPlan` (domain outage +
  actuator failures) replayed as sim events

The port's copy of ``kubeflow_tpu/sim/scenarios.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import json
import random

from ..serving.autoscale import AutoscalePolicy
from ..utils.stats import round_floats
from .core import Simulator
from .fleet import PhaseCosts, SimFleet
from .traces import (
    CLASSES,
    chip_seconds,
    diurnal_arrivals,
    diurnal_policy,
    slo_attainment,
)

#: fleet-scale knobs: slower modeled replicas (so queueing dynamics
#: dominate, ~1.1 s mean service) and a policy that can actually ramp
#: hundreds of replicas inside a compressed window.
FLEET_COST_SCALE = 10.0


def fleet_policy(**over) -> AutoscalePolicy:
    kw = dict(target_concurrency=1.0, window_s=5.0, horizon_s=5.0,
              high_band=1.05, low_band=0.4, loop_s=0.25,
              up_cooldown_s=0.25, down_cooldown_s=2.0,
              emergency_surge=10)
    kw.update(over)
    return AutoscalePolicy(**kw)


def _burst_arrivals(seed: int, windows, rate: float,
                    classes=None) -> list:
    """Seeded Poisson arrivals confined to ``windows`` ([(t0, t1)...])
    — the wake-storm trace: silence, then a wall of demand."""
    rng = random.Random(seed)
    names = list(classes or CLASSES)
    out = []
    for (t0, t1) in windows:
        t = t0
        while True:
            t += rng.expovariate(rate)
            if t >= t1:
                break
            out.append((t, names[rng.randrange(len(names))]))
    out.sort()
    return out


def _run(sim: Simulator, fleet: SimFleet, arrivals, auto, *,
         duration_s: float, session_pool: int = 0,
         record_decisions=None) -> None:
    """Schedule the trace + the autoscaler tick cadence, run to
    ``duration_s``, then drain in-flight work to terminal states (the
    grace window is the client deadline — anything still live after
    it is a leak the score reports)."""
    for i, (t, cls) in enumerate(arrivals):
        session = f"s{i % session_pool}" if session_pool else ""
        sim.at(t, lambda cls=cls, session=session:
               fleet.submit(cls, session=session))
    if auto is not None:
        def tick():
            dec = auto.tick()
            if record_decisions is not None:
                record_decisions.append(
                    (round(sim.now, 6), dec.action, dec.reason))
        sim.every(auto.policy.loop_s, tick, until=duration_s)
    sim.run(until=duration_s)
    sim.run(until=duration_s + fleet.request_timeout_s + 1.0)


def _score(name: str, seed: int, sim: Simulator, fleet: SimFleet,
           auto=None, extra: dict | None = None) -> dict:
    sc = {
        "scenario": name,
        "seed": seed,
        "duration_s": sim.now,
        "events": sim.events_run,
        "replicas_peak": max(n for _, n in fleet.replica_trace),
        "chip_seconds": chip_seconds(fleet.replica_trace, sim.now),
        "requests_total": len(fleet.requests),
        "admitted": fleet.admitted,
        "completed": fleet.completed,
        "shed": dict(sorted(fleet.shed.items())),
        "failed": dict(sorted(fleet.failed.items())),
        "slo_attainment": slo_attainment(fleet.latencies),
        "retry_amplification": fleet.forwards / max(fleet.admitted, 1),
        "retries_granted": fleet.retries_granted,
        "domain_outages_total": fleet.router.domain_outages_total,
        "leaked": fleet.leaked(),
    }
    if auto is not None:
        sc["decisions"] = {a: n for a, n
                           in sorted(auto.decisions_total.items()) if n}
        sc["actuator_failures_total"] = auto.actuator_failures_total
        sc["emergency_bypass_total"] = auto.emergency_bypass_total
    if extra:
        sc.update(extra)
    return round_floats(sc)


def score_json(score: dict) -> str:
    """The byte-stable serialization of one score row — sorted keys,
    rounded floats, no incidental whitespace.  Two runs of the same
    (scenario, seed, knobs) must produce identical bytes."""
    return json.dumps(round_floats(score), sort_keys=True,
                      separators=(",", ":"))


# -- catalog rows ---------------------------------------------------------

def scenario_smoke(seed: int = 0, replicas: int = 2, **kw) -> dict:
    """The tier-1 breath: a short burst through the REAL door
    (bounded concurrency forces queueing), REAL routing, and a REAL
    autoscaler that fires at least one actuation — door -> route ->
    decide -> actuate end to end in well under a second of wall."""
    sim = Simulator(seed)
    qos = {"gold": {"priority": 0, "max_concurrent": 3,
                    "queue_depth": 16}}
    fleet = SimFleet(sim, max_replicas=max(replicas, 2),
                     qos=qos, tenants={"gold": "gold"})
    fleet.add_replica()
    sim.run(until=2.0)
    policy = diurnal_policy()
    decisions: list = []
    auto = fleet.make_autoscaler(policy)
    arrivals = _burst_arrivals(seed + 1, [(0.2, 2.2)], 30.0,
                               classes=("gold",))
    _run(sim, fleet, arrivals, auto, duration_s=4.0,
         record_decisions=decisions)
    return _score("smoke", seed, sim, fleet, auto, extra={
        "scaled_up": int(auto.decisions_total.get("scale_up", 0) > 0),
    })


def scenario_diurnal(seed: int = 0, replicas: int = 4,
                     duration_s: float | None = None,
                     day_s: float | None = None,
                     record_signals=None, record_decisions=None,
                     **kw) -> dict:
    """The bench's multi-tenant diurnal day.  At <= 8 replicas this is
    the PARITY configuration: the exact ``diurnal_policy()`` and trace
    shape ``autoscale_bench.py`` replays on live engines, so the
    recorded (signal, decision) stream is directly comparable.  Above
    that it is the fleet-scale row — slower modeled replicas, a policy
    that ramps hundreds of replicas, arrival rate proportional to the
    fleet."""
    sim = Simulator(seed)
    small = replicas <= 8
    duration = duration_s or (20.0 if small else 90.0)
    day = day_s or duration
    if small:
        policy = diurnal_policy()
        fleet = SimFleet(sim, max_replicas=replicas)
        arrivals = diurnal_arrivals(seed, duration, day)
        fleet.add_replica()
    else:
        policy = fleet_policy()
        fleet = SimFleet(sim, max_replicas=replicas, domains=8,
                         costs=PhaseCosts(scale=FLEET_COST_SCALE))
        arrivals = diurnal_arrivals(seed, duration, day,
                                    peak_rps=replicas * 0.8,
                                    trough_rps=replicas * 0.02)
        fleet.warm_cache_seeded = True
        for _ in range(max(replicas // 4, 1)):
            fleet.add_replica()
    sim.run(until=3.0)
    auto = fleet.make_autoscaler(policy, record=record_signals)
    _run(sim, fleet, arrivals, auto, duration_s=3.0 + duration,
         record_decisions=record_decisions)
    return _score("diurnal", seed, sim, fleet, auto, extra={
        "replicas_cap": replicas,
        "arrivals": len(arrivals),
    })


def scenario_domain_outage(seed: int = 0, replicas: int = 100,
                           domains: int = 4,
                           duration_s: float = 20.0,
                           outage_at: float = 6.0, **kw) -> dict:
    """Zone loss at fleet scale: one failure domain (replicas/domains
    backends) dies whole mid-storm.  The real circuits must detect it,
    the real mass-forget must fire EXACTLY once, the herd of re-routes
    must stay inside the real retry budget's amplification bound
    (PR 16's invariants at 100x the live harness's replica count) and
    no request may hang or point at a corpse afterwards."""
    sim = Simulator(seed)
    fleet = SimFleet(sim, max_replicas=int(replicas * 1.2) + 1,
                     domains=domains,
                     costs=PhaseCosts(scale=FLEET_COST_SCALE))
    fleet.warm_cache_seeded = True
    for _ in range(replicas):
        fleet.add_replica()
    sim.run(until=2.0)
    auto = fleet.make_autoscaler(fleet_policy())
    rate = replicas * 1.5
    arrivals = _burst_arrivals(seed + 1, [(0.0, duration_s)], rate)
    victim = fleet.domain_names[0]
    sim.at(outage_at, lambda: fleet.kill_domain(victim))
    _run(sim, fleet, arrivals, auto, duration_s=2.0 + duration_s,
         session_pool=replicas * 3)
    return _score("domain_outage", seed, sim, fleet, auto, extra={
        "replicas": replicas,
        "domains": domains,
        "outage_domain": victim,
        "outage_at_s": outage_at,
    })


def scenario_cold_start_storm(seed: int = 0, replicas: int = 8,
                              **kw) -> dict:
    """Scale-to-zero wake storms: demand arrives in walls separated by
    idle gaps longer than ``idle_zero_s``, so the fleet hibernates
    between them and every wall pays a wake.  The first boot ever is
    AOT-cache-cold; the wakes ride the warm path — the REAL r21
    warm/cold EWMA split budgets the zero gate, and the door queue
    absorbs (or sheds) the wall while the replica warms."""
    sim = Simulator(seed)
    policy = AutoscalePolicy(
        target_concurrency=0.5, window_s=2.0, horizon_s=2.0,
        high_band=1.1, low_band=0.35, loop_s=0.1,
        up_cooldown_s=0.2, down_cooldown_s=0.5,
        scale_to_zero=True, idle_zero_s=1.5,
        cold_start_budget_s=5.0, zero_cooldown_s=1.0)
    fleet = SimFleet(sim, max_replicas=replicas, min_replicas=0,
                     queue_timeout_s=5.0)
    fleet.add_replica()
    sim.run(until=2.0)
    auto = fleet.make_autoscaler(policy)
    windows = [(5.0, 9.0), (16.0, 20.0), (27.0, 31.0)]
    arrivals = _burst_arrivals(seed + 1, windows, 8.0)
    _run(sim, fleet, arrivals, auto, duration_s=2.0 + 34.0)
    return _score("cold_start_storm", seed, sim, fleet, auto, extra={
        "wakes": fleet.wakes,
        "zero_decisions": auto.decisions_total.get("scale_to_zero", 0),
        "cold_starts": len(fleet.cold_samples),
        "cold_starts_warm": sum(1 for _, w in fleet.cold_samples if w),
        "cold_start_ewma_s": auto.cold_start_s,
        "cold_start_warm_ewma_s": auto.cold_start_warm_s,
    })


def scenario_noisy_neighbor(seed: int = 0, replicas: int = 6,
                            duration_s: float = 15.0, **kw) -> dict:
    """One tenant floods at 10x its share; the REAL QoS door (token
    buckets + bounded per-class queues + priority tiers) must shed the
    flood at the rate limit while gold's SLO attainment holds — the
    isolation story the door exists to tell."""
    sim = Simulator(seed)
    qos = {
        "gold": {"priority": 0},
        "silver": {"priority": 1, "rate": 40.0, "burst": 40.0},
        "bronze": {"priority": 2, "rate": 12.0, "burst": 12.0,
                   "max_concurrent": 10, "queue_depth": 8},
    }
    fleet = SimFleet(sim, max_replicas=replicas, qos=qos,
                     tenants={"noisy": "bronze"})
    fleet.warm_cache_seeded = True
    for _ in range(replicas):
        fleet.add_replica()
    sim.run(until=1.0)
    auto = fleet.make_autoscaler(diurnal_policy())
    arrivals = diurnal_arrivals(seed, duration_s, duration_s,
                                peak_rps=10.0)
    noisy = [(t, "noisy") for (t, _c) in _burst_arrivals(
        seed + 2, [(2.0, duration_s)], 120.0, classes=("noisy",))]
    trace = sorted(arrivals + noisy)
    _run(sim, fleet, trace, auto, duration_s=1.0 + duration_s)
    plane_stats = fleet.plane.stats()["classes"]
    return _score("noisy_neighbor", seed, sim, fleet, auto, extra={
        "noisy_arrivals": len(noisy),
        "noisy_shed": fleet.shed.get("rate_limited", 0)
        + fleet.shed.get("queue_full", 0)
        + fleet.shed.get("queue_timeout", 0),
        "door_classes": {
            name: {k: v for k, v in sorted(st.items())
                   if k != "qos_live"}
            for name, st in sorted(plane_stats.items())},
    })


def scenario_chaos_fleet(seed: int = 0, replicas: int = 50,
                         domains: int = 5,
                         duration_s: float = 25.0, **kw) -> dict:
    """Chaos at fleet scope: a seeded :class:`FaultPlan` — the same
    plan object the live chaos harness drives — replayed as sim
    events.  A seeded domain dies for a window and comes back; seeded
    autoscale actuator failures hit the real bounded-retry/park
    machinery via the plan's failpoint.  The fleet must survive: no
    hung requests, bounded amplification, every injected fault
    consumed."""
    from ..chaos.plan import FaultPlan

    sim = Simulator(seed)
    fleet = SimFleet(sim, max_replicas=int(replicas * 1.3) + 1,
                     domains=domains,
                     costs=PhaseCosts(scale=FLEET_COST_SCALE))
    fleet.warm_cache_seeded = True
    for _ in range(replicas):
        fleet.add_replica()
    sim.run(until=2.0)

    outage_window = 9.0
    plan = (FaultPlan(seed)
            .domain_outage(fleet.domain_names, min_at=4.0, max_at=10.0,
                           duration=outage_window)
            .autoscale_actuator_fail("replica_up", times=2))
    plan.activate(now=sim.now)
    auto = fleet.make_autoscaler(fleet_policy(),
                                 failpoint=plan.autoscale_failpoint())
    fired: list = []

    def poll_faults():
        for d in plan.due_domain_outages(now=sim.now):
            fired.append((round(sim.now, 6), d))
            fleet.kill_domain(d)
            sim.after(outage_window, lambda d=d: fleet.revive_domain(d))
    sim.every(0.1, poll_faults, until=2.0 + duration_s)

    rate = replicas * 1.6
    arrivals = _burst_arrivals(seed + 1, [(0.0, duration_s)], rate)
    _run(sim, fleet, arrivals, auto, duration_s=2.0 + duration_s,
         session_pool=replicas * 2)
    return _score("chaos_fleet", seed, sim, fleet, auto, extra={
        "replicas": replicas,
        "domains": domains,
        "faults_fired": fired,
        "autoscale_faults_pending": len(plan.due_autoscale_fails()),
    })


SCENARIOS = {
    "smoke": scenario_smoke,
    "diurnal": scenario_diurnal,
    "domain_outage": scenario_domain_outage,
    "cold_start_storm": scenario_cold_start_storm,
    "noisy_neighbor": scenario_noisy_neighbor,
    "chaos_fleet": scenario_chaos_fleet,
}


def run_scenario(name: str, seed: int = 0,
                 replicas: int | None = None, **kw) -> dict:
    """Run one catalog row; ``replicas`` overrides the scenario's
    default scale.  Returns the deterministic score dict (pass it to
    :func:`score_json` for the byte-stable row)."""
    fn = SCENARIOS.get(name)
    if fn is None:
        raise KeyError(
            f"unknown scenario {name!r} (one of {sorted(SCENARIOS)})")
    if replicas is not None:
        kw["replicas"] = replicas
    return fn(seed=seed, **kw)
