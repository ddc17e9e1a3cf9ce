"""Predictive cluster autoscaler (ISSUE 15): sense -> decide -> actuate.

Every fleet-scope actuator already exists — lossless replica drain via
``migrate_live_sequences`` (PR 7), elastic TP resize via ``GangResizer``
(PR 9), prefill/decode role pools (PR 7), session hibernation (PR 11) —
and PR 12 landed the sensor layer (``TraceSink.summary()`` per-class
queue-wait aggregates, plane shed counters, ``ClusterPrefixPoller``
prefix heat).  This module closes the loop: a short-horizon predictor
(EWMA + slope over a sliding window; the CONTRACT is the decision
interface, not the estimator) feeds one pure decision function that
emits at most one action per tick, and a per-actuator state machine
enforces hysteresis, cooldowns and bounded-retry backoff so a failing
actuator can never turn the loop into a resize storm.

Thread contract (the ``*Autoscaler``/``*Scaler``/``*Reaper`` analyzer
roots pin it): the decision loop is a WORKER thread — same shape as
``EnginePreemptor``.  Sensor reads are GIL ``list()``/dict copies or
the engines' public ``stats()``; every engine mutation goes through the
existing mailbox/drain APIs (``migrate_live_sequences``,
``hibernate_sequence``, ``GangResizer.resize``, the controller's
replica scaling) — never a direct pool write.  Actuators run on the
tick caller's thread (the controller's reconcile worker, or the
``start()`` thread), so a slow drain stalls this loop, never an engine
scheduler.

Decision priority (first match wins; everything below the matched rule
is NOT considered this tick — one action per tick is the anti-flap
floor):

1. ``wake``            — scaled to zero with demand pending
2. ``scale_up``        — EMERGENCY surge (ISSUE 16): more than
                         ``emergency_unhealthy_frac`` of the pool's
                         health circuits open at once — bounded surge
                         that may also bypass the placement cooldown,
                         at most once per ``emergency_window_s``
3. ``scale_up``        — shed rate / queue wait / free-block famine
                         (SLO pressure outranks the utilization bands)
4. ``scale_up``        — forecast utilization above the high band
5. ``resize_up``       — same deficit but replicas are at max: the
                         bottleneck is per-replica throughput, so the
                         TP degree grows instead (Tenplex: parallelism
                         degree is a runtime variable)
6. ``scale_to_zero``   — idle past the zero clock with a measured
                         cold-start budget that fits
7. ``scale_down``      — forecast AND current utilization below the
                         low band (both: a forecast dip alone must not
                         shed capacity)
8. ``resize_down``     — still below the low band at the replica floor
                         with a lower configured degree available
9. ``tier_rebalance``  — prefill/decode pressure imbalance beyond the
                         band (Podracer: chips are fungible across
                         roles)
10. ``none``           — inside the hysteresis band

The port's copy of ``kubeflow_tpu/serving/autoscale.py``, device-free
like it, with the same names; it imports nothing of the reference
package.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

log = logging.getLogger("kubeflow_tpu_torch.serving.autoscale")

#: every action ``decide`` can emit
ACTIONS = ("none", "wake", "scale_up", "scale_down", "resize_up",
           "resize_down", "tier_rebalance", "scale_to_zero")

#: actuator channels — each owns a cooldown + retry budget.  Several
#: actions share a channel on purpose: wake and scale_up both place a
#: replica, so they share the placement cooldown.
ACTUATOR_OF = {
    "wake": "replica_up", "scale_up": "replica_up",
    "scale_down": "replica_down", "scale_to_zero": "zero",
    "resize_up": "resize", "resize_down": "resize",
    "tier_rebalance": "tier",
}

_POLICY_KEYS = frozenset({
    "target_concurrency", "window_s", "horizon_s", "high_band",
    "low_band", "shed_hot", "queue_wait_hot_s", "free_block_low",
    "scale_to_zero", "idle_zero_s", "cold_start_budget_s",
    "tp_degrees", "tier_band", "up_cooldown_s", "down_cooldown_s",
    "resize_cooldown_s", "tier_cooldown_s", "zero_cooldown_s",
    "max_retries", "backoff_s", "backoff_cap_s", "loop_s",
    "emergency_unhealthy_frac", "emergency_surge",
    "emergency_window_s", "thaw_concurrency",
})


def validate_autoscale(spec) -> dict:
    """Validate an ISvc ``autoscale:`` knob dict (the ONE validator —
    the controller wraps errors into its conf-freeze ``invalid engine
    knobs`` message, the same contract as ``validate_qos`` /
    ``validate_tracing``).  Returns the normalized dict."""
    if not isinstance(spec, dict):
        raise ValueError("autoscale must be a mapping of knobs")
    unknown = set(spec) - _POLICY_KEYS
    if unknown:
        raise ValueError(f"autoscale keys {sorted(unknown)} unknown")
    out = dict(spec)

    def _pos(key: str, *, zero_ok: bool = False) -> None:
        if key not in out:
            return
        try:
            v = float(out[key])
            ok = v >= 0 if zero_ok else v > 0
        except (TypeError, ValueError):
            ok = False
        if not ok or not math.isfinite(float(out[key])):
            raise ValueError(
                f"autoscale.{key} {out[key]!r} must be a "
                + ("non-negative" if zero_ok else "positive") + " number")

    for k in ("target_concurrency", "window_s", "idle_zero_s",
              "cold_start_budget_s", "up_cooldown_s", "down_cooldown_s",
              "resize_cooldown_s", "tier_cooldown_s", "zero_cooldown_s",
              "backoff_s", "backoff_cap_s", "loop_s"):
        _pos(k)
    for k in ("horizon_s", "shed_hot", "queue_wait_hot_s"):
        _pos(k, zero_ok=True)
    if "free_block_low" in out:
        try:
            ok = 0.0 <= float(out["free_block_low"]) < 1.0
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise ValueError(
                f"autoscale.free_block_low {out['free_block_low']!r} "
                "must be in [0, 1)")
    if "tier_band" in out:
        try:
            ok = float(out["tier_band"]) >= 0.0
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise ValueError(
                f"autoscale.tier_band {out['tier_band']!r} must be >= 0")
    hi = float(out.get("high_band", 1.25))
    lo = float(out.get("low_band", 0.5))
    if not (0.0 <= lo < hi):
        raise ValueError(
            f"autoscale bands must satisfy 0 <= low_band < high_band "
            f"(got low={lo}, high={hi}) — the gap IS the hysteresis")
    if "max_retries" in out and int(out["max_retries"]) < 1:
        raise ValueError(
            f"autoscale.max_retries {out['max_retries']!r} must be >= 1")
    degrees = out.get("tp_degrees")
    if degrees is not None:
        if (not isinstance(degrees, (list, tuple))
                or not all(isinstance(d, int) and d >= 1 for d in degrees)
                or list(degrees) != sorted(set(degrees))):
            raise ValueError(
                "autoscale.tp_degrees must be a strictly increasing "
                "list of ints >= 1")
    if "scale_to_zero" in out and not isinstance(out["scale_to_zero"], bool):
        raise ValueError("autoscale.scale_to_zero must be a bool")
    _pos("emergency_window_s")
    if "emergency_unhealthy_frac" in out:
        try:
            ok = 0.0 < float(out["emergency_unhealthy_frac"]) <= 1.0
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise ValueError(
                "autoscale.emergency_unhealthy_frac "
                f"{out['emergency_unhealthy_frac']!r} must be in (0, 1]")
    if "emergency_surge" in out:
        v = out["emergency_surge"]
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            raise ValueError(
                f"autoscale.emergency_surge {v!r} must be an int >= 1")
    if "thaw_concurrency" in out:
        v = out["thaw_concurrency"]
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise ValueError(
                f"autoscale.thaw_concurrency {v!r} must be an int >= 0 "
                "(0 = uncapped)")
    return out


@dataclass(frozen=True)
class AutoscalePolicy:
    """Frozen knob set for one autoscaler instance (conf-freeze: built
    once per revision fingerprint, like the traffic plane)."""

    #: per-replica inflight the fleet is sized for; utilization =
    #: inflight / (replicas * target_concurrency)
    target_concurrency: float = 4.0
    #: sensor sliding window feeding the predictor
    window_s: float = 30.0
    #: forecast horizon — 0 disables the slope term (pure EWMA)
    horizon_s: float = 5.0
    #: hysteresis band on forecast utilization: above high -> grow,
    #: below low -> shrink, inside -> hold
    high_band: float = 1.25
    low_band: float = 0.5
    #: sheds/s (worst class) beyond which scale-up fires regardless of
    #: utilization — a shed IS an SLO miss already happening
    shed_hot: float = 0.0
    #: mean queue wait (worst class, seconds) beyond which scale-up fires
    queue_wait_hot_s: float = 1.0
    #: min free-block ratio across engines below which scale-up fires
    #: (KV famine strands admissions even at modest concurrency)
    free_block_low: float = 0.08
    scale_to_zero: bool = False
    #: idle seconds before scale-to-zero considers firing
    idle_zero_s: float = 60.0
    #: measured cold start must fit this budget for zero to be safe
    cold_start_budget_s: float = 30.0
    #: allowed TP degrees, strictly increasing; empty = resize actuator off
    tp_degrees: Tuple[int, ...] = ()
    #: relative prefill/decode pressure gap tolerated before rebalance
    tier_band: float = 0.5
    up_cooldown_s: float = 2.0
    down_cooldown_s: float = 10.0
    resize_cooldown_s: float = 30.0
    tier_cooldown_s: float = 30.0
    zero_cooldown_s: float = 60.0
    #: consecutive actuator failures tolerated before the channel parks
    max_retries: int = 3
    backoff_s: float = 1.0
    backoff_cap_s: float = 30.0
    #: threaded-mode tick interval
    loop_s: float = 1.0
    #: correlated-failure emergency mode (ISSUE 16): when more than
    #: this fraction of the router's backends have non-closed health
    #: circuits, ``decide`` fires a bounded surge scale-out that
    #: outranks the utilization bands, and ``tick`` may bypass the
    #: placement cooldown/backoff at most once per
    #: ``emergency_window_s``
    emergency_unhealthy_frac: float = 0.5
    #: replicas added per emergency surge decision (capped at max)
    emergency_surge: int = 1
    emergency_window_s: float = 30.0
    #: mass-recovery thaw cap: max concurrent ``thaw_sequence`` calls
    #: per deployment (0 = uncapped, the pre-PR behavior)
    thaw_concurrency: int = 0

    @classmethod
    def from_config(cls, spec: Optional[dict]) -> "AutoscalePolicy":
        if not spec:
            return cls()
        out = validate_autoscale(spec)
        kw: Dict[str, Any] = {}
        for k, v in out.items():
            if k == "tp_degrees":
                kw[k] = tuple(int(d) for d in v)
            elif k in ("max_retries", "emergency_surge",
                       "thaw_concurrency"):
                kw[k] = int(v)
            elif k == "scale_to_zero":
                kw[k] = bool(v)
            else:
                kw[k] = float(v)
        return cls(**kw)


class TrendPredictor:
    """EWMA level + least-squares slope over a sliding time window.

    Pure host arithmetic (table-tested): ``observe(t, v)`` retires
    samples older than ``window_s``, ``forecast(h)`` extrapolates
    ``level + slope * h``.  The estimator is deliberately boring — the
    decision interface is the contract, and a fancier model slots in
    behind the same three reads."""

    def __init__(self, window_s: float = 30.0, alpha: float = 0.3):
        self.window_s = float(window_s)
        self.alpha = float(alpha)
        self._samples: deque = deque()
        self._level: Optional[float] = None

    def observe(self, t: float, v: float) -> None:
        v = float(v)
        self._samples.append((float(t), v))
        while self._samples and t - self._samples[0][0] > self.window_s:
            self._samples.popleft()
        self._level = (v if self._level is None
                       else self.alpha * v + (1 - self.alpha) * self._level)

    @property
    def n(self) -> int:
        return len(self._samples)

    @property
    def level(self) -> float:
        return 0.0 if self._level is None else self._level

    @property
    def slope(self) -> float:
        """Least-squares d(value)/dt over the retained window; 0 until
        two samples span a non-zero interval."""
        if len(self._samples) < 2:
            return 0.0
        ts = [s[0] for s in self._samples]
        vs = [s[1] for s in self._samples]
        tm = sum(ts) / len(ts)
        vm = sum(vs) / len(vs)
        den = sum((t - tm) ** 2 for t in ts)
        if den <= 0.0:
            return 0.0
        return sum((t - tm) * (v - vm) for t, v in zip(ts, vs)) / den

    def forecast(self, horizon_s: float) -> float:
        return self.level + self.slope * float(horizon_s)


class ConcurrencyGate:
    """Bounded-concurrency context manager for the mass-recovery
    stampede paths (ISSUE 16): cold-start pre-warm and
    hibernated-session thaw both arrive in herds after a domain
    outage — the gate admits ``limit`` at a time and makes the rest
    WAIT (refusal would just re-herd the retries).  Plain bounded
    semaphore plus counters; safe to share across threads."""

    def __init__(self, limit: int = 1):
        self.limit = max(1, int(limit))
        self._sem = threading.BoundedSemaphore(self.limit)
        self._lock = threading.Lock()
        self.entries_total = 0
        self.waits_total = 0

    def __enter__(self) -> "ConcurrencyGate":
        if not self._sem.acquire(blocking=False):
            with self._lock:
                self.waits_total += 1
            self._sem.acquire()
        with self._lock:
            self.entries_total += 1
        return self

    def __exit__(self, *exc) -> None:
        self._sem.release()

    def stats(self) -> dict:
        return {"gate_limit": self.limit,
                "gate_entries_total": self.entries_total,
                "gate_waits_total": self.waits_total}


class ActuatorState:
    """Cooldown + bounded-retry backoff for ONE actuator channel.

    ``ready`` gates firing; ``note_failed`` backs off exponentially and
    PARKS the channel after ``max_retries`` consecutive failures — a
    parked channel never fires again until ``reset()`` (the loop resets
    it when the demanded action changes or the band clears, i.e. when
    the world moved on).  This is the no-flap contract the chaos sweep
    pins: a dead actuator costs at most ``max_retries`` attempts per
    demand episode."""

    def __init__(self, name: str, cooldown_s: float, *,
                 max_retries: int = 3, backoff_s: float = 1.0,
                 backoff_cap_s: float = 30.0):
        self.name = name
        self.cooldown_s = float(cooldown_s)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.last_fired = -math.inf
        self.failures = 0
        self.blocked_until = -math.inf
        self.parked = False

    def ready(self, now: float) -> bool:
        return (not self.parked
                and now >= self.blocked_until
                and now - self.last_fired >= self.cooldown_s)

    def note_fired(self, now: float) -> None:
        self.last_fired = now

    def note_ok(self) -> None:
        self.failures = 0
        self.blocked_until = -math.inf

    def note_failed(self, now: float) -> None:
        self.failures += 1
        if self.failures >= self.max_retries:
            self.parked = True
        else:
            self.blocked_until = now + min(
                self.backoff_cap_s,
                self.backoff_s * (2.0 ** (self.failures - 1)))

    def reset(self) -> None:
        self.failures = 0
        self.parked = False
        self.blocked_until = -math.inf


@dataclass(frozen=True)
class Decision:
    """One tick's verdict — at most one action, with the actuator
    payload it needs (target replica count / TP degree / prefill tier
    size)."""

    action: str
    reason: str = ""
    replicas: Optional[int] = None
    degree: Optional[int] = None
    prefill: Optional[int] = None

    @property
    def actuator(self) -> Optional[str]:
        return ACTUATOR_OF.get(self.action)


def _sig(sig: Mapping, key: str, default: float) -> float:
    v = sig.get(key, default)
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def decide(sig: Mapping, policy: AutoscalePolicy) -> Decision:
    """The pure decision function: one sensor snapshot -> exactly one
    :class:`Decision` (possibly ``none``).  No clocks, no side effects —
    the table-driven tests enumerate it row by row.

    Expected ``sig`` keys (missing keys take neutral defaults, so a
    partially-wired deployment degrades to the utilization bands):
    ``replicas``, ``min_replicas``, ``max_replicas``, ``util``,
    ``util_forecast``, ``shed_rate``, ``queue_wait_s``,
    ``free_block_ratio``, ``idle_s``, ``live``, ``pending``,
    ``cold_start_s``, ``degree``, ``prefill_pressure``,
    ``decode_pressure``, ``prefill_replicas``, ``decode_replicas``,
    ``unhealthy_frac``.
    """
    n = int(_sig(sig, "replicas", 0))
    lo_n = max(int(_sig(sig, "min_replicas", 0)), 0)
    hi_n = max(int(_sig(sig, "max_replicas", max(n, 1))), 1)
    floor = max(lo_n, 1) if not policy.scale_to_zero else lo_n
    util = _sig(sig, "util", 0.0)
    fc = _sig(sig, "util_forecast", util)
    pending = _sig(sig, "pending", 0.0)

    # 1. wake: scaled to zero with demand at the door
    if n == 0:
        if pending > 0 or util > 0:
            return Decision("wake", "demand while scaled to zero",
                            replicas=max(floor, 1))
        return Decision("none", "scaled to zero, no demand")

    # 2. emergency surge (ISSUE 16): a correlated failure — more than
    # emergency_unhealthy_frac of the pool's health circuits open at
    # once — outranks every band and even the SLO rules: the fleet is
    # not merely hot, it is GONE.  Surge is bounded (emergency_surge
    # replicas, never past max) and the reason prefix is the contract
    # ``tick`` keys its cooldown bypass off.
    bad = _sig(sig, "unhealthy_frac", 0.0)
    if bad > policy.emergency_unhealthy_frac and n < hi_n:
        return Decision(
            "scale_up",
            f"emergency: {bad:.0%} of backends unhealthy",
            replicas=min(hi_n,
                         n + max(int(policy.emergency_surge), 1)))

    # 3. SLO pressure outranks the utilization bands: a shed or a long
    # queue wait is a miss already happening, not a forecast
    shed = _sig(sig, "shed_rate", 0.0)
    qwait = _sig(sig, "queue_wait_s", 0.0)
    free = _sig(sig, "free_block_ratio", 1.0)
    if n < hi_n:
        if shed > policy.shed_hot:
            return Decision("scale_up", f"shed rate {shed:.3g}/s",
                            replicas=n + 1)
        if qwait > policy.queue_wait_hot_s:
            return Decision("scale_up", f"queue wait {qwait:.3g}s",
                            replicas=n + 1)
        if free < policy.free_block_low:
            return Decision("scale_up",
                            f"free-block ratio {free:.3g}",
                            replicas=n + 1)

    # 4/5. the high band: forecast says the fleet will run hot.  With
    # replica headroom, add concurrency; at max replicas the deficit is
    # per-replica throughput — grow the TP degree instead.
    if fc > policy.high_band:
        if n < hi_n:
            return Decision("scale_up",
                            f"forecast util {fc:.3g} > {policy.high_band}",
                            replicas=n + 1)
        degree = int(_sig(sig, "degree", 0))
        bigger = [d for d in policy.tp_degrees if d > degree]
        if degree and bigger:
            return Decision("resize_up",
                            f"at max replicas, forecast util {fc:.3g}",
                            degree=bigger[0])

    # 6. scale-to-zero: idle past the clock, nothing live, and the
    # measured cold start fits the budget (an unmeasured cold start
    # counts as 0 — the first zero is how the budget gets measured,
    # and the activator path bounds the damage)
    idle = _sig(sig, "idle_s", 0.0)
    live = _sig(sig, "live", 0.0)
    if (policy.scale_to_zero and lo_n == 0 and idle > policy.idle_zero_s
            and live <= 0
            and _sig(sig, "cold_start_s", 0.0)
            <= policy.cold_start_budget_s):
        return Decision("scale_to_zero", f"idle {idle:.3g}s", replicas=0)

    # 7/8. the low band: BOTH current and forecast utilization must sit
    # below it (a dip in the forecast alone must not shed capacity —
    # that asymmetry is deliberate: adding capacity early is cheap,
    # removing it early sheds SLO)
    # the last replica retires ONLY through scale_to_zero above — its
    # gates (nothing live, cold start fits the budget) are the whole
    # point; a band-driven step 1 -> 0 would skip hibernation
    if fc < policy.low_band and util < policy.low_band:
        if n > max(floor, 1):
            return Decision("scale_down",
                            f"util {util:.3g} below {policy.low_band}",
                            replicas=n - 1)
        degree = int(_sig(sig, "degree", 0))
        smaller = [d for d in policy.tp_degrees if 0 < d < degree]
        if degree and smaller:
            return Decision("resize_down",
                            f"at replica floor, util {util:.3g}",
                            degree=smaller[-1])

    # 9. tier rebalance: prefill vs decode pressure imbalance beyond the
    # band, with a spare engine on the fat side
    pp = _sig(sig, "prefill_pressure", 0.0)
    dp = _sig(sig, "decode_pressure", 0.0)
    pn = int(_sig(sig, "prefill_replicas", 0))
    dn = int(_sig(sig, "decode_replicas", 0))
    if pn >= 1 and dn >= 1:
        if pp > (1.0 + policy.tier_band) * max(dp, 1e-9) and dn > 1:
            return Decision("tier_rebalance",
                            f"prefill pressure {pp:.3g} vs decode "
                            f"{dp:.3g}", prefill=pn + 1)
        if dp > (1.0 + policy.tier_band) * max(pp, 1e-9) and pn > 1:
            return Decision("tier_rebalance",
                            f"decode pressure {dp:.3g} vs prefill "
                            f"{pp:.3g}", prefill=pn - 1)

    return Decision("none", "inside the hysteresis band")


class ClusterAutoscaler:
    """The sense -> decide -> actuate loop.

    ``sensors`` is a callable returning the signal mapping ``decide``
    consumes (raw values; this loop adds the predictor-derived
    ``util_forecast`` before deciding).  ``actuators`` maps channel
    names (``replica_up``/``replica_down``/``resize``/``tier``/``zero``)
    to callables taking the :class:`Decision`; a missing channel means
    the deployment has no such actuator and the decision is recorded
    but not fired.  ``failpoint`` is the chaos hook
    (``FaultPlan.autoscale_failpoint()``): called with the channel name
    right before the actuator runs, raising to simulate a failed
    resize / failed drain / unreachable replica.

    Worker-thread discipline: ``tick`` runs on the caller's thread (the
    controller's reconcile worker or the ``start()`` loop) and touches
    engines only through their public cross-thread APIs.
    """

    def __init__(self, policy: AutoscalePolicy, *,
                 sensors: Callable[[], Mapping],
                 actuators: Optional[Mapping[str, Callable]] = None,
                 failpoint: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self.sensors = sensors
        self.actuators: Dict[str, Callable] = dict(actuators or {})
        self.failpoint = failpoint
        self.clock = clock
        cooldown = {
            "replica_up": policy.up_cooldown_s,
            "replica_down": policy.down_cooldown_s,
            "resize": policy.resize_cooldown_s,
            "tier": policy.tier_cooldown_s,
            "zero": policy.zero_cooldown_s,
        }
        self.states: Dict[str, ActuatorState] = {
            name: ActuatorState(
                name, cd, max_retries=policy.max_retries,
                backoff_s=policy.backoff_s,
                backoff_cap_s=policy.backoff_cap_s)
            for name, cd in cooldown.items()
        }
        self._util = TrendPredictor(policy.window_s)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._last_demand: Optional[str] = None
        #: bounded decision history (action, ok) for flap inspection
        self.history: deque = deque(maxlen=256)
        self.decisions_total: Dict[str, int] = {a: 0 for a in ACTIONS}
        self.actuator_failures_total = 0
        self.actuator_skips_total = 0
        self.sensor_errors_total = 0
        self.ticks_total = 0
        #: emergency cooldown bypass (ISSUE 16): at most one per
        #: ``emergency_window_s`` — the clock that bounds it
        self._last_emergency_bypass = float("-inf")
        self.emergency_bypass_total = 0
        #: EWMA of measured cold starts (scale-up fire -> replica ready)
        self.cold_start_s = 0.0
        self._cold_n = 0
        #: the warm-path EWMA (ISSUE 17): cold starts whose warmup HIT
        #: the AOT artifact cache, tracked separately — one cache-cold
        #: build (first boot, version bump) must not poison the budget
        #: the scale-to-zero gate holds the steady state to
        self.cold_start_warm_s = 0.0
        self._cold_warm_n = 0

    # -- sensors ----------------------------------------------------------

    def note_cold_start(self, seconds: float, warm: bool = False) -> None:
        """Record one measured cold start (scale-up decision to replica
        Ready).  The EWMA is the budget ``decide`` holds scale-to-zero
        to — zero is only cheap if waking is.  ``warm=True`` tags a
        build whose program warmup hit the artifact cache: it ALSO
        feeds the warm-path EWMA, which the gate prefers once measured
        (every post-first boot takes the warm path, so that is the
        budget that predicts the next wake)."""
        with self._lock:
            self._cold_n += 1
            a = 0.3 if self._cold_n > 1 else 1.0
            self.cold_start_s = (a * float(seconds)
                                 + (1 - a) * self.cold_start_s)
            if warm:
                self._cold_warm_n += 1
                a = 0.3 if self._cold_warm_n > 1 else 1.0
                self.cold_start_warm_s = (
                    a * float(seconds)
                    + (1 - a) * self.cold_start_warm_s)

    # -- the loop ---------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Decision:
        """One sense -> decide -> actuate pass; returns the decision
        (``none`` with a reason when gated by cooldown/backoff/park)."""
        now = self.clock() if now is None else now
        self.ticks_total += 1
        try:
            sig = dict(self.sensors() or {})
        except Exception as e:  # noqa: BLE001 — a torn sensor read must
            # not kill the loop; the next tick re-reads
            self.sensor_errors_total += 1
            log.debug("autoscale sensor read failed: %s", e)
            return self._record(Decision("none", f"sensor error: {e}"),
                                ok=True)
        self._util.observe(now, _sig(sig, "util", 0.0))
        sig.setdefault("util_forecast",
                       self._util.forecast(self.policy.horizon_s))
        # the scale-to-zero gate budgets the NEXT wake: once a
        # warm-cache cold start has been measured, that is the path
        # every future wake takes — prefer it over the all-paths EWMA
        # (which one cache-cold first boot would otherwise poison)
        sig.setdefault("cold_start_s",
                       self.cold_start_warm_s if self._cold_warm_n > 0
                       else self.cold_start_s)
        dec = decide(sig, self.policy)

        # demand-change bookkeeping: when the demanded action changes
        # (including to none), the previous episode is over — parked
        # channels get their retry budget back.  THIS is what bounds a
        # failing actuator to max_retries attempts per demand episode
        # while still letting a later, different episode try again.
        demand = dec.action if dec.action != "none" else None
        if demand != self._last_demand:
            for st in self.states.values():
                if st.parked or st.failures:
                    st.reset()
            self._last_demand = demand

        if dec.action == "none":
            return self._record(dec, ok=True)
        chan = dec.actuator
        assert chan is not None
        state = self.states[chan]
        ready = state.ready(now)
        if (not ready and not state.parked
                and dec.reason.startswith("emergency")
                and now - self._last_emergency_bypass
                >= self.policy.emergency_window_s):
            # correlated-failure surge may jump the placement
            # cooldown/backoff — but never a PARKED channel (the
            # bounded-retry contract holds even in an emergency), and
            # at most once per emergency window so a flapping health
            # sensor cannot turn the bypass into unlimited fire
            self._last_emergency_bypass = now
            self.emergency_bypass_total += 1
            ready = True
        if not ready:
            self.actuator_skips_total += 1
            why = ("parked after bounded retries" if state.parked
                   else "backoff" if now < state.blocked_until
                   else "cooldown")
            return self._record(
                Decision("none", f"{dec.action} gated: {chan} {why}"),
                ok=True)
        fn = self.actuators.get(chan)
        if fn is None:
            self.actuator_skips_total += 1
            return self._record(
                Decision("none", f"{dec.action}: no {chan} actuator"),
                ok=True)
        state.note_fired(now)
        try:
            if self.failpoint is not None:
                self.failpoint(chan)
            fn(dec)
        except Exception as e:  # noqa: BLE001 — actuator failure is a
            # first-class outcome: back off, bounded retries, no flap
            state.note_failed(now)
            self.actuator_failures_total += 1
            log.warning("autoscale actuator %s failed (%d/%d): %s",
                        chan, state.failures, state.max_retries, e)
            return self._record(dec, ok=False)
        state.note_ok()
        return self._record(dec, ok=True)

    def _record(self, dec: Decision, *, ok: bool) -> Decision:
        self.decisions_total[dec.action] = (
            self.decisions_total.get(dec.action, 0) + 1)
        self.history.append((dec.action, ok))
        return dec

    # -- threaded mode ----------------------------------------------------

    def start(self, interval_s: Optional[float] = None) -> "ClusterAutoscaler":
        """Run the loop on a daemon worker thread (the bench/serving
        path; the controller instead calls ``tick`` from its 4 Hz
        reconcile worker)."""
        if self._thread is not None:
            return self
        interval = float(interval_s or self.policy.loop_s)
        self._stopping.clear()

        def _loop_autoscale() -> None:
            while not self._stopping.wait(interval):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the loop survives
                    log.exception("autoscale tick failed")

        self._thread = threading.Thread(
            target=_loop_autoscale, name="cluster-autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    # -- observability ----------------------------------------------------

    def stats(self) -> dict:
        out = {
            "autoscale_ticks_total": self.ticks_total,
            "autoscale_actuator_failures_total":
                self.actuator_failures_total,
            "autoscale_actuator_skips_total": self.actuator_skips_total,
            "autoscale_sensor_errors_total": self.sensor_errors_total,
            "autoscale_emergency_bypass_total":
                self.emergency_bypass_total,
            "autoscale_cold_start_s": round(self.cold_start_s, 4),
            "autoscale_cold_start_warm_s": round(
                self.cold_start_warm_s, 4),
            "decisions": dict(self.decisions_total),
        }
        out["autoscale_parked_actuators"] = sum(
            1 for st in self.states.values() if st.parked)
        return out

    def metrics_lines(self) -> List[str]:
        """Prometheus rows for the router/bench /metrics export —
        decisions carry the action as a LABEL (the class-as-label
        rule)."""
        from .traffic import prom_label

        s = self.stats()
        lines = [
            f"kft_autoscale_ticks_total {s['autoscale_ticks_total']}",
            "kft_autoscale_actuator_failures_total "
            f"{s['autoscale_actuator_failures_total']}",
            "kft_autoscale_parked_actuators "
            f"{s['autoscale_parked_actuators']}",
            f"kft_autoscale_cold_start_s {s['autoscale_cold_start_s']}",
            "kft_autoscale_cold_start_warm_s "
            f"{s['autoscale_cold_start_warm_s']}",
        ]
        for action in ACTIONS:
            lines.append(
                'kft_autoscale_decisions_total{action="'
                f'{prom_label(action)}"}} '
                f"{self.decisions_total.get(action, 0)}")
        return lines


class SessionReaper:
    """Idle-session reaper (ISSUE 15 satellite): a configurable idle
    clock that ``hibernate_sequence``s quiet sessions to the spill
    store, freeing their HBM blocks — hibernation stops being purely
    API/operator-driven.

    A session is QUIET when its token stream has made no progress for
    ``idle_s`` (engine-side accounting: ``Request.last_token_at``,
    stamped by the scheduler at every delivery) — in practice a held
    import parked between turns, or a sequence wedged behind an
    operator quiesce.  An actively-decoding sequence refreshes its
    stamp every chunk and is never reaped.  Reaped sessions thaw
    bit-identically on the next request (``thaw_sequence`` — the PR 11
    parity bar), and a failed spill resumes the sequence in place
    (copy-then-cutover at the storage tier), so the reaper can never
    lose a conversation.

    Worker-thread discipline (the ``*Reaper`` analyzer root): reads are
    the engine's public ``idle_sessions`` GIL-copy probe; the only
    mutation path is ``hibernate_sequence`` — the engine's own
    mailbox-backed API, run on THIS thread (device fetch + file I/O
    never land on a scheduler).
    """

    def __init__(self, engines: Callable[[], list], idle_s: float, *,
                 interval_s: float = 1.0,
                 clock: Callable[[], float] = time.perf_counter):
        if float(idle_s) <= 0:
            raise ValueError(f"reap_idle_s {idle_s!r} must be > 0")
        self.engines = engines
        self.idle_s = float(idle_s)
        self.interval_s = float(interval_s)
        self.clock = clock
        self.sessions_reaped_total = 0
        self.reap_failures_total = 0
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def scan(self, now: Optional[float] = None) -> int:
        """One reap pass over every engine; returns sessions reaped."""
        reaped = 0
        for eng in list(self.engines() or []):
            probe = getattr(eng, "idle_sessions", None)
            if probe is None or getattr(eng, "spill_store", None) is None:
                continue
            for req in probe(self.idle_s, now=now):
                sid = getattr(req, "session_id", None)
                if not sid:
                    continue
                try:
                    if eng.hibernate_sequence(req, sid):
                        reaped += 1
                except Exception as e:  # noqa: BLE001 — a torn spill
                    # resumed the sequence in place; count and move on
                    self.reap_failures_total += 1
                    log.debug("session reap %s failed: %s", sid, e)
        self.sessions_reaped_total += reaped
        return reaped

    def start(self) -> "SessionReaper":
        if self._thread is not None:
            return self
        self._stopping.clear()

        def _loop_reap() -> None:
            while not self._stopping.wait(self.interval_s):
                try:
                    self.scan()
                except Exception:  # noqa: BLE001 — the clock survives
                    log.exception("session reap pass failed")

        self._thread = threading.Thread(
            target=_loop_reap, name="session-reaper", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def stats(self) -> dict:
        return {
            "sessions_reaped_total": self.sessions_reaped_total,
            "reap_failures_total": self.reap_failures_total,
        }
