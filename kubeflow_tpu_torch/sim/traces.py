"""Pure trace generation + scoring shared by the live bench and the twin.

Moved verbatim from ``scripts/autoscale_bench.py`` (ISSUE 20): the
fleet-scale digital twin replays the SAME seeded diurnal trace through
the SAME scorer as the live-engine bench, so a twin score and a bench
score are comparable row for row.  ``autoscale_bench`` re-exports these
names (``tests/test_autoscale.py`` imports them from there), and
``diurnal_policy`` is the one shared :class:`AutoscalePolicy`
constructor both sides use — the parity test pins that the twin's
decision sequence equals the live replay's because it IS the same
``decide()`` under the same policy.

Everything here is pure and seeded — no wall clock, no process rng —
the ``wall-clock-in-policy`` analyzer rule lints this package.

The port's copy of ``kubeflow_tpu/sim/traces.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import math

#: QoS classes: (engine priority tier, diurnal peak phase in day
#: fractions, share of total traffic, SLO in compressed wall seconds).
#: Distinct peak phases are what makes the trace MULTI-tenant: the
#: fleet-wide rate is the sum of three out-of-phase sinusoids, so
#: static provisioning cannot sit at any single tenant's peak.
CLASSES = {
    "gold": {"priority": 0, "phase": 0.35, "share": 0.25, "slo_s": 2.0},
    "silver": {"priority": 1, "phase": 0.55, "share": 0.35, "slo_s": 4.0},
    "bronze": {"priority": 2, "phase": 0.80, "share": 0.40, "slo_s": 8.0},
}


def diurnal_arrivals(seed: int, duration_s: float, day_s: float, *,
                     peak_rps: float = 14.0, trough_rps: float = 1.0,
                     bursts: int = 2, burst_mult: float = 4.0,
                     burst_len_s: float = 1.0,
                     classes=None) -> list:
    """Seeded non-homogeneous Poisson arrivals: per class, rate(t) =
    share * (trough + (peak-trough) * (1+sin(2pi(t/day - phase)))/2),
    plus ``bursts`` seeded spikes multiplying one random class's rate
    by ``burst_mult`` for ``burst_len_s``.  Returns a time-sorted list
    of ``(t, class_name)`` — deterministic for a given seed.
    """
    import numpy as np

    classes = classes or CLASSES
    rng = np.random.default_rng(seed)
    spikes = [(rng.uniform(0.1, 0.9) * duration_s,
               list(classes)[rng.integers(0, len(classes))])
              for _ in range(bursts)]
    out = []
    dt = 0.02
    steps = int(duration_s / dt)
    for cls, spec in classes.items():
        for k in range(steps):
            t = k * dt
            wave = (1.0 + math.sin(
                2 * math.pi * (t / day_s - spec["phase"]))) / 2.0
            rate = spec["share"] * (
                trough_rps + (peak_rps - trough_rps) * wave)
            for t0, scls in spikes:
                if scls == cls and t0 <= t < t0 + burst_len_s:
                    rate *= burst_mult
            for _ in range(rng.poisson(rate * dt)):
                out.append((t + rng.uniform(0, dt), cls))
    out.sort()
    return out


def chip_seconds(trace: list, end_s: float) -> float:
    """Integrate a step-function replica trace ``[(t, replicas), ...]``
    (time-sorted, first entry at t<=0) to chip-seconds over [0, end]."""
    total = 0.0
    for i, (t, n) in enumerate(trace):
        t_next = trace[i + 1][0] if i + 1 < len(trace) else end_s
        total += max(0.0, min(t_next, end_s) - max(t, 0.0)) * n
    return total


def static_replicas_for(chips: float, duration_s: float) -> int:
    """The equal-chip-seconds baseline: the constant fleet size that
    spends the same chip budget over the same window."""
    return max(1, round(chips / max(duration_s, 1e-9)))


def slo_attainment(latencies: dict, classes=None) -> dict:
    """Per-class fraction of requests with e2e latency <= the class
    SLO.  ``latencies`` maps class -> list of e2e seconds (a dropped
    request must be recorded as +inf by the caller — absence would
    inflate the score)."""
    classes = classes or CLASSES
    out = {}
    for cls, spec in classes.items():
        xs = latencies.get(cls, [])
        out[cls] = (sum(1 for x in xs if x <= spec["slo_s"]) / len(xs)
                    if xs else 1.0)
    return out


def diurnal_policy():
    """The ONE diurnal-bench :class:`AutoscalePolicy` — constructed
    here so ``autoscale_bench.py`` (live engines) and the twin's
    diurnal scenario provably run the identical policy: the parity
    test (same signals -> same ``decide()`` actions in the same order)
    is only meaningful because neither side can drift a band on its
    own.

    target_concurrency is deliberately fractional: the tiny CPU
    engines drain requests in tens of milliseconds, so "hot" for this
    fleet is half a live request per replica — the bands and the
    diurnal wave do the rest, exactly as they would at real scale.
    horizon_s ~ the measured cold start: the predictor must lead by
    at least the time a new replica takes to warm, or every scale-up
    lands after the wave it was meant to absorb.
    """
    from kubeflow_tpu_torch.serving.autoscale import AutoscalePolicy

    return AutoscalePolicy(
        target_concurrency=0.5, window_s=3.0, horizon_s=3.0,
        high_band=1.1, low_band=0.35, loop_s=0.25,
        up_cooldown_s=0.5, down_cooldown_s=3.0)
