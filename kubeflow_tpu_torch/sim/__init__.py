"""Fleet-scale digital twin: virtual-clock simulation of the REAL
serving policies (ISSUE 20).

The twin inverts the usual simulator bargain.  Instead of re-modeling
the control logic (and silently drifting from production), it runs the
*production objects* — the router's smooth-WRR pick + health circuits
+ retry budget + domain mass-forget, the traffic plane's
``door_decision`` QoS admission, the autoscaler's ``decide``/``tick``
with cooldowns and emergency surge — on a virtual clock and a seeded
rng, and models only the physics around them: service times from the
r17 phase tiles, cold starts from the r21 warm/cold split, re-route
hops from the handler's jitter window.  A 500-replica day replays in
seconds; the same seed replays the same bytes.

- :mod:`.core`      — :class:`VirtualClock` + seeded event loop
- :mod:`.traces`    — the shared trace/scorer helpers (the live bench
  imports these too: one trace, one scorer, two harnesses)
- :mod:`.fleet`     — modeled replicas/transport around the real
  Router/TrafficPlane/ClusterAutoscaler
- :mod:`.scenarios` — the scored catalog (``scripts/twin_bench.py``)

The port's copy of ``kubeflow_tpu/sim/__init__.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from .core import Simulator, VirtualClock
from .fleet import PhaseCosts, SimFleet
from .scenarios import SCENARIOS, run_scenario, score_json
from .traces import (
    CLASSES,
    chip_seconds,
    diurnal_arrivals,
    diurnal_policy,
    slo_attainment,
    static_replicas_for,
)

__all__ = [
    "Simulator", "VirtualClock", "PhaseCosts", "SimFleet",
    "SCENARIOS", "run_scenario", "score_json",
    "CLASSES", "chip_seconds", "diurnal_arrivals", "diurnal_policy",
    "slo_attainment", "static_replicas_for",
]
