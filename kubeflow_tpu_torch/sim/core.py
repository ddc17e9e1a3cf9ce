"""Virtual clock + seeded discrete-event loop — the twin's heartbeat.

The whole point of the twin (ISSUE 20) is that the *decisions* come
from the real production objects and only the *physics* (time, network,
engine service) is modeled.  That works because every policy surface
grew a ``clock=``/``rng=`` seam this PR: a :class:`VirtualClock` is a
zero-arg callable, so ``TokenBucket(..., clock=sim.clock)`` or
``Router(..., clock=sim.clock, rng=sim.rng)`` makes the real circuit
breakers, retry budgets, coalescing windows and cooldowns tick in
simulated seconds.  A 24h diurnal cycle replays in wall milliseconds,
and two runs with the same seed are byte-identical.

No wall clock, no process rng anywhere in this package — the
``wall-clock-in-policy`` analyzer rule fails the build if one sneaks
in.

The port's copy of ``kubeflow_tpu/sim/core.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import heapq
import random
from typing import Callable, Optional


class VirtualClock:
    """A monotonically advancing simulated clock.  Instances are
    zero-arg callables returning seconds-as-float, drop-in for the
    ``clock=time.monotonic`` seams across serving/."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    __call__ = now

    def advance_to(self, t: float) -> None:
        """Jump forward (never backward — simulated time is monotonic
        by construction, which is what lets the real cooldown/circuit
        arithmetic run unmodified)."""
        if t > self._now:
            self._now = t


class Simulator:
    """Seeded discrete-event loop over a :class:`VirtualClock`.

    Events are ``(time, seq, fn)`` on a heap; ``seq`` is a monotonic
    tiebreaker so same-instant events run in scheduling order —
    determinism does not hinge on heap internals or callable identity.
    ``fn`` takes no arguments and may schedule further events.

    One ``random.Random(seed)`` instance is threaded through every
    modeled cost AND every real policy object's ``rng=`` seam, so the
    full interleaving — arrival jitter, service noise, probe jitter,
    retry spread — replays exactly from the seed.
    """

    def __init__(self, seed: int = 0, start: float = 0.0):
        self.clock = VirtualClock(start)
        self.rng = random.Random(seed)
        self.seed = seed
        self.events_run = 0
        self._heap: list = []
        self._seq = 0

    @property
    def now(self) -> float:
        return self.clock.now()

    def at(self, t: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` at simulated time ``t`` (clamped to now —
        the past is not schedulable)."""
        heapq.heappush(self._heap, (max(t, self.clock.now()),
                                    self._seq, fn))
        self._seq += 1

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.clock.now() + max(dt, 0.0), fn)

    def every(self, period: float, fn: Callable[[], None], *,
              until: float) -> None:
        """Schedule ``fn`` at ``now+period, now+2*period, ...`` up to
        ``until`` — the autoscaler tick cadence, made explicit events
        instead of a thread loop."""
        def tick():
            fn()
            if self.clock.now() + period <= until:
                self.after(period, tick)
        self.after(period, tick)

    def run(self, until: Optional[float] = None,
            max_events: int = 20_000_000) -> int:
        """Drain events in time order up to ``until`` (inclusive);
        returns the number of events run.  ``max_events`` is a runaway
        backstop — a scenario that hits it is a bug, not a workload."""
        n = 0
        while self._heap and n < max_events:
            t = self._heap[0][0]
            if until is not None and t > until:
                break
            _, _, fn = heapq.heappop(self._heap)
            self.clock.advance_to(t)
            fn()
            n += 1
        if until is not None:
            self.clock.advance_to(until)
        self.events_run += n
        return n
