"""FakeKubelet: drives bound pods through phases without real processes.

The envtest gap-filler (SURVEY.md §4): upstream controller tests create pods
that never run because envtest has no kubelet; gang-startup latency and
restart policies then go untested.  This kubelet simulator runs bound pods to
a scripted outcome (success, exit code, hang) so reconciler + scheduler
behavior — including failure/restart paths — is testable deterministically.
The *real* kubelet is ``kubeflow_tpu_torch.runtime.launcher``, which runs actual
processes.

Scripts come in two shapes:

- the classic single-phase :class:`PodScript` (run N seconds, then exit /
  hang), kept for every existing test;
- multi-phase scripts (``PodScript.phases``): an ordered list of
  :class:`ScriptPhase` steps the pod walks through while RUNNING — a
  barrier crossing, healthy activity, an activity stall — before the
  terminal outcome.  This is what the chaos layer
  (:mod:`kubeflow_tpu_torch.chaos`) drives: a pod that runs fine, goes quiet,
  then dies is three phases, not a new kubelet.

Passing ``chaos=FaultPlan(...)`` additionally lets the plan stall this
kubelet's loop (detection-latency faults) and fire cluster-level faults
(node drains) from ``step()``.

The port's copy of ``kubeflow_tpu/controlplane/fake_kubelet.py``,
device-free like it, with the same names; it imports nothing of the
reference package.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .objects import KIND_POD, Pod, PodPhase
from .store import AlreadyExists, NotFound, Store

log = logging.getLogger("kubeflow_tpu_torch.fake-kubelet")


@dataclass
class ScriptPhase:
    """One step of a multi-phase pod life (all while RUNNING)."""

    duration: float = 0.0
    #: the pod crosses its first collective barrier entering this phase
    barrier: bool = False
    #: whether the pod keeps reporting activity heartbeats in this phase
    #: (False models a wedged-but-alive process going quiet)
    activity: bool = True


@dataclass
class PodScript:
    """What happens to a pod once it starts."""

    run_seconds: float = 0.0
    exit_code: int = 0
    barrier_after: Optional[float] = 0.0  # None = never reaches the barrier
    hang: bool = False
    #: multi-phase mode: walk these steps, then apply exit_code/hang.
    #: ``run_seconds``/``barrier_after`` are ignored when phases are set
    #: (the phases carry the timing and the barrier crossing).
    phases: list[ScriptPhase] = field(default_factory=list)


DEFAULT_SCRIPT = PodScript()

ScriptFn = Callable[[Pod], PodScript]


@dataclass
class _Running:
    start: float
    script: PodScript
    phase: int = 0          # index into script.phases
    phase_start: float = 0.0


class FakeKubelet:
    def __init__(self, store: Store, script: Optional[ScriptFn] = None,
                 interval: float = 0.01, chaos=None):
        self.store = store
        if script is None and chaos is not None:
            script = chaos.script_fn()
        self.script: ScriptFn = script or (lambda pod: DEFAULT_SCRIPT)
        self.interval = interval
        self.chaos = chaos
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: serializes the tick against attach_store's swap+resync — a
        #: tick landing between the two would sweep crash-lost pods out
        #: of _last_seen before resync could re-report them
        self._tick_lock = threading.Lock()
        self._running: dict[str, _Running] = {}
        #: ns/name -> last pod object this kubelet reported (uid inside):
        #: the node's own view of its pods, which is what survives a
        #: control-plane crash and feeds the adoption relist (resync)
        self._last_seen: dict[str, Pod] = {}

    def start(self) -> None:
        if self.chaos is not None:
            self.chaos.activate()
        self._stop.clear()  # re-startable: the node outlives a control plane
        self._thread = threading.Thread(target=self._loop, name="fake-kubelet", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self.chaos is not None and self.chaos.kubelet_stalled():
                    self._stop.wait(self.interval)
                    continue
                with self._tick_lock:
                    self.step()
            except Exception:  # noqa: BLE001 — the kubelet loop must survive
                log.debug("fake-kubelet step failed", exc_info=True)
            self._stop.wait(self.interval)

    # -- control-plane crash-restart (adoption) ---------------------------

    def attach_store(self, store: Store) -> None:
        """Point this kubelet at a RESTARTED control plane's store and
        re-report everything the node still knows (``resync``) — the
        kubelet relist that makes surviving pods adoptable.  Call this
        BEFORE the new cluster's controllers start, so their initial
        list already contains the survivors (informer-sync-before-
        reconcile); creates race-safely no-op on AlreadyExists either
        way.  Safe while the kubelet loop runs: the swap + resync are
        one atomic unit w.r.t. ticks."""
        with self._tick_lock:
            self.store = store
            self.resync()

    def resync(self) -> None:
        """Reconcile the store against this node's view:

        - a pod the node runs (or finished during the outage) that the
          recovered store LOST (its create/status records sat past the
          durability horizon) is re-created verbatim — same uid, labels,
          owner refs — so the controller adopts it by owner-ref match
          instead of double-creating the gang member;
        - a pod the store recovered with a STALE status (e.g. RUNNING
          though it finished while the control plane was down) gets the
          node's truth replayed onto it.  The kubelet is the sole status
          writer, so node truth always wins on matching uid."""
        for nkey, pod in list(self._last_seen.items()):
            ns, name = nkey.split("/", 1)
            cur = self.store.try_get(KIND_POD, name, ns)
            if cur is None:
                obj = copy.deepcopy(pod)
                obj.metadata.resource_version = 0
                try:
                    self.store.create(obj)
                except AlreadyExists:
                    pass  # raced a controller create of the same name
                except NotFound:
                    pass  # admission raced an owner lookup; next step heals
                continue
            assert isinstance(cur, Pod)
            if cur.metadata.uid != pod.metadata.uid:
                continue  # a newer incarnation owns the name now
            if cur.status == pod.status and cur.spec.node_name:
                continue

            def mut(o, p=pod):
                o.status = p.status.model_copy(deep=True)
                if not o.spec.node_name:  # lost binding: the node knows
                    o.spec.node_name = p.spec.node_name

            try:
                self.store.update_with_retry(KIND_POD, name, ns, mut)
            except NotFound:
                pass
        # the inverse direction: a recovered pod that claims to be
        # RUNNING but that this node does not know (its delete record
        # was lost, so the store resurrected it) has no process behind
        # it — report it failed so the controller re-forms the gang
        # instead of waiting forever on a ghost
        for pod in self.store.list(KIND_POD):
            assert isinstance(pod, Pod)
            nkey = f"{pod.metadata.namespace}/{pod.metadata.name}"
            if (pod.status.phase != PodPhase.RUNNING
                    or nkey in self._last_seen):
                continue

            def lost(o):
                o.status.phase = PodPhase.FAILED
                o.status.exit_code = 137
                o.status.message = "no process on node after restart"
                o.status.finish_time = time.time()

            try:
                self.store.update_with_retry(
                    KIND_POD, pod.metadata.name, pod.metadata.namespace, lost)
            except NotFound:
                pass

    def step(self) -> None:
        now = time.time()
        if self.chaos is not None:
            self.chaos.apply_cluster_faults(self.store, now)
        # ONE store snapshot per tick (list deep-copies under the store
        # lock): both the deletion sweep and the pod loop work off it
        pods = [p for p in self.store.list(KIND_POD) if isinstance(p, Pod)]
        present = {
            f"{p.metadata.namespace}/{p.metadata.name}/{p.metadata.uid}"
            for p in pods}
        for key in list(self._running):
            if key not in present:
                # the pod object was deleted while we watched: the
                # controller killed it — the local "process" dies too
                self._running.pop(key, None)
                nkey, _, uid = key.rpartition("/")
                seen = self._last_seen.get(nkey)
                if seen is not None and seen.metadata.uid == uid:
                    self._last_seen.pop(nkey, None)
        for pod in pods:
            key = f"{pod.metadata.namespace}/{pod.metadata.name}/{pod.metadata.uid}"
            if pod.status.phase == PodPhase.PENDING and pod.spec.node_name:
                script = self.script(pod)
                self._running[key] = _Running(now, script, phase_start=now)
                self._mutate(pod, lambda o: self._start(o, now, script))
            elif pod.status.phase == PodPhase.RUNNING and key in self._running:
                run = self._running[key]
                if run.script.phases:
                    self._step_phases(pod, run, now, key)
                    continue
                if run.script.hang:
                    continue
                if now - run.start >= run.script.run_seconds:
                    del self._running[key]
                    self._mutate(pod, lambda o: self._finish(o, run.script, now))

    def _step_phases(self, pod: Pod, run: _Running, now: float, key: str) -> None:
        """Advance a multi-phase script: cross due phase boundaries, stamp
        barrier/activity status, finish after the last phase."""
        while run.phase < len(run.script.phases):
            phase = run.script.phases[run.phase]
            if now - run.phase_start < phase.duration:
                # heartbeat at ~10 Hz, not every kubelet tick: each write
                # is a store update fanning out to every watch
                if phase.activity and (pod.status.last_activity is None
                                       or now - pod.status.last_activity >= 0.1):
                    self._mutate(pod, lambda o: setattr(
                        o.status, "last_activity", now))
                return
            run.phase += 1
            run.phase_start = now
            if run.phase < len(run.script.phases):
                nxt = run.script.phases[run.phase]
                if nxt.barrier:
                    self._mutate(pod, lambda o: setattr(
                        o.status, "barrier_time",
                        o.status.barrier_time or now))
        if run.script.hang:
            return
        del self._running[key]
        self._mutate(pod, lambda o: self._finish(o, run.script, now))

    @staticmethod
    def _start(pod: Pod, now: float, script: PodScript) -> None:
        pod.status.phase = PodPhase.RUNNING
        pod.status.start_time = now
        if script.phases:
            if script.phases[0].barrier:
                pod.status.barrier_time = now
            if script.phases[0].activity:
                pod.status.last_activity = now
        elif script.barrier_after is not None and script.barrier_after <= 0:
            pod.status.barrier_time = now

    @staticmethod
    def _finish(pod: Pod, script: PodScript, now: float) -> None:
        if (not script.phases and script.barrier_after is not None
                and pod.status.barrier_time is None):
            pod.status.barrier_time = (pod.status.start_time or now) + script.barrier_after
        pod.status.phase = PodPhase.SUCCEEDED if script.exit_code == 0 else PodPhase.FAILED
        pod.status.exit_code = script.exit_code
        pod.status.finish_time = now

    def _mutate(self, pod: Pod, fn) -> None:
        nkey = f"{pod.metadata.namespace}/{pod.metadata.name}"
        try:
            out = self.store.update_with_retry(
                KIND_POD, pod.metadata.name, pod.metadata.namespace, fn
            )
            assert isinstance(out, Pod)
            # the node's own record of this pod (store returns a copy):
            # what resync re-reports after a control-plane crash
            self._last_seen[nkey] = out
        except NotFound:
            self._running.pop(f"{nkey}/{pod.metadata.uid}", None)
            self._last_seen.pop(nkey, None)
