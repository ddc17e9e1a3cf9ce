"""FaultPlan: a deterministic, seed-driven fault-injection schedule.

The chaos layer that makes every recovery path in this platform testable
without real processes (ISSUE 1 tentpole; SURVEY §4's envtest gap —
restart policies go untested upstream because nothing ever *fails* in
envtest).  A plan is a list of faults with firing conditions; the same
seed always yields the same member choices and the same schedule, so a
failing chaos test reproduces byte-for-byte.

Integration points:

- ``plan.script_fn()`` -> a :class:`~..controlplane.fake_kubelet.ScriptFn`
  for :class:`FakeKubelet`: pod-level faults (crash at t, barrier hang,
  flaky-then-succeed, coordinator kill) become multi-phase
  :class:`PodScript`s, tracked per pod *incarnation* so a fault can hit
  the first N lives of a pod and spare the rest;
- ``FakeKubelet(..., chaos=plan)`` -> cluster-level faults: kubelet
  stalls (the loop stops stepping pods, modelling detection latency) and
  node drains/preemptions (the Node object vanishes and its pods fail
  with the preemption exit code);
- ``plan.socket_wrapper(role)`` -> an injectable wrapper for
  :class:`~..serving.gang.GangChannel` sockets: connection drops and
  send delays on the gang control stream (chaos/net.py).

Times are relative to ``plan.activate()`` (called by the kubelet's
``start()``/first tick, or explicitly by a test).

The port's copy of ``kubeflow_tpu/chaos/plan.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import enum
import random
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Optional

#: the exit code a preempted/drained pod dies with (SIGKILL-style,
#: retryable under RestartPolicy.EXIT_CODE)
PREEMPTION_EXIT_CODE = 137


class FaultKind(str, enum.Enum):
    CRASH = "crash"                  # pod dies at t with exit_code
    BARRIER_HANG = "barrier_hang"    # pod runs but never reaches the barrier
    FLAKY = "flaky"                  # first N incarnations fail, then succeed
    KUBELET_STALL = "kubelet_stall"  # kubelet loop pauses for a window
    NODE_DRAIN = "node_drain"        # node vanishes; its pods are preempted
    SOCKET_DROP = "socket_drop"      # gang control socket dies mid-stream
    SOCKET_DELAY = "socket_delay"    # gang control sends are delayed
    CONTROL_PLANE_CRASH = "control_plane_crash"  # kill -9 at a WAL offset
    REPLICA_KILL = "replica_kill"    # serving replica dies mid-storm
    GANG_MEMBER_LOSS = "gang_member_loss"  # gang member dies, maybe forever
    RESIZE_KILL = "resize_kill"      # elastic resize dies at a phase
    SPILL_TORN = "spill_torn"        # published spill file loses its tail
    SPILL_KILL = "spill_kill"        # process dies mid-spill-write
    TIER_IO_STALL = "tier_io_stall"  # storage-tier I/O wedges for a window
    AUTOSCALE_ACTUATOR_FAIL = "autoscale_actuator_fail"  # actuator dies
    DOMAIN_OUTAGE = "domain_outage"  # failure domain dies at once


@dataclass
class Fault:
    kind: FaultKind
    #: worker replica index the fault targets (pod-level faults)
    index: Optional[int] = None
    #: job-name filter; None = any job
    job: Optional[str] = None
    #: seconds after activation (cluster faults) or after pod start
    #: (pod faults) when the fault fires
    at: float = 0.0
    duration: float = 0.0
    exit_code: int = PREEMPTION_EXIT_CODE
    #: how many pod incarnations the fault applies to (CRASH/FLAKY)
    times: int = 1
    node: Optional[str] = None
    #: "leader" | "follower" — which side's sockets a net fault wraps
    role: str = "follower"
    #: SOCKET_DROP: sendall/recv calls on the wrapped socket before the
    #: drop (None = drop on connect)
    after_calls: Optional[int] = None
    delay: float = 0.0
    #: CONTROL_PLANE_CRASH: bytes of the in-flight WAL record that reach
    #: disk before the machine dies (a torn tail for recovery to chew on)
    torn_bytes: int = 0
    #: bookkeeping: consumed count (pod faults), fired flag (cluster)
    fired: int = field(default=0, compare=False)


class FaultPlan:
    """Seed-driven fault schedule; see module docstring for the hooks."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.rng = random.Random(seed)
        self.faults: list[Fault] = []
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        #: pod-name -> incarnations seen (a new uid = a new life)
        self._lives: dict[str, set[str]] = defaultdict(set)
        #: memoized WalCrashPoint (wal_crashpoint())
        self._crashpoint = None

    # -- builders (chainable) ---------------------------------------------

    def crash_pod(self, index: int, at: float = 0.0,
                  exit_code: int = PREEMPTION_EXIT_CODE, times: int = 1,
                  job: Optional[str] = None) -> "FaultPlan":
        """Worker ``index`` dies ``at`` seconds into its run, for the
        first ``times`` incarnations."""
        self.faults.append(Fault(FaultKind.CRASH, index=index, at=at,
                                 exit_code=exit_code, times=times, job=job))
        return self

    def crash_random_member(self, world: int, at: float = 0.0,
                            exit_code: int = PREEMPTION_EXIT_CODE,
                            times: int = 1,
                            job: Optional[str] = None) -> "FaultPlan":
        """Seeded random gang member dies mid-run — the canonical chaos
        scenario (the choice is frozen at plan-build time, so the same
        seed kills the same rank)."""
        return self.crash_pod(self.rng.randrange(world), at=at,
                              exit_code=exit_code, times=times, job=job)

    def coordinator_kill(self, at: float = 0.0,
                         exit_code: int = PREEMPTION_EXIT_CODE,
                         times: int = 1,
                         job: Optional[str] = None) -> "FaultPlan":
        """Kill rank 0 — the worst member to lose (it is the
        jax.distributed coordinator AND the serving-gang leader)."""
        return self.crash_pod(0, at=at, exit_code=exit_code, times=times,
                              job=job)

    def flaky(self, index: int, failures: int = 1, run_seconds: float = 0.02,
              exit_code: int = PREEMPTION_EXIT_CODE,
              job: Optional[str] = None) -> "FaultPlan":
        """First ``failures`` incarnations of worker ``index`` die early,
        then it behaves — the flapping-node shape that used to trigger a
        fixed-interval restart storm."""
        self.faults.append(Fault(FaultKind.FLAKY, index=index,
                                 at=run_seconds, exit_code=exit_code,
                                 times=failures, job=job))
        return self

    def barrier_hang(self, index: int,
                     job: Optional[str] = None) -> "FaultPlan":
        """Worker ``index`` runs but never reaches its first collective
        barrier (a wedged rendezvous)."""
        self.faults.append(Fault(FaultKind.BARRIER_HANG, index=index, job=job))
        return self

    def kubelet_stall(self, at: float = 0.0,
                      duration: float = 1.0) -> "FaultPlan":
        """The kubelet loop freezes for ``duration`` seconds starting
        ``at`` seconds after activation: pods bound in the window start
        late, failures in the window are detected late."""
        self.faults.append(
            Fault(FaultKind.KUBELET_STALL, at=at, duration=duration))
        return self

    def node_drain(self, node: str, at: float = 0.0) -> "FaultPlan":
        """Node ``node`` vanishes ``at`` seconds after activation
        (preemption/maintenance): its non-terminal pods die with the
        preemption exit code and the gang must re-form elsewhere."""
        self.faults.append(Fault(FaultKind.NODE_DRAIN, node=node, at=at))
        return self

    def socket_drop(self, role: str = "follower",
                    after_calls: Optional[int] = None,
                    times: int = 1) -> "FaultPlan":
        """Drop a gang control-stream socket after ``after_calls``
        send/recv calls (None = at connect) — the follower-reconnect
        scenario.  Applies to the first ``times`` sockets wrapped for
        ``role``; reconnected sockets beyond that are clean."""
        self.faults.append(Fault(FaultKind.SOCKET_DROP, role=role,
                                 after_calls=after_calls, times=times))
        return self

    def kv_migrate_drop(self, after_frames: Optional[int] = None,
                        times: int = 1,
                        max_frames: int = 12) -> "FaultPlan":
        """Kill a live KV migration mid-stream: the next ``times``
        sockets wrapped for role ``"kv_migrate"`` die after
        ``after_frames`` send/recv calls (None = seeded random offset in
        ``[0, max_frames)`` — early kills hit the handshake/kv_begin,
        late ones land mid-block or between commit and ack).  Consume
        via ``sock_wrap=plan.socket_wrapper("kv_migrate")`` on
        ``migrate_sequence`` / ``KvMigrationServer``.  The contract
        under test is copy-then-cutover (ISSUE 8): the source sequence
        keeps decoding, no client token is duplicated or dropped, and
        neither allocator leaks a block."""
        if after_frames is None:
            after_frames = self.rng.randrange(max_frames)
        self.faults.append(Fault(FaultKind.SOCKET_DROP, role="kv_migrate",
                                 after_calls=after_frames, times=times))
        return self

    def control_plane_crash(self, after_records: Optional[int] = None,
                            max_records: int = 64,
                            torn_bytes: Optional[int] = None) -> "FaultPlan":
        """kill -9 the control plane once its WAL has appended
        ``after_records`` records (None = seeded random offset in
        ``[0, max_records)``), with ``torn_bytes`` of the record
        in flight at death reaching disk (None = seeded draw between a
        clean cut and a mid-record tear) — the one fault PR 1 could not
        reach.  Nothing later persists; the surviving kubelets/pods keep
        running unadopted until a restarted Cluster (same ``data_dir``)
        replays the log and re-adopts them.  Consume via
        ``Cluster(data_dir=..., wal_crashpoint=plan.wal_crashpoint())``;
        ``plan.wal_crashpoint().fired`` is the death notification."""
        if after_records is None:
            after_records = self.rng.randrange(max_records)
        if torn_bytes is None:
            torn_bytes = self.rng.choice((0, 0, 5, 11, 23))
        self.faults.append(Fault(FaultKind.CONTROL_PLANE_CRASH,
                                 after_calls=after_records,
                                 torn_bytes=torn_bytes))
        return self

    def wal_crashpoint(self):
        """The :class:`~kubeflow_tpu_torch.controlplane.wal.WalCrashPoint` for
        this plan's CONTROL_PLANE_CRASH fault (built once, so tests can
        both hand it to the Cluster and wait on ``.fired``); None when
        the plan has no control-plane fault."""
        from ..controlplane.wal import WalCrashPoint

        with self._lock:
            if getattr(self, "_crashpoint", None) is None:
                f = next((f for f in self.faults
                          if f.kind == FaultKind.CONTROL_PLANE_CRASH), None)
                if f is None:
                    return None
                self._crashpoint = WalCrashPoint(
                    after_records=f.after_calls or 0,
                    torn_bytes=f.torn_bytes)
            return self._crashpoint

    def replica_kill_mid_storm(self, world: int,
                               at: Optional[float] = None,
                               min_at: float = 0.2,
                               max_at: float = 2.0) -> "FaultPlan":
        """Kill one of ``world`` serving replicas at a seeded offset
        into a traffic storm (ISSUE 9): the member choice AND the kill
        time are frozen at plan-build time, so a failing storm run
        reproduces byte-for-byte.  The open-loop traffic bench /
        chaos test polls :meth:`due_replica_kills` from its arrival
        loop and abruptly stops the chosen replica server.  The
        contract under test: already-shed requests got their explicit
        429 (never a hang), in-flight requests on the dead replica
        surface as a bounded re-route or 5xx (never a hang), and
        prefix affinity forgets the corpse — same-prefix traffic
        re-routes to the survivors."""
        if at is None:
            at = min_at + self.rng.random() * max(max_at - min_at, 0.0)
        self.faults.append(Fault(FaultKind.REPLICA_KILL,
                                 index=self.rng.randrange(world), at=at))
        return self

    def due_replica_kills(self, now: Optional[float] = None) -> list[int]:
        """Replica indices whose seeded kill is due (each fault fires
        at most once) — the actuator poll for the storm driver."""
        t = self.elapsed(now)
        out: list[int] = []
        with self._lock:
            for f in self.faults:
                if (f.kind == FaultKind.REPLICA_KILL and not f.fired
                        and t >= f.at):
                    f.fired = 1
                    out.append(f.index)
        return out

    def domain_outage(self, domains, at: Optional[float] = None,
                      min_at: float = 0.2, max_at: float = 2.0,
                      duration: float = 0.0) -> "FaultPlan":
        """Correlated failure (ISSUE 16): one of ``domains`` (a list of
        failure-domain names) dies WHOLE at a seeded offset — every
        replica labeled with that domain stops at once, the
        rack/zone-loss shape no single-replica fault exercises.  The
        victim domain AND the outage time are frozen at plan-build
        time (same seed = same domain dies at the same offset).  The
        outage driver polls :meth:`due_domain_outages` from its
        arrival loop and abruptly stops every replica of the named
        domain.  ``duration > 0`` means the domain comes back after
        the window (the driver restarts it); 0 = permanent for the
        run.  Contract under test: the router's circuits open, the
        domain's sessions/affinity/registry rows mass-forget in one
        pass, retry amplification stays inside the budget, and the
        surge path brings the fleet back under SLO."""
        names = [str(d) for d in domains]
        if not names:
            raise ValueError("domain_outage needs at least one domain")
        if at is None:
            at = min_at + self.rng.random() * max(max_at - min_at, 0.0)
        self.faults.append(Fault(
            FaultKind.DOMAIN_OUTAGE,
            node=names[self.rng.randrange(len(names))],
            at=at, duration=duration))
        return self

    def due_domain_outages(self, now: Optional[float] = None) -> list[str]:
        """Failure-domain names whose seeded outage is due (each fault
        fires at most once) — the actuator poll for the outage driver,
        mirroring :meth:`due_replica_kills`."""
        t = self.elapsed(now)
        out: list[str] = []
        with self._lock:
            for f in self.faults:
                if (f.kind == FaultKind.DOMAIN_OUTAGE and not f.fired
                        and t >= f.at):
                    f.fired = 1
                    out.append(f.node)
        return out

    def gang_member_loss(self, world: int, at: Optional[float] = None,
                         permanent: bool = True, min_at: float = 0.1,
                         max_at: float = 1.0, spare_leader: bool = True,
                         job: Optional[str] = None) -> "FaultPlan":
        """Seeded gang-member loss (ISSUE 10).  Today's socket faults
        are all TRANSIENT — the member reconnects and PR 1's replay
        heals the stream.  ``permanent=True`` is the fault that
        machinery cannot absorb: the member never comes back (a dead
        chip), so the gang must either go fatal past the re-attach
        grace or — with elastic resize configured — shrink to the
        surviving degree.  The member choice and kill time are frozen
        at plan-build time (same seed = same rank dies at the same
        offset).  ``spare_leader`` keeps rank 0 alive: losing the
        leader is a full gang restart, not a resize.  Pod-level runs
        consume it through :meth:`script_fn` (a crash for effectively
        unlimited incarnations when permanent); in-process gang tests
        poll :meth:`due_member_losses` and sever the chosen member's
        channel for good."""
        if at is None:
            at = min_at + self.rng.random() * max(max_at - min_at, 0.0)
        lo = 1 if (spare_leader and world > 1) else 0
        rank = self.rng.randrange(lo, world)
        self.faults.append(Fault(
            FaultKind.GANG_MEMBER_LOSS, index=rank, at=at, job=job,
            times=(1_000_000 if permanent else 1)))
        return self

    def due_member_losses(self, now: Optional[float] = None) -> list[int]:
        """Gang ranks whose seeded loss is due (each fault fires at
        most once from this poll) — the actuator for in-process gang
        tests, mirroring :meth:`due_replica_kills`."""
        t = self.elapsed(now)
        out: list[int] = []
        with self._lock:
            for f in self.faults:
                if (f.kind == FaultKind.GANG_MEMBER_LOSS and not f.fired
                        and t >= f.at):
                    f.fired = 1
                    out.append(f.index)
        return out

    RESIZE_PHASES = ("export", "reshard", "commit")

    def kill_mid_resize(self, phases=RESIZE_PHASES,
                        phase: Optional[str] = None,
                        times: int = 1) -> "FaultPlan":
        """Seeded kill at an elastic-resize phase (ISSUE 10): the
        returned plan's :meth:`resize_failpoint` raises inside
        ``GangResizer`` at the chosen phase offset — mid-export,
        mid-reshard or mid-commit.  Contract under test
        (copy-then-cutover): the old-degree gang keeps serving,
        every client token is delivered exactly once, and neither
        allocator leaks a block."""
        if phase is None:
            phase = phases[self.rng.randrange(len(phases))]
        self.faults.append(Fault(FaultKind.RESIZE_KILL, role=str(phase),
                                 times=times))
        return self

    def resize_failpoint(self):
        """A ``callable(phase)`` for ``GangResizer(failpoint=...)``:
        raises at the plan's seeded RESIZE_KILL phase, at most
        ``times`` firings; clean pass-through otherwise."""
        def fp(phase: str) -> None:
            with self._lock:
                for f in self.faults:
                    if (f.kind == FaultKind.RESIZE_KILL
                            and f.role == phase and f.fired < f.times):
                        f.fired += 1
                        raise RuntimeError(
                            f"chaos: resize killed mid-{phase}")
        return fp

    # -- autoscale actuator faults (ISSUE 15) ------------------------------
    #
    # The ClusterAutoscaler's actuators are multi-step live-state moves
    # (replica drain, TP resize, tier rebalance, scale-to-zero
    # hibernation) — any of them can fail mid-flight (a wedged drain, a
    # follower nack, an unreachable new replica).  The loop's contract
    # under injected failure: exponential backoff, at most
    # ``max_retries`` attempts per demand episode (then the channel
    # PARKS), and no flapping — pinned by the seeded sweep in
    # tests/test_chaos.py.

    AUTOSCALE_ACTUATORS = ("replica_up", "replica_down", "resize",
                           "tier", "zero")

    def autoscale_actuator_fail(self, actuator: Optional[str] = None,
                                times: int = 1) -> "FaultPlan":
        """Seeded failure of one autoscaler actuator channel (None =
        seeded draw over :data:`AUTOSCALE_ACTUATORS` — a failed
        placement, failed drain, failed resize, failed rebalance or
        failed zero).  Consumed by :meth:`autoscale_failpoint`: the
        loop's next ``times`` firings of that channel raise before the
        actuator body runs."""
        if actuator is None:
            actuator = self.AUTOSCALE_ACTUATORS[
                self.rng.randrange(len(self.AUTOSCALE_ACTUATORS))]
        if actuator not in self.AUTOSCALE_ACTUATORS:
            raise ValueError(
                f"unknown autoscale actuator {actuator!r} "
                f"(one of {self.AUTOSCALE_ACTUATORS})")
        self.faults.append(Fault(FaultKind.AUTOSCALE_ACTUATOR_FAIL,
                                 role=str(actuator), times=times))
        return self

    def autoscale_failpoint(self):
        """A ``callable(channel)`` for
        ``ClusterAutoscaler(failpoint=...)``: raises when the loop
        fires the seeded channel, at most ``times`` firings; clean
        pass-through otherwise."""
        def fp(channel: str) -> None:
            with self._lock:
                for f in self.faults:
                    if (f.kind == FaultKind.AUTOSCALE_ACTUATOR_FAIL
                            and f.role == channel and f.fired < f.times):
                        f.fired += 1
                        raise RuntimeError(
                            f"chaos: autoscale {channel} actuator "
                            "failed")
        return fp

    def due_autoscale_fails(self) -> list[str]:
        """Actuator channels whose seeded failures are NOT yet
        exhausted — the paired read-only probe (tests assert the sweep
        consumed every injected failure; consuming happens in
        :meth:`autoscale_failpoint`, once per loop firing)."""
        with self._lock:
            return [f.role for f in self.faults
                    if f.kind == FaultKind.AUTOSCALE_ACTUATOR_FAIL
                    and f.fired < f.times]

    # -- storage-tier faults (ISSUE 12: crash-safe KV tiering) -------------
    #
    # The spill path (serving/storage.py KvSpillStore) has three failure
    # shapes the hibernate/thaw contract must absorb: the writer dies
    # mid-spill (nothing may publish — the session resumes in place),
    # a PUBLISHED spill loses bytes at rest (torn write / bit rot — the
    # thaw must detect it via the manifest hashes and re-prefill, never
    # serve corrupt KV), and the tier's I/O wedges (a hung NFS mount —
    # bounded stall, not a scheduler hang).  Each has a builder here and
    # a ``due_*`` actuator the store polls at its phase boundaries.

    SPILL_PHASES = ("payload", "meta", "publish")

    def spill_kill_mid_write(self, phase: Optional[str] = None,
                             times: int = 1) -> "FaultPlan":
        """The spilling process dies at a seeded write phase (payload
        bytes / manifest / publish rename).  Consumed by
        ``KvSpillStore(chaos=plan)``: the write raises after the chosen
        phase's bytes hit the staging dir, so nothing is ever published
        — a half-written spill is a stale staging dir, and the source
        engine resumes the sequence in place (copy-then-cutover,
        lifted to the storage tier)."""
        if phase is None:
            phase = self.SPILL_PHASES[
                self.rng.randrange(len(self.SPILL_PHASES))]
        self.faults.append(Fault(FaultKind.SPILL_KILL, role=str(phase),
                                 times=times))
        return self

    def spill_torn(self, torn_bytes: Optional[int] = None,
                   times: int = 1) -> "FaultPlan":
        """A PUBLISHED spill file loses its last ``torn_bytes`` bytes
        (torn write at the device layer, the PR 5 WAL-tail shape one
        tier down; None = seeded draw).  Consumed by
        ``KvSpillStore(chaos=plan)`` right after publish: the entry
        exists and its manifest is intact, but a payload hash no longer
        matches — thaw must detect it and re-prefill from the manifest's
        token record instead of serving wrong KV."""
        if torn_bytes is None:
            torn_bytes = self.rng.choice((1, 7, 64, 4096))
        self.faults.append(Fault(FaultKind.SPILL_TORN,
                                 torn_bytes=int(torn_bytes), times=times))
        return self

    def tier_io_stall(self, seconds: float = 0.2,
                      times: int = 1) -> "FaultPlan":
        """Storage-tier I/O wedges for ``seconds`` on the next
        ``times`` spill/thaw operations (a hung remote mount).
        Consumed by ``KvSpillStore(chaos=plan)`` at operation start —
        the stall lands on the HIBERNATION WORKER thread by
        construction (spill I/O never runs on an engine scheduler: the
        analyzer roots ``*Tier``/``*Spill``/``*Hibernate`` classes),
        so live decode traffic keeps flowing through the window."""
        self.faults.append(Fault(FaultKind.TIER_IO_STALL,
                                 delay=float(seconds), times=times))
        return self

    def due_spill_kills(self) -> list[str]:
        """Spill-write phases whose seeded kill is due — polled by the
        store ONCE per write.  At most ONE kill is drawn per call: a
        write dies at a single phase, and draining every seeded kill
        into one doomed write would consume later-phase kills without
        ever firing them (two seeded kills = two killed writes)."""
        out: list[str] = []
        with self._lock:
            for f in self.faults:
                if (f.kind == FaultKind.SPILL_KILL
                        and f.fired < f.times):
                    f.fired += 1
                    out.append(f.role)
                    break
        return out

    def due_spill_torn(self) -> list[int]:
        """Byte counts to tear off the just-published spill's payload
        tail — polled by the store after each publish."""
        out: list[int] = []
        with self._lock:
            for f in self.faults:
                if (f.kind == FaultKind.SPILL_TORN
                        and f.fired < f.times):
                    f.fired += 1
                    out.append(int(f.torn_bytes))
        return out

    def due_tier_stalls(self) -> list[float]:
        """Seconds of storage-tier stall due for the next I/O op —
        polled by the store at operation start."""
        out: list[float] = []
        with self._lock:
            for f in self.faults:
                if (f.kind == FaultKind.TIER_IO_STALL
                        and f.fired < f.times):
                    f.fired += 1
                    out.append(float(f.delay))
        return out

    def socket_delay(self, role: str = "leader", delay: float = 0.01,
                     times: int = 1) -> "FaultPlan":
        """Add ``delay`` seconds to every send on the next ``times``
        sockets wrapped for ``role`` (a slow cross-host link)."""
        self.faults.append(Fault(FaultKind.SOCKET_DELAY, role=role,
                                 delay=delay, times=times))
        return self

    # -- activation / clock ------------------------------------------------

    def activate(self, now: Optional[float] = None) -> "FaultPlan":
        """Start the plan clock (idempotent).  FakeKubelet calls this on
        ``start()``; tests may call it explicitly."""
        with self._lock:
            if self._t0 is None:
                self._t0 = time.time() if now is None else now
        return self

    def elapsed(self, now: Optional[float] = None) -> float:
        if self._t0 is None:
            return 0.0
        return (time.time() if now is None else now) - self._t0

    # -- FakeKubelet integration ------------------------------------------

    def kubelet_stalled(self, now: Optional[float] = None) -> bool:
        """True while a KUBELET_STALL window is open."""
        t = self.elapsed(now)
        return any(
            f.kind == FaultKind.KUBELET_STALL
            and f.at <= t < f.at + f.duration
            for f in self.faults
        )

    def apply_cluster_faults(self, store, now: Optional[float] = None) -> None:
        """Fire due cluster-level faults (node drains) against the store.

        Called from ``FakeKubelet.step()`` — the kubelet is the one
        component that already touches every pod, so it doubles as the
        chaos actuator, exactly once per fault.
        """
        from ..controlplane.objects import KIND_NODE, KIND_POD, PodPhase

        t = self.elapsed(now)
        for f in self.faults:
            if f.kind != FaultKind.NODE_DRAIN or f.fired or t < f.at:
                continue
            f.fired = 1
            store.try_delete(KIND_NODE, f.node)
            for pod in store.list(KIND_POD):
                if pod.spec.node_name != f.node or pod.terminal:
                    continue

                def preempt(o, code=f.exit_code):
                    o.status.phase = PodPhase.FAILED
                    o.status.exit_code = code
                    o.status.message = f"node {o.spec.node_name} drained"
                    o.status.finish_time = time.time()

                try:
                    store.update_with_retry(
                        KIND_POD, pod.metadata.name,
                        pod.metadata.namespace, preempt)
                except Exception:  # noqa: BLE001 — pod raced deletion
                    pass

    def _incarnation(self, pod) -> int:
        """0-based life count for this pod name (a new uid = a new life)."""
        with self._lock:
            lives = self._lives[
                f"{pod.metadata.namespace}/{pod.metadata.name}"]
            lives.add(pod.metadata.uid)
            return len(lives) - 1

    def pod_script(self, pod, default=None):
        """Resolve the PodScript for one pod incarnation (the ScriptFn
        body); ``default`` supplies the healthy behavior."""
        from ..controlplane.fake_kubelet import DEFAULT_SCRIPT, PodScript

        base = default(pod) if default is not None else DEFAULT_SCRIPT
        job = pod.metadata.labels.get("job-name")
        try:
            idx = int(pod.metadata.labels.get("replica-index", -1))
        except (TypeError, ValueError):
            idx = -1
        incarnation = self._incarnation(pod)
        for f in self.faults:
            if f.job is not None and f.job != job:
                continue
            if f.kind == FaultKind.BARRIER_HANG and f.index == idx:
                return PodScript(hang=True, barrier_after=None)
            if f.kind in (FaultKind.CRASH, FaultKind.FLAKY,
                          FaultKind.GANG_MEMBER_LOSS) and f.index == idx:
                if incarnation < f.times:
                    return PodScript(run_seconds=f.at,
                                     exit_code=f.exit_code,
                                     barrier_after=base.barrier_after)
        return base

    def script_fn(self, default=None) -> Callable:
        """A ScriptFn for FakeKubelet: chaos faults first, ``default``
        (healthy behavior) otherwise."""
        return lambda pod: self.pod_script(pod, default=default)

    # -- gang-socket integration ------------------------------------------

    def socket_wrapper(self, role: str) -> Callable:
        """A ``sock -> sock`` wrapper for GangChannel injection: applies
        the next unconsumed SOCKET_* fault for ``role``; clean
        pass-through once the plan's net faults are spent."""
        from .net import ChaosSocket

        def wrap(sock):
            with self._lock:
                for f in self.faults:
                    if f.role != role or f.fired >= f.times:
                        continue
                    if f.kind == FaultKind.SOCKET_DROP:
                        f.fired += 1
                        return ChaosSocket(sock, drop_after_calls=f.after_calls)
                    if f.kind == FaultKind.SOCKET_DELAY:
                        f.fired += 1
                        return ChaosSocket(sock, send_delay=f.delay)
            return sock

        return wrap
