"""Controller runtime: watch-driven workqueue + reconcile loop.

The controller-runtime analog [upstream: kubernetes-sigs/controller-runtime,
as consumed by kubeflow/training-operator]: watch events enqueue object keys
into a deduplicating workqueue; worker threads pop keys and call
``reconcile(key)``; a reconcile may request requeue-after; errors requeue
with exponential backoff.  Controllers also watch *owned* kinds (pods,
services) and map those events back to the owner's key, exactly the
``Owns(...)`` wiring in the reference's ``SetupWithManager``.

The port's copy of ``kubeflow_tpu/controlplane/controller.py``, device-
free like it, with the same names; it imports nothing of the reference
package.
"""

from __future__ import annotations

import heapq
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from ..api.common import TypedObject
from .objects import Event, KIND_EVENT
from .store import DELETED, TOO_OLD, Store, WatchEvent

log = logging.getLogger("kubeflow_tpu_torch.controlplane")


@dataclass(order=True)
class _QueueItem:
    at: float
    key: str = field(compare=False)


class WorkQueue:
    """Deduplicating delay queue (client-go workqueue analog).

    In-flight dedup, client-go style: a key handed to a worker is
    *processing* until ``done(key)``; adds for it meanwhile are parked
    (dirty-set) and re-queued at ``done``.  Without this, two workers of
    one controller can reconcile the SAME key concurrently and double-
    apply a transition (e.g. two restart_count bumps for one gang
    failure — the storm chaos testing surfaced, ISSUE 1)."""

    def __init__(self) -> None:
        self._lock = threading.Condition()
        self._heap: list[_QueueItem] = []
        #: key -> earliest scheduled fire time among queued entries; an add
        #: only dedups against an entry that would fire sooner-or-equal, so
        #: an immediate add always tightens a far-future TTL requeue
        #: (client-go Add vs AddAfter semantics).
        self._queued: dict[str, float] = {}
        #: keys currently held by a worker (get() .. done())
        self._processing: set[str] = set()
        #: key -> earliest re-add time requested while processing
        self._dirty: dict[str, float] = {}

    def add(self, key: str, delay: float = 0.0) -> None:
        at = time.time() + delay
        with self._lock:
            if key in self._processing:
                cur = self._dirty.get(key)
                if cur is None or at < cur:
                    self._dirty[key] = at
                return
            earliest = self._queued.get(key)
            if earliest is not None and earliest <= at:
                return
            heapq.heappush(self._heap, _QueueItem(at, key))
            self._queued[key] = at
            self._lock.notify()

    def get(self, timeout: float = 0.2) -> Optional[str]:
        with self._lock:
            deadline = time.time() + timeout
            while True:
                now = time.time()
                popped = None
                if self._heap and self._heap[0].at <= now:
                    popped = heapq.heappop(self._heap)
                    remaining = [it.at for it in self._heap if it.key == popped.key]
                    if remaining:
                        self._queued[popped.key] = min(remaining)
                    else:
                        self._queued.pop(popped.key, None)
                    if popped.key in self._processing:
                        # another worker holds this key: park it dirty
                        cur = self._dirty.get(popped.key)
                        if cur is None or popped.at < cur:
                            self._dirty[popped.key] = popped.at
                        continue
                    self._processing.add(popped.key)
                    return popped.key
                wait = min(
                    self._heap[0].at - now if self._heap else timeout,
                    deadline - now,
                )
                if wait <= 0:
                    return None
                self._lock.wait(wait)

    def done(self, key: str) -> None:
        """Worker finished ``key``: release it and re-queue any add that
        arrived while it was processing."""
        with self._lock:
            self._processing.discard(key)
            at = self._dirty.pop(key, None)
            if at is None:
                return
            earliest = self._queued.get(key)
            if earliest is not None and earliest <= at:
                return
            heapq.heappush(self._heap, _QueueItem(at, key))
            self._queued[key] = at
            self._lock.notify()

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


@dataclass
class Result:
    requeue_after: Optional[float] = None


class ReconcileMetrics:
    """Per-controller reconcile metrics, Prometheus text exposition.

    The controller-runtime metrics surface [upstream: controller-runtime ->
    pkg/internal/controller/metrics: controller_runtime_reconcile_total,
    _errors_total, _time_seconds, workqueue depth], which the reference
    operators export on ``--metrics-bind-address`` (SURVEY.md §5 tracing).
    """

    #: reconcile-duration histogram upper bounds (seconds)
    BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 2.5, 10.0)

    def __init__(self, controller: str) -> None:
        self.controller = controller
        self._lock = threading.Lock()
        self.total = 0
        self.errors = 0
        self.duration_sum = 0.0
        self.bucket_counts = [0] * (len(self.BUCKETS) + 1)  # +inf tail

    def observe(self, seconds: float, error: bool) -> None:
        with self._lock:
            self.total += 1
            if error:
                self.errors += 1
            self.duration_sum += seconds
            for i, ub in enumerate(self.BUCKETS):
                if seconds <= ub:
                    self.bucket_counts[i] += 1
                    break
            else:
                self.bucket_counts[-1] += 1

    def prometheus(self, queue_depth: int) -> str:
        lab = f'controller="{self.controller}"'
        with self._lock:
            lines = [
                f"kft_reconcile_total{{{lab}}} {self.total}",
                f"kft_reconcile_errors_total{{{lab}}} {self.errors}",
                f"kft_reconcile_time_seconds_sum{{{lab}}} {self.duration_sum:.6f}",
                f"kft_reconcile_time_seconds_count{{{lab}}} {self.total}",
            ]
            cum = 0
            for ub, c in zip(self.BUCKETS, self.bucket_counts):
                cum += c
                lines.append(
                    f'kft_reconcile_time_seconds_bucket{{{lab},le="{ub}"}} {cum}')
            cum += self.bucket_counts[-1]
            lines.append(
                f'kft_reconcile_time_seconds_bucket{{{lab},le="+Inf"}} {cum}')
        lines.append(f"kft_workqueue_depth{{{lab}}} {queue_depth}")
        return "\n".join(lines) + "\n"


class Controller:
    """Base reconciler.  Subclasses set ``kind``, ``owned_kinds`` and
    implement ``reconcile(namespace, name) -> Optional[Result]``."""

    kind: str = ""
    owned_kinds: tuple[str, ...] = ()
    workers: int = 1

    def __init__(self, store: Store) -> None:
        self.store = store
        self.queue = WorkQueue()
        self.metrics = ReconcileMetrics(self.kind or type(self).__name__)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._watch = None
        self._backoff: dict[str, float] = {}

    # -- event -> key mapping --------------------------------------------------

    def owner_key_for(self, obj: TypedObject) -> Optional[str]:
        """Map an owned object's event to its controller's key via
        owner_references (the ``Owns()`` handler)."""
        for ref in obj.metadata.owner_references:
            if ref.kind == self.kind and ref.controller:
                return f"{obj.metadata.namespace}/{ref.name}"
        return None

    def observe(self, ev: WatchEvent) -> None:
        """Hook for expectation accounting; called for every owned event."""

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        kinds = (self.kind, *self.owned_kinds)
        self._watch = self.store.watch(kinds)
        self._prime()
        t = threading.Thread(target=self._watch_loop, name=f"{self.kind}-watch", daemon=True)
        t.start()
        self._threads.append(t)
        for i in range(self.workers):
            t = threading.Thread(
                target=self._worker_loop, name=f"{self.kind}-worker-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self.store.stop_watch(self._watch)
        for t in self._threads:
            t.join(timeout=5)

    def _prime(self) -> None:
        """Informer initial list: enqueue every existing object of our
        kind, AND the owner key of every existing owned object — after a
        control-plane restart an owned pod whose job is gone must still
        trigger a reconcile (orphan cleanup), and one whose job survived
        must be adopted, even though neither produces a watch event."""
        for obj in self.store.list(self.kind):
            self.queue.add(obj.key)
        for kind in self.owned_kinds:
            for obj in self.store.list(kind):
                key = self.owner_key_for(obj)
                if key:
                    self.queue.add(key)

    def _resync(self) -> None:
        """The watch overflowed (TOO_OLD): events were dropped and the
        ONLY correct recovery is a fresh watch + full relist — never
        resuming as if nothing was missed.  New watch FIRST, then list,
        so nothing lands in the gap between the two."""
        kinds = (self.kind, *self.owned_kinds)
        self._watch = self.store.watch(kinds)
        self._prime()

    def _watch_loop(self) -> None:
        assert self._watch is not None
        while not self._stop.is_set():
            try:
                ev = self._watch.q.get(timeout=0.2)
            except queue.Empty:
                continue
            if ev.type == TOO_OLD:
                log.warning("%s watch fell behind; relisting", self.kind)
                self._resync()
                continue
            assert ev.obj is not None
            if ev.obj.kind == self.kind:
                self.queue.add(ev.obj.key)
            else:
                self.observe(ev)
                key = self.owner_key_for(ev.obj)
                if key:
                    self.queue.add(key)

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            key = self.queue.get(timeout=0.2)
            if key is None:
                continue
            ns, name = key.split("/", 1)
            t0 = time.perf_counter()
            try:
                res = self.reconcile(ns, name)
            except Exception:  # noqa: BLE001
                self.metrics.observe(time.perf_counter() - t0, error=True)
                log.exception("reconcile %s %s failed", self.kind, key)
                back = min(self._backoff.get(key, 0.05) * 2, 5.0)
                self._backoff[key] = back
                self.queue.done(key)
                self.queue.add(key, delay=back)
                continue
            self.metrics.observe(time.perf_counter() - t0, error=False)
            self._backoff.pop(key, None)
            # release BEFORE the requeue so the requeue lands in the heap,
            # not the dirty set (watch events that arrived mid-reconcile
            # are flushed by done() as well)
            self.queue.done(key)
            if res and res.requeue_after is not None:
                self.queue.add(key, delay=res.requeue_after)

    # -- to implement ----------------------------------------------------------

    def reconcile(self, namespace: str, name: str) -> Optional[Result]:
        raise NotImplementedError

    # -- events (kubectl describe UX) -----------------------------------------

    def emit_event(
        self, obj: TypedObject, reason: str, message: str, type_: str = "Normal"
    ) -> None:
        from ..api.common import ObjectMeta

        name = f"{obj.metadata.name}-{reason.lower()}-{int(time.time() * 1000) % 1_000_000}"
        try:
            self.store.create(
                Event(
                    metadata=ObjectMeta(name=name, namespace=obj.metadata.namespace),
                    involved_kind=obj.kind,
                    involved_name=obj.metadata.name,
                    reason=reason,
                    message=message,
                    type=type_,
                )
            )
        except Exception:  # noqa: BLE001 — events are best-effort
            pass


def events_for(store: Store, kind: str, name: str) -> list[Event]:
    return sorted(
        (
            e
            for e in store.list(KIND_EVENT)
            if isinstance(e, Event) and e.involved_kind == kind and e.involved_name == name
        ),
        key=lambda e: e.timestamp,
    )
