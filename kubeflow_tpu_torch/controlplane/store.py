"""In-process API server: typed object store with watches and admission.

The envtest analog from SURVEY.md §4: a real state store + watch semantics so
reconcilers run deterministically without Kubernetes.  Semantics kept from
the real API server because the reference's controllers depend on them:

- optimistic concurrency (``resource_version`` bump per write; stale updates
  raise ``Conflict``) — the races the reference's expectations cache exists
  to tame happen here too, on purpose;
- admission hooks per kind (mutating defaulting then validating), the webhook
  layer [upstream: training-operator -> pkg/webhooks/];
- watch streams with ADDED/MODIFIED/DELETED events fanned out to BOUNDED
  subscriber queues (the informer analog; an overflowed subscriber gets a
  TOO_OLD marker and must relist, kube-apiserver's 410 Gone contract);
- optional etcd-style durability: ``Store.open(data_dir)`` attaches a
  write-ahead log + snapshot (wal.py) so a control-plane kill -9 recovers
  every object and resumes the resourceVersion counter.

The port's copy of ``kubeflow_tpu/controlplane/store.py``, device-free
like it, with the same names; it imports nothing of the reference
package.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from ..api.common import TypedObject, object_key
from .wal import OP_DEL, OP_PUT, Wal, WalCrashPoint  # noqa: F401 (re-export)


class ApiError(Exception):
    pass


class NotFound(ApiError):
    pass


class AlreadyExists(ApiError):
    pass


class Conflict(ApiError):
    """resource_version mismatch — caller must re-read and retry."""


class Rejected(ApiError):
    """Admission (validating webhook) rejection."""


ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
#: Marker event closing an overflowed watch: the subscriber was too slow,
#: events were dropped, and the ONLY correct response is to re-watch and
#: relist (kube-apiserver's 410 Gone / client-go relist contract).  The
#: marker's ``obj`` is None.
TOO_OLD = "TOO_OLD"


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED | TOO_OLD
    obj: Optional[TypedObject]


@dataclass
class _Watch:
    kinds: frozenset[str]
    q: "queue.Queue[WatchEvent]" = field(default_factory=queue.Queue)
    closed: bool = False
    #: set when the watch was closed for falling behind (queue overflow)
    too_old: bool = False


MutatingHook = Callable[[TypedObject], TypedObject]
ValidatingHook = Callable[[TypedObject], None]


class Store:
    #: default per-watch queue bound — one slow watcher must not grow
    #: memory without limit; on overflow the watch closes with a TOO_OLD
    #: marker and the subscriber relists (never silently misses events)
    watch_maxsize: int = 4096

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._objs: dict[tuple[str, str], TypedObject] = {}  # (kind, ns/name)
        self._last_rv = 0
        self._watches: list[_Watch] = []
        self._mutators: dict[str, list[MutatingHook]] = {}
        self._validators: dict[str, list[ValidatingHook]] = {}
        #: durability (None = classic in-memory store)
        self._wal: Optional[Wal] = None

    def _next_rv(self) -> int:
        self._last_rv += 1
        return self._last_rv

    # -- durability ------------------------------------------------------------

    @classmethod
    def open(
        cls,
        data_dir: str,
        fsync_every: int = 64,
        fsync_interval_s: float = 0.05,
        snapshot_every: int = 1024,
        crashpoint: Optional[WalCrashPoint] = None,
    ) -> "Store":
        """Open (or create) a durable store at ``data_dir``: replay
        snapshot + WAL into memory, resume the ``resourceVersion``
        counter past everything recovered (so optimistic-concurrency
        semantics hold across restarts), and keep logging.

        Replay bypasses admission — every recovered object was admitted
        when it was first written."""
        # late import: yaml_io pulls in every api kind module; importing
        # objects registers the cluster-substrate kinds (Pod/Node/...)
        from ..api.yaml_io import from_dict
        from . import objects  # noqa: F401 — KIND_REGISTRY side effect

        store = cls()
        wal = Wal(data_dir, fsync_every=fsync_every,
                  fsync_interval_s=fsync_interval_s,
                  snapshot_every=snapshot_every, crashpoint=crashpoint)
        snap_rv, snap_objs, records = wal.recover()
        max_rv = snap_rv
        for d in snap_objs:
            obj = from_dict(d)
            store._objs[(obj.kind, obj.key)] = obj
            max_rv = max(max_rv, obj.metadata.resource_version)
        for rec in records:
            rv = int(rec["rv"])
            if rv <= snap_rv:
                # a crash between snapshot rename and log truncation
                # leaves already-snapshotted records behind — skip them
                continue
            if rec["op"] == OP_PUT:
                obj = from_dict(rec["obj"])
                store._objs[(obj.kind, obj.key)] = obj
            else:
                store._objs.pop(
                    (rec["kind"], object_key(rec["ns"], rec["name"])), None)
            max_rv = max(max_rv, rv)
        store._last_rv = max_rv
        store._wal = wal
        return store

    @property
    def wal(self) -> Optional[Wal]:
        return self._wal

    def close(self) -> None:
        """Flush and detach the WAL (no-op for in-memory stores)."""
        with self._lock:
            wal, self._wal = self._wal, None
        if wal is not None:
            wal.close()

    def _persist_put(self, obj: TypedObject) -> None:
        """Called under ``_lock`` after a successful create/update."""
        if self._wal is None:
            return
        from ..api.yaml_io import to_dict

        self._wal.append({"rv": obj.metadata.resource_version,
                          "op": OP_PUT, "obj": to_dict(obj)})
        self._maybe_snapshot()

    def _persist_del(self, kind: str, namespace: str, name: str) -> None:
        """Called under ``_lock`` after a successful delete.  Deletes
        draw their own rv so WAL replay order is total (etcd bumps its
        revision on delete for the same reason)."""
        if self._wal is None:
            return
        self._wal.append({"rv": self._next_rv(), "op": OP_DEL,
                          "kind": kind, "ns": namespace, "name": name})
        self._maybe_snapshot()

    def _maybe_snapshot(self) -> None:
        wal = self._wal
        if wal is None or wal.records_since_snapshot < wal.snapshot_every:
            return
        from ..api.yaml_io import to_dict

        # under _lock: the dump is consistent with every appended record
        wal.write_snapshot(
            self._last_rv, [to_dict(o) for o in self._objs.values()])

    # -- admission registration ------------------------------------------------

    def register_admission(
        self,
        kind: str,
        mutate: Optional[MutatingHook] = None,
        validate: Optional[ValidatingHook] = None,
    ) -> None:
        if mutate:
            self._mutators.setdefault(kind, []).append(mutate)
        if validate:
            self._validators.setdefault(kind, []).append(validate)

    def _admit(self, obj: TypedObject) -> TypedObject:
        for m in self._mutators.get(obj.kind, []):
            obj = m(obj) or obj
        for v in self._validators.get(obj.kind, []):
            try:
                v(obj)
            except Exception as e:  # noqa: BLE001 — admission wraps any failure
                raise Rejected(str(e)) from e
        return obj

    # -- CRUD ------------------------------------------------------------------

    def create(self, obj: TypedObject) -> TypedObject:
        obj = copy.deepcopy(obj)
        obj = self._admit(obj)
        with self._lock:
            k = (obj.kind, obj.key)
            if k in self._objs:
                raise AlreadyExists(f"{obj.kind} {obj.key} exists")
            obj.metadata.uid = obj.metadata.uid or uuid.uuid4().hex[:12]
            obj.metadata.resource_version = self._next_rv()
            obj.metadata.creation_timestamp = (
                obj.metadata.creation_timestamp or time.time()
            )
            self._objs[k] = obj
            self._persist_put(obj)
            self._notify(WatchEvent(ADDED, copy.deepcopy(obj)))
        return copy.deepcopy(obj)

    def get(self, kind: str, name: str, namespace: str = "default") -> TypedObject:
        with self._lock:
            k = (kind, object_key(namespace, name))
            if k not in self._objs:
                raise NotFound(f"{kind} {namespace}/{name}")
            return copy.deepcopy(self._objs[k])

    def try_get(self, kind: str, name: str, namespace: str = "default"):
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def update(self, obj: TypedObject) -> TypedObject:
        obj = copy.deepcopy(obj)
        obj = self._admit(obj)  # webhooks run on UPDATE too, like the real apiserver
        with self._lock:
            k = (obj.kind, obj.key)
            cur = self._objs.get(k)
            if cur is None:
                raise NotFound(f"{obj.kind} {obj.key}")
            if obj.metadata.resource_version != cur.metadata.resource_version:
                raise Conflict(
                    f"{obj.kind} {obj.key}: rv {obj.metadata.resource_version} "
                    f"!= {cur.metadata.resource_version}"
                )
            if obj == cur:
                # no-op write: like the real apiserver, don't bump the rv or
                # fire MODIFIED — otherwise every reconcile's unchanged
                # status write would requeue its own key in a hot loop
                return copy.deepcopy(cur)
            obj.metadata.resource_version = self._next_rv()
            self._objs[k] = obj
            self._persist_put(obj)
            self._notify(WatchEvent(MODIFIED, copy.deepcopy(obj)))
        return copy.deepcopy(obj)

    def update_with_retry(
        self, kind: str, name: str, namespace: str, fn: Callable[[TypedObject], None],
        attempts: int = 8,
    ) -> TypedObject:
        """Read-modify-write with conflict retry (client-go UpdateStatus idiom)."""
        last: Optional[Exception] = None
        for _ in range(attempts):
            obj = self.get(kind, name, namespace)
            fn(obj)
            try:
                return self.update(obj)
            except Conflict as e:
                last = e
        raise last  # type: ignore[misc]

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        with self._lock:
            k = (kind, object_key(namespace, name))
            obj = self._objs.pop(k, None)
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name}")
            self._persist_del(kind, namespace, name)
            self._notify(WatchEvent(DELETED, copy.deepcopy(obj)))

    def try_delete(self, kind: str, name: str, namespace: str = "default") -> bool:
        try:
            self.delete(kind, name, namespace)
            return True
        except NotFound:
            return False

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        labels: Optional[dict[str, str]] = None,
    ) -> list[TypedObject]:
        with self._lock:
            out = []
            for (k, _), obj in self._objs.items():
                if k != kind:
                    continue
                if namespace and obj.metadata.namespace != namespace:
                    continue
                if labels and any(
                    obj.metadata.labels.get(lk) != lv for lk, lv in labels.items()
                ):
                    continue
                out.append(copy.deepcopy(obj))
            return sorted(out, key=lambda o: o.metadata.name)

    # -- watches ---------------------------------------------------------------

    def watch(self, kinds: Iterable[str],
              maxsize: Optional[int] = None) -> "_Watch":
        w = _Watch(kinds=frozenset(kinds),
                   q=queue.Queue(maxsize=maxsize or self.watch_maxsize))
        with self._lock:
            self._watches.append(w)
        return w

    def stop_watch(self, w: "_Watch") -> None:
        with self._lock:
            w.closed = True
            if w in self._watches:
                self._watches.remove(w)

    def _notify(self, ev: WatchEvent) -> None:
        assert ev.obj is not None
        for w in list(self._watches):
            if w.closed or ev.obj.kind not in w.kinds:
                continue
            try:
                w.q.put_nowait(ev)
            except queue.Full:
                # slow subscriber: close the watch with a TOO_OLD marker
                # instead of growing without bound OR dropping silently —
                # the subscriber must re-watch + relist.  Evicting one
                # queued event guarantees room for the marker (this is
                # the only producer, under _lock).
                w.closed = True
                w.too_old = True
                self._watches.remove(w)
                try:
                    w.q.get_nowait()
                except queue.Empty:
                    pass
                w.q.put_nowait(WatchEvent(TOO_OLD, None))
