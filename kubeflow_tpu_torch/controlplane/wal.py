"""Write-ahead log + snapshot persistence for the object store.

The etcd analog (ISSUE 5 tentpole): every store mutation appends one
CRC-tagged JSONL record keyed by ``resourceVersion`` before it is
visible to watchers, so a control-plane kill -9 recovers to a
consistent recent state instead of total amnesia.  Recovery semantics
follow the etcd/raft-log playbook:

- **torn tail tolerated**: a record cut mid-write by the crash (bad
  CRC, truncated line, missing newline) at the very END of the log is
  dropped and the file truncated back to the last good record — that
  write was never acknowledged as durable;
- **mid-log corruption is fatal**: a bad CRC with valid records AFTER
  it means the medium lied, not that a write was interrupted; replay
  raises :class:`WalCorrupt` loudly rather than silently skipping
  committed history;
- **batched fsync**: appends buffer and fsync every ``fsync_every``
  records or ``fsync_interval_s`` seconds, whichever first — the
  durability window is bounded and explicit (records inside it are the
  ones a crash may lose);
- **snapshot + compaction**: every ``snapshot_every`` records the full
  object set is written to ``snapshot.json`` (tmp-file + fsync +
  atomic rename) and the log truncated; replay = snapshot + records
  with ``rv`` greater than the snapshot's.

The :class:`WalCrashPoint` seam is the chaos layer's kill switch
(:meth:`~kubeflow_tpu_torch.chaos.FaultPlan.control_plane_crash`): once
``after_records`` records have been appended, the WAL behaves like the
machine died at that exact offset — nothing later reaches disk, and at
most ``torn_bytes`` of the next record do (a torn tail for recovery to
chew on).  The in-process threads keep running until the harness tears
them down, exactly like in-flight work on a node that lost its API
server; none of it persists.

The port's copy of ``kubeflow_tpu/controlplane/wal.py``, device-free
like it, with the same names; it imports nothing of the reference
package.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Optional

log = logging.getLogger("kubeflow_tpu_torch.wal")

LOG_NAME = "wal.jsonl"
SNAP_NAME = "snapshot.json"

OP_PUT = "put"
OP_DEL = "del"


class WalError(Exception):
    pass


class WalCorrupt(WalError):
    """A record that is NOT the tail failed its CRC/format check —
    committed history is damaged and replay must not guess around it."""


@dataclass
class WalCrashPoint:
    """Simulated kill -9 at a WAL offset (see module docstring)."""

    after_records: int
    torn_bytes: int = 0
    fired: threading.Event = field(default_factory=threading.Event)


def _encode(payload: dict) -> bytes:
    body = json.dumps(payload, separators=(",", ":"), sort_keys=True)
    return f"{zlib.crc32(body.encode()):08x} {body}\n".encode()


def _decode(raw: bytes) -> Optional[dict]:
    """Parse one CRC-tagged record line (without newline); None if the
    bytes do not form a complete valid record."""
    try:
        text = raw.decode()
        crc_hex, _, body = text.partition(" ")
        if len(crc_hex) != 8 or not body:
            return None
        if int(crc_hex, 16) != zlib.crc32(body.encode()):
            return None
        rec = json.loads(body)
        return rec if isinstance(rec, dict) else None
    except (ValueError, UnicodeDecodeError):
        return None


class Wal:
    """Append-only JSONL log + snapshot for one :class:`Store`.

    Thread-safe; the store appends under its own lock, and the WAL's
    ``Wal._lock`` serializes the file write + batched fsync (the
    acquisition order is always ``Store._lock`` -> ``Wal._lock``; the
    WAL never calls back into the store)."""

    def __init__(
        self,
        data_dir: str,
        fsync_every: int = 64,
        fsync_interval_s: float = 0.05,
        snapshot_every: int = 1024,
        crashpoint: Optional[WalCrashPoint] = None,
    ) -> None:
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        self.log_path = os.path.join(data_dir, LOG_NAME)
        self.snap_path = os.path.join(data_dir, SNAP_NAME)
        self.fsync_every = max(1, fsync_every)
        self.fsync_interval_s = fsync_interval_s
        self.snapshot_every = max(1, snapshot_every)
        self.crashpoint = crashpoint
        self._lock = threading.Lock()
        self._f: Optional[Any] = None
        self._unsynced = 0
        self._last_fsync = time.monotonic()
        #: records appended since the last snapshot (compaction trigger)
        self.records_since_snapshot = 0
        #: records appended this incarnation (the crashpoint's clock)
        self.appended_records = 0
        #: the simulated machine death happened: drop every later write
        self.crashed = False
        self.closed = False

    # -- recovery ----------------------------------------------------------

    def recover(self) -> tuple[int, list[dict], list[dict]]:
        """Read snapshot + log, truncate a torn tail, open for append.

        Returns ``(snapshot_rv, snapshot_objs, records)`` where
        ``records`` are the valid log records (the caller filters to
        ``rv > snapshot_rv`` — a crash between snapshot rename and log
        truncation legitimately leaves older records behind)."""
        # a crash mid-snapshot leaves only the tmp file; the rename is
        # atomic, so snapshot.json is either the old complete one or the
        # new complete one — tmp leftovers are garbage
        tmp = self.snap_path + ".tmp"
        if os.path.exists(tmp):
            os.unlink(tmp)
        snap_rv, snap_objs = 0, []
        if os.path.exists(self.snap_path):
            with open(self.snap_path, encoding="utf-8") as f:
                try:
                    snap = json.load(f)
                except ValueError as e:
                    # snapshots are written atomically; a half snapshot
                    # cannot exist, so a bad one is real corruption
                    raise WalCorrupt(f"snapshot {self.snap_path}: {e}") from e
            snap_rv = int(snap.get("rv", 0))
            snap_objs = snap.get("objs", [])
        records = self._read_log()
        # the reopened log's backlog counts toward the next compaction —
        # otherwise a plane restarted every < snapshot_every writes never
        # snapshots and the log grows without bound across incarnations
        self.records_since_snapshot = len(records)
        self._open_for_append()
        return snap_rv, snap_objs, records

    def _read_log(self) -> list[dict]:
        if not os.path.exists(self.log_path):
            return []
        with open(self.log_path, "rb") as f:
            data = f.read()
        records: list[dict] = []
        offset = 0  # byte offset of the first unparsed record
        good_end = 0  # byte offset just past the last valid record
        while offset < len(data):
            nl = data.find(b"\n", offset)
            chunk = data[offset:nl] if nl >= 0 else data[offset:]
            rec = _decode(chunk) if nl >= 0 else None  # no newline = torn
            if rec is None:
                # bad record: tolerable ONLY as the file's tail (a write
                # the crash cut short was never acknowledged durable)
                rest = data[offset:] if nl < 0 else data[nl + 1:]
                if nl >= 0 and rest.strip(b"\n"):
                    raise WalCorrupt(
                        f"{self.log_path}: corrupt record at byte {offset} "
                        "with committed records after it")
                log.warning("wal %s: dropping torn tail record (%d bytes)",
                            self.log_path, len(data) - offset)
                with open(self.log_path, "r+b") as f:
                    f.truncate(good_end)
                    f.flush()
                    os.fsync(f.fileno())
                break
            records.append(rec)
            offset = nl + 1
            good_end = offset
        return records

    def _open_for_append(self) -> None:
        # append-only log: a torn tail is the DESIGNED crash artifact —
        # replay() truncates to the last newline-complete record (the
        # repair path the chaos tests pin)
        # analysis: ok torn-write — torn tail repaired on replay
        self._f = open(self.log_path, "ab")

    # -- append path -------------------------------------------------------

    def append(self, payload: dict) -> None:
        """Append one record; fsync per the batch policy.  After a
        simulated crash this silently drops writes (the process is
        'dead'; its survivors stop at teardown)."""
        line = _encode(payload)
        with self._lock:
            if self.crashed or self.closed or self._f is None:
                return
            cp = self.crashpoint
            if cp is not None and self.appended_records >= cp.after_records:
                # the machine dies HERE: at most torn_bytes of this
                # record reach the platter, nothing ever again — clamped
                # below the record length, or a generous torn_bytes would
                # persist the COMPLETE record the model says died in flight
                if cp.torn_bytes > 0:
                    self._f.write(line[: min(cp.torn_bytes, len(line) - 1)])
                    self._f.flush()
                    os.fsync(self._f.fileno())
                self.crashed = True
                cp.fired.set()
                return
            self._f.write(line)
            self.appended_records += 1
            self.records_since_snapshot += 1
            self._unsynced += 1
            now = time.monotonic()
            if (self._unsynced >= self.fsync_every
                    or now - self._last_fsync >= self.fsync_interval_s):
                # the batched fsync under the append lock IS the
                # durability contract: no writer may observe an append
                # as accepted before its batch boundary is on disk
                # analysis: ok lock-blocking-call — batched-fsync contract
                self._fsync_locked(now)

    def _fsync_locked(self, now: Optional[float] = None) -> None:
        assert self._f is not None
        self._f.flush()
        os.fsync(self._f.fileno())
        self._unsynced = 0
        self._last_fsync = time.monotonic() if now is None else now

    def sync(self) -> None:
        """Force the batched fsync (clean shutdown / test determinism)."""
        with self._lock:
            if self._f is not None and not self.crashed and self._unsynced:
                # analysis: ok lock-blocking-call — forced flush of the batched-fsync contract
                self._fsync_locked()

    # -- snapshot + compaction ---------------------------------------------

    def write_snapshot(self, rv: int, objs: list[dict]) -> None:
        """Write the full object set and truncate the log.  The caller
        (the store, under its lock) guarantees ``objs`` is consistent
        with every record appended so far."""
        with self._lock:
            if self.crashed or self.closed or self._f is None:
                return
            tmp = self.snap_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"rv": rv, "objs": objs}, f,
                          separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            # log truncation AFTER the snapshot is durable: a crash
            # between the two leaves snapshot + stale records, which
            # replay filters by rv
            self._f.close()
            # analysis: ok torn-write — truncate after durable snapshot; replay filters stale records by rv
            self._f = open(self.log_path, "wb")
            self._unsynced = 0
            self.records_since_snapshot = 0

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            self.closed = True
            if self._f is None:
                return
            if not self.crashed:
                self._f.flush()
                os.fsync(self._f.fileno())
            self._f.close()
            self._f = None
