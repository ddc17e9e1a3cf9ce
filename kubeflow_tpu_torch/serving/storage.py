"""The storage tier of the paged-KV economy: the port's copy of the spill
store of ``kubeflow_tpu/serving/storage.py`` (``KvSpillStore`` and the
helpers it needs; the model-download half of that module stays there).

The manifest schema is the reference's, byte for byte, so a spill either
framework writes is readable by the other. The one change: the reference
resolves a leaf dtype such as ``"bfloat16"`` through ``ml_dtypes``, which
the port does not have. Here leaves are torch CPU tensors (numpy arrays are
taken too) and a payload is read back through a byte view into the
recorded torch dtype, so bfloat16 leaves round-trip without ``ml_dtypes``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import uuid
from typing import Optional

import numpy as np
import torch


class StorageError(RuntimeError):
    pass


class SpillCorrupt(StorageError):
    """A spill entry's MANIFEST is unreadable or self-inconsistent: the
    session cannot be reconstructed from this tier (payload corruption
    is softer: the manifest's token record still re-prefills)."""


SPILL_MANIFEST = "spill.json"

#: a staging dir untouched this long is presumed orphaned by a dead stager
STAGING_STALE_SECONDS = 3600.0


def _stale_staging_dirs(cache_dir: str, key: str) -> list[str]:
    """Staging dirs for ``key`` old enough to be crash leftovers; live
    concurrent stagers are younger than this and must not be deleted."""
    out = []
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return out
    prefix = f".staging-{key}-"
    now = time.time()
    for n in names:
        if not n.startswith(prefix):
            continue
        p = os.path.join(cache_dir, n)
        try:
            if now - os.path.getmtime(p) > STAGING_STALE_SECONDS:
                out.append(p)
        except OSError:
            continue
    return out


def _host_tensor(x) -> torch.Tensor:
    """A leaf as a contiguous torch CPU tensor (numpy arrays by view)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.detach().cpu().contiguous()


def _dtype_name(x) -> str:
    """The manifest's dtype string: numpy's name (``"float32"``,
    ``"int8"``, and ``"bfloat16"`` as ``ml_dtypes`` spells it)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _spill_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise SpillCorrupt(f"spill leaf dtype {name!r} is not a torch dtype")
    return dt


def _pack_spill_leaves(leaves) -> bytes:
    return b"".join(_host_tensor(x).reshape(-1).view(torch.uint8)
                    .numpy().tobytes() for x in leaves)


def _unpack_spill_leaves(payload: bytes, specs: list) -> list:
    out, off = [], 0
    for s in specs:
        dt = _spill_dtype(s["dtype"])
        n = int(np.prod(s["shape"], dtype=np.int64)) * torch.empty(
            0, dtype=dt).element_size()
        raw = np.frombuffer(payload[off:off + n], dtype=np.uint8).copy()
        if raw.size != n:
            raise SpillCorrupt(
                f"spill payload {len(payload)}B shorter than its leaf specs")
        out.append(torch.from_numpy(raw).view(dt).reshape(s["shape"]))
        off += n
    if off != len(payload):
        raise SpillCorrupt(
            f"spill payload {len(payload)}B != leaf specs {off}B")
    return out


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platforms without dir-fd fsync: rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class KvSpillStore:
    """Manifest-verified storage tier for hibernated sessions, copied from
    the reference.

    The spill format is the ``export_sequence`` snapshot: scheduler meta
    (tokens, position, budget, sampling knobs) in a JSON manifest, block
    leaf bytes and the next-token logits row in packed binary payloads.

    - WRITE: everything lands in a hidden ``.staging-`` dir (payloads
      fsync'd, then the manifest, then the dir), published by one atomic
      ``rename``. A writer that dies mid-spill leaves a stale staging dir
      (collected later) and no entry: the source engine still owns the
      sequence and resumes in place.
    - READ: the manifest records every payload file's size and sha256 and
      the sequence's chained ``paged.block_keys``. A torn or corrupted
      payload is detected at thaw, and the caller re-prefills from the
      manifest's token record instead of serving wrong KV
      (``verify_failures_total``). An unreadable manifest raises
      :class:`SpillCorrupt`.

    ``chaos`` is an optional object with the reference ``FaultPlan``'s
    ``due_spill_kills``/``due_spill_torn``/``due_tier_stalls``, polled at
    the matching phase boundaries. All I/O runs on the hibernating
    caller's thread, never on an engine's scheduler thread.
    """

    def __init__(self, root: str, *, fsync: bool = True, chaos=None):
        self.root = root
        self.fsync = bool(fsync)
        self.chaos = chaos
        os.makedirs(root, exist_ok=True)
        #: one store serves every engine behind a runtime, and hibernations
        #: run on any caller thread: counters are locked, and a write's
        #: chaos kill set lives in its locals
        self._mu = threading.Lock()
        self.writes_total = 0
        self.reads_total = 0
        self.verify_failures_total = 0

    # -- chaos seams -------------------------------------------------------

    def _stall(self) -> None:
        if self.chaos is not None:
            for s in self.chaos.due_tier_stalls():
                time.sleep(s)

    @staticmethod
    def _maybe_kill(phase: str, due: set) -> None:
        if phase in due:
            raise StorageError(f"chaos: spill writer killed mid-{phase}")

    # -- paths -------------------------------------------------------------

    def _entry_dir(self, session_id: str) -> str:
        key = hashlib.sha256(session_id.encode()).hexdigest()[:24]
        return os.path.join(self.root, key)

    def sessions(self) -> list[str]:
        """Session ids of every published spill entry."""
        out = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for name in names:
            if name.startswith("."):
                continue
            mpath = os.path.join(self.root, name, SPILL_MANIFEST)
            try:
                with open(mpath) as f:
                    out.append(json.load(f)["session"])
            except (OSError, json.JSONDecodeError, KeyError):
                continue
        return out

    def contains(self, session_id: str) -> bool:
        return os.path.exists(
            os.path.join(self._entry_dir(session_id), SPILL_MANIFEST))

    def session_count(self) -> int:
        """Published entries (a dir scan: the ``kv_sessions_hibernated``
        gauge)."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return 0
        return sum(
            1 for name in names
            if not name.startswith(".") and os.path.exists(
                os.path.join(self.root, name, SPILL_MANIFEST)))

    # -- write (spill) -----------------------------------------------------

    def _write_file(self, path: str, data: bytes) -> dict:
        with open(path, "wb") as f:
            f.write(data)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        return {"path": os.path.basename(path), "size": len(data),
                "sha256": hashlib.sha256(data).hexdigest()}

    def write(self, session_id: str, snapshot: dict,
              block_keys: Optional[list] = None) -> str:
        """Persist one exported snapshot atomically; returns the entry
        dir. Overwrites an existing entry for the session (the newest
        hibernation wins; the old entry is removed only after the new one
        is published)."""
        self._stall()
        due = set(self.chaos.due_spill_kills()) if self.chaos else set()
        entry_dir = self._entry_dir(session_id)
        key = os.path.basename(entry_dir)
        for leftover in _stale_staging_dirs(self.root, key):
            shutil.rmtree(leftover, ignore_errors=True)
        # a crash between the two publish renames below leaves the
        # superseded copy under a hidden ``.old-<key>-`` name: garbage
        try:
            for name in os.listdir(self.root):
                if name.startswith(f".old-{key}-"):
                    shutil.rmtree(os.path.join(self.root, name),
                                  ignore_errors=True)
        except OSError:
            pass
        tmp_dir = os.path.join(
            self.root, f".staging-{key}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp_dir)
        # a chaos kill (or a real I/O error) publishes nothing; the
        # staging dir stays for the stale collection, as a kill -9 would
        # leave it
        blocks = snapshot.get("blocks", [])
        logits = snapshot.get("logits")
        leaves = ([{"dtype": _dtype_name(x), "shape": list(x.shape)}
                   for x in blocks[0]] if blocks else [])
        files = [self._write_file(
            os.path.join(tmp_dir, "blocks.bin"),
            b"".join(_pack_spill_leaves(blk) for blk in blocks))]
        self._maybe_kill("payload", due)
        logits_spec = None
        if logits is not None:
            logits_spec = {"dtype": _dtype_name(logits),
                           "shape": list(logits.shape)}
            files.append(self._write_file(
                os.path.join(tmp_dir, "logits.bin"),
                _pack_spill_leaves([logits])))
        meta = {k: v for k, v in snapshot.items()
                if k not in ("blocks", "logits", "blocks_dev",
                             "logits_dev")}
        manifest = {
            "session": session_id, "created": time.time(),
            "meta": meta, "leaves": leaves, "nblocks": len(blocks),
            "logits": logits_spec,
            #: chained content keys (paged.block_keys): the cluster-scope
            #: content index of this spill
            "block_keys": [int(k) for k in (block_keys or [])],
            "files": files,
        }
        with open(os.path.join(tmp_dir, SPILL_MANIFEST), "w") as f:
            json.dump(manifest, f)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        self._maybe_kill("meta", due)
        if self.fsync:
            _fsync_dir(tmp_dir)
        self._maybe_kill("publish", due)
        old = None
        if os.path.exists(entry_dir):
            # move the old entry to a hidden name (listings skip dotted
            # dirs), then rename the staged copy in
            old = os.path.join(self.root, f".old-{key}-{uuid.uuid4().hex[:8]}")
            os.rename(entry_dir, old)
        os.rename(tmp_dir, entry_dir)
        if self.fsync:
            _fsync_dir(self.root)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        with self._mu:
            self.writes_total += 1
        if self.chaos is not None:
            for torn in self.chaos.due_spill_torn():
                self._tear(entry_dir, torn)
        return entry_dir

    @staticmethod
    def _tear(entry_dir: str, torn_bytes: int) -> None:
        """Chaos actuator: drop the last ``torn_bytes`` of the payload (a
        torn write: the manifest survives, the hash check must catch
        it)."""
        p = os.path.join(entry_dir, "blocks.bin")
        try:
            size = os.path.getsize(p)
            with open(p, "r+b") as f:
                f.truncate(max(size - max(int(torn_bytes), 1), 0))
        except OSError:
            pass

    # -- read (thaw) -------------------------------------------------------

    def read(self, session_id: str) -> tuple[dict, bool]:
        """(snapshot, payload_ok) for a hibernated session.

        The snapshot always carries the manifest's scheduler meta, enough
        to re-prefill the session from tokens. ``payload_ok`` is True only
        when every payload file matched its recorded size and sha256; then
        (and only then) ``blocks``/``logits`` are attached, as torch CPU
        tensors. Raises :class:`SpillCorrupt` when the manifest itself is
        missing or unreadable."""
        self._stall()
        entry_dir = self._entry_dir(session_id)
        mpath = os.path.join(entry_dir, SPILL_MANIFEST)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            meta = dict(manifest["meta"])
            nblocks = int(manifest["nblocks"])
            specs = list(manifest["leaves"])
        except (OSError, json.JSONDecodeError, KeyError, TypeError,
                ValueError) as e:
            raise SpillCorrupt(
                f"session {session_id!r}: spill manifest unreadable: "
                f"{e}") from e
        with self._mu:
            self.reads_total += 1
        snapshot = dict(meta)
        ok = True
        payloads: dict[str, bytes] = {}
        for rec in manifest.get("files", []):
            try:
                with open(os.path.join(entry_dir, rec["path"]), "rb") as f:
                    data = f.read()
            except OSError:
                ok = False
                break
            if len(data) != int(rec["size"]) or (
                    hashlib.sha256(data).hexdigest() != rec["sha256"]):
                ok = False
                break
            payloads[rec["path"]] = data
        if ok:
            try:
                per_block = _unpack_spill_leaves(
                    payloads.get("blocks.bin", b""),
                    [s for _ in range(nblocks) for s in specs])
                step = len(specs)
                snapshot["blocks"] = [per_block[i * step:(i + 1) * step]
                                      for i in range(nblocks)]
                if manifest.get("logits") is not None:
                    snapshot["logits"] = _unpack_spill_leaves(
                        payloads.get("logits.bin", b""),
                        [manifest["logits"]])[0]
            except SpillCorrupt:
                ok = False
                snapshot.pop("blocks", None)
                snapshot.pop("logits", None)
        if not ok:
            with self._mu:
                self.verify_failures_total += 1
        return snapshot, ok

    def read_manifest(self, session_id: str) -> dict:
        """The raw manifest (block_keys index, file records)."""
        mpath = os.path.join(self._entry_dir(session_id), SPILL_MANIFEST)
        try:
            with open(mpath) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise SpillCorrupt(
                f"session {session_id!r}: spill manifest unreadable: "
                f"{e}") from e

    def delete(self, session_id: str) -> None:
        shutil.rmtree(self._entry_dir(session_id), ignore_errors=True)

    def stats(self) -> dict:
        return {
            "kv_spill_writes_total": self.writes_total,
            "kv_spill_reads_total": self.reads_total,
            "kv_spill_verify_failures_total": self.verify_failures_total,
        }
