"""The program-artifact cache: the port of ``kubeflow_tpu/serving/programs.py``.

Cold start, scale from zero and a gang's resize each boot an engine whose
program ladder some other replica (or the same one, a boot ago) already
warmed. In the reference a warm boot loads serialized XLA executables from
a shared root instead of compiling them. Here the engine's programs are
CUDA graphs, and a CUDA graph cannot be written to disk, so a warm boot
still captures every program; what the cache carries is:

``ProgramArtifactCache``
    The reference's verified on-disk store, copied as it is: entries are
    published with the manifest-verified atomic protocol of
    :mod:`.storage`'s spill tier (payload fsync, manifest with size and
    sha256 fsync, staging-dir fsync, one ``os.rename``), so a reader sees a
    whole, checksummed entry or nothing. A torn or corrupt entry is
    detected, counted, deleted and reported as a miss, never a crash.
    Replicas share one root.

Program records
    Each program of the warmed ladder publishes a record (JSON): its key,
    its input spec (names, shapes, kinds), its output's shape and dtype and
    the kernel launches one replay makes, per counter. While an engine
    warms (its capture counter unarmed), a fresh program's capture is
    checked against its record: equal is a hit; no entry is a miss and
    publishes; a record that does not match (or a torn one) counts a load
    failure, is replaced from this capture and counts a miss. Once the
    counter is armed the engine never consults the cache, so no artifact
    I/O runs on the scheduler thread (``continuous.py`` ``_Dispatch``).

Kernel libraries
    The counterpart of the Mosaic kernels inside the reference's
    executables: ``ops/_build.py`` takes each ``nvcc`` library from its
    verified entry (checked before ``ctypes.CDLL``, no compiler run) and
    builds and publishes it on a miss.

Greedy streams are bitwise equal with the cache on and off: a record
decides nothing about what runs, only whether the fresh capture is the one
a previous boot published.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Optional

ARTIFACT_MANIFEST = "artifact.json"
PAYLOAD_NAME = "program.bin"

#: staging dirs older than this are presumed orphaned by a crashed
#: publisher and are swept before the next publish of the same key
STAGING_STALE_SECONDS = 3600.0


def _fsync_dir(path: str) -> None:
    """Fsync a directory so the rename that published an entry is
    durable; degrades to a no-op on platforms without dir-fd fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _dtype_name(x: Any) -> str:
    """``float32`` for a torch tensor, a numpy array or a dtype alike."""
    dt = getattr(x, "dtype", None)
    if dt is None:
        return type(x).__name__
    return getattr(dt, "name", None) or str(dt).removeprefix("torch.")


def _state_dict(module_or_state_dict: Any) -> dict:
    if hasattr(module_or_state_dict, "state_dict"):
        return module_or_state_dict.state_dict()
    return dict(module_or_state_dict)


def model_fingerprint(cfg: Any, module_or_state_dict: Any) -> str:
    """Structural fingerprint of (model config, state dict).

    Hashes the config record plus each state-dict entry's name, shape and
    dtype, NOT the weight values: two checkpoints of one architecture share
    one program ladder, since weights are a program's inputs, not part of
    what was captured. A ``Llama`` module and a state dict for it (the
    port's own or one converted from the reference) fingerprint alike.
    """
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        rec = dataclasses.asdict(cfg)
    else:
        rec = {k: v for k, v in sorted(vars(cfg).items())
               if not k.startswith("_")}
    h = hashlib.sha256()
    h.update(json.dumps(rec, sort_keys=True, default=str).encode())
    for name, x in sorted(_state_dict(module_or_state_dict).items()):
        h.update(name.encode())
        h.update(str(tuple(int(n) for n in getattr(x, "shape", ()))).encode())
        h.update(_dtype_name(x).encode())
    return h.hexdigest()[:16]


def _device_of(module_or_state_dict: Any) -> str:
    """``cpu``, or the card's name and compute capability."""
    import torch

    dev = None
    for x in _state_dict(module_or_state_dict).values():
        if isinstance(x, torch.Tensor):
            dev = x.device
            break
    if dev is None or dev.type != "cuda":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(dev)
    return f"{torch.cuda.get_device_name(dev)} sm_{major}{minor}"


def cache_key_base(cfg: Any, params: Any, mesh_axes: Optional[dict] = None,
                   **knobs: Any) -> str:
    """The per-engine half of a record's key: model fingerprint, mesh
    degree ("1" unsharded), torch and CUDA versions, the device the params
    live on, and the program-shaping engine knobs (decode chunk, prefill
    budget, spec depth, block size, ...). The per-program half, family and
    signature, is appended by :meth:`ProgramArtifactCache.entry_key`."""
    import torch

    axes = {k: int(v) for k, v in (mesh_axes or {}).items() if int(v) > 1}
    degree = "x".join(f"{k}{v}" for k, v in sorted(axes.items())) or "1"
    knob_s = ",".join(f"{k}={knobs[k]}" for k in sorted(knobs))
    return "|".join([
        model_fingerprint(cfg, params), degree, torch.__version__,
        str(torch.version.cuda), _device_of(params), knob_s,
    ])


class ProgramArtifactCache:
    """Verified on-disk store of program records and kernel libraries.

    Publish protocol (the :mod:`.storage` idiom): write payload +
    fsync, write a manifest recording size and sha256 + fsync, fsync
    the staging dir, then a single atomic ``os.rename`` into place.
    Concurrent publishers of one key race on the rename; the loser
    verifies the winner's entry instead of clobbering it.  ``load``
    verifies size and sha256 against the manifest before returning
    bytes — a torn or corrupt entry is deleted and reported as a miss.
    """

    def __init__(self, root: str, *, fsync: bool = True,
                 chaos: Any = None):
        self.root = str(root)
        self.fsync = bool(fsync)
        self.chaos = chaos
        self._mu = threading.Lock()
        # bare += across threads loses increments; every counter bump
        # takes the lock
        self._hits = 0
        self._misses = 0
        self._load_failures = 0
        self._published = 0
        self._bytes_read = 0
        self._bytes_written = 0

    # -- key / path helpers -------------------------------------------

    @staticmethod
    def entry_key(base: str, family: str, sig: str) -> str:
        h = hashlib.sha256()
        h.update(base.encode())
        h.update(b"|")
        h.update(family.encode())
        h.update(b"|")
        h.update(sig.encode())
        return h.hexdigest()[:32]

    def _entry_dir(self, key: str) -> str:
        return os.path.join(self.root, key)

    # -- counters -----------------------------------------------------

    def _bump(self, attr: str, n: int = 1) -> None:
        with self._mu:
            setattr(self, attr, getattr(self, attr) + n)

    def note_hit(self) -> None:
        self._bump("_hits")

    def note_miss(self) -> None:
        self._bump("_misses")

    def note_load_failure(self) -> None:
        self._bump("_load_failures")

    # -- load ---------------------------------------------------------

    def load(self, key: str) -> Optional[bytes]:
        """Bytes of a verified entry, or None.

        Counts load failures (and deletes the offending entry so a
        later publish can replace it) but NOT hits/misses — the caller
        still has to check what it read, which can independently fail.
        """
        entry_dir = self._entry_dir(key)
        man_path = os.path.join(entry_dir, ARTIFACT_MANIFEST)
        if not os.path.exists(man_path):
            return None
        try:
            with open(man_path, "r", encoding="utf-8") as f:
                manifest = json.load(f)
            rec = manifest["files"][PAYLOAD_NAME]
            path = os.path.join(entry_dir, PAYLOAD_NAME)
            with open(path, "rb") as f:
                blob = f.read()
            if len(blob) != int(rec["size"]):
                raise ValueError(
                    f"torn payload: {len(blob)} != {rec['size']}")
            if hashlib.sha256(blob).hexdigest() != rec["sha256"]:
                raise ValueError("payload checksum mismatch")
        except Exception:  # analysis: ok swallowed-exception — counted in aot_cache_load_failures_total; any defect here degrades to a capture (or a build) by contract
            # corrupt/torn entry: detected, counted, removed — the
            # caller degrades to a miss, never a crash
            self.note_load_failure()
            shutil.rmtree(entry_dir, ignore_errors=True)
            return None
        self._bump("_bytes_read", len(blob))
        return blob

    def invalidate(self, key: str) -> None:
        """Drop an entry that verified on disk but failed downstream
        (a record that does not match this boot's capture) so the next
        publish can replace it."""
        shutil.rmtree(self._entry_dir(key), ignore_errors=True)

    def verify(self, key: str) -> bool:
        """True iff the entry exists and passes manifest verification
        (reads the payload; used by publish losers and tests)."""
        entry_dir = self._entry_dir(key)
        man_path = os.path.join(entry_dir, ARTIFACT_MANIFEST)
        if not os.path.exists(man_path):
            return False
        try:
            with open(man_path, "r", encoding="utf-8") as f:
                manifest = json.load(f)
            rec = manifest["files"][PAYLOAD_NAME]
            path = os.path.join(entry_dir, PAYLOAD_NAME)
            if os.path.getsize(path) != int(rec["size"]):
                return False
            return _sha256_file(path) == rec["sha256"]
        except Exception:  # analysis: ok swallowed-exception — verify() IS the failure probe; any unreadable/torn state simply verifies False
            return False

    # -- publish ------------------------------------------------------

    def _sweep_stale_staging(self, key: str) -> None:
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        prefix = f".staging-{key}-"
        now = time.time()
        for name in names:
            if not name.startswith(prefix):
                continue
            path = os.path.join(self.root, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue
            if age > STAGING_STALE_SECONDS:
                shutil.rmtree(path, ignore_errors=True)

    def publish(self, key: str, payload: bytes,
                meta: Optional[dict] = None) -> bool:
        """Atomically publish ``payload`` under ``key``.

        Returns True if this call installed (or verified an already-
        installed) entry.  Crash-safe: a reader never observes a
        partially-written entry because the rename is the only step
        that makes it visible, and everything renamed was fsync'd.
        """
        entry_dir = self._entry_dir(key)
        if os.path.exists(os.path.join(entry_dir, ARTIFACT_MANIFEST)):
            return True
        os.makedirs(self.root, exist_ok=True)
        self._sweep_stale_staging(key)
        tmp_dir = os.path.join(
            self.root,
            f".staging-{key}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp_dir)
        try:
            path = os.path.join(tmp_dir, PAYLOAD_NAME)
            with open(path, "wb") as f:
                f.write(payload)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            manifest = {
                "key": key,
                "files": {PAYLOAD_NAME: {
                    "size": len(payload),
                    "sha256": hashlib.sha256(payload).hexdigest(),
                }},
                "meta": dict(meta or {}),
            }
            man_path = os.path.join(tmp_dir, ARTIFACT_MANIFEST)
            with open(man_path, "w", encoding="utf-8") as f:
                json.dump(manifest, f)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            if self.fsync:
                _fsync_dir(tmp_dir)
            try:
                os.rename(tmp_dir, entry_dir)
            except OSError:
                # lost the publish race: verify the winner instead of
                # clobbering a good entry with our duplicate
                shutil.rmtree(tmp_dir, ignore_errors=True)
                return self.verify(key)
            if self.fsync:
                _fsync_dir(self.root)
        except Exception:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        self._bump("_published")
        self._bump("_bytes_written", len(payload))
        if self.chaos is not None:
            # fault-plan seam: tear the tail off a just-published
            # artifact so tier-1 proves torn entries degrade to a
            # miss (mirrors KvSpillStore's spill_torn seam)
            for torn in self.chaos.due_spill_torn():
                self._tear(entry_dir, torn)
        return True

    @staticmethod
    def _tear(entry_dir: str, torn_bytes: Optional[int]) -> None:
        path = os.path.join(entry_dir, PAYLOAD_NAME)
        try:
            size = os.path.getsize(path)
            cut = torn_bytes if torn_bytes is not None else max(
                1, size // 2)
            with open(path, "r+b") as f:
                f.truncate(max(0, size - cut))
        except OSError:
            pass

    # -- stats --------------------------------------------------------

    def entries(self) -> list:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n for n in names if not n.startswith("."))

    def stats(self) -> dict:
        entries = self.entries()
        nbytes = 0
        for name in entries:
            path = os.path.join(self.root, name, PAYLOAD_NAME)
            try:
                nbytes += os.path.getsize(path)
            except OSError:
                pass
        with self._mu:
            return {
                "aot_cache_hits_total": self._hits,
                "aot_cache_misses_total": self._misses,
                "aot_cache_load_failures_total": self._load_failures,
                "aot_cache_published_total": self._published,
                "aot_cache_bytes_read_total": self._bytes_read,
                "aot_cache_bytes_written_total": self._bytes_written,
                "aot_cache_entries": len(entries),
                "aot_cache_bytes": nbytes,
            }


#: the zeros ``stats()`` reports for an engine without a cache, so
#: dashboards never see a hole
EMPTY_STATS = {
    "aot_cache_hits_total": 0,
    "aot_cache_misses_total": 0,
    "aot_cache_load_failures_total": 0,
    "aot_cache_published_total": 0,
    "aot_cache_bytes_read_total": 0,
    "aot_cache_bytes_written_total": 0,
    "aot_cache_entries": 0,
    "aot_cache_bytes": 0,
}


# -- program records ----------------------------------------------------


def _out_spec(out: Any) -> Any:
    """A program output's shape and dtype (None for no output; a list for
    a tuple of outputs)."""
    if out is None:
        return None
    if isinstance(out, (tuple, list)):
        return [_out_spec(x) for x in out]
    return {"shape": [int(n) for n in out.shape], "dtype": _dtype_name(out)}


def program_record(key: tuple, spec: dict, out: Any,
                   launches: list) -> dict:
    """The record of one program: its key, its input spec (name ->
    (shape, kind)), its output's shape and dtype, and the kernel launches
    one run makes, per launch counter. JSON-shaped, so a record read back
    compares equal to a fresh one."""
    return json.loads(json.dumps({
        "key": [str(k) for k in key],
        "inputs": {n: [[int(d) for d in shape], kind]
                   for n, (shape, kind) in spec.items()},
        "output": _out_spec(out),
        "launches": [dict(sorted(c.items())) for c in launches],
    }, sort_keys=True))


def check_record(cache: ProgramArtifactCache, key_base: str, family: str,
                 sig: str, record: dict) -> str:
    """Hold a fresh program's ``record`` against the cache's: ``"hit"``
    when the stored record verifies and equals it; else ``"miss"``, and
    this record is published. A stored record that does not match (or
    cannot be parsed) counts a load failure and is replaced, as a torn
    one is (``load`` counts and deletes that)."""
    key = cache.entry_key(key_base, family, sig)
    blob = cache.load(key)
    if blob is not None:
        try:
            stored = json.loads(blob)
        except ValueError:
            stored = None
        if stored == record:
            cache.note_hit()
            return "hit"
        cache.note_load_failure()
        cache.invalidate(key)
    cache.note_miss()
    cache.publish(key, json.dumps(record, sort_keys=True).encode(),
                  meta={"family": family})
    return "miss"


# -- conf-freeze validation + construction ----------------------------

_AOT_KEYS = ("root", "fsync")


def validate_aot(spec: Any) -> None:
    """Conf-freeze validation of the ``aot:`` knob family — raises
    ``ValueError`` listing every problem so the controller reports ONE
    Failed status per bad freeze."""
    if not isinstance(spec, dict):
        raise ValueError(
            f"aot must be a mapping, got {type(spec).__name__}")
    problems = []
    unknown = sorted(set(spec) - set(_AOT_KEYS))
    if unknown:
        problems.append(
            f"unknown aot keys {unknown} (known: {list(_AOT_KEYS)})")
    root = spec.get("root")
    if not isinstance(root, str) or not root.strip():
        problems.append("aot.root must be a non-empty path string")
    fsync = spec.get("fsync", True)
    if not isinstance(fsync, bool):
        problems.append(
            f"aot.fsync must be a bool, got {type(fsync).__name__}")
    if problems:
        raise ValueError("; ".join(problems))


def build_program_cache(config: Optional[dict]):
    """The single construction seam: a validated
    :class:`ProgramArtifactCache` from a serving config's ``aot:``
    block, or None when the block is absent.  Kept OUT of
    ``engine_kwargs`` so config validation stays side-effect-free."""
    spec = (config or {}).get("aot")
    if not spec:
        return None
    validate_aot(spec)
    return ProgramArtifactCache(
        spec["root"], fsync=spec.get("fsync", True))
