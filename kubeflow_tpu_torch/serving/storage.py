"""The port's copy of ``kubeflow_tpu/serving/storage.py``: the storage
initializer (``download(uri) -> local path`` over ``file://``, ``mem://``,
``hf://org/name[@rev]`` resolved against a local hub layout under
``$KFT_HF_HOME``, and ``gs://``/``s3://`` through a registered transport, with
the manifest-verified local model cache) and the storage tier of the
paged-KV economy (``KvSpillStore``). All of it is device-free; nothing here
reaches the network unless a deployment registers a transport or sets
``KFT_REMOTE_TOOLS=1``.

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
from typing import Any, Optional

import numpy as np
import torch


_MEM_REGISTRY: dict[str, Any] = {}

MANIFEST_NAME = "manifest.json"


class StorageError(RuntimeError):
    pass


class SpillCorrupt(StorageError):
    """A spill entry's MANIFEST is unreadable or self-inconsistent: the
    session cannot be reconstructed from this tier (payload corruption
    is softer: the manifest's token record still re-prefills)."""


def register_mem(key: str, value: Any) -> str:
    """Publish an object under ``mem://<key>`` (test/bench convenience)."""
    _MEM_REGISTRY[key] = value
    return f"mem://{key}"


def fetch_mem(key: str) -> Any:
    try:
        return _MEM_REGISTRY[key]
    except KeyError:
        raise StorageError(f"mem://{key} not registered") from None


#: scheme ("gs://", "s3://", ...) -> transport(uri, dest_dir) that fetches
#: the object(s) at uri INTO dest_dir.  Injectable for tests and for
#: deployments with egress; download() stages the result through the
#: manifest cache so replicas share one verified copy.
_TRANSPORTS: dict[str, Any] = {}


def register_transport(scheme: str, fn) -> None:
    """Install (or override) the transport for a remote scheme.  Pass
    ``None`` to remove."""
    if fn is None:
        _TRANSPORTS.pop(scheme, None)
    else:
        _TRANSPORTS[scheme] = fn


def _tool_transport(tool_argv_prefix: list[str]):
    """Transport that shells out to a cloud CLI (gsutil / aws s3) when the
    binary exists on PATH — the reference's storage-initializer behavior
    [upstream: kserve pkg/agent/storage].  Returns None when absent so the
    caller falls through to the explicit zero-egress error."""
    import shutil as _shutil
    import subprocess

    if _shutil.which(tool_argv_prefix[0]) is None:
        return None

    def fetch(uri: str, dest_dir: str) -> None:
        proc = subprocess.run(
            [*tool_argv_prefix, uri, dest_dir],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise StorageError(
                f"{uri}: transfer failed: {proc.stderr.strip()[:500]}")

    return fetch


def _remote_transport_for(uri: str):
    scheme = uri.split("://", 1)[0] + "://"
    t = _TRANSPORTS.get(scheme)
    if t is not None:
        return t
    # CLI-tool fallbacks require an EXPLICIT opt-in: a gsutil/aws binary
    # may exist on a zero-egress host, where it retries against the
    # blackhole for minutes instead of failing fast — the hang the
    # scheme gating exists to prevent.  Deployments with real egress set
    # KFT_REMOTE_TOOLS=1 (or register a transport).
    if os.environ.get("KFT_REMOTE_TOOLS") != "1":
        return None
    if scheme == "gs://":
        return _tool_transport(["gsutil", "-m", "cp", "-r"])
    if scheme == "s3://":
        return _s3_tool_transport()
    return None


def _s3_tool_transport():
    """aws-cli transport.  `aws s3 cp --recursive` treats a single-object
    key as an (empty) prefix, so try the plain object copy first and fall
    back to recursive for prefix trees."""
    import shutil as _shutil
    import subprocess

    if _shutil.which("aws") is None:
        return None

    def fetch(uri: str, dest_dir: str) -> None:
        single = subprocess.run(
            ["aws", "s3", "cp", uri, dest_dir + "/"],
            capture_output=True, text=True)
        if single.returncode == 0 and os.listdir(dest_dir):
            return
        tree = subprocess.run(
            ["aws", "s3", "cp", "--recursive", uri, dest_dir],
            capture_output=True, text=True)
        if tree.returncode != 0:
            raise StorageError(
                f"{uri}: transfer failed: "
                f"{(tree.stderr or single.stderr).strip()[:500]}")

    return fetch


def _download_remote(uri: str, cache_dir: Optional[str]) -> str:
    """Fetch via the scheme's transport into a temp dir, then publish
    through the manifest cache (atomic, shared across replicas)."""
    import tempfile

    transport = _remote_transport_for(uri)
    if transport is None:
        raise StorageError(
            f"{uri}: remote storage requires network egress, which this "
            "deployment does not have; stage the model locally and use "
            "file:// (or register_transport() in an egress-enabled "
            "deployment)")
    cache_dir = cache_dir or os.path.join(
        tempfile.gettempdir(), "kft-remote-cache")
    # cache hit: a previously-staged, manifest-valid entry skips the
    # transport entirely (the kserve local-model-cache economy)
    key = hashlib.sha256(uri.encode()).hexdigest()[:16]
    entry_dir = os.path.join(cache_dir, key)
    if os.path.exists(os.path.join(entry_dir, MANIFEST_NAME)) and (
            verify_manifest(entry_dir)):
        _verified_entries.add(entry_dir)
        return os.path.join(entry_dir, "model")
    with tempfile.TemporaryDirectory(prefix="kft-fetch-") as tmp:
        dest = os.path.join(tmp, "payload")
        os.makedirs(dest, exist_ok=True)
        transport(uri, dest)
        if not os.listdir(dest):
            raise StorageError(f"{uri}: transport produced no files")
        # always stage the payload DIRECTORY: remote downloads resolve to
        # a model directory (single-file objects become a one-file dir),
        # which keeps the cache-hit path above unambiguous
        return stage_to_cache(uri, dest, cache_dir)


def download(
    uri: str, cache_dir: Optional[str] = None, hf_root: Optional[str] = None
) -> str:
    """Resolve ``uri`` to a local filesystem path (V1 storage contract).

    With ``cache_dir`` (or ``$KFT_MODEL_CACHE``), file sources are staged
    through the manifest-verified local cache and the cached path is
    returned instead of the source path.
    """
    cache_dir = cache_dir or os.environ.get("KFT_MODEL_CACHE")
    if uri.startswith("file://"):
        path = uri[len("file://"):]
        if not os.path.exists(path):
            raise StorageError(f"{uri}: no such path")
        if cache_dir:
            return stage_to_cache(uri, path, cache_dir)
        return path
    if uri.startswith("mem://"):
        # mem objects have no path; callers use fetch_mem directly
        key = uri[len("mem://"):]
        if key not in _MEM_REGISTRY:
            raise StorageError(f"{uri} not registered")
        return uri
    if uri.startswith("hf://"):
        path = resolve_hf(uri, hf_root=hf_root)
        if cache_dir:
            return stage_to_cache(uri, path, cache_dir)
        return path
    if uri.startswith(("gs://", "s3://")):
        return _download_remote(uri, cache_dir)
    for scheme in ("http://", "https://"):
        if uri.startswith(scheme):
            raise StorageError(
                f"{uri}: remote storage requires network egress, which this "
                "deployment does not have; stage the model locally and use file://"
            )
    raise StorageError(f"unsupported storage uri {uri!r}")


def resolve_hf(uri: str, hf_root: Optional[str] = None) -> str:
    """Resolve ``hf://org/name[@revision]`` against a LOCAL HuggingFace-hub
    layout snapshot root [upstream: kserve -> python/kserve storage hf://
    scheme; the reference downloads from the Hub — this deployment has
    zero egress, so the contract is covered by hub-layout directories
    staged locally (``$KFT_HF_HOME``, e.g. an exported HF_HOME/hub)]:

        <root>/models--org--name/
            refs/<revision>            # text file naming a commit
            snapshots/<commit>/...     # config.json + weights

    ``revision`` defaults to ``main``; it may be a named ref, a full
    commit, or a unique commit prefix — pinning a revision serves exactly
    that snapshot forever, the property the reference gets from commit-
    hash URLs.
    """
    hf_root = hf_root or os.environ.get("KFT_HF_HOME")
    if not hf_root:
        raise StorageError(
            f"{uri}: hf:// resolves against a local HuggingFace-hub layout "
            "(zero-egress deployment); set KFT_HF_HOME or pass hf_root")
    ref = uri[len("hf://"):]
    repo, _, revision = ref.partition("@")
    revision = revision or "main"
    repo = repo.strip("/")
    if repo.count("/") != 1:
        raise StorageError(f"{uri}: expected hf://<org>/<name>[@revision]")
    repo_dir = os.path.join(hf_root, "models--" + repo.replace("/", "--"))
    if not os.path.isdir(repo_dir):
        raise StorageError(f"{uri}: {repo!r} not present under {hf_root}")
    snapshots = os.path.join(repo_dir, "snapshots")
    commit: Optional[str] = None
    ref_file = os.path.join(repo_dir, "refs", revision)
    if os.path.isfile(ref_file):
        with open(ref_file) as f:
            commit = f.read().strip()
    else:
        try:
            known = sorted(os.listdir(snapshots))
        except OSError:
            known = []
        matches = [c for c in known if c.startswith(revision)]
        if len(matches) == 1:
            commit = matches[0]
        elif len(matches) > 1:
            raise StorageError(
                f"{uri}: revision {revision!r} is ambiguous ({matches})")
    if not commit:
        raise StorageError(f"{uri}: unknown revision {revision!r}")
    snap = os.path.join(snapshots, commit)
    if not os.path.isdir(snap):
        raise StorageError(
            f"{uri}: ref {revision!r} names missing snapshot {commit!r}")
    return snap


# ---------------------------------------------------------------------------
# Local model cache with manifests
# ---------------------------------------------------------------------------


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _walk_files(root: str) -> list[str]:
    """Relative paths of every regular file under root (root may be a file)."""
    if os.path.isfile(root):
        return [""]
    out = []
    for dirpath, _, names in os.walk(root):
        for n in names:
            out.append(os.path.relpath(os.path.join(dirpath, n), root))
    return sorted(out)


def build_manifest(uri: str, root: str) -> dict:
    files = []
    for rel in _walk_files(root):
        p = root if rel == "" else os.path.join(root, rel)
        st = os.stat(p)
        files.append({
            "path": rel or os.path.basename(root),
            "size": st.st_size,
            "mtime_ns": st.st_mtime_ns,
            "sha256": _sha256_file(p),
        })
    return {"uri": uri, "created": time.time(), "files": files}


def verify_manifest(entry_dir: str) -> bool:
    """True when every file named by the entry's manifest matches on size
    and sha256 (the cache-hit validity check)."""
    mpath = os.path.join(entry_dir, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    model_root = os.path.join(entry_dir, "model")
    for rec in manifest.get("files", []):
        p = os.path.join(model_root, rec["path"])
        try:
            if os.path.getsize(p) != rec["size"]:
                return False
            if _sha256_file(p) != rec["sha256"]:
                return False
        except OSError:
            return False
    return True


#: entry dirs fully hash-verified once by this process; later hits only
#: size-check, so warm-path cost is O(files), not O(bytes)
_verified_entries: set[str] = set()


def _sizes_ok(entry_dir: str) -> bool:
    """Cheap validity check: size + mtime match the manifest (catches
    rewrites without re-reading the bytes)."""
    mpath = os.path.join(entry_dir, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        model_root = os.path.join(entry_dir, "model")
        for rec in manifest.get("files", []):
            st = os.stat(os.path.join(model_root, rec["path"]))
            if st.st_size != rec["size"]:
                return False
            if "mtime_ns" in rec and st.st_mtime_ns != rec["mtime_ns"]:
                return False
        return True
    except (OSError, json.JSONDecodeError, KeyError):
        return False


def stage_to_cache(uri: str, src_path: str, cache_dir: str) -> str:
    """Stage ``src_path`` into the cache under a URI-keyed entry; return the
    staged model path.  A valid existing entry is reused without copying;
    an invalid one (interrupted copy, corruption) is re-staged."""
    key = hashlib.sha256(uri.encode()).hexdigest()[:16]
    entry_dir = os.path.join(cache_dir, key)
    model_root = os.path.join(entry_dir, "model")

    def staged_path() -> str:
        if os.path.isdir(src_path):
            return model_root
        return os.path.join(model_root, os.path.basename(src_path))

    if os.path.exists(os.path.join(entry_dir, MANIFEST_NAME)):
        if entry_dir in _verified_entries:
            # full-hash verified once this process; cheap size check after
            if _sizes_ok(entry_dir):
                return staged_path()
            _verified_entries.discard(entry_dir)
        if verify_manifest(entry_dir):
            _verified_entries.add(entry_dir)
            return staged_path()
        shutil.rmtree(entry_dir, ignore_errors=True)

    # hidden staging name: list_cache skips dot-entries; unique per attempt
    # so concurrent stagers (other processes OR other threads here) never
    # collide.  Only *stale* leftovers (dead stagers) are garbage-collected.
    tmp_dir = os.path.join(
        cache_dir, f".staging-{key}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    for leftover in _stale_staging_dirs(cache_dir, key):
        shutil.rmtree(leftover, ignore_errors=True)
    tmp_model = os.path.join(tmp_dir, "model")
    if os.path.isdir(src_path):
        shutil.copytree(src_path, tmp_model)
    else:
        os.makedirs(tmp_model, exist_ok=True)
        shutil.copy2(src_path, os.path.join(tmp_model, os.path.basename(src_path)))
    # manifest is built from the STAGED copy so manifest and bytes agree by
    # construction even if the source mutates mid-copy
    manifest = build_manifest(uri, tmp_model)
    with open(os.path.join(tmp_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp_dir)
    # rename() publishes the entry atomically; never remove a published
    # entry here — a concurrent replica may already be serving from it
    try:
        os.rename(tmp_dir, entry_dir)
        _fsync_dir(cache_dir)
        _verified_entries.add(entry_dir)
    except OSError:
        # lost the publish race to a concurrent replica; use the winner's
        shutil.rmtree(tmp_dir, ignore_errors=True)
        if not verify_manifest(entry_dir):
            raise StorageError(f"cache entry for {uri} is invalid after race")
        _verified_entries.add(entry_dir)
    return staged_path()


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
        # analysis: ok host-sync-in-dispatch — snapshot leaves are host memory (spill worker)
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    # analysis: ok host-sync-in-dispatch — snapshot leaves are host memory (spill worker)
    return x.detach().cpu().contiguous()


def _dtype_name(x) -> str:
    """The manifest's dtype string: numpy's name (``"float32"``,
    ``"int8"``, and ``"bfloat16"`` as ``ml_dtypes`` spells it)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    # analysis: ok host-sync-in-dispatch — snapshot leaves are host memory (spill worker)
    return str(np.asarray(x).dtype)


def _spill_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise SpillCorrupt(f"spill leaf dtype {name!r} is not a torch dtype")
    return dt


def _pack_spill_leaves(leaves) -> bytes:
    # analysis: ok host-sync-in-dispatch — snapshot leaves are host memory (spill worker)
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

    def _write_file(self, staged_path: str, data: bytes) -> dict:
        """Write one payload file inside the entry's staging directory
        (``write`` publishes the directory by rename)."""
        with open(staged_path, "wb") as f:
            f.write(data)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        return {"path": os.path.basename(staged_path), "size": len(data),
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
