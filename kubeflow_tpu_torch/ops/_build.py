"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` (one kernel each, with a plain C entry point) is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the repository root, and loaded with ``ctypes``. A
library's file name carries a hash of its source, the shared headers and the
flags, so an edited source is rebuilt and an unchanged one is reused. The
first use builds every missing library at once, one ``nvcc`` per source, all
started together. A failed build raises with the compiler's output.

With a program-artifact cache (``serving/programs.py``; an engine hands its
``program_cache`` over before warmup's first launch), each library is an
entry of the cache, family ``kernels``, keyed by its name, the hash above,
the compiler's release and the target: ``load_through`` takes each library
from its verified entry (size and sha256 checked before ``ctypes.CDLL``, no
compile) and writes it under its hashed name here; the misses (no
entry, or a torn one, which the cache counts and deletes) are built with
``nvcc`` as without a cache and published. Without a cache (``load``)
nothing changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: kernel name -> source; each source defines ``<name>_launch``
KERNELS = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dkv": "flash_bwd_dkv.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "gmm": "gmm.cu",
    "tgmm": "tgmm.cu",
}
HEADERS = ("flash_common.cuh", "hopper_gemm.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the target every library is built for (a part of its cache key)
TARGET = "sm_90a"
#: the per-engine half of a library's cache key: libraries are shared by
#: every engine and model on one cache root
KEY_BASE = "cuda-kernels"

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_release: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (KERNELS[name], *HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every library (of ``names``, default all) that is missing, in
    parallel.

    Returns the compiler's output (ptxas register and spill report) for each
    library it built.
    """
    todo = [n for n in (KERNELS if names is None else names)
            if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            # durable before the name commits: a torn library under the
            # hashed name would be loaded as if it were complete
            with open(tmp, "rb") as fh:
                os.fsync(fh.fileno())
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def nvcc_release() -> str:
    """The compiler's version (``12.9.86``), as ``nvcc --version`` prints it
    after ``V``; read once a process."""
    nvcc = nvcc_path()
    if nvcc not in _release:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
        found = re.search(r"\bV(\d+(?:\.\d+)+)", out)
        if found is None:
            raise RuntimeError(f"no release in nvcc --version: {out}")
        _release[nvcc] = found.group(1)
    return _release[nvcc]


def library_sig(name: str) -> str:
    """A library's signature in the program-artifact cache: its hashed
    file name (source, headers, flags), the compiler's release and the
    target."""
    return "|".join((name, library_path(name).name, nvcc_release(), TARGET))


def _install(path: Path, blob: bytes) -> None:
    """Write verified library bytes under ``path``: temporary file, fsync,
    then the rename that commits the name."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "wb") as fh:
        fh.write(blob)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _through_cache(names, cache) -> dict[str, str]:
    """Put the bytes of each library's verified cache entry at its
    ``library_path``; returns ``"hit"`` or ``"miss"`` by name. A hit writes
    the entry's bytes there unless the file there already has them; the
    misses are built together (``nvcc`` only for a library missing here, as
    without a cache) and published."""
    outcomes, misses = {}, []
    for name in names:
        key = cache.entry_key(KEY_BASE, "kernels", library_sig(name))
        out = library_path(name)
        blob = cache.load(key)
        if blob is None:
            cache.note_miss()
            misses.append((name, key, out))
            continue
        cache.note_hit()
        outcomes[name] = "hit"
        digest = hashlib.sha256(blob).hexdigest()
        if not out.exists() or hashlib.sha256(
                out.read_bytes()).hexdigest() != digest:
            _install(out, blob)
    if misses:
        build([name for name, _, _ in misses])
    for name, key, out in misses:
        cache.publish(key, out.read_bytes(),
                      meta={"family": "kernels", "library": out.name})
        outcomes[name] = "miss"
    return outcomes


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def load_through(cache) -> dict[str, str]:
    """Load every library through a program-artifact ``cache`` (see the
    module docstring), also those this process has loaded already; returns
    each one's ``"hit"`` or ``"miss"``."""
    with _lock:
        outcomes = _through_cache(list(KERNELS), cache)
        for name in KERNELS:
            if name not in _loaded:
                _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return outcomes
