"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` (one kernel each, with a plain C entry point) is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the repository root, and loaded with ``ctypes``. A
library's file name carries a hash of its source, the shared headers and the
flags, so an edited source is rebuilt and an unchanged one is reused. The
first use builds every missing library at once, one ``nvcc`` per source, all
started together. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


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


def build() -> dict[str, str]:
    """Compile every library that is missing, in parallel.

    Returns the compiler's output (ptxas register and spill report) for each
    library it built.
    """
    todo = [n for n in KERNELS if not library_path(n).exists()]
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
