"""Native (C++) runtime components, built on demand with the system g++.

The port's copy of ``kubeflow_tpu/native/__init__.py``. The reference's
native tier is its data path (PyTorch C++ DataLoader workers, tf.data's C++
runtime); the control plane itself is Go with no hot loops (SURVEY.md §2
intro). Mirroring that split: torch and the Hopper kernels own device
compute, C++ owns the host-side memory loops feeding it, and everything here
is optional — a NumPy fallback backs every entry point.

The library is ``libkft_torch_data.so``, its own name, so the two packages
never swap libraries in a shared cache directory.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

log = logging.getLogger("kubeflow_tpu_torch.native")

_SRC = os.path.join(os.path.dirname(__file__), "dataloader.cpp")
LIB_NAME = "libkft_torch_data.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build(so_path: str) -> bool:
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        _SRC, "-o", so_path,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("native dataloader build failed (%s); using NumPy fallback", e)
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """The compiled dataloader library, building it on first use; None when
    no toolchain is available (callers fall back to NumPy)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        cache_dir = os.environ.get(
            "KFT_NATIVE_CACHE",
            os.path.join(tempfile.gettempdir(), "kft-native"))
        os.makedirs(cache_dir, exist_ok=True)
        so_path = os.path.join(cache_dir, LIB_NAME)
        src_mtime = os.path.getmtime(_SRC)
        if not os.path.exists(so_path) or os.path.getmtime(so_path) < src_mtime:
            tmp = so_path + f".build-{os.getpid()}"
            if not _build(tmp):
                _build_failed = True
                return None
            # durability before publish: a crash after the replace must
            # not leave a live .so whose pages never hit disk (dlopen of
            # a torn library segfaults instead of failing cleanly)
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, so_path)  # atomic publish for concurrent builders
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            log.warning("native dataloader load failed (%s)", e)
            _build_failed = True
            return None
        u64 = ctypes.c_uint64
        p_u64 = ctypes.POINTER(u64)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        lib.kft_shuffle_indices.argtypes = [u64, u64, p_u64]
        lib.kft_shuffle_indices.restype = None
        lib.kft_pack_sequences.argtypes = [
            p_i32, p_u64, u64, p_u64, ctypes.c_int32, u64, u64, u64, p_i32]
        lib.kft_pack_sequences.restype = u64
        lib.kft_gather_batch.argtypes = [p_i32, u64, p_u64, u64, p_i32]
        lib.kft_gather_batch.restype = None
        _lib = lib
        return _lib
