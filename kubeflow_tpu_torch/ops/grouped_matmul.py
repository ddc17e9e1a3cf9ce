"""Grouped matrix multiply over expert-sorted rows: the dropless-MoE GEMM.

The port of ``kubeflow_tpu/ops/grouped_matmul.py``. Two CUDA kernels
(``csrc/``) carry it on the card, in place of MegaBlox's ``gmm`` and ``tgmm``:

- K4a ``gmm``: ``out[i] = x[i] @ w[e]`` for ``offsets[e] <= i < offsets[e+1]``;
- K4b ``tgmm``: ``dw[e] = x_e^T g_e``, the weight gradient.

Each kernel has a wrapper of the same name that launches it for CUDA tensors
and runs its plain f32 version (``*_plain``) for CPU tensors; nothing else
selects between the two. A CUDA tensor the kernels do not take (not bf16, K or
N not a multiple of 8, offsets not int32) raises. ``LAUNCHES`` counts kernel
launches per wrapper.

The contract the reference pins on top of MegaBlox holds here too: rows that
belong to no group come back as zeros (``gmm``), and so do the blocks of
empty groups (``tgmm``). The offsets stay on the device: the kernels build
their tile schedule from them, so a call makes no host sync. Accumulation is
f32; the reference's TPU tile request (``set_gmm_tiling``) and its bf16
accumulator option are not carried over. Both kernels are persistent
(one block per SM walks a tile schedule it builds from the offsets) and
feed ``wgmma`` from TMA loads; ``csrc/hopper_gemm.cuh`` holds their shared
pieces.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches per wrapper; reset by setting entries to 0
LAUNCHES = {"gmm": 0, "tgmm": 0}

#: most groups the kernels schedule (GMM_MAX_EXPERTS in csrc/gmm.cu,
#: TGMM_MAX_EXPERTS in csrc/tgmm.cu)
MAX_EXPERTS = 256
#: most rows: the kernels' TMA row coordinates are int32, and the last
#: 128-row tile must start below 2**31
MAX_ROWS = 2**31 - 1 - 128


class _GmmArgs(ctypes.Structure):
    """Mirror of ``GmmArgs`` in csrc/gmm.cu."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("ldx", ctypes.c_longlong),
        ("w", ctypes.c_void_p), ("swe", ctypes.c_longlong),
        ("swr", ctypes.c_longlong),
        ("out", ctypes.c_void_p), ("ldo", ctypes.c_longlong),
        ("offsets", ctypes.c_void_p),
        ("b", ctypes.c_int), ("k", ctypes.c_int), ("n", ctypes.c_int),
        ("e", ctypes.c_int), ("trans_w", ctypes.c_int),
    ]


class _TgmmArgs(ctypes.Structure):
    """Mirror of ``TgmmArgs`` in csrc/tgmm.cu."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("ldx", ctypes.c_longlong),
        ("g", ctypes.c_void_p), ("ldg", ctypes.c_longlong),
        ("dw", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
        ("b", ctypes.c_int), ("k", ctypes.c_int), ("n", ctypes.c_int),
        ("e", ctypes.c_int),
    ]


def _launch(name: str, args: ctypes.Structure, device) -> None:
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = [ctypes.POINTER(type(args)), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernels can read it (last dim contiguous, 16-byte
    aligned rows), else a contiguous copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in t.stride()[:-1])):
        return t
    return t.contiguous()


def _check(x, offsets, e: int, k: int, n: int, *rest) -> None:
    """Shared checks; ``rest`` are the other tensor operands."""
    if offsets.shape != (e + 1,) or offsets.dtype != torch.int32:
        raise ValueError(
            f"offsets must be int32 [{e + 1}], not {offsets.dtype} "
            f"{tuple(offsets.shape)}")
    for t in (offsets, *rest):
        if t.device != x.device:
            raise ValueError("grouped matmul inputs are on different devices")
    if x.is_cuda:
        for t in (x, *rest):
            if t.dtype != torch.bfloat16:
                raise TypeError(
                    f"the CUDA kernels take bfloat16 tensors, not {t.dtype}")
        if k % 8 or n % 8:
            raise ValueError(
                f"the CUDA kernels take K and N in multiples of 8, not "
                f"K={k}, N={n}")
        if not 1 <= e <= MAX_EXPERTS:
            raise ValueError(
                f"the CUDA kernels take 1 to {MAX_EXPERTS} groups, not {e}")
        if x.shape[0] > MAX_ROWS:
            raise ValueError(
                f"the CUDA kernels take at most {MAX_ROWS} rows (int32 TMA "
                f"coordinates), not {x.shape[0]}")
    elif x.device.type != "cpu":
        raise ValueError(f"no grouped matmul for device {x.device}")


def _gmm_shapes(x, w, trans_w: bool) -> tuple[int, int, int, int]:
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(
            f"expected x [B,K] and w [E,K,N] ([E,N,K] with trans_w); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}")
    e, kw, n = (w.shape[0], w.shape[2], w.shape[1]) if trans_w else w.shape
    if kw != x.shape[1]:
        raise ValueError(
            f"x {tuple(x.shape)} and w {tuple(w.shape)} (trans_w={trans_w}) "
            f"do not match")
    return x.shape[0], x.shape[1], n, e


# ---------------------------------------------------------------------------
# plain versions: a loop over the groups with the offsets on the host, f32
# ---------------------------------------------------------------------------


def _bounds(offsets) -> list[tuple[int, int]]:
    offs = offsets.tolist()
    return list(zip(offs[:-1], offs[1:]))


def gmm_plain(x, w, offsets, trans_w: bool = False) -> torch.Tensor:
    """out [B, N] f32; rows of no group are zero."""
    b, _, n, _ = _gmm_shapes(x, w, trans_w)
    out = torch.zeros(b, n, dtype=torch.float32, device=x.device)
    for e, (lo, hi) in enumerate(_bounds(offsets)):
        if hi > lo:
            we = w[e].float()
            out[lo:hi] = x[lo:hi].float() @ (we.t() if trans_w else we)
    return out


def tgmm_plain(x, g, offsets) -> torch.Tensor:
    """dw [E, K, N] f32; blocks of empty groups are zero."""
    bounds = _bounds(offsets)
    dw = torch.zeros(len(bounds), x.shape[1], g.shape[1],
                     dtype=torch.float32, device=x.device)
    for e, (lo, hi) in enumerate(bounds):
        if hi > lo:
            dw[e] = x[lo:hi].float().t() @ g[lo:hi].float()
    return dw


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------


def gmm(x, w, offsets, trans_w: bool = False) -> torch.Tensor:
    """K4a: out [B, N] in x's dtype, ``out[i] = x[i] @ w[e]`` (``w[e]^T``
    with ``trans_w``) for ``offsets[e] <= i < offsets[e+1]``; other rows 0."""
    b, k, n, e = _gmm_shapes(x, w, trans_w)
    _check(x, offsets, e, k, n, w)
    if not x.is_cuda:
        return gmm_plain(x, w, offsets, trans_w).to(x.dtype)
    out = torch.empty(b, n, dtype=x.dtype, device=x.device)
    x, w = _kernel_layout(x), _kernel_layout(w)
    offsets = offsets.contiguous()
    _launch("gmm", _GmmArgs(
        x=x.data_ptr(), ldx=x.stride(0), w=w.data_ptr(), swe=w.stride(0),
        swr=w.stride(1), out=out.data_ptr(), ldo=out.stride(0),
        offsets=offsets.data_ptr(), b=b, k=k, n=n, e=e,
        trans_w=int(trans_w)), x.device)
    return out


def tgmm(x, g, offsets) -> torch.Tensor:
    """K4b: dw [E, K, N] in x's dtype, ``dw[e] = x_e^T g_e``; empty groups
    0. ``E`` is ``len(offsets) - 1``. Rows outside group e never reach
    ``dw[e]``, whatever they hold (Inf and NaN included)."""
    if x.dim() != 2 or g.dim() != 2 or x.shape[0] != g.shape[0]:
        raise ValueError(
            f"expected x [B,K] and g [B,N]; got {tuple(x.shape)}, "
            f"{tuple(g.shape)}")
    (b, k), n, e = x.shape, g.shape[1], offsets.shape[0] - 1
    _check(x, offsets, e, k, n, g)
    if not x.is_cuda:
        return tgmm_plain(x, g, offsets).to(x.dtype)
    dw = torch.empty(e, k, n, dtype=x.dtype, device=x.device)
    x, g = _kernel_layout(x), _kernel_layout(g)
    offsets = offsets.contiguous()
    _launch("tgmm", _TgmmArgs(
        x=x.data_ptr(), ldx=x.stride(0), g=g.data_ptr(), ldg=g.stride(0),
        dw=dw.data_ptr(), offsets=offsets.data_ptr(), b=b, k=k, n=n, e=e),
        x.device)
    return dw


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        return gmm(x, w, offsets)

    @staticmethod
    def backward(ctx, g):
        x, w, offsets = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(g, w, offsets, trans_w=True)
        if ctx.needs_input_grad[1]:
            dw = tgmm(x, g, offsets).to(w.dtype)
        return dx, dw, None


def grouped_matmul(x, w, offsets) -> torch.Tensor:
    """``out[i] = x[i] @ w[e]`` for rows ``offsets[e] <= i < offsets[e+1]``.

    x: [B, K] rows grouped by expert; w: [E, K, N]; offsets: int32 [E+1]
    monotone group boundaries on x's device (rows outside every group give
    zeros). Returns [B, N] in x's dtype. Backward: ``dx = gmm(g, w,
    trans_w=True)`` and ``dw = tgmm(x, g)``, as the reference's VJP.
    """
    return _GroupedMatmul.apply(x, w, offsets)
