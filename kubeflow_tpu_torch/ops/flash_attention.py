"""Causal or non-causal GQA flash attention on hand-written Hopper kernels.

The port of ``kubeflow_tpu/ops/flash_attention.py``. Three CUDA kernels
(``csrc/``) carry it on the card:

- K1 ``flash_fwd``: O and the row logsumexp (lse);
- K2 ``flash_bwd_dkv``: dK and dV, summed over each KV head's query group;
- K3 ``flash_bwd_dq``: dQ.

Each kernel has a wrapper of the same name that launches it for CUDA tensors
and runs its plain f32 version (``*_plain``) for CPU tensors; nothing else
selects between the two. A CUDA tensor the kernel does not take (not bf16, or
head_dim not 64/128) raises. ``LAUNCHES`` counts kernel launches per wrapper.

Layout follows the reference's public functions: q ``[b, s, h, d]``, k/v
``[b, s, kv, d]``, lse ``[b, h, s]``. The kernels read these through strides,
and mask a ragged last tile themselves, so any sequence length works without
padding (the reference pads odd lengths to a tileable one; the result is the
same because padded keys sit past every real query).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30

#: kernel launches per wrapper; reset by setting entries to 0.
#: ``flash_fwd_noncausal`` counts those of K1's launches that ran without
#: the causal mask (a part of ``flash_fwd``'s, not a kernel of its own)
LAUNCHES = {"flash_fwd": 0, "flash_fwd_noncausal": 0, "flash_bwd_dkv": 0,
            "flash_bwd_dq": 0}

_HEAD_DIMS = (64, 128)


class _TensorRef(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("ss", ctypes.c_longlong), ("sh", ctypes.c_longlong)]


class _FlashArgs(ctypes.Structure):
    """Mirror of ``FlashArgs`` in csrc/flash_common.cuh."""

    _fields_ = [(n, _TensorRef) for n in
                ("q", "k", "v", "o", "dout", "dq", "dk", "dv")] + [
        ("lse", ctypes.c_void_p), ("delta", ctypes.c_void_p),
        ("b", ctypes.c_int), ("s", ctypes.c_int), ("h", ctypes.c_int),
        ("kv", ctypes.c_int), ("d", ctypes.c_int), ("causal", ctypes.c_int),
        ("scale", ctypes.c_float),
    ]


def _entry(name: str):
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = [ctypes.POINTER(_FlashArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ref(t: torch.Tensor) -> _TensorRef:
    return _TensorRef(t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernels can read it through a TMA tensor map
    (head_dim contiguous, a 16-byte aligned base, the other strides positive
    multiples of 16 bytes), else a contiguous copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st > 0 and st % 8 == 0 for st in t.stride()[:-1])):
        return t
    return t.contiguous()


def _check(q, k, v, *rest):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q [b,s,h,d] and k/v [b,s,kv,d]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % kv:
        raise ValueError(
            f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match")
    for t in (q, k, v, *rest):
        if t.device != q.device:
            raise ValueError("flash attention inputs are on different devices")
    if q.is_cuda:
        if d not in _HEAD_DIMS:
            raise ValueError(
                f"the CUDA kernels take head_dim {_HEAD_DIMS}, not {d}")
        for t in (q, k, v, *rest):
            if t.dtype != torch.bfloat16:
                raise TypeError(
                    f"the CUDA kernels take bfloat16 tensors, not {t.dtype}")
    elif q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    return b, s, h, kv, d


def _launch(name: str, q, k, v, causal: bool, **refs) -> None:
    b, s, h, d = q.shape
    args = _FlashArgs(
        q=_ref(q), k=_ref(k), v=_ref(v), b=b, s=s, h=h, kv=k.shape[2], d=d,
        causal=int(causal), scale=1.0 / math.sqrt(d))
    for field, t in refs.items():
        if field in ("lse", "delta"):
            setattr(args, field, t.data_ptr())
        else:
            setattr(args, field, _ref(t))
    with torch.cuda.device(q.device):
        err = _entry(name)(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# plain versions: the exact arithmetic of the kernels, in f32 over full [s, s]
# score matrices
# ---------------------------------------------------------------------------


def _scores(q, k, causal: bool) -> torch.Tensor:
    """scale * Q K^T, masked: [b, h, s, s] f32."""
    d = q.shape[-1]
    g = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(d)), kf)
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _probs_and_dscores(q, k, v, do, lse, delta, causal):
    """P = exp(S - lse) and dS = P * (dO V^T - delta) * scale, [b, h, s, s]."""
    g = q.shape[2] // k.shape[2]
    p = torch.exp(_scores(q, k, causal) - lse.float()[..., None])
    vf = v.float().repeat_interleave(g, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    ds = p * (dp - delta.float()[..., None]) / math.sqrt(q.shape[-1])
    return p, ds


def flash_fwd_plain(q, k, v, *, causal: bool = True):
    """(o [b,s,h,d] f32, lse [b,h,s] f32)."""
    g = q.shape[2] // k.shape[2]
    s = _scores(q, k, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    vf = v.float().repeat_interleave(g, dim=2)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l[..., None], vf)
    return o, m + torch.log(l)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True):
    """(dk, dv) [b,s,kv,d] f32, each summed over its query group."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return (dk.reshape(b, s, kv, h // kv, d).sum(3),
            dv.reshape(b, s, kv, h // kv, d).sum(3))


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True):
    """dq [b,s,h,d] f32."""
    g = q.shape[2] // k.shape[2]
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds,
                        k.float().repeat_interleave(g, dim=2))


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------


def flash_fwd(q, k, v, *, causal: bool = True):
    """K1: (o [b,s,h,d] in q's dtype, lse [b,h,s] f32)."""
    b, s, h, _, _ = _check(q, k, v)
    if not q.is_cuda:
        o, lse = flash_fwd_plain(q, k, v, causal=causal)
        return o.to(q.dtype), lse
    q, k, v = map(_kernel_layout, (q, k, v))
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, v, causal, o=o, lse=lse)
    if not causal:
        LAUNCHES["flash_fwd_noncausal"] += 1
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True):
    """K2: (dk, dv) [b,s,kv,d] in k's and v's dtype."""
    _check(q, k, v, do)
    if not q.is_cuda:
        dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
        return dk.to(k.dtype), dv.to(v.dtype)
    q, k, v, do = map(_kernel_layout, (q, k, v, do))
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("flash_bwd_dkv", q, k, v, causal, dout=do, dk=dk, dv=dv,
            lse=_rows(lse), delta=_rows(delta))
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True):
    """K3: dq [b,s,h,d] in q's dtype."""
    _check(q, k, v, do)
    if not q.is_cuda:
        return flash_bwd_dq_plain(
            q, k, v, do, lse, delta, causal=causal).to(q.dtype)
    q, k, v, do = map(_kernel_layout, (q, k, v, do))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("flash_bwd_dq", q, k, v, causal, dout=do, dq=dq,
            lse=_rows(lse), delta=_rows(delta))
    return dq


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A [b, h, s] per-row statistic as the contiguous f32 the kernels read."""
    if t.dtype != torch.float32:
        raise TypeError(f"lse/delta must be float32, not {t.dtype}")
    return t.contiguous()


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _FlashFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        # delta = rowsum(dO * O) - dlse, outside the kernels as in the
        # reference: d(lse)/d(s) = p, so the lse cotangent folds into delta
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse.float()
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_lse(q, k, v, *, q_per_kv: int = 1, causal: bool = True):
    """(out [b,s,h,d], lse [b,h,s]); both outputs are differentiable.

    ``causal=False`` attends over every key, the block-combinable form that
    ring attention merges through the lse.
    """
    if q.shape[2] != k.shape[2] * q_per_kv:
        raise ValueError(
            f"q_per_kv={q_per_kv} inconsistent with heads {q.shape[2]}, "
            f"kv {k.shape[2]}")
    return _FlashFunction.apply(q, k, v, causal)


def flash_attention(q, k, v, *, q_per_kv: int = 1):
    """Causal GQA flash attention: q [b,s,h,d]; k, v [b,s,kv,d]."""
    return flash_attention_lse(q, k, v, q_per_kv=q_per_kv, causal=True)[0]
