"""Sequence parallelism: ring and Ulysses attention over the ``seq`` mesh
axis, the port of ``kubeflow_tpu/parallel/ring_attention.py``.

Each rank holds one contiguous block of the sequence: q ``[b, s/r, h, d]``,
k and v ``[b, s/r, kv, d]`` (rank ``i`` the positions ``[i s/r, (i+1)
s/r)``). ``ring_attention`` hands the K/V blocks round the ring of the ``r``
ranks (``collectives.ring_pass``: K and V in one buffer, ``r - 1`` shifts,
one collective a step) and folds each block into its queries' causal
attention:

- ``"flash"`` blocks: the diagonal block runs the causal K1, an earlier
  block the non-causal K1, a later block is skipped (nothing launched, but
  the rank still joins every shift); the normalised block outputs merge
  exactly through their logsumexps, and the lse's cotangent folds into K2's
  and K3's delta (``ops/flash_attention.py``);
- ``"einsum"`` blocks: the plain f32 online-softmax fold of every block,
  masked by global positions;
- ``"auto"``: flash on CUDA tensors, einsum on CPU ones (the kernel on the
  accelerator, the plain fold on the CPU, as the reference chooses).

``ulysses_attention`` trades the sequence shard of every head for the whole
sequence of ``h / r`` heads (an all-to-all), runs causal attention, and
trades back. With no ``seq`` axis of more than one rank both run causal
attention over the rank's whole sequence, by the same ``block_impl`` (the
causal K1-K3 for flash, which is the one-rank ring), so a model may name
them unconditionally.

``mesh`` is a ``DeviceMesh`` (default ``mesh.current_mesh()``) or the
``seq`` axis's ``sharding.AxisGroup`` itself, as a laid-out model holds it.
Every rank of the axis calls these functions together, forward and
backward, and issues the same collectives in the same order.
"""

from __future__ import annotations

import math

import torch

from .collectives import all_to_all, ring_pass
from .sharding import axis_group

_NEG_INF = -1e30
_BLOCK_IMPLS = ("auto", "flash", "einsum")


def _dense(q, k, v, q_per_kv: int):
    from ..models.llama import _causal_attention

    return _causal_attention(q, k, v, q_per_kv)


def _whole(q, k, v, q_per_kv: int, block_impl: str):
    """Causal attention over the whole sequence this rank holds (no ``seq``
    axis, or Ulysses' gathered heads): K1-K3 for ``"flash"``, the dense f32
    path for ``"einsum"``."""
    if _block_impl(block_impl, q) == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, q_per_kv=q_per_kv)
    return _dense(q, k, v, q_per_kv)


def _block_impl(block_impl: str, q) -> str:
    if block_impl not in _BLOCK_IMPLS:
        raise ValueError(f"unknown block_impl {block_impl!r}")
    if block_impl == "auto":
        return "flash" if q.is_cuda else "einsum"
    return block_impl


def ring_attention(q, k, v, *, axis_name: str = "seq", q_per_kv: int = 1,
                   mesh=None, block_impl: str = "auto"):
    """Causal GQA attention of this rank's sequence block ``q`` [b, s/r, h,
    d] over every rank's ``k``, ``v`` [b, s/r, kv, d]; see the module
    docstring."""
    ring = axis_group(mesh, axis_name)
    if ring is None:
        return _whole(q, k, v, q_per_kv, block_impl)
    body = (_ring_forward_flash if _block_impl(block_impl, q) == "flash"
            else _ring_forward)
    return body(q, k, v, ring, q_per_kv)


def _block_fold(acc, qh, k_blk, v_blk, q_pos, k_pos, scale):
    """Fold one visiting K/V block into the online-softmax accumulator.

    qh: [b, sq, kv, g, d] f32; k_blk/v_blk: [b, sk, kv, d]. acc = (m, l,
    o): running max [b, sq, kv, g], denominator [b, sq, kv, g], numerator
    [b, sq, kv, g, d], all f32."""
    m, l, o = acc
    logits = torch.einsum("bqkgd,bskd->bqkgs", qh, k_blk.float()) * scale
    causal = q_pos[:, None] >= k_pos[None, :]
    logits = logits.masked_fill(~causal[None, :, None, None, :], _NEG_INF)
    m_new = torch.maximum(m, logits.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.einsum(
        "bqkgs,bskd->bqkgd", p, v_blk.float())
    return m_new, l_new, o_new


def _ring_forward(q, k, v, ring, q_per_kv: int):
    """The einsum fold: this rank's queries stay, the K/V blocks visit."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qh = q.reshape(b, sq, kvh, q_per_kv, d).float()
    pos = torch.arange(sq, device=q.device)
    q_pos = ring.rank * sq + pos
    acc = (torch.full((b, sq, kvh, q_per_kv), _NEG_INF, device=q.device),
           torch.zeros(b, sq, kvh, q_per_kv, device=q.device),
           torch.zeros(b, sq, kvh, q_per_kv, d, device=q.device))
    for t, kv in enumerate(ring_pass(torch.stack([k, v]), ring.group)):
        src = (ring.rank - t) % ring.size  # whose block this is
        acc = _block_fold(acc, qh, kv[0], kv[1], q_pos, src * sq + pos,
                          scale)
    _, l, o = acc
    return (o / l[..., None]).reshape(b, sq, h, d).to(q.dtype)


def _ring_forward_flash(q, k, v, ring, q_per_kv: int):
    """The flash fold: K1 on each block this rank's queries can see (the
    diagonal causal, an earlier one not), combined through the blocks'
    logsumexps into an unnormalised accumulator divided once at the end."""
    from ..ops.flash_attention import flash_attention_lse

    b, sq, h, d = q.shape
    o_num = torch.zeros(b, sq, h, d, device=q.device)
    l_run = torch.zeros(b, h, sq, device=q.device)
    m_run = torch.full((b, h, sq), _NEG_INF, device=q.device)
    for t, kv in enumerate(ring_pass(torch.stack([k, v]), ring.group)):
        src = (ring.rank - t) % ring.size
        if src > ring.rank:
            continue  # every key is after every query here
        o_t, lse_t = flash_attention_lse(q, kv[0], kv[1], q_per_kv=q_per_kv,
                                         causal=src == ring.rank)
        m_new = torch.maximum(m_run, lse_t)
        corr = torch.exp(m_run - m_new)
        w_t = torch.exp(lse_t - m_new)
        o_num = (o_num * corr.transpose(1, 2)[..., None]
                 + o_t.float() * w_t.transpose(1, 2)[..., None])
        l_run = l_run * corr + w_t
        m_run = m_new
    out = o_num / l_run.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q, k, v, *, axis_name: str = "seq", q_per_kv: int = 1,
                      mesh=None, block_impl: str = "auto"):
    """Ulysses sequence parallelism: an all-to-all swaps this rank's
    sequence block of every head for the whole sequence of ``h / r`` heads,
    causal attention runs on them (K1-K3 for ``"flash"``, the dense f32
    path for ``"einsum"``), and a second all-to-all swaps back. The query
    and KV head counts this rank holds must divide by the ``seq`` size."""
    impl = _block_impl(block_impl, q)
    ring = axis_group(mesh, axis_name)
    if ring is None:
        return _whole(q, k, v, q_per_kv, impl)
    r = ring.size
    if q.shape[2] % r or k.shape[2] % r:
        raise ValueError(
            f"ulysses needs per-shard head counts (q={q.shape[2]}, "
            f"kv={k.shape[2]}) divisible by seq axis size {r}")

    def gather_seq(x):  # [b, s/r, h, d] -> [b, s, h/r, d]
        b, sl, hh, d = x.shape
        chunks = x.reshape(b, sl, r, hh // r, d).permute(2, 0, 1, 3, 4)
        got = all_to_all(chunks, ring.group)  # [source rank, b, sl, ...]
        return got.permute(1, 0, 2, 3, 4).reshape(b, r * sl, hh // r, d)

    def scatter_seq(x):  # [b, s, h/r, d] -> [b, s/r, h, d]
        b, s, hl, d = x.shape
        chunks = x.reshape(b, r, s // r, hl, d).permute(1, 0, 2, 3, 4)
        got = all_to_all(chunks, ring.group)  # [head group, b, s/r, ...]
        return got.permute(1, 2, 0, 3, 4).reshape(b, s // r, r * hl, d)

    gq, gk, gv = gather_seq(q), gather_seq(k), gather_seq(v)
    return scatter_seq(_whole(gq, gk, gv, q_per_kv, impl))
