"""Continuous batching for LLM serving: the port of the engine core of
``kubeflow_tpu/serving/continuous.py``.

Requests join and leave a running decode batch at chunk boundaries. The
engine keeps a pool of ``num_slots`` decode slots; each dispatch runs
``decode_chunk`` sampling steps for the whole pool in one program, inactive
slots riding along with their writes dropped. Admission comes in three
forms, as in the reference:

- the slot pool (``block_size=0``) with whole-prompt admission: waiting
  requests group by prompt bucket, and each group is one batched prefill
  merged into the pool;
- chunked admission (``prefill_budget > 0``): a prompt prefills
  ``prefill_budget`` tokens a dispatch, fused into the decode dispatch
  whenever decode work is live;
- the paged pool (``block_size > 0``): KV lives in blocks owned by a
  ``BlockAllocator``; each dispatch gathers the slots' block tables into a
  contiguous working view, runs the same math and scatters the written
  blocks back (``paged.py``).

Prefix reuse (``prefix_cache``, on by default as in the reference): in
the slot pool a prompt sharing ``min_prefix`` tokens with a slot's KV
admits by an on-device row copy and its suffix prefill; in the paged pool
full blocks of a live or retired sequence are shared by refcount and the
boundary block forks with one copy (COW). Shared-prefix segments
(``prefix_segments``) hold one immutable prefix for many short suffix
slots. Speculative decoding (``spec_k``) verifies up to ``spec_k`` drafts
a slot in one dispatch (``NgramProposer`` or an injected
``DraftProposer``); greedy tokens equal plain decode's.

Every program is a plain function on tensors that updates the pool in
place (``make_*_program``). On the card the engine captures each program, at
each static shape it runs (attend rung, admission group and bucket), as a
CUDA graph in ``warmup`` and replays it afterwards: the counterpart of the
reference's one ``jit`` per shape. A capture after warmup is a stall of
every live request; ``analysis/runtime.py``'s ``CaptureCounter`` counts
it into the ``graph_captures_total`` gauge, which must stay 0. On the CPU
the same functions run eagerly, and the counter counts each program shape's
first use.

What differs from the reference, and why:

- Out-of-range writes. The reference drops them (``mode="drop"``): an
  inactive slot pinned at ``max_seq_len``, an admission pad row merged into
  slot ``num_slots``, a pad block id, a verify's tokens past
  ``max_seq_len``. A CUDA index out of range fires a device-side assert,
  so every pool here holds scratch that nothing reads: one slot row past
  ``num_slots``, one position past ``max_seq_len``, one block past
  ``num_blocks``, one segment row past ``prefix_segments``, and such
  writes land there (the decode path clamps every write position to the
  scratch position).
- Warmup. The reference compiles a paged prefix hit's suffix prefill at
  a deep attend rung on first use; here a first use is a capture while
  serving, so warmup also captures the smallest bucket's chunk at every
  rung a warmed prompt reaches.
- ``lax.cond`` on "any slot filters top-k/top-p" cannot branch inside a
  graph. The host knows every slot's knobs, so it picks one of two
  captured variants; the outcome is the same.
- The random draw. Categorical sampling is Gumbel-max as in
  ``jax.random.categorical``; its uniform noise is drawn from the engine's
  ``torch.Generator`` into a static buffer before each replay (only when a
  slot samples), and the graph reads it. The two frameworks' generators
  differ, so sampled tokens match the reference in distribution only;
  greedy tokens match exactly.
- Dispatch ahead. With ``pipeline_depth`` dispatches in flight, each
  dispatch's tokens are copied into their own pinned host buffer and
  ``_process`` waits on that dispatch's CUDA event; host inputs reach the
  graphs' static buffers through a ring of pinned staging buffers. A
  verify's accept lengths travel in the same buffer, after its tokens.

Knobs not ported yet raise ``NotImplementedError`` naming their ROADMAP
item: the host KV tier (``host_blocks``, ``host_watermark``), admission
policies and roles, serving meshes and the program-artifact cache.

Thread contract, as in the reference: scheduler state (the slot table,
``_waiting``, the allocator, the pool) is owned by the scheduler thread,
started lazily by the first ``submit``; other threads post requests through
``_queue`` and read stats.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import logging
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..analysis.runtime import CaptureCounter
from ..device import resolve_device
from ..models.llama import KvCache, Llama, LlamaConfig
from ..ops import flash_attention as _fa
from ..ops import grouped_matmul as _gm
from .paged import (
    BlockAllocator,
    gather_working_view,
    lcp,
    scatter_working_view,
    write_window_tables,
)

log = logging.getLogger("kubeflow_tpu_torch.serving")


@dataclass
class Request:
    """One generation request tracked through the engine."""

    prompt: list[int]
    max_new_tokens: int
    #: per-request sampling knobs (None = the engine's defaults):
    #: temperature (0 = greedy), top_p (nucleus mass), top_k (0 = off)
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    #: priority tier (0 = high): admission sorts by it, stably
    priority: int = 1
    submitted_at: float = field(default_factory=time.perf_counter)
    submitted_step: int = 0
    admitted_step: int = -1
    slot: int = -1
    tokens: list[int] = field(default_factory=list)
    first_token_at: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[Exception] = None
    cancelled: threading.Event = field(default_factory=threading.Event)
    #: request-lifecycle trace; always None here (tracing is not ported)
    trace: Optional[Any] = None
    last_token_at: float = field(default_factory=time.perf_counter)

    def cancel(self) -> None:
        """Resolve now with the tokens so far; the engine frees the slot
        at the next chunk boundary."""
        self.cancelled.set()
        self.done.set()

    def wait(self, timeout: Optional[float] = None) -> list[int]:
        if not self.done.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self.error is not None:
            raise self.error
        return self.tokens

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


def cache_shapes(cfg: LlamaConfig, batch: int) -> dict[str, tuple]:
    """``{leaf: (shape, dtype)}`` of a ``batch``-row KV cache of
    ``cfg.max_seq_len`` positions, scratch not counted."""
    kv = (cfg.num_layers, batch, cfg.max_seq_len, cfg.num_kv_heads,
          cfg.head_dim)
    dt = torch.int8 if cfg.quant_kv else cfg.dtype
    out = {"k": (kv, dt), "v": (kv, dt)}
    if cfg.quant_kv:
        sc = (cfg.num_layers, batch, cfg.num_kv_heads, cfg.max_seq_len)
        out.update(k_scale=(sc, torch.float32), v_scale=(sc, torch.float32))
    return out


# -- sampling -------------------------------------------------------------


def sample_filter(logits, temps, top_ps, top_ks, banned=None, *,
                  filtered: bool):
    """The deterministic half of the reference's ``_sample_step``:
    (the warped f32 logits [slots, v], the greedy argmax [slots]).

    Temperature, then top-k, then top-p on one descending sort of the
    scaled logits (``filtered``; the host passes False when no slot sets
    top-k or top-p, where the warp keeps every token), then the ``banned``
    token of each slot (-1 = none). Ties go to the first index in both
    frameworks' argmax."""
    v = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
    final = scaled
    if filtered:
        sorted_desc = scaled.sort(dim=-1, descending=True).values
        k_eff = torch.where(top_ks > 0, top_ks.clamp(1, v),
                            torch.full_like(top_ks, v))
        kth = sorted_desc.gather(-1, (k_eff - 1)[:, None])
        ranks = torch.arange(v, device=logits.device)[None, :]
        in_k = ranks < k_eff[:, None]
        sorted_k = sorted_desc.masked_fill(~in_k, float("-inf"))
        sp = sorted_k.softmax(dim=-1)
        cum_before = sp.cumsum(dim=-1) - sp
        keep = in_k & (cum_before < top_ps.clamp(1e-6, 1.0)[:, None])
        min_keep = sorted_desc.masked_fill(~keep, float("inf")).amin(
            dim=-1, keepdim=True)
        final = scaled.masked_fill(~((scaled >= min_keep) & (scaled >= kth)),
                                   float("-inf"))
    if banned is not None:
        ids = torch.arange(v, device=logits.device)[None, :]
        final = final.masked_fill(ids == banned[:, None], float("-inf"))
    return final, greedy


def sample_draw(final, greedy, temps, noise):
    """The random half: Gumbel-max over ``final`` with ``noise`` uniform in
    [0, 1) [slots, v] (``jax.random.categorical``'s algorithm); greedy
    slots (temperature 0) take ``greedy``."""
    sampled = (final - (-noise.log()).log()).argmax(dim=-1)
    return torch.where(temps > 0, sampled, greedy)


def _sample_step(logits, temps, top_ps, top_ks, noise, *, filtered: bool):
    final, greedy = sample_filter(logits, temps, top_ps, top_ks,
                                  filtered=filtered)
    return sample_draw(final, greedy, temps, noise)


# -- programs -------------------------------------------------------------
#
# Each make_* function returns a plain function of (model, pool tensors,
# inputs) that updates the pool in place. Pools hold one scratch slot row
# past num_slots (and a slot pool one scratch position past max_seq_len), so
# every write the reference drops lands in scratch. Index inputs are int64
# device tensors: a scalar input is a [1] tensor.


def make_prefill_program(cfg: LlamaConfig, attend: int):
    """[g, bucket] ragged prefill -> (last-token logits [g, v], a fresh
    row cache), attending only over cache positions [0, attend)."""

    def prefill(model, prompt, lengths):
        g, length = prompt.shape
        cache = KvCache.zeros(cfg, g, cfg.max_seq_len, device=prompt.device)
        positions = torch.arange(length, device=prompt.device).expand(
            g, length)
        logits_all = model(prompt, positions, cache=cache, attend=attend)
        idx = (lengths - 1)[:, None, None].expand(g, 1, logits_all.shape[-1])
        return logits_all.gather(1, idx)[:, 0], cache

    return prefill


def merge(pool: KvCache, pool_logits, rows: KvCache, row_logits,
          slots) -> None:
    """Scatter a batch of prefilled row caches and their next-token logits
    into the pool at ``slots`` [g]; pad rows carry ``num_slots``, the
    scratch row."""
    pool.put_rows(slots, rows)
    pool_logits.index_copy_(0, slots, row_logits)


def _chunk_prefill_body(cfg: LlamaConfig, attend: int, budget: int):
    """Run ``budget`` prompt tokens of one admitting slot's prefill against
    the pool: take the slot's row, forward the chunk at global positions
    [start, start + budget), put the row back, and write the logits of the
    token ``length - 1`` into the pool logits at ``write_slot`` (the scratch
    row ``num_slots`` for a chunk that is not the last)."""

    def body(model, cache, logits, slot, toks, start, length, write_slot):
        row = cache.select_rows(slot)
        positions = (start + torch.arange(budget, device=toks.device))[None]
        logits_all = model(toks[None], positions, cache=row, attend=attend)
        cache.put_rows(slot, row)
        logits.index_copy_(0, write_slot,
                           logits_all[0].index_select(0, length - 1))

    return body


def _decode_scan(model, cache, logits, pos, active, temps, top_ps, top_ks,
                 noise, *, attend: int, chunk: int, filtered: bool,
                 sentinel: int, keep_inactive: bool, prefix=None):
    """``chunk`` sampling steps over the pool's slots (every row but the
    scratch one): sample from the carried logits, forward the sampled
    tokens at ``pos``, advance active rows (inactive ones stay pinned at
    ``sentinel``). ``keep_inactive`` keeps inactive rows' logits (the fused
    step: the admitting row's fresh prefill logits must survive). With
    ``prefix = (pk, pv, plens)`` every row attends its shared segment
    first and ``pos`` is slot-local (global = pos + plens). Returns the
    tokens [slots, chunk]."""
    slots = active.shape[0]
    view, lg = cache.head_rows(slots), logits[:slots]
    out = []
    for i in range(chunk):
        tok = _sample_step(lg, temps, top_ps, top_ks, noise[i],
                           filtered=filtered)
        if prefix is None:
            new = model(tok[:, None], pos[:, None], cache=view,
                        attend=attend)[:, -1]
        else:
            new = model(tok[:, None], (pos + prefix[2])[:, None],
                        cache=view, attend=attend, prefix=prefix,
                        cache_positions=pos[:, None])[:, -1]
        pos = torch.where(active, pos + 1, sentinel)
        lg.copy_(torch.where(active[:, None], new, lg) if keep_inactive
                 else new)
        out.append(tok)
    return torch.stack(out, dim=1)


def make_chunk_prefill_program(cfg: LlamaConfig, attend: int, budget: int):
    """One ``budget``-token prefill chunk as its own dispatch (no live
    decode work to ride). (model, pool, pool_logits, slot, toks [budget],
    start, length, write_slot) -> None."""
    return _chunk_prefill_body(cfg, attend, budget)


def make_fused_step_program(cfg: LlamaConfig, attend: int, chunk: int,
                            budget: int, filtered: bool):
    """One dispatch = one prefill chunk of the admitting request +
    ``chunk`` decode steps of the whole pool; inactive rows (the admitting
    one included) keep their logits. Returns the tokens [slots, chunk]."""
    body = _chunk_prefill_body(cfg, attend, budget)

    def fused(model, cache, logits, slot, toks, start, length, write_slot,
              positions, active, temps, top_ps, top_ks, noise):
        body(model, cache, logits, slot, toks, start, length, write_slot)
        safe = torch.where(active, positions, cfg.max_seq_len)
        return _decode_scan(model, cache, logits, safe, active, temps,
                            top_ps, top_ks, noise, attend=attend,
                            chunk=chunk, filtered=filtered,
                            sentinel=cfg.max_seq_len, keep_inactive=True)

    return fused


def make_decode_program(cfg: LlamaConfig, attend: int, chunk: int,
                        filtered: bool):
    """``chunk`` sampling steps for the whole slot pool, attending over
    cache positions [0, attend). Inactive slots compute but their writes
    land in the scratch position ``max_seq_len``, which the causal mask
    hides. Returns the tokens [slots, chunk]."""

    def decode(model, cache, logits, positions, active, temps, top_ps,
               top_ks, noise):
        safe = torch.where(active, positions, cfg.max_seq_len)
        return _decode_scan(model, cache, logits, safe, active, temps,
                            top_ps, top_ks, noise, attend=attend,
                            chunk=chunk, filtered=filtered,
                            sentinel=cfg.max_seq_len, keep_inactive=False)

    return decode


def _paged_view_len(attend: int, block_size: int) -> int:
    """Gathered-view length for an attend rung: whole blocks covering it."""
    return -(-attend // block_size) * block_size


def make_paged_decode_program(cfg: LlamaConfig, attend: int, chunk: int,
                              block_size: int, filtered: bool):
    """Paged twin of ``make_decode_program``: gather the slots' block tables
    ``bt`` [slots, nblk] into the working view, run the same scan, scatter
    the written window back. Inactive rows pin to the view's length."""
    view_len = _paged_view_len(attend, block_size)

    def decode(model, pool, logits, bt, positions, active, temps, top_ps,
               top_ks, noise):
        view = gather_working_view(pool, bt)
        safe = torch.where(active, positions, view_len)
        toks = _decode_scan(model, view, logits, safe, active, temps,
                            top_ps, top_ks, noise, attend=attend,
                            chunk=chunk, filtered=filtered,
                            sentinel=view_len, keep_inactive=False)
        scatter_working_view(pool, view,
                             write_window_tables(bt, safe, block_size))
        return toks

    return decode


def make_paged_chunk_prefill_program(cfg: LlamaConfig, attend: int,
                                     budget: int, block_size: int):
    """One ``budget``-token prefill chunk against the admitting slot's own
    blocks ``bt_row`` [1, nblk]. Returns None."""
    body = _chunk_prefill_body(cfg, attend, budget)

    def chunk(model, pool, logits, bt_row, toks, start, length, write_slot):
        view = gather_working_view(pool, bt_row)
        body(model, view, logits, torch.zeros_like(start), toks, start,
             length, write_slot)
        scatter_working_view(pool, view,
                             write_window_tables(bt_row, start, block_size))

    return chunk


def make_paged_fused_step_program(cfg: LlamaConfig, attend: int, chunk: int,
                                  budget: int, block_size: int,
                                  filtered: bool):
    """Paged twin of ``make_fused_step_program``: one gather serves the
    admitting slot's chunk and the pool's decode, one scatter commits
    both."""
    body = _chunk_prefill_body(cfg, attend, budget)
    view_len = _paged_view_len(attend, block_size)

    def fused(model, pool, logits, bt, slot, toks, start, length, write_slot,
              positions, active, temps, top_ps, top_ks, noise):
        view = gather_working_view(pool, bt)
        body(model, view, logits, slot, toks, start, length, write_slot)
        safe = torch.where(active, positions, view_len)
        out = _decode_scan(model, view, logits, safe, active, temps,
                           top_ps, top_ks, noise, attend=attend, chunk=chunk,
                           filtered=filtered, sentinel=view_len,
                           keep_inactive=True)
        rows = torch.arange(bt.shape[0], device=bt.device)
        front = torch.where(rows == slot, torch.minimum(safe, start), safe)
        scatter_working_view(pool, view,
                             write_window_tables(bt, front, block_size))
        return out

    return fused


def _verify_math(model, cache, logits, drafts, banned, positions, active,
                 temps, top_ps, top_ks, noise, *, attend: int, k: int,
                 filtered: bool, sentinel: int):
    """One speculative verify of every slot (the reference's
    ``_verify_math``): t1 samples from the carried logits with the slot's
    residual ``banned`` token masked after the warp; one [slots, k+1]
    forward of [t1, drafts] at [front, front+k] writes every token's KV;
    candidate i samples from the logits after token i, and a slot accepts
    the longest run of candidates equal to its drafts (-1 pads never
    match). Active rows carry the logits after their last accepted token;
    inactive rows keep theirs (the fused-step rule). Rejected tokens' KV
    stays past the front, hidden by the causal mask until overwritten: the
    host's position pointer is the only rollback. The k+1 draws read noise
    planes 0..k. Returns [slots, k+2]: the tokens [t1, drafts] and, last,
    the accept length, so one copy brings both to the host."""
    slots = active.shape[0]
    view, lg = cache.head_rows(slots), logits[:slots]
    safe = torch.where(active, positions, sentinel)
    final, greedy = sample_filter(lg, temps, top_ps, top_ks, banned,
                                  filtered=filtered)
    t1 = sample_draw(final, greedy, temps, noise[0])
    toks = torch.cat([t1[:, None], drafts], dim=1)
    grid = safe[:, None] + torch.arange(k + 1, device=safe.device)[None, :]
    out = model(toks, grid, cache=view, attend=attend)   # [slots, k+1, v]
    cand = torch.stack([
        _sample_step(out[:, i], temps, top_ps, top_ks, noise[i + 1],
                     filtered=filtered) for i in range(k)], dim=1)
    accept = (cand == drafts).long().cumprod(dim=1).sum(dim=1)
    sel = out.gather(1, accept[:, None, None].expand(
        slots, 1, out.shape[-1]))[:, 0]
    lg.copy_(torch.where(active[:, None], sel.to(lg.dtype), lg))
    return torch.cat([toks, accept[:, None]], dim=1)


def make_verify_program(cfg: LlamaConfig, attend: int, k: int,
                        filtered: bool):
    """Speculative verify of the whole slot pool in one dispatch (see
    ``_verify_math``); inactive rows pin at the scratch position
    ``max_seq_len``."""

    def verify(model, cache, logits, drafts, banned, positions, active,
               temps, top_ps, top_ks, noise):
        return _verify_math(model, cache, logits, drafts, banned, positions,
                            active, temps, top_ps, top_ks, noise,
                            attend=attend, k=k, filtered=filtered,
                            sentinel=cfg.max_seq_len)

    return verify


def make_fused_verify_program(cfg: LlamaConfig, attend: int, k: int,
                              budget: int, filtered: bool):
    """One prefill chunk of the admitting request + one verify of the
    whole pool in one dispatch; the verify keeps inactive rows' logits, so
    the final chunk's logits survive to seed the slot's first token."""
    body = _chunk_prefill_body(cfg, attend, budget)
    verify = make_verify_program(cfg, attend, k, filtered)

    def fused(model, cache, logits, slot, toks, start, length, write_slot,
              drafts, banned, positions, active, temps, top_ps, top_ks,
              noise):
        body(model, cache, logits, slot, toks, start, length, write_slot)
        return verify(model, cache, logits, drafts, banned, positions,
                      active, temps, top_ps, top_ks, noise)

    return fused


def make_paged_verify_program(cfg: LlamaConfig, attend: int, k: int,
                              block_size: int, filtered: bool):
    """Paged twin of ``make_verify_program``: gather, the same verify with
    inactive rows pinned at the view's length, scatter the window the
    verify wrote ([position, position + k] of each active row)."""
    view_len = _paged_view_len(attend, block_size)

    def verify(model, pool, logits, bt, drafts, banned, positions, active,
               temps, top_ps, top_ks, noise):
        view = gather_working_view(pool, bt)
        out = _verify_math(model, view, logits, drafts, banned, positions,
                           active, temps, top_ps, top_ks, noise,
                           attend=attend, k=k, filtered=filtered,
                           sentinel=view_len)
        front = torch.where(active, positions, view_len)
        scatter_working_view(pool, view,
                             write_window_tables(bt, front, block_size))
        return out

    return verify


def make_paged_fused_verify_program(cfg: LlamaConfig, attend: int, k: int,
                                    budget: int, block_size: int,
                                    filtered: bool):
    """Paged twin of ``make_fused_verify_program``: one gather, the chunk
    body, the verify, one scatter."""
    body = _chunk_prefill_body(cfg, attend, budget)
    view_len = _paged_view_len(attend, block_size)

    def fused(model, pool, logits, bt, slot, toks, start, length, write_slot,
              drafts, banned, positions, active, temps, top_ps, top_ks,
              noise):
        view = gather_working_view(pool, bt)
        body(model, view, logits, slot, toks, start, length, write_slot)
        out = _verify_math(model, view, logits, drafts, banned, positions,
                           active, temps, top_ps, top_ks, noise,
                           attend=attend, k=k, filtered=filtered,
                           sentinel=view_len)
        base = torch.where(active, positions, view_len)
        rows = torch.arange(bt.shape[0], device=bt.device)
        front = torch.where(rows == slot, torch.minimum(base, start), base)
        scatter_working_view(pool, view,
                             write_window_tables(bt, front, block_size))
        return out

    return fused


def _seq_dim(leaf: str) -> int:
    """The position axis of a ``KvCache`` leaf: k/v keep it after the row
    axis, the int8-KV scales keep it last."""
    return 2 if leaf in ("k", "v") else 3


def make_prefix_admit_program(cfg: LlamaConfig, attend: int,
                              suffix_bucket: int):
    """Admission with prefix reuse in one dispatch: the masked row copy
    ``pool[dst, :lp] <- pool[src, :lp]`` over the first ``attend``
    positions (``attend >= lp``: the engine builds it at the rung of
    ``lp + suffix_bucket``), then the suffix forward at positions
    [lp, lp + bucket) against the copied prefix, and the dst row's logits
    of the suffix's last token. ``src``, ``dst``, ``lp`` and ``slen`` are
    device scalars ([1]); the warmup's dst is the scratch row."""
    body = _chunk_prefill_body(cfg, attend, suffix_bucket)

    def admit(model, pool, logits, src, dst, lp, suffix, slen):
        keep = torch.arange(attend, device=lp.device) < lp
        for name, t in pool.leaves().items():
            ax = _seq_dim(name)
            head = t.narrow(ax, 0, attend)
            mask = keep.view([attend if i == ax else 1
                              for i in range(t.dim())])
            head.index_copy_(1, dst, torch.where(
                mask, head.index_select(1, src), head.index_select(1, dst)))
        body(model, pool, logits, dst, suffix, lp, slen, dst)

    return admit


def make_block_copy_program():
    """The COW fork: block ``dst`` <- block ``src`` in every leaf of the
    block pool. ``src`` clips to the real blocks; an out-of-range ``dst``
    (the warmup's pad id) writes the scratch block."""

    def copy(pool, src, dst):
        n = pool.k.shape[1] - 1
        src, dst = src.clamp(0, n - 1), dst.clamp(0, n)
        for t in pool.leaves().values():
            t.index_copy_(1, dst, t.index_select(1, src))

    return copy


def _seg_kv(seg: KvCache, seg_ids, seg_att: int) -> tuple:
    """(pk, pv) [layers, rows, seg_att, kv, d]: the segment rows
    ``seg_ids`` of the segment pool, cut to ``seg_att`` positions."""
    return (seg.k.index_select(1, seg_ids)[:, :, :seg_att],
            seg.v.index_select(1, seg_ids)[:, :, :seg_att])


def make_suffix_admit_program(cfg: LlamaConfig, attend: int, seg_att: int,
                              suffix_bucket: int):
    """Batched admission against shared segments: [g, bucket] suffix
    forwards attending each row's segment (``seg_ids``, live length
    ``plens``) first, into fresh row caches at slot-local positions
    [0, bucket) (global ``plens + i``). Rows with plen 0 (group padding)
    attend nothing of the segment. Returns (last-token logits [g, v], the
    row cache), for ``merge``."""

    def admit(model, seg, toks, seg_ids, plens, slens):
        g = toks.shape[0]
        pk, pv = _seg_kv(seg, seg_ids, seg_att)
        cache = KvCache.zeros(cfg, g, cfg.max_seq_len, device=toks.device)
        local = torch.arange(suffix_bucket, device=toks.device).expand(
            g, suffix_bucket)
        logits_all = model(toks, plens[:, None] + local, cache=cache,
                           attend=attend, prefix=(pk, pv, plens),
                           cache_positions=local)
        idx = (slens - 1)[:, None, None].expand(g, 1, logits_all.shape[-1])
        return logits_all.gather(1, idx)[:, 0], cache

    return admit


def make_prefix_decode_program(cfg: LlamaConfig, attend: int, seg_att: int,
                               chunk: int, filtered: bool):
    """``chunk`` sampling steps for the whole pool where slots may attend a
    shared segment: each row's segment KV (``seg_ids``, ``plens``) is
    gathered once a dispatch, positions are slot-local (the private cache
    holds suffixes only). Rows with plen 0 attend an empty segment.
    Returns the tokens [slots, chunk]."""

    def decode(model, cache, logits, seg, positions, plens, seg_ids, active,
               temps, top_ps, top_ks, noise):
        safe = torch.where(active, positions, cfg.max_seq_len)
        pk, pv = _seg_kv(seg, seg_ids, seg_att)
        return _decode_scan(model, cache, logits, safe, active, temps,
                            top_ps, top_ks, noise, attend=attend,
                            chunk=chunk, filtered=filtered,
                            sentinel=cfg.max_seq_len, keep_inactive=False,
                            prefix=(pk, pv, plens))

    return decode


# -- dispatch -------------------------------------------------------------


def _launch_counters() -> list[dict]:
    """The kernel wrappers' launch counts (a graph replays the launches its
    capture recorded, so the engine adds them per replay)."""
    return [_fa.LAUNCHES, _gm.LAUNCHES]


class _Program:
    """One program at one static shape: static device buffers for its host
    inputs (int64 and f32 packed), and on the card its CUDA graph."""

    def __init__(self, fn: Callable, spec: dict[str, tuple], device):
        self.fn = fn
        self.spec = spec  # name -> (shape, "i" | "f")
        sizes = {kind: sum(int(np.prod(s)) for s, k in spec.values()
                           if k == kind) for kind in "if"}
        self.ibuf = torch.zeros(max(sizes["i"], 1), dtype=torch.int64,
                                device=device)
        self.fbuf = torch.zeros(max(sizes["f"], 1), dtype=torch.float32,
                                device=device)
        self.inputs, off = {}, {"i": 0, "f": 0}
        for name, (shape, kind) in spec.items():
            buf = self.ibuf if kind == "i" else self.fbuf
            n = int(np.prod(shape))
            self.inputs[name] = buf[off[kind]:off[kind] + n].view(shape)
            off[kind] += n
        self.graph = None
        self.out = None
        #: kernel launches one replay makes, per counter
        self.launches: list[dict] = []

    def pack(self, host: dict[str, np.ndarray]) -> tuple[np.ndarray,
                                                         np.ndarray]:
        ints = [np.asarray(host[n], np.int64).ravel()
                for n, (_, k) in self.spec.items() if k == "i"]
        floats = [np.asarray(host[n], np.float32).ravel()
                  for n, (_, k) in self.spec.items() if k == "f"]
        return (np.concatenate(ints) if ints else np.zeros(1, np.int64),
                np.concatenate(floats) if floats
                else np.zeros(1, np.float32))

    def run(self):
        return self.fn(self.inputs)


class _Dispatch:
    """Host side of dispatching programs: staging of inputs, graph capture
    and replay on the card, eager runs on the CPU, token fetches."""

    def __init__(self, device: torch.device, counter: CaptureCounter,
                 ring: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.counter = counter
        self.programs: dict[tuple, _Program] = {}
        self.ring = ring
        self._n = 0
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
            #: per ring entry: (pinned ints, pinned floats, event)
            self._stage: list[list] = [[None, None, None]
                                       for _ in range(ring)]

    def stream_ctx(self):
        return (torch.cuda.stream(self.stream) if self.cuda
                else contextlib.nullcontext())

    def _upload(self, prog: _Program, host: dict) -> None:
        ints, floats = prog.pack(host)
        if not self.cuda:
            prog.ibuf[:ints.size].copy_(torch.from_numpy(ints))
            prog.fbuf[:floats.size].copy_(torch.from_numpy(floats))
            return
        entry = self._stage[self._n % self.ring]
        self._n += 1
        if entry[2] is not None:
            entry[2].synchronize()  # the last copy out of this entry ended
        for j, arr in ((0, ints), (1, floats)):
            if entry[j] is None or entry[j].numel() < arr.size:
                entry[j] = torch.empty(max(arr.size, 256),
                                       dtype=torch.from_numpy(arr).dtype,
                                       pin_memory=True)
            entry[j][:arr.size].numpy()[:] = arr
        prog.ibuf[:ints.size].copy_(entry[0][:ints.size], non_blocking=True)
        prog.fbuf[:floats.size].copy_(entry[1][:floats.size],
                                      non_blocking=True)
        entry[2] = torch.cuda.Event()
        entry[2].record(self.stream)

    def _capture(self, prog: _Program) -> None:
        """Capture ``prog`` as a CUDA graph. Before the counter is armed
        (warmup), the program first runs once eagerly: the warmup's inputs
        target scratch rows and inactive slots, so that run changes no live
        state, and it loads the kernels and cuBLAS's handles before the
        capture. A capture that fails raises."""
        if not self.counter.armed:
            prog.run()
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        # a graph destroyed on this thread during a capture (a dead
        # engine's, freed by the cyclic collector) invalidates the capture:
        # collect now, and hold the collector off until the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                prog.out = prog.run()
        finally:
            if collecting:
                gc.enable()
        # the capture recorded these launches; nothing ran yet
        prog.launches = [{k: c[k] - b[k] for k in c}
                         for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.update(b)
        prog.graph = graph

    @torch.no_grad()
    def run(self, key: tuple, build: Callable[[], tuple[Callable, dict]],
            host: dict):
        """Run the program ``key`` (built by ``build`` -> (fn, spec) at its
        first use, which counts as a capture) on the host inputs ``host``;
        returns its output tensor (None for programs without one)."""
        prog = self.programs.get(key)
        fresh = prog is None
        if fresh:
            fn, spec = build()
            prog = _Program(fn, spec, self.device)
            self.programs[key] = prog
            self.counter.note()
        self._upload(prog, host)
        if not self.cuda:
            return prog.run()
        if fresh:
            self._capture(prog)
        prog.graph.replay()
        for c, delta in zip(_launch_counters(), prog.launches):
            for k, n in delta.items():
                c[k] += n
        return prog.out

    def fetch_start(self, toks, host_out):
        """Start copying a dispatch's tokens to the host; returns the handle
        ``fetch`` waits on."""
        if not self.cuda:
            return toks.numpy().copy(), None
        host_out.copy_(toks, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return host_out, ev

    def close(self) -> None:
        """Free the programs and their graphs (on this thread, now)."""
        self.programs.clear()

    @staticmethod
    def fetch(handle) -> np.ndarray:
        out, ev = handle
        if ev is None:
            return out
        ev.synchronize()
        return out.numpy().copy()


# -- drafts (host only) ---------------------------------------------------


class DraftProposer:
    """Draft-token source for speculative decoding, copied from the
    reference.

    ``propose(history, k)`` returns up to ``k`` guessed continuation tokens
    for a request whose prompt + generated history is ``history`` (host
    ints, the slot's KV ground truth), or ``[]``. Alignment contract: the
    verify always emits the true next token itself (t1, sampled from the
    carried logits), so ``propose`` guesses the ``k`` tokens after it. The
    verifier treats a proposal as a point-mass draft, so any proposer is
    sound: a wrong guess costs verify work, never correctness."""

    def propose(self, history: list[int], k: int) -> list[int]:
        raise NotImplementedError


class NgramProposer(DraftProposer):
    """Prompt-lookup drafts, copied from the reference: match the last
    ``n`` tokens of the history against the history and propose what
    followed the most recent earlier match, scanning at most the trailing
    ``window`` tokens (host numpy, between dispatches)."""

    def __init__(self, n: int = 3, window: int = 4096):
        if n < 1:
            raise ValueError("ngram length must be >= 1")
        if window < 1:
            raise ValueError("lookup window must be >= 1")
        self.n = int(n)
        self.window = int(window)

    @staticmethod
    def _lookup(arr: np.ndarray, n: int, k: int) -> list[int]:
        """Up to ``k`` tokens that followed the most recent earlier
        occurrence of ``arr``'s last-``n`` tail, [] if none."""
        m = len(arr) - n
        if m <= 0 or k <= 0:
            return []
        tail = arr[-n:]
        windows = np.lib.stride_tricks.sliding_window_view(arr, n)[:m]
        hits = np.nonzero((windows == tail).all(axis=1))[0]
        if hits.size == 0:
            return []
        j = int(hits[-1])
        return arr[j + n: j + n + k].astype(int).tolist()

    def propose(self, history: list[int], k: int) -> list[int]:
        n = self.n
        arr = np.asarray(history[-self.window:], np.int64)
        # guess[0] sits at t1's position (the alignment contract): the
        # drafts are the k tokens after it. A match that abuts the tail
        # keeps drafting by matching again on history + the guess so far.
        guess = self._lookup(arr, n, k + 1)
        if not guess:
            return []
        while len(guess) < k + 1:
            more = self._lookup(
                np.concatenate([arr, np.asarray(guess, np.int64)]), n,
                k + 1 - len(guess))
            if not more:
                break
            guess.extend(more)
        return guess[1: k + 1]


#: knob -> (its default, the ROADMAP item that ports it)
_UNPORTED = {
    "host_blocks": (0, "A4(c)"),
    "host_watermark": (0.25, "A4(c)"),
    "admission_policy": (None, "A4(d)"),
    "role": ("mixed", "A4(d)"),
    "mesh_axes": (None, "A7"),
    "program_cache": (None, "A12"),
}


class ContinuousEngine:
    """Slot-pool continuous-batching decode engine over a Llama model.

    ``cfg`` and ``params`` give the model: ``params`` is a ``Llama`` module
    on the engine's device (used as it is, never modified) or a state dict
    for one. ``device``: the CUDA
    card by default (raises without one); ``"cpu"`` runs every program
    eagerly. The other knobs are the reference's (its docstring has their
    full story):

    - ``num_slots``: pool width; ``decode_chunk``: sampling steps a
      dispatch; ``pipeline_depth``: dispatches in flight before the host
      waits for the oldest one's tokens;
    - ``prefill_budget``: 0 = whole-prompt admission; > 0 = chunked
      admission fused into the decode dispatches;
    - ``block_size``: 0 = the slot pool; > 0 = the paged pool of
      ``num_blocks`` blocks (0 = the slot pool's capacity); admission
      reserves a request's whole span (prompt + max_new_tokens) or waits;
    - ``prefix_cache``: reuse KV across requests sharing ``min_prefix``
      tokens or more of a prompt prefix. In the slot pool, with any slot's
      content: an on-device row copy, then the suffix prefill alone (taken
      under ``prefill_budget`` only when the suffix fits one budget). In
      the paged pool, at block granularity with live and retired
      sequences: full blocks shared by refcount, the boundary block forked
      with one copy (COW);
    - ``prefix_segments``/``segment_len``: refcounted immutable segments
      of a shared prefix (slot pool only); ``max_seq_len`` is then the
      slots' suffix capacity;
    - ``spec_k``: 0 = off; > 0 = speculative decoding, up to ``spec_k``
      drafts a slot verified in one dispatch, from an ``NgramProposer`` of
      ``spec_ngram`` tokens or ``draft_proposer``. Greedy tokens equal
      plain decode's. The accept length decides the schedule, so the
      pipeline runs at depth 1 while ``spec_k > 0``; dispatches where no
      slot has a draft (and no residual ban waits) run the plain decode;
      segment-backed slots decode unspeculated;
    - ``temperature``, ``eos_id``, ``seq_buckets``,
      ``default_max_new_tokens`` as in the reference.

    The knobs in ``_UNPORTED`` raise ``NotImplementedError`` when set.
    """

    def __init__(
        self,
        cfg: LlamaConfig,
        params: Any,
        *,
        num_slots: int = 8,
        decode_chunk: int = 1,
        prefill_budget: int = 0,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        seq_buckets: Optional[list[int]] = None,
        default_max_new_tokens: int = 16,
        pipeline_depth: int = 2,
        prefix_cache: bool = True,
        min_prefix: int = 32,
        prefix_segments: int = 0,
        segment_len: int = 0,
        spec_k: int = 0,
        spec_ngram: int = 3,
        draft_proposer: Optional[DraftProposer] = None,
        block_size: int = 0,
        num_blocks: int = 0,
        device=None,
        **unported,
    ):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"unknown ContinuousEngine knob {name!r}")
            default, item = _UNPORTED[name]
            if value != default:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet (ROADMAP {item})")
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if decode_chunk < 1:
            raise ValueError("decode_chunk must be >= 1")
        if prefill_budget < 0:
            raise ValueError("prefill_budget must be >= 0 (0 = off)")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 = off)")
        if spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        if block_size < 0:
            raise ValueError("block_size must be >= 0 (0 = slot pool)")
        if num_blocks < 0:
            raise ValueError("num_blocks must be >= 0 (0 = derived)")
        if block_size > 0 and prefix_segments > 0:
            raise ValueError(
                "prefix_segments is superseded by the paged pool: "
                "block-granular sharing subsumes whole-segment LCP — "
                "drop prefix_segments or set block_size=0")
        if prefix_segments > 0:
            if segment_len <= 0:
                raise ValueError("prefix_segments needs segment_len > 0")
            if segment_len < min_prefix:
                raise ValueError(
                    f"segment_len {segment_len} < min_prefix {min_prefix}:"
                    " every created segment would be unusable")
        if 0 < cfg.max_seq_len <= block_size:
            raise ValueError(
                f"block_size {block_size} must be < max_seq_len "
                f"{cfg.max_seq_len}")
        self.device = resolve_device(device)
        self.cfg = cfg
        if isinstance(params, Llama):
            self.model = params
        else:
            self.model = Llama(cfg, device=self.device)
            self.model.load_state_dict(params, strict=True)
        self.num_slots = num_slots
        self.decode_chunk = decode_chunk
        self.prefill_budget = int(prefill_budget)
        self.prefix_cache = bool(prefix_cache)
        self.min_prefix = int(min_prefix)
        self.prefix_segments = int(prefix_segments)
        self.segment_len = int(segment_len)
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self._proposer = draft_proposer or NgramProposer(self.spec_ngram)
        self.block_size = int(block_size)
        self.paged = self.block_size > 0
        if self.paged and num_blocks == 0:
            num_blocks = num_slots * (-(-cfg.max_seq_len // self.block_size))
        self.num_blocks = int(num_blocks)
        self._alloc = (BlockAllocator(self.num_blocks, self.block_size)
                       if self.paged else None)
        #: optional ``analysis.runtime.BlockLedger`` (attach_block_ledger)
        self.block_ledger = None
        self._slot_blocks: list[list[int]] = [[] for _ in range(num_slots)]
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.default_max_new_tokens = default_max_new_tokens
        self.pipeline_depth = pipeline_depth

        cap = cfg.max_seq_len - 1
        raw = seq_buckets or [
            s for s in (32, 64, 128, 256, 512, 1024, 2048, 4096) if s < cap
        ] + [cap]
        self.seq_buckets = tuple(sorted(
            {int(b) for b in raw if 1 <= int(b) <= cap}))
        if not self.seq_buckets:
            raise ValueError(f"no usable seq bucket <= {cap}")
        #: decode-attention windows: a dispatch attends only over the
        #: smallest rung covering every live position plus its write span
        self.attend_buckets = tuple(
            [b for b in (128, 256, 512, 1024, 2048) if b < cfg.max_seq_len]
            + [cfg.max_seq_len])
        if self.prefix_segments > 0:
            #: the segment pool holds prefixes at segment_len, in the
            #: activation dtype whatever quant_kv says (the prefix feeds the
            #: f32 attention directly; int8 slots still compose)
            self._seg_cfg = dataclasses.replace(
                cfg, max_seq_len=self.segment_len, quant_kv=False)
            self._seg_attends = tuple(
                [b for b in (128, 256, 512, 1024, 2048)
                 if b < self.segment_len] + [self.segment_len])

        #: the slot pool's KV bytes at max_seq_len, scratch not counted
        self.kv_pool_bytes = sum(
            int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
            for shape, dt in cache_shapes(cfg, num_slots).values())
        self._captures = CaptureCounter()
        self._dispatch = _Dispatch(self.device, self._captures,
                                   ring=pipeline_depth + 1)
        self._init_pool()

        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._waiting: list[Request] = []
        self._slots: list[Optional[Request]] = [None] * num_slots
        #: tokens whose KV each slot holds at positions [0, len)
        self._slot_content: list[list[int]] = [[] for _ in range(num_slots)]
        #: the request whose tokens may still append to a slot's record
        self._slot_owner: list[Optional[Request]] = [None] * num_slots
        self._active = np.zeros(num_slots, dtype=bool)
        self._positions = np.zeros(num_slots, dtype=np.int64)
        self._remaining = np.zeros(num_slots, dtype=np.int64)
        self._temps = np.zeros(num_slots, dtype=np.float32)
        self._top_ps = np.ones(num_slots, dtype=np.float32)
        self._top_ks = np.zeros(num_slots, dtype=np.int64)
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        #: shared-prefix segments: each row's tokens (empty = free), its
        #: live references and last use; each slot's segment and prefix
        #: length (0 = a plain slot)
        self._seg_content: list[list[int]] = [
            [] for _ in range(self.prefix_segments)]
        self._seg_refs = np.zeros(max(self.prefix_segments, 1), np.int64)
        self._seg_used = np.zeros(max(self.prefix_segments, 1), np.float64)
        self._slot_plen = np.zeros(num_slots, np.int64)
        self._slot_seg = np.zeros(num_slots, np.int64)
        self.segment_hits = 0
        self.segment_tokens_shared = 0
        self.segment_evictions = 0
        #: segments planned into this admission cycle's batched suffix
        #: prefill: not evictable until it is dispatched
        self._seg_reserved: set[int] = set()
        #: speculation: each slot's residual ban (the draft the last verify
        #: rejected at its front, -1 = none), and the zero-accept backoff
        #: (a slot whose real drafts all failed sits out a cooldown that
        #: doubles from 2 to 32 dispatches; any accept resets it)
        self._spec_ban = np.full(num_slots, -1, dtype=np.int64)
        self._spec_backoff = np.zeros(num_slots, dtype=np.int64)
        self._spec_cool = np.zeros(num_slots, dtype=np.int64)
        self.spec_tokens_proposed_total = 0
        self.spec_tokens_accepted_total = 0
        self.spec_dispatches_total = 0
        #: chunked admission: [req, slot, prompt, next_offset] entries whose
        #: slot is reserved but not yet active
        self._prefilling: "deque[list]" = deque()
        #: (group, bucket) admission shapes known captured, whole-prompt
        #: and segment-suffix
        self._warm_plain: set = set()
        self._warm_seg: set = set()
        self._prefill_tokens_inflight = 0
        self.prefill_chunks_dispatched = 0
        self.decode_stall_ms_total = 0.0
        self.step_counter = 0
        self.tokens_emitted = 0
        self.tokens_discarded = 0
        self._error: Optional[Exception] = None
        self._stop = threading.Event()
        self._gate = threading.Lock()
        self._wake = threading.Event()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int.from_bytes(os.urandom(4), "little"))
        self._thread: Optional[threading.Thread] = None

    def _init_pool(self) -> None:
        cfg, dev = self.cfg, self.device
        if self.paged:
            # rows = blocks (plus the scratch block), seq = block_size
            self._pool = KvCache.zeros(cfg, self.num_blocks + 1,
                                       self.block_size, device=dev,
                                       scratch=0)
        else:
            self._pool = KvCache.zeros(cfg, self.num_slots + 1,
                                       cfg.max_seq_len, device=dev)
        self._pool_logits = torch.zeros(self.num_slots + 1, cfg.vocab_size,
                                        dtype=cfg.dtype, device=dev)
        if self.prefix_segments > 0:
            # one scratch row past the segments, for the warmup's writes
            self._seg = KvCache.zeros(self._seg_cfg, self.prefix_segments + 1,
                                      self.segment_len, device=dev)
        #: the uniform noise of one dispatch's draws (a verify draws
        #: spec_k + 1 times), filled only when a slot samples
        self._noise = torch.zeros(max(self.decode_chunk, self.spec_k + 1),
                                  self.num_slots, cfg.vocab_size, device=dev)
        #: pinned host buffers for dispatches' tokens (a verify's: its
        #: spec_k + 1 tokens and the accept length), one per dispatch in
        #: flight; flat, so each dispatch's view is contiguous
        width = max(self.decode_chunk, self.spec_k + 2 if self.spec_k else 0)
        self._out_ring = [
            torch.zeros(self.num_slots * width, dtype=torch.int64,
                        pin_memory=self._dispatch.cuda)
            for _ in range(self.pipeline_depth + 1)]
        self._out_n = 0
        if self._dispatch.cuda:
            torch.cuda.synchronize(dev)

    def _ensure_running(self) -> None:
        if self._thread is None:
            self._captures.armed = True
            self._thread = threading.Thread(
                target=self._loop, name="continuous-engine", daemon=True)
            self._thread.start()

    # -- programs ------------------------------------------------------------

    def _rung(self, needed: int) -> int:
        return next((b for b in self.attend_buckets if b >= needed),
                    self.cfg.max_seq_len)

    def _decode_spec(self) -> dict:
        s = self.num_slots
        return {"positions": ((s,), "i"), "active": ((s,), "i"),
                "temps": ((s,), "f"), "top_ps": ((s,), "f"),
                "top_ks": ((s,), "i")}

    def _chunk_spec(self, budget: int, slot: bool = True) -> dict:
        spec = {"toks": ((budget,), "i"), "start": ((1,), "i"),
                "length": ((1,), "i"), "write_slot": ((1,), "i")}
        if slot:
            spec["slot"] = ((1,), "i")
        return spec

    def _decode_args(self, v: dict) -> tuple:
        return (v["positions"], v["active"].bool(), v["temps"], v["top_ps"],
                v["top_ks"], self._noise)

    @staticmethod
    def _chunk_args(v: dict) -> tuple:
        return v["toks"], v["start"], v["length"], v["write_slot"]

    def _host_decode(self) -> dict:
        return {"positions": self._positions.copy(),
                "active": self._active.copy(), "temps": self._temps.copy(),
                "top_ps": self._top_ps.copy(), "top_ks": self._top_ks.copy()}

    def _idle_decode(self, sentinel: int) -> dict:
        s = self.num_slots
        return {"positions": np.full(s, sentinel), "active": np.zeros(s),
                "temps": np.zeros(s), "top_ps": np.ones(s),
                "top_ks": np.zeros(s)}

    def _filtered(self) -> bool:
        """The reference's ``lax.cond`` predicate, decided on the host:
        does any slot set top-k or top-p?"""
        return bool(((self._top_ks > 0) | (self._top_ps < 1.0)).any())

    def _run_admit(self, g: int, bucket: int, host: dict) -> None:
        cfg, m = self.cfg, self.model
        prefill = make_prefill_program(cfg, self._rung(bucket))

        def build():
            def fn(v):
                row_logits, rows = prefill(m, v["prompt"], v["lengths"])
                merge(self._pool, self._pool_logits, rows, row_logits,
                      v["slots"])
            return fn, {"prompt": ((g, bucket), "i"),
                        "lengths": ((g,), "i"), "slots": ((g,), "i")}

        self._dispatch.run(("admit", g, bucket), build, host)

    def _run_decode(self, attend: int, filtered: bool, host: dict):
        cfg, m = self.cfg, self.model
        if self.paged:
            nblk = -(-attend // self.block_size)
            prog = make_paged_decode_program(cfg, attend, self.decode_chunk,
                                             self.block_size, filtered)

            def build():
                return (lambda v: prog(m, self._pool, self._pool_logits,
                                       v["bt"], *self._decode_args(v)),
                        {"bt": ((self.num_slots, nblk), "i"),
                         **self._decode_spec()})
            key = ("paged_decode", attend, filtered)
        else:
            prog = make_decode_program(cfg, attend, self.decode_chunk,
                                       filtered)

            def build():
                return (lambda v: prog(m, self._pool, self._pool_logits,
                                       *self._decode_args(v)),
                        self._decode_spec())
            key = ("decode", attend, filtered)
        return self._dispatch.run(key, build, host)

    def _run_fused(self, attend: int, filtered: bool, host: dict):
        cfg, m, b = self.cfg, self.model, self.prefill_budget
        if self.paged:
            nblk = -(-attend // self.block_size)
            prog = make_paged_fused_step_program(
                cfg, attend, self.decode_chunk, b, self.block_size, filtered)

            def build():
                return (lambda v: prog(m, self._pool, self._pool_logits,
                                       v["bt"], v["slot"],
                                       *self._chunk_args(v),
                                       *self._decode_args(v)),
                        {"bt": ((self.num_slots, nblk), "i"),
                         **self._chunk_spec(b), **self._decode_spec()})
            key = ("paged_fused", attend, filtered)
        else:
            prog = make_fused_step_program(cfg, attend, self.decode_chunk, b,
                                           filtered)

            def build():
                return (lambda v: prog(m, self._pool, self._pool_logits,
                                       v["slot"], *self._chunk_args(v),
                                       *self._decode_args(v)),
                        {**self._chunk_spec(b), **self._decode_spec()})
            key = ("fused", attend, filtered)
        return self._dispatch.run(key, build, host)

    def _run_chunk(self, attend: int, budget: int, host: dict) -> None:
        cfg, m = self.cfg, self.model
        if self.paged:
            nblk = -(-attend // self.block_size)
            prog = make_paged_chunk_prefill_program(cfg, attend, budget,
                                                    self.block_size)

            def build():
                return (lambda v: prog(m, self._pool, self._pool_logits,
                                       v["bt"], *self._chunk_args(v)),
                        {"bt": ((1, nblk), "i"),
                         **self._chunk_spec(budget, slot=False)})
            key = ("paged_chunk", attend, budget)
        else:
            prog = make_chunk_prefill_program(cfg, attend, budget)

            def build():
                return (lambda v: prog(m, self._pool, self._pool_logits,
                                       v["slot"], *self._chunk_args(v)),
                        self._chunk_spec(budget))
            key = ("chunk", attend)
        self._dispatch.run(key, build, host)

    def _verify_spec(self) -> dict:
        s = self.num_slots
        return {"drafts": ((s, self.spec_k), "i"), "banned": ((s,), "i")}

    def _run_verify(self, attend: int, filtered: bool, host: dict):
        cfg, m, k = self.cfg, self.model, self.spec_k
        if self.paged:
            nblk = -(-attend // self.block_size)
            prog = make_paged_verify_program(cfg, attend, k, self.block_size,
                                             filtered)

            def build():
                return (lambda v: prog(m, self._pool, self._pool_logits,
                                       v["bt"], v["drafts"], v["banned"],
                                       *self._decode_args(v)),
                        {"bt": ((self.num_slots, nblk), "i"),
                         **self._verify_spec(), **self._decode_spec()})
            key = ("paged_verify", attend, filtered)
        else:
            prog = make_verify_program(cfg, attend, k, filtered)

            def build():
                return (lambda v: prog(m, self._pool, self._pool_logits,
                                       v["drafts"], v["banned"],
                                       *self._decode_args(v)),
                        {**self._verify_spec(), **self._decode_spec()})
            key = ("verify", attend, filtered)
        return self._dispatch.run(key, build, host)

    def _run_fused_verify(self, attend: int, filtered: bool, host: dict):
        cfg, m, k, b = self.cfg, self.model, self.spec_k, self.prefill_budget
        if self.paged:
            nblk = -(-attend // self.block_size)
            prog = make_paged_fused_verify_program(
                cfg, attend, k, b, self.block_size, filtered)

            def build():
                return (lambda v: prog(m, self._pool, self._pool_logits,
                                       v["bt"], v["slot"],
                                       *self._chunk_args(v), v["drafts"],
                                       v["banned"], *self._decode_args(v)),
                        {"bt": ((self.num_slots, nblk), "i"),
                         **self._chunk_spec(b), **self._verify_spec(),
                         **self._decode_spec()})
            key = ("paged_fused_verify", attend, filtered)
        else:
            prog = make_fused_verify_program(cfg, attend, k, b, filtered)

            def build():
                return (lambda v: prog(m, self._pool, self._pool_logits,
                                       v["slot"], *self._chunk_args(v),
                                       v["drafts"], v["banned"],
                                       *self._decode_args(v)),
                        {**self._chunk_spec(b), **self._verify_spec(),
                         **self._decode_spec()})
            key = ("fused_verify", attend, filtered)
        return self._dispatch.run(key, build, host)

    def _run_prefix_admit(self, attend: int, bucket: int, host: dict) -> None:
        m = self.model
        prog = make_prefix_admit_program(self.cfg, attend, bucket)

        def build():
            return (lambda v: prog(m, self._pool, self._pool_logits,
                                   v["src"], v["dst"], v["lp"], v["suffix"],
                                   v["slen"]),
                    {"src": ((1,), "i"), "dst": ((1,), "i"),
                     "lp": ((1,), "i"), "suffix": ((bucket,), "i"),
                     "slen": ((1,), "i")})

        self._dispatch.run(("prefix_admit", attend, bucket), build, host)

    def _run_block_copy(self, src: int, dst: int) -> None:
        copy = make_block_copy_program()

        def build():
            return (lambda v: copy(self._pool, v["src"], v["dst"]),
                    {"src": ((1,), "i"), "dst": ((1,), "i")})

        self._dispatch.run(("block_copy",), build,
                           {"src": [src], "dst": [dst]})

    def _seg_rung(self, needed: int) -> int:
        return next(x for x in self._seg_attends if x >= needed)

    def _run_seg_prefill(self, bucket: int, host: dict) -> None:
        """Prefill one segment row (``toks`` [1, bucket], ``length``) into
        the segment pool at ``row``."""
        m = self.model
        prefill = make_prefill_program(self._seg_cfg, bucket)

        def build():
            def fn(v):
                _, rows = prefill(m, v["toks"], v["length"])
                self._seg.put_rows(v["row"], rows)
            return fn, {"toks": ((1, bucket), "i"), "length": ((1,), "i"),
                        "row": ((1,), "i")}

        self._dispatch.run(("seg_prefill", bucket), build, host)

    def _run_seg_admit(self, g: int, attend: int, seg_att: int, bucket: int,
                       host: dict) -> None:
        m = self.model
        admit = make_suffix_admit_program(self.cfg, attend, seg_att, bucket)

        def build():
            def fn(v):
                row_logits, rows = admit(m, self._seg, v["toks"],
                                         v["seg_ids"], v["plens"],
                                         v["slens"])
                merge(self._pool, self._pool_logits, rows, row_logits,
                      v["slots"])
            return fn, {"toks": ((g, bucket), "i"), "seg_ids": ((g,), "i"),
                        "plens": ((g,), "i"), "slens": ((g,), "i"),
                        "slots": ((g,), "i")}

        self._dispatch.run(("seg_admit", g, attend, seg_att, bucket), build,
                           host)

    def _run_prefix_decode(self, attend: int, seg_att: int, filtered: bool,
                           host: dict):
        m, s = self.model, self.num_slots
        prog = make_prefix_decode_program(self.cfg, attend, seg_att,
                                          self.decode_chunk, filtered)

        def build():
            return (lambda v: prog(m, self._pool, self._pool_logits,
                                   self._seg, v["positions"], v["plens"],
                                   v["seg_ids"], *self._decode_args(v)[1:]),
                    {**self._decode_spec(), "plens": ((s,), "i"),
                     "seg_ids": ((s,), "i")})

        return self._dispatch.run(("prefix_decode", attend, seg_att,
                                   filtered), build, host)

    def _draw_noise(self) -> None:
        """Fill the draw's noise when an active slot samples (greedy slots
        never read it)."""
        if bool((self._temps[self._active] > 0).any()):
            torch.rand(self._noise.shape, generator=self._gen,
                       device=self.device, out=self._noise)

    def _fetch_start(self, toks):
        flat = self._out_ring[self._out_n % len(self._out_ring)]
        self._out_n += 1
        host = flat[:toks.numel()].view(toks.shape)
        return self._dispatch.fetch_start(toks, host)

    # -- public API ----------------------------------------------------------

    def warmup(self, groups: Optional[list[tuple[int, int]]] = None) -> None:
        """Capture the programs the given (admission group, prompt bucket)
        shapes need: the whole-prompt prefill and merge of each, and the
        decode (and with chunked admission the chunk and fused) programs of
        every attend rung they reach, both sampling variants. Every warmup
        dispatch targets the scratch row or inactive slots, so pool state is
        untouched. Default groups: sizes 1 and ``num_slots`` at the smallest
        bucket. Arms the capture counter. Must run before the first
        ``submit``."""
        with self._gate:
            if self._thread is not None:
                raise RuntimeError(
                    "warmup() must run before the first submit(): the "
                    "scheduler thread owns the pool once traffic starts")
            with self._dispatch.stream_ctx():
                self._warmup_locked(groups)
            if self._dispatch.cuda:
                torch.cuda.synchronize(self.device)
            self._captures.armed = True

    def _warmup_locked(self, groups) -> None:
        if groups is None:
            groups = [(1, self.seq_buckets[0]),
                      (self.num_slots, self.seq_buckets[0])]
        if self.paged:
            self._warmup_paged(groups)
            return
        sentinel, sb = self.num_slots, self.seq_buckets[0]
        warm_attends = set()
        for g, bucket in groups:
            bucket = next(b for b in self.seq_buckets if b >= bucket)
            if self.prefill_budget == 0:
                self._run_admit(g, bucket, {
                    "prompt": np.zeros((g, bucket)), "lengths": np.ones(g),
                    "slots": np.full(g, sentinel)})
                self._warm_plain.add((g, bucket))
            warm_attends.add(bucket + self.decode_chunk)
        idle = self._idle_decode(self.cfg.max_seq_len)
        for needed in sorted(warm_attends):
            for filtered in (False, True):
                self._run_decode(self._rung(needed), filtered, idle)
        chunk = {"toks": np.zeros(self.prefill_budget), "start": [0],
                 "length": [1], "write_slot": [sentinel], "slot": [sentinel]}
        if self.prefill_budget > 0 and warm_attends:
            cover = self._rung(max(warm_attends))
            for attend in [a for a in self.attend_buckets if a <= cover]:
                self._run_chunk(attend, self.prefill_budget, chunk)
                for filtered in (False, True):
                    self._run_fused(attend, filtered, {**chunk, **idle})
        if self.spec_k > 0 and warm_attends:
            # a verify reads front + spec_k + 1, so it climbs the attend
            # ladder ahead of the decode: every rung up to what the warmed
            # buckets imply, both sampling variants
            cover = self._rung(max(warm_attends) - self.decode_chunk
                               + self.spec_k + 1)
            spec = {**idle, **self._idle_verify()}
            for attend in [a for a in self.attend_buckets if a <= cover]:
                for filtered in (False, True):
                    self._run_verify(attend, filtered, spec)
                    if self.prefill_budget > 0:
                        self._run_fused_verify(attend, filtered,
                                               {**chunk, **spec})
        if self.prefix_segments > 0:
            # the segment path: creation prefill at every segment rung, the
            # batched suffix admission at group sizes 1 and num_slots, the
            # segment decode; every write goes to a scratch row
            s = self.num_slots
            for sa in self._seg_attends:
                self._run_seg_prefill(sa, {"toks": np.zeros((1, sa)),
                                           "length": [1],
                                           "row": [self.prefix_segments]})
                for g in sorted({1, s}):
                    self._run_seg_admit(g, self._rung(sb), sa, sb, {
                        "toks": np.zeros((g, sb)), "seg_ids": np.zeros(g),
                        "plens": np.full(g, sa), "slens": np.ones(g),
                        "slots": np.full(g, sentinel)})
                    self._warm_seg.add((g, sb))
                for filtered in (False, True):
                    self._run_prefix_decode(
                        self._rung(sb + self.decode_chunk), sa, filtered,
                        {**idle, "plens": np.zeros(s),
                         "seg_ids": np.zeros(s)})
        if self.prefix_cache:
            # a prompt of any length L <= bucket admits by prefix with
            # total (L - 1) + the suffix bucket: every rung up to that
            totals = set()
            for _, bucket in groups:
                b = next(x for x in self.seq_buckets if x >= bucket)
                cover = self._rung(b - 1 + sb)
                totals.update(a for a in self.attend_buckets if a <= cover)
            for attend in sorted(totals):
                self._run_prefix_admit(attend, sb, {
                    "src": [sentinel], "dst": [sentinel], "lp": [1],
                    "suffix": np.zeros(sb), "slen": [1]})

    def _idle_verify(self) -> dict:
        s = self.num_slots
        return {"drafts": np.full((s, self.spec_k), -1),
                "banned": np.full(s, -1)}

    def _warmup_paged(self, groups) -> None:
        buckets = [next(b for b in self.seq_buckets if b >= bucket)
                   for _, bucket in groups]
        if not buckets:
            return
        top = max(buckets) + self.decode_chunk
        if self.spec_k > 0:
            top = max(top, max(buckets) + self.spec_k + 1)
        cover = self._rung(top)
        pad, sent = self._alloc.pad_block, self.num_slots
        for a in [x for x in self.attend_buckets if x <= cover]:
            nblk = -(-a // self.block_size)
            bt = np.full((self.num_slots, nblk), pad)
            idle = {"bt": bt, **self._idle_decode(0)}
            chunk = {"toks": np.zeros(self.prefill_budget), "start": [0],
                     "length": [1], "write_slot": [sent]}
            for filtered in (False, True):
                self._run_decode(a, filtered, idle)
            if self.prefill_budget > 0:
                self._run_chunk(a, self.prefill_budget,
                                {**chunk, "bt": np.full((1, nblk), pad)})
                for filtered in (False, True):
                    self._run_fused(a, filtered,
                                    {**chunk, **idle, "slot": [sent]})
            if self.spec_k > 0:
                spec = {**idle, **self._idle_verify()}
                for filtered in (False, True):
                    self._run_verify(a, filtered, spec)
                    if self.prefill_budget > 0:
                        self._run_fused_verify(
                            a, filtered, {**chunk, **spec, "slot": [sent]})
        if self.prefill_budget == 0:
            # monolithic paged admission: one chunk covers the prompt,
            # programs keyed (rung, bucket)
            chunks = {(self._rung(b), b) for b in self.seq_buckets
                      if b <= cover}
            if self.prefix_cache:
                # a prefix hit prefills its suffix from deep in the prompt:
                # the smallest bucket at every rung a warmed prompt reaches
                # (the reference compiles these at first use, which here
                # would be a capture while serving)
                sb = self.seq_buckets[0]
                deep = self._rung(max(buckets) - 1 + sb)
                chunks |= {(a, sb) for a in self.attend_buckets if a <= deep}
            for a, bucket in sorted(chunks):
                self._run_chunk(a, bucket, {
                    "bt": np.full((1, -(-a // self.block_size)), pad),
                    "toks": np.zeros(bucket), "start": [0], "length": [1],
                    "write_slot": [sent]})
        if self.prefix_cache:
            # the COW fork (dst = the pad id: the scratch block)
            self._run_block_copy(0, pad)

    def submit(self, prompt: list[int], max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None, top_k: Optional[int] = None,
               priority: Optional[int] = None) -> Request:
        req = Request(
            prompt=list(map(int, prompt)),
            max_new_tokens=int(
                self.default_max_new_tokens
                if max_new_tokens is None else max_new_tokens),
            temperature=(None if temperature is None else float(temperature)),
            top_p=(None if top_p is None else float(top_p)),
            top_k=(None if top_k is None else int(top_k)),
            priority=(1 if priority is None else int(priority)),
        )
        req.submitted_step = self.step_counter
        with self._gate:
            if self._error is not None:
                raise RuntimeError(
                    f"engine failed: {self._error!r}") from self._error
            if self._stop.is_set():
                raise RuntimeError("engine is shutting down")
            self._queue.put(req)
            self._ensure_running()
        self._wake.set()
        return req

    def generate(self, prompt: list[int],
                 max_new_tokens: Optional[int] = None,
                 timeout: float = 120.0,
                 temperature: Optional[float] = None,
                 top_p: Optional[float] = None,
                 top_k: Optional[int] = None) -> list[int]:
        return self.submit(prompt, max_new_tokens, temperature,
                           top_p=top_p, top_k=top_k).wait(timeout)

    def stats(self) -> dict:
        """Engine observability snapshot."""
        if self.paged:
            paged = {
                **self._alloc.stats(),
                "kv_blocks_leaked_total": (
                    self.block_ledger.leaked_total
                    if self.block_ledger is not None else 0),
            }
        else:
            paged = {"kv_block_size": 0, "kv_blocks_total": 0,
                     "kv_blocks_free": 0, "kv_blocks_cow_copies_total": 0,
                     "prefix_block_hits_total": 0,
                     "kv_blocks_leaked_total": 0}
        return {
            **paged,
            "slots_capacity": self.num_slots,
            "slots_live": int(self._active.sum()),
            "queue_depth": len(self._waiting) + self._queue.qsize(),
            "decode_steps": self.step_counter,
            "tokens_emitted": self.tokens_emitted,
            "tokens_discarded": self.tokens_discarded,
            "prefill_budget": self.prefill_budget,
            "prefill_chunks_dispatched": self.prefill_chunks_dispatched,
            "prefill_tokens_inflight": self._prefill_tokens_inflight,
            "decode_stall_ms_total": round(self.decode_stall_ms_total, 3),
            # speculative decoding: drafts offered and accepted, and the
            # dispatches that verified
            "spec_tokens_proposed_total": self.spec_tokens_proposed_total,
            "spec_tokens_accepted_total": self.spec_tokens_accepted_total,
            "spec_dispatches_total": self.spec_dispatches_total,
            "spec_acceptance_rate": round(
                self.spec_tokens_accepted_total
                / max(self.spec_tokens_proposed_total, 1), 4),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "segments_capacity": self.prefix_segments,
            "segments_live": sum(1 for c in self._seg_content if c),
            "segment_hits": self.segment_hits,
            "segment_tokens_shared": self.segment_tokens_shared,
            "segment_evictions": self.segment_evictions,
            # captures after warmup stall every live request: must stay 0
            "graph_captures_total": self._captures.count,
            "graph_captures_warmup": self._captures.warmup,
            # the slot pool's KV at max_seq_len (what num_blocks=0 buys)
            "kv_pool_bytes": self.kv_pool_bytes,
            "kv_pool_bytes_allocated": self._pool.nbytes,
        }

    def stop(self) -> None:
        with self._gate:
            self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = RuntimeError("engine shut down")
            req.done.set()
        for req in [*self._waiting, *self._slots]:
            if req is not None and not req.done.is_set():
                req.error = RuntimeError("engine shut down")
                req.done.set()
        self._waiting.clear()
        if self._thread is None or not self._thread.is_alive():
            self._dispatch.close()
        if self.block_ledger is not None and self._alloc is not None:
            self._audit_blocks_now()

    # -- block-ledger audit --------------------------------------------------

    def attach_block_ledger(self, ledger) -> None:
        """Wrap this engine's ``BlockAllocator`` with a ``BlockLedger``
        (``analysis/runtime.py``): every alloc/ref/release is
        conservation-checked, the scheduler audits the zero-leaked-blocks
        invariant whenever the pool goes idle, and ``stats()`` exports
        ``kv_blocks_leaked_total``. Attach before traffic."""
        if not self.paged:
            raise RuntimeError(
                "block ledger requires the paged pool (block_size > 0)")
        ledger.attach(self._alloc)
        self.block_ledger = ledger

    def audit_blocks(self) -> list:
        """Zero-leak audit; leak records (empty = the invariant holds).
        Runs only on a stopped engine or before traffic, where no
        scheduler thread can be mid-mutation."""
        if self.block_ledger is None:
            return []
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("audit_blocks() needs a stopped engine")
        return self._audit_blocks_now()

    def _held_blocks(self) -> list[int]:
        held: list[int] = []
        for slot, blocks in enumerate(self._slot_blocks):
            if blocks and self._slots[slot] is not None:
                held.extend(blocks)
        return held

    def _audit_blocks_now(self) -> list:
        if self.block_ledger is None or self._alloc is None:
            return []
        return self.block_ledger.audit_quiesced(
            self._alloc, held=self._held_blocks())

    # -- scheduler: admission ------------------------------------------------

    def _admit(self) -> None:
        """Move queued requests into free slots (between dispatches).
        Whole-prompt admissions are batched: one prefill and merge per
        prompt bucket."""
        while True:
            try:
                self._waiting.append(self._queue.get_nowait())
            except queue.Empty:
                break
        self._waiting = [r for r in self._waiting
                         if not r.cancelled.is_set()]
        self._waiting.sort(key=lambda r: r.priority)
        free = [i for i, r in enumerate(self._slots) if r is None]
        taken: list[tuple[Request, int]] = []
        plans: list[tuple] = []
        deferred: list[Request] = []
        while free and self._waiting:
            req = self._waiting.pop(0)
            if req.max_new_tokens >= self.cfg.max_seq_len:
                req.max_new_tokens = self.cfg.max_seq_len - 1
            if not req.prompt:
                req.done.set()  # empty prompt -> empty continuation
                continue
            if self.paged:
                plan = self._plan_paged(req)
                if plan is None:
                    if not req.done.is_set():
                        deferred.append(req)  # wait for blocks
                    continue
                plans.append(plan)
            slot = free.pop(0)
            self._slots[slot] = req
            taken.append((req, slot))
        if deferred:
            self._waiting = deferred + self._waiting
        if not taken:
            return
        if self.paged:
            self._admit_paged(taken, plans)
            return
        stall_t0 = time.perf_counter()
        had_live = bool(self._active.any())
        dispatched = False
        # the segment route sees the whole prompt (a suffix-slot pool's
        # truncation is what segments exist to avoid); then the prefix
        # cache: a prompt sharing >= min_prefix tokens with some slot's KV
        # admits by a row copy and the suffix prefill (src == dst is the
        # conversation that continues)
        grouped = []
        seg_groups: dict[int, list] = {}
        for req, slot in taken:
            if self.prefix_segments > 0:
                try:
                    plan = self._plan_segment(req)
                except Exception as e:  # noqa: BLE001 — fail this request
                    req.error = e
                    req.done.set()
                    continue
                if plan is not None:
                    seg, blen, suffix = plan
                    bucket = next(b for b in self.seq_buckets
                                  if b >= len(suffix))
                    seg_groups.setdefault(bucket, []).append(
                        (req, slot, seg, blen, suffix))
                    continue
            cap = min(self.seq_buckets[-1],
                      self.cfg.max_seq_len - req.max_new_tokens)
            prompt = req.prompt[-cap:]
            src, lp = (self._best_prefix(prompt) if self.prefix_cache
                       else (-1, 0))
            # under chunked admission the prefix route is taken only when
            # its one suffix prefill fits the per-dispatch budget
            if (src < 0 or lp < self.min_prefix
                    or (self.prefill_budget > 0
                        and len(prompt) - lp > self.prefill_budget)):
                grouped.append((req, prompt, slot))
                continue
            try:
                self._admit_with_prefix(req, prompt, slot, src, lp)
                dispatched = True
            except Exception as e:  # noqa: BLE001 — fail this request only
                req.error = e
                req.done.set()
        # one batched suffix prefill and merge per bucket; pad rows carry
        # plen 0 and the scratch slot
        for bucket, members in seg_groups.items():
            g = self._pad_group(len(members), bucket, self._warm_seg)
            toks = np.zeros((g, bucket), np.int64)
            seg_ids = np.zeros(g, np.int64)
            plens = np.zeros(g, np.int64)
            slens = np.ones(g, np.int64)
            slots = np.full(g, self.num_slots, np.int64)
            for j, (req, slot, seg, blen, suffix) in enumerate(members):
                toks[j, :len(suffix)] = suffix
                seg_ids[j], plens[j], slens[j] = seg, blen, len(suffix)
                slots[j] = slot
            try:
                self._run_seg_admit(
                    g, self._rung(bucket), self._seg_rung(int(plens.max())),
                    bucket, {"toks": toks, "seg_ids": seg_ids,
                             "plens": plens, "slens": slens, "slots": slots})
            except Exception as e:  # noqa: BLE001 — fail this group only
                for req, *_ in members:
                    req.error = e
                    req.done.set()
                continue
            for req, slot, seg, blen, suffix in members:
                self._occupy(req, req.prompt, slot, plen=blen, seg=seg,
                             local_len=len(suffix))
            dispatched = True
        self._seg_reserved.clear()
        if self.prefill_budget > 0:
            for req, prompt, slot in grouped:
                self._slot_content[slot] = []
                self._slot_owner[slot] = None
                self._prefilling.append([req, slot, list(prompt), 0])
                self._prefill_tokens_inflight += len(prompt)
            if had_live and dispatched:
                self.decode_stall_ms_total += (
                    time.perf_counter() - stall_t0) * 1e3
            return
        groups: dict[int, list] = {}
        for req, prompt, slot in grouped:
            bucket = next(b for b in self.seq_buckets if b >= len(prompt))
            groups.setdefault(bucket, []).append((req, prompt, slot))
        for bucket, members in groups.items():
            g = self._pad_group(len(members), bucket, self._warm_plain)
            toks = np.zeros((g, bucket), np.int64)
            lengths = np.ones(g, np.int64)
            slots = np.full(g, self.num_slots, np.int64)
            for j, (req, prompt, slot) in enumerate(members):
                toks[j, :len(prompt)] = prompt
                lengths[j] = len(prompt)
                slots[j] = slot
            try:
                self._run_admit(g, bucket, {"prompt": toks,
                                            "lengths": lengths,
                                            "slots": slots})
            except Exception as e:  # noqa: BLE001 — fail this group only
                for req, _, slot in members:
                    req.error = e
                    req.done.set()
                continue
            for req, prompt, slot in members:
                self._occupy(req, prompt, slot)
            dispatched = True
        if had_live and dispatched:
            self.decode_stall_ms_total += (
                time.perf_counter() - stall_t0) * 1e3

    def _best_prefix(self, prompt: list[int]) -> tuple[int, int]:
        """(src slot, lp): the longest prefix of ``prompt`` some slot's KV
        holds, capped at len(prompt) - 1 (one suffix token must run for
        the next-token logits)."""
        best_slot, best_lp = -1, 0
        cap = len(prompt) - 1
        p = np.asarray(prompt, np.int64)
        for s, content in enumerate(self._slot_content):
            if min(len(content), cap) <= best_lp:
                continue
            n = lcp(content, p, cap)
            if n > best_lp:
                best_slot, best_lp = s, n
        return best_slot, best_lp

    def _admit_with_prefix(self, req: Request, prompt: list[int], slot: int,
                           src: int, lp: int) -> None:
        suffix = prompt[lp:]
        bucket = next(b for b in self.seq_buckets if b >= len(suffix))
        toks = np.zeros(bucket, np.int64)
        toks[:len(suffix)] = suffix
        self._run_prefix_admit(self._rung(lp + bucket), bucket, {
            "src": [src], "dst": [slot], "lp": [lp], "suffix": toks,
            "slen": [len(suffix)]})
        self._occupy(req, prompt, slot)
        self.prefix_hits += 1
        self.prefix_tokens_saved += lp

    def _pad_group(self, need: int, bucket: int, warmed: set) -> int:
        """Admission group size: pad up to a captured shape in ``warmed``,
        else the next power of two (captured on first use)."""
        cands = [g for (g, b) in warmed if b == bucket and g >= need]
        if cands:
            return min(cands)
        g = 1
        while g < need:
            g *= 2
        g = min(g, self.num_slots)
        warmed.add((g, bucket))
        return g

    def _occupy(self, req: Request, prompt: list[int], slot: int, *,
                plen: int = 0, seg: int = 0,
                local_len: Optional[int] = None) -> None:
        """Activate ``slot`` for ``req``. A segment-backed slot (``plen``
        > 0) holds its suffix at slot-local positions [0, local_len)."""
        self._slots[slot] = req
        self._active[slot] = True
        self._positions[slot] = len(prompt) if local_len is None else local_len
        self._remaining[slot] = req.max_new_tokens
        self._temps[slot] = (self.temperature if req.temperature is None
                             else req.temperature)
        self._top_ps[slot] = 1.0 if req.top_p is None else req.top_p
        self._top_ks[slot] = 0 if req.top_k is None else req.top_k
        self._spec_ban[slot] = -1  # residual bans do not cross occupants
        self._spec_backoff[slot] = 0
        self._spec_cool[slot] = 0
        if plen > 0:
            self._slot_plen[slot] = plen
            self._slot_seg[slot] = seg
            self._seg_refs[seg] += 1
            self._seg_used[seg] = time.monotonic()
            # its KV sits at offset positions: the slot matcher must not
            # match it
            self._slot_content[slot] = []
            self._slot_owner[slot] = None
        else:
            self._slot_content[slot] = list(prompt)
            self._slot_owner[slot] = req
        req.slot = slot
        req.admitted_step = self.step_counter

    def _release_seg(self, slot: int) -> None:
        """Drop a freed slot's segment reference."""
        if self._slot_plen[slot] > 0:
            self._seg_refs[self._slot_seg[slot]] -= 1
            self._slot_plen[slot] = 0
            self._slot_seg[slot] = 0

    def _create_segment(self, tokens: list[int]) -> int:
        """Prefill ``tokens`` into a free segment row (or the least recently
        used one no slot references); the row, or -1 when every segment is
        referenced."""
        free = [i for i, c in enumerate(self._seg_content) if not c]
        if not free:
            evictable = [i for i in range(self.prefix_segments)
                         if self._seg_refs[i] == 0 and self._seg_content[i]
                         and i not in self._seg_reserved]
            if not evictable:
                return -1
            victim = min(evictable, key=lambda i: self._seg_used[i])
            self._seg_content[victim] = []
            self.segment_evictions += 1
            free = [victim]
        seg = free[0]
        bucket = self._seg_rung(len(tokens))
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :len(tokens)] = tokens
        self._run_seg_prefill(bucket, {"toks": toks, "length": [len(tokens)],
                                       "row": [seg]})
        self._seg_content[seg] = list(tokens)
        self._seg_used[seg] = time.monotonic()
        return seg

    def _plan_segment(self, req: Request) -> Optional[tuple]:
        """The segment route of one request: (segment, prefix length,
        suffix), or None (the plain routes take it). May create a segment
        (one prefill dispatch); segments planned this cycle are reserved
        until their batched suffix prefill is dispatched."""
        prompt = req.prompt
        cap = len(prompt) - 1  # one suffix token must run for the logits
        # segment KV at positions < lcp depends only on tokens < lcp, so any
        # prompt sharing them may attend that much of the segment
        best, blen = -1, 0
        p_arr = np.asarray(prompt, np.int64)
        for i, content in enumerate(self._seg_content):
            if min(len(content), cap) <= blen:
                continue
            n = lcp(content, p_arr, cap)
            if n > blen:
                best, blen = i, n

        def feasible(bl: int) -> bool:
            # the whole generation must fit the suffix slot: a shrunk
            # max_new_tokens would make token counts depend on cache state
            sfx = len(prompt) - bl
            return (0 < sfx <= self.seq_buckets[-1]
                    and sfx + req.max_new_tokens <= self.cfg.max_seq_len - 1)

        created = False
        if blen < self.min_prefix and cap >= self.min_prefix:
            # too little shared with any segment: this prompt gets its own
            # (feasibility first: an abandoned plan burns no dispatch)
            want = min(self.segment_len, cap)
            if want >= self.min_prefix and feasible(want):
                made = self._create_segment(prompt[:want])
                if made >= 0:
                    best, blen, created = made, want, True
        if best < 0 or blen < self.min_prefix or not feasible(blen):
            return None
        self._seg_reserved.add(best)
        if not created:
            self.segment_hits += 1
            self.segment_tokens_shared += blen
        return best, blen, prompt[blen:]

    def _plan_paged(self, req: Request) -> Optional[tuple]:
        """(prompt, start, table, cow_src, shared) with the request's whole
        span (prompt + max_new_tokens) reserved, or None when the free list
        cannot host it. A span no empty pool could host fails the request.

        Prefix reuse at block granularity: the full blocks of the best
        matching live or retired sequence are shared by refcount; a match
        that ends inside a block forks that block (``cow_src``) into the
        first fresh one, and the prefill starts at the divergence."""
        bs = self.block_size
        cap = min(self.seq_buckets[-1],
                  self.cfg.max_seq_len - req.max_new_tokens)
        prompt = req.prompt[-cap:]
        total = len(prompt) + req.max_new_tokens
        nb_total = -(-total // bs)
        if nb_total > self._alloc.num_blocks:
            req.error = RuntimeError(
                f"request needs {nb_total} KV blocks but the pool has "
                f"{self._alloc.num_blocks} (num_blocks too small for "
                f"prompt + max_new_tokens = {total} at block_size {bs})")
            req.done.set()
            return None
        start, shared, cow_src = 0, [], None
        if self.prefix_cache:
            blocks, n = self._paged_match(prompt)
            n = min(n, len(prompt) - 1)
            if n >= self.min_prefix:
                nfull = n // bs
                shared = [int(b) for b in blocks[:nfull]]
                start = nfull * bs
                if n > start and nfull < len(blocks):
                    cow_src = int(blocks[nfull])
                    start = n
        # pin the shared blocks out of the free list before allocating
        self._alloc.ref(shared)
        fresh = self._alloc.alloc(nb_total - len(shared))
        if fresh is None:
            self._alloc.release(shared)
            return None
        if shared:
            self._alloc.prefix_block_hits_total += len(shared)
        return prompt, start, shared + fresh, cow_src, len(shared)

    def _paged_match(self, prompt: list[int]) -> tuple[tuple, int]:
        """(blocks, lcp): the best block-backed prefix of ``prompt``, from
        the live slots' content first, then the allocator's registry of
        retired sequences (freed blocks not yet reused)."""
        cap = len(prompt) - 1
        if cap <= 0:
            return (), 0
        p = np.asarray(prompt, np.int64)
        best_blocks: tuple = ()
        best = 0
        for s in range(self.num_slots):
            content, blocks = self._slot_content[s], self._slot_blocks[s]
            if not blocks or min(len(content), cap) <= best:
                continue
            n = lcp(content, p, cap)
            if n > best:
                best_blocks, best = tuple(blocks), n
        reg_blocks, reg = self._alloc.match(p, cap)
        if reg > best:
            best_blocks, best = reg_blocks, reg
        return best_blocks, best

    def _admit_paged(self, taken, plans) -> None:
        """Install planned admissions: fork COW boundaries on the card and
        queue the prefill from each plan's start; paged admission is always
        chunk driven (with ``prefill_budget == 0`` one chunk covers the
        rest of the prompt)."""
        stall_t0 = time.perf_counter()
        had_live = bool(self._active.any())
        dispatched = False
        for (req, slot), (prompt, start, table, cow_src, shared) in zip(
                taken, plans):
            if cow_src is not None:
                try:
                    self._run_block_copy(cow_src, table[shared])
                except Exception as e:  # noqa: BLE001 — fail THIS request
                    req.error = e
                    req.done.set()
                    self._slots[slot] = None
                    self._alloc.release(table)
                    continue
                self._alloc.cow_copies_total += 1
                dispatched = True
            self._slot_blocks[slot] = table
            if self.block_ledger is not None:
                self.block_ledger.annotate(self._alloc, table,
                                           f"slot{slot}:admit")
            # the shared prefix is real KV at [0, start) from now on
            self._slot_content[slot] = list(prompt[:start])
            self._slot_owner[slot] = None
            self._prefilling.append([req, slot, list(prompt), start])
            self._prefill_tokens_inflight += len(prompt) - start
            if start > 0:
                self.prefix_hits += 1
                self.prefix_tokens_saved += start
        if had_live and dispatched:
            self.decode_stall_ms_total += (
                time.perf_counter() - stall_t0) * 1e3

    def _block_tables(self, attend: int) -> np.ndarray:
        """[num_slots, nblk] block tables for an attend rung, padded with
        the allocator's out-of-range sentinel."""
        nblk = -(-attend // self.block_size)
        bt = np.full((self.num_slots, nblk), self._alloc.pad_block, np.int64)
        for s, blocks in enumerate(self._slot_blocks):
            if blocks:
                m = min(len(blocks), nblk)
                bt[s, :m] = blocks[:m]
        return bt

    def _retire_slot(self, slot: int) -> None:
        """Free a slot for reuse: its segment reference and, paged, its
        blocks. Freed blocks are reused uncleared (the causal mask hides
        their bytes); with the prefix cache the sequence is registered
        over them, so a later prompt sharing its prefix takes them back
        instead of prefilling again."""
        self._slots[slot] = None
        self._active[slot] = False
        self._remaining[slot] = 0
        self._release_seg(slot)
        if self.paged and self._slot_blocks[slot]:
            blocks = self._slot_blocks[slot]
            if self.prefix_cache:
                self._alloc.register(self._slot_content[slot], blocks)
            self._alloc.release(blocks)
            self._slot_blocks[slot] = []

    # -- scheduler: the loop -------------------------------------------------

    def _loop(self) -> None:
        try:
            with self._dispatch.stream_ctx():
                self._loop_inner()
        except Exception as e:  # noqa: BLE001 — a dead engine thread must
            # not strand waiters: fail everything in flight and refuse new
            # submissions (submit() re-raises self._error)
            log.exception("continuous engine failed")
            with self._gate:
                self._error = e
            for req in self._slots:
                if req is not None and not req.done.is_set():
                    req.error = e
                    req.done.set()
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                req.error = e
                req.done.set()
            for req in self._waiting:
                if not req.done.is_set():
                    req.error = e
                    req.done.set()
            self._waiting.clear()

    def _purge_prefilling(self) -> None:
        """Drop chunked-admission entries whose request resolved out of
        band (cancelled mid-prefill)."""
        if not self._prefilling:
            return
        kept = deque()
        for e in self._prefilling:
            if e[0].done.is_set():
                self._prefill_tokens_inflight -= len(e[2]) - e[3]
            else:
                kept.append(e)
        self._prefilling = kept

    def _prefill_chunk_args(self):
        """(entry, host chunk inputs, take, final, attend needed) for the
        head of the chunked-admission queue. With ``prefill_budget == 0``
        (paged whole-prompt admission) one chunk covers the remainder,
        bucketed like a whole-prompt prefill."""
        entry = self._prefilling[0]
        req, slot, prompt, off = entry
        rem = len(prompt) - off
        budget = self.prefill_budget or next(
            b for b in self.seq_buckets if b >= rem)
        take = min(budget, rem)
        final = (off + take) == len(prompt)
        toks = np.zeros(budget, np.int64)
        toks[:take] = prompt[off:off + take]
        host = {"toks": toks, "start": [off], "length": [take],
                "write_slot": [slot if final else self.num_slots],
                "slot": [slot]}
        return entry, host, take, final, off + budget

    def _fail_prefill_head(self, entry, e: Exception) -> None:
        entry[0].error = e
        entry[0].done.set()

    def _advance_prefill(self, entry, take: int, final: bool) -> None:
        """Book one dispatched chunk; the final one activates the slot (its
        first token samples from the written logits at the next
        dispatch)."""
        req, slot, prompt, off = entry
        entry[3] = off + take
        self._slot_content[slot] = prompt[:off + take]
        self._prefill_tokens_inflight -= take
        self.prefill_chunks_dispatched += 1
        if final:
            self._prefilling.popleft()
            self._occupy(req, prompt, slot)

    def _loop_inner(self) -> None:
        # dispatches in flight: (fetch handle, [(slot, req, take)], the
        # verify's drafts or None)
        pending: list[tuple[Any, list, Any]] = []
        while not self._stop.is_set():
            self._admit()
            for slot in range(self.num_slots):
                req = self._slots[slot]
                if req is not None and req.done.is_set():
                    self._retire_slot(slot)  # resolved out of band
            self._purge_prefilling()
            has_prefill = bool(self._prefilling)
            can_fuse = has_prefill and self.prefill_budget > 0
            if not self._active.any() and not has_prefill:
                while pending:
                    self._process(*pending.pop(0))
                if (self._active.any() or self._waiting or self._prefilling
                        or not self._queue.empty()):
                    continue
                if self.block_ledger is not None:
                    self._audit_blocks_now()
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            live = bool(self._active.any())
            if live:
                self.step_counter += 1
                self._draw_noise()
            snapshot = [
                (slot, self._slots[slot],
                 int(min(self.decode_chunk, self._remaining[slot])))
                for slot in range(self.num_slots)
                if self._active[slot] and self._slots[slot] is not None
            ]
            live_seg = (live and self.prefix_segments > 0
                        and bool((self._slot_plen[self._active] > 0).any()))
            use_spec, drafts, proposed = (
                self._plan_spec() if live and self.spec_k > 0 and not live_seg
                else (False, None, 0))
            # the window covers every live position plus this dispatch's
            # writes: decode_chunk steps, or the verify's t1 + spec_k drafts
            span = self.spec_k + 1 if use_spec else self.decode_chunk
            needed = ((int(self._positions[self._active].max()) + span)
                      if live else self.decode_chunk)
            filtered = self._filtered()
            spec = ({"drafts": drafts, "banned": self._spec_ban.copy()}
                    if use_spec else {})
            toks = None
            if live_seg:
                # the segment decode advances every active slot without the
                # verify's residual mask: pending bans would go stale
                self._spec_ban[:] = -1
                seg_att = self._seg_rung(
                    int(self._slot_plen[self._active].max()))
                host = {**self._host_decode(),
                        "plens": np.where(self._active, self._slot_plen, 0),
                        "seg_ids": self._slot_seg.copy()}
                toks = self._run_prefix_decode(self._rung(needed), seg_att,
                                               filtered, host)
            elif live and can_fuse:
                entry, chunk, take, final, p_needed = (
                    self._prefill_chunk_args())
                a = self._rung(max(needed, p_needed))
                host = {**chunk, **self._host_decode(), **spec}
                if self.paged:
                    host["bt"] = self._block_tables(a)
                run = self._run_fused_verify if use_spec else self._run_fused
                try:
                    toks = run(a, filtered, host)
                except Exception as e:  # noqa: BLE001 — fail THIS request
                    self._fail_prefill_head(entry, e)
                    continue
                self._advance_prefill(entry, take, final)
            elif live:
                a = self._rung(needed)
                host = {**self._host_decode(), **spec}
                if self.paged:
                    host["bt"] = self._block_tables(a)
                run = self._run_verify if use_spec else self._run_decode
                toks = run(a, filtered, host)
            if has_prefill and (not live or live_seg or not can_fuse):
                # no decode dispatch to ride (or the pool decodes through
                # the segment program): the chunk runs alone, after the
                # decode (which rewrites every slot's logits); paged
                # whole-prompt admission drains the queue here
                while self._prefilling:
                    entry, chunk, take, final, p_needed = (
                        self._prefill_chunk_args())
                    a = self._rung(p_needed)
                    if self.paged:
                        nblk = -(-a // self.block_size)
                        row = np.full((1, nblk), self._alloc.pad_block)
                        blocks = self._slot_blocks[entry[1]][:nblk]
                        row[0, :len(blocks)] = blocks
                        chunk["bt"] = row
                    try:
                        self._run_chunk(a, len(chunk["toks"]), chunk)
                    except Exception as e:  # noqa: BLE001 — fail THIS
                        self._fail_prefill_head(entry, e)
                        break
                    self._advance_prefill(entry, take, final)
                    if not (self.paged and self.prefill_budget == 0):
                        break  # budgeted chunks: one a dispatch cycle
            if not live:
                while pending:
                    self._process(*pending.pop(0))
                continue
            if use_spec:
                # counted here, not when planned: a failed fused verify
                # verified nothing
                self.spec_dispatches_total += 1
                self.spec_tokens_proposed_total += proposed
                # the advance depends on the accept lengths: _process
                # applies it once the tokens are on the host
                pending.append((self._fetch_start(toks), snapshot, drafts))
            else:
                # advance the value-independent schedule now, so the next
                # dispatch can go before this one's tokens are fetched
                for slot, req, take in snapshot:
                    self._positions[slot] += self.decode_chunk
                    self._remaining[slot] -= take
                    if self._remaining[slot] <= 0:
                        self._retire_slot(slot)
                pending.append((self._fetch_start(toks), snapshot, None))
            if self.spec_k > 0:
                # the next dispatch's positions, drafts and bans need this
                # one's accept lengths: a speculating pool runs at depth 1
                while pending:
                    self._process(*pending.pop(0))
            elif len(pending) >= self.pipeline_depth:
                self._process(*pending.pop(0))
        while pending:
            self._process(*pending.pop(0))

    def _plan_spec(self):
        """(use a verify, drafts [slots, spec_k] -1-padded, drafts
        proposed). A verify is worth its (spec_k + 1)-wide forward when a
        slot has a real draft or a residual ban waits (only a verify's
        masked first draw consumes it); otherwise the plain decode runs."""
        k = self.spec_k
        drafts = np.full((self.num_slots, k), -1, np.int64)
        proposed = 0
        for slot in range(self.num_slots):
            if not self._active[slot] or self._slots[slot] is None:
                continue
            if self._spec_cool[slot] > 0:
                self._spec_cool[slot] -= 1  # the zero-accept backoff
                continue
            # draft only what the request can still emit beyond t1
            lim = min(k, int(self._remaining[slot]) - 1)
            if lim <= 0:
                continue
            try:
                p = self._proposer.propose(self._slot_content[slot], lim)
            except Exception:  # noqa: BLE001 — drafts are guesses: a
                # proposer that raises means no draft, never a dead engine
                log.debug("draft proposer failed for slot %d", slot,
                          exc_info=True)
                continue
            if p:
                p = list(p)[:lim]  # an overlong proposal is clamped
                drafts[slot, :len(p)] = p
                proposed += len(p)
        use = proposed > 0 or bool((self._spec_ban[self._active] >= 0).any())
        return use, drafts, proposed

    def _process(self, handle, snapshot, drafts=None) -> None:
        """Wait for one dispatch's tokens and deliver them (a verify's
        through ``_deliver_verify``)."""
        toks = self._dispatch.fetch(handle)  # [slots, chunk]
        now = time.perf_counter()
        if drafts is not None:
            self._deliver_verify(toks, snapshot, drafts, now)
            return
        for slot, req, take in snapshot:
            if req.done.is_set():
                self.tokens_discarded += take
                continue
            emitted = toks[slot, :take].tolist()
            if self._slot_owner[slot] is req:
                self._slot_content[slot].extend(emitted)
            done = False
            if self.eos_id is not None and self.eos_id in emitted:
                emitted = emitted[:emitted.index(self.eos_id) + 1]
                self.tokens_discarded += take - len(emitted)
                done = True
                if self._slots[slot] is req:
                    self._retire_slot(slot)
            if emitted and req.first_token_at is None:
                req.first_token_at = now
            req.tokens.extend(emitted)
            if emitted:
                req.last_token_at = now
            self.tokens_emitted += len(emitted)
            if done or len(req.tokens) >= req.max_new_tokens:
                req.done.set()

    def _deliver_verify(self, out, snapshot, drafts, now) -> None:
        """Deliver one verify ([slots, spec_k + 2]: the tokens, then the
        accept length): each slot emits 1 + accept tokens (EOS inside the
        run cuts at the exact token) and its front advances as far; a
        rejected draft arms the slot's residual ban, an all-rejected one
        its backoff."""
        k = self.spec_k
        toks, acc = out[:, :k + 1], out[:, k + 1]
        for slot, req, _take in snapshot:
            a = int(acc[slot])
            self.spec_tokens_accepted_total += a
            if int(drafts[slot, 0]) >= 0:  # this slot offered real drafts
                if a == 0:
                    self._spec_backoff[slot] = min(
                        max(2 * self._spec_backoff[slot], 2), 32)
                    self._spec_cool[slot] = self._spec_backoff[slot]
                else:
                    self._spec_backoff[slot] = 0
            # the first rejected draft's candidate was discarded on the
            # condition that it differs: the next draw must exclude it
            ban = int(drafts[slot, a]) if a < k else -1
            if req.done.is_set():
                self.tokens_discarded += 1 + a
                self._spec_ban[slot] = -1
                continue
            take = min(1 + a, int(self._remaining[slot]))
            self.tokens_discarded += (1 + a) - take
            emitted = toks[slot, :take].tolist()
            self._positions[slot] += take
            self._remaining[slot] -= take
            if self._slot_owner[slot] is req:
                self._slot_content[slot].extend(emitted)
            done = False
            if self.eos_id is not None and self.eos_id in emitted:
                cut = emitted.index(self.eos_id) + 1
                self.tokens_discarded += take - cut
                emitted = emitted[:cut]
                done = True
            if emitted and req.first_token_at is None:
                req.first_token_at = now
            req.tokens.extend(emitted)
            if emitted:
                req.last_token_at = now
            self.tokens_emitted += len(emitted)
            if (done or len(req.tokens) >= req.max_new_tokens
                    or self._remaining[slot] <= 0):
                req.done.set()
                done = True
            if done and self._slots[slot] is req:
                self._retire_slot(slot)
                ban = -1
            self._spec_ban[slot] = ban


def engine_kwargs(config: dict, *, default_eos=None,
                  default_max_new_tokens: int = 16) -> dict:
    """ContinuousEngine kwargs from a serving-config dict (the reference's
    keys and defaults)."""
    return dict(
        num_slots=int(config.get("num_slots", 8)),
        decode_chunk=int(config.get("decode_chunk", 4)),
        prefill_budget=int(config.get("prefill_budget", 0)),
        temperature=float(config.get("temperature", 0.0)),
        eos_id=config.get("eos_id", default_eos),
        pipeline_depth=int(config.get("pipeline_depth", 2)),
        mesh_axes=config.get("mesh_axes"),
        prefix_cache=bool(config.get("prefix_cache", True)),
        min_prefix=int(config.get("min_prefix", 32)),
        prefix_segments=int(config.get("prefix_segments", 0)),
        segment_len=int(config.get("segment_len", 0)),
        spec_k=int(config.get("spec_k", 0)),
        spec_ngram=int(config.get("spec_ngram", 3)),
        block_size=int(config.get("block_size", 0)),
        num_blocks=int(config.get("num_blocks", 0)),
        host_blocks=int(config.get("host_blocks", 0)),
        host_watermark=float(config.get("host_watermark", 0.25)),
        role=str(config.get("role", "mixed")),
        default_max_new_tokens=int(
            config.get("max_new_tokens", default_max_new_tokens)),
    )


#: serving-config keys of engines and options not ported yet
_UNPORTED_CONFIG = {
    "short_pool_len": "A4(d)", "tier_lens": "A4(d)",
    "disaggregation": "A4(d)", "aot": "A12", "quant_weights": "A11",
}


def build_engine(cfg: LlamaConfig, params, config: dict, *, default_eos=None,
                 default_max_new_tokens: int = 16,
                 device=None) -> ContinuousEngine:
    """Engine from a serving-config dict: the reference's plain
    ``ContinuousEngine`` branch. ``quant_kv`` turns on the int8 KV cache;
    ``"warmup_groups": []`` skips warmup."""
    for key, item in _UNPORTED_CONFIG.items():
        if config.get(key):
            raise NotImplementedError(
                f"serving config {key!r} is not ported yet (ROADMAP {item})")
    kw = engine_kwargs(config, default_eos=default_eos,
                       default_max_new_tokens=default_max_new_tokens)
    if config.get("quant_kv"):
        cfg = dataclasses.replace(cfg, quant_kv=True)
    engine = ContinuousEngine(cfg, params, seq_buckets=config.get(
        "seq_buckets"), device=device, **kw)
    groups = config.get("warmup_groups")
    if groups != []:
        engine.warmup([tuple(g) for g in groups] if groups else None)
    return engine
