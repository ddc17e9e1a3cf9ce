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

Moving and storing sequences (the paged pool): ``export_sequence`` and
``import_sequence`` move a live sequence between engines, copy then
cutover (``migrate_live_sequences`` drains one); ``host_blocks`` spills
retired prefixes to a host-RAM tier (``paged.HostBlockPool``) and restores
them at admission; ``hibernate_sequence``/``thaw_sequence`` park a session
in a ``storage.KvSpillStore`` and resume it on any engine. On that path
the scheduler only enqueues, on the engine's stream, the block gathers
(``paged.kv_export``) and their copy into pinned host memory; the caller's
thread or the ``kv-host-tier`` worker waits on a CUDA event recorded after
the copy. These few gathers and scatters run eagerly, not as graphs, so
nothing aliases a graph's static output. ``TieredEngine`` (the tier ladder
as an admission policy) and ``DisaggregatedPool`` (prefill engines handing
each sequence to a decode engine, in process) sit on top.

Request tracing (``trace.py``) has the reference's seams and names: a
sampled request carries a ``Trace`` whose phase track runs
``engine.queue`` -> ``engine.prefill`` -> ``engine.decode`` (with
``engine.handoff``, ``kv.hibernate``/``kv.thaw`` and the preemptor's
``engine.preempted`` where they happen), with detail spans under it
(``prefill.chunk``, ``dispatch`` carrying the program family and attend
rung, ``kv.cow``, ``kv.export``/``kv.import``/``kv.transfer``,
``kv.spill_write``). An unsampled request has ``trace=None`` and every
site checks that first. The scheduler only stamps times; the trace is
finished on the thread that delivered the response. ``warmup`` records an
``engine.warmup`` trace with one ``warmup.compile`` span per program shape:
on the card each times the shape's eager run and CUDA-graph capture (the
counterpart of the reference's compile), on the CPU its first eager run.
With a program-artifact cache (``program_cache``, ``programs.py``) the
spans are ``warmup.hit`` / ``warmup.miss``, one more for each kernel
library on the card, and the trace's meta carries ``aot_hits`` and
``aot_misses``.

A tensor-parallel engine (``mesh_axes``: ``model``, and ``expert`` for an
MoE model) is one rank of a serving gang
(``sharded.py``, ``gang.py``): one process drives one card. Its programs
hold the model's collectives; on an NCCL group they are captured as CUDA
graphs like any other, on gloo they run eagerly on the card's tensors.

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
from ..models import llama as llamalib
from ..models.llama import KvCache, Llama, LlamaConfig
from ..ops import _build
from ..ops import flash_attention as _fa
from ..ops import grouped_matmul as _gm
from .paged import (
    KV_MIGRATE_GROUP,
    MIGRATE_LEAVES,
    BlockAllocator,
    HostBlockPool,
    block_keys,
    gather_working_view,
    kv_export,
    kv_import,
    lcp,
    scatter_working_view,
    write_window_tables,
)
from . import programs as programslib
from . import sharded
from .model import Model
from .storage import fetch_mem
from .trace import Trace

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
    #: request-lifecycle trace (``trace.py``), None = unsampled: every
    #: instrumentation site checks for None first
    trace: Optional[Any] = None
    #: durable-session binding: an idle sequence with a session id may be
    #: hibernated under it (``idle_sessions``)
    session_id: Optional[str] = None
    #: stamped at every token delivery (and at resume): the idle clock
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


def cache_shapes(cfg: LlamaConfig, batch: int,
                 kv_heads: Optional[int] = None) -> dict[str, tuple]:
    """``{leaf: (shape, dtype)}`` of a ``batch``-row KV cache of
    ``cfg.max_seq_len`` positions, scratch not counted, holding
    ``kv_heads`` heads (default all: a tensor-parallel rank holds
    ``num_kv_heads / tp``)."""
    heads = cfg.num_kv_heads if kv_heads is None else kv_heads
    kv = (cfg.num_layers, batch, cfg.max_seq_len, heads, cfg.head_dim)
    dt = torch.int8 if cfg.quant_kv else cfg.dtype
    out = {"k": (kv, dt), "v": (kv, dt)}
    if cfg.quant_kv:
        sc = (cfg.num_layers, batch, heads, cfg.max_seq_len)
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
        cache = KvCache.zeros(cfg, g, cfg.max_seq_len, device=prompt.device,
                              kv_heads=model.kv_heads)
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
        cache = KvCache.zeros(cfg, g, cfg.max_seq_len, device=toks.device,
                              kv_heads=model.kv_heads)
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


def logits_take(logits, slot: int):
    """One slot's next-token logits row, as a copy (migration export; the
    slot clips into the pool, so the warmup's scratch row reads
    harmlessly)."""
    return logits[min(max(int(slot), 0), logits.shape[0] - 1)].clone()


def logits_set(logits, row, slot: int) -> None:
    """Install a logits row at ``slot`` (migration import and resume); the
    warmup's out-of-range slot writes the scratch row."""
    logits[min(max(int(slot), 0), logits.shape[0] - 1)].copy_(row)


def _block_rows(host: list, n: int) -> list[list]:
    """Per block, its leaf list: row ``j`` of each host leaf [n, ...] as a
    [1, ...] view (the snapshot's and the host tier's block format)."""
    return [[x[j:j + 1] for x in host] for j in range(n)]


def _stack_leaves(blocks: list) -> list[torch.Tensor]:
    """The inverse of ``_block_rows``: per leaf, the blocks' rows as one
    host tensor [n, ...]. Rows that are consecutive views of one tensor
    (an export's, a spill's) come back as a view of it, without a copy;
    numpy leaves (the reference's) are taken as they are."""
    out = []
    for li in range(len(blocks[0])):
        parts = [b[li] if isinstance(b[li], torch.Tensor)
                 # analysis: ok host-sync-in-dispatch — host numpy leaves
                 else torch.from_numpy(np.array(b[li]))
                 for b in blocks]
        first = parts[0]
        base = first.untyped_storage().data_ptr()
        step = first.numel()
        if first.is_contiguous() and all(
                p.is_contiguous() and p.shape == first.shape
                and p.untyped_storage().data_ptr() == base
                and p.storage_offset() == first.storage_offset() + k * step
                for k, p in enumerate(parts)):
            out.append(first.as_strided((len(parts), *first.shape[1:]),
                                        first.stride()))
        else:
            out.append(torch.cat(parts))
    return out


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
                 ring: int, observer: Callable, graphs: bool = True):
        self.device = device
        self.cuda = device.type == "cuda"
        #: capture and replay CUDA graphs (on the card); False runs every
        #: program eagerly, on the card as on the CPU
        self.graphs = self.cuda and graphs
        self.counter = counter
        #: optional callable(key, host) called before every program runs:
        #: a serving gang's rank 0 publishes the dispatch there
        self.publish: Optional[Callable] = None
        #: callable(family, outcome, t0, t1) for each program shape first
        #: run before the counter is armed (the warmup trace's spans):
        #: "compile" without a program cache, else "hit" or "miss"
        self.observer = observer
        #: the program-artifact cache (``programs.py``) and this engine's
        #: half of its keys: a program first run before the counter is
        #: armed is held against its record there
        self.cache: Optional[programslib.ProgramArtifactCache] = None
        self.key_base = ""
        #: called once, before the first program an unarmed engine builds
        #: (its warmup's, or a follower's first replay): the kernel
        #: libraries through the cache
        self.libraries: Optional[Callable[[], None]] = None
        #: seconds of the warmup's library hand-over, eager pre-runs,
        #: captures and record checks (``ContinuousEngine.warmup_report``)
        self.split = dict.fromkeys(
            ("libraries_s", "prerun_s", "capture_s", "records_s"), 0.0)
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
            # analysis: ok host-sync-in-dispatch — ring reuse of a pinned entry
            entry[2].synchronize()  # the last copy out of this entry ended
        for j, arr in ((0, ints), (1, floats)):
            if entry[j] is None or entry[j].numel() < arr.size:
                entry[j] = torch.empty(max(arr.size, 256),
                                       dtype=torch.from_numpy(arr).dtype,
                                       pin_memory=True)
            # analysis: ok host-sync-in-dispatch — pinned host staging buffer
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
        t0 = time.perf_counter()
        if not self.counter.armed:
            prog.run()
        # this thread's cuBLAS handle, made before the capture: a matmul
        # captured on a thread that has none (the scheduler's, with no
        # warmup) would create it inside the capture, which fails
        torch.cuda.current_blas_handle()
        t1 = time.perf_counter()
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        # a graph destroyed on this thread during a capture (a dead
        # engine's, freed by the cyclic collector) invalidates the capture:
        # collect now, and hold the collector off until the capture ends
        # (warmup holds it off across all its captures and collects once)
        collecting = gc.isenabled()
        if collecting:
            gc.collect()
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
        self.split["prerun_s"] += t1 - t0
        self.split["capture_s"] += time.perf_counter() - t1

    @torch.no_grad()
    def run(self, key: tuple, build: Callable[[], tuple[Callable, dict]],
            host: dict):
        """Run the program ``key`` (built by ``build`` -> (fn, spec) at its
        first use, which counts as a capture) on the host inputs ``host``;
        returns its output tensor (None for programs without one)."""
        prog = self.programs.get(key)
        fresh = prog is None
        if fresh and self.libraries is not None and not self.counter.armed:
            hand_over, self.libraries = self.libraries, None
            hand_over()
        if fresh:
            t0 = time.perf_counter()
            fn, spec = build()
            prog = _Program(fn, spec, self.device)
            self.programs[key] = prog
            self.counter.note()
        if self.publish is not None:
            self.publish(key, host)
        self._upload(prog, host)
        if not self.graphs:
            if fresh:
                # the launches one run makes (none on the CPU)
                before = [dict(c) for c in _launch_counters()]
                t1 = time.perf_counter()
                out = prog.run()
                self.split["prerun_s"] += time.perf_counter() - t1
                prog.launches = [{k: c[k] - b.get(k, 0) for k in c}
                                 for c, b in zip(_launch_counters(), before)]
            else:
                out = prog.run()
        else:
            if fresh:
                self._capture(prog)
            prog.graph.replay()
            out = prog.out
            for c, delta in zip(_launch_counters(), prog.launches):
                for k, n in delta.items():
                    c[k] += n
        if fresh and not self.counter.armed:
            # with graphs: the eager run and the capture; the replay is
            # only enqueued
            outcome = "compile"
            if self.cache is not None:
                # unarmed only: no artifact I/O once the scheduler runs
                t1 = time.perf_counter()
                outcome = programslib.check_record(
                    self.cache, self.key_base, str(key[0]),
                    ":".join(str(k) for k in key[1:]),
                    programslib.program_record(key, prog.spec, out,
                                               prog.launches))
                self.split["records_s"] += time.perf_counter() - t1
            self.observer(":".join(str(k) for k in key), outcome, t0,
                          time.perf_counter())
        return out

    def fetch_start(self, toks, host_out):
        """Start copying a dispatch's tokens to the host; returns the handle
        ``fetch`` waits on."""
        if not self.cuda:
            # analysis: ok host-sync-in-dispatch — CPU tokens, no device value
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
        # analysis: ok host-sync-in-dispatch — the one intended fetch
        ev.synchronize()
        # analysis: ok host-sync-in-dispatch — numpy view after the fetch
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
    - ``host_blocks``: 0 = no host tier; > 0 = a host-RAM mirror of that
      many blocks (paged pool only): while the free list is below
      ``host_watermark`` of the pool, a retiring sequence's full blocks
      spill there, and an admission whose prefix the host tier holds
      deeper than any block in the pool restores it instead of
      prefilling;
    - ``admission_policy``: an optional host callable(req) -> bool
      consulted at admission (scheduler thread); False defers the request
      without taking a slot (the tier ladder rides it);
    - ``role``: ``mixed`` (default), ``prefill`` or ``decode`` (paged pool
      only). A ``prefill`` engine freezes each sequence at its final chunk
      and calls ``on_prefilled`` (set by ``DisaggregatedPool``), which
      hands it to a decode engine by migration;
    - ``mesh_axes``: a tensor-parallel serving mesh, ``{"model": N}``,
      or for an MoE model ``{"expert": E, "model": N}`` (its experts
      split over ``expert`` too). One process drives one card, so the
      engine is then one rank of a ``torch.distributed`` group of
      ``E x N`` ranks (``sharded.py``): its model holds this rank's
      shards and its pool ``num_kv_heads / N`` heads,
      and it runs only as a serving gang (``gang.py``: rank 0's
      ``GangEngine`` decides, the others ``follow``). Without a group of
      N ranks it raises ``ValueError``. On an NCCL group every program is
      captured as a CUDA graph, collectives included; on gloo (the only
      backend that lets two ranks share one card) the programs run
      eagerly on the card's tensors;
    - ``program_cache``: an optional ``programs.ProgramArtifactCache``.
      While the engine warms, each fresh program's capture is held against
      its record there (equal: a hit; none: a miss that publishes; one
      that does not match, or a torn one: a load failure, replaced), and
      on the card every kernel library goes through it before warmup's
      first launch (``ops/_build.py``). A graph is captured either way: a
      CUDA graph cannot be loaded from disk. Once armed the engine never
      touches the cache. ``stats()`` reports its ``aot_cache_*`` counters;
    - ``temperature``, ``eos_id``, ``seq_buckets``,
      ``default_max_new_tokens`` as in the reference.
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
        host_blocks: int = 0,
        host_watermark: float = 0.25,
        admission_policy: Optional[Callable[[Request], bool]] = None,
        role: str = "mixed",
        mesh_axes: Optional[dict[str, int]] = None,
        program_cache: Optional[programslib.ProgramArtifactCache] = None,
        device=None,
    ):
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
        if host_blocks < 0:
            raise ValueError("host_blocks must be >= 0 (0 = no host tier)")
        if host_blocks > 0 and block_size <= 0:
            raise ValueError(
                "the host KV tier requires the paged pool "
                "(block_size > 0): the spill unit is the block")
        if not (0.0 <= float(host_watermark) <= 1.0):
            raise ValueError("host_watermark must be in [0, 1]")
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"role {role!r}: must be mixed|prefill|decode")
        if role != "mixed" and block_size <= 0:
            raise ValueError(
                f"role={role} requires the paged pool (block_size > 0): "
                "the KV migration unit is the block")
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
        #: the serving mesh's axes, and the ``DeviceMesh`` of a
        #: tensor-parallel engine (None for one process)
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        self.mesh = (sharded.build_serving_mesh(self.mesh_axes)
                     if sharded.degree_of(mesh_axes) > 1 else None)
        if isinstance(params, Llama) and (
                self.mesh is None
                or getattr(params, "layout", None) is not None):
            # one process's model, or one already laid out on the group
            self.model = params
        elif self.mesh is not None:
            # a state dict or an unsharded ``Llama``: this rank's shards
            self.model = sharded.place_params(cfg, params, self.mesh,
                                              self.device)
        else:
            self.model = Llama(cfg, device=self.device)
            self.model.load_state_dict(params, strict=True)
        #: the ``model`` axis group (None unsharded), this rank's kv heads
        self._tp = sharded.tp_group(self.model)
        self.kv_heads = self.model.kv_heads
        self.tp_degree = 1 if self._tp is None else self._tp.size
        #: the group's backend, and whether programs run as CUDA graphs:
        #: on the card, unless a gloo group's collectives (which a graph
        #: cannot hold) are in them
        self.backend = None
        if self.mesh is not None:
            import torch.distributed as dist

            self.backend = dist.get_backend()
        self.graphs = (self.device.type == "cuda"
                       and self.backend in (None, "nccl"))
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
        #: the host-RAM tier: retired sequences' block bytes, spilled under
        #: free-list pressure (the scheduler enqueues the gathers, the
        #: ``kv-host-tier`` worker takes the fetched leaves in)
        self.host_blocks = int(host_blocks)
        self._host_pool = (HostBlockPool(self.host_blocks, self.block_size)
                           if self.paged and self.host_blocks > 0 else None)
        #: free-block count below which retirement spills to host RAM
        self._host_watermark_blocks = int(self.num_blocks
                                          * float(host_watermark))
        self._spill_q: "queue.Queue" = queue.Queue()
        self._spill_thread: Optional[threading.Thread] = None
        #: the storage tier (``storage.KvSpillStore``) for hibernate/thaw
        self.spill_store = None
        #: the tier and migration counters tick on the host-tier worker, on
        #: callers' threads and on the scheduler: one lock
        self._tier_mu = threading.Lock()
        self.kv_spills_total = 0
        self.kv_thaws_total = 0
        self.kv_thaws_degraded_total = 0
        #: optional ``analysis.runtime.BlockLedger`` (attach_block_ledger)
        self.block_ledger = None
        #: optional ``trace.Tracer`` shared with the runtime in front
        #: (``text.py`` sets it): engine-level phases with no request
        #: trace (a host-tier spill) observe into its sink, and an import
        #: of a snapshot with a ``"trace"`` context continues that trace
        self.tracer = None
        #: warmup trace material: (family, outcome, t0, t1) per program
        #: shape, and the ``engine.warmup`` trace stashed until a tracer
        #: is attached (``flush_warmup_trace``)
        self._warm_events: list = []
        self._warmup_trace = None
        self._slot_blocks: list[list[int]] = [[] for _ in range(num_slots)]
        self.admission_policy = admission_policy
        self.role = role
        #: the disaggregation handoff hook (scheduler thread, must not
        #: block): called with the Request when a prefill-role engine's
        #: sequence finishes its final chunk, frozen at that boundary
        self.on_prefilled: Optional[Callable[[Request], None]] = None
        #: live migration: slots frozen pending cutover (slot -> {"req",
        #: "entry", "logits"}) and the mailbox the scheduler services
        #: between dispatches (every op mutates scheduler state)
        self._migrating: dict[int, dict] = {}
        self._migrate_q: "queue.Queue[tuple]" = queue.Queue()
        self.kv_migrations_total = 0
        self.kv_migrate_failures_total = 0
        self.kv_migrate_bytes_total = 0
        #: export -> acknowledged import latencies (ms), fixed buckets + inf
        self._mig_buckets = (5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                             1000.0)
        self._mig_lat_counts = [0] * (len(self._mig_buckets) + 1)
        self._mig_lat_sum = 0.0
        #: pinned host tensors of imports and restores in flight, each with
        #: the event recorded after its copy to the card
        self._staged: list[tuple[Any, Any]] = []
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
            for shape, dt in cache_shapes(cfg, num_slots,
                                          self.kv_heads).values())
        self._captures = CaptureCounter()
        self._dispatch = _Dispatch(self.device, self._captures,
                                   ring=pipeline_depth + 1,
                                   observer=self._note_warm,
                                   graphs=self.graphs)
        #: the program-artifact cache, keyed by the model's structure, the
        #: degree and the knobs that shape programs (the reference's)
        self.program_cache = program_cache
        if program_cache is not None:
            self._dispatch.cache = program_cache
            if self._dispatch.cuda:
                self._dispatch.libraries = self._libraries_through_cache
            self._dispatch.key_base = programslib.cache_key_base(
                cfg, self.model, self.mesh_axes, slots=num_slots,
                chunk=decode_chunk, budget=self.prefill_budget,
                spec_k=self.spec_k, spec_ngram=self.spec_ngram,
                block=self.block_size, segments=self.prefix_segments,
                seglen=self.segment_len)
        #: the last warmup's outcome per program (and kernel library) and
        #: its seconds by part
        self.warmup_report: dict = {}
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
                                       scratch=0, kv_heads=self.kv_heads)
        else:
            self._pool = KvCache.zeros(cfg, self.num_slots + 1,
                                       cfg.max_seq_len, device=dev,
                                       kv_heads=self.kv_heads)
        self._pool_logits = torch.zeros(self.num_slots + 1, cfg.vocab_size,
                                        dtype=cfg.dtype, device=dev)
        if self.prefix_segments > 0:
            # one scratch row past the segments, for the warmup's writes
            self._seg = KvCache.zeros(self._seg_cfg, self.prefix_segments + 1,
                                      self.segment_len, device=dev,
                                      kv_heads=self.kv_heads)
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
        if self._host_pool is not None and self._spill_thread is None:
            self._spill_thread = threading.Thread(
                target=self._host_tier_loop, name="kv-host-tier",
                daemon=True)
            self._spill_thread.start()

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
        # analysis: ok host-sync-in-dispatch — host numpy scheduler state
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
            key = ("chunk", attend, budget)
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

    def replay(self, key: tuple, host: dict):
        """Run program ``key`` on the host inputs ``host``, as another
        engine of the same config dispatched it (a serving gang's rank 0
        publishes both, ``gang.py``): the program is rebuilt from its key.
        Returns the program's output."""
        fam = key[0]
        if fam == "block_copy":
            return self._run_block_copy(int(host["src"][0]),
                                        int(host["dst"][0]))
        # every other family is its ``_run_*`` method's name (the paged
        # pool's behind a prefix), the rest of the key its arguments
        run = getattr(self, "_run_" + fam.removeprefix("paged_"), None)
        if run is None:
            raise RuntimeError(f"unknown program family {fam!r}")
        return run(*key[1:], host)

    def _draw_noise(self) -> None:
        """Fill the draw's noise when an active slot samples (greedy slots
        never read it)."""
        # analysis: ok host-sync-in-dispatch — host numpy scheduler state
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
        decode (and with chunked admission the chunk and fused; with
        speculation the verify) programs of every attend rung up to
        ``max_seq_len``, which a request reaches as it decodes, both sampling
        variants. Every warmup dispatch targets the scratch row or inactive
        slots, so pool state is untouched. Default groups: sizes 1 and ``num_slots`` at the smallest
        bucket. Arms the capture counter. Must run before the first
        ``submit``."""
        with self._gate:
            if self._thread is not None:
                raise RuntimeError(
                    "warmup() must run before the first submit(): the "
                    "scheduler thread owns the pool once traffic starts")
            self._warm_events = []
            tr = Trace(name="warmup", kind="engine")
            tr.phase("engine.warmup")
            started = time.perf_counter()
            split = self._dispatch.split
            split.update(dict.fromkeys(split, 0.0))
            # on the card, one collection for every capture below (_capture)
            collecting = self._dispatch.cuda and gc.isenabled()
            if collecting:
                gc.collect()
                gc.disable()
            try:
                with self._dispatch.stream_ctx():
                    self._warmup_locked(groups)
                if self._dispatch.cuda:
                    # analysis: ok lock-order — warmup's phase barrier
                    torch.cuda.synchronize(self.device)
            finally:
                if collecting:
                    gc.enable()
                # one span per program shape, so the capture wall shows in
                # /traces and kft_phase_seconds like every other phase
                for family, outcome, t0, t1 in self._warm_events:
                    sp = tr.begin(f"warmup.{outcome}", family=family)
                    sp.start = t0
                    sp.done(at=t1)
                self.warmup_report = {
                    "outcomes": {f: o for f, o, _, _ in self._warm_events},
                    "split": dict(split),
                    "wall_s": time.perf_counter() - started}
                self._warm_events = []
                if self.program_cache is not None:
                    st = self.program_cache.stats()
                    tr.meta["aot_hits"] = st["aot_cache_hits_total"]
                    tr.meta["aot_misses"] = st["aot_cache_misses_total"]
                tr.finish()
                self._warmup_trace = tr
                self.flush_warmup_trace()
            self._captures.armed = True

    def _libraries_through_cache(self) -> None:
        """Hand the program cache to the kernel build before the first
        launch of an unarmed engine (``_Dispatch.libraries``): every library
        is taken from its verified entry (a hit) or built and published (a
        miss); a span a library, each over the whole hand-over (the misses
        build together)."""
        t0 = time.perf_counter()
        outcomes = _build.load_through(self.program_cache)
        t1 = time.perf_counter()
        for name, outcome in outcomes.items():
            self._note_warm(f"kernels:{name}", outcome, t0, t1)
        self._dispatch.split["libraries_s"] = t1 - t0

    def _note_warm(self, family: str, outcome: str, t0: float,
                   t1: float) -> None:
        """The dispatcher's observer: one event per program shape first
        run in warmup (capped below the trace's span limit)."""
        if len(self._warm_events) < 500:
            self._warm_events.append((family, outcome, t0, t1))

    def flush_warmup_trace(self) -> None:
        """Hand the stashed warmup trace to the tracer's sink. The runtime
        attaches ``self.tracer`` after the engine is built and warmed, so
        warmup stashes its trace and whoever attaches a tracer flushes it.
        Idempotent; a no-op with no tracer or no stash."""
        tr, tracer = self._warmup_trace, self.tracer
        if tr is None or tracer is None:
            return
        self._warmup_trace = None
        tracer.sink.finish(tr)

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
        # a request climbs the attend rungs as it decodes: the decode, chunk
        # and fused programs of EVERY rung up to max_seq_len are captured
        # here, so no rung's first use is a capture while serving
        rungs = self.attend_buckets if warm_attends else ()
        for attend in rungs:
            for filtered in (False, True):
                self._run_decode(attend, filtered, idle)
        chunk = {"toks": np.zeros(self.prefill_budget), "start": [0],
                 "length": [1], "write_slot": [sentinel], "slot": [sentinel]}
        if self.prefill_budget > 0:
            for attend in rungs:
                self._run_chunk(attend, self.prefill_budget, chunk)
                for filtered in (False, True):
                    self._run_fused(attend, filtered, {**chunk, **idle})
        if self.spec_k > 0:
            # a verify reads front + spec_k + 1 and climbs the ladder as the
            # decode does: every rung, both sampling variants
            spec = {**idle, **self._idle_verify()}
            for attend in rungs:
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
        # admission programs cover the warmed buckets; the decode, chunk,
        # fused and verify programs cover every rung up to max_seq_len, which
        # a request reaches as it decodes (no capture while serving)
        cover = self._rung(top)
        pad, sent = self._alloc.pad_block, self.num_slots
        # the migration gather and scatter and the logits take and set run
        # eagerly (no capture): exercise them as the reference's warmup
        # does, on pad ids (the gather clips, the scatter writes the
        # scratch block) and the scratch slot row
        ids = torch.full((KV_MIGRATE_GROUP,), pad, dtype=torch.long,
                         device=self.device)
        kv_import(self._pool, ids,
                  [torch.zeros_like(x) for x in kv_export(self._pool, ids)])
        logits_set(self._pool_logits, logits_take(self._pool_logits, sent),
                   sent)
        for a in self.attend_buckets:
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
               priority: Optional[int] = None, trace=None,
               session_id: Optional[str] = None) -> Request:
        req = Request(
            prompt=list(map(int, prompt)),
            max_new_tokens=int(
                self.default_max_new_tokens
                if max_new_tokens is None else max_new_tokens),
            temperature=(None if temperature is None else float(temperature)),
            top_p=(None if top_p is None else float(top_p)),
            top_k=(None if top_k is None else int(top_k)),
            priority=(1 if priority is None else int(priority)),
            trace=trace,
            session_id=(None if session_id is None else str(session_id)),
        )
        if trace is not None:
            # the queue wait opens here and closes when the scheduler
            # reserves a slot (_admit)
            trace.phase("engine.queue", prompt_tokens=len(req.prompt))
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
        """Engine observability snapshot (the reference's keys)."""
        if self.paged:
            a = self._alloc
            allocated = a.num_blocks - a.free_blocks
            live_tokens = sum(
                len(self._slot_content[s]) for s in range(self.num_slots)
                if self._slot_blocks[s])
            host = (self._host_pool.stats() if self._host_pool is not None
                    else {"kv_blocks_host_tier": 0, "kv_host_bytes": 0,
                          "kv_host_capacity_blocks": 0,
                          "kv_host_spills_total": 0,
                          "kv_host_restores_total": 0,
                          "kv_host_evictions_total": 0})
            paged = {
                **a.stats(),
                # the KV tiers: host-RAM occupancy and traffic, spills and
                # thaws through every tier (host and storage), torn spills
                # found at thaw, and the hibernated sessions
                **host,
                "kv_spills_total": self.kv_spills_total,
                "kv_thaws_total": self.kv_thaws_total,
                "kv_thaws_degraded_total": self.kv_thaws_degraded_total,
                "kv_spill_verify_failures_total": (
                    self.spill_store.verify_failures_total
                    if self.spill_store is not None else 0),
                "kv_sessions_hibernated": (
                    self.spill_store.session_count()
                    if self.spill_store is not None else 0),
                # reserved-but-unwritten span across live tables, as a
                # share of the allocated bytes
                "kv_fragmentation_ratio": (
                    0.0 if allocated == 0 else round(max(
                        0.0, 1.0 - live_tokens
                        / (allocated * self.block_size)), 4)),
                "kv_blocks_leaked_total": (
                    self.block_ledger.leaked_total
                    if self.block_ledger is not None else 0),
            }
        else:
            paged = {
                "kv_block_size": 0, "kv_blocks_total": 0,
                "kv_blocks_free": 0, "kv_blocks_cow_copies_total": 0,
                "prefix_block_hits_total": 0,
                "kv_fragmentation_ratio": 0.0,
                "kv_blocks_leaked_total": 0,
                "kv_blocks_host_tier": 0, "kv_host_bytes": 0,
                "kv_host_capacity_blocks": 0, "kv_host_spills_total": 0,
                "kv_host_restores_total": 0,
                "kv_host_evictions_total": 0,
                "kv_spills_total": 0, "kv_thaws_total": 0,
                "kv_thaws_degraded_total": 0,
                "kv_spill_verify_failures_total": 0,
                "kv_sessions_hibernated": 0,
            }
        return {
            **paged,
            "slots_capacity": self.num_slots,
            # analysis: ok host-sync-in-dispatch — host numpy scheduler state
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
            # live migration: sequences imported here (one count a
            # migration), payload bytes both ways, failures counted by the
            # orchestrating layer, and the export -> ack latency histogram
            "kv_migrations_total": self.kv_migrations_total,
            "kv_migrate_bytes_total": self.kv_migrate_bytes_total,
            "kv_migrate_failures_total": self.kv_migrate_failures_total,
            **self._migration_histogram(),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "segments_capacity": self.prefix_segments,
            "segments_live": sum(1 for c in self._seg_content if c),
            "segment_hits": self.segment_hits,
            "segment_tokens_shared": self.segment_tokens_shared,
            "segment_evictions": self.segment_evictions,
            # captures after warmup stall every live request: must stay 0
            "graph_captures_total": self._captures.count,
            # the serving mesh: ranks of the tensor-parallel group, and
            # whether programs replay as CUDA graphs (0 on the CPU and on
            # a gloo group)
            "tp_degree": self.tp_degree,
            "cuda_graphs": int(self.graphs),
            "graph_captures_warmup": self._captures.warmup,
            # the slot pool's KV at max_seq_len (what num_blocks=0 buys)
            "kv_pool_bytes": self.kv_pool_bytes,
            "kv_pool_bytes_allocated": self._pool.nbytes,
            # the program-artifact cache (programs.py): warmup's record
            # and library hits, misses, torn entries; zeros without one
            **(self.program_cache.stats() if self.program_cache is not None
               else programslib.EMPTY_STATS),
        }

    def _migration_histogram(self) -> dict:
        out = {}
        cum = 0
        for b, c in zip(self._mig_buckets, self._mig_lat_counts):
            cum += c
            out[f"kv_migrate_latency_ms_bucket_le_{b:g}"] = cum
        cum += self._mig_lat_counts[-1]
        out["kv_migrate_latency_ms_bucket_le_inf"] = cum
        out["kv_migrate_latency_ms_count"] = cum
        out["kv_migrate_latency_ms_sum"] = round(self._mig_lat_sum, 3)
        return out

    def stop(self) -> None:
        with self._gate:
            self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._spill_thread is not None:
            # the host-tier worker drains its queue, then exits
            self._spill_thread.join(timeout=30)
            self._spill_thread = None
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
        self._fail_migration_waiters(RuntimeError("engine shut down"))
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
        if self._host_pool is not None:
            # the host tier joins the audit: its gauges are conservation
            # checked like the pool's refcounts
            ledger.attach_host_pool(self._host_pool)
        self.block_ledger = ledger

    def audit_blocks(self, timeout: float = 60.0) -> list:
        """Zero-leak audit at a consistent boundary; leak records (empty =
        the invariant holds). On a running engine it runs on the scheduler
        thread through the migration mailbox, between dispatches; on a
        stopped engine or before traffic, directly."""
        if self.block_ledger is None:
            return []
        if self._thread is None or not self._thread.is_alive():
            return self._audit_blocks_now()
        return self._post_migration_op("audit", None, None,
                                       timeout)["leaks"]

    def _held_blocks(self) -> list[int]:
        """Blocks legitimately referenced now: live and frozen slots'
        tables (a frozen migrating slot keeps its blocks until the cutover,
        and a chunked admission reserves its slot up front)."""
        held: list[int] = []
        for slot, blocks in enumerate(self._slot_blocks):
            if blocks and (self._slots[slot] is not None
                           or slot in self._migrating):
                held.extend(blocks)
        return held

    def _audit_blocks_now(self) -> list:
        if self.block_ledger is None or self._alloc is None:
            return []
        if self._host_pool is not None:
            self.block_ledger.audit_host(self._host_pool)
        return self.block_ledger.audit_quiesced(
            self._alloc, held=self._held_blocks())

    # -- moving blocks between the card and the host ---------------------------
    #
    # The scheduler only enqueues, on the engine's stream: the grouped block
    # gathers and their copy into (pinned) host tensors, or the copy of
    # pinned host tensors to the card and the grouped scatters. Whoever reads
    # the host tensors waits on the CUDA event recorded after the copy.

    def _record(self):
        """An event after everything enqueued so far on the engine's stream
        (None on the CPU, where every copy has happened already)."""
        if not self._dispatch.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self._dispatch.stream)
        return ev

    def _to_device(self, arr) -> torch.Tensor:
        """A small host int array on the engine's device, copied without a
        host sync (a pageable copy would wait for the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(arr, np.int64))
        if not self._dispatch.cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, x: torch.Tensor, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """Enqueue the copy of a device tensor into a host tensor (pinned on
        the card); read it after ``_record``'s event."""
        if out is None:
            out = torch.empty(x.shape, dtype=x.dtype,
                              pin_memory=self._dispatch.cuda)
        out.copy_(x, non_blocking=True)
        return out

    def _export_blocks(self, ids: list[int]) -> list[torch.Tensor]:
        """Enqueue the gathers of blocks ``ids`` in groups of
        ``KV_MIGRATE_GROUP`` and their copy to the host: per leaf a host
        tensor [len(ids), ...] in ``MIGRATE_LEAVES`` order. A group's pad
        rows clip and stay on the card: only valid rows are copied."""
        host: list[torch.Tensor] = []
        g = KV_MIGRATE_GROUP
        for i in range(0, len(ids), g):
            grp = ids[i:i + g]
            bt = np.full(g, self._alloc.pad_block, np.int64)
            bt[:len(grp)] = grp
            leaves = kv_export(self._pool, self._to_device(bt))
            if self._tp is not None:
                # a snapshot holds every head, whatever the degree
                leaves = sharded.gather_heads(leaves, self._head_dims(),
                                              self._tp)
            if not host:
                host = [torch.empty((len(ids), *x.shape[1:]), dtype=x.dtype,
                                    pin_memory=self._dispatch.cuda)
                        for x in leaves]
            for h, x in zip(host, leaves):
                self._to_host(x[:len(grp)], h[i:i + len(grp)])
        return host

    def _head_dims(self) -> list[int]:
        """The kv-heads dim of each leaf an export carries."""
        names = self._pool.leaves()
        return sharded.head_dims([n for n in MIGRATE_LEAVES if n in names])

    def _install_logits(self, row: torch.Tensor, slot: int) -> None:
        """Set the pool's logits row ``slot`` (a migration's import or
        resume): from a pinned host row, or a device row stashed at a
        freeze."""
        if row.device.type != self.device.type:
            staged = row
            row = row.to(self.device, non_blocking=True)
            self._hold([staged])
        logits_set(self._pool_logits, row, slot)

    def _hold(self, tensors: list) -> None:
        """Keep the pinned host tensors of copies to the card alive until
        their event; drop the ones whose copies have ended."""
        if not self._dispatch.cuda:
            return
        self._staged = [(t, e) for t, e in self._staged if not e.query()]
        self._staged.append((tensors, self._record()))

    def _import_blocks(self, ids: list[int], leaves: list) -> None:
        """Enqueue the copy of host leaves ([len(ids), ...] each, the
        export's layout) to the card and their scatter into blocks ``ids``,
        in groups of ``KV_MIGRATE_GROUP``. Under tensor parallelism the
        leaves hold every head and this rank keeps its own."""
        if self._tp is not None:
            leaves = [x.contiguous() for x in sharded.local_heads(
                leaves, self._head_dims(), self._tp)]
        if self._dispatch.cuda:
            leaves = [x if x.is_pinned() else x.pin_memory() for x in leaves]
        g = KV_MIGRATE_GROUP
        for i in range(0, len(ids), g):
            m = min(g, len(ids) - i)
            dev = [x[i:i + m].to(self.device, non_blocking=True)
                   for x in leaves]
            kv_import(self._pool, self._to_device(ids[i:i + m]), dev)
        self._hold(leaves)

    # -- the host-RAM tier -----------------------------------------------------

    def _maybe_spill_host(self, slot: int, blocks: list) -> None:
        """The scheduler's spill decision for a retiring sequence's full
        blocks, and the enqueue of their gathers (the worker takes them
        in)."""
        hp = self._host_pool
        if hp is None:
            return
        if self._alloc.free_blocks >= self._host_watermark_blocks:
            return  # no pressure: the pool's free list keeps the prefix
        content = self._slot_content[slot]
        nfull = min(len(content) // self.block_size, len(blocks))
        if nfull == 0:
            return
        toks = list(content[: nfull * self.block_size])
        if hp.contains_prefix(toks, min_tokens=len(toks)):
            return  # already held: a spill again would churn the LRU
        host = self._export_blocks([int(b) for b in blocks[:nfull]])
        self._spill_q.put((toks, host, nfull, self._record()))

    def _host_tier_loop(self) -> None:
        """The ``kv-host-tier`` worker: wait for each spill's copy, then
        admit its blocks to the ``HostBlockPool``."""
        while not (self._stop.is_set() and self._spill_q.empty()):
            try:
                toks, host, n, ev = self._spill_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                t0 = time.perf_counter()
                if ev is not None:
                    ev.synchronize()
                nbytes = sum(int(x.nbytes) for x in host)
                if self._host_pool.put(toks, _block_rows(host, n),
                                       nbytes) >= 0:
                    with self._tier_mu:
                        self.kv_spills_total += 1
                    if self.tracer is not None:
                        # an engine-level phase with no request trace,
                        # observed on this worker, never the scheduler
                        self.tracer.sink.observe_phase(
                            "kv.host_spill", time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — a failed spill costs
                # only the cache entry; the tier never takes the engine down
                log.debug("host-tier spill failed: %s", e)

    def _scatter_host_blocks(self, ids: list, blocks: list) -> None:
        """Scatter host block leaf-lists into pool blocks ``ids`` (the
        host-tier restore and the prefix install; scheduler thread)."""
        self._import_blocks([int(b) for b in ids[:len(blocks)]],
                            _stack_leaves(blocks))

    # -- the storage tier: hibernate and thaw ----------------------------------

    def attach_spill_store(self, store) -> None:
        """Attach the storage tier (``storage.KvSpillStore``):
        hibernate/thaw default to it and ``stats()`` reads its gauges."""
        self.spill_store = store

    def idle_sessions(self, idle_s: float,
                      now: Optional[float] = None) -> list:
        """Live session-bound sequences whose token stream has been quiet
        for ``idle_s``: the idle-session reaper's probe (a copy of the slot
        table; ``hibernate_sequence``'s own export decides)."""
        now = time.perf_counter() if now is None else now
        out = []
        for req in list(self._slots):
            if req is None or req.done.is_set() or not req.session_id:
                continue
            if now - req.last_token_at >= float(idle_s):
                out.append(req)
        return out

    def hibernate_sequence(self, req: Request, session_id: str,
                           store=None, timeout: float = 60.0) -> bool:
        """Spill a live sequence to the storage tier and retire it: the
        export snapshot goes through the store's atomic, manifest-verified
        write, then the slot is released (its blocks return to the free
        list, prefix-registered). The handle stays unresolved;
        ``thaw_sequence`` on any engine sharing the store resumes it. A
        write that fails publishes nothing and the sequence resumes in
        place. Runs on the caller's thread. False when the request already
        finished."""
        store = store or self.spill_store
        if store is None:
            raise RuntimeError("no spill store attached "
                               "(attach_spill_store)")
        t0 = time.perf_counter()
        if req.trace is not None:
            req.trace.phase("kv.hibernate", session=session_id)
        snap = self.export_sequence(req, timeout)
        if snap is None:
            return False
        toks = [int(t) for t in snap["prompt"]] + \
            [int(t) for t in snap.get("generated", ())]
        wsp = (req.trace.begin("kv.spill_write")
               if req.trace is not None else None)
        try:
            store.write(session_id, snap,
                        block_keys=block_keys(toks, self.block_size))
        except Exception:
            if wsp is not None:
                wsp.set(error=True).done()
            try:
                self.resume_sequence(req, timeout)
            except (RuntimeError, TimeoutError):
                pass
            raise
        if wsp is not None:
            wsp.done()
        self.release_sequence(req, timeout)
        with self._tier_mu:
            self.kv_spills_total += 1
        if self.tracer is not None:
            self.tracer.sink.observe_phase(
                "kv.hibernate", time.perf_counter() - t0,
                req.trace.trace_id if req.trace is not None else "")
        return True

    def thaw_sequence(self, session_id: str, store=None,
                      req: Optional[Request] = None,
                      timeout: float = 60.0) -> tuple[Request, dict]:
        """Resume a hibernated session from the storage tier (any engine
        sharing the store), behind the optional ``thaw_gate`` (a context
        manager that caps concurrent thaws). Returns ``(req, info)``:

        - a verified payload: ``import_sequence`` scatters the spilled
          blocks and decoding resumes at the exact position;
        - a torn payload (a hash mismatch): never scattered; the session
          re-prefills from the manifest's token record
          (``info["degraded"]``, the same greedy tokens);
        - an unreadable manifest: ``storage.SpillCorrupt``.

        ``info["tokens"]`` holds the tokens generated before hibernation.
        The spill entry is consumed."""
        gate = getattr(self, "thaw_gate", None)
        if gate is not None:
            with gate:
                return self._thaw_sequence_gated(
                    session_id, store, req, timeout)
        return self._thaw_sequence_gated(session_id, store, req, timeout)

    def _thaw_sequence_gated(self, session_id: str, store=None,
                             req: Optional[Request] = None,
                             timeout: float = 60.0
                             ) -> tuple[Request, dict]:
        store = store or self.spill_store
        if store is None:
            raise RuntimeError("no spill store attached "
                               "(attach_spill_store)")
        t0 = time.perf_counter()
        if req is not None and req.trace is not None:
            req.trace.phase("kv.thaw", session=session_id)
        snap, ok = store.read(session_id)
        prior = [int(t) for t in snap.get("generated", ())]
        if ok:
            new_req = self.import_sequence(snap, req=req, timeout=timeout)
        else:
            prompt = [int(t) for t in snap["prompt"]]
            remaining = (int(snap["remaining"])
                         if snap.get("phase") == "decode"
                         else int(snap["max_new_tokens"]))
            # the handle's budget counts delivered tokens and the prior
            # transcript rides the handle: prior + remainder; the
            # snapshot's max_new_tokens below stays the remainder (it sizes
            # the block span over the re-prefilled prompt)
            if req is None:
                req = Request(
                    prompt=prompt, max_new_tokens=len(prior) + remaining,
                    temperature=snap.get("temperature"),
                    top_p=snap.get("top_p"), top_k=snap.get("top_k"),
                    priority=int(snap.get("priority", 1)))
                req.tokens = list(prior)
            else:
                req.max_new_tokens = len(prior) + remaining
            re_snap = {
                "v": 1, "phase": "prefill", "block_size": self.block_size,
                # prompt and prior generation re-prefill as one prompt: the
                # chunked-prefill math, so the continuation is the same
                "prompt": prompt + prior, "generated": [],
                "position": 0, "remaining": remaining,
                "max_new_tokens": remaining,
                "temperature": snap.get("temperature"),
                "top_p": snap.get("top_p"), "top_k": snap.get("top_k"),
                "priority": int(snap.get("priority", 1)),
                "spec_ban": -1, "blocks": [],
            }
            new_req = self.import_sequence(re_snap, req=req,
                                           timeout=timeout)
            with self._tier_mu:
                self.kv_thaws_degraded_total += 1
        store.delete(session_id)
        with self._tier_mu:
            self.kv_thaws_total += 1
        if self.tracer is not None:
            self.tracer.sink.observe_phase(
                "kv.thaw", time.perf_counter() - t0,
                new_req.trace.trace_id if new_req.trace is not None else "")
        return new_req, {"degraded": not ok, "tokens": prior,
                         "session": session_id}

    # -- prefix export and install across engines ------------------------------

    def export_prefix_blocks(self, tokens: list[int],
                             timeout: float = 60.0) -> tuple[list[int], list]:
        """(covered tokens, host block leaf-lists) of the longest full-block
        prefix of ``tokens`` this pool holds (live slots or the registry of
        retired sequences): what a cold engine installs instead of
        prefilling a hot prefix. The gathers are enqueued on the
        scheduler; the copy is awaited here, on the caller's thread."""
        if not self.paged:
            raise RuntimeError("prefix export requires the paged pool")
        sharded.refuse_expert(self.mesh_axes, "a kv_migrate prefix export")
        out = self._post_migration_op("export_prefix",
                                      [int(t) for t in tokens], None,
                                      timeout)
        host, n, ev = out["fetch"]
        if ev is not None:
            ev.synchronize()
        return out["covered"], _block_rows(host, n)

    def install_prefix(self, tokens: list[int], blocks: list,
                       timeout: float = 60.0) -> bool:
        """Install a fetched prefix (host block leaf-lists, one per full
        block of ``tokens``) into this pool's registry: alloc, scatter,
        register, release; the next same-prefix admission shares the
        blocks instead of prefilling. False when the pool has no room
        (never evicts a live sequence)."""
        if not self.paged:
            raise RuntimeError("prefix install requires the paged pool")
        out = self._post_migration_op(
            "install_prefix", [int(t) for t in tokens], blocks, timeout)
        return bool(out.get("ok"))

    def prefix_census(self, timeout: float = 30.0) -> list:
        """Copies of every block-registered token record (live slots and
        the registry), taken at a scheduler boundary, for
        ``paged.prefix_digest``. Empty when the scheduler has not started
        (a probe must not start the pool)."""
        if not self.paged or self._thread is None:
            return []
        try:
            out = self._post_migration_op("prefix_census", None, None,
                                          timeout)
        except (RuntimeError, TimeoutError):
            return []
        return out.get("tokens", [])

    def _mig_export_prefix(self, tokens: list[int], out: dict) -> None:
        # uncapped: a prefix export may cover the whole token record
        blocks, n = self._paged_match(tokens, cap=len(tokens))
        nfull = n // self.block_size
        host = self._export_blocks([int(b) for b in blocks[:nfull]])
        out["covered"] = tokens[: nfull * self.block_size]
        out["fetch"] = (host, nfull, self._record())

    def _mig_prefix_census(self, out: dict) -> None:
        records = []
        for s in range(self.num_slots):
            content = self._slot_content[s]
            if self._slot_blocks[s] and len(content) >= self.block_size:
                # analysis: ok host-sync-in-dispatch — host token list, no device value
                records.append(np.asarray(content, np.int64))
        for toks, blocks in self._alloc._seqs.values():
            # analysis: ok host-sync-in-dispatch — host token list, no device value
            records.append(np.asarray(
                toks[: len(blocks) * self.block_size], np.int64))
        out["tokens"] = records

    def _mig_install_prefix(self, tokens: list[int], blocks: list,
                            out: dict) -> None:
        n = min(len(blocks), len(tokens) // self.block_size)
        if n == 0:
            out["ok"] = False
            return
        table = self._alloc.alloc(n)
        if table is None:
            out["ok"] = False  # no room: never evict a live sequence
            return
        self._scatter_host_blocks(table, blocks[:n])
        if self.block_ledger is not None:
            self.block_ledger.annotate(self._alloc, table,
                                       "registry:install_prefix")
        self._alloc.register(tokens[: n * self.block_size], table)
        self._alloc.release(table)
        with self._tier_mu:
            self.kv_thaws_total += 1
        out["ok"] = True

    # -- live KV migration -------------------------------------------------------
    #
    # The unit is the paged block: export gathers a sequence's written
    # blocks to the host, import allocates and scatters them on the
    # destination, and the scheduler state (position, budget, sampling
    # knobs, the next-token logits row) rides along, so the destination
    # resumes at the exact position. Copy then cutover: export freezes the
    # slot and frees nothing; release (after the destination acknowledged)
    # retires it, and resume unfreezes it after a failed transfer. Every
    # pool and scheduler mutation runs on the scheduler thread through the
    # mailbox; the wait for the host copy runs on the caller's thread.

    def export_sequence(self, req: Request,
                        timeout: float = 60.0) -> Optional[dict]:
        """Copy step: snapshot ``req``'s live KV and scheduler state.
        Freezes the slot at a dispatch boundary (in-flight dispatches are
        delivered first) and returns a host snapshot: block leaves as
        torch CPU tensors (per block a list in ``MIGRATE_LEAVES`` order,
        block axis first) and the logits row, ready for
        ``import_sequence`` on any engine. None when the request already
        finished. The source stays intact until ``release_sequence``."""
        if not self.paged:
            raise RuntimeError(
                "KV migration requires the paged pool (block_size > 0)")
        sharded.refuse_expert(self.mesh_axes, "a kv_migrate export")
        xsp = (req.trace.begin("kv.export")
               if req.trace is not None else None)
        out = self._post_migration_op("export", req, None, timeout)
        snap = out.get("snap")
        if snap is None:
            if xsp is not None:
                xsp.set(empty=True).done()
            return None
        host, n, row, ev = snap.pop("fetch")
        if ev is not None:
            ev.synchronize()
        snap["blocks"] = _block_rows(host, n)
        nbytes = sum(int(x.nbytes) for x in host)
        if row is not None:
            snap["logits"] = row
            nbytes += int(row.nbytes)
        with self._tier_mu:
            self.kv_migrate_bytes_total += nbytes
        if xsp is not None:
            xsp.done(blocks=len(snap["blocks"]), bytes=nbytes)
            # the context rides the snapshot, so an import on a fresh
            # handle (another process) continues the same trace; an
            # in-process import shares the handle and needs nothing
            snap["trace"] = req.trace.wire_context()
        return snap

    def import_sequence(self, snapshot: dict, req: Optional[Request] = None,
                        timeout: float = 60.0, hold: bool = False) -> Request:
        """Cutover step: install an exported sequence into this pool.

        Allocates the sequence's whole remaining span (exhaustion raises,
        never a partial hold: the source then resumes), scatters the
        blocks, installs the logits row and scheduler state and resumes
        decoding at the exact position. ``req`` re-targets an existing
        handle (in-process handoff); None builds a fresh one from the
        snapshot. ``hold=True`` installs the sequence frozen until
        ``resume_sequence``. The snapshot's leaves (this port's or the
        reference's numpy ones) are staged into pinned host tensors here,
        on the caller's thread."""
        if not self.paged:
            raise RuntimeError(
                "KV migration requires the paged pool (block_size > 0)")
        if snapshot is None:
            raise ValueError(
                "snapshot is None — the sequence had already finished "
                "on the source (export_sequence returned None)")
        blocks = snapshot.get("blocks", [])
        leaves = _stack_leaves(blocks) if blocks else []
        row = snapshot.get("logits")
        if row is not None and not isinstance(row, torch.Tensor):
            # analysis: ok host-sync-in-dispatch — host numpy logits row
            row = torch.from_numpy(np.array(row))
        if self._dispatch.cuda:
            leaves = [x if x.is_pinned() else x.pin_memory() for x in leaves]
            if row is not None and not row.is_pinned():
                row = row.pin_memory()
        isp = (req.trace.begin("kv.import", blocks=len(blocks), hold=hold)
               if req is not None and req.trace is not None else None)
        try:
            out = self._post_migration_op(
                "import", snapshot, (req, hold, leaves, row), timeout)
        except Exception as e:
            if isp is not None:
                isp.set(error=str(e)).done()
            raise
        if isp is not None:
            isp.done()
        return out["req"]

    def take_waiting(self, timeout: float = 60.0) -> list:
        """Withdraw every queued, unadmitted request (on the scheduler
        thread, which owns the waiting list)."""
        return self._post_migration_op("take_waiting", None, None,
                                       timeout)["reqs"]

    def quiesced_live_requests(self, timeout: float = 60.0) -> list:
        """Every admitted, unfinished request, read on the scheduler thread
        after any admission cycle in progress."""
        return self._post_migration_op("live_slots", None, None,
                                       timeout)["reqs"]

    def adopt_request(self, req: Request) -> None:
        """Queue an existing Request handle (its streamed tokens kept)."""
        if req.trace is not None:
            req.trace.phase("engine.queue", adopted=True)
        with self._gate:
            if self._error is not None:
                raise RuntimeError(
                    f"engine failed: {self._error!r}") from self._error
            if self._stop.is_set():
                raise RuntimeError("engine is shutting down")
            self._queue.put(req)
            self._ensure_running()
        self._wake.set()

    def resume_sequence(self, req: Request, timeout: float = 60.0) -> None:
        """Abort a migration: unfreeze the exported slot, so the source
        decodes on as if the transfer never happened."""
        self._post_migration_op("resume", req, None, timeout)

    def release_sequence(self, req: Request, timeout: float = 60.0) -> None:
        """Commit the cutover after the destination acknowledged: retire
        the source slot. Its blocks join the free list with the sequence
        registered, so it stays prefix-matchable here until they are
        reused."""
        self._post_migration_op("release", req, None, timeout)

    def observe_migration_ms(self, ms: float) -> None:
        """Record one completed migration's export -> ack latency."""
        for i, b in enumerate(self._mig_buckets):
            if ms <= b:
                break
        else:
            i = len(self._mig_buckets)
        with self._tier_mu:
            self._mig_lat_counts[i] += 1
            self._mig_lat_sum += float(ms)

    def _note_migrate_failure(self) -> None:
        with self._tier_mu:
            self.kv_migrate_failures_total += 1

    def _post_migration_op(self, kind: str, a, b, timeout: float) -> dict:
        ev = threading.Event()
        out: dict = {}
        with self._gate:
            if self._error is not None:
                raise RuntimeError(
                    f"engine failed: {self._error!r}") from self._error
            if self._stop.is_set():
                raise RuntimeError("engine is shutting down")
            self._migrate_q.put((kind, a, b, ev, out))
            self._ensure_running()
        self._wake.set()
        if not ev.wait(timeout):
            # abandon the op so it never runs later: a stale import landing
            # after the caller resumed the source would decode one request
            # twice. Either the scheduler already took it (wait out its
            # bounded run) or it will skip it.
            out["abandoned"] = True
            if not (out.get("taken") and ev.wait(60)):
                raise TimeoutError(
                    f"migration {kind} not serviced within {timeout}s")
        err = out.get("error")
        if err is not None:
            raise err if isinstance(err, Exception) \
                else RuntimeError(str(err))
        return out

    def _service_migrations(self, pending) -> None:
        """The scheduler's mailbox pump, between dispatches."""
        while True:
            try:
                kind, a, b, ev, out = self._migrate_q.get_nowait()
            except queue.Empty:
                return
            out["taken"] = True
            if out.get("abandoned"):
                out["error"] = RuntimeError("migration op abandoned")
                ev.set()
                continue
            try:
                if kind == "export":
                    self._mig_export(a, out, pending)
                elif kind == "freeze":
                    self._mig_freeze(a, pending)
                elif kind == "import":
                    self._mig_import(a, *b, out)
                elif kind == "resume":
                    self._mig_resume(a)
                elif kind == "take_waiting":
                    self._mig_take_waiting(out)
                elif kind == "audit":
                    out["leaks"] = self._audit_blocks_now()
                elif kind == "export_prefix":
                    self._mig_export_prefix(a, out)
                elif kind == "prefix_census":
                    self._mig_prefix_census(out)
                elif kind == "install_prefix":
                    self._mig_install_prefix(a, b, out)
                elif kind == "live_slots":
                    out["reqs"] = [r for r in self._slots
                                   if r is not None and not r.done.is_set()]
                else:
                    self._mig_release(a)
            except Exception as e:  # noqa: BLE001 — resolve THIS waiter
                out["error"] = e
            ev.set()

    def _fail_migration_waiters(self, e: Exception) -> None:
        """Resolve every queued mailbox op with ``e`` (engine death or
        shutdown), so no caller hangs on the mailbox."""
        while True:
            try:
                *_a, ev, out = self._migrate_q.get_nowait()
            except queue.Empty:
                return
            out["error"] = e
            ev.set()

    def _find_req_slot(self, req: Request) -> Optional[int]:
        for i, r in enumerate(self._slots):
            if r is req:
                return i
        return None

    def _mig_export(self, req: Request, out: dict, pending) -> None:
        # deliver every dispatch in flight first (a verify's accept lengths
        # included): position, delivered tokens and content must agree
        # before the snapshot freezes them
        while pending:
            self._process(*pending.pop(0))
        slot = self._find_req_slot(req)
        if slot is None or req.done.is_set():
            out["snap"] = None  # finished or cancelled: nothing to move
            return
        rec = self._migrating.get(slot) or self._freeze(slot, req)
        out["snap"] = self._snapshot_slot(slot, req, rec.get("entry"), rec)

    def _freeze(self, slot: int, req: Request) -> dict:
        """Freeze a slot for migration (dispatches in flight delivered):
        no later dispatch advances it until resume or release."""
        # a sequence mid-prefill freezes at its chunk boundary: pull its
        # admission entry so no later chunk advances it meanwhile
        entry = next((e for e in self._prefilling if e[0] is req), None)
        rec = {"req": req, "entry": entry}
        if entry is not None:
            self._prefilling.remove(entry)
            self._prefill_tokens_inflight -= len(entry[2]) - entry[3]
        else:
            self._active[slot] = False
            # every decode dispatch rewrites every slot's logits row, frozen
            # ones too: the snapshot and a resume read the row as it was at
            # the freeze
            rec["logits"] = logits_take(self._pool_logits, slot)
        self._migrating[slot] = rec
        return rec

    def _mig_freeze(self, reqs: list, pending) -> None:
        """Freeze every live request of ``reqs`` in one boundary (a
        drain's first step)."""
        while pending:
            self._process(*pending.pop(0))
        for req in reqs:
            slot = self._find_req_slot(req)
            if (slot is not None and not req.done.is_set()
                    and slot not in self._migrating):
                self._freeze(slot, req)

    def _snapshot_slot(self, slot: int, req: Request, entry, rec) -> dict:
        """The snapshot, with its block gathers and their copy to the host
        enqueued under ``"fetch"`` (the caller waits on its event)."""
        bs = self.block_size
        if entry is not None:
            phase = "prefill"
            prompt, position = list(entry[2]), int(entry[3])
            generated: list[int] = []
            remaining = int(req.max_new_tokens)
            row = None
            temp = (self.temperature if req.temperature is None
                    else req.temperature)
            top_p = 1.0 if req.top_p is None else req.top_p
            top_k = 0 if req.top_k is None else req.top_k
        else:
            phase = "decode"
            position = int(self._positions[slot])
            generated = list(req.tokens)
            content = list(self._slot_content[slot])
            prompt = content[: max(position - len(generated), 0)]
            remaining = int(self._remaining[slot])
            row = rec.get("logits")
            if row is None:
                row = logits_take(self._pool_logits, slot)
            temp = float(self._temps[slot])
            top_p = float(self._top_ps[slot])
            top_k = int(self._top_ks[slot])
        nwritten = (min(-(-position // bs), len(self._slot_blocks[slot]))
                    if position > 0 else 0)
        ids = [int(b) for b in self._slot_blocks[slot][:nwritten]]
        host = self._export_blocks(ids)
        host_row = None if row is None else self._to_host(row)
        return {
            "v": 1, "phase": phase, "block_size": bs,
            "prompt": [int(t) for t in prompt],
            "generated": [int(t) for t in generated],
            "position": position, "remaining": remaining,
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(temp), "top_p": float(top_p),
            "top_k": int(top_k), "priority": int(req.priority),
            "spec_ban": int(self._spec_ban[slot]),
            "fetch": (host, len(ids), host_row, self._record()),
        }

    def _mig_take_waiting(self, out: dict) -> None:
        reqs = [r for r in self._waiting if not r.done.is_set()]
        self._waiting.clear()
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if not r.done.is_set():
                reqs.append(r)
        out["reqs"] = reqs

    def _mig_import(self, snap: dict, req: Optional[Request], hold: bool,
                    leaves: list, row, out: dict) -> None:
        bs = int(snap["block_size"])
        if bs != self.block_size:
            raise ValueError(
                f"block_size mismatch: snapshot {bs} vs pool "
                f"{self.block_size}")
        phase = snap.get("phase", "decode")
        position = int(snap["position"])
        remaining = int(snap["remaining"])
        prompt = [int(t) for t in snap["prompt"]]
        generated = [int(t) for t in snap.get("generated", ())]
        nblocks = len(snap.get("blocks", ()))
        if phase == "prefill":
            total = len(prompt) + int(snap["max_new_tokens"])
        else:
            total = position + remaining
        nb_total = max(-(-total // bs), nblocks, 1)
        if nb_total > self._alloc.num_blocks:
            raise RuntimeError(
                f"sequence needs {nb_total} KV blocks but the pool has "
                f"{self._alloc.num_blocks}")
        free = [i for i, r in enumerate(self._slots) if r is None]
        if not free:
            raise RuntimeError("no free slot on the destination pool")
        table = self._alloc.alloc(nb_total)
        if table is None:
            raise RuntimeError(
                f"destination pool exhausted: {self._alloc.free_blocks} "
                f"free blocks < {nb_total} needed")
        slot = free[0]
        try:
            nbytes = sum(int(x.nbytes) for x in leaves)
            if nblocks:
                self._import_blocks([int(b) for b in table[:nblocks]],
                                    leaves)
            if req is None:
                req = Request(
                    prompt=prompt,
                    max_new_tokens=int(snap["max_new_tokens"]),
                    temperature=snap.get("temperature"),
                    top_p=snap.get("top_p"), top_k=snap.get("top_k"),
                    priority=int(snap.get("priority", 1)))
                req.tokens = list(generated)
                if self.tracer is not None and snap.get("trace"):
                    # an import on a fresh handle continues the exporter's
                    # trace; no door finishes it, so the tracer's reap
                    # does once the request is done
                    req.trace = self.tracer.adopt(snap["trace"])
                    self.tracer.watch(req.done, req.trace)
            self._slots[slot] = req
            self._slot_blocks[slot] = [int(b) for b in table]
            if self.block_ledger is not None:
                self.block_ledger.annotate(self._alloc, table,
                                           f"slot{slot}:import")
            req.slot = slot
            req.admitted_step = self.step_counter
            if phase == "prefill":
                self._slot_content[slot] = prompt[:position]
                self._slot_owner[slot] = None
                self._active[slot] = False
                entry = [req, slot, prompt, position]
                if hold:
                    # installed frozen: the admission entry waits in the
                    # freeze record, and resume queues it at the head
                    self._migrating[slot] = {"req": req, "entry": entry}
                else:
                    self._prefilling.append(entry)
                    self._prefill_tokens_inflight += len(prompt) - position
                    if req.trace is not None:
                        req.trace.phase("engine.prefill", slot=slot,
                                        imported=True)
            else:
                nbytes += int(row.nbytes)
                self._install_logits(row, slot)
                self._slot_content[slot] = prompt + generated
                self._slot_owner[slot] = req
                self._positions[slot] = position
                self._remaining[slot] = remaining
                self._temps[slot] = float(snap.get("temperature") or 0.0)
                self._top_ps[slot] = float(snap.get("top_p") or 1.0)
                self._top_ks[slot] = int(snap.get("top_k") or 0)
                self._spec_ban[slot] = int(snap.get("spec_ban", -1))
                self._spec_backoff[slot] = 0
                self._spec_cool[slot] = 0
                if hold:
                    self._active[slot] = False
                    # resumed neighbours' dispatches rewrite a held row
                    self._migrating[slot] = {
                        "req": req, "entry": None,
                        "logits": logits_take(self._pool_logits, slot)}
                else:
                    self._active[slot] = not req.done.is_set()
                    if req.trace is not None:
                        req.trace.phase("engine.decode", slot=slot,
                                        imported=True)
            self.kv_migrations_total += 1
            with self._tier_mu:
                self.kv_migrate_bytes_total += nbytes
            out["req"] = req
        except Exception:
            # unwind fully: no leaked block, no half-occupied slot (the
            # source still owns the sequence)
            self._slots[slot] = None
            self._slot_blocks[slot] = []
            self._slot_content[slot] = []
            self._active[slot] = False
            self._migrating.pop(slot, None)
            self._alloc.release(table)
            raise

    def _mig_resume(self, req: Request) -> None:
        slot = self._find_req_slot(req)
        if slot is None:
            return  # finished and swept while the transfer ran
        rec = self._migrating.pop(slot, None)
        if rec is None or req.done.is_set():
            # never frozen (an abandoned export, or a resume racing a
            # cutover): nothing to undo; a done request is swept next
            return
        if rec.get("entry") is not None:
            e = rec["entry"]
            # mid-admission: resume at the head of the queue
            self._prefilling.appendleft(e)
            self._prefill_tokens_inflight += len(e[2]) - e[3]
            if req.trace is not None:
                req.trace.phase("engine.prefill", resumed=True)
        else:
            if rec.get("logits") is not None:
                # reinstall the row as it was at the freeze
                self._install_logits(rec["logits"], slot)
            self._active[slot] = True
            if req.trace is not None:
                req.trace.phase("engine.decode", resumed=True)
        # a freeze is not idleness: restart the idle clock
        req.last_token_at = time.perf_counter()

    def _mig_release(self, req: Request) -> None:
        slot = self._find_req_slot(req)
        if slot is None:
            return
        # the destination owns the sequence now; the handle is not
        # resolved (it keeps taking tokens there). kv_migrations_total
        # counts on the importing side only.
        self._retire_slot(slot)

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
            if (self.admission_policy is not None
                    and not self.admission_policy(req)):
                # the policy says not now (the tier ladder's class quota is
                # full): defer without taking a slot
                deferred.append(req)
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
            if req.trace is not None:
                # the queue wait ends at the slot's reservation
                req.trace.phase("engine.prefill", slot=slot,
                                queue_depth=len(self._waiting))
            taken.append((req, slot))
        if deferred:
            self._waiting = deferred + self._waiting
        if not taken:
            return
        if self.paged:
            self._admit_paged(taken, plans)
            return
        stall_t0 = time.perf_counter()
        # analysis: ok host-sync-in-dispatch — host numpy scheduler state
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
                    # analysis: ok host-sync-in-dispatch — host numpy scheduler state
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
        # analysis: ok host-sync-in-dispatch — host token list, no device value
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
        if req.trace is not None:
            # prefill (or an import) ends at activation; decode begins
            req.trace.phase("engine.decode", slot=slot)
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
        # analysis: ok host-sync-in-dispatch — host token list, no device value
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
        """(prompt, start, table, cow_src, shared, restore) with the
        request's whole span (prompt + max_new_tokens) reserved, or None
        when the free list cannot host it. A span no empty pool could host
        fails the request.

        Prefix reuse at block granularity: the full blocks of the best
        matching live or retired sequence are shared by refcount; a match
        that ends inside a block forks that block (``cow_src``) into the
        first fresh one, and the prefill starts at the divergence. A deeper
        full-block prefix in the host tier wins over both: ``restore`` =
        (host entry, blocks) scattered into the first fresh blocks."""
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
        start, shared, cow_src, restore = 0, [], None, None
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
            if self._host_pool is not None:
                # a deeper prefix than any in the pool may survive in host
                # RAM: scattering it back beats prefilling it again (full
                # blocks only, into fresh blocks)
                hid, hlcp = self._host_pool.match(
                    # analysis: ok host-sync-in-dispatch — host token list, no device value
                    np.asarray(prompt, np.int64), len(prompt) - 1)
                hstart = (hlcp // bs) * bs
                if hstart > start and hstart >= self.min_prefix:
                    shared, cow_src = [], None
                    start = hstart
                    restore = (hid, hstart // bs)
        # pin the shared blocks out of the free list before allocating
        self._alloc.ref(shared)
        fresh = self._alloc.alloc(nb_total - len(shared))
        if fresh is None:
            self._alloc.release(shared)
            return None
        if shared:
            self._alloc.prefix_block_hits_total += len(shared)
        return prompt, start, shared + fresh, cow_src, len(shared), restore

    def _paged_match(self, prompt: list[int],
                     cap: Optional[int] = None) -> tuple[tuple, int]:
        """(blocks, lcp): the best block-backed prefix of ``prompt``, from
        the live slots' content first, then the allocator's registry of
        retired sequences (freed blocks not yet reused). The match is
        capped at ``cap`` tokens, by default ``len(prompt) - 1`` (one
        suffix token must run for the next-token logits)."""
        cap = len(prompt) - 1 if cap is None else cap
        if cap <= 0:
            return (), 0
        # analysis: ok host-sync-in-dispatch — host token list, no device value
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
        # analysis: ok host-sync-in-dispatch — host numpy scheduler state
        had_live = bool(self._active.any())
        dispatched = False
        for (req, slot), (prompt, start, table, cow_src, shared,
                          restore) in zip(taken, plans):
            if restore is not None:
                hid, nfull = restore
                host_blk = self._host_pool.take(hid, nfull)
                if host_blk is None or len(host_blk) < nfull:
                    start = 0  # evicted since the match: prefill it all
                else:
                    self._scatter_host_blocks(table[:nfull], host_blk)
                    with self._tier_mu:
                        self.kv_thaws_total += 1
                    dispatched = True
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
                if req.trace is not None:
                    # the COW fork is a named cost on the trace
                    req.trace.begin("kv.cow", src=int(cow_src),
                                    dst=int(table[shared])).done()
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
        self._migrating.pop(slot, None)
        self._release_seg(slot)
        if self.paged and self._slot_blocks[slot]:
            blocks = self._slot_blocks[slot]
            if self.prefix_cache:
                self._alloc.register(self._slot_content[slot], blocks)
                # under free-list pressure this registration is about to
                # be reused: enqueue the spill's gathers now, on the
                # engine's stream, so they read today's bytes before any
                # later dispatch overwrites the released blocks
                self._maybe_spill_host(slot, blocks)
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
            self._fail_migration_waiters(e)

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
            if self.role == "prefill" and self.on_prefilled is not None:
                # the disaggregation handoff: freeze at the chunk boundary
                # (the final chunk's logits are in the slot's row, stashed
                # against later dispatches), so the destination samples the
                # first token as this engine would have. The hook only
                # queues; a hook that raises falls back to decoding here.
                self._active[slot] = False
                self._migrating[slot] = {
                    "req": req, "entry": None,
                    "logits": logits_take(self._pool_logits, slot)}
                if req.trace is not None:
                    # prefill ends frozen at the chunk boundary; the
                    # handoff runs until the decode engine's import
                    # activates the sequence
                    req.trace.phase("engine.handoff", slot=slot)
                try:
                    self.on_prefilled(req)
                except Exception as e:  # noqa: BLE001 — degrade to mixed
                    log.debug("on_prefilled hook failed: %s", e)
                    self._migrating.pop(slot, None)
                    self._active[slot] = True

    def _loop_inner(self) -> None:
        # dispatches in flight: (fetch handle, [(slot, req, take)], the
        # verify's drafts or None, the traced requests' dispatch spans)
        pending: list[tuple[Any, list, Any, Any]] = []
        while not self._stop.is_set():
            self._service_migrations(pending)
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
                        or not self._queue.empty()
                        or not self._migrate_q.empty()):
                    continue
                if self.block_ledger is not None and not self._migrating:
                    # fully idle, nothing frozen: every block still
                    # referenced outside a slot table is a leak
                    self._audit_blocks_now()
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            # analysis: ok host-sync-in-dispatch — host numpy scheduler state
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
            # any sampled request in this dispatch? Stays False, and
            # nothing below allocates, when no request is traced
            traced = any(r.trace is not None for _, r, _ in snapshot)
            family, rung = "decode", 0  # the dispatch spans' attrs
            live_seg = (live and self.prefix_segments > 0
                        # analysis: ok host-sync-in-dispatch — host numpy scheduler state
                        and bool((self._slot_plen[self._active] > 0).any()))
            use_spec, drafts, proposed = (
                self._plan_spec() if live and self.spec_k > 0 and not live_seg
                else (False, None, 0))
            # the window covers every live position plus this dispatch's
            # writes: decode_chunk steps, or the verify's t1 + spec_k drafts
            span = self.spec_k + 1 if use_spec else self.decode_chunk
            # analysis: ok host-sync-in-dispatch — host numpy scheduler state
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
                    # analysis: ok host-sync-in-dispatch — host numpy scheduler state
                    int(self._slot_plen[self._active].max()))
                host = {**self._host_decode(),
                        "plens": np.where(self._active, self._slot_plen, 0),
                        "seg_ids": self._slot_seg.copy()}
                family, rung = "seg_decode", self._rung(needed)
                toks = self._run_prefix_decode(rung, seg_att, filtered, host)
            elif live and can_fuse:
                entry, chunk, take, final, p_needed = (
                    self._prefill_chunk_args())
                a = self._rung(max(needed, p_needed))
                host = {**chunk, **self._host_decode(), **spec}
                if self.paged:
                    host["bt"] = self._block_tables(a)
                run = self._run_fused_verify if use_spec else self._run_fused
                family = (("paged_" if self.paged else "")
                          + ("fused_verify" if use_spec else "fused"))
                rung = a
                psp = (entry[0].trace.begin(
                    "prefill.chunk", take=take, offset=int(entry[3]),
                    final=final, fused=True)
                    if entry[0].trace is not None else None)
                try:
                    toks = run(a, filtered, host)
                except Exception as e:  # noqa: BLE001 — fail THIS request
                    if psp is not None:
                        psp.set(error=str(e)).done()
                    self._fail_prefill_head(entry, e)
                    continue
                if psp is not None:
                    psp.done()
                self._advance_prefill(entry, take, final)
            elif live:
                a = self._rung(needed)
                host = {**self._host_decode(), **spec}
                if self.paged:
                    host["bt"] = self._block_tables(a)
                run = self._run_verify if use_spec else self._run_decode
                family = (("paged_" if self.paged else "")
                          + ("verify" if use_spec else "decode"))
                rung = a
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
                    psp = (entry[0].trace.begin(
                        "prefill.chunk", take=take, offset=int(entry[3]),
                        final=final, fused=False)
                        if entry[0].trace is not None else None)
                    try:
                        self._run_chunk(a, len(chunk["toks"]), chunk)
                    except Exception as e:  # noqa: BLE001 — fail THIS
                        if psp is not None:
                            psp.set(error=str(e)).done()
                        self._fail_prefill_head(entry, e)
                        break
                    if psp is not None:
                        psp.done()
                    self._advance_prefill(entry, take, final)
                    if not (self.paged and self.prefill_budget == 0):
                        break  # budgeted chunks: one a dispatch cycle
            if not live:
                while pending:
                    self._process(*pending.pop(0))
                continue
            # per-request dispatch spans: enqueue to tokens on the host,
            # with the program family and attend rung dispatched (closed
            # by _process)
            dspans = ([r.trace.begin("dispatch", family=family,
                                     rung=int(rung), step=self.step_counter)
                       for _, r, _ in snapshot if r.trace is not None]
                      if traced else None)
            if use_spec:
                # counted here, not when planned: a failed fused verify
                # verified nothing
                self.spec_dispatches_total += 1
                self.spec_tokens_proposed_total += proposed
                # the advance depends on the accept lengths: _process
                # applies it once the tokens are on the host
                pending.append((self._fetch_start(toks), snapshot, drafts,
                                dspans))
            else:
                # advance the value-independent schedule now, so the next
                # dispatch can go before this one's tokens are fetched
                for slot, req, take in snapshot:
                    self._positions[slot] += self.decode_chunk
                    self._remaining[slot] -= take
                    if self._remaining[slot] <= 0:
                        self._retire_slot(slot)
                pending.append((self._fetch_start(toks), snapshot, None,
                                dspans))
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
        # analysis: ok host-sync-in-dispatch — host numpy scheduler state
        use = proposed > 0 or bool((self._spec_ban[self._active] >= 0).any())
        return use, drafts, proposed

    def _process(self, handle, snapshot, drafts=None, spans=None) -> None:
        """Wait for one dispatch's tokens and deliver them (a verify's
        through ``_deliver_verify``)."""
        toks = self._dispatch.fetch(handle)  # [slots, chunk]
        now = time.perf_counter()
        if spans:
            # the dispatch spans close when the tokens land (a timestamp,
            # never finalization)
            for sp in spans:
                sp.done(now)
        if drafts is not None:
            self._deliver_verify(toks, snapshot, drafts, now)
            return
        for slot, req, take in snapshot:
            if req.done.is_set():
                self.tokens_discarded += take
                continue
            # analysis: ok host-sync-in-dispatch — numpy after the fetch
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
                _mark_last_token(req)
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
            # analysis: ok host-sync-in-dispatch — numpy after the fetch
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
                _mark_last_token(req)
                req.done.set()
                done = True
            if done and self._slots[slot] is req:
                self._retire_slot(slot)
                ban = -1
            self._spec_ban[slot] = ban


def _mark_last_token(req: Request) -> None:
    """Stamp the last token's delivery on a traced request's decode phase.

    The phase stays open: the serving surface's ``finish`` closes it once
    the response is written, so the phases tile the request whatever delays
    the handler thread between the last token and the response (a garbage
    collection, a busy interpreter). ``last_token_s`` (``perf_counter``,
    the clock of every span) marks where decoding ended."""
    if req.trace is None:
        return
    cur = req.trace.current_phase
    if cur is not None:
        cur.set(tokens=len(req.tokens),
                last_token_s=round(time.perf_counter(), 6))


def _shared_model(cfg: LlamaConfig, params: Any, device) -> Llama:
    """One ``Llama`` for every engine of a pool (an engine uses its model
    as it is, never modified)."""
    if isinstance(params, Llama):
        return params
    model = Llama(cfg, device=resolve_device(device))
    model.load_state_dict(params, strict=True)
    return model


class TieredEngine:
    """The tier ladder as an admission policy over one paged pool, copied
    from the reference.

    ``tier_lens`` classifies requests by their known total length (prompt
    + max_new_tokens) against an ascending ladder of bounds, and
    ``tier_slots`` reserves each bounded class its share of the slots (the
    rest is the unbounded class), enforced through the engine's
    ``admission_policy``: a burst of long conversations cannot starve
    short admissions. One pool means one prefix cache across the classes.
    The classic two-tier API (``short_len``/``short_slots``) is the
    one-bound case. Without a ``block_size`` the pool is paged at
    ``min(16, short_len // 2)``."""

    def __init__(self, cfg: LlamaConfig, params: Any, *, short_len: int = 512,
                 short_slots: Optional[int] = None, num_slots: int = 8,
                 tier_lens: Optional[list[int]] = None,
                 tier_slots: Optional[list[int]] = None, **kw):
        if tier_lens is None:
            tier_lens = [int(short_len)]
            tier_slots = [num_slots // 2 if short_slots is None
                          else int(short_slots)]
        tier_lens = [int(t) for t in tier_lens]
        if sorted(set(tier_lens)) != tier_lens:
            raise ValueError(f"tier_lens {tier_lens} must be strictly "
                             "ascending")
        for t in tier_lens:
            if not (1 < t < cfg.max_seq_len):
                raise ValueError(
                    f"tier cap {t} must be in (1, {cfg.max_seq_len})")
        if tier_slots is None:
            per = max(1, num_slots // (len(tier_lens) + 1))
            tier_slots = [per] * len(tier_lens)
        tier_slots = [int(n) for n in tier_slots]
        if len(tier_slots) != len(tier_lens) or any(
                n < 1 for n in tier_slots):
            raise ValueError("tier_slots must give every tier >= 1 slot")
        if sum(tier_slots) >= num_slots:
            raise ValueError("tier_slots must leave the uncapped pool "
                             ">= 1 slot")
        self.caps = list(tier_lens)
        self.short_len = tier_lens[0]
        self.quotas = tier_slots + [num_slots - sum(tier_slots)]
        if kw.get("block_size", None) in (None, 0):
            kw["block_size"] = max(1, min(16, self.short_len // 2))
        self.engine = ContinuousEngine(
            cfg, params, num_slots=num_slots,
            admission_policy=self._admit_quota, **kw)
        #: one pool: ``pools`` holds it, ``short``/``long`` alias it
        self.pools = [self.engine]
        self.short = self.engine
        self.long = self.engine

    def _classify(self, req: Request) -> int:
        total = len(req.prompt) + req.max_new_tokens
        for i, cap in enumerate(self.caps):
            if total < cap:
                return i
        return len(self.caps)

    def _admit_quota(self, req: Request) -> bool:
        """Admit only while the request's class holds fewer slots than its
        quota (live and reserved slots; scheduler thread)."""
        cls = self._classify(req)
        live = sum(1 for r in self.engine._slots
                   if r is not None and self._classify(r) == cls)
        return live < self.quotas[cls]

    def submit(self, prompt, max_new_tokens=None, temperature=None,
               top_p=None, top_k=None, priority=None, trace=None,
               session_id=None) -> Request:
        return self.engine.submit(
            prompt, max_new_tokens, temperature, top_p=top_p, top_k=top_k,
            priority=priority, trace=trace, session_id=session_id)

    def generate(self, prompt, max_new_tokens=None, timeout: float = 120.0,
                 temperature=None, top_p=None, top_k=None) -> list[int]:
        return self.submit(prompt, max_new_tokens, temperature,
                           top_p=top_p, top_k=top_k).wait(timeout)

    def warmup(self, groups=None) -> None:
        self.engine.warmup(groups)

    def flush_warmup_trace(self) -> None:
        self.engine.flush_warmup_trace()

    def stop(self) -> None:
        self.engine.stop()

    @property
    def eos_id(self):
        return self.engine.eos_id

    @property
    def default_max_new_tokens(self) -> int:
        return self.engine.default_max_new_tokens

    @property
    def cfg(self):
        return self.engine.cfg

    @property
    def tokens_emitted(self) -> int:
        return self.engine.tokens_emitted

    @property
    def prefix_hits(self) -> int:
        return self.engine.prefix_hits

    @property
    def prefix_tokens_saved(self) -> int:
        return self.engine.prefix_tokens_saved

    def stats(self) -> dict:
        merged = dict(self.engine.stats())
        live = [0] * len(self.quotas)
        for r in self.engine._slots:
            if r is not None:
                live[self._classify(r)] += 1
        merged["classes"] = [
            {"cap": (self.caps[i] if i < len(self.caps) else 0),
             "quota": q, "live": live[i]}
            for i, q in enumerate(self.quotas)]
        snap = dict(merged)
        merged["pools"] = [snap]
        merged["short_pool"] = snap
        merged["long_pool"] = snap
        return merged


def migrate_live_sequences(src: ContinuousEngine, dst=None, *, send=None,
                           on_latency=None) -> tuple[int, int]:
    """Drain: migrate every live sequence off ``src``, copy then cutover
    one by one (a failed transfer resumes decoding on ``src``: a drain can
    fall short, never lose a sequence). ``dst`` imports in process;
    ``send`` (callable(snapshot, req) -> bool) transfers another way and
    must resolve an indeterminate outcome itself. Returns (moved,
    failed).

    Unlike the reference, every live sequence is frozen first, in one
    scheduler boundary: exported one at a time, the sequences still
    waiting would keep decoding on a busy source and could finish there
    before their turn (each export waits for the dispatches in
    flight)."""
    if send is None and dst is None:
        raise ValueError("migrate_live_sequences needs dst or send")
    live = [r for r in list(src._slots)
            if r is not None and not r.done.is_set()]
    try:
        src._post_migration_op("freeze", live, None, 60.0)
    except (RuntimeError, TimeoutError) as e:
        # each export below freezes its own sequence, or fails and resumes
        log.debug("drain freeze failed: %s", e)
    moved = failed = 0
    for req in live:
        if send is not None:
            def transfer(snap, _r=req):
                return send(snap, _r)
        else:
            def transfer(snap, _r=req):
                return dst.import_sequence(snap, req=_r) is not None
        outcome = _migrate_one(src, req, transfer, on_latency)
        if outcome is True:
            moved += 1
        elif outcome is False:
            failed += 1
    return moved, failed


def _migrate_one(src: ContinuousEngine, req: Request, transfer,
                 on_latency=None) -> Optional[bool]:
    """One copy-then-cutover attempt: export, ``transfer(snapshot)``
    (True = installed, False = not, None = indeterminate, treated as a
    failure), then release on success or resume on failure. Returns True
    (moved), False (failed) or None (the request finished first)."""
    t0 = time.perf_counter()
    if req.trace is not None:
        # a no-op when the prefill-role freeze opened it already: the
        # phase runs from the freeze to the destination's activation
        req.trace.phase("engine.handoff")
    try:
        snap = src.export_sequence(req)
    except (RuntimeError, TimeoutError) as e:
        log.debug("migration export failed: %s", e)
        src._note_migrate_failure()
        # a failed export may have frozen the slot; resuming a slot never
        # frozen is a no-op
        try:
            src.resume_sequence(req)
        except (RuntimeError, TimeoutError):
            pass
        return False
    if snap is None:
        return None
    tsp = (req.trace.begin("kv.transfer")
           if req.trace is not None else None)
    try:
        ok = transfer(snap)
    except Exception as e:  # noqa: BLE001 — a rejection is a per-sequence
        # failure, not a drain abort: resume in place
        log.debug("migration transfer failed: %s", e)
        ok = False
    if tsp is not None:
        tsp.done(ok=bool(ok))
    if ok is None:
        log.warning(
            "kv_migrate transfer returned indeterminate without resolving "
            "it; treating as failed — the destination may hold an orphaned "
            "copy")
        ok = False
    try:
        if ok:
            src.release_sequence(req)
            ms = (time.perf_counter() - t0) * 1e3
            src.observe_migration_ms(ms)
            if on_latency is not None:
                on_latency(ms)
            return True
        src._note_migrate_failure()
        src.resume_sequence(req)
    except (RuntimeError, TimeoutError) as e:
        log.debug("migration cutover failed: %s", e)
    return False


class DisaggregatedPool:
    """Prefill/decode disaggregation over live paged-KV migration, in
    process (the reference's ``wire=False``).

    ``prefill_replicas`` engines of ``role="prefill"`` admit and
    chunk-prefill only; each finished sequence (KV blocks, logits row,
    scheduler state) is handed by the ``kv-migrate`` worker to the
    ``role="decode"`` engine with the most free blocks. The handoff is a
    copy-then-cutover migration, so a failed transfer decodes on the
    prefill engine, and the request handle is re-targeted in place. The
    engines share one ``Llama`` and each has its own stream and graphs.
    Engine-shaped: ``submit``/``generate``/``warmup``/``stop``/``stats``.

    ``wire=True`` routes every handoff through the authenticated,
    length-framed ``kv_migrate`` stream (``gang.py``) over loopback TCP,
    the bytes a cross-host deployment ships, with the destination
    resolving the request handle from the migration-id registry."""

    def __init__(self, cfg: LlamaConfig, params: Any, *,
                 prefill_replicas: int = 1, decode_replicas: int = 1,
                 wire: bool = False, migrate_token: str = "",
                 sock_wrap=None, seq_buckets=None, device=None, **kw):
        if int(kw.get("block_size", 0)) <= 0:
            raise ValueError(
                "disaggregation requires the paged pool (block_size > 0)")
        if prefill_replicas < 1 or decode_replicas < 1:
            raise ValueError("disaggregation needs >= 1 replica per role")
        kw.pop("role", None)
        model = _shared_model(cfg, params, device)
        self.prefill = [
            ContinuousEngine(cfg, model, role="prefill",
                             seq_buckets=seq_buckets, device=device, **kw)
            for _ in range(prefill_replicas)]
        self.decode = [
            ContinuousEngine(cfg, model, role="decode",
                             seq_buckets=seq_buckets, device=device, **kw)
            for _ in range(decode_replicas)]
        self.pools = self.prefill + self.decode
        #: guards the tier lists (which engine is on which) against
        #: ``rebalance`` racing the worker's and ``submit``'s picks
        self._tier_lock = threading.Lock()
        self.tier_rebalances_total = 0
        self._handoff_q: "queue.Queue" = queue.Queue()
        self._stopping = threading.Event()
        #: recent handoff latencies (ms); the engines keep the histogram
        self.migration_latencies_ms: "deque[float]" = deque(maxlen=4096)
        self._servers = []
        if wire and not migrate_token:
            # the tiers share a process: a per-pool secret instead of an
            # open loopback listener; cross-process deployments pass theirs
            import secrets

            migrate_token = secrets.token_hex(16)
        self._wire_token = migrate_token
        self._sock_wrap = sock_wrap
        if wire:
            from .gang import KvMigrationServer  # gang.py imports this module

            for eng in self.decode:
                self._servers.append(KvMigrationServer(
                    eng, token=migrate_token, sock_wrap=sock_wrap))
        for eng in self.prefill:
            eng.on_prefilled = (
                lambda req, _e=eng: self._handoff_q.put((_e, req)))
        self._worker = threading.Thread(
            target=self._pump, name="kv-migrate", daemon=True)
        self._worker.start()

    def _pump(self) -> None:
        """The handoff worker: the blocking half of every migration (the
        host copy, the cutover waits) runs here, never on a scheduler."""
        while not self._stopping.is_set():
            try:
                src, req = self._handoff_q.get(timeout=0.1)
            except queue.Empty:
                continue
            with self._tier_lock:
                di = max(range(len(self.decode)),
                         key=lambda i: self.decode[i]._alloc.free_blocks)
                deng = self.decode[di]
            if self._servers:
                def transfer(snap, _r=req, _d=di):
                    return self._send_wire(snap, _r, _d)
            else:
                def transfer(snap, _r=req, _e=deng):
                    return _e.import_sequence(snap, req=_r) is not None
            # a failed transfer decodes on the prefill engine
            _migrate_one(src, req, transfer,
                         self.migration_latencies_ms.append)

    def _send_wire(self, snap: dict, req: Request, di: int) -> bool:
        """One wire handoff, the reference's: a definitive outcome (ack,
        explicit rejection, or a death before ``kv_commit`` went out)
        resolves at once; an indeterminate one (commit delivered, ack
        lost) must not resume blind, or the request would decode twice:
        it waits for the destination to own the request, for the import's
        bounded service time."""
        from .gang import (
            migrate_sequence,
            register_migration_handle,
            unregister_migration_handle,
        )

        srv = self._servers[di]
        mid = register_migration_handle(req)
        st = migrate_sequence(snap, "127.0.0.1", srv.port,
                              token=self._wire_token, mid=mid,
                              sock_wrap=self._sock_wrap)
        if st is True:
            return True
        if st is False:
            unregister_migration_handle(mid)
            return False
        if unregister_migration_handle(mid):
            return False  # the commit never arrived: the source resumes
        deadline = time.perf_counter() + 60.0
        while time.perf_counter() < deadline:
            if (self.decode[di]._find_req_slot(req) is not None
                    or req.done.is_set()):
                return True
            time.sleep(0.01)
        log.warning(
            "kv_migrate cutover unresolved after 60s (commit delivered, "
            "no ack, destination never installed): resuming the source")
        return False

    def submit(self, prompt, max_new_tokens=None, temperature=None,
               top_p=None, top_k=None, priority=None, trace=None,
               session_id=None) -> Request:
        # only prefill engines take traffic, the least loaded first
        with self._tier_lock:
            eng = min(self.prefill,
                      key=lambda e: e._queue.qsize() + len(e._prefilling)
                      + int(e._active.sum()))
        return eng.submit(prompt, max_new_tokens, temperature, top_p=top_p,
                          top_k=top_k, priority=priority, trace=trace,
                          session_id=session_id)

    def generate(self, prompt, max_new_tokens=None, timeout: float = 120.0,
                 temperature=None, top_p=None, top_k=None) -> list[int]:
        return self.submit(prompt, max_new_tokens, temperature,
                           top_p=top_p, top_k=top_k).wait(timeout)

    def warmup(self, groups=None) -> None:
        for eng in self.pools:
            eng.warmup(groups)

    def flush_warmup_trace(self) -> None:
        for eng in self.pools:
            eng.flush_warmup_trace()

    def stop(self) -> None:
        self._stopping.set()
        self._worker.join(timeout=30)
        for srv in self._servers:
            srv.close()
        for eng in self.pools:
            eng.stop()

    @property
    def eos_id(self):
        return self.prefill[0].eos_id

    @eos_id.setter
    def eos_id(self, value) -> None:
        for eng in self.pools:
            eng.eos_id = value

    @property
    def default_max_new_tokens(self) -> int:
        return self.prefill[0].default_max_new_tokens

    @property
    def cfg(self):
        return self.prefill[0].cfg

    @property
    def tokens_emitted(self) -> int:
        return sum(e.tokens_emitted for e in self.pools)

    @property
    def prefix_hits(self) -> int:
        return sum(e.prefix_hits for e in self.pools)

    @property
    def prefix_tokens_saved(self) -> int:
        return sum(e.prefix_tokens_saved for e in self.pools)

    def tier_pressure(self) -> dict:
        """Load per tier for a rebalance decision: backlog per prefill
        engine (queued and mid-prefill) against live sequences per decode
        engine."""
        with self._tier_lock:
            prefill, decode = list(self.prefill), list(self.decode)
        pb = sum(e._queue.qsize() + len(e._prefilling) for e in prefill)
        dl = sum(int(e._active.sum()) for e in decode)
        return {
            "prefill_pressure": pb / max(len(prefill), 1),
            "decode_pressure": dl / max(len(decode), 1),
            "prefill_replicas": len(prefill),
            "decode_replicas": len(decode),
        }

    def rebalance(self, prefill_replicas: int) -> bool:
        """Move engines between the tiers until the prefill tier holds
        ``prefill_replicas`` (both tiers keep >= 1). Prefill -> decode: the
        least loaded prefill engine stops taking admissions and flips its
        role (its prefills in flight finish and decode locally). Decode ->
        prefill: the emptiest decode engine first drains its live
        sequences onto the others (a failed move aborts the flip). Runs
        on the caller's thread. True when the split changed. A wire pool
        refuses: its migration servers are placement this does not
        manage."""
        target = int(prefill_replicas)
        if self._servers:
            raise RuntimeError(
                "tier rebalance unsupported on wire=True pools")
        if not 1 <= target <= len(self.pools) - 1:
            raise ValueError(
                f"prefill_replicas {target} out of range "
                f"[1, {len(self.pools) - 1}]")
        changed = False
        while True:
            with self._tier_lock:
                delta = target - len(self.prefill)
                if delta == 0:
                    break
                if delta < 0:
                    eng = min(self.prefill,
                              key=lambda e: e._queue.qsize()
                              + len(e._prefilling))
                    self.prefill.remove(eng)
                    eng.on_prefilled = None
                    eng.role = "decode"
                    self.decode.append(eng)
                    self.tier_rebalances_total += 1
                    changed = True
                    continue
                # drain outside the lock (migration ops wait on mailboxes)
                eng = max(self.decode, key=lambda e: e._alloc.free_blocks)
                rest = [d for d in self.decode if d is not eng]
            dst = max(rest, key=lambda e: e._alloc.free_blocks)
            moved, failed = migrate_live_sequences(eng, dst)
            if failed:
                raise RuntimeError(
                    f"tier rebalance aborted: {failed} sequences failed to "
                    "drain off the donor decode engine")
            with self._tier_lock:
                if eng in self.decode and len(self.decode) > 1:
                    self.decode.remove(eng)
                    eng.role = "prefill"
                    eng.on_prefilled = (
                        lambda req, _e=eng: self._handoff_q.put((_e, req)))
                    self.prefill.append(eng)
                    self.tier_rebalances_total += 1
                    changed = True
        return changed

    def stats(self) -> dict:
        """Numeric stats summed across the engines (counters and capacity
        gauges add), ratios recomputed from the sums, and the tier
        split."""
        merged: dict = {}
        per: list[dict] = []
        config_keys = {"kv_block_size", "prefill_budget"}
        for eng in self.pools:
            st = eng.stats()
            per.append(st)
            for k, v in st.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if k in config_keys or k.startswith("aot_cache_"):
                    # the pool's engines share ONE artifact cache: summing
                    # its counters would multiply them by the engines
                    merged.setdefault(k, v)
                else:
                    merged[k] = merged.get(k, 0) + v
        merged["spec_acceptance_rate"] = round(
            merged.get("spec_tokens_accepted_total", 0)
            / max(merged.get("spec_tokens_proposed_total", 0), 1), 4)
        allocated = (merged.get("kv_blocks_total", 0)
                     - merged.get("kv_blocks_free", 0))
        merged["kv_fragmentation_ratio"] = round(
            sum((st["kv_blocks_total"] - st["kv_blocks_free"])
                * st["kv_fragmentation_ratio"] for st in per)
            / allocated, 4) if allocated > 0 else 0.0
        merged["disagg_prefill_replicas"] = len(self.prefill)
        merged["disagg_decode_replicas"] = len(self.decode)
        return merged


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


def resolve_model_source(config: dict, *, name: str = "model"):
    """(cfg, params) from a serving config's model source: ``params_ref``
    (a ``mem://`` key registered with ``(cfg, params)``) or
    ``storage_path`` (a snapshot ``load_pretrained`` reads, this layout or
    a transformers one). ``adapter_path``: a ``save_adapter`` snapshot
    merged into the base at load (``merge_adapter``; the model is then a
    plain Llama, so int8 quantization composes unchanged). ``max_seq_len``
    overrides the snapshot's context length (the serving capacity)."""
    ref = config.get("params_ref")
    if ref:
        cfg, params = fetch_mem(ref[len("mem://"):])
    elif config.get("storage_path"):
        cfg, params = llamalib.load_pretrained(config["storage_path"])
    else:
        raise RuntimeError(
            f"model {name}: need params_ref or storage_path (set "
            "storage_uri on the component spec — the storage initializer "
            "resolves it to storage_path)")
    adapter = config.get("adapter_path")
    if adapter:
        acfg, adapters = llamalib.load_adapter(adapter)
        cfg, params = llamalib.merge_adapter(acfg, params, adapters)
    if config.get("max_seq_len"):
        cfg = dataclasses.replace(cfg, max_seq_len=int(config["max_seq_len"]))
    return cfg, params


def apply_serving_quant(cfg, params, config: dict):
    """The serving config's int8 knobs: ``quant_weights`` (int8 projection
    kernels and unembedding, ``quantize_for_serving``) and ``quant_kv``
    (the int8 KV cache)."""
    w = bool(config.get("quant_weights"))
    k = bool(config.get("quant_kv"))
    if not (w or k):
        return cfg, params
    return llamalib.quantize_for_serving(cfg, params, weights=w, kv=k)


def build_engine(cfg: LlamaConfig, params, config: dict, *, default_eos=None,
                 default_max_new_tokens: int = 16, device=None):
    """Engine from a serving-config dict, the reference's branches:
    ``disaggregation`` ({"prefill": n, "decode": m}, in process) builds a
    ``DisaggregatedPool``, ``tier_lens`` or ``short_pool_len`` a
    ``TieredEngine``, else a ``ContinuousEngine``. ``quant_weights`` and
    ``quant_kv`` quantize first (``apply_serving_quant``);
    ``"warmup_groups": []`` skips warmup. ``aot`` ({"root": dir[, "fsync":
    bool]}) gives every engine built here one program-artifact cache
    (``programs.build_program_cache``)."""
    kw = engine_kwargs(config, default_eos=default_eos,
                       default_max_new_tokens=default_max_new_tokens)
    # constructed HERE, not in engine_kwargs: engine_kwargs is also the
    # controller's validation probe and must stay side-effect-free
    kw["program_cache"] = programslib.build_program_cache(config)
    cfg, params = apply_serving_quant(cfg, params, config)
    short_len = config.get("short_pool_len")
    tier_lens = config.get("tier_lens")
    disagg = config.get("disaggregation")
    buckets = config.get("seq_buckets")
    if disagg:
        if tier_lens or short_len:
            raise ValueError(
                "disaggregation does not compose with the tier ladder: "
                "route tiers to separate ISvcs instead")
        engine = DisaggregatedPool(
            cfg, params, prefill_replicas=int(disagg.get("prefill", 1)),
            decode_replicas=int(disagg.get("decode", 1)),
            wire=bool(disagg.get("wire", False)), seq_buckets=buckets,
            device=device, **kw)
    elif tier_lens:
        engine = TieredEngine(
            cfg, params, tier_lens=[int(t) for t in tier_lens],
            tier_slots=config.get("tier_slots"), seq_buckets=buckets,
            device=device, **kw)
    elif short_len:
        engine = TieredEngine(
            cfg, params, short_len=int(short_len),
            short_slots=config.get("short_pool_slots"), seq_buckets=buckets,
            device=device, **kw)
    else:
        engine = ContinuousEngine(cfg, params, seq_buckets=buckets,
                                  device=device, **kw)
    groups = config.get("warmup_groups")
    if groups != []:
        engine.warmup([tuple(g) for g in groups] if groups else None)
    return engine


class ContinuousLlamaGenerator(Model):
    """Serving runtime over :class:`ContinuousEngine` (the reference's
    class of the same name).

    Unlike ``LlamaGenerator`` this model is **self-batching**: the server
    bypasses the micro-batcher and calls it from each request thread
    directly; concurrent requests coalesce inside the engine's slot pool
    at token boundaries instead of at HTTP arrival time.

    config:
      params_ref:       "mem://key" holding (LlamaConfig, state dict), or
      storage_path:     a snapshot (``resolve_model_source``)
      num_slots, decode_chunk, temperature, eos_id, max_new_tokens,
      seq_buckets, ...: engine knobs (``build_engine``)
      device:           "cpu" to serve on the CPU (default: the CUDA card)
    """

    self_batching = True

    def __init__(self, name: str, config: Optional[dict[str, Any]] = None,
                 engine: Optional[ContinuousEngine] = None):
        super().__init__(name, config)
        #: a prebuilt engine: load() then skips construction
        self.engine: Optional[ContinuousEngine] = engine

    def load(self) -> None:
        if self.engine is not None:
            self.ready = True
            return
        cfg, params = resolve_model_source(self.config, name=self.name)
        self.engine = build_engine(cfg, params, self.config,
                                   device=self.config.get("device"))
        self.ready = True

    def stop(self) -> None:
        if self.engine is not None:
            self.engine.stop()
            self.engine = None
        super().stop()

    def predict_batch(self, instances):
        assert self.engine is not None, "model not loaded"
        reqs = [self.engine.submit(inst) for inst in instances]
        return [r.wait(timeout=300.0) for r in reqs]
