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
  slot ``num_slots``, a pad block id. A CUDA index out of range fires a
  device-side assert, so every pool here holds scratch that nothing reads:
  one slot row past ``num_slots``, one position past ``max_seq_len``, one
  block past ``num_blocks``, and such writes land there.
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
  graphs' static buffers through a ring of pinned staging buffers.

Knobs not ported yet raise ``NotImplementedError`` naming their ROADMAP
item: the prefix cache and shared-prefix segments, the host KV tier,
speculative decoding, admission policies and roles, serving meshes and the
program-artifact cache. ``prefix_cache`` defaults to False here (True in the
reference) until the prefix cache is ported.

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
                 sentinel: int, keep_inactive: bool):
    """``chunk`` sampling steps over the pool's slots (every row but the
    scratch one): sample from the carried logits, forward the sampled
    tokens at ``pos``, advance active rows (inactive ones stay pinned at
    ``sentinel``). ``keep_inactive`` keeps inactive rows' logits (the fused
    step: the admitting row's fresh prefill logits must survive). Returns
    the tokens [slots, chunk]."""
    slots = active.shape[0]
    view, lg = cache.head_rows(slots), logits[:slots]
    out = []
    for i in range(chunk):
        tok = _sample_step(lg, temps, top_ps, top_ks, noise[i],
                           filtered=filtered)
        new = model(tok[:, None], pos[:, None], cache=view,
                    attend=attend)[:, -1]
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


#: knob -> (its default, the ROADMAP item that ports it)
_UNPORTED = {
    "prefix_cache": (False, "A4(c)"),
    "min_prefix": (32, "A4(c)"),
    "prefix_segments": (0, "A4(c)"),
    "segment_len": (0, "A4(c)"),
    "host_blocks": (0, "A4(c)"),
    "host_watermark": (0.25, "A4(c)"),
    "spec_k": (0, "A4(b)"),
    "spec_ngram": (3, "A4(b)"),
    "draft_proposer": (None, "A4(b)"),
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
        if block_size < 0:
            raise ValueError("block_size must be >= 0 (0 = slot pool)")
        if num_blocks < 0:
            raise ValueError("num_blocks must be >= 0 (0 = derived)")
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
        #: chunked admission: [req, slot, prompt, next_offset] entries whose
        #: slot is reserved but not yet active
        self._prefilling: "deque[list]" = deque()
        #: (group, bucket) admission shapes known captured
        self._warm_plain: set = set()
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
        #: the uniform noise of one dispatch's draws, filled only when a
        #: slot samples
        self._noise = torch.zeros(self.decode_chunk, self.num_slots,
                                  cfg.vocab_size, device=dev)
        #: pinned host buffers for dispatches' tokens, one per dispatch in
        #: flight
        self._out_ring = [
            torch.zeros(self.num_slots, self.decode_chunk, dtype=torch.int64,
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

    def _draw_noise(self) -> None:
        """Fill the draw's noise when an active slot samples (greedy slots
        never read it)."""
        if bool((self._temps[self._active] > 0).any()):
            torch.rand(self._noise.shape, generator=self._gen,
                       device=self.device, out=self._noise)

    def _fetch_start(self, toks):
        host = self._out_ring[self._out_n % len(self._out_ring)]
        self._out_n += 1
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
        sentinel = self.num_slots
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
        if self.prefill_budget > 0 and warm_attends:
            cover = self._rung(max(warm_attends))
            chunk = {"toks": np.zeros(self.prefill_budget), "start": [0],
                     "length": [1], "write_slot": [sentinel],
                     "slot": [sentinel]}
            for attend in [a for a in self.attend_buckets if a <= cover]:
                self._run_chunk(attend, self.prefill_budget, chunk)
                for filtered in (False, True):
                    self._run_fused(attend, filtered, {**chunk, **idle})

    def _warmup_paged(self, groups) -> None:
        warm_attends = set()
        for g, bucket in groups:
            bucket = next(b for b in self.seq_buckets if b >= bucket)
            warm_attends.add(bucket + self.decode_chunk)
        if not warm_attends:
            return
        cover = self._rung(max(warm_attends))
        pad, sent = self._alloc.pad_block, self.num_slots
        for a in [x for x in self.attend_buckets if x <= cover]:
            nblk = -(-a // self.block_size)
            bt = np.full((self.num_slots, nblk), pad)
            idle = {"bt": bt, **self._idle_decode(0)}
            for filtered in (False, True):
                self._run_decode(a, filtered, idle)
            if self.prefill_budget > 0:
                chunk = {"toks": np.zeros(self.prefill_budget),
                         "start": [0], "length": [1], "write_slot": [sent]}
                self._run_chunk(a, self.prefill_budget,
                                {**chunk, "bt": np.full((1, nblk), pad)})
                for filtered in (False, True):
                    self._run_fused(a, filtered,
                                    {**chunk, **idle, "slot": [sent]})
        if self.prefill_budget == 0:
            # monolithic paged admission: one chunk covers the prompt,
            # programs keyed (rung, bucket)
            for bucket in [b for b in self.seq_buckets if b <= cover]:
                a = self._rung(bucket)
                self._run_chunk(a, bucket, {
                    "bt": np.full((1, -(-a // self.block_size)), pad),
                    "toks": np.zeros(bucket), "start": [0], "length": [1],
                    "write_slot": [sent]})

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
                     "kv_blocks_free": 0, "kv_blocks_leaked_total": 0}
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
        grouped = []
        for req, slot in taken:
            cap = min(self.seq_buckets[-1],
                      self.cfg.max_seq_len - req.max_new_tokens)
            grouped.append((req, req.prompt[-cap:], slot))
        if self.prefill_budget > 0:
            for req, prompt, slot in grouped:
                self._slot_content[slot] = []
                self._slot_owner[slot] = None
                self._prefilling.append([req, slot, list(prompt), 0])
                self._prefill_tokens_inflight += len(prompt)
            return
        groups: dict[int, list] = {}
        for req, prompt, slot in grouped:
            bucket = next(b for b in self.seq_buckets if b >= len(prompt))
            groups.setdefault(bucket, []).append((req, prompt, slot))
        dispatched = False
        for bucket, members in groups.items():
            g = self._pad_group(len(members), bucket)
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

    def _pad_group(self, need: int, bucket: int) -> int:
        """Admission group size: pad up to a captured shape, else the next
        power of two (captured on first use)."""
        cands = [g for (g, b) in self._warm_plain if b == bucket and g >= need]
        if cands:
            return min(cands)
        g = 1
        while g < need:
            g *= 2
        g = min(g, self.num_slots)
        self._warm_plain.add((g, bucket))
        return g

    def _occupy(self, req: Request, prompt: list[int], slot: int) -> None:
        self._slots[slot] = req
        self._active[slot] = True
        self._positions[slot] = len(prompt)
        self._remaining[slot] = req.max_new_tokens
        self._temps[slot] = (self.temperature if req.temperature is None
                             else req.temperature)
        self._top_ps[slot] = 1.0 if req.top_p is None else req.top_p
        self._top_ks[slot] = 0 if req.top_k is None else req.top_k
        self._slot_content[slot] = list(prompt)
        self._slot_owner[slot] = req
        req.slot = slot
        req.admitted_step = self.step_counter

    def _plan_paged(self, req: Request) -> Optional[tuple]:
        """(prompt, start, table) with the request's whole span (prompt +
        max_new_tokens) reserved, or None when the free list cannot host
        it. A span no empty pool could host fails the request."""
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
        fresh = self._alloc.alloc(nb_total)
        if fresh is None:
            return None
        return prompt, 0, fresh

    def _admit_paged(self, taken, plans) -> None:
        """Install planned admissions; paged admission is always chunk
        driven (with ``prefill_budget == 0`` one chunk covers the prompt)."""
        for (req, slot), (prompt, start, table) in zip(taken, plans):
            self._slot_blocks[slot] = table
            if self.block_ledger is not None:
                self.block_ledger.annotate(self._alloc, table,
                                           f"slot{slot}:admit")
            self._slot_content[slot] = list(prompt[:start])
            self._slot_owner[slot] = None
            self._prefilling.append([req, slot, list(prompt), start])
            self._prefill_tokens_inflight += len(prompt) - start

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
        """Free a slot for reuse (and, paged, its blocks: freed blocks are
        reused uncleared; the causal mask hides their bytes)."""
        self._slots[slot] = None
        self._active[slot] = False
        self._remaining[slot] = 0
        if self.paged and self._slot_blocks[slot]:
            self._alloc.release(self._slot_blocks[slot])
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
        # dispatches in flight: (token fetch handle, [(slot, req, take)])
        pending: list[tuple[Any, list]] = []
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
            needed = ((int(self._positions[self._active].max())
                       + self.decode_chunk) if live else self.decode_chunk)
            filtered = self._filtered()
            toks = None
            if live and can_fuse:
                entry, chunk, take, final, p_needed = (
                    self._prefill_chunk_args())
                a = self._rung(max(needed, p_needed))
                host = {**chunk, **self._host_decode()}
                if self.paged:
                    host["bt"] = self._block_tables(a)
                try:
                    toks = self._run_fused(a, filtered, host)
                except Exception as e:  # noqa: BLE001 — fail THIS request
                    self._fail_prefill_head(entry, e)
                    continue
                self._advance_prefill(entry, take, final)
            elif live:
                a = self._rung(needed)
                host = self._host_decode()
                if self.paged:
                    host["bt"] = self._block_tables(a)
                toks = self._run_decode(a, filtered, host)
            if has_prefill and (not live or not can_fuse):
                # no decode dispatch to ride: the chunk runs alone, after
                # the decode (which rewrites every slot's logits); paged
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
            # advance the value-independent schedule now, so the next
            # dispatch can go before this one's tokens are fetched
            for slot, req, take in snapshot:
                self._positions[slot] += self.decode_chunk
                self._remaining[slot] -= take
                if self._remaining[slot] <= 0:
                    self._retire_slot(slot)
            pending.append((self._fetch_start(toks), snapshot))
            if len(pending) >= self.pipeline_depth:
                self._process(*pending.pop(0))
        while pending:
            self._process(*pending.pop(0))

    def _process(self, handle, snapshot) -> None:
        """Wait for one dispatch's tokens and deliver them."""
        toks = self._dispatch.fetch(handle)  # [slots, chunk]
        now = time.perf_counter()
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


def engine_kwargs(config: dict, *, default_eos=None,
                  default_max_new_tokens: int = 16) -> dict:
    """ContinuousEngine kwargs from a serving-config dict (the reference's
    keys and defaults, but ``prefix_cache`` off until it is ported)."""
    return dict(
        num_slots=int(config.get("num_slots", 8)),
        decode_chunk=int(config.get("decode_chunk", 4)),
        prefill_budget=int(config.get("prefill_budget", 0)),
        temperature=float(config.get("temperature", 0.0)),
        eos_id=config.get("eos_id", default_eos),
        pipeline_depth=int(config.get("pipeline_depth", 2)),
        mesh_axes=config.get("mesh_axes"),
        prefix_cache=bool(config.get("prefix_cache", False)),
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
