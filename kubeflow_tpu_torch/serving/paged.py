"""Paged KV: the port of ``kubeflow_tpu/serving/paged.py``.

KV lives in a pool of fixed-size blocks owned by :class:`BlockAllocator`
(host numpy, copied from the reference as it is); each request holds a block
table. Every paged dispatch gathers its rows' block tables into the
contiguous working view the slot-pool programs consume, runs the same
decode and prefill math, and scatters the written blocks back.

Pools here are ``KvCache`` objects (``models/llama.py``) whose row axis is
the block axis and whose seq axis is ``block_size``. A pool holds one block
more than its allocator owns: block ``num_blocks``, the scratch block.
Gathers clip an out-of-range id to the last real block, as the reference's
``mode="clip"`` does (finite bytes the causal mask hides); scatters send
every out-of-range id, the allocator's ``pad_block`` and the ``int32`` max of
``write_window_tables``, to the scratch block, where the reference's
``mode="drop"`` discards the write. Nothing reads the scratch block's bytes.

Live migration and the KV tiers move blocks by ``kv_export``/``kv_import``
(up to ``KV_MIGRATE_GROUP`` blocks a call, block axis first, the leaves in
the reference's order). Their host side is copied from the reference:
:class:`HostBlockPool` (the host-RAM tier) and ``prefix_digest``. Host
leaves are torch CPU tensors (numpy has no bfloat16); numpy leaves from the
reference are taken as they are.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..models.llama import KvCache

#: what ``write_window_tables`` puts in place of a block not to write
NO_WRITE = np.iinfo(np.int32).max

#: blocks a migration gather or scatter moves at most (the reference's
#: fixed [KV_MIGRATE_GROUP, 1] table: one program each way for sequences of
#: any length)
KV_MIGRATE_GROUP = 8

#: the order of a moved block's leaves: the reference's tree order
#: (cached_key, cached_key_scale, cached_value, cached_value_scale), so a
#: snapshot or a spill of either framework carries its leaves alike
MIGRATE_LEAVES = ("k", "k_scale", "v", "v_scale")


def _real_blocks(pool: KvCache) -> int:
    return pool.k.shape[1] - 1


def _gather(pool: KvCache, idx) -> dict[str, torch.Tensor]:
    """Rows ``idx`` [rows, nblk] of the pool as [rows, nblk * bs] leaves
    (copies)."""
    rows, nblk = idx.shape
    out = {}
    for name, t in pool.leaves().items():
        g = t[:, idx]                       # [L, rows, nblk, ...]
        if name in ("k", "v"):              # [L, rows, nblk, bs, kv, d]
            out[name] = g.reshape(g.shape[0], rows, -1, *g.shape[4:])
        else:                               # [L, rows, nblk, kv, bs]
            out[name] = g.transpose(2, 3).reshape(
                g.shape[0], rows, g.shape[3], -1)
    return out


def _scatter(pool: KvCache, view: dict, idx) -> None:
    """Write the view's blocks back at ``idx`` [rows, nblk] (in range)."""
    rows, nblk = idx.shape
    for name, t in pool.leaves().items():
        w = view[name]
        bs = t.shape[2] if name in ("k", "v") else t.shape[3]
        if name in ("k", "v"):
            w = w.reshape(w.shape[0], rows, nblk, bs, *w.shape[3:])
        else:
            w = w.reshape(w.shape[0], rows, w.shape[2], nblk, bs
                          ).transpose(2, 3)
        t[:, idx] = w


def gather_block_view(pool: KvCache, bt) -> dict[str, torch.Tensor]:
    """Per-row contiguous KV view gathered from the block pool.

    ``bt``: [rows, nblk] block tables on the pool's device; an out-of-range
    id (the pad sentinel) clips to the last real block. Returns the
    leaves ``k``/``v`` ``[layers, rows, nblk * block_size, kv, d]`` (and
    the scales ``[layers, rows, kv, nblk * block_size]``): the reference's
    view, with no scratch past its end (``gather_working_view`` adds it)."""
    return _gather(pool, bt.long().clamp(0, _real_blocks(pool) - 1))


def scatter_block_view(pool: KvCache, view: dict, bt) -> None:
    """Write a gathered view's blocks back into the pool at ``bt``, in
    place. Out-of-range ids go to the scratch block (the reference drops
    them). Blocks shared by several rows carry identical bytes (no row
    writes below its own front), so the order of duplicate writes is
    invisible."""
    _scatter(pool, view, bt.long().clamp(0, _real_blocks(pool)))


def gather_working_view(pool: KvCache, bt) -> KvCache:
    """The programs' view: ``gather_block_view`` with one more row and one
    more block column, both the scratch block. Its logical length is
    ``nblk * block_size``; a write past it (an inactive row pinned at the
    view's length) or to the extra row (the warmup's out-of-range slot)
    lands in scratch and goes back to the scratch block."""
    n = _real_blocks(pool)
    rows, nblk = bt.shape
    idx = torch.full((rows + 1, nblk + 1), n, dtype=torch.long,
                     device=bt.device)
    idx[:rows, :nblk] = bt.long().clamp(0, n - 1)
    return KvCache(**_gather(pool, idx), seq_len=nblk * pool.k.shape[2])


def scatter_working_view(pool: KvCache, view: KvCache, bt_w) -> None:
    """Write back a ``gather_working_view`` view through the write tables
    ``bt_w`` [rows, nblk] (``write_window_tables``)."""
    n = _real_blocks(pool)
    rows, nblk = bt_w.shape
    idx = torch.full((rows + 1, nblk + 1), n, dtype=torch.long,
                     device=bt_w.device)
    idx[:rows, :nblk] = bt_w.long().clamp(0, n)
    _scatter(pool, view.leaves(), idx)


def _migrate_leaves(pool: KvCache) -> list[torch.Tensor]:
    leaves = pool.leaves()
    return [leaves[n] for n in MIGRATE_LEAVES if n in leaves]


def kv_export(pool: KvCache, ids) -> list[torch.Tensor]:
    """The migration gather: blocks ``ids`` [g] (``g <= KV_MIGRATE_GROUP``)
    of every leaf, block axis first (``[g, layers, bs, kv, d]``; scales
    ``[g, layers, kv, bs]``), in ``MIGRATE_LEAVES`` order, as new
    contiguous tensors. An out-of-range id (the allocator's pad) clips to
    the last real block, as the reference's ``mode="clip"``; the caller
    keeps only its valid rows."""
    idx = ids.long().clamp(0, _real_blocks(pool) - 1)
    return [t.index_select(1, idx).movedim(1, 0).contiguous()
            for t in _migrate_leaves(pool)]


def kv_import(pool: KvCache, ids, leaves) -> None:
    """The exact inverse of ``kv_export``: write ``leaves`` (its layout and
    order) into blocks ``ids`` [g], in place. An out-of-range id (a pad
    row's ``num_blocks``) writes the scratch block, where the reference
    drops it."""
    idx = ids.long().clamp(0, _real_blocks(pool))
    for t, x in zip(_migrate_leaves(pool), leaves):
        t.index_copy_(1, idx, x.movedim(0, 1).to(t.dtype))


def write_window_tables(bt, front, block_size: int):
    """Scatter-side block tables narrowed to the WRITTEN suffix window.

    A dispatch writes row ``r`` only at positions >= ``front[r]`` (decode
    at the position front, a prefill chunk at its start offset, inactive
    rows nowhere: their front is the view length). Blocks that end below
    the front get ``NO_WRITE``, which the scatter sends to the scratch
    block; the gather still uses the full table."""
    nblk = bt.shape[1]
    first = front.long() // block_size
    keep = (torch.arange(nblk, device=bt.device)[None, :]
            >= first[:, None])
    return torch.where(keep, bt.long(), NO_WRITE)


def block_keys(tokens, block_size: int, max_blocks: int = 64) -> list[int]:
    """Chained content keys for a token sequence's FULL prefix blocks.

    ``key[i]`` identifies the exact token content of blocks ``[0, i]`` —
    each key hashes the previous key plus the block's tokens, so two
    sequences share ``key[i]`` iff their first ``(i+1) * block_size``
    tokens are identical.  This is the block economy's identity at the
    granularity the allocator shares KV (full blocks by refcount): the
    traffic plane's prefix-affinity router (serving/traffic.py) matches
    these keys against where it last routed them, because a replica that
    served a prefix holds its blocks — live, or retired-but-registered
    in the allocator's free-list-as-cache.  Host-side stdlib hashing
    only (runs per request on router/server threads, never on a
    scheduler thread)."""
    import hashlib

    n = min(len(tokens) // block_size, max_blocks)
    keys: list[int] = []
    h = hashlib.blake2b(digest_size=8)
    for i in range(n):
        blk = tokens[i * block_size:(i + 1) * block_size]
        # analysis: ok host-sync-in-dispatch — host token list, no device value
        h.update(np.asarray(blk, np.int64).tobytes())
        keys.append(int.from_bytes(h.digest(), "little"))
        h = hashlib.blake2b(h.digest(), digest_size=8)
    return keys


def prefix_digest(token_records, block_size: int,
                  max_entries: int = 64) -> dict[str, int]:
    """``{hex key: block depth}`` for the deepest chained content key of
    each token record: the replica's block-registry digest, copied from
    the reference. The whole chain publishes per record (a query sharing
    only the first i blocks probes ``key[i-1]``), deduped across records
    and bounded at ``max_entries``, deepest first."""
    depths: dict[str, int] = {}
    for toks in token_records:
        for i, k in enumerate(block_keys(toks, block_size)):
            kh = f"{k:016x}"
            depths[kh] = max(depths.get(kh, 0), i + 1)
    if len(depths) > max_entries:
        deepest = sorted(depths.items(), key=lambda kv: -kv[1])
        depths = dict(deepest[:max_entries])
    return depths


def lcp(content, prompt_arr: np.ndarray, cap: int) -> int:
    """Longest common prefix of a token sequence and the prompt array,
    capped — vectorized, runs per candidate per admission on the
    scheduler thread (the ONE implementation: the engine's slot/segment
    matchers and the allocator registry both import it)."""
    n = min(len(content), cap)
    if n <= 0:
        return 0
    # analysis: ok host-sync-in-dispatch — host token list, no device value
    c = np.asarray(content[:n], np.int64)
    neq = np.nonzero(c != prompt_arr[:n])[0]
    return int(neq[0]) if neq.size else n


class BlockAllocator:
    """Fixed-size KV block economy: free list, refcounts, COW counters,
    and the retired-sequence prefix registry.

    Block ids are [0, num_blocks); the dispatch-side pad sentinel is
    ``num_blocks`` itself (out of range: gathers clip, scatters drop) so
    every pool row is a real allocatable block.

    Free-list-as-cache: ``release`` appends a refcount-zero block to the
    tail of an ordered free map WITHOUT clearing it — its bytes stay in
    HBM and any sequence registered over it stays prefix-matchable.
    ``alloc`` pops from the head (oldest-freed first, the LRU eviction
    order) and only THEN invalidates registrations touching the block —
    reuse costs a dict pop, never a clearing dispatch.  ``ref`` on a
    zero-ref block resurrects it out of the free list (a prefix hit on
    a retired conversation's blocks).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._refs = np.zeros(self.num_blocks, np.int64)
        #: insertion-ordered free map: keys are free block ids, oldest
        #: freed first (the eviction order); values unused
        self._free: "OrderedDict[int, None]" = OrderedDict(
            (b, None) for b in range(self.num_blocks))
        #: retired sequences still matchable: seq_id -> (tokens, blocks)
        #: (insertion-ordered: oldest registration evicts first)
        self._seqs: dict[int, tuple[np.ndarray, tuple[int, ...]]] = {}
        self._block_seqs: dict[int, set[int]] = {}
        self._next_seq = 0
        #: registry bound: a hot shared prefix re-registers on EVERY
        #: retirement while resurrection keeps its blocks off the
        #: alloc path (the only lazy pruner), so without a cap the
        #: registry — and the per-admission match() scan — grows with
        #: traffic, not with the pool.  There are at most num_blocks
        #: distinct useful first-blocks, so that is the natural bound.
        self._max_seqs = self.num_blocks
        self.cow_copies_total = 0
        self.prefix_block_hits_total = 0

    # -- capacity ---------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def pad_block(self) -> int:
        """Out-of-range id used to pad block tables (gather clips,
        scatter drops)."""
        return self.num_blocks

    # -- allocation / refcounts ------------------------------------------

    def alloc(self, n: int) -> Optional[list[int]]:
        """Pop ``n`` blocks off the free list (refcount 1 each), oldest
        freed first; None when fewer than ``n`` are free — the caller's
        admission backpressure, never a partial grant."""
        if n < 0:
            raise ValueError("alloc count must be >= 0")
        if n > len(self._free):
            return None
        out: list[int] = []
        for _ in range(n):
            b, _ = self._free.popitem(last=False)
            self._refs[b] = 1
            self._invalidate(b)
            out.append(b)
        return out

    def ref(self, blocks) -> None:
        """Take a reference on each block (prefix sharing).  A zero-ref
        block resurrects out of the free list — its bytes were never
        cleared, so the cached KV is still ground truth."""
        for b in blocks:
            if self._refs[b] == 0:
                self._free.pop(b, None)
            self._refs[b] += 1

    def release(self, blocks) -> None:
        """Drop one reference per block; refcount-zero blocks join the
        free-list TAIL uncleaned (reuse without clearing — the per-row
        causal mask hides stale bytes, and registrations stay valid)."""
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] < 0:
                raise RuntimeError(f"block {b} over-released")
            if self._refs[b] == 0:
                self._free[b] = None

    # -- retired-sequence prefix registry --------------------------------

    def register(self, tokens, blocks) -> None:
        """Record a retired sequence (its KV still sits in ``blocks``)
        for future prefix matches; entries die lazily when a covering
        block is reallocated."""
        cover = -(-len(tokens) // self.block_size)
        blocks = tuple(int(b) for b in blocks[:cover])
        if not blocks or len(tokens) < self.block_size:
            return  # nothing shareable at block granularity
        sid = self._next_seq
        self._next_seq += 1
        # analysis: ok host-sync-in-dispatch — host token list, no device value
        self._seqs[sid] = (np.asarray(tokens, np.int64), blocks)
        for b in blocks:
            self._block_seqs.setdefault(b, set()).add(sid)
        while len(self._seqs) > self._max_seqs:
            self._drop_seq(next(iter(self._seqs)))

    def _drop_seq(self, sid: int) -> None:
        entry = self._seqs.pop(sid, None)
        if entry is None:
            return
        for b in entry[1]:
            peers = self._block_seqs.get(b)
            if peers:
                peers.discard(sid)
                if not peers:
                    del self._block_seqs[b]

    def _invalidate(self, block: int) -> None:
        for sid in list(self._block_seqs.pop(block, ())):  # content dies
            self._drop_seq(sid)

    def match(self, prompt_arr: np.ndarray, cap: int
              ) -> tuple[tuple[int, ...], int]:
        """Best retired-sequence prefix match: (blocks, lcp tokens).
        The caller shares ``lcp // block_size`` full blocks by ref and
        may COW-fork the boundary block for the partial remainder."""
        best_blocks: tuple[int, ...] = ()
        best = 0
        for tokens, blocks in self._seqs.values():
            lim = min(len(tokens), len(blocks) * self.block_size, cap)
            if lim <= best:
                continue
            n = lcp(tokens, prompt_arr, lim)
            if n > best:
                best, best_blocks = n, blocks
        return best_blocks, best

    def stats(self) -> dict:
        return {
            "kv_block_size": self.block_size,
            "kv_blocks_total": self.num_blocks,
            "kv_blocks_free": len(self._free),
            "kv_blocks_cow_copies_total": self.cow_copies_total,
            "prefix_block_hits_total": self.prefix_block_hits_total,
        }


class HostBlockPool:
    """Host-RAM tier of the paged-KV economy, copied from the reference: a
    bounded mirror of spilled sequences' block bytes, content-addressed by
    token prefix like the allocator's registry, LRU-evicted at
    ``capacity_blocks``.

    Thread contract as in the reference: everything here is host state
    under one lock. The engine dispatches spill gathers on its scheduler
    thread, its host-tier worker ``put``s the fetched leaves, and
    admission's ``match``/``take`` walk host arrays on the scheduler
    thread; no method blocks on the device or on I/O. A block is a list of
    host leaves (torch CPU tensors, pinned on the card; numpy works too)."""

    def __init__(self, capacity_blocks: int, block_size: int):
        if capacity_blocks < 1:
            raise ValueError("capacity_blocks must be >= 1")
        self.capacity_blocks = int(capacity_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        #: hid -> {"tokens": np.int64[], "blocks": [leaf-list per block],
        #: "nbytes": int}, insertion/touch ordered (LRU eviction)
        self._seqs: "OrderedDict[int, dict]" = OrderedDict()
        self._next = 0
        self.blocks_held = 0
        self.bytes_held = 0
        self.spills_total = 0
        self.restores_total = 0
        self.evictions_total = 0

    def put(self, tokens, blocks: list, nbytes: Optional[int] = None) -> int:
        """Admit one spilled sequence (``blocks`` = host leaf-lists, one
        per FULL block of ``tokens``); LRU-evicts older entries to fit.
        Returns the entry id. A sequence wider than the whole pool is
        truncated to the capacity prefix: the hot part of a prefix is its
        head."""
        blocks = list(blocks)[: self.capacity_blocks]
        n = len(blocks)
        if n == 0:
            return -1
        if nbytes is None:
            nbytes = sum(int(x.nbytes) for blk in blocks for x in blk)
        toks = np.asarray(list(tokens)[: n * self.block_size], np.int64)
        with self._lock:
            hid = self._next
            self._next += 1
            self._seqs[hid] = {"tokens": toks, "blocks": blocks,
                               "nbytes": int(nbytes)}
            self.blocks_held += n
            self.bytes_held += int(nbytes)
            self.spills_total += 1
            # the truncation above bounds any single entry at capacity,
            # so evicting older entries always converges
            while self.blocks_held > self.capacity_blocks:
                self._evict_oldest()
            return hid if hid in self._seqs else -1

    def _evict_oldest(self) -> None:
        _hid, entry = self._seqs.popitem(last=False)
        self.blocks_held -= len(entry["blocks"])
        self.bytes_held -= entry["nbytes"]
        self.evictions_total += 1

    def match(self, prompt_arr: np.ndarray, cap: int) -> tuple[int, int]:
        """(hid, lcp tokens) of the deepest host-tier prefix of the
        prompt; (-1, 0) on a miss. ``BlockAllocator.match``'s contract,
        one tier down."""
        best_hid, best = -1, 0
        with self._lock:
            for hid, entry in self._seqs.items():
                toks = entry["tokens"]
                lim = min(len(toks), cap)
                if lim <= best:
                    continue
                n = lcp(toks, prompt_arr, lim)
                if n > best:
                    best_hid, best = hid, n
        return best_hid, best

    def take(self, hid: int, nblocks: int) -> Optional[list]:
        """The first ``nblocks`` leaf-lists of entry ``hid`` (a restore
        reads only the matched full blocks), LRU-touched; None when the
        entry was evicted between match and take."""
        with self._lock:
            entry = self._seqs.get(hid)
            if entry is None:
                return None
            self._seqs.move_to_end(hid)
            self.restores_total += 1
            return entry["blocks"][:nblocks]

    def contains_prefix(self, tokens, min_tokens: int = 1) -> bool:
        """True when some entry already covers >= ``min_tokens`` of
        ``tokens``: the spill path's dedup probe (re-spilling a hot shared
        prefix on every retirement would churn the LRU)."""
        arr = np.asarray(list(tokens), np.int64)
        _hid, n = self.match(arr, len(arr))
        return n >= max(int(min_tokens), 1)

    def stats(self) -> dict:
        with self._lock:
            return {
                "kv_blocks_host_tier": self.blocks_held,
                "kv_host_bytes": self.bytes_held,
                "kv_host_capacity_blocks": self.capacity_blocks,
                "kv_host_spills_total": self.spills_total,
                "kv_host_restores_total": self.restores_total,
                "kv_host_evictions_total": self.evictions_total,
            }
