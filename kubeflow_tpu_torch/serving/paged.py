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
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..models.llama import KvCache

#: what ``write_window_tables`` puts in place of a block not to write
NO_WRITE = np.iinfo(np.int32).max


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


