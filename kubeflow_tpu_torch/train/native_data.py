"""Real-corpus input pipeline over the native data-loader kernels.

The port's copy of ``kubeflow_tpu/train/native_data.py`` (host code: no
device work). SyntheticLm keeps tests hermetic, but a real pretrain reads a
tokenized corpus. This module provides it — an mmap'd on-disk token corpus
(documents + offsets), deterministic epoch shuffling, GPT-style
EOS-separated sequence packing, and per-process window slicing into the same
``local_batch(step)`` source the trainer consumes. The hot loops run in C++
(``kubeflow_tpu_torch/native/dataloader.cpp``, the PyTorch-DataLoader-worker
analog) with exact-parity NumPy fallbacks, so the corpus path works on any
host and gets fast where g++ exists.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..native import load_library

# ---------------------------------------------------------------------------
# Kernels: native when available, NumPy parity fallback otherwise
# ---------------------------------------------------------------------------


def _splitmix64(state: np.uint64) -> tuple[np.uint64, np.uint64]:
    with np.errstate(over="ignore"):
        state = np.uint64(state + np.uint64(0x9E3779B97F4A7C15))
        z = state
        z = np.uint64((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9))
        z = np.uint64((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB))
        return state, np.uint64(z ^ (z >> np.uint64(31)))


def shuffle_indices(n: int, seed: int, *, force_fallback: bool = False) -> np.ndarray:
    """Deterministic Fisher-Yates permutation of [0, n) — identical output
    from the native and fallback paths (tested), so every host derives the
    same epoch order from the seed with no communication."""
    lib = None if force_fallback else load_library()
    out = np.empty(n, dtype=np.uint64)
    if lib is not None:
        lib.kft_shuffle_indices(
            n, np.uint64(seed),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out
    out[:] = np.arange(n, dtype=np.uint64)
    state = np.uint64(seed)
    u64_max = np.uint64(0xFFFFFFFFFFFFFFFF)
    for i in range(n, 1, -1):
        bound = np.uint64(i)
        limit = np.uint64(u64_max - (u64_max % bound))
        while True:
            state, r = _splitmix64(state)
            if r < limit:
                break
        j = int(r % bound)
        out[i - 1], out[j] = out[j], out[i - 1]
    return out


def pack_sequences(
    tokens: np.ndarray,
    doc_offsets: np.ndarray,
    order: np.ndarray,
    eos: int,
    seq_len: int,
    row0: int,
    n_seqs: int,
    *,
    force_fallback: bool = False,
) -> tuple[np.ndarray, int]:
    """Rows [row0, row0+n_seqs) of the packed epoch stream.

    Returns (out[n_seqs, seq_len+1] int32, epoch_rows).  The stream is
    doc[order[0]] EOS doc[order[1]] EOS ..., EOS-padded at the tail.
    """
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    doc_offsets = np.ascontiguousarray(doc_offsets, dtype=np.uint64)
    order = np.ascontiguousarray(order, dtype=np.uint64)
    row = seq_len + 1
    out = np.empty((n_seqs, row), dtype=np.int32)
    lib = None if force_fallback else load_library()
    if lib is not None:
        epoch_rows = lib.kft_pack_sequences(
            tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            doc_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(doc_offsets) - 1,
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            np.int32(eos), seq_len, row0, n_seqs,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out, int(epoch_rows)
    # fallback: materialize the stream window naively
    lengths = (doc_offsets[1:] - doc_offsets[:-1]).astype(np.int64)
    stream_len = int((lengths[order.astype(np.int64)] + 1).sum())
    pieces = []
    for d in order:
        d = int(d)
        pieces.append(tokens[int(doc_offsets[d]): int(doc_offsets[d + 1])])
        pieces.append(np.array([eos], dtype=np.int32))
    stream = np.concatenate(pieces) if pieces else np.empty(0, np.int32)
    lo, hi = row0 * row, (row0 + n_seqs) * row
    window = stream[lo:hi]
    if len(window) < hi - lo:
        window = np.concatenate(
            [window, np.full((hi - lo) - len(window), eos, np.int32)])
    out[:] = window.reshape(n_seqs, row)
    return out, (stream_len + row - 1) // row


def gather_batch(
    data: np.ndarray, idx: np.ndarray, *, force_fallback: bool = False
) -> np.ndarray:
    """out[i] = data[idx[i]] for a 2D int32 array (batch assembly)."""
    data = np.ascontiguousarray(data, dtype=np.int32)
    idx = np.ascontiguousarray(idx, dtype=np.uint64)
    lib = None if force_fallback else load_library()
    if lib is None:
        return data[idx.astype(np.int64)]
    out = np.empty((len(idx), data.shape[1]), dtype=np.int32)
    lib.kft_gather_batch(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        data.shape[1],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


# ---------------------------------------------------------------------------
# On-disk token corpus
# ---------------------------------------------------------------------------

TOKENS_FILE = "tokens.npy"
OFFSETS_FILE = "offsets.npy"


class TokenCorpus:
    """A tokenized document corpus on disk, mmap'd for zero-copy reads.

    Layout: ``tokens.npy`` (int32, all documents concatenated) +
    ``offsets.npy`` (uint64, n_docs+1 prefix offsets) — the standard
    binary-corpus shape (Megatron/.bin+.idx, arrayrecord) minus the framing.
    """

    def __init__(self, tokens: np.ndarray, offsets: np.ndarray):
        self.tokens = tokens
        self.offsets = offsets

    @property
    def n_docs(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_tokens(self) -> int:
        return int(self.offsets[-1])

    @classmethod
    def write(cls, path: str, docs: list[np.ndarray]) -> "TokenCorpus":
        os.makedirs(path, exist_ok=True)
        offsets = np.zeros(len(docs) + 1, dtype=np.uint64)
        for i, d in enumerate(docs):
            offsets[i + 1] = offsets[i] + len(d)
        tokens = (np.concatenate([np.asarray(d, np.int32) for d in docs])
                  if docs else np.empty(0, np.int32))
        np.save(os.path.join(path, TOKENS_FILE), tokens)
        np.save(os.path.join(path, OFFSETS_FILE), offsets)
        return cls.open(path)

    @classmethod
    def open(cls, path: str) -> "TokenCorpus":
        return cls(
            np.load(os.path.join(path, TOKENS_FILE), mmap_mode="r"),
            np.load(os.path.join(path, OFFSETS_FILE)),
        )


def _process_grid() -> tuple[int, int]:
    """(rank, world size) of this process: ``torch.distributed``'s when a
    process group is up, else (0, 1). A sharded trainer passes its batch
    shard instead (the ranks of a ``model`` group share their rows)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class PackedLmCorpus:
    """BatchSource over a TokenCorpus: shuffled, packed, process-sharded.

    Every process derives the same epoch permutation from (seed, epoch) and
    packs only its own rows of the epoch stream — disjoint global coverage
    with zero inter-host coordination, the same contract SyntheticLm keeps.
    ``local_batch(step)`` is resume-aware: any step index reproduces its
    batch exactly (checkpoint restore replays nothing).
    """

    def __init__(
        self,
        corpus: TokenCorpus,
        global_batch: int,
        seq_len: int,
        eos: int = 0,
        *,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        seed: int = 0,
    ):
        self.corpus = corpus
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.eos = eos
        rank, world = _process_grid()
        self.proc = rank if process_index is None else process_index
        self.nproc = world if process_count is None else process_count
        if global_batch % self.nproc:
            raise ValueError(
                f"global batch {global_batch} not divisible by {self.nproc}")
        self.local_bs = global_batch // self.nproc
        self.seed = seed
        row = seq_len + 1
        stream_len = corpus.n_tokens + corpus.n_docs  # + EOS separators
        epoch_rows = (stream_len + row - 1) // row
        #: full global batches per epoch (tail rows are dropped, like every
        #: fixed-shape LM pipeline; <1 batch of data is a config error)
        self.batches_per_epoch = epoch_rows // global_batch
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"corpus ({epoch_rows} rows) smaller than one global batch "
                f"({global_batch} rows of seq_len {seq_len})")
        self._epoch_cache: tuple[int, np.ndarray] = (-1, np.empty(0, np.uint64))

    def _order(self, epoch: int) -> np.ndarray:
        cached_epoch, cached = self._epoch_cache
        if cached_epoch != epoch:
            cached = shuffle_indices(self.corpus.n_docs, self.seed + epoch)
            self._epoch_cache = (epoch, cached)
        return cached

    def local_batch(self, step: int) -> dict[str, np.ndarray]:
        epoch, within = divmod(step, self.batches_per_epoch)
        row0 = within * self.global_batch + self.proc * self.local_bs
        out, _ = pack_sequences(
            self.corpus.tokens, self.corpus.offsets, self._order(epoch),
            self.eos, self.seq_len, row0, self.local_bs)
        return {"tokens": out}
