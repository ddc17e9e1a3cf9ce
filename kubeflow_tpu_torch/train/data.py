"""Synthetic LM token stream, numpy only.

A copy of ``kubeflow_tpu/train/data.py::SyntheticLm`` that needs no jax: the
same ``(seed, step, row)`` gives the same tokens, so both packages train on
one stream.
"""

from __future__ import annotations

import numpy as np


class SyntheticLm:
    """Deterministic fake LM tokens: each row is an arithmetic sequence mod
    vocab whose start and stride come from a splitmix64-style hash of
    (seed, step, row). Independent of world size for a fixed global batch."""

    def __init__(self, global_batch: int, seq_len: int, vocab_size: int, *,
                 process_index: int = 0, process_count: int = 1,
                 seed: int = 0):
        if global_batch % process_count:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"{process_count} processes")
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.proc = process_index
        self.local_bs = global_batch // process_count
        self.seed = seed

    def local_batch(self, step: int) -> dict[str, np.ndarray]:
        row0 = self.proc * self.local_bs
        rows = np.arange(row0, row0 + self.local_bs, dtype=np.uint64)
        # uint64 wraparound is the point of the hash
        with np.errstate(over="ignore"):
            x = (rows * np.uint64(0x9E3779B97F4A7C15)
                 + np.uint64(step) * np.uint64(0x94D049BB133111EB)
                 + np.uint64(self.seed))
            x ^= x >> np.uint64(30)
            x *= np.uint64(0xBF58476D1CE4E5B9)
            x ^= x >> np.uint64(27)
        start = (x % np.uint64(self.vocab_size)).astype(np.int64)
        stride = ((x >> np.uint64(17)) % np.uint64(7)
                  + np.uint64(1)).astype(np.int64)
        pos = np.arange(self.seq_len + 1, dtype=np.int64)
        tokens = (start[:, None] + stride[:, None] * pos[None, :]) \
            % self.vocab_size
        return {"tokens": tokens.astype(np.int32)}
