"""The port's paged-KV pieces (``kubeflow_tpu_torch/serving/paged.py``)
against the reference's (``kubeflow_tpu/serving/paged.py``): the block
gather and scatter views, the write-window tables, and the host-side
``BlockAllocator``; all exact.

Pools are in the scan layout of both packages (k/v ``[L, blocks, bs, kv,
d]``, int8-KV scales ``[L, blocks, kv, bs]``); the port's pool holds one
scratch block more, where the reference's dropped writes land.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.serving import paged as ref

L, N, BS, KV, D = 2, 6, 4, 2, 3
INT32_MAX = np.iinfo(np.int32).max


def _port():
    import torch

    from kubeflow_tpu_torch.models.llama import KvCache
    from kubeflow_tpu_torch.serving import paged

    torch.set_num_threads(1)
    return torch, KvCache, paged


def _pools(seed, scales: bool):
    """(reference pool tree, its block axes, its seq axes, the port's pool
    with a scratch block of NaN appended)."""
    torch, KvCache, _ = _port()
    rng = np.random.default_rng(seed)
    leaves = {"k": rng.standard_normal((L, N, BS, KV, D)).astype(np.float32),
              "v": rng.standard_normal((L, N, BS, KV, D)).astype(np.float32)}
    if scales:
        for n in ("k_scale", "v_scale"):
            leaves[n] = rng.random((L, N, KV, BS)).astype(np.float32)
    names = {"k": "cached_key", "v": "cached_value",
             "k_scale": "cached_key_scale", "v_scale": "cached_value_scale"}
    tree = {names[n]: jnp.asarray(a) for n, a in leaves.items()}
    block_axes = {names[n]: 1 for n in leaves}
    seq_axes = {names[n]: (2 if n in ("k", "v") else 3) for n in leaves}

    def with_scratch(a):
        pad = np.full((L, 1, *a.shape[2:]), np.nan, np.float32)
        return torch.from_numpy(np.concatenate([a, pad], axis=1))

    pool = KvCache(**{n: with_scratch(a) for n, a in leaves.items()},
                   seq_len=BS)
    return tree, block_axes, seq_axes, pool, names


@pytest.mark.parametrize("scales", [False, True],
                         ids=["kv", "kv_int8_scales"])
def test_gather_matches_reference(scales):
    torch, _, paged = _port()
    tree, baxes, saxes, pool, names = _pools(0, scales)
    # pad sentinels (N, and the write tables' int32 max) clip to block N-1
    bt = np.array([[3, 0, N, N], [5, 5, 1, 2], [N, INT32_MAX, 4, 0]],
                  np.int32)
    want = ref.gather_block_view(tree, jnp.asarray(bt), baxes, saxes)
    got = paged.gather_block_view(pool, torch.from_numpy(bt))
    for n, leaf in got.items():
        np.testing.assert_array_equal(
            leaf.numpy(), np.asarray(want[names[n]]), err_msg=n)


@pytest.mark.parametrize("scales", [False, True],
                         ids=["kv", "kv_int8_scales"])
def test_scatter_matches_reference(scales):
    torch, _, paged = _port()
    tree, baxes, saxes, pool, names = _pools(1, scales)
    rng = np.random.default_rng(2)
    # distinct real ids (a real id written twice carries equal bytes only
    # when the rows share a prefix), pad sentinels dropped
    bt = np.array([[2, N, 0], [INT32_MAX, 5, N], [1, 3, INT32_MAX]],
                  np.int32)
    view = {}
    for n in pool.leaves():
        shape = ((L, 3, 3 * BS, KV, D) if n in ("k", "v")
                 else (L, 3, KV, 3 * BS))
        view[n] = rng.standard_normal(shape).astype(np.float32)
    want = ref.scatter_block_view(
        tree, {names[n]: jnp.asarray(a) for n, a in view.items()},
        jnp.asarray(bt), baxes, saxes)
    paged.scatter_block_view(
        pool, {n: torch.from_numpy(a) for n, a in view.items()},
        torch.from_numpy(bt))
    for n, leaf in pool.leaves().items():
        np.testing.assert_array_equal(leaf[:, :N].numpy(),
                                      np.asarray(want[names[n]]), err_msg=n)


def test_working_view_round_trip():
    """The programs' view: the gathered rows plus a scratch row and a
    scratch block column; scattered back through full-write tables it
    leaves the real blocks as they were, and the scratch writes land in
    the scratch block."""
    torch, _, paged = _port()
    _, _, _, pool, _ = _pools(3, True)
    before = {n: t.clone() for n, t in pool.leaves().items()}
    bt = torch.tensor([[0, 1], [N, N]])
    view = paged.gather_working_view(pool, bt)
    assert view.k.shape == (L, 3, 3 * BS, KV, D)
    assert view.k_scale.shape == (L, 3, KV, 3 * BS)
    assert view.seq_len == 2 * BS
    view.k[:, 2] = 7.0            # the scratch row
    view.k[:, :, 2 * BS:] = 9.0   # the scratch column
    front = torch.tensor([0, 2 * BS])
    paged.scatter_working_view(pool, view,
                               paged.write_window_tables(bt, front, BS))
    for n, t in pool.leaves().items():
        assert torch.equal(t[:, :N], before[n][:, :N]), n
    assert pool.k[:, N].isfinite().all()  # the NaN scratch was written


def test_write_window_tables_match_reference():
    torch, _, paged = _port()
    rng = np.random.default_rng(4)
    bt = rng.integers(0, 40, size=(5, 8)).astype(np.int32)
    front = np.array([0, 3, 17, 31, 32], np.int32)
    want = ref.write_window_tables(jnp.asarray(bt), jnp.asarray(front), 4)
    got = paged.write_window_tables(torch.from_numpy(bt),
                                    torch.from_numpy(front), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _script(alloc_cls):
    """One scripted run of the allocator's verbs; returns every result."""
    a = alloc_cls(10, 4)
    out = [a.alloc(3), a.alloc(4), a.free_blocks, a.pad_block]
    first, second = out[0], out[1]
    a.ref(first[:2])
    a.release(first)
    out.append(a.free_blocks)
    a.register(list(range(10)), first)
    a.release(first[:2])
    out.append(a.alloc(2))
    a.register([9, 9, 9, 9, 8, 8, 8, 8, 7], second)
    a.release(second)
    out.append(a.match(np.array([9, 9, 9, 9, 8, 8, 1], np.int64), 6))
    out.append(a.match(np.array([0, 1, 2, 3, 4, 5], np.int64), 5))
    a.ref(second[:1])
    out.append(a.alloc(5))
    out.append(a.alloc(20))
    a.cow_copies_total += 2
    a.prefix_block_hits_total += 1
    out.append(a.stats())
    out.append(ref.block_keys(list(range(13)), 4))
    out.append(ref.lcp([1, 2, 3, 4], np.array([1, 2, 5, 4]), 4))
    with pytest.raises(RuntimeError):
        a.release([first[2]] * 3)
    return out


def test_block_allocator_matches_reference():
    _, _, paged = _port()
    want = _script(ref.BlockAllocator)
    got = _script(paged.BlockAllocator)
    assert got == want
    assert paged.block_keys(list(range(13)), 4) == want[-2]
    assert paged.lcp([1, 2, 3, 4], np.array([1, 2, 5, 4]), 4) == want[-1]
