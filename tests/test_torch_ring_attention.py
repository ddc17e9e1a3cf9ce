"""Sequence parallelism of the port (``kubeflow_tpu_torch/parallel/
ring_attention.py``, ``attention_impl="ring"`` in ``models/llama.py``)
against the reference's on the same meshes of four devices.

One spawn (``parallel.dryrun.spawn``: four gloo processes on the CPU,
``tests/_torch_sp_pp_worker.py``) runs every case; each rank holds one
sequence block of the same numpy operands. The tests compare:

- ``ring_attention`` with einsum and with flash blocks (the kernels' plain
  versions on the CPU) on ``{"seq": 4}``, ``{"data": 2, "seq": 2}`` and
  ``{"seq": 2, "model": 2}``: each rank's output block against the
  reference's ``ring_attention`` on a jax mesh of the same axes (atol
  2e-5), and the gradients of sum(out * g) for q, k and v against the
  reference's (atol 2e-5);
- ``ulysses_attention``'s output the same way, and its refusal of head
  counts the ``seq`` axis does not divide, as the reference refuses;
- the tiny model with ``attention_impl="ring"`` laid out on ``{"seq": 4}``
  and ``{"seq": 2, "model": 2}`` from the reference's params: every rank's
  logits (its sequence block, rope at global positions) against the
  reference model's under its mesh (atol 1e-5).

``ring_permute`` on a ring (either way) and on an open chain: every rank's
output and its buffer's gradient against ``lax.ppermute`` under
``shard_map``, exactly.

Without a spawn: with no ``seq`` axis, causal attention over the whole
sequence by each block implementation (dense and flash), and
the flash lse (causal and not) against a dense logsumexp.

torch and the port are imported inside the tests.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref_llama
from kubeflow_tpu.parallel import mesh as ref_mesh
from kubeflow_tpu.parallel import ring_attention as ref_ring
from kubeflow_tpu.parallel import sharding as ref_shard
from kubeflow_tpu.train import data as ref_data
from kubeflow_tpu.train import trainer as ref_train

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_sp_pp_worker as worker  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT_S = 240
Q_PER_KV = worker.ATTN["h"] // worker.ATTN["kv"]


def _ref_init(**model_kw):
    cfg = ref_train.TrainConfig(
        model=ref_llama.tiny(num_layers=4, **model_kw), mesh_axes={},
        global_batch=worker.BATCH, seq_len=worker.SEQ)
    t = ref_train.Trainer(cfg, devices=jax.devices()[:1])
    return jax.tree.map(np.array, nn.meta.unbox(t.init_state(0)["params"]))


@pytest.fixture(scope="module")
def ranks():
    from kubeflow_tpu_torch.parallel import dryrun

    init = _ref_init()
    return init, dryrun.spawn(WORLD, worker.run_ring, init,
                              timeout=SPAWN_TIMEOUT_S)


def _reference(axes, fn, block_impl):
    """The reference's output and q/k/v gradients of sum(out * g)."""
    ops = {k: jnp.asarray(v) for k, v in worker.attention_operands().items()}
    mesh = ref_mesh.build_mesh(axes, devices=jax.devices()[:WORLD])

    def f(q, k, v):
        return fn(q, k, v, q_per_kv=Q_PER_KV, mesh=mesh,
                  block_impl=block_impl)

    out, vjp = jax.vjp(jax.jit(f), ops["q"], ops["k"], ops["v"])
    return [np.asarray(t) for t in (out, *vjp(ops["g"]))]


@pytest.mark.parametrize("shift,wrap", [(1, True), (-1, True), (1, False)],
                         ids=["ring_next", "ring_prev", "chain"])
def test_ring_permute_matches_reference(ranks, shift, wrap):
    from jax.sharding import Mesh, PartitionSpec as P

    _, results = ranks
    ops = worker.permute_operands(WORLD)
    perm = [(i, (i + shift) % WORLD) for i in range(WORLD)
            if wrap or 0 <= i + shift < WORLD]
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("x",))
    f = jax.shard_map(lambda x: jax.lax.ppermute(x, "x", perm), mesh=mesh,
                      in_specs=P("x"), out_specs=P("x"))
    want, vjp = jax.vjp(jax.jit(f), jnp.asarray(ops["x"].reshape(-1, 5)))
    (dx,) = vjp(jnp.asarray(ops["g"].reshape(-1, 5)))
    want = np.asarray(want).reshape(WORLD, 3, 5)
    dx = np.asarray(dx).reshape(WORLD, 3, 5)
    for r, res in enumerate(results):
        out, grad = res["permute"][(shift, wrap)]
        np.testing.assert_array_equal(out, want[r])
        np.testing.assert_array_equal(grad, dx[r])


CASES = [(name, "ring", impl) for name in worker.RING_MESHES
         for impl in ("einsum", "flash")]


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_ring_attention_matches_reference(ranks, case):
    _, results = ranks
    name, _, impl = case
    want = _reference(worker.RING_MESHES[name], ref_ring.ring_attention,
                      impl)
    for res in results:
        got = res[case]
        cut = slice(*got["cut"])
        for what, ref in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(got[what], ref[:, cut], atol=2e-5,
                                       err_msg=f"{case} {what}")


@pytest.mark.parametrize("name", list(worker.RING_MESHES))
def test_ulysses_matches_reference(ranks, name):
    _, results = ranks
    want = _reference(worker.RING_MESHES[name], ref_ring.ulysses_attention,
                      "flash")
    for res in results:
        got = res[(name, "ulysses", "flash")]
        cut = slice(*got["cut"])
        for what, ref in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(got[what], ref[:, cut], atol=2e-5,
                                       err_msg=f"{name} {what}")


def test_ulysses_refuses_indivisible_heads(ranks):
    _, results = ranks
    q = jnp.zeros((1, 4, 2, 8))
    mesh = ref_mesh.build_mesh({"seq": 4}, devices=jax.devices()[:WORLD])
    with pytest.raises(ValueError, match="divisible"):
        ref_ring.ulysses_attention(q, q, q, mesh=mesh)
    for res in results:
        assert res["ulysses_refusal"] is not None
        assert "divisible by seq axis size 4" in res["ulysses_refusal"]


@pytest.mark.parametrize("name,axes", [("seq4", {"seq": 4}),
                                       ("seq_model", {"seq": 2, "model": 2})])
def test_ring_model_logits_match_reference(ranks, name, axes):
    init, results = ranks
    cfg = ref_llama.tiny(num_layers=4, attention_impl="ring")
    mesh = ref_mesh.build_mesh(axes, devices=jax.devices()[:WORLD])
    tokens = ref_data.SyntheticLm(worker.BATCH, worker.SEQ,
                                  cfg.vocab_size).local_batch(0)["tokens"]
    with ref_shard.shard_context(mesh):
        want = np.asarray(jax.jit(ref_llama.Llama(cfg).apply)(
            {"params": init}, tokens[:, :-1]))
    seen = set()
    for res in results:
        got = res[("model", name)]
        (index, count), (block, blocks) = got["shard"], got["seq"]
        rows = slice(index * worker.BATCH // count,
                     (index + 1) * worker.BATCH // count)
        width = worker.SEQ // blocks
        cols = slice(block * width, (block + 1) * width)
        np.testing.assert_allclose(got["logits"], want[rows, cols],
                                   atol=1e-5, err_msg=name)
        seen.add((index, block))
    assert len(seen) == blocks * count


def test_ring_falls_back_without_seq_axis():
    import torch

    from kubeflow_tpu_torch.parallel.ring_attention import (
        ring_attention,
        ulysses_attention,
    )

    ops = worker.attention_operands()
    ref_mesh_ = ref_mesh.build_mesh({"data": 8})
    want = np.asarray(ref_ring.ring_attention(
        *(jnp.asarray(ops[n]) for n in "qkv"), q_per_kv=Q_PER_KV,
        mesh=ref_mesh_))
    q, k, v = (torch.tensor(ops[n]) for n in "qkv")
    for fn in (ring_attention, ulysses_attention):
        # no mesh at all; "flash" is the causal flash attention (its plain
        # version on these CPU tensors), "auto" here the dense path
        for impl in ("auto", "einsum", "flash"):
            got = fn(q, k, v, q_per_kv=Q_PER_KV, block_impl=impl).numpy()
            np.testing.assert_allclose(got, want, atol=1e-6,
                                       err_msg=f"{fn.__name__} {impl}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_lse_matches_dense_logsumexp(causal):
    import torch

    from kubeflow_tpu_torch.ops.flash_attention import flash_attention_lse

    ops = worker.attention_operands()
    q, k, v = (torch.tensor(ops[n]) for n in "qkv")
    _, lse = flash_attention_lse(q, k, v, q_per_kv=Q_PER_KV, causal=causal)
    qf = ops["q"].astype(np.float64)
    kf = np.repeat(ops["k"].astype(np.float64), Q_PER_KV, axis=2)
    scores = np.einsum("bqhd,bkhd->bhqk", qf, kf) / np.sqrt(qf.shape[-1])
    if causal:
        s = qf.shape[1]
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    top = scores.max(-1, keepdims=True)
    want = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5)
