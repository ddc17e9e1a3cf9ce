"""The port's sharded training over four gloo processes on the CPU
(``kubeflow_tpu_torch/parallel/``, ``train/trainer.py`` on a mesh), held
against the reference on the same mesh of four virtual devices and against
one unsharded process.

One spawn (``parallel.dryrun.spawn``: a fresh rendezvous port, the
``spawn`` start method, a timeout of its own) runs every case on four ranks
(``tests/_torch_dist_worker.py``); the tests compare:

- ``ragged_all_to_all``: every rank's output and the gradients of
  sum(out * cotangent) for its operand and output buffer, against the
  reference's ``_emulated_ragged_all_to_all`` under ``shard_map`` on the
  same numpy operands (chunks with gaps, out of order), exactly;
- 5 ``tiny()`` steps (flash, f32 μ) on ``{"fsdp": 2, "model": 2}`` and on
  ``{"data": 2, "fsdp": 2}`` from the reference's initial params: the loss
  curve against the reference ``Trainer`` on the same mesh at rtol 1e-4,
  and the first step's global grad norm against one unsharded process's at
  rel 1e-6;
- the MoE ``tiny`` (4 experts, top-2, ragged) on ``{"expert": 2, "data":
  2}`` and on ``{"expert": 2, "model": 2}`` (the experts' mlp dim split
  too): the logits against the port's ``d == 1`` path and the reference's
  expert-parallel forward (atol 1e-5), the loss against the unsharded one
  (rtol 1e-6), every synced gradient against the unsharded ones (atol
  1e-5), and one host copy of the count matrix per MoE layer;
- a checkpoint written on ``{"fsdp": 2, "model": 2}`` restores on
  ``{"data": 2, "model": 2}`` bit for bit (params and both moments), and the
  next step's loss agrees (rtol 1e-6);
- each rank's rows of a global batch, joined in shard order, are the
  one-process batch on three meshes.

torch and the port are imported inside the tests (the spawned ranks import
only them).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref_llama
from kubeflow_tpu.parallel import collectives as ref_coll
from kubeflow_tpu.parallel import mesh as ref_mesh
from kubeflow_tpu.parallel import sharding as ref_shard
from kubeflow_tpu.train import data as ref_data
from kubeflow_tpu.train import trainer as ref_train

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_worker as worker  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT_S = 240


def _ref_config(mesh, **model_kw):
    if model_kw.get("moe_experts"):
        model_kw = dict(model_kw, moe_ragged_compute="grouped")
    return ref_train.TrainConfig(
        model=ref_llama.tiny(attention_impl="flash", **model_kw),
        mesh_axes=mesh, global_batch=worker.BATCH, seq_len=worker.SEQ,
        steps=worker.STEPS, warmup_steps=2, log_every=1, mu_dtype=None,
        aux_loss_coef=0.01)


def _ref_init(**model_kw):
    t = ref_train.Trainer(_ref_config({}, **model_kw),
                          devices=jax.devices()[:1])
    state = t.init_state(0)
    return jax.tree.map(np.array, nn.meta.unbox(state["params"]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results on each of the four ranks."""
    from kubeflow_tpu_torch.parallel import dryrun

    inits = {"dense": _ref_init(), "moe": _ref_init(**worker.MOE)}
    results = dryrun.spawn(
        WORLD, worker.run, inits["dense"], inits["moe"],
        str(tmp_path_factory.mktemp("ckpt")), timeout=SPAWN_TIMEOUT_S)
    return inits, results


def _port_trainer(init, **model_kw):
    import torch

    from kubeflow_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    t = Trainer(worker.train_config({}, **model_kw), device="cpu")
    t.load_params(init)
    return t


def test_ragged_all_to_all_matches_reference(ranks):
    from jax.sharding import Mesh, PartitionSpec as P

    _, results = ranks
    ops = worker.ragged_operands(WORLD)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("x",))
    names = ("operand", "output", "input_offsets", "send_sizes",
             "output_offsets", "recv_sizes")

    def body(operand, output, *idx):
        return ref_coll._emulated_ragged_all_to_all(
            operand[0], output[0], *(i[0] for i in idx), axis_name="x")[None]

    def f(operand, output):
        idx = [jnp.asarray(ops[n], jnp.int32) for n in names[2:]]
        return jax.shard_map(body, mesh=mesh, in_specs=(P("x"),) * 6,
                             out_specs=P("x"), check_vma=False)(
            operand, output, *idx)

    want, vjp = jax.vjp(jax.jit(f), jnp.asarray(ops["operand"]),
                        jnp.asarray(ops["output"]))
    d_operand, d_output = vjp(jnp.asarray(ops["cotangent"]))
    for r, res in enumerate(results):
        got = res["ragged"]
        np.testing.assert_array_equal(got["out"], np.asarray(want[r]))
        np.testing.assert_array_equal(got["d_operand"],
                                      np.asarray(d_operand[r]))
        np.testing.assert_array_equal(got["d_output"],
                                      np.asarray(d_output[r]))


@pytest.mark.parametrize("name", list(worker.DENSE_MESHES))
def test_loss_curve_matches_reference_on_the_mesh(ranks, name):
    inits, results = ranks
    mesh = worker.DENSE_MESHES[name]
    t = ref_train.Trainer(_ref_config(mesh), devices=jax.devices()[:WORLD])
    state = t.init_state(0)
    # the same initial params as the port's ranks, on this mesh
    shardings = jax.tree.map(lambda a: a.sharding,
                             t.abstract_state()["params"])
    state = {**state, "params": jax.device_put(inits["dense"], shardings)}
    step_fn = t.compiled_step()
    source = ref_data.SyntheticLm(worker.BATCH, worker.SEQ,
                                  t.cfg.model.vocab_size)
    want = []
    for batch in ref_data.device_batches(source, t.batch_sharding,
                                         worker.STEPS):
        state, out = step_fn(state, batch)
        want.append(float(out["loss"]))
    for res in results:
        np.testing.assert_allclose(res[name]["losses"], want, rtol=1e-4)
        # every rank reports the same global mean
        assert res[name]["losses"] == results[0][name]["losses"]
    plain = _port_trainer(inits["dense"])
    _, norm = plain.step(plain.data_source().local_batch(0)["tokens"])
    np.testing.assert_allclose(results[0][name]["norms"][0], float(norm),
                               rtol=1e-6)


@pytest.mark.parametrize("name", list(worker.MOE_MESHES))
def test_expert_parallel_moe_matches_one_device_and_reference(ranks, name):
    import torch

    inits, results = ranks
    shards = {}
    for res in results:  # a model group's ranks hold the same rows
        index, count = res[name]["shard"]
        np.testing.assert_array_equal(
            shards.setdefault(index, res[name]["logits"]),
            res[name]["logits"])
    assert sorted(shards) == list(range(count))
    logits = np.concatenate([shards[i] for i in range(count)])

    plain = _port_trainer(inits["moe"], **worker.MOE)
    tokens = torch.as_tensor(plain.data_source().local_batch(0)["tokens"])
    with torch.no_grad():
        want = plain.model(tokens[:, :-1]).numpy()
    np.testing.assert_allclose(logits, want, atol=1e-5)

    cfg = ref_llama.tiny(attention_impl="flash", **worker.MOE)
    mesh = ref_mesh.build_mesh(worker.MOE_MESHES[name],
                               devices=jax.devices()[:WORLD])
    with ref_shard.shard_context(mesh):
        ref = jax.jit(ref_llama.Llama(cfg).apply)(
            {"params": inits["moe"]}, tokens[:, :-1].numpy())
    np.testing.assert_allclose(logits, np.asarray(ref), atol=1e-5)

    loss = plain.loss_and_grads(tokens)
    for res in results:
        np.testing.assert_allclose(res[name]["loss"], float(loss),
                                   rtol=1e-6)
        # one count-matrix copy per MoE layer's forward pass
        assert res[name]["host_copies"] == cfg.num_layers
    for key, p in plain.model.named_parameters():
        for res in results:
            np.testing.assert_allclose(res[name]["grads"][key],
                                       p.grad.numpy(), atol=1e-5,
                                       err_msg=key)


def test_checkpoint_restores_onto_another_mesh(ranks):
    _, results = ranks
    for res in results:
        ck = res["checkpoint"]
        assert ck["params_equal"] and ck["opt_equal"]
        assert ck["count"] == [3, 3] and ck["steps_on_disk"] == [1, 2]
        np.testing.assert_allclose(ck["next_loss"][1], ck["next_loss"][0],
                                   rtol=1e-6)


def test_batch_does_not_depend_on_world_size(ranks):
    from kubeflow_tpu_torch.train.data import SyntheticLm

    _, results = ranks
    want = SyntheticLm(8, worker.SEQ, 256).local_batch(3)["tokens"]
    for name in results[0]["batches"]:
        shards = {}
        for res in results:
            index, count, local, rows = res["batches"][name]
            assert local == 8 // count and rows.shape[0] == local
            if index in shards:  # a model group's ranks share their rows
                np.testing.assert_array_equal(shards[index], rows)
            shards[index] = rows
        assert sorted(shards) == list(range(count))
        np.testing.assert_array_equal(
            np.concatenate([shards[i] for i in range(count)]), want)
