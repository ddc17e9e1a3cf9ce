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
- the capacity dispatch (4 experts, top-2, capacity factor 0.5, tokens
  dropped) on ``{"expert": 2, "data": 2}``: the logits against the
  reference's expert-parallel forward (atol 1e-5), the loss and every
  synced gradient against one unsharded process's;
- LoRA (rank 4 on wq, wv, wo and w_down: both kinds of product) from a
  reference-written base on ``{"fsdp": 2, "model": 2}``: the loss curve
  against the reference ``Trainer`` (rtol 1e-4), the adapters' first
  synced gradients against one unsharded process's (atol 1e-5);
- Adafactor at a width whose projections factor on ``{"fsdp": 2,
  "model": 2}``: the loss curve against the reference (rtol 1e-4);
- a checkpoint written on ``{"fsdp": 2, "model": 2}`` restores on
  ``{"data": 2, "model": 2}`` bit for bit (params and both moments, and
  Adafactor's factored and whole moments), and the next step's loss
  agrees (rtol 1e-6);
- each rank's rows of a global batch, joined in shard order, are the
  one-process batch on three meshes;
- the MoE tiny served greedily by a gang of the four ranks at
  ``{"expert": 2, "model": 2}`` (rank 0's ``GangEngine``, the others
  following), slot pool and paged: the tokens of the reference's
  ``test_moe_serving.py`` prompts against the reference engine's on the
  same mesh of four virtual devices and unsharded, every rank's program
  outputs bitwise rank 0's, ``w_gate`` ``[4 / 2, h, m / 2]`` a layer, no
  count-matrix host copy; what such a gang refuses by name (a resize, an
  elastic shrink, a kv_migrate export).

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
from kubeflow_tpu.serving.continuous import ContinuousEngine as RefEngine
from kubeflow_tpu.train import data as ref_data
from kubeflow_tpu.train import trainer as ref_train

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_worker as worker  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT_S = 240


def _ref_config(mesh, train_kw=None, **model_kw):
    if model_kw.get("moe_experts"):
        model_kw = dict(model_kw, moe_ragged_compute="grouped")
    return ref_train.TrainConfig(
        model=ref_llama.tiny(attention_impl="flash", **model_kw),
        mesh_axes=mesh, global_batch=worker.BATCH, seq_len=worker.SEQ,
        steps=worker.STEPS, warmup_steps=2, log_every=1, mu_dtype=None,
        aux_loss_coef=0.01, **(train_kw or {}))


def _ref_init(**model_kw):
    t = ref_train.Trainer(_ref_config({}, **model_kw),
                          devices=jax.devices()[:1])
    state = t.init_state(0)
    return jax.tree.map(np.array, nn.meta.unbox(state["params"]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results on each of the four ranks, and the LoRA
    base's snapshot (written by the reference)."""
    from kubeflow_tpu_torch.parallel import dryrun

    inits = {"dense": _ref_init(), "moe": _ref_init(**worker.MOE),
             "wide": _ref_init(**worker.WIDE)}
    snapshot = str(tmp_path_factory.mktemp("base"))
    ref_llama.save_pretrained(snapshot, ref_llama.tiny(attention_impl="flash"),
                              inits["dense"])
    results = dryrun.spawn(
        WORLD, worker.run, inits, str(tmp_path_factory.mktemp("ckpt")),
        snapshot, timeout=SPAWN_TIMEOUT_S)
    return inits, results, snapshot


def _port_trainer(init, train_kw=None, **model_kw):
    import torch

    from kubeflow_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    t = Trainer(worker.train_config({}, train_kw=train_kw, **model_kw),
                device="cpu")
    if init is None:
        t.init_state(0)
    else:
        t.load_params(init)
    return t


def _ref_losses(mesh, init, train_kw=None, params=False, **model_kw):
    """The reference ``Trainer``'s losses on ``mesh`` from ``init`` (the
    params; None: its own ``init_state``, e.g. from ``init_from``); with
    ``params``, also its grad norms and its params after the steps (numpy
    tree)."""
    t = ref_train.Trainer(_ref_config(mesh, train_kw, **model_kw),
                          devices=jax.devices()[:WORLD])
    state = t.init_state(0)
    if init is not None:
        # the same initial params as the port's ranks, on this mesh
        shardings = jax.tree.map(lambda a: a.sharding,
                                 t.abstract_state()["params"])
        state = {**state, "params": jax.device_put(init, shardings)}
    step_fn = t.compiled_step()
    source = ref_data.SyntheticLm(worker.BATCH, worker.SEQ,
                                  t.cfg.model.vocab_size)
    want, norms = [], []
    for batch in ref_data.device_batches(source, t.batch_sharding,
                                         worker.STEPS):
        state, out = step_fn(state, batch)
        want.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    if params:
        return want, norms, jax.tree.map(np.array,
                                         nn.meta.unbox(state["params"]))
    return want


def test_ragged_all_to_all_matches_reference(ranks):
    from jax.sharding import Mesh, PartitionSpec as P

    _, results, _ = ranks
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
    inits, results, _ = ranks
    want = _ref_losses(worker.DENSE_MESHES[name], inits["dense"])
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

    inits, results, _ = ranks
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


def _dropped(model, tokens) -> int:
    """The token copies past their expert's capacity in every MoE layer
    of ``model``'s forward over ``tokens``."""
    import torch

    from kubeflow_tpu_torch.models.moe import MoeMlp, _one_hot

    drops = []

    def hook(m, inp, out):
        _, _, idx = m.route(inp[0])
        mask = _one_hot(idx, m.cfg.moe_experts)          # [b, s, k, e]
        b, s, k, e = mask.shape
        cap = max(1, int(m.cfg.moe_capacity_factor * k * s / e))
        flat = mask.transpose(1, 2).reshape(b, k * s, e)
        pos = flat.cumsum(1) - flat
        drops.append(int(((pos >= cap) * flat).sum()))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, MoeMlp)]
    with torch.no_grad():
        model(tokens)
    for h in handles:
        h.remove()
    return sum(drops)


def test_capacity_moe_matches_one_device_and_reference(ranks):
    """The capacity dispatch over an ``expert`` axis (its slots
    all-to-all'd to the experts' ranks): the logits against the port's
    ``d == 1`` path and the reference's expert-parallel forward, the loss
    and every synced gradient against one unsharded process's."""
    import torch

    inits, results, _ = ranks
    shards = {}
    for res in results:  # an expert group's ranks hold their own rows
        index, count = res["capacity"]["shard"]
        shards[index] = res["capacity"]["logits"]
    assert sorted(shards) == list(range(count))
    logits = np.concatenate([shards[i] for i in range(count)])

    plain = _port_trainer(inits["moe"], **worker.CAPACITY)
    tokens = torch.as_tensor(plain.data_source().local_batch(0)["tokens"])
    # the capacity limit bites: some copies are dropped
    assert _dropped(plain.model, tokens[:, :-1]) > 0
    with torch.no_grad():
        want = plain.model(tokens[:, :-1]).numpy()
    np.testing.assert_allclose(logits, want, atol=1e-5)

    cfg = ref_llama.tiny(attention_impl="flash", **worker.CAPACITY)
    mesh = ref_mesh.build_mesh(worker.CAPACITY_MESH,
                               devices=jax.devices()[:WORLD])
    with ref_shard.shard_context(mesh):
        ref = jax.jit(ref_llama.Llama(cfg).apply)(
            {"params": inits["moe"]}, tokens[:, :-1].numpy())
    np.testing.assert_allclose(logits, np.asarray(ref), atol=1e-5)

    loss = plain.loss_and_grads(tokens)
    for res in results:
        np.testing.assert_allclose(res["capacity"]["loss"], float(loss),
                                   rtol=1e-6)
        assert res["capacity"]["host_copies"] == 0  # equal-sized slots
    for key, p in plain.model.named_parameters():
        for res in results:
            np.testing.assert_allclose(res["capacity"]["grads"][key],
                                       p.grad.numpy(), atol=1e-5,
                                       err_msg=key)


def test_lora_under_tensor_parallelism_matches_reference(ranks):
    """LoRA on ``{"fsdp": 2, "model": 2}``: the loss curve against the
    reference's on the same mesh, and the adapters' first gradients
    (synced: the factor a rank holds whole summed over ``model``)
    against one unsharded process's."""
    _, results, snapshot = ranks
    want = _ref_losses(worker.LORA_MESH, None, {"init_from": snapshot},
                       **worker.LORA)
    for res in results:
        np.testing.assert_allclose(res["lora"]["losses"], want, rtol=1e-4)
        assert res["lora"]["losses"] == results[0]["lora"]["losses"]
    plain = _port_trainer(None, {"init_from": snapshot}, **worker.LORA)
    plain.loss_and_grads(plain.data_source().local_batch(0)["tokens"])
    grads = {k: p.grad.numpy() for k, p in plain.model.named_parameters()
             if p.grad is not None}
    assert len(grads) == 2 * 4 * 2  # (a, b) x 4 targets x 2 layers
    for res in results:
        assert set(res["lora"]["grads"]) == set(grads)
        for key, g in grads.items():
            np.testing.assert_allclose(res["lora"]["grads"][key], g,
                                       atol=1e-5, err_msg=key)


def test_lora_adapter_checkpoint_from_the_mesh_loads_on_one_process(ranks):
    """The adapters-only checkpoint written on ``{"fsdp": 2, "model":
    2}`` (every rank's adapter shards gathered whole) restores in one
    unsharded process, which takes the next batch to the mesh's loss."""
    import torch

    _, results, snapshot = ranks
    plain = _port_trainer(None, {"init_from": snapshot,
                                 "checkpoint_dir": results[0]["lora_ckpt"]},
                          **worker.LORA)
    plain.restore_or_init()
    assert plain.opt.count == worker.STEPS
    tokens = plain.data_source().local_batch(worker.STEPS)["tokens"]
    with torch.no_grad():
        loss = float(plain._loss(torch.as_tensor(tokens)))
    for res in results:
        np.testing.assert_allclose(loss, res["lora"]["next_loss"],
                                   rtol=1e-6)


def test_adafactor_on_the_mesh_matches_reference(ranks):
    """The loss curve, the grad norms, and every parameter after the
    steps: an Adafactor update moves each element by about lr * rms(p),
    far below what the loss shows, so each parameter is held to the
    reference's within a thousandth of its largest move."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.models import llama as port_llama

    inits, results, _ = ranks
    want, norms, final = _ref_losses(
        worker.ADAFACTOR_MESH, inits["wide"], {"optimizer": "adafactor"},
        params=True, **worker.WIDE)
    cfg = port_llama.tiny(attention_impl="flash", **worker.WIDE)
    before = convert.state_dict_from_jax(inits["wide"], cfg)
    after = convert.state_dict_from_jax(final, cfg)
    for res in results:
        # every projection of both layers, the embedding and the head
        # factor; wq/wk/wv's and w_down's second factored dim follows
        # their first (the v_row mean over it is not split)
        assert res["adafactor"]["factored"] == 7 * 2 + 2
        np.testing.assert_allclose(res["adafactor"]["losses"], want,
                                   rtol=1e-4)
        assert res["adafactor"]["losses"] == results[0]["adafactor"]["losses"]
        np.testing.assert_allclose(res["adafactor"]["norms"], norms,
                                   rtol=1e-4)
        got = res["adafactor"]["params"]
        assert set(got) == set(after)
        for k, p in got.items():
            moved = after[k].numpy() - before[k].numpy()
            # a thousandth of the largest move, and the param's rounding
            np.testing.assert_allclose(
                p, after[k].numpy(), rtol=2 ** -22,
                atol=1e-3 * np.abs(moved).max(), err_msg=k)


def test_adafactor_checkpoint_restores_onto_another_mesh(ranks):
    _, results, _ = ranks
    for res in results:
        ck = res["checkpoint_adafactor"]
        assert ck["moments"] == ["v_row", "v_col", "v"] and ck["factored"]
        assert ck["params_equal"] and ck["opt_equal"]
        assert ck["count"] == [3, 3] and ck["steps_on_disk"] == [1, 2]
        np.testing.assert_allclose(ck["next_loss"][1], ck["next_loss"][0],
                                   rtol=1e-6)


def test_checkpoint_restores_onto_another_mesh(ranks):
    _, results, _ = ranks
    for res in results:
        ck = res["checkpoint"]
        assert ck["params_equal"] and ck["opt_equal"]
        assert ck["count"] == [3, 3] and ck["steps_on_disk"] == [1, 2]
        np.testing.assert_allclose(ck["next_loss"][1], ck["next_loss"][0],
                                   rtol=1e-6)


def test_batch_does_not_depend_on_world_size(ranks):
    from kubeflow_tpu_torch.train.data import SyntheticLm

    _, results, _ = ranks
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


@pytest.fixture(scope="module")
def ref_moe_serve(ranks):
    """The reference engine's greedy tokens of ``worker.SERVE_PROMPTS``,
    unsharded and on ``worker.SERVE_MESH`` (four virtual devices), with
    the placement of the mesh engine's first ``w_gate``."""
    inits = ranks[0]
    cfg = ref_llama.tiny(**worker.MOE)
    out = {}
    for name, axes in (("unsharded", None), ("mesh", worker.SERVE_MESH)):
        eng = RefEngine(cfg, inits["moe"], mesh_axes=axes,
                        **worker.SERVE_ENGINES["slot"])
        try:
            if axes is not None:
                wg = eng.params["layers"]["block"]["mlp"]["w_gate"]
                out["spec"] = tuple(wg.sharding.spec)
            out[name] = [eng.generate(p, max_new_tokens=worker.SERVE_NEW)
                         for p in worker.SERVE_PROMPTS]
        finally:
            eng.stop()
    return out


@pytest.mark.parametrize("name", list(worker.SERVE_ENGINES))
def test_moe_serving_on_an_expert_model_gang_matches_reference(
        ranks, ref_moe_serve, name):
    """Every rank's experts split over ``expert`` and their mlp dim over
    ``model`` (the reference's ``spec[1] == "expert"``, ``spec[-1] ==
    "model"``), the gang's greedy tokens the reference's on the mesh and
    unsharded, the followers' program outputs bitwise rank 0's, and no
    host copy of a count matrix while serving."""
    _, results, _ = ranks
    assert ref_moe_serve["spec"][1] == "expert"
    assert ref_moe_serve["spec"][-1] == "model"
    assert ref_moe_serve["mesh"] == ref_moe_serve["unsharded"]
    lead = results[0][f"moe_serve_{name}"]
    assert lead["tokens"] == ref_moe_serve["unsharded"]
    assert lead["stats"]["tp_degree"] == worker.SERVE_MESH["model"]
    cfg = ref_llama.tiny(**worker.MOE)
    local = (cfg.moe_experts // worker.SERVE_MESH["expert"],
             cfg.hidden_size,
             cfg.intermediate_size // worker.SERVE_MESH["model"])
    for res in results:
        got = res[f"moe_serve_{name}"]
        assert got["digests"] == lead["digests"] and got["digests"]
        assert got["host_copies"] == 0
        assert got["w_gate"] == [local] * cfg.num_layers
        assert got["pool_heads"] == (cfg.num_kv_heads
                                     // worker.SERVE_MESH["model"])
        assert got["backend"] == "gloo" and not got["graphs"]


@pytest.mark.parametrize("what", ["resize", "elastic", "export"])
def test_an_expert_gang_refuses_by_name(ranks, what):
    """A resize (``GangResizer.resize``), an elastic shrink
    (``ElasticGangSupervisor`` over the gang) and a kv_migrate export
    (``export_sequence``) of the paged expert x model gang raise a
    ``ValueError`` that names the ``expert`` axis."""
    _, results, _ = ranks
    msg = results[0]["moe_serve_paged"]["refused"][what]
    assert msg is not None and "'expert' axis" in msg
