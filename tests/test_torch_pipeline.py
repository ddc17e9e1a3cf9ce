"""Pipeline parallelism of the port (``kubeflow_tpu_torch/parallel/
pipeline.py``, the trainer on ``seq`` and ``pipeline`` mesh axes) against
the reference.

Without a spawn: ``schedule_1f1b``'s tick tables and stash high-waters and
``interleave_permutation`` equal the reference's arrays exactly over a grid
of (stages, microbatches, chunks), and the schedules keep the reference's
properties (the lower bound T = mv + p + pv - 2, interleaving no slower in
wall time).

One spawn (``parallel.dryrun.spawn``: four gloo processes on the CPU,
``tests/_torch_sp_pp_worker.py``) runs the rest:

- ``gpipe`` and ``one_f_one_b`` on the reference test's tanh stack at p in
  {2, 4}, several microbatch counts, and interleaved at (2, 4, 2): the loss
  and every stage's layer gradients against one sequential autograd pass
  (atol 1e-6 / 1e-5), the head's gradient on the last stage and the input's
  on the first;
- the ``Trainer`` (tiny, 4 layers, remat) from the reference's initial
  params, 3 steps: the loss curve against the reference ``Trainer`` on the
  same mesh at rtol 1e-4 on ``{"pipeline": 2, "data": 2}`` (GPipe, 1F1B,
  1F1B with 2 chunks a stage, accumulation x 1F1B, tied embeddings x
  1F1B), the MoE balancing loss under both schedules on ``{"pipeline": 2,
  "model": 2}``, ``{"seq": 2, "fsdp": 2}`` (ring attention),
  ``{"pipeline": 2, "seq": 2}`` over two slices (the planner puts
  ``pipeline`` on DCN), and ``{"pipeline": 2, "fsdp": 2}`` (FSDP2 inside
  the stages) under GPipe and under 1F1B with tied embeddings;
- a checkpoint written on ``{"pipeline": 2, "data": 2}`` (interleaved
  stages), and one written on ``{"pipeline": 2, "fsdp": 2}`` (each stage's
  FSDP2 shards gathered whole), restores bit for bit on ``{"fsdp": 2,
  "model": 2}``, params and both moments in the whole model's order, and
  the next step's loss agrees (rtol 1e-6).

torch and the port are imported inside the tests.
"""

import os
import sys

import jax
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref_llama
from kubeflow_tpu.parallel import pipeline as ref_pipe
from kubeflow_tpu.train import data as ref_data
from kubeflow_tpu.train import trainer as ref_train

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_sp_pp_worker as worker  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT_S = 300


def _port_pipe():
    import torch

    from kubeflow_tpu_torch.parallel import pipeline

    torch.set_num_threads(1)
    return pipeline


GRID = [(p, m, v) for p in (1, 2, 3, 4) for m in (1, 2, 4, 7, 8)
        for v in (1, 2)]


@pytest.mark.parametrize("p,m,v", GRID, ids=[f"p{p}m{m}v{v}"
                                               for p, m, v in GRID])
def test_1f1b_tables_match_reference(p, m, v):
    pipe = _port_pipe()
    want = ref_pipe.schedule_1f1b(p, m, v)
    got = pipe.schedule_1f1b(p, m, v)
    for f in ("fwd", "fwd_lv", "fwd_slot", "fwd_seed_slot", "bwd", "bwd_lv",
              "bwd_slot", "bwd_gslot", "ra_slot", "rg_slot"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.p, got.m, got.v, got.ticks, got.act_slots,
            got.grad_slots) == (want.p, want.m, want.v, want.ticks,
                                want.act_slots, want.grad_slots)
    assert got.useful_fraction == want.useful_fraction


@pytest.mark.parametrize("layers,p,v", [(8, 2, 1), (8, 2, 2), (16, 2, 2),
                                        (16, 4, 2), (16, 2, 4), (12, 3, 2)])
def test_interleave_permutation_matches_reference(layers, p, v):
    pipe = _port_pipe()
    np.testing.assert_array_equal(pipe.interleave_permutation(layers, p, v),
                                  ref_pipe.interleave_permutation(layers, p,
                                                                  v))


def test_schedule_refusals_match_reference():
    pipe = _port_pipe()
    for port, ref, args in (
            (pipe.interleave_permutation, ref_pipe.interleave_permutation,
             (8, 3, 2)),
            (pipe.schedule_1f1b, ref_pipe.schedule_1f1b, (2, 0, 1))):
        with pytest.raises(ValueError) as want:
            ref(*args)
        with pytest.raises(ValueError) as got:
            port(*args)
        assert str(got.value) == str(want.value)


def test_schedule_properties():
    pipe = _port_pipe()
    for p, m, v in [(2, 4, 2), (4, 8, 2), (4, 8, 4), (4, 16, 4)]:
        s = pipe.schedule_1f1b(p, m, v)
        assert s.ticks == m * v + p + p * v - 2
        assert (s.fwd >= 0).sum() == (s.bwd >= 0).sum() == m * v * p
        assert s.act_slots <= p * v + 2
    for p, m in [(2, 8), (4, 8), (4, 16)]:
        t1 = pipe.schedule_1f1b(p, m, 1).ticks
        for v in (2, 4):
            tv = pipe.schedule_1f1b(p, m, v).ticks
            assert tv / v < t1 if p > 2 else tv / v <= t1


def _ref_init(**model_kw):
    cfg = ref_train.TrainConfig(
        model=ref_llama.tiny(**_ref_model_kw(model_kw)), mesh_axes={},
        global_batch=worker.BATCH, seq_len=worker.SEQ)
    t = ref_train.Trainer(cfg, devices=jax.devices()[:1])
    return jax.tree.map(np.array, nn.meta.unbox(t.init_state(0)["params"]))


def _ref_model_kw(model_kw):
    kw = {"attention_impl": "dense", "num_layers": 4, "remat": True,
          **model_kw}
    if kw.get("moe_experts"):
        kw["moe_ragged_compute"] = "grouped"
    return kw


def _sharp_router(params):
    """``params`` with every router's logits scaled up by
    ``worker.ROUTER_SCALE``: at init the router is near uniform, which
    leaves the balancing loss nearly the same whatever rows a microbatch
    holds; peaked routing makes it depend on them."""
    def scale(path, a):
        return a * worker.ROUTER_SCALE if path[-1].key == "router" else a
    return jax.tree_util.tree_map_with_path(scale, params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from kubeflow_tpu_torch.parallel import dryrun

    inits = {"dense": _ref_init(), "tied": _ref_init(tie_embeddings=True),
             "moe": _sharp_router(_ref_init(**worker.MOE))}
    results = dryrun.spawn(WORLD, worker.run_pipeline, inits,
                           str(tmp_path_factory.mktemp("ckpt")),
                           timeout=SPAWN_TIMEOUT_S)
    return inits, results


def _sequential():
    """Loss and gradients of the problem in one autograd pass."""
    import torch

    prob = worker.exec_problem()
    ws = torch.tensor(prob["ws"]).requires_grad_()
    head = torch.tensor(prob["head"]).requires_grad_()
    x = torch.tensor(prob["x"]).requires_grad_()
    h = x
    for i in range(worker.EXEC["layers"]):
        h = torch.tanh(h @ ws[i])
    loss = ((h @ head - torch.tensor(prob["tgt"])) ** 2).mean()
    loss.backward()
    return float(loss), ws.grad.numpy(), head.grad.numpy(), x.grad.numpy()


@pytest.mark.parametrize("case", worker.EXEC_CASES,
                         ids=["{}-p{}-m{}-v{}".format(*c)
                              for c in worker.EXEC_CASES])
def test_executors_match_sequential(ranks, case):
    _, results = ranks
    loss, dws, dhead, dx = _sequential()
    schedule = case[0]
    covered = set()
    for res in results:
        got = res["exec"][case]
        np.testing.assert_allclose(got["loss"], loss, atol=1e-6)
        for i, g in got["layer_grads"].items():
            np.testing.assert_allclose(g, dws[i], atol=1e-5, err_msg=str(i))
            covered.add(i)
        if got["last"] or schedule == "gpipe":
            # GPipe's head runs on every rank, 1F1B's on the last stage
            np.testing.assert_allclose(got["head_grad"], dhead, atol=1e-5)
        else:
            assert got["head_grad"] is None
        np.testing.assert_allclose(got["dx"], dx if got["first"]
                                   else np.zeros_like(dx), atol=1e-5)
    assert covered == set(range(worker.EXEC["layers"]))


def _ref_losses(name, init, params=False):
    """The reference ``Trainer``'s losses in case ``name`` from ``init``;
    with ``params``, also its grad norms and its params after the steps
    (numpy tree)."""
    mesh, slices, train_kw, model_kw = worker.TRAIN_CASES[name]
    cfg = ref_train.TrainConfig(
        model=ref_llama.tiny(**_ref_model_kw(model_kw)), mesh_axes=mesh,
        num_slices=slices, global_batch=worker.BATCH, seq_len=worker.SEQ,
        steps=worker.STEPS, warmup_steps=2, log_every=1, mu_dtype=None,
        aux_loss_coef=0.01, **train_kw)
    t = ref_train.Trainer(cfg, devices=jax.devices()[:WORLD])
    state = t.init_state(0)
    shardings = jax.tree.map(lambda a: a.sharding,
                             t.abstract_state()["params"])
    state = {**state, "params": jax.device_put(init, shardings)}
    step_fn = t.compiled_step()
    source = ref_data.SyntheticLm(worker.BATCH, worker.SEQ,
                                  cfg.model.vocab_size)
    out, norms = [], []
    for batch in ref_data.device_batches(source, t.batch_sharding,
                                         worker.STEPS):
        state, metrics = step_fn(state, batch)
        out.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    if params:
        return out, norms, jax.tree.map(np.array,
                                        nn.meta.unbox(state["params"]))
    return out


@pytest.mark.parametrize("name", list(worker.TRAIN_CASES))
def test_loss_curve_matches_reference(ranks, name):
    inits, results = ranks
    model_kw = worker.TRAIN_CASES[name][3]
    want = _ref_losses(name, inits[worker.init_key(model_kw)])
    for res in results:
        np.testing.assert_allclose(res[name]["losses"], want, rtol=1e-4)
        # every rank reports the same global mean
        assert res[name]["losses"] == results[0][name]["losses"]


@pytest.mark.parametrize("name", worker.PARAM_CASES)
def test_pipeline_fsdp_params_match_reference(ranks, name):
    """FSDP2 inside the stages: the global grad norms and every parameter
    after the steps against the reference's, each parameter within a
    thousandth of its largest move (and its own rounding), so a gradient
    shard handed to the wrong rank or averaged over the wrong ranks shows
    where the loss hides it (clipping and AdamW do not see a gradient's
    scale; the norm does)."""
    from kubeflow_tpu_torch.models import convert

    inits, results = ranks
    model_kw = worker.TRAIN_CASES[name][3]
    init = inits[worker.init_key(model_kw)]
    _, norms, final = _ref_losses(name, init, params=True)
    cfg = worker.train_config({}, **model_kw).model
    before = convert.state_dict_from_jax(init, cfg)
    after = convert.state_dict_from_jax(final, cfg)
    for res in results:
        np.testing.assert_allclose(res[name]["norms"], norms, rtol=1e-4)
        got = res[name]["params"]
        assert set(got) == set(after)
        for k, p in got.items():
            moved = np.abs(after[k].numpy() - before[k].numpy()).max()
            assert moved > 0, k
            np.testing.assert_allclose(p, after[k].numpy(), rtol=2 ** -22,
                                       atol=1e-3 * moved, err_msg=k)


def test_stage_layout(ranks):
    """Each rank holds its stage's blocks: contiguous for GPipe, the model
    chunks {d, P+d} under interleaving."""
    _, results = ranks
    stages = {tuple(r["gpipe"]["stage"]) for r in results}
    assert stages == {(0, 1), (2, 3)}
    stages = {tuple(r["1f1b_interleave"]["stage"]) for r in results}
    assert stages == {(0, 2), (1, 3)}
    assert {tuple(r["seq_fsdp"]["stage"]) for r in results} == {(0, 1, 2, 3)}
    assert {tuple(r["gpipe_fsdp"]["stage"]) for r in results} == {(0, 1),
                                                                  (2, 3)}


def test_checkpoint_restores_onto_another_mesh(ranks):
    _, results = ranks
    for res in results:
        ck = res["checkpoint"]
        assert ck["params_equal"] and ck["opt_equal"]
        assert ck["count"] == [3, 3]
        # the whole model's order, whatever the stage held
        assert [k for k in ck["keys"] if k.startswith("layers.")][0] == \
            "layers.0.attn_norm.scale"
        np.testing.assert_allclose(ck["next_loss"][1], ck["next_loss"][0],
                                   rtol=1e-6)


def test_pipeline_fsdp_checkpoint_restores_onto_another_mesh(ranks):
    _, results = ranks
    for res in results:
        ck = res["checkpoint_fsdp"]
        assert ck["params_equal"] and ck["opt_equal"]
        assert ck["count"] == [3, 3]
        assert ck["keys"] == results[0]["checkpoint"]["keys"]
        np.testing.assert_allclose(ck["next_loss"][1], ck["next_loss"][0],
                                   rtol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"lora_rank": 2},
                                {"moe_experts": 4, "moe_top_k": 2}],
                         ids=["dense", "lora", "moe"])
def test_stage_init_draws_the_unsharded_values(kw):
    """A pipeline stage built on the meta device builds and keeps only its
    blocks, with the values the whole model's init gives them."""
    import torch

    from kubeflow_tpu_torch.models import llama

    _port_pipe()
    cfg = llama.tiny(num_layers=4, **kw)
    whole = llama.Llama(cfg, device="cpu")
    whole.init_weights(3)
    want = whole.state_dict()
    stage = llama.Llama(cfg, device="meta")
    stage.layers = llama.StageLayers({i: stage.layers[i] for i in (1, 3)})
    got: dict = {}
    stage.init_streamed(3, "cpu", got.update)
    assert set(got) == {k for k in want if not k.startswith("layers.")
                        or k.split(".")[1] in ("1", "3")}
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
