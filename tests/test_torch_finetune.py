"""The port's fine-tune path against the reference on tiny() (f32, CPU): LoRA
in the model and the trainer, the adapter functions, Adafactor, gradient
accumulation and checkpoint/resume. The LoRA cases run on a bf16 base too
(``param_dtype``): the reference keeps its adapters f32 under any base.

torch and the port are imported inside the tests (``_port``): imported at
collection they would sit in every test worker's heap and slow the other
files' tests.
"""

import os
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.train import data as ref_data
from kubeflow_tpu.train import trainer as ref_train

LOGITS_TOL = 2e-4
STEPS, BATCH, SEQ = 5, 4, 32
TARGETS_ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: the base's parameter dtype (``param_dtype``) of the LoRA cases
PARAM_DTYPES = ["float32", "bfloat16"]


def _param_dtypes(name):
    """(the reference's, the port's) ``param_dtype`` named ``name``."""
    import torch

    return getattr(jnp, name), getattr(torch, name)


def _port():
    """torch and the port's modules, with torch set up for exact f32 on the
    CPU: no TF32, one intra-op thread."""
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.train import checkpoint, data, optim, trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    return types.SimpleNamespace(
        torch=torch, convert=convert, llama=llama, data=data, optim=optim,
        trainer=trainer, checkpoint=checkpoint)


def _init(rcfg, seed=0):
    params = ref.Llama(rcfg).init(jax.random.PRNGKey(seed),
                                  jnp.ones((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def _nonzero_b(params, seed=1):
    """B of every adapter drawn normal(0, 0.05): a zero B would hide the
    adapter path entirely."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: a, params)
    for mod in out["layers"]["block"].values():
        for leaf in mod.values():
            if isinstance(leaf, dict) and "lora_b" in leaf:
                leaf["lora_b"] = rng.normal(
                    0, 0.05, leaf["lora_b"].shape).astype(np.float32)
    return out


def _tokens(b=2, s=24, vocab=256, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _port_snapshot(pt, path):
    """A port-written tiny() snapshot of random weights (seed 0)."""
    model = pt.llama.Llama(pt.llama.tiny(), device="cpu")
    model.init_weights(0)
    pt.llama.save_pretrained(path, model.cfg, model)


def _port_logits(pt, cfg, sd, tokens):
    model = pt.llama.Llama(cfg, device="cpu")
    model.load_state_dict(sd)
    with pt.torch.no_grad():
        return model(pt.torch.from_numpy(tokens)).numpy()


# -- LoRA in the model --------------------------------------------------------


@pytest.mark.parametrize("targets,alpha", [(("wq", "wv"), 0.0),
                                           (TARGETS_ALL, 16.0)],
                         ids=["qv", "all_alpha16"])
def test_lora_logits_match_reference(targets, alpha):
    pt = _port()
    kw = dict(lora_rank=4, lora_alpha=alpha, lora_targets=targets)
    params = _nonzero_b(_init(ref.tiny(**kw)))
    tokens = _tokens()
    want = np.asarray(ref.Llama(ref.tiny(**kw)).apply({"params": params},
                                                      tokens))
    cfg = pt.llama.tiny(**kw)
    got = _port_logits(pt, cfg, pt.convert.state_dict_from_jax(params, cfg),
                       tokens)
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL)
    assert cfg.lora_scale == ref.tiny(**kw).lora_scale


@pytest.mark.parametrize("param_dtype", PARAM_DTYPES)
def test_merge_adapter_matches_reference(param_dtype):
    """The merged kernels are the reference's: in f32 within 1e-6; on a
    bf16 base (f32 adapters, the sum taken in f32 and rounded once) bit
    for bit."""
    pt = _port()
    rdt, dt = _param_dtypes(param_dtype)
    kw = dict(lora_rank=4, lora_targets=TARGETS_ALL)
    rcfg = ref.tiny(**kw, param_dtype=rdt)
    params = _nonzero_b(_init(rcfg))
    rbase, rada = ref.split_lora(params)
    rmcfg, rmerged = ref.merge_adapter(rcfg, rbase, rada)
    cfg = pt.llama.tiny(**kw, param_dtype=dt)
    sd = pt.convert.state_dict_from_jax(params, cfg)
    base, ada = pt.llama.split_lora(sd)
    assert {v.dtype for v in ada.values()} == {pt.torch.float32}
    mcfg, merged = pt.llama.merge_adapter(cfg, base, ada)
    assert mcfg.lora_rank == 0 and rmcfg.lora_rank == 0
    want = pt.convert.state_dict_from_jax(rmerged, mcfg)
    assert merged.keys() == want.keys()
    for k, v in want.items():
        assert merged[k].dtype == v.dtype == pt.llama.leaf_dtype(k, mcfg), k
        if param_dtype == "bfloat16":
            assert pt.torch.equal(merged[k], v), k
        else:
            np.testing.assert_allclose(merged[k].numpy(), v.numpy(),
                                       atol=1e-6, err_msg=k)
    if param_dtype == "bfloat16":
        return  # the merged kernels are rounded: their logits move
    tokens = _tokens()
    np.testing.assert_allclose(
        _port_logits(pt, mcfg, merged, tokens),
        _port_logits(pt, cfg, sd, tokens), atol=LOGITS_TOL, rtol=LOGITS_TOL)


@pytest.mark.parametrize("param_dtype", PARAM_DTYPES)
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_adapter_crosses_packages(tmp_path, direction, param_dtype):
    """An adapter crosses bit for bit and f32 both ways, whatever the
    base's ``param_dtype``."""
    pt = _port()
    rdt, dt = _param_dtypes(param_dtype)
    kw = dict(lora_rank=4, lora_targets=("wq", "wv", "w_down"))
    rcfg = ref.tiny(**kw, param_dtype=rdt)
    cfg = pt.llama.tiny(**kw, param_dtype=dt)
    params = _nonzero_b(_init(rcfg))
    sd = pt.convert.state_dict_from_jax(params, cfg)
    path = str(tmp_path / "adapter")
    if direction == "reference_to_port":
        ref.save_adapter(path, rcfg, params)
        got_cfg, got = pt.llama.load_adapter(path)
        assert got_cfg == cfg
        _, want = pt.llama.split_lora(sd)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == pt.torch.float32, k
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    else:
        pt.llama.save_adapter(path, cfg, sd)
        got_cfg, got = ref.load_adapter(path)
        assert got_cfg == rcfg
        _, want = ref.split_lora(params)
        assert {np.asarray(x).dtype for x in jax.tree.leaves(got)} == {
            np.dtype(np.float32)}
        jax.tree.map(np.testing.assert_array_equal, got, want)
    assert sorted(os.listdir(path)) == ["adapter.msgpack", "config.json"]


@pytest.mark.parametrize("case", ["quantized_config", "int8_kernel"])
def test_merge_adapter_refuses_int8(case):
    pt = _port()
    cfg = pt.llama.tiny(lora_rank=2)
    sd = pt.llama.Llama(cfg, device="cpu").state_dict()
    base, ada = pt.llama.split_lora(sd)
    if case == "quantized_config":
        import dataclasses

        with pytest.raises(ValueError, match="UNQUANTIZED"):
            pt.llama.merge_adapter(
                dataclasses.replace(cfg, quant_weights=True), base, ada)
    else:
        base = dict(base)
        base["layers.0.attn.wq"] = base["layers.0.attn.wq"].to(
            pt.torch.int8)
        with pytest.raises(ValueError, match="is int8"):
            pt.llama.merge_adapter(cfg, base, ada)


def test_lora_requires_init_from():
    pt = _port()
    cfg = pt.trainer.TrainConfig(model=pt.llama.tiny(lora_rank=2))
    with pytest.raises(ValueError, match="requires init_from"):
        pt.trainer.Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="requires init_from"):
        ref_train.Trainer(ref_train.TrainConfig(model=ref.tiny(lora_rank=2)),
                          devices=jax.devices()[:1])


# -- the trainer against the reference's -------------------------------------


def _ref_curve(cfg, steps=STEPS):
    """Per-step losses and grad norms of the reference trainer, and its
    final params (numpy)."""
    t = ref_train.Trainer(cfg, devices=jax.devices()[:1])
    state = t.restore_or_init(0)
    step_fn = t.compiled_step()
    source = ref_data.SyntheticLm(cfg.global_batch, cfg.seq_len,
                                  cfg.model.vocab_size, process_index=0,
                                  process_count=1)
    losses, norms = [], []
    for batch in ref_data.device_batches(source, t.batch_sharding, steps):
        state, out = step_fn(state, batch)
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, state["params"])


def _port_curve(pt, cfg, steps=STEPS, init=None):
    t = pt.trainer.Trainer(cfg, device="cpu")
    if init is None:
        t.restore_or_init(0)
    else:
        t.load_params(init)
    source = pt.data.SyntheticLm(cfg.global_batch, cfg.seq_len,
                                 cfg.model.vocab_size)
    losses, norms = [], []
    for step in range(steps):
        loss, norm = t.step(source.local_batch(step)["tokens"])
        losses.append(float(loss))
        norms.append(float(norm))
    return losses, norms, t


def _assert_params(pt, trainer, want_tree, rtol, atol, keys=None):
    want = pt.convert.state_dict_from_jax(want_tree, trainer.cfg.model)
    got = trainer.model.state_dict()
    for k in keys or want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("param_dtype", PARAM_DTYPES)
def test_lora_finetune_matches_reference(tmp_path, param_dtype):
    """5 LoRA steps from a reference-written snapshot (f32 or bf16): the
    loss curve and the adapters as the reference's, the adapters f32 in
    both, the base bit-equal to the snapshot, and the reported grad norm
    the adapters' alone."""
    pt = _port()
    rdt, dt = _param_dtypes(param_dtype)
    snap = str(tmp_path / "base")
    base_cfg = ref.tiny(attention_impl="flash", param_dtype=rdt)
    ref.save_pretrained(snap, base_cfg, _init(base_cfg))
    # f32 moments: a bf16 first moment rounds a last-bit gradient
    # difference into a 2^-8 relative step
    kw = dict(global_batch=BATCH, seq_len=SEQ, steps=STEPS, warmup_steps=2,
              log_every=1, init_from=snap, mu_dtype=None)
    want_losses, want_norms, want_params = _ref_curve(ref_train.TrainConfig(
        model=ref.tiny(attention_impl="flash", lora_rank=4,
                       param_dtype=rdt), **kw))
    cfg = pt.trainer.TrainConfig(
        model=pt.llama.tiny(attention_impl="flash", lora_rank=4,
                            param_dtype=dt), **kw)
    losses, norms, t = _port_curve(pt, cfg)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    adapters = [k for k in t.model.state_dict() if pt.llama.is_lora_path(k)]
    assert len(adapters) == 2 * 2 * 2  # (a, b) x (wq, wv) x 2 layers
    assert {np.asarray(x).dtype for p, x in
            jax.tree_util.tree_leaves_with_path(want_params)
            if ref.is_lora_path(tuple(k.key for k in p))} == {
                np.dtype(np.float32)}
    got = t.model.state_dict()
    assert {got[k].dtype for k in adapters} == {pt.torch.float32}
    _assert_params(pt, t, want_params, 1e-4, 1e-7, keys=adapters)
    _, base_sd = pt.llama.load_pretrained(snap)
    assert pt.llama.param_dtype_of(base_sd) == dt
    for k, v in base_sd.items():
        assert pt.torch.equal(got[k], v), k
    assert all(p.grad is None for n, p in t.model.named_parameters()
               if not pt.llama.is_lora_path(n))
    # the reported norm: the adapters' (the reference's includes the base
    # gradients it computes and then zeroes)
    assert all(g < w for g, w in zip(norms, want_norms))


def test_lora_grad_norm_is_the_adapters_norm(tmp_path):
    pt = _port()
    snap = str(tmp_path / "base")
    _port_snapshot(pt, snap)
    cfg = pt.trainer.TrainConfig(model=pt.llama.tiny(lora_rank=4),
                                 init_from=snap, global_batch=BATCH,
                                 seq_len=SEQ, steps=1)
    t = pt.trainer.Trainer(cfg, device="cpu")
    t.init_state()
    tokens = pt.data.SyntheticLm(BATCH, SEQ, 256).local_batch(0)["tokens"]
    t.loss_and_grads(tokens)
    grads = [p.grad for n, p in t.model.named_parameters()
             if pt.llama.is_lora_path(n)]
    want = float(pt.torch.sqrt(sum(g.square().sum() for g in grads)))
    norm = float(t.opt.step())
    assert norm == pytest.approx(want, rel=1e-6)


def _adafactor_leaves(rng):
    """Leaves where optax factors (both dims >= 128), factors a stacked
    leaf, and does not factor (small, 1-d)."""
    return {"factored": rng.standard_normal((128, 160)).astype(np.float32),
            "stacked": rng.standard_normal((2, 130, 128)).astype(np.float32),
            "small": rng.standard_normal((8, 16)).astype(np.float32),
            "vector": rng.standard_normal((200,)).astype(np.float32)}


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adafactor_matches_optax(clip):
    pt = _port()
    torch = pt.torch
    rng = np.random.default_rng(5)
    params = _adafactor_leaves(rng)
    steps, warmup, lr = 5, 2, 1e-2
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adafactor(
        optax.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                           max(steps, warmup + 1)),
        min_dim_size_to_factor=128))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    groups = []
    for k, v in tp.items():
        parts = list(v.unbind(0)) if k == "stacked" else [v]
        for p in parts:
            p.requires_grad_()
        groups.append((tuple(v.shape), parts, pt.optim.LeafCut()))
    opt = pt.optim.Adafactor(groups, learning_rate=lr, warmup_steps=warmup,
                             decay_steps=max(steps, warmup + 1),
                             grad_clip_norm=clip)
    for step in range(steps):
        grads = {k: (rng.standard_normal(v.shape) * (step + 1)).astype(
            np.float32) for k, v in params.items()}
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jp)
        jp = optax.apply_updates(jp, updates)
        for (shape, parts, _), (k, g) in zip(groups, grads.items()):
            gs = list(torch.tensor(g).unbind(0)) if k == "stacked" else \
                [torch.tensor(g)]
            for p, gp in zip(parts, gs):
                p.grad = gp.clone()
        opt.step()
        for (shape, parts, _), k in zip(groups, params):
            got = torch.stack(parts).detach().numpy().reshape(shape)
            np.testing.assert_allclose(got, np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {step}")
    assert opt.v_row[0] is not None and opt.v[-1] is not None


def test_adafactor_trainer_matches_reference():
    pt = _port()
    rcfg = ref.tiny(attention_impl="flash")
    init = _init(rcfg)
    kw = dict(global_batch=BATCH, seq_len=SEQ, steps=STEPS, warmup_steps=2,
              log_every=1, optimizer="adafactor")
    t = ref_train.Trainer(ref_train.TrainConfig(model=rcfg, **kw),
                          devices=jax.devices()[:1])
    state = t.init_state(0)
    state = {**state, "params": jax.tree.map(jnp.asarray, init)}
    step_fn = t.compiled_step()
    source = ref_data.SyntheticLm(BATCH, SEQ, 256, process_index=0,
                                  process_count=1)
    want = []
    for batch in ref_data.device_batches(source, t.batch_sharding, STEPS):
        state, out = step_fn(state, batch)
        want.append(float(out["loss"]))
    cfg = pt.trainer.TrainConfig(
        model=pt.llama.tiny(attention_impl="flash"), **kw)
    losses, _, trainer = _port_curve(pt, cfg, init=init)
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    _assert_params(pt, trainer, jax.tree.map(np.asarray, state["params"]),
                   1e-4, 1e-5)


@pytest.mark.parametrize("model_kw", [
    {}, dict(moe_experts=4, moe_top_k=2, moe_dispatch="ragged")],
    ids=["dense", "moe_ragged"])
def test_accum_matches_reference(model_kw):
    pt = _port()
    rkw = dict(model_kw, moe_ragged_compute="grouped") if model_kw else {}
    rcfg = ref.tiny(attention_impl="flash", **rkw)
    init = _init(rcfg)
    kw = dict(global_batch=BATCH, seq_len=SEQ, steps=STEPS, warmup_steps=2,
              log_every=1, accum_steps=2, mu_dtype=None, aux_loss_coef=0.01)
    t = ref_train.Trainer(ref_train.TrainConfig(model=rcfg, **kw),
                          devices=jax.devices()[:1])
    state = {**t.init_state(0), "params": jax.tree.map(jnp.asarray, init)}
    step_fn = t.compiled_step()
    source = ref_data.SyntheticLm(BATCH, SEQ, 256, process_index=0,
                                  process_count=1)
    want = []
    for batch in ref_data.device_batches(source, t.batch_sharding, STEPS):
        state, out = step_fn(state, batch)
        want.append(float(out["loss"]))
    cfg = pt.trainer.TrainConfig(
        model=pt.llama.tiny(attention_impl="flash", **model_kw), **kw)
    losses, _, _ = _port_curve(pt, cfg, init=init)
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_accum_rejects_an_uneven_batch():
    pt = _port()
    cfg = pt.trainer.TrainConfig(global_batch=3, seq_len=8, accum_steps=2)
    t = pt.trainer.Trainer(cfg, device="cpu")
    t.init_state()
    with pytest.raises(ValueError, match="not divisible"):
        t.step(np.zeros((3, 9), np.int32))


# -- checkpoints --------------------------------------------------------------


def _ckpt_cfg(pt, tmp_path, steps, **kw):
    return pt.trainer.TrainConfig(
        model=pt.llama.tiny(), global_batch=BATCH, seq_len=SEQ, steps=steps,
        warmup_steps=2, log_every=1, checkpoint_dir=str(tmp_path / "ckpt"),
        save_interval_steps=3, **kw)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, optimizer):
    pt = _port()
    full = pt.trainer.Trainer(pt.trainer.TrainConfig(
        model=pt.llama.tiny(), global_batch=BATCH, seq_len=SEQ, steps=5,
        warmup_steps=2, log_every=1, optimizer=optimizer), device="cpu")
    want = []
    full.train(on_metrics=lambda m: want.append(m.loss))
    first = pt.trainer.Trainer(_ckpt_cfg(pt, tmp_path, 3,
                                         optimizer=optimizer), device="cpu")
    first.train()
    assert first.ckpt.all_steps() == [1, 3]
    second = pt.trainer.Trainer(_ckpt_cfg(pt, tmp_path, 5,
                                          optimizer=optimizer), device="cpu")
    got = []
    second.train(on_metrics=lambda m: got.append((m.step, m.loss)))
    assert [s for s, _ in got] == [4, 5]
    assert [loss for _, loss in got] == want[3:]
    a, b = full.model.state_dict(), second.model.state_dict()
    for k in a:
        assert pt.torch.equal(a[k], b[k]), k
    assert second.ckpt.all_steps() == [1, 3, 5]


def test_lora_checkpoints_hold_the_adapters_only(tmp_path):
    pt = _port()
    snap = str(tmp_path / "base")
    _port_snapshot(pt, snap)
    cfg = _ckpt_cfg(pt, tmp_path, 4, init_from=snap)
    cfg.model = pt.llama.tiny(lora_rank=2)
    t = pt.trainer.Trainer(cfg, device="cpu")
    t.train()
    state = t.ckpt.restore()
    assert set(state) == {"step", "opt_state", "adapters"}
    assert all(pt.llama.is_lora_path(k) for k in state["adapters"])
    _, lora = pt.llama.split_lora(t.model)
    for k, v in lora.items():
        assert pt.torch.equal(state["adapters"][k], v)
    resumed = pt.trainer.Trainer(cfg, device="cpu")
    resumed.restore_or_init()
    assert resumed.opt.count == 4
    for k, v in t.model.state_dict().items():
        assert pt.torch.equal(resumed.model.state_dict()[k], v), k


def test_sigterm_leaves_a_complete_step(tmp_path):
    pt = _port()
    t = pt.trainer.Trainer(_ckpt_cfg(pt, tmp_path, 6), device="cpu")

    def on_metrics(m):
        if m.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(SystemExit) as e:
        t.train(on_metrics=on_metrics)
    assert e.value.code == 143
    assert t.ckpt.latest_step() == 2
    assert t.ckpt.restore()["step"] == 2
    assert signal.getsignal(signal.SIGTERM) is not None


def test_max_to_keep_prunes_and_staging_is_never_latest(tmp_path):
    pt = _port()
    mgr = pt.checkpoint.CheckpointManager(str(tmp_path), save_interval_steps=1)
    for step in range(1, 6):
        assert mgr.save(step, {"w": pt.torch.full((2,), float(step))})
    assert mgr.all_steps() == [3, 4, 5]
    assert not mgr.save(5, {"w": pt.torch.zeros(2)}, force=True)
    # a torn write: a staging directory and an empty step directory
    os.makedirs(tmp_path / ".staging-9-deadbeef")
    (tmp_path / ".staging-9-deadbeef" / "state.pt").write_bytes(b"torn")
    os.makedirs(tmp_path / "8")
    assert mgr.latest_step() == 5
    assert float(mgr.restore()["w"][0]) == 5.0
    again = pt.checkpoint.CheckpointManager(str(tmp_path))
    assert again.latest_step() == 5
    assert not (tmp_path / ".staging-9-deadbeef").exists()


def test_save_decision_follows_orbax(tmp_path):
    pt = _port()
    mgr = pt.checkpoint.CheckpointManager(str(tmp_path),
                                          save_interval_steps=4)
    saved = [s for s in range(1, 10) if mgr.save(s, {"s": s})]
    assert saved == [1, 4, 8]
