"""The port's trainer, optimizer and data against the reference (CPU, f32).

torch and the port are imported inside the tests (``_port``): imported at
collection they would sit in every test worker's heap and slow the other
files' tests.
"""

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

STEPS, BATCH, SEQ = 5, 4, 32


def _port():
    """torch and the port's modules, with torch set up for exact f32 on the
    CPU: no TF32, one intra-op thread (tiny shapes; leaves the cores to the
    other test workers)."""
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.ops import flash_attention
    from kubeflow_tpu_torch.train import data, optim, trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    return types.SimpleNamespace(
        torch=torch, convert=convert, llama=llama, fa=flash_attention,
        data=data, optim=optim, trainer=trainer)


def _numpy_params(state):
    return jax.tree.map(np.array, nn.meta.unbox(state["params"]))


#: the MoE layers of the MoE loss-curve case (the reference runs them on its
#: grouped GEMM, the port's only expert compute)
MOE = dict(moe_experts=4, moe_top_k=2, moe_dispatch="ragged")


def _reference_run(mu_dtype, **model_kw):
    """Initial params, per-step losses and params after each step of the
    reference trainer on tiny(flash, **model_kw)."""
    if model_kw.get("moe_experts"):
        model_kw = dict(model_kw, moe_ragged_compute="grouped")
    cfg = ref_train.TrainConfig(
        model=ref.tiny(attention_impl="flash", **model_kw),
        global_batch=BATCH, seq_len=SEQ, steps=STEPS, warmup_steps=2,
        log_every=1, mu_dtype=mu_dtype, aux_loss_coef=0.01)
    t = ref_train.Trainer(cfg, devices=jax.devices()[:1])
    state = t.init_state(0)
    init = _numpy_params(state)
    step_fn = t.compiled_step()
    source = ref_data.SyntheticLm(BATCH, SEQ, cfg.model.vocab_size,
                                  process_index=0, process_count=1)
    losses, params = [], []
    for batch in ref_data.device_batches(source, t.batch_sharding, STEPS):
        state, out = step_fn(state, batch)
        losses.append(float(out["loss"]))
        params.append(_numpy_params(state))
    return init, losses, params


@pytest.mark.parametrize("mu_dtype,rtol,model_kw", [
    (None, 1e-4, {}), ("bfloat16", 1e-3, {}), (None, 1e-4, MOE)],
    ids=["mu_f32", "mu_bf16", "moe_mu_f32"])
def test_loss_curve_matches_reference(mu_dtype, rtol, model_kw):
    pt = _port()
    init, want_losses, want_params = _reference_run(
        mu_dtype and jnp.bfloat16, **model_kw)
    cfg = pt.trainer.TrainConfig(
        model=pt.llama.tiny(attention_impl="flash", **model_kw),
        global_batch=BATCH, seq_len=SEQ, steps=STEPS, warmup_steps=2,
        log_every=1, mu_dtype=mu_dtype and pt.torch.bfloat16,
        aux_loss_coef=0.01)
    trainer = pt.trainer.Trainer(cfg, device="cpu")
    trainer.load_params(init)
    source = pt.data.SyntheticLm(BATCH, SEQ, cfg.model.vocab_size)
    losses, params = [], []
    for step in range(STEPS):
        loss, _ = trainer.step(source.local_batch(step)["tokens"])
        losses.append(float(loss))
        params.append({k: v.detach().numpy().copy() for k, v in
                       trainer.model.state_dict().items()})
    np.testing.assert_allclose(losses, want_losses, rtol=rtol)
    # the first step's learning rate is 0 (schedule at the pre-increment
    # count): params after step 1 are the initial ones, on both sides
    for step in (0, STEPS - 1):
        want = pt.convert.state_dict_from_jax(want_params[step], cfg.model)
        for k, v in want.items():
            np.testing.assert_allclose(
                params[step][k], v.numpy(), atol=1e-6 if step == 0 else 2e-5,
                err_msg=f"{k} after step {step + 1}")
    first = pt.convert.state_dict_from_jax(init, cfg.model)
    for k, v in first.items():
        np.testing.assert_array_equal(params[0][k], v.numpy())


def test_train_loop_reports_metrics():
    pt = _port()
    cfg = pt.trainer.TrainConfig(
        model=pt.llama.tiny(), global_batch=BATCH, seq_len=SEQ, steps=4,
        warmup_steps=2, log_every=2)
    seen = []
    last = pt.trainer.Trainer(cfg, device="cpu").train(
        on_metrics=seen.append)
    assert [m.step for m in seen] == [2, 4] and last == seen[-1]
    assert isinstance(last, pt.trainer.StepMetrics)
    assert np.isfinite(last.loss)
    assert last.tokens_per_sec > 0 and last.mfu == 0.0  # no peak for a CPU


def _nan_grads(step):
    """A NaN in one parameter's gradient, the other's all finite: optax's
    clip takes the clipping branch on the NaN norm and turns every
    parameter NaN."""
    return {"a": np.array([0.1, np.nan, 0.1, 0.1], np.float32),
            "b": np.full(3, 0.2 * (step + 1), np.float32)}


@pytest.mark.parametrize("mu_dtype,nan", [
    (None, False), ("bfloat16", False), (None, True)],
    ids=["mu_f32", "mu_bf16", "mu_f32_nan_grad"])
def test_adamw_matches_optax(mu_dtype, nan):
    pt = _port()
    torch = pt.torch
    rng = np.random.default_rng(4)
    shapes = ({"a": (4,), "b": (3,)} if nan
              else {"a": (8, 16), "b": (32,), "c": (4, 4, 4)})
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    steps, warmup, lr = (2, 1, 1e-2) if nan else (4, 2, 1e-2)
    tx = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup, max(steps, warmup + 1)), b1=0.9, b2=0.95,
            weight_decay=0.1, mu_dtype=mu_dtype and jnp.bfloat16))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = pt.optim.AdamW(list(tp.values()), learning_rate=lr,
                         warmup_steps=warmup,
                         decay_steps=max(steps, warmup + 1),
                         mu_dtype=mu_dtype and torch.bfloat16)
    scales = [5.0, 0.01] if nan else [5.0, 0.01, 3.0, 0.02]  # clip fires
    for step, scale in enumerate(scales):
        grads = (_nan_grads(step) if nan else
                 {k: (scale * rng.standard_normal(s)).astype(np.float32)
                  for k, s in shapes.items()})
        updates, state = tx.update(
            jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.tensor(grads[k])
        norm = opt.step()
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for i, k in enumerate(shapes):
            np.testing.assert_allclose(
                tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                atol=1e-7, err_msg=f"{k} after update {step + 1}")
            np.testing.assert_allclose(
                opt.mu[i].float().numpy(),
                np.asarray(state[1][0].mu[k], np.float32), rtol=1e-6,
                atol=1e-8)
            np.testing.assert_allclose(
                opt.nu[i].numpy(), np.asarray(state[1][0].nu[k]),
                rtol=1e-6, atol=1e-12)
    if nan:  # the finite parameter went NaN with the rest, as in optax
        assert np.isnan(tp["b"].detach().numpy()).all()


def test_schedule_matches_optax():
    optim = _port().optim
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 9)
    for count in range(12):
        np.testing.assert_allclose(
            optim.warmup_cosine_decay(count, 3e-4, 3, 9),
            float(sched(count)), rtol=1e-6, atol=1e-12)
    assert optim.warmup_cosine_decay(0, 3e-4, 3, 9) == 0.0


@pytest.mark.parametrize("kw", [
    dict(global_batch=8, seq_len=16, vocab_size=1000, seed=3),
    dict(global_batch=8, seq_len=16, vocab_size=256, process_index=1,
         process_count=2)], ids=["one_process", "second_of_two"])
def test_synthetic_lm_matches_reference(kw):
    a, b = _port().data.SyntheticLm(**kw), ref_data.SyntheticLm(**kw)
    for step in (0, 1, 7):
        np.testing.assert_array_equal(
            a.local_batch(step)["tokens"], b.local_batch(step)["tokens"])


def _grads(pt, cfg, tokens, seed=0):
    model = pt.llama.Llama(cfg, device="cpu")
    model.init_weights(seed)
    x = pt.torch.from_numpy(tokens)
    logits = model(x[:, :-1])
    loss = pt.torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), x[:, 1:].reshape(-1).long())
    loss.backward()
    return float(loss.detach()), {
        n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_remat_policies_match_no_remat(policy, monkeypatch):
    pt = _port()
    tokens = pt.data.SyntheticLm(BATCH, SEQ, 256).local_batch(0)["tokens"]
    base = pt.llama.tiny(attention_impl="flash")
    calls = []
    fwd = pt.fa.flash_fwd
    monkeypatch.setattr(pt.fa, "flash_fwd",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    loss0, want = _grads(pt, base, tokens)
    plain_calls, calls[:] = len(calls), []
    loss1, got = _grads(pt, pt.llama.tiny(attention_impl="flash", remat=True,
                                          remat_policy=policy), tokens)
    assert loss1 == pytest.approx(loss0, rel=1e-6)
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), atol=1e-6,
                                   err_msg=k)
    # the attention forward runs again in the backward pass under remat
    assert plain_calls == base.num_layers
    assert len(calls) == 2 * base.num_layers
