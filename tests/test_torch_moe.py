"""The port's MoE MLP against the reference on the same weights (f32, CPU).

The routing is compared first: one near-tie resolved differently by the two
frameworks would move a token to another expert and its output by O(1), so
the values are compared only once the expert ids and the sort order agree.
torch and the port are imported inside the tests: imported at collection they
would sit in every test worker's heap and slow the other files' tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.models.moe import MoeMlp as RefMoeMlp

OUT_TOL = 2e-5
GRAD_TOL = 1e-4
AUX_TOL = 1e-6
AUX_COT = 0.5  # cotangent of the aux loss, so the router sees its gradient
NAMES = ("router", "w_gate", "w_up", "w_down")
#: (dispatch, the reference's expert compute): the port's ragged dispatch
#: runs its grouped GEMM against both of the reference's
MODES = [("dense", "auto"), ("ragged", "masked"), ("ragged", "grouped")]
MODE_IDS = ["dense", "ragged_masked", "ragged_grouped"]


def _port():
    """torch and the port's model modules, with torch set up for exact f32
    on the CPU: no TF32, one intra-op thread."""
    import torch

    from kubeflow_tpu_torch.models import convert, llama, moe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    return torch, llama, moe, convert


def _inputs(seed, b=2, s=8, h=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h), dtype=np.float32),
            rng.standard_normal((b, s, h), dtype=np.float32))


def _reference(rcfg, x, dy):
    """(params, y, aux, routing ids, grads wrt x and params) of the
    reference layer."""
    mod = RefMoeMlp(rcfg)
    params = nn.meta.unbox(
        mod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])

    def f(xx, p):
        y, mut = mod.apply({"params": p}, xx, mutable=["intermediates"])
        return y, mut["intermediates"]["moe_aux_loss"][0]

    (y, aux), vjp = jax.vjp(f, jnp.asarray(x), params)
    gx, gp = vjp((jnp.asarray(dy), jnp.float32(AUX_COT)))
    probs = jax.nn.softmax(
        jnp.einsum("bsh,he->bse", jnp.asarray(x), params["router"]), axis=-1)
    ids = jax.lax.top_k(probs, rcfg.moe_top_k)[1]
    grads = {"x": gx, **gp}
    return (jax.tree.map(np.asarray, params), np.asarray(y), float(aux),
            np.asarray(ids), jax.tree.map(np.asarray, grads))


def _port_layer(pt, pcfg, params):
    torch, _, moe, _ = pt
    layer = moe.MoeMlp(pcfg, device="cpu")
    with torch.no_grad():
        for name in NAMES:
            getattr(layer, name).copy_(torch.tensor(params[name]))
    return layer


@pytest.mark.parametrize("dispatch,compute", MODES, ids=MODE_IDS)
def test_moe_mlp_matches_reference(dispatch, compute):
    pt = _port()
    torch, llama = pt[0], pt[1]
    kw = dict(moe_experts=4, moe_top_k=2, moe_dispatch=dispatch)
    x, dy = _inputs(0)
    params, want_y, want_aux, want_ids, want_g = _reference(
        ref.tiny(moe_ragged_compute=compute, **kw), x, dy)
    layer = _port_layer(pt, llama.tiny(**kw), params)
    xt = torch.tensor(x, requires_grad=True)
    ids = layer.route(xt)[2]
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(
        torch.argsort(ids.reshape(-1), stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(want_ids).reshape(-1),
                               stable=True)))
    y, aux = layer(xt)
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=OUT_TOL)
    np.testing.assert_allclose(float(aux.detach()), want_aux, atol=AUX_TOL)
    leaves = [xt] + [getattr(layer, n) for n in NAMES]
    got = torch.autograd.grad(
        (y * torch.from_numpy(dy)).sum() + AUX_COT * aux, leaves)
    for name, g in zip(("x",) + NAMES, got):
        np.testing.assert_allclose(g.numpy(), want_g[name], atol=GRAD_TOL,
                                   err_msg=name)


def test_ragged_offsets_and_permutes():
    """Offsets from searchsorted equal the per-expert counts' prefix sums,
    and the permutes' gather backwards equal autograd's scatter-adds."""
    torch, _, moe, _ = _port()
    rng = np.random.default_rng(5)
    n, k, e, h = 12, 2, 4, 8
    flat = torch.from_numpy(rng.integers(0, e, n * k))
    order = torch.argsort(flat, stable=True)
    inv = torch.argsort(order)
    offs = torch.searchsorted(flat[order], torch.arange(e + 1),
                              out_int32=True)
    np.testing.assert_array_equal(
        offs.numpy(), np.concatenate([[0], np.cumsum(np.bincount(
            flat.numpy(), minlength=e))]))
    xf = torch.tensor(rng.standard_normal((n, h)), requires_grad=True)
    g = torch.from_numpy(rng.standard_normal((n * k, h)))
    got = torch.autograd.grad(
        moe._GatherTokens.apply(xf, order, inv, k), xf, g)[0]
    want = torch.autograd.grad(xf[order // k], xf, g)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)
    ys = torch.tensor(rng.standard_normal((n * k, h)), requires_grad=True)
    got = torch.autograd.grad(moe._Permute.apply(ys, inv, order), ys, g)[0]
    want = torch.autograd.grad(ys[inv], ys, g)[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("dispatch,top_k", [
    ("dense", 2), ("ragged", 1), ("ragged", 2)],
    ids=["dense", "ragged_top1", "ragged_top2"])
def test_identical_experts_equal_dense_mlp(dispatch, top_k):
    """With every expert equal to one dense MLP and the top-k gates
    renormalised, the MoE layer is that MLP (no token dropped: capacity
    factor 2 covers top-2 of 4 experts)."""
    torch, llama, moe, _ = _port()
    cfg = llama.tiny(moe_experts=4, moe_top_k=top_k, moe_dispatch=dispatch,
                     moe_capacity_factor=2.0)
    gen = torch.Generator().manual_seed(0)
    dense = llama.Mlp(cfg, device="cpu")
    layer = moe.MoeMlp(cfg, device="cpu")
    with torch.no_grad():
        dense.init_weights(gen)
        layer.init_weights(gen)
        for name in ("w_gate", "w_up", "w_down"):
            getattr(layer, name).copy_(getattr(dense, name).expand_as(
                getattr(layer, name)))
    x = torch.from_numpy(_inputs(7)[0])
    y, _ = layer(x)
    np.testing.assert_allclose(y.detach().numpy(), dense(x).detach().numpy(),
                               atol=2e-5)


def test_moe_llama_logits_match_reference():
    """The whole MoE model (ragged dispatch; the reference picks masked
    compute off a TPU, the port grouped) through ``convert``; the unrolled
    layout of the same params converts to the same state dict."""
    torch, llama, _, convert = _port()
    kw = dict(moe_experts=4, moe_top_k=2, moe_dispatch="ragged")
    rcfg = ref.tiny(**kw)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 16),
                                               dtype=np.int32)
    params = jax.tree.map(np.asarray, nn.meta.unbox(ref.Llama(rcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]))
    model = llama.Llama(llama.tiny(**kw), device="cpu")
    sd = convert.state_dict_from_jax(params, model.cfg)
    assert sd.keys() == model.state_dict().keys()
    unrolled = {k: v for k, v in params.items() if k != "layers"}
    for i in range(rcfg.num_layers):
        unrolled[f"layer_{i}"] = jax.tree.map(
            lambda a, i=i: a[i], params["layers"]["block"])
    for k, v in convert.state_dict_from_jax(unrolled, model.cfg).items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    model.load_state_dict(sd)
    want = np.asarray(ref.Llama(rcfg).apply({"params": params}, tokens))
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(tokens), return_aux=True)
    np.testing.assert_allclose(logits.numpy(), want, atol=2e-4, rtol=2e-4)
    assert aux.shape == () and np.isfinite(float(aux))


def test_moe_remat_matches_no_remat_and_recomputes_gmm(monkeypatch):
    """Under remat "dots" the grouped products are recomputed in the
    backward pass (a kernel output is not an mm): 3 forward + 3 recomputed +
    3 dx gmm and 3 tgmm per layer, the counts chip_smoke.py holds the card
    to; the gradients equal those without remat."""
    torch, llama, _, _ = _port()
    from kubeflow_tpu_torch.ops import grouped_matmul as gm

    calls = {"gmm": 0, "tgmm": 0}
    for name in calls:
        fn = getattr(gm, name)
        monkeypatch.setattr(gm, name, lambda *a, _f=fn, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1) or _f(*a, **k)))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 17), dtype=np.int64))
    grads, counts = [], []
    for remat in (False, True):
        cfg = llama.tiny(moe_experts=4, moe_top_k=2, moe_dispatch="ragged",
                         remat=remat)
        model = llama.Llama(cfg, device="cpu")
        model.init_weights(0)
        calls.update(gmm=0, tgmm=0)
        logits, aux = model(tokens[:, :-1], return_aux=True)
        (torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
         + 0.01 * aux).backward()
        counts.append(dict(calls))
        grads.append({n: p.grad for n, p in model.named_parameters()})
    layers = llama.tiny().num_layers
    assert counts == [{"gmm": 6 * layers, "tgmm": 3 * layers},
                      {"gmm": 9 * layers, "tgmm": 3 * layers}]
    for name, g in grads[0].items():
        np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(),
                                   atol=1e-6, err_msg=name)


def test_chip_smoke_moe_stream_gaps_tell_a_wrong_path():
    """``chip_smoke._stream_gaps`` on a tiny bf16 MoE model: a served
    stream whose routing rounded one near tie the other way (row 3, at
    its smallest router margin) is reproduced by one routing flip, with
    drawn tokens over the limit; the same stream with every fourth token
    from position 8 on the model's second choice is not."""
    import torch

    import chip_smoke
    from kubeflow_tpu_torch.models import llama

    torch.set_num_threads(2)
    cfg = llama.tiny(moe_experts=8, moe_top_k=2, moe_dispatch="ragged",
                     dtype=torch.bfloat16, max_seq_len=96)
    model = llama.Llama(cfg, device="cpu")
    model.init_weights(1)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (4, 48)).tolist()

    def greedy(prompt, flips):
        seq = list(prompt)
        for _ in range(32):
            # a trailing token makes the slice score the last real one
            lg, _ = chip_smoke._flipped_forward(
                model, torch.tensor([seq + [0]]), len(seq),
                [[f for f in flips if f[1] < len(seq)]])
            seq.append(int(lg[0, -1].argmax()))
        return seq[len(prompt):]

    streams = [greedy(p, []) for p in prompts]
    seq = torch.tensor([prompts[3] + streams[3]])
    _, probs = chip_smoke._flipped_forward(model, seq, 48, [[]])
    top = probs[:, 0, 48:68].topk(3, dim=-1).values
    margin = ((top[..., 1] - top[..., 2]) / top[..., 1]).flatten()
    at = int(margin.argmin())
    streams[3] = greedy(prompts[3], [(at // 20, 48 + at % 20)])
    served = chip_smoke._stream_gaps(model, prompts, streams)
    assert served["gap_max_unflipped"] > chip_smoke.STREAM_GAP_TOL
    assert not served["over_tol"] and served["routing_explained"] >= 1
    assert served["control_over_tol"] >= 0.9
    second = chip_smoke._forced_logits(model, prompts, streams).topk(
        2, dim=-1).indices[..., 1]
    wrong = [list(s) for s in streams]
    for r in range(4):
        for i in range(8, 32, 4):
            wrong[r][i] = int(second[r, i])
    assert chip_smoke._stream_gaps(model, prompts, wrong)["over_tol"]
