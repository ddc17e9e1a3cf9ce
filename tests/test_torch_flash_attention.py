"""The port's flash attention (CPU path = the kernels' plain versions) against
the reference Pallas kernels (interpret mode on the CPU), in f32.

torch and the port are imported inside the tests: imported at collection they
would sit in every test worker's heap and slow the other files' tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.ops import flash_attention as ref

# the tolerances of tests/test_flash_attention.py
FWD_TOL = 2e-5
GRAD_TOL = 5e-5


def _port():
    """The port's flash module, with torch set up for exact f32 on the CPU:
    no TF32, and one intra-op thread (tiny shapes; leaves the cores to the
    other test workers)."""
    import torch

    from kubeflow_tpu_torch.ops import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    return flash_attention


def _inputs(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    do = rng.standard_normal((b, s, h, d), dtype=np.float32)
    dlse = rng.standard_normal((b, h, s), dtype=np.float32)
    return q, k, v, do, dlse


def _port_grads(fn, arrays, cotangents):
    import torch

    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cotangents))
    grads = torch.autograd.grad(loss, ts)
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _ref_grads(fn, arrays, cotangents):
    outs, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    outs_t = outs if isinstance(outs, tuple) else (outs,)
    grads = vjp(tuple(map(jnp.asarray, cotangents))
                if isinstance(outs, tuple) else jnp.asarray(cotangents[0]))
    return [np.asarray(o) for o in outs_t], [np.asarray(g) for g in grads]


def _assert_close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("s", [128, 127], ids=["s128", "s127_ragged"])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_flash_attention_matches_reference(h, kv, s):
    port = _port()
    q, k, v, do, _ = _inputs(0, 2, s, h, kv, 32)
    g = h // kv
    outs, grads = _port_grads(
        lambda q, k, v: port.flash_attention(q, k, v, q_per_kv=g),
        (q, k, v), (do,))
    r_outs, r_grads = _ref_grads(
        lambda q, k, v: ref.flash_attention(q, k, v, q_per_kv=g),
        (q, k, v), (do,))
    _assert_close(outs, r_outs, FWD_TOL)
    _assert_close(grads, r_grads, GRAD_TOL)


# s = 127: a length no tile divides, causal and not (on the card, K3 masks
# the keys of its ragged key tile explicitly)
@pytest.mark.parametrize(
    "causal,s", [(True, 128), (False, 128), (True, 127), (False, 127)],
    ids=["causal", "full", "causal_s127", "full_s127"])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_flash_attention_lse_matches_reference(h, kv, causal, s):
    port = _port()
    q, k, v, do, dlse = _inputs(1, 2, s, h, kv, 32)
    g = h // kv
    outs, grads = _port_grads(
        lambda q, k, v: port.flash_attention_lse(
            q, k, v, q_per_kv=g, causal=causal),
        (q, k, v), (do, dlse))
    r_outs, r_grads = _ref_grads(
        lambda q, k, v: ref.flash_attention_lse(
            q, k, v, q_per_kv=g, causal=causal),
        (q, k, v), (do, dlse))
    _assert_close(outs, r_outs, FWD_TOL)    # out and lse
    _assert_close(grads, r_grads, GRAD_TOL)


def test_cpu_wrappers_run_the_plain_versions():
    import torch

    port = _port()
    q, k, v, do, _ = map(torch.tensor, _inputs(2, 1, 64, 4, 2, 16))
    before = dict(port.LAUNCHES)
    o, lse = port.flash_fwd(q, k, v)
    o_p, lse_p = port.flash_fwd_plain(q, k, v)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = (do * o).sum(-1).transpose(1, 2)
    dk, dv = port.flash_bwd_dkv(q, k, v, do, lse, delta)
    dk_p, dv_p = port.flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    assert torch.equal(dk, dk_p) and torch.equal(dv, dv_p)
    assert torch.equal(port.flash_bwd_dq(q, k, v, do, lse, delta),
                       port.flash_bwd_dq_plain(q, k, v, do, lse, delta))
    assert port.LAUNCHES == before  # no kernel ran


def test_kernel_layout_keeps_what_a_tensor_map_takes():
    import torch

    port = _port()
    q = torch.zeros(2, 16, 4, 64)
    assert port._kernel_layout(q) is q
    # a head view of a fused projection: strided, 16-byte aligned
    heads = torch.zeros(2, 16, 12, 64)[:, :, 4:8]
    assert port._kernel_layout(heads) is heads
    # stride 0 (an expanded batch): copied
    wide = torch.zeros(1, 16, 4, 64).expand(3, -1, -1, -1)
    laid = port._kernel_layout(wide)
    assert laid.stride(0) > 0 and torch.equal(laid, wide)
    # head_dim not contiguous: copied
    assert port._kernel_layout(q.transpose(2, 3)).is_contiguous()


def test_shape_mismatches_raise():
    import torch

    port = _port()
    q, k, v, _, _ = map(torch.tensor, _inputs(3, 1, 16, 4, 2, 16))
    with pytest.raises(ValueError):
        port.flash_attention(q, k, v, q_per_kv=3)
    with pytest.raises(ValueError):
        port.flash_fwd(q, k[:, :8], v[:, :8])
    with pytest.raises(ValueError):
        port.flash_fwd(q[..., :8], k, v)


def test_trainer_without_device_needs_a_card(monkeypatch):
    import torch

    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    # no silent CPU path: without a card, only device="cpu" builds a trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig())
    assert Trainer(TrainConfig(), device="cpu").device.type == "cpu"
