"""The port's grouped matmul (CPU path = the kernels' plain versions) against
the reference's MegaBlox kernels (interpret mode on the CPU), in f32.

torch and the port are imported inside the tests: imported at collection they
would sit in every test worker's heap and slow the other files' tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.ops.grouped_matmul import grouped_matmul as ref_gmm

# the tolerances of tests/test_grouped_matmul.py
FWD_TOL = 2e-5
GRAD_TOL = 1e-4

# the group-size patterns of tests/test_grouped_matmul.py (B = 128 rows)
SIZES = [
    [10, 0, 15],          # empty group + trailing no-group rows
    [32, 32, 32, 32],     # exact tile alignment
    [1, 127],             # boundary mid-tile
    [0, 0, 64],           # leading empty groups + trailing no-group rows
]
IDS = ["empty_and_tail", "aligned", "mid_tile", "leading_empty"]


def _port():
    """The port's grouped-matmul module, with torch set up for exact f32 on
    the CPU: no TF32, one intra-op thread."""
    import torch

    from kubeflow_tpu_torch.ops import grouped_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    return torch, grouped_matmul


def _inputs(seed, sizes, b=128, h=64, m=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h), dtype=np.float32)
    w = rng.standard_normal((len(sizes), h, m), dtype=np.float32)
    g = rng.standard_normal((b, m), dtype=np.float32)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return x, w, g, offs


@pytest.mark.parametrize("sizes", SIZES, ids=IDS)
def test_gmm_matches_reference(sizes):
    torch, gm = _port()
    x, w, _, offs = _inputs(0, sizes)
    want = np.asarray(ref_gmm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(offs)))
    got = gm.gmm(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(offs)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL)
    assert not got[offs[-1]:].any()  # rows of no group are exactly zero
    # trans_w reads w[e] transposed: the same product from [E, N, K]
    wt = torch.from_numpy(np.ascontiguousarray(w.swapaxes(1, 2)))
    got_t = gm.gmm(torch.from_numpy(x), wt, torch.from_numpy(offs),
                   trans_w=True).numpy()
    np.testing.assert_allclose(got_t, want, atol=FWD_TOL)


@pytest.mark.parametrize("sizes", SIZES, ids=IDS)
def test_grads_match_reference(sizes):
    torch, gm = _port()
    x, w, g, offs = _inputs(1, sizes)
    _, vjp = jax.vjp(lambda a, b: ref_gmm(a, b, jnp.asarray(offs)),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = gm.grouped_matmul(xt, wt, torch.from_numpy(offs))
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx),
                               atol=GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw),
                               atol=GRAD_TOL)
    assert not dx[offs[-1]:].any()
    for e, n in enumerate(sizes):
        if n == 0:  # an empty group's weight gradient is exactly zero
            assert not dw[e].any()


def test_tgmm_is_the_weight_gradient():
    torch, gm = _port()
    x, _, g, offs = _inputs(2, [40, 0, 50, 30])
    got = gm.tgmm(torch.from_numpy(x), torch.from_numpy(g),
                  torch.from_numpy(offs)).numpy()
    for e, (lo, hi) in enumerate(zip(offs[:-1], offs[1:])):
        np.testing.assert_allclose(got[e], x[lo:hi].T @ g[lo:hi], atol=1e-4)
    assert got.shape == (4, 64, 96) and not got[1].any()


@pytest.mark.parametrize("case", [
    "offsets_dtype", "offsets_len", "contraction", "meta_device"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    torch, gm = _port()
    x, w, offs = torch.zeros(16, 8), torch.zeros(2, 8, 16), torch.tensor(
        [0, 8, 16], dtype=torch.int32)
    if case == "offsets_dtype":
        with pytest.raises(ValueError, match="int32"):
            gm.gmm(x, w, offs.long())
    elif case == "offsets_len":
        with pytest.raises(ValueError, match="offsets"):
            gm.gmm(x, w, offs[:2])
    elif case == "contraction":
        with pytest.raises(ValueError, match="do not match"):
            gm.gmm(x, w, offs, trans_w=True)
    else:
        with pytest.raises(ValueError, match="no grouped matmul"):
            gm.gmm(x.to("meta"), w.to("meta"), offs.to("meta"))
