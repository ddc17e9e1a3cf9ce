"""The port's decode path (``Llama.forward(..., cache=...)``) against the
reference's ``decode=True`` apply, on the same weights (f32, CPU).

A ragged [3, 16] prefill (every row at positions 0..15, as the serving
prefill runs it), then 4 single-token steps at per-row positions, one row
pinned past the end of the cache (an inactive serving slot: the reference
drops its writes, the port sends them to its scratch position).

torch and the port are imported inside the tests (see test_torch_llama.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.serving.continuous import cache_shapes

LOGITS_TOL = 2e-4
#: f32 K/V written by the two frameworks' projections: the same products
#: summed in another order
CACHE_TOL = 1e-5


def _port():
    import torch

    from kubeflow_tpu_torch.models import convert, llama

    torch.set_num_threads(1)
    return torch, llama, convert


@pytest.fixture(scope="module")
def weights():
    out = {}
    for quant in (False, True):
        cfg = ref.tiny(quant_kv=quant)
        params = ref.Llama(cfg).init(
            jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
        out[quant] = jax.tree.map(np.asarray, nn.meta.unbox(params))
    return out


def _ref_leaves(cache):
    attn = cache["layers"]["block"]["attn"]
    names = {"k": "cached_key", "v": "cached_value",
             "k_scale": "cached_key_scale", "v_scale": "cached_value_scale"}
    return {k: np.asarray(attn[v]) for k, v in names.items() if v in attn}


def _steps(seed, vocab, s_max):
    """(prefill tokens [3, 16], lengths, then 4 x (tokens [3, 1],
    positions [3, 1])): row 2 is inactive from the first step on, pinned at
    ``s_max``."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, vocab, size=(3, 16), dtype=np.int32)
    lengths = np.array([16, 5, 11], np.int32)
    steps = []
    for i in range(4):
        toks = rng.integers(0, vocab, size=(3, 1), dtype=np.int32)
        pos = (lengths + i)[:, None].astype(np.int32)
        pos[2] = s_max
        steps.append((toks, pos))
    return prompt, lengths, steps


@pytest.mark.parametrize("quant", [False, True],
                         ids=["kv_in_dtype", "kv_int8"])
@pytest.mark.parametrize("attend", [64, 128])
def test_decode_matches_reference(weights, quant, attend):
    torch, port, convert = _port()
    rcfg = ref.tiny(quant_kv=quant)
    params = weights[quant]
    rmodel = ref.Llama(rcfg, decode_attend_len=attend)
    rcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          cache_shapes(rcfg, 3))
    pcfg = port.tiny(quant_kv=quant)
    model = port.Llama(pcfg, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(params, pcfg))
    cache = port.KvCache.zeros(pcfg, 3, pcfg.max_seq_len, device="cpu")
    prompt, _, steps = _steps(1, rcfg.vocab_size, rcfg.max_seq_len)
    feeds = [(prompt, np.broadcast_to(np.arange(16, dtype=np.int32),
                                      (3, 16)))] + steps
    for i, (toks, pos) in enumerate(feeds):
        want, mut = rmodel.apply({"params": params, "cache": rcache}, toks,
                                 pos, decode=True, mutable=["cache"])
        rcache = mut["cache"]
        with torch.no_grad():
            got = model(torch.from_numpy(toks).long(),
                        torch.from_numpy(np.ascontiguousarray(pos)).long(),
                        cache=cache, attend=attend)
        want = np.asarray(want)
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel <= LOGITS_TOL, f"step {i}: logits rel err {rel}"
        for name, ref_leaf in _ref_leaves(rcache).items():
            leaf = getattr(cache, name)
            mine = (leaf[:, :, :128] if name in ("k", "v")
                    else leaf[..., :128]).numpy()
            if name in ("k", "v") and quant:
                diff = np.abs(mine.astype(np.int32)
                              - ref_leaf.astype(np.int32)).max()
                assert diff <= 1, f"step {i}: {name} codes differ by {diff}"
            elif quant:
                np.testing.assert_allclose(mine, ref_leaf, rtol=1e-6,
                                           atol=0, err_msg=f"step {i}")
            else:
                np.testing.assert_allclose(mine, ref_leaf, rtol=CACHE_TOL,
                                           atol=CACHE_TOL,
                                           err_msg=f"step {i}: {name}")


def test_inactive_row_writes_only_scratch():
    """A row pinned at max_seq_len leaves its cache row as it was, except
    the scratch position past the end."""
    torch, port, _ = _port()
    cfg = port.tiny()
    model = port.Llama(cfg, device="cpu")
    model.init_weights(0)
    cache = port.KvCache.zeros(cfg, 2, cfg.max_seq_len, device="cpu")
    before = cache.k.clone()
    toks = torch.tensor([[5], [7]])
    pos = torch.tensor([[3], [cfg.max_seq_len]])
    with torch.no_grad():
        model(toks, pos, cache=cache)
    assert torch.equal(cache.k[:, 1, :cfg.max_seq_len],
                       before[:, 1, :cfg.max_seq_len])
    assert cache.k[:, 1, cfg.max_seq_len].abs().sum() > 0
    assert cache.k[:, 0, 3].abs().sum() > 0


def test_cache_without_scratch_is_refused():
    torch, port, _ = _port()
    cfg = port.tiny()
    model = port.Llama(cfg, device="cpu")
    model.init_weights(0)
    cache = port.KvCache.zeros(cfg, 1, cfg.max_seq_len, device="cpu",
                               scratch=0)
    with pytest.raises(ValueError, match="scratch"), torch.no_grad():
        model(torch.tensor([[1]]), torch.tensor([[0]]), cache=cache)
