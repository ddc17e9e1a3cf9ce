"""Snapshots with bf16 parameters (``param_dtype: "bfloat16"``) between the
two packages:

- a tiny snapshot the reference's ``save_pretrained`` wrote from a
  ``param_dtype=jnp.bfloat16`` model loads into the port with its leaves
  in bf16, bit for bit the reference's, and the port's engine serves it
  (``resolve_model_source``, as a ``storage_path``) with the reference
  engine's greedy tokens; the port's logits on it are within
  ``LOGITS_TOL`` of the reference's;
- a bf16 model the port saves says ``bfloat16`` in its ``config.json``
  (the dtype its leaves have), and the reference's ``load_pretrained``
  reads it back with the same bits.

torch and the port are imported inside the tests.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.serving.continuous import ContinuousEngine as RefEngine

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9]]
NEW = 6
ENGINE = dict(num_slots=4, decode_chunk=2, eos_id=None, prefix_cache=False)
#: the parity tests' logits tolerance: both packages compute in f32 from
#: the same bf16 weights
LOGITS_TOL = 2e-4


def _port():
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import continuous

    torch.set_num_threads(1)
    return types.SimpleNamespace(torch=torch, llama=llama, convert=convert,
                                 continuous=continuous)


def _tokens() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (2, 12)).astype(
        np.int32)


def _bits(x) -> tuple[str, np.ndarray]:
    """(dtype name, bits) of a leaf: bf16 as int16, f32 as it is."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy()
        return str(x.dtype).removeprefix("torch."), x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return "bfloat16", x.view(np.int16)
    return x.dtype.name, x


def _leaves_equal(tree, sd, cfg, pt) -> set:
    """Every leaf of the reference ``tree`` bit for bit, and in the same
    dtype, the port state dict's; returns the dtypes seen."""
    want = dict(jax.tree_util.tree_leaves_with_path(
        pt.convert.tree_from_state_dict(sd, cfg)))
    got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert set(want) == set(got)
    seen = set()
    for path, w in want.items():
        (wd, wb), (gd, gb) = _bits(w), _bits(got[path])
        assert wd == gd, (path, wd, gd)
        np.testing.assert_array_equal(gb, wb, err_msg=str(path))
        seen.add(wd)
    return seen


@pytest.fixture(scope="module")
def ref_snapshot(tmp_path_factory):
    """A reference-written bf16 snapshot, its params, and the reference
    engine's greedy tokens of ``PROMPTS`` on them."""
    rcfg = ref.tiny(param_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, nn.meta.unbox(ref.Llama(rcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]))
    path = str(tmp_path_factory.mktemp("ref-bf16"))
    ref.save_pretrained(path, rcfg, params)
    eng = RefEngine(rcfg, params, **ENGINE)
    try:
        tokens = [eng.generate(p, max_new_tokens=NEW) for p in PROMPTS]
    finally:
        eng.stop()
    return path, rcfg, params, tokens


def test_reference_bf16_snapshot_loads_in_bf16(ref_snapshot):
    pt = _port()
    path, _, params, _ = ref_snapshot
    with open(f"{path}/config.json") as f:
        assert json.load(f)["param_dtype"] == "bfloat16"
    cfg, sd = pt.llama.load_pretrained(path)
    assert cfg.param_dtype == pt.torch.bfloat16
    # bf16 but for the norms' scales, which both packages keep in f32
    for k, v in sd.items():
        assert v.dtype == (pt.torch.float32 if k.endswith("norm.scale")
                           else pt.torch.bfloat16), k
    assert _leaves_equal(params, sd, cfg, pt) == {"bfloat16", "float32"}


def test_reference_bf16_snapshot_serves_with_reference_tokens(ref_snapshot):
    pt = _port()
    path, rcfg, params, want = ref_snapshot
    cfg, sd = pt.continuous.resolve_model_source({"storage_path": path})
    eng = pt.continuous.ContinuousEngine(cfg, sd, device="cpu", **ENGINE)
    try:
        # the engine's weights stay bf16 (the norms f32), cast once at load
        assert {k: p.dtype for k, p in eng.model.named_parameters()} == {
            k: v.dtype for k, v in sd.items()}
        got = [eng.generate(p, max_new_tokens=NEW) for p in PROMPTS]
    finally:
        eng.stop()
    assert got == want
    tokens = _tokens()
    ref_logits = np.asarray(ref.Llama(rcfg).apply({"params": params},
                                                  tokens))
    model = pt.llama.Llama(cfg, device="cpu")
    model.load_state_dict(sd)
    with pt.torch.no_grad():
        logits = model(pt.torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(logits, ref_logits, atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)


def test_port_bf16_snapshot_says_bfloat16_and_loads_in_reference(tmp_path):
    pt = _port()
    cfg = pt.llama.tiny()
    model = pt.llama.Llama(cfg, device="cpu")
    model.init_weights(0)
    model.to(pt.torch.bfloat16)   # the leaves bf16, the config f32
    sd = model.state_dict()
    path = str(tmp_path)
    pt.llama.save_pretrained(path, cfg, model)
    with open(f"{path}/config.json") as f:
        assert json.load(f)["param_dtype"] == "bfloat16"
    rcfg, rparams = ref.load_pretrained(path)
    assert jnp.dtype(rcfg.param_dtype) == jnp.bfloat16
    assert _leaves_equal(rparams, sd, cfg, pt) == {"bfloat16"}
    # the port reads its own bf16 snapshot back with the same values: its
    # norms' scales in f32, as a bf16 config keeps them
    got_cfg, got_sd = pt.llama.load_pretrained(path)
    assert got_cfg.param_dtype == pt.torch.bfloat16
    for k, v in sd.items():
        assert got_sd[k].dtype == pt.llama.leaf_dtype(k, got_cfg), k
        assert pt.torch.equal(got_sd[k].float(), v.float()), k
    tokens = _tokens()
    want = np.asarray(ref.Llama(rcfg).apply({"params": rparams}, tokens))
    with pt.torch.no_grad():
        logits = model(pt.torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(logits, want, atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
