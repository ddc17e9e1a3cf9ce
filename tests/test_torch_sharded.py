"""The port's tensor-parallel engine (``kubeflow_tpu_torch/serving/
sharded.py``) on two gloo ranks on the CPU, held against the reference's
``mesh_axes`` engine (one process over two of the eight virtual CPU
devices, as ``tests/test_serving_sharded.py`` runs it) and against the
port's unsharded engine on the same weights.

One spawn (``parallel.dryrun.spawn``) runs every case on two ranks
(``tests/_torch_gang_worker.py``): rank 0 serves through a ``GangEngine``,
rank 1 follows. The tests compare, at ``{"model": 2}``:

- the greedy tokens of the slot pool, the paged pool, the int8-KV slot
  pool (which scatters the scales over the rank's own heads) and the
  int8-weight slot pool (the reference's ``quantize_for_serving`` weights:
  each rank's kernels and scales its slices, a row-parallel product
  scaled before its all-reduce) against the reference's ``mesh_axes``
  engine and the port's unsharded engine;
- every program output of the follower, bitwise, against rank 0's;
- each rank's pool: ``num_kv_heads / 2`` heads, half the unsharded pool's
  bytes; programs run eagerly (gloo), no capture after warmup;
- the f32 logits of a forward pass through the sharded model against the
  unsharded port model and the reference (atol 1e-5);
- ``LlamaGenerator`` with ``mesh_axes`` inside the group against the
  unsharded one;
- an unsharded ``Llama`` handed to an engine with ``mesh_axes``: laid out
  over the group, as a state dict is.

torch and the port are imported inside the tests.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref_llama
from kubeflow_tpu.serving.continuous import ContinuousEngine as RefEngine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gang_worker as worker  # noqa: E402

NEW = 8
WARM = [(1, 32), (2, 32)]
BASE = {"num_slots": 2, "decode_chunk": 4, "prefix_cache": False}
#: name -> (model config kwargs, engine kwargs)
CASES = {
    "slot_pool": ({}, BASE),
    "paged": ({}, {**BASE, "block_size": 8}),
    "int8_kv": ({"quant_kv": True}, BASE),
    "int8_weights": ({"quant_weights": True}, BASE),
}
#: the variants the reference's mesh engine also serves here
REFERENCE = ("slot_pool", "int8_kv", "int8_weights")
SPAWN_TIMEOUT_S = 240


def _port():
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import continuous

    torch.set_num_threads(1)
    return torch, llama, convert, continuous


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, size=n).tolist() for n in (3, 17, 30, 9)]


@pytest.fixture(scope="module")
def weights():
    """(reference cfg, its numpy params, the port's state dict), and as
    the reference's ``quantize_for_serving`` makes them int8 (the
    ``"int8"`` entry: the same three)."""
    _, llama, convert, _ = _port()
    cfg = ref_llama.tiny()
    params = ref_llama.Llama(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    qcfg, qparams = ref_llama.quantize_for_serving(cfg, params, kv=False)
    qparams = jax.tree.map(np.asarray, qparams)
    return {"plain": (cfg, params,
                      convert.state_dict_from_jax(params, llama.tiny())),
            "int8": (qcfg, qparams, convert.state_dict_from_jax(
                qparams, llama.tiny(quant_weights=True)))}


def _weights_of(weights, cfg_kw):
    return weights["int8" if cfg_kw.get("quant_weights") else "plain"]


@pytest.fixture(scope="module")
def ranks(weights):
    """Every case's results on both ranks."""
    from kubeflow_tpu_torch.parallel import dryrun
    from kubeflow_tpu_torch.utils.net import free_port

    ports = [free_port() for _ in CASES]
    case_sds = {name: _weights_of(weights, cfg_kw)[2]
                for name, (cfg_kw, _) in CASES.items()
                if cfg_kw.get("quant_weights")}
    return dryrun.spawn(2, worker.run_sharded, ports, CASES,
                        weights["plain"][2], _prompts(), NEW, WARM,
                        case_sds, timeout=SPAWN_TIMEOUT_S)


def _unsharded(weights, cfg_kw, kw):
    _, llama, _, continuous = _port()
    eng = continuous.ContinuousEngine(llama.tiny(**cfg_kw),
                                      _weights_of(weights, cfg_kw)[2],
                                      device="cpu", **kw)
    return worker._serve(eng, _prompts(), NEW, WARM)


def _reference(weights, cfg_kw, kw, mesh_axes=None):
    import dataclasses

    base, params, _ = _weights_of(weights, cfg_kw)
    cfg = dataclasses.replace(base, **cfg_kw)
    eng = RefEngine(cfg, params, mesh_axes=mesh_axes, **kw)
    try:
        eng.warmup(WARM)
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in _prompts()]
        return [r.wait(worker.WAIT_S) for r in reqs]
    finally:
        eng.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_tp_greedy_tokens_match_reference_and_unsharded(weights, ranks,
                                                        case):
    cfg_kw, kw = CASES[case]
    got = ranks[0][case]["tokens"]
    assert got == _unsharded(weights, cfg_kw, kw)["tokens"]
    if case in REFERENCE:
        assert got == _reference(weights, cfg_kw, kw, {"model": 2})
    assert all(len(t) == NEW for t in got)


@pytest.mark.parametrize("case", list(CASES))
def test_follower_outputs_bitwise_equal_rank0(ranks, case):
    import torch

    lead, follow = ranks[0][case]["outs"], ranks[1][case]["outs"]
    assert lead and len(lead) == len(follow)
    for (k0, t0), (k1, t1) in zip(lead, follow):
        assert k0 == k1
        assert torch.equal(t0, t1)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_pool_holds_half_the_kv_heads(weights, ranks, case):
    from kubeflow_tpu_torch.serving.sharded import kv_heads_axis

    assert kv_heads_axis({"model": 2}) == "model"
    cfg_kw, kw = CASES[case]
    whole = _unsharded(weights, cfg_kw, kw)
    for r in ranks:
        assert r[case]["pool_heads"] == weights["plain"][0].num_kv_heads // 2
        assert 2 * r[case]["kv_pool_bytes"] == whole["kv_pool_bytes"]
    lead = ranks[0][case]
    assert (lead["backend"], lead["graphs"]) == ("gloo", False)
    st = lead["stats"]
    assert st["tp_degree"] == 2 and st["cuda_graphs"] == 0
    assert st["graph_captures_total"] == 0
    assert st["tokens_emitted"] == 4 * NEW


def test_tp_logits_match_unsharded_and_reference(weights, ranks):
    torch, llama, _, _ = _port()
    tokens = [_prompts()[2]]
    model = llama.Llama(llama.tiny(), device="cpu")
    cfg, params, sd = weights["plain"]
    model.load_state_dict(sd)
    with torch.no_grad():
        whole = model(torch.tensor(tokens)).float().numpy()
    ref = np.asarray(ref_llama.Llama(cfg).apply(
        {"params": params}, jnp.asarray(tokens)), np.float32)
    for r in ranks:
        np.testing.assert_allclose(r["logits"], whole, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["logits"], ref, rtol=0, atol=1e-5)


def test_llama_generator_with_mesh_axes_matches_unsharded(weights, ranks):
    from kubeflow_tpu_torch.serving.runtimes import LlamaGenerator
    from kubeflow_tpu_torch.serving.storage import register_mem

    _, llama, _, _ = _port()
    ref = register_mem("sharded-generator", (llama.tiny(),
                                             weights["plain"][2]))
    gen = LlamaGenerator("g", {"params_ref": ref, "device": "cpu",
                               "max_new_tokens": NEW})
    gen.start()
    want = gen.predict_batch(_prompts())
    assert ranks[0]["generator"] == want == ranks[1]["generator"]


def test_mesh_axes_without_a_gang_raises_value_error(weights):
    _, llama, _, continuous = _port()
    with pytest.raises(ValueError, match="needs a gang of 2 ranks"):
        continuous.ContinuousEngine(llama.tiny(), weights["plain"][2],
                                    device="cpu", mesh_axes={"model": 2})
    with pytest.raises(NotImplementedError, match="only 'model'"):
        continuous.ContinuousEngine(llama.tiny(), weights["plain"][2],
                                    device="cpu", mesh_axes={"data": 2})


def test_engine_lays_out_an_unsharded_module(ranks):
    for r in ranks:
        assert r["module_engine"] == {"tp_degree": 2, "kv_heads": 1,
                                      "laid_out": True}
