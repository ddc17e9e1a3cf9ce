"""The 7B path of the port on the CPU, small: Llama-2 7B's configuration and
parameter count against the reference's, the model built with each
parameter in its own dtype from the start (no f32 copy of a bf16 model),
and a bf16 base with a published f32 adapter served with the reference
engine's greedy tokens.

torch and the port are imported inside the tests.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.serving import continuous as ref_continuous

#: Llama-2 7B's parameters (the published model's count)
LLAMA2_7B_PARAMS = 6_738_415_616
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9]]
NEW = 6
ENGINE = dict(num_slots=4, decode_chunk=2, eos_id=None, prefix_cache=False)


def _port():
    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import continuous

    torch.set_num_threads(1)
    return types.SimpleNamespace(torch=torch, llama=llama,
                                 continuous=continuous)


def test_llama2_7b_matches_reference():
    """The 7B as the card runs it (bf16 parameters, flash attention,
    remat "nothing"): the reference's fields, 6,738,415,616 parameters in
    both packages and the same FLOPs a token."""
    pt = _port()
    kw = dict(attention_impl="flash", remat_policy="nothing")
    got = pt.llama.llama2_7b(**kw, param_dtype=pt.torch.bfloat16)
    want = ref.llama2_7b(**kw, param_dtype=jnp.bfloat16)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, pt.torch.dtype):
            assert str(a).removeprefix("torch.") == jnp.dtype(b).name, f.name
        else:
            assert a == b, f.name
    assert (got.num_layers, got.hidden_size, got.num_heads,
            got.num_kv_heads, got.head_dim, got.intermediate_size,
            got.vocab_size) == (32, 4096, 32, 32, 128, 11008, 32000)
    assert pt.llama.num_params(got) == ref.num_params(want) == \
        LLAMA2_7B_PARAMS
    assert pt.llama.flops_per_token(got, 2048) == \
        ref.flops_per_token(want, 2048)
    meta = pt.llama.Llama(got, device="meta")
    assert sum(p.numel() for p in meta.parameters()) == LLAMA2_7B_PARAMS
    assert {p.dtype for p in meta.parameters()} == {
        pt.torch.bfloat16, pt.torch.float32}


def _cast_build(pt, cfg, seed):
    """The model as it was built before each parameter was allocated in
    its own dtype: every leaf f32, then cast to its ``leaf_dtype``, then
    ``init_weights``."""
    model = pt.llama.Llama(
        dataclasses.replace(cfg, param_dtype=pt.torch.float32), device="cpu")
    for key, p in model.named_parameters():
        if p.is_floating_point():
            p.data = p.data.to(pt.llama.leaf_dtype(key, cfg))
    model.init_weights(seed)
    return model.state_dict()


@pytest.mark.parametrize("param_dtype,kw", [
    ("float32", {}), ("float32", {"lora_rank": 4}),
    ("bfloat16", {}), ("bfloat16", {"lora_rank": 4}),
    ("bfloat16", {"lora_rank": 4, "moe_experts": 4, "moe_top_k": 2}),
], ids=["f32_dense", "f32_lora", "bf16_dense", "bf16_lora", "bf16_moe_lora"])
def test_lean_build_is_bit_equal_to_the_cast_build(param_dtype, kw):
    """Each parameter is allocated in its ``leaf_dtype`` (the norms, the
    router and the adapters f32), and ``init_weights`` draws the same bits
    as on the f32-then-cast model; ``init_streamed`` (the sharded
    trainer's init) hands over the same values."""
    pt = _port()
    cfg = pt.llama.tiny(param_dtype=getattr(pt.torch, param_dtype), **kw)
    model = pt.llama.Llama(cfg, device="cpu")
    for key, p in model.named_parameters():
        assert p.dtype == pt.llama.leaf_dtype(key, cfg), key
    model.init_weights(7)
    got = model.state_dict()
    want = _cast_build(pt, cfg, 7)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and pt.torch.equal(got[k], v), k
    streamed = {}
    pt.llama.Llama(cfg, device="meta").init_streamed(7, "cpu",
                                                     streamed.update)
    assert streamed.keys() == got.keys()
    for k, v in got.items():
        assert streamed[k].dtype == v.dtype and pt.torch.equal(
            streamed[k], v), k


def test_bf16_base_with_f32_adapter_serves_reference_tokens(tmp_path):
    """A reference-written bf16 base and its f32 adapter (B not zero),
    merged at load by each package's ``resolve_model_source``: the port's
    engine gives the reference engine's greedy tokens, from the same
    merged bf16 weights."""
    pt = _port()
    kw = dict(lora_rank=4, lora_targets=("wq", "wv", "w_down"))
    rcfg = ref.tiny(**kw, param_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, nn.meta.unbox(ref.Llama(rcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]))
    rng = np.random.default_rng(1)
    for mod in params["layers"]["block"].values():
        for leaf in mod.values():
            if isinstance(leaf, dict) and "lora_b" in leaf:
                leaf["lora_b"] = rng.normal(
                    0, 0.05, leaf["lora_b"].shape).astype(np.float32)
    base, _ = ref.split_lora(params)
    base_path, ada_path = str(tmp_path / "base"), str(tmp_path / "adapter")
    ref.save_pretrained(base_path, ref.tiny(param_dtype=jnp.bfloat16), base)
    ref.save_adapter(ada_path, rcfg, params)
    source = {"storage_path": base_path, "adapter_path": ada_path}

    _, adapters = pt.llama.load_adapter(ada_path)
    assert {v.dtype for v in adapters.values()} == {pt.torch.float32}
    rmcfg, rmerged = ref_continuous.resolve_model_source(source)
    eng = ref_continuous.ContinuousEngine(rmcfg, rmerged, **ENGINE)
    try:
        want = [eng.generate(p, max_new_tokens=NEW) for p in PROMPTS]
    finally:
        eng.stop()
    cfg, sd = pt.continuous.resolve_model_source(source)
    assert cfg.lora_rank == 0 and cfg.param_dtype == pt.torch.bfloat16
    assert pt.llama.param_dtype_of(sd) == pt.torch.bfloat16
    eng = pt.continuous.ContinuousEngine(cfg, sd, device="cpu", **ENGINE)
    try:
        got = [eng.generate(p, max_new_tokens=NEW) for p in PROMPTS]
    finally:
        eng.stop()
    assert got == want
