"""The port's snapshot I/O against the reference's (CPU, f32): its own
msgpack codec against flax's, ``save_pretrained``/``load_pretrained`` in
both directions, transformers safetensors snapshots, the state-dict <-> tree
bridge, the presets and ``quantize_for_serving``.

torch and the port are imported inside the tests (``_port``): imported at
collection they would sit in every test worker's heap and slow the other
files' tests.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn
from flax import serialization

from kubeflow_tpu.models import llama as ref

LOGITS_TOL = 2e-4


def _port():
    import torch

    from kubeflow_tpu_torch.models import _msgpack, convert, hf_checkpoint
    from kubeflow_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    return types.SimpleNamespace(torch=torch, llama=llama, convert=convert,
                                 msgpack=_msgpack, hf=hf_checkpoint)


def _init(rcfg, seed=0):
    params = ref.Llama(rcfg).init(jax.random.PRNGKey(seed),
                                  jnp.ones((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def _unroll(params, layers):
    block = params["layers"]["block"]
    out = {k: v for k, v in params.items() if k != "layers"}
    for i in range(layers):
        out[f"layer_{i}"] = jax.tree.map(lambda a, i=i: a[i], block)
    return out


def _tokens(b=2, s=24, vocab=256, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _port_logits(pt, cfg, sd, tokens):
    model = pt.llama.Llama(cfg, device="cpu")
    model.load_state_dict(sd)
    with pt.torch.no_grad():
        return model(pt.torch.from_numpy(tokens)).numpy()


@pytest.fixture
def small_chunks(monkeypatch):
    """Both codecs chunk every leaf over 1 KiB (the real limit, 1 GiB, is
    too large for a test)."""
    _, mp = None, _port().msgpack
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 1024)


# -- the codec -----------------------------------------------------------------


def _codec_tree(case):
    rng = np.random.default_rng(0)
    if case == "scalars":
        return {"i": 300, "neg": -70, "big": 1 << 40, "f": 1.5, "t": True,
                "n": None, "s": "x" * 40, "np": np.float32(2.5),
                "i64": np.int64(-3)}
    if case == "bf16":
        return {"w": np.asarray(jnp.asarray(rng.standard_normal((4, 5)),
                                            jnp.bfloat16))}
    return {"b": {"a": rng.standard_normal((3, 4)).astype(np.float32),
                  "q": np.arange(-5, 5, dtype=np.int8)},
            "e": np.zeros((0, 3), np.float32),
            "long": rng.standard_normal(5000).astype(np.float32)}


@pytest.mark.parametrize("case", ["arrays", "scalars", "bf16", "chunked"])
def test_msgpack_bytes_equal_flax(case, request):
    """The port writes flax's bytes exactly and reads them back."""
    pt = _port()
    if case == "chunked":
        request.getfixturevalue("small_chunks")
    tree = _codec_tree("arrays" if case == "chunked" else case)
    want = serialization.msgpack_serialize(tree)
    port_tree = tree
    if case == "bf16":  # the port holds bf16 as torch tensors
        port_tree = pt.msgpack.loads(want)
        assert port_tree["w"].dtype == pt.torch.bfloat16
    assert pt.msgpack.dumps(port_tree) == want
    back = pt.msgpack.loads(want)
    flat_want = jax.tree_util.tree_leaves_with_path(
        serialization.msgpack_restore(want))
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, g), (_, w) in zip(flat_got, flat_want):
        if isinstance(g, pt.torch.Tensor):
            g = g.float().numpy()
            w = np.asarray(w, np.float32)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_msgpack_stacked_leaf_streams_its_parts():
    pt = _port()
    parts = [pt.torch.randn(3, 4) for _ in range(5)]
    lazy = pt.msgpack.dumps({"w": pt.msgpack.Stacked(parts)})
    assert lazy == pt.msgpack.dumps({"w": pt.torch.stack(parts)})
    back = serialization.msgpack_restore(lazy)["w"]
    np.testing.assert_array_equal(back, pt.torch.stack(parts).numpy())


# -- snapshots across the packages ----------------------------------------------


@pytest.mark.parametrize("case", ["f32", "bf16_leaves", "chunked",
                                  "unrolled", "tied"])
def test_reference_snapshot_loads_in_port(tmp_path, case, request):
    pt = _port()
    if case == "chunked":
        request.getfixturevalue("small_chunks")
    kw = {"tie_embeddings": True} if case == "tied" else {}
    rcfg = ref.tiny(scan_layers=case != "unrolled", **kw)
    params = _init(ref.tiny(**kw))
    if case == "unrolled":
        params = _unroll(params, rcfg.num_layers)
    if case == "bf16_leaves":  # stored bf16, served in f32 on both sides
        params = jax.tree.map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    ref.save_pretrained(str(tmp_path), rcfg, params)
    if case == "chunked":
        raw = (tmp_path / "weights.msgpack").read_bytes()
        assert b"__msgpack_chunked_array__" in raw
    cfg, sd = pt.llama.load_pretrained(str(tmp_path))
    assert cfg == pt.llama.tiny(**kw)
    tokens = _tokens()
    _, rparams = ref.load_pretrained(str(tmp_path))
    want = np.asarray(ref.Llama(rcfg).apply({"params": rparams}, tokens))
    np.testing.assert_allclose(_port_logits(pt, cfg, sd, tokens), want,
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


@pytest.mark.parametrize("case", ["plain", "chunked", "lora", "int8"])
def test_port_snapshot_loads_in_reference(tmp_path, case, request):
    pt = _port()
    if case == "chunked":
        request.getfixturevalue("small_chunks")
    kw = {"lora_rank": 2} if case == "lora" else {}
    cfg = pt.llama.tiny(**kw)
    model = pt.llama.Llama(cfg, device="cpu")
    model.init_weights(1)
    sd = model.state_dict()
    if case == "int8":
        cfg, sd = pt.llama.quantize_for_serving(cfg, sd, kv=False)
    pt.llama.save_pretrained(str(tmp_path), cfg, sd)
    with open(tmp_path / "config.json") as f:
        keys = set(json.load(f))
    assert keys <= {f.name for f in dataclasses.fields(ref.LlamaConfig)}
    rcfg, rparams = ref.load_pretrained(str(tmp_path))
    assert rcfg.scan_layers and rcfg.quant_weights == (case == "int8")
    # flax's own restore gives arrays equal to the port's tensors
    want_tree = pt.convert.tree_from_state_dict(sd, cfg)
    jax.tree.map(np.testing.assert_array_equal, rparams, want_tree)
    tokens = _tokens()
    want = np.asarray(ref.Llama(rcfg).apply({"params": rparams}, tokens))
    np.testing.assert_allclose(_port_logits(pt, cfg, sd, tokens), want,
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    got_cfg, got_sd = pt.llama.load_pretrained(str(tmp_path))
    assert got_cfg == cfg
    for k, v in sd.items():
        assert pt.torch.equal(got_sd[k], v), k


@pytest.mark.parametrize("key,value,ok", [
    ("scan_layers", False, True), ("embed_one_hot", True, True),
    ("moe_ragged_compute", "masked", True),
    ("param_dtype", "bfloat16", True), ("moe_ragged_compute", "fast", False),
    ("param_dtype", "float16", False),
], ids=["scan_layers", "embed_one_hot", "ragged_compute", "param_dtype_bf16",
        "ragged_compute_unknown", "param_dtype_f16"])
def test_reference_only_config_keys(tmp_path, key, value, ok):
    pt = _port()
    d = pt.llama.config_to_dict(pt.llama.tiny())
    d[key] = value
    with open(tmp_path / "config.json", "w") as f:
        json.dump(d, f)
    if ok:
        # a bf16 snapshot's parameters stay bf16 (the port's param_dtype)
        want = (pt.llama.tiny(param_dtype=pt.torch.bfloat16)
                if key == "param_dtype" else pt.llama.tiny())
        assert pt.llama.load_pretrained_config(str(tmp_path)) == want
    else:
        with pytest.raises(ValueError, match=key):
            pt.llama.load_pretrained_config(str(tmp_path))


# -- transformers snapshots ------------------------------------------------------


def _write_hf(path, tie: bool, seed=0):
    """A tiny transformers-layout Llama snapshot written with the installed
    ``safetensors`` (random f32 weights; nothing downloaded)."""
    from safetensors.numpy import save_file

    E, M, H, KV, D, L, V = 64, 128, 4, 2, 16, 2, 256
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    t = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": 1 + w(E)}
    for i in range(L):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": 1 + w(E),
            p + "post_attention_layernorm.weight": 1 + w(E),
            p + "self_attn.q_proj.weight": w(H * D, E),
            p + "self_attn.k_proj.weight": w(KV * D, E),
            p + "self_attn.v_proj.weight": w(KV * D, E),
            p + "self_attn.o_proj.weight": w(E, H * D),
            p + "mlp.gate_proj.weight": w(M, E),
            p + "mlp.up_proj.weight": w(M, E),
            p + "mlp.down_proj.weight": w(E, M)})
    if not tie:
        t["lm_head.weight"] = w(V, E)
    os.makedirs(path, exist_ok=True)
    save_file(t, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": V, "hidden_size": E,
                   "intermediate_size": M, "num_hidden_layers": L,
                   "num_attention_heads": H, "num_key_value_heads": KV,
                   "max_position_embeddings": 128, "rms_norm_eps": 1e-5,
                   "rope_theta": 10000.0, "tie_word_embeddings": tie}, f)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_hf_snapshot_loads_alike_in_both_packages(tmp_path, tie):
    pt = _port()
    _write_hf(str(tmp_path), tie)
    assert pt.hf.is_hf_snapshot(str(tmp_path))
    rcfg, rparams = ref.load_pretrained(str(tmp_path))
    cfg, sd = pt.llama.load_pretrained(str(tmp_path))
    assert cfg.tie_embeddings == tie and cfg.num_kv_heads == 2
    assert cfg == pt.llama.load_pretrained_config(str(tmp_path))
    rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
    cfg = dataclasses.replace(cfg, dtype=pt.torch.float32)
    tokens = _tokens()
    want = np.asarray(ref.Llama(rcfg).apply({"params": rparams}, tokens))
    np.testing.assert_allclose(_port_logits(pt, cfg, sd, tokens), want,
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


# -- the state-dict <-> tree bridge ------------------------------------------------


@pytest.mark.parametrize("case", ["stacked", "unrolled", "lora", "int8",
                                  "moe"])
def test_tree_round_trip(case):
    pt = _port()
    kw = {"lora": dict(lora_rank=2, lora_targets=("wq", "wo", "w_up")),
          "moe": dict(moe_experts=4)}.get(case, {})
    rcfg = ref.tiny(**kw)
    params = _init(rcfg)
    cfg = pt.llama.tiny(**kw)
    if case == "int8":
        rcfg, params = ref.quantize_for_serving(rcfg, params, kv=False)
        cfg = dataclasses.replace(cfg, quant_weights=True)
    stacked = case != "unrolled"
    if not stacked:
        params = _unroll(params, cfg.num_layers)
    sd = pt.convert.state_dict_from_jax(params, cfg)
    assert sd.keys() == pt.llama.Llama(cfg, device="cpu").state_dict().keys()
    back = pt.convert.tree_from_state_dict(sd, cfg, stacked=stacked)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_presets_match_reference():
    pt = _port()
    assert list(pt.llama.PRESETS) == list(ref.PRESETS)
    names = list(ref.PRESETS) + ["llama_1b"]
    for name in names:
        want = (ref.llama_1b() if name == "llama_1b"
                else ref.PRESETS[name]())
        got = (pt.llama.llama_1b() if name == "llama_1b"
               else pt.llama.PRESETS[name]())
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(a, pt.torch.dtype):
                assert str(a).removeprefix("torch.") == jnp.dtype(b).name
            else:
                assert a == b, (name, f.name)
    assert pt.llama.num_params(pt.llama.llama_1b()) == 1_193_629_696
    assert ref.num_params(ref.llama_1b()) == 1_193_629_696


# -- serving quantization ------------------------------------------------------


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_quantize_codes_equal_the_reference(tie):
    pt = _port()
    rcfg = ref.tiny(tie_embeddings=tie)
    params = _init(rcfg)
    rqcfg, rq = ref.quantize_for_serving(rcfg, params)
    cfg = pt.llama.tiny(tie_embeddings=tie)
    qcfg, qsd = pt.llama.quantize_for_serving(
        cfg, pt.convert.state_dict_from_jax(params, cfg))
    assert qcfg.quant_weights and qcfg.quant_kv
    want = pt.convert.state_dict_from_jax(rq, qcfg)
    assert qsd.keys() == want.keys()
    for k, v in want.items():
        if v.dtype == pt.torch.int8:
            assert pt.torch.equal(qsd[k], v), k
        else:
            np.testing.assert_allclose(qsd[k].numpy(), v.numpy(), rtol=1e-7,
                                       atol=0, err_msg=k)
    assert ("head.unembedding_scale" in qsd) == (not tie)
    tokens = _tokens()
    rlogits = np.asarray(ref.Llama(rqcfg).apply({"params": rq}, tokens))
    np.testing.assert_allclose(_port_logits(pt, qcfg, qsd, tokens), rlogits,
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_quantize_refuses_moe_weights():
    pt = _port()
    cfg = pt.llama.tiny(moe_experts=4)
    sd = pt.llama.Llama(cfg, device="cpu").state_dict()
    with pytest.raises(ValueError, match="MoE"):
        pt.llama.quantize_for_serving(cfg, sd)
    qcfg, same = pt.llama.quantize_for_serving(cfg, sd, weights=False)
    assert qcfg.quant_kv and not qcfg.quant_weights and same is sd
