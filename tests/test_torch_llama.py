"""The port's Llama against the reference on the same weights (f32, CPU).

torch and the port are imported inside the tests: imported at collection they
would sit in every test worker's heap and slow the other files' tests.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from __graft_entry__ import _bench_model
from kubeflow_tpu.models import llama as ref

LOGITS_TOL = 2e-4


def _port():
    """(torch, the port's llama module, its convert module), with torch set
    up for exact f32 on the CPU: no TF32, one intra-op thread (tiny shapes;
    leaves the cores to the other test workers)."""
    import torch

    from kubeflow_tpu_torch.models import convert, llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    return torch, llama, convert


@pytest.fixture(scope="module")
def ref_params():
    """One reference init of tiny(), in the layouts the tests need: the scan
    layout as initialised, the unrolled one by unstacking its layer axis, and
    the tied one without the unembedding (attention_impl adds no params)."""
    params = ref.Llama(ref.tiny()).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    scan = jax.tree.map(np.asarray, nn.meta.unbox(params))
    block = scan["layers"]["block"]
    unrolled = {k: v for k, v in scan.items() if k != "layers"}
    for i in range(ref.tiny().num_layers):
        unrolled[f"layer_{i}"] = jax.tree.map(lambda a, i=i: a[i], block)

    def tied(p):
        return {**p, "head": {"final_norm": p["head"]["final_norm"]}}

    return {(True, False): scan, (False, False): unrolled,
            (True, True): tied(scan), (False, True): tied(unrolled)}


def _tokens(seed, b, s, vocab):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s), dtype=np.int32)
    tokens[0, 3], tokens[1, 5] = vocab + 7, -2  # out of range: both clamp
    return tokens


@pytest.mark.parametrize("scan,tie,impl", [
    (True, False, "dense"),
    (False, False, "dense"),
    (True, True, "dense"),
    (True, False, "flash"),
    (False, True, "flash"),
], ids=["scan", "unrolled", "scan_tied", "scan_flash", "unrolled_tied_flash"])
def test_logits_match_reference(ref_params, scan, tie, impl):
    torch, port, convert = _port()
    kw = dict(tie_embeddings=tie, attention_impl=impl)
    rcfg = ref.tiny(scan_layers=scan, **kw)
    params = ref_params[scan, tie]
    model = port.Llama(port.tiny(**kw), device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(params, model.cfg))
    tokens = _tokens(1, 2, 24, rcfg.vocab_size)
    want = np.asarray(ref.Llama(rcfg).apply({"params": params}, tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL)


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "unrolled"])
def test_convert_covers_every_param(ref_params, scan):
    _, port, convert = _port()
    cfg = port.tiny()
    sd = convert.state_dict_from_jax(ref_params[scan, False], cfg)
    want = port.Llama(cfg, device="cpu").state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].shape == want[k].shape for k in sd)
    stacked = ref_params[True, False]["layers"]["block"]["attn"]["wq"]
    np.testing.assert_array_equal(
        sd["layers.1.attn.wq"].numpy(), stacked["kernel"][1])


@pytest.mark.parametrize("name,kw", [
    ("tiny", {}), ("tiny_tied", {"tie_embeddings": True}),
    ("bench", None)])
def test_param_and_flop_counts_match_reference(name, kw):
    _, port, _ = _port()
    if kw is None:
        rcfg, pcfg = _bench_model(), port.bench_model()
    else:
        rcfg, pcfg = ref.tiny(**kw), port.tiny(**kw)
    assert port.num_params(pcfg) == ref.num_params(rcfg)
    assert port.flops_per_token(pcfg, 1024) == ref.flops_per_token(rcfg, 1024)
    if name == "tiny":
        model = port.Llama(pcfg, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == \
            port.num_params(pcfg)


def test_moe_param_and_flop_counts():
    """num_params counts every expert and the router; flops_per_token counts
    the active ones (top-k experts + router). The reference's num_params
    counts one expert MLP and no router, so only the dense trunk agrees."""
    _, port, _ = _port()
    cfg = port.bench_moe_model()
    assert port.num_params(cfg) == 1_240_105_984
    assert port.active_params(cfg) == 409_633_792
    assert port.flops_per_token(cfg, 1024) == 6 * 409_633_792 + 6 * 16 * 8 \
        * 128 * 1024
    rcfg = dataclasses.replace(_bench_model(), moe_experts=8, moe_top_k=2,
                               moe_dispatch="ragged")
    assert ref.num_params(rcfg) == 271_090_688
    tiny = port.tiny(moe_experts=4)
    model = port.Llama(tiny, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        port.num_params(tiny)
    dense = port.tiny()
    assert port.active_params(dense) == port.num_params(dense)


def test_bench_model_matches_graft_entry():
    torch, port, _ = _port()
    want, got = _bench_model(), port.bench_model()
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.dtype):
            assert str(a).removeprefix("torch.") == jnp.dtype(b).name, f.name
        else:
            assert a == b, f.name
    assert port.num_params(got) == 271_090_688


def test_config_validation():
    _, port, _ = _port()
    with pytest.raises(ValueError):
        port.tiny(num_kv_heads=3)
    with pytest.raises(ValueError):
        port.tiny(attention_impl="ring")
    with pytest.raises(ValueError):
        port.tiny(remat_policy="everything")
    with pytest.raises(ValueError):
        port.tiny(moe_experts=4, moe_dispatch="scatter")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import chip_smoke, kernel_ab\n"
        "import kubeflow_tpu_torch, kubeflow_tpu_torch.device\n"
        "import kubeflow_tpu_torch.models.llama, "
        "kubeflow_tpu_torch.models.convert, kubeflow_tpu_torch.models.moe\n"
        "import kubeflow_tpu_torch.ops.flash_attention, "
        "kubeflow_tpu_torch.ops.grouped_matmul, "
        "kubeflow_tpu_torch.ops._build\n"
        "import kubeflow_tpu_torch.train.data, kubeflow_tpu_torch.train.optim,"
        " kubeflow_tpu_torch.train.trainer, kubeflow_tpu_torch.train.profile\n"
        "import kubeflow_tpu_torch.serving, "
        "kubeflow_tpu_torch.serving.continuous, "
        "kubeflow_tpu_torch.serving.paged, "
        "kubeflow_tpu_torch.serving.profile, "
        "kubeflow_tpu_torch.analysis.runtime\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax') or m.startswith('kubeflow_tpu.')"
        " or m == 'kubeflow_tpu']\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
