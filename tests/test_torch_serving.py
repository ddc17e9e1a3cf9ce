"""The port's ``ContinuousEngine(device="cpu")`` against the reference
``ContinuousEngine`` on the same weights and prompts (f32, greedy).

Four prompts of 3 to 40 tokens, 8 new tokens each, ``num_slots=2`` so slots
are reused, in the slot pool (whole-prompt and chunked admission), the paged
pool, and the slot pool serving the tiny MoE model (ragged dispatch, on the
grouped GEMM's plain version here). Every engine warms the admission shapes
these prompts use, so no program is captured (first used, on the CPU) after
warmup. Each reference engine runs once per module. The prompts are submitted
in a fixed order; greedy tokens do not depend on how the scheduler happens to
group them. Every wait has its own time limit.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.serving.continuous import ContinuousEngine as RefEngine

WAIT_S = 120
NEW = 8
#: group sizes 1 and 2 at the buckets the prompts fall in (32 and 64)
WARM = [(1, 32), (2, 32), (1, 64), (2, 64)]
VARIANTS = {
    "slot_pool": {},
    "chunked": {"prefill_budget": 16},
    "paged": {"block_size": 8},
}
MOE = dict(moe_experts=4, moe_top_k=2, moe_dispatch="ragged")


def _port():
    import torch

    from kubeflow_tpu_torch.analysis import runtime
    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import continuous

    torch.set_num_threads(1)
    return torch, llama, convert, continuous, runtime


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, size=n).tolist() for n in (3, 17, 40, 9)]


def _serve(engine, prompts=None):
    try:
        engine.warmup(WARM)
        reqs = [engine.submit(p, max_new_tokens=NEW)
                for p in prompts or _prompts()]
        tokens = [r.wait(WAIT_S) for r in reqs]
        return tokens, engine.stats()
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def models():
    """{moe?: (reference cfg, its params as numpy)}."""
    out = {}
    for moe in (False, True):
        cfg = ref.tiny(**(MOE if moe else {}))
        params = ref.Llama(cfg).init(
            jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
        out[moe] = cfg, jax.tree.map(np.asarray, nn.meta.unbox(params))
    return out


@pytest.fixture(scope="module")
def reference_tokens(models):
    """The reference engine's greedy tokens for each variant (and MoE)."""
    out = {}
    for name, kw in [*VARIANTS.items(), ("moe", {})]:
        cfg, params = models[name == "moe"]
        eng = RefEngine(cfg, params, num_slots=2, decode_chunk=4,
                        prefix_cache=False, **kw)
        out[name] = _serve(eng)[0]
    return out


def _port_engine(models, moe=False, **kw):
    _, llama, convert, continuous, _ = _port()
    _, params = models[moe]
    cfg = llama.tiny(**(MOE if moe else {}))
    # the reference engines above run with the prefix cache off
    return continuous.ContinuousEngine(
        cfg, convert.state_dict_from_jax(params, cfg), num_slots=2,
        decode_chunk=4, device="cpu", **{"prefix_cache": False, **kw})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_tokens_match_reference(models, reference_tokens, variant):
    tokens, stats = _serve(_port_engine(models, **VARIANTS[variant]))
    assert tokens == reference_tokens[variant]
    assert all(len(t) == NEW for t in tokens)
    assert stats["graph_captures_total"] == 0
    assert stats["graph_captures_warmup"] > 0
    assert stats["tokens_emitted"] == 4 * NEW


def test_moe_greedy_tokens_match_reference(models, reference_tokens):
    tokens, stats = _serve(_port_engine(models, moe=True))
    assert tokens == reference_tokens["moe"]
    assert stats["graph_captures_total"] == 0


def test_variants_agree_inside_the_port(models):
    """Whole-prompt, chunked and paged admission (and paged with chunked
    admission) give the same greedy tokens."""
    streams = {name: _serve(_port_engine(models, **kw))[0]
               for name, kw in {**VARIANTS, "paged_chunked": {
                   "block_size": 8, "prefill_budget": 16}}.items()}
    first = streams.pop("slot_pool")
    for name, tokens in streams.items():
        assert tokens == first, name


def test_paged_ledger_reports_no_leaks(models):
    _, _, _, _, runtime = _port()
    ledger = runtime.BlockLedger()
    eng = _port_engine(models, block_size=8, num_blocks=12)
    eng.attach_block_ledger(ledger)
    # 12 blocks of 8 hold at most two of these spans at once: admissions
    # wait for blocks, and every retirement must give them back
    tokens, stats = _serve(eng)
    assert all(len(t) == NEW for t in tokens)
    assert eng.audit_blocks() == []
    assert ledger.leaked_total == 0 and stats["kv_blocks_leaked_total"] == 0
    assert ledger.conservation_errors == []
    assert eng.stats()["kv_blocks_free"] == 12


def test_post_warmup_capture_is_counted(models):
    """A prompt bucket warmup did not cover is first used while serving:
    the gauge counts it."""
    eng = _port_engine(models)
    try:
        eng.warmup([(1, 32)])
        eng.submit(list(range(1, 50)), max_new_tokens=2).wait(WAIT_S)
        assert eng.stats()["graph_captures_total"] == 1
    finally:
        eng.stop()


def test_sampled_requests_run(models):
    """Temperature, top-k and top-p requests ride the pool beside greedy
    ones (the filtered program variant)."""
    eng = _port_engine(models)
    try:
        eng.warmup(WARM)
        greedy = eng.submit(_prompts()[0], max_new_tokens=NEW)
        hot = eng.submit(_prompts()[1], max_new_tokens=NEW, temperature=0.9,
                         top_k=20, top_p=0.8)
        assert len(hot.wait(WAIT_S)) == NEW
        assert len(greedy.wait(WAIT_S)) == NEW
        assert eng.stats()["graph_captures_total"] == 0
    finally:
        eng.stop()


def test_eos_stops_a_request(models, reference_tokens):
    eos = reference_tokens["slot_pool"][1][2]
    eng = _port_engine(models, eos_id=eos)
    tokens, _ = _serve(eng)
    assert tokens[1] == reference_tokens["slot_pool"][1][:3]


@pytest.mark.parametrize("knob,value,item", [
    ("mesh_axes", {"model": 2}, "A7"),
    ("program_cache", object(), "A12"),
], ids=["mesh_axes-value4-A7", "program_cache-value5-A12"])
def test_unported_knobs_raise(models, knob, value, item):
    with pytest.raises(NotImplementedError, match=item):
        _port_engine(models, **{knob: value})


@pytest.mark.parametrize("knobs,match", [
    ({"host_blocks": 4}, "paged pool"),
    ({"role": "prefill"}, "paged pool"),
], ids=["host_blocks_without_blocks", "prefill_role_on_the_slot_pool"])
def test_paged_only_knobs_refuse_the_slot_pool(models, knobs, match):
    """The host tier and the roles move blocks: as in the reference, the
    slot pool (block_size 0) refuses them."""
    with pytest.raises(ValueError, match=match):
        _port_engine(models, **knobs)


@pytest.mark.parametrize("config,item", [
    ({"aot": {"root": "x"}}, "A12"), ({"quant_weights": True}, "A11"),
    ({"block_size": 8, "disaggregation": {"prefill": 1, "decode": 1,
                                          "wire": True}}, "A7")],
    ids=["aot-A12", "quant_weights-A11", "disaggregation_wire-A7"])
def test_build_engine_refuses_unported_config(models, config, item):
    _, llama, convert, continuous, _ = _port()
    cfg = llama.tiny()
    with pytest.raises(NotImplementedError, match=item):
        continuous.build_engine(
            cfg, convert.state_dict_from_jax(models[False][1], cfg),
            config, device="cpu")


def test_build_engine_serves_int8_kv(models):
    _, llama, convert, continuous, _ = _port()
    cfg = llama.tiny()
    eng = continuous.build_engine(
        cfg, convert.state_dict_from_jax(models[False][1], cfg),
        {"num_slots": 2, "quant_kv": True, "warmup_groups": WARM},
        device="cpu")
    try:
        assert eng.cfg.quant_kv and eng.decode_chunk == 4
        assert len(eng.generate(_prompts()[2], 4, timeout=WAIT_S)) == 4
        assert eng.stats()["graph_captures_total"] == 0
    finally:
        eng.stop()


def test_stop_joins_the_scheduler_thread(models):
    eng = _port_engine(models)
    eng.warmup(WARM)
    eng.submit(_prompts()[0], max_new_tokens=2).wait(WAIT_S)
    thread = eng._thread
    assert thread.is_alive()
    eng.stop()
    thread.join(WAIT_S)
    assert not thread.is_alive()
    assert not any(t.name == "continuous-engine" and t is thread
                   for t in threading.enumerate())
    with pytest.raises(RuntimeError, match="shutting down"):
        eng.submit([1, 2, 3])


def test_default_device_is_the_card(models, monkeypatch):
    torch, llama, convert, continuous, _ = _port()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        continuous.ContinuousEngine(
            cfg, convert.state_dict_from_jax(models[False][1], cfg))
