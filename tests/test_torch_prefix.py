"""Prefix reuse in the port's serving engine (``kubeflow_tpu_torch/
serving/continuous.py``) against the reference's, f32 ``tiny()`` weights
carried across with ``convert.state_dict_from_jax``:

- the prefix-admit program (row copy + suffix prefill) and the COW block
  copy, on the same pool, within 1e-5 (int8 codes within 1);
- the slot pool with the prefix cache on: a repeated prompt and a
  conversation that continues give the reference's greedy tokens,
  ``prefix_hits`` and ``prefix_tokens_saved``;
- the paged pool: a COW fork against a live sequence, the resurrection of
  a retired sequence's blocks and a resend give the reference's tokens,
  ``prefix_block_hits_total`` and ``kv_blocks_cow_copies_total``, with a
  ``BlockLedger`` that counts no leak;
- shared-prefix segments: a same-prefix burst gives the reference's tokens
  (and the full-length slots' tokens) and segment counters, with KV in the
  activation dtype and in int8;
- speculative decoding composes with the prefix cache.

Every engine warms the shapes its prompts use: no capture after warmup.
Each reference engine runs once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.serving import continuous as refc

WAIT_S = 300
TOL = 1e-5
RNG = np.random.default_rng(0)
BASE = RNG.integers(1, 256, size=45).tolist()
SYSTEM = RNG.integers(1, 256, size=48).tolist()
BURST = [SYSTEM + RNG.integers(1, 256, size=5).tolist() for _ in range(4)]
WARM = [(1, 32), (1, 64)]
SLOT = dict(num_slots=2, decode_chunk=2, min_prefix=8)
PAGED = dict(SLOT, block_size=8)
SEGMENTS = dict(num_slots=4, decode_chunk=2, prefix_cache=False,
                prefix_segments=2, segment_len=64, min_prefix=16)
PREFIX_COUNTERS = ("prefix_hits", "prefix_tokens_saved",
                   "prefix_block_hits_total", "kv_blocks_cow_copies_total")
SEGMENT_COUNTERS = ("segment_hits", "segment_tokens_shared",
                    "segment_evictions", "segments_live")


def _port():
    import torch

    from kubeflow_tpu_torch.analysis import runtime
    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import continuous

    torch.set_num_threads(1)
    return torch, llama, convert, continuous, runtime


@pytest.fixture(scope="module")
def weights():
    """{quant_kv: the reference's params as numpy} (the same init)."""
    out = {}
    for quant in (False, True):
        cfg = ref.tiny(quant_kv=quant)
        params = ref.Llama(cfg).init(
            jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
        out[quant] = jax.tree.map(np.asarray, nn.meta.unbox(params))
    return out


# -- the programs -------------------------------------------------------------


def _prefilled(cfg, params, slots, attend):
    """A reference pool of ``slots`` rows after a 16-token prefill, and its
    per-slot last logits."""
    rmodel = ref.Llama(cfg, decode_attend_len=attend)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, size=(slots, 16),
                          dtype=np.int32)
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         refc.cache_shapes(cfg, slots))
    lg, mut = rmodel.apply(
        {"params": params, "cache": cache}, prompt,
        np.broadcast_to(np.arange(16, dtype=np.int32), (slots, 16)),
        decode=True, mutable=["cache"])
    return mut["cache"], np.array(lg[:, -1])


_LEAVES = {"k": "cached_key", "v": "cached_value",
           "k_scale": "cached_key_scale", "v_scale": "cached_value_scale"}


def _axes(tree):
    """The reference's per-leaf (row axis, position axis) trees of a scan
    layout cache."""
    def row(path, c):
        return None if path[-1].key == "cache_index" else 1

    def seq(path, c):
        if path[-1].key == "cache_index":
            return None
        return 3 if path[-1].key.endswith("scale") else 2
    return (jax.tree_util.tree_map_with_path(row, tree),
            jax.tree_util.tree_map_with_path(seq, tree))


def _to_port(torch, llama, pcfg, tree, rows, seq):
    """The reference pool ``tree`` as a port ``KvCache`` with a scratch
    row and a scratch position."""
    cache = llama.KvCache.zeros(pcfg, rows + 1, seq, device="cpu")
    attn = tree["layers"]["block"]["attn"]
    for name, leaf in cache.leaves().items():
        src = torch.from_numpy(np.array(attn[_LEAVES[name]]))
        if name in ("k", "v"):
            leaf[:, :rows, :seq] = src
        else:
            leaf[:, :rows, :, :seq] = src
    return cache


def _assert_cache_close(cache, tree, rows, seq):
    attn = tree["layers"]["block"]["attn"]
    for name, leaf in cache.leaves().items():
        mine = (leaf[:, :rows, :seq] if name in ("k", "v")
                else leaf[:, :rows, :, :seq]).numpy()
        theirs = np.asarray(attn[_LEAVES[name]])
        if mine.dtype == np.int8:
            assert np.abs(mine.astype(np.int32)
                          - theirs.astype(np.int32)).max() <= 1, name
        else:
            np.testing.assert_allclose(mine, theirs, rtol=TOL, atol=TOL,
                                       err_msg=name)


@pytest.mark.parametrize("quant", [False, True],
                         ids=["kv_in_dtype", "kv_int8"])
def test_prefix_admit_program_matches_reference(weights, quant):
    """Slot 2 takes slot 0's first 11 positions and prefills a 5-token
    suffix after them."""
    torch, llama, convert, continuous, _ = _port()
    cfg, params = ref.tiny(quant_kv=quant), weights[quant]
    slots, attend, bucket = 3, 64, 16
    tree, logits = _prefilled(cfg, params, slots, attend)
    suffix = np.zeros(bucket, np.int32)
    suffix[:5] = [9, 8, 7, 6, 5]
    baxes, saxes = _axes(tree)
    admit = refc.make_prefix_admit_program(cfg, attend, bucket, baxes,
                                           seq_axes=saxes)
    want_tree, want_logits = jax.tree.map(np.asarray, admit(
        params, jax.tree.map(jnp.array, tree), jnp.asarray(logits),
        np.int32(0), np.int32(2), np.int32(11), suffix, np.int32(5)))

    pcfg = llama.tiny(quant_kv=quant)
    model = llama.Llama(pcfg, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(params, pcfg))
    cache = _to_port(torch, llama, pcfg, tree, slots, pcfg.max_seq_len)
    plogits = torch.zeros(slots + 1, pcfg.vocab_size)
    plogits[:slots] = torch.from_numpy(logits)
    one = (lambda n: torch.tensor([n]))
    with torch.no_grad():
        continuous.make_prefix_admit_program(pcfg, attend, bucket)(
            model, cache, plogits, one(0), one(2), one(11),
            torch.from_numpy(suffix).long(), one(5))
    np.testing.assert_allclose(plogits[:slots].numpy(), want_logits,
                               rtol=TOL, atol=TOL)
    _assert_cache_close(cache, want_tree, slots, pcfg.max_seq_len)


def test_block_copy_program_matches_reference(weights):
    """Block 1 forks into block 3; a pad destination writes nothing."""
    torch, llama, _, continuous, _ = _port()
    cfg, params = ref.tiny(), weights[False]
    tree, _ = _prefilled(cfg, params, 4, 64)
    baxes, _ = _axes(tree)
    copy = refc.make_block_copy_program(baxes)
    want = copy(jax.tree.map(jnp.array, tree), np.int32(1), np.int32(3))
    want = jax.tree.map(np.asarray, copy(want, np.int32(0), np.int32(4)))
    pcfg = llama.tiny()
    cache = _to_port(torch, llama, pcfg, tree, 4, pcfg.max_seq_len)
    fork = continuous.make_block_copy_program()
    fork(cache, torch.tensor([1]), torch.tensor([3]))
    fork(cache, torch.tensor([0]), torch.tensor([4]))  # the pad id
    _assert_cache_close(cache, want, 4, pcfg.max_seq_len)


# -- the engine ---------------------------------------------------------------


def _conversation(engine):
    """A prompt, the same prompt again, then the conversation continued."""
    a = engine.generate(BASE, max_new_tokens=8, timeout=WAIT_S)
    b = engine.generate(BASE, max_new_tokens=8, timeout=WAIT_S)
    c = engine.generate(BASE + a + [5, 6, 7], max_new_tokens=8,
                        timeout=WAIT_S)
    return [a, b, c]


def _fork_live(engine):
    """B shares 37 tokens (4 full blocks of 8 and 5 of the fifth) with A,
    which is still decoding: B shares 4 blocks and forks the fifth."""
    a = engine.submit(BASE, max_new_tokens=40)
    first = None
    while first is None and not a.done.wait(0.001):
        first = a.tokens[:1] or None
    b = engine.generate(BASE[:37] + [9, 9, 9], max_new_tokens=8,
                        timeout=WAIT_S)
    return [a.wait(WAIT_S), b]


def _resurrect(engine):
    """A retires; B shares exactly 5 full blocks of A's registered ones."""
    a = engine.generate(BASE, max_new_tokens=8, timeout=WAIT_S)
    b = engine.generate(BASE[:40] + [9, 9, 9], max_new_tokens=8,
                        timeout=WAIT_S)
    return [a, b]


def _burst(engine):
    reqs = [engine.submit(p, max_new_tokens=5) for p in BURST]
    return [r.wait(WAIT_S) for r in reqs]


PAGED_CASES = {"fork_live": _fork_live, "resurrect": _resurrect,
               "resend": _conversation}


def _serve(engine, script, warm=WARM):
    try:
        engine.warmup(warm)
        return script(engine), engine.stats()
    finally:
        engine.stop()


def _suffix_cfg(cfg):
    return dataclasses.replace(cfg, max_seq_len=32)


@pytest.fixture(scope="module")
def reference_runs(weights):
    out = {"slot": _serve(refc.ContinuousEngine(ref.tiny(), weights[False],
                                                **SLOT), _conversation)}
    for name, script in PAGED_CASES.items():
        out[name] = _serve(refc.ContinuousEngine(ref.tiny(), weights[False],
                                                 **PAGED), script)
    for quant in (False, True):
        cfg = ref.tiny(quant_kv=quant)
        out["segments", quant] = _serve(refc.ContinuousEngine(
            _suffix_cfg(cfg), weights[quant], **SEGMENTS), _burst, None)
        out["full_slots", quant] = _serve(refc.ContinuousEngine(
            cfg, weights[quant], num_slots=4, decode_chunk=2,
            prefix_cache=False), _burst, None)
    out["spec"] = _serve(refc.ContinuousEngine(
        ref.tiny(), weights[False], num_slots=4, decode_chunk=2, spec_k=4,
        min_prefix=8), _conversation)
    return out


def _port_engine(weights, quant=False, suffix=False, **kw):
    _, llama, convert, continuous, _ = _port()
    cfg = llama.tiny(quant_kv=quant)
    sd = convert.state_dict_from_jax(weights[quant], cfg)
    if suffix:
        cfg = _suffix_cfg(cfg)
    return continuous.ContinuousEngine(cfg, sd, device="cpu", **kw)


def _counters(stats, names):
    return {n: stats[n] for n in names}


def test_slot_prefix_cache_matches_reference(weights, reference_runs):
    tokens, stats = _serve(_port_engine(weights, **SLOT), _conversation)
    want, want_stats = reference_runs["slot"]
    assert tokens == want
    assert tokens[0] == tokens[1]
    assert _counters(stats, PREFIX_COUNTERS) == _counters(
        want_stats, PREFIX_COUNTERS)
    assert stats["prefix_hits"] == 2
    assert stats["graph_captures_total"] == 0


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_prefix_matches_reference(weights, reference_runs, case):
    _, _, _, _, runtime = _port()
    ledger = runtime.BlockLedger()
    eng = _port_engine(weights, **PAGED)
    eng.attach_block_ledger(ledger)
    tokens, stats = _serve(eng, PAGED_CASES[case])
    want, want_stats = reference_runs[case]
    assert tokens == want
    assert _counters(stats, PREFIX_COUNTERS) == _counters(
        want_stats, PREFIX_COUNTERS)
    assert stats["prefix_block_hits_total"] > 0
    if case != "resurrect":
        assert stats["kv_blocks_cow_copies_total"] > 0
    assert eng.audit_blocks() == []
    assert ledger.leaked_total == 0 and ledger.conservation_errors == []
    assert eng.stats()["kv_blocks_free"] == eng.num_blocks
    assert stats["graph_captures_total"] == 0


def test_paged_prefix_equals_slot_pool(weights):
    """Block sharing and the COW fork give the slot pool's tokens."""
    slot = _serve(_port_engine(weights, **SLOT), _conversation)[0]
    paged = _serve(_port_engine(weights, **PAGED), _conversation)[0]
    assert paged == slot


@pytest.mark.parametrize("quant", [False, True],
                         ids=["kv_in_dtype", "kv_int8"])
def test_segments_match_reference(weights, reference_runs, quant):
    """Four prompts sharing a 48-token prefix decode together in 32-token
    suffix slots behind one segment: the reference's tokens and counters,
    and those of full-length slots."""
    tokens, stats = _serve(_port_engine(weights, quant, suffix=True,
                                        **SEGMENTS), _burst, None)
    want, want_stats = reference_runs["segments", quant]
    assert tokens == want
    assert tokens == reference_runs["full_slots", quant][0]
    assert _counters(stats, SEGMENT_COUNTERS) == _counters(
        want_stats, SEGMENT_COUNTERS)
    assert stats["segment_hits"] == 3
    assert stats["graph_captures_total"] == 0


def test_spec_with_prefix_cache_matches_reference(weights, reference_runs):
    tokens, stats = _serve(_port_engine(
        weights, num_slots=4, decode_chunk=2, spec_k=4, min_prefix=8),
        _conversation)
    want, want_stats = reference_runs["spec"]
    assert tokens == want == reference_runs["slot"][0]
    assert stats["prefix_hits"] == want_stats["prefix_hits"] == 2
    assert stats["spec_dispatches_total"] > 0
    assert stats["graph_captures_total"] == 0


def test_prefix_cache_is_on_by_default(weights):
    _, llama, convert, continuous, _ = _port()
    cfg = llama.tiny()
    sd = convert.state_dict_from_jax(weights[False], cfg)
    assert continuous.engine_kwargs({})["prefix_cache"] is True
    assert continuous.ContinuousEngine(cfg, sd, device="cpu").prefix_cache
    eng = continuous.build_engine(cfg, sd, {"warmup_groups": []},
                                  device="cpu")
    assert eng.prefix_cache and eng.min_prefix == 32
    eng.stop()


@pytest.mark.parametrize("kw,match", [
    ({"prefix_segments": 2, "segment_len": 64, "block_size": 8},
     "superseded"),
    ({"prefix_segments": 2}, "segment_len"),
    ({"prefix_segments": 2, "segment_len": 16, "min_prefix": 32},
     "min_prefix"),
])
def test_bad_segment_knobs_raise(weights, kw, match):
    with pytest.raises(ValueError, match=match):
        _port_engine(weights, **kw)
