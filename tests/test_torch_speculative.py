"""Speculative decoding in the port (``kubeflow_tpu_torch/serving/
continuous.py``) against the reference's (``kubeflow_tpu/serving/
continuous.py``), f32 ``tiny()`` weights carried across with
``convert.state_dict_from_jax``:

- ``NgramProposer`` proposes what the reference's proposes;
- the verify program, on the same pool, logits, drafts and residual bans
  with greedy rows, gives the same tokens and accept lengths, and logits
  and cache within 1e-5;
- the decode attention with a shared-prefix segment (``prefix``,
  ``cache_positions``) matches the reference's within 2e-5, rows with an
  empty segment and int8 KV included;
- the engine with ``spec_k=4`` gives the reference engine's greedy tokens
  for the ``LOOPY`` prompt of ``tests/test_speculative.py`` in the slot
  pool, the paged pool, the tiny MoE and under chunked admission (fused
  verify), and, served alone, the same speculation counters.

Each reference engine runs once per module. torch and the port are
imported inside the tests (see test_torch_llama.py).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.serving import continuous as refc

WAIT_S = 300
NEW = 60
LOOPY = np.random.default_rng(7).integers(1, 256, size=5).tolist()
SHORT = [7, 8, 9]
MOE = dict(moe_experts=4, moe_top_k=2, moe_dispatch="ragged")
WARM = [(1, 32)]
SPEC = dict(num_slots=4, decode_chunk=1, spec_k=4, prefix_cache=False)
SETUPS = {"slot_pool": {}, "paged": {"block_size": 8}, "moe": {}}
COUNTERS = ("spec_dispatches_total", "spec_tokens_proposed_total",
            "spec_tokens_accepted_total", "decode_steps")
#: f32 K/V and logits written by the two frameworks: the same products
#: summed in another order
TOL = 1e-5
ATTEND_TOL = 2e-5


def _port():
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import continuous

    torch.set_num_threads(1)
    return torch, llama, convert, continuous


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


def _solo(engine):
    """Warm, serve LOOPY alone, stop: (tokens, stats)."""
    try:
        engine.warmup(WARM)
        tokens = engine.generate(LOOPY, max_new_tokens=NEW, timeout=WAIT_S)
        return tokens, engine.stats()
    finally:
        engine.stop()


def _victim_and_late(engine):
    """LOOPY decoding speculatively while a second prompt's chunks fuse
    into its verify dispatches: (tokens of both, stats)."""
    try:
        engine.warmup(WARM)
        victim = engine.submit(LOOPY, max_new_tokens=NEW)
        deadline = time.monotonic() + WAIT_S
        while engine.step_counter < 5 and time.monotonic() < deadline:
            time.sleep(0.005)
        late = engine.submit(SHORT, max_new_tokens=8)
        return [victim.wait(WAIT_S), late.wait(WAIT_S)], engine.stats()
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def reference_runs(models):
    """The reference engine's (tokens, stats) per setup, spec on and off."""
    out = {}
    for name, kw in SETUPS.items():
        cfg, params = models[name == "moe"]
        for spec_k in (0, 4):
            eng = refc.ContinuousEngine(cfg, params, **{**SPEC, **kw,
                                                        "spec_k": spec_k})
            out[name, spec_k] = _solo(eng)
    cfg, params = models[False]
    out["chunked"] = _victim_and_late(refc.ContinuousEngine(
        cfg, params, prefill_budget=8, **SPEC))
    return out


def _port_engine(models, moe=False, **kw):
    _, llama, convert, continuous = _port()
    cfg = llama.tiny(**(MOE if moe else {}))
    return continuous.ContinuousEngine(
        cfg, convert.state_dict_from_jax(models[moe][1], cfg), device="cpu",
        **{**SPEC, **kw})


# -- NgramProposer ----------------------------------------------------------


def _histories():
    """(history, n, k, window) cases: the reference tests' (a match, no
    match, a short history, a continuation past the history's end, a
    constant run, a period-5 cycle, the window cap) and seeded ones."""
    cases = [
        ([1, 2, 9, 9, 5, 1, 2, 3, 4, 1, 2], 2, 3, 4096),
        ([1, 2, 3, 4, 5], 3, 4, 4096),
        ([1, 2], 3, 4, 4096),
        ([5, 6, 7, 8, 5, 6], 2, 8, 4096),
        ([5, 6, 7, 8, 5, 6], 2, 2, 4096),
        ([7] * 6, 3, 4, 4096),
        (([11, 22, 33, 44, 55] * 4)[:18], 3, 4, 4096),
        ([1, 2, 3] + [0] * 7 + [1, 2], 2, 2, 4096),
        ([1, 2, 3] + [0] * 7 + [1, 2], 2, 2, 8),
    ]
    rng = np.random.default_rng(11)
    for seed in range(4):
        hist = rng.integers(0, 4, size=40).tolist()
        cases.append((hist, 1 + seed % 3, 4, 16 + 8 * seed))
    return cases


@pytest.mark.parametrize("case", range(len(_histories())))
def test_ngram_proposer_matches_reference(case):
    _, _, _, continuous = _port()
    hist, n, k, window = _histories()[case]
    want = refc.NgramProposer(n, window=window).propose(hist, k)
    got = continuous.NgramProposer(n, window=window).propose(hist, k)
    assert got == want


def test_ngram_proposer_refuses_bad_arguments():
    _, _, _, continuous = _port()
    with pytest.raises(ValueError, match=">= 1"):
        continuous.NgramProposer(0)
    with pytest.raises(ValueError, match="window"):
        continuous.NgramProposer(2, window=0)


# -- the verify program -----------------------------------------------------


def _greedy_chain(rmodel, params, cache, logits, pos, n):
    """The next ``n`` greedy tokens of one row from its carried logits."""
    out = []
    for i in range(n):
        tok = int(np.argmax(logits))
        out.append(tok)
        lg, mut = rmodel.apply(
            {"params": params, "cache": cache}, jnp.asarray([[tok]]),
            jnp.asarray([[pos + i]]), decode=True, mutable=["cache"])
        cache, logits = mut["cache"], np.asarray(lg[0, -1])
    return out


@pytest.mark.parametrize("filtered", [False, True])
def test_verify_program_matches_reference(models, filtered):
    """Four slots after a ragged prefill: drafts equal to the greedy run
    (all accepted), wrong at the third draft (2 accepted), no drafts with
    a residual ban, and an inactive slot."""
    torch, llama, convert, continuous = _port()
    cfg, params = models[False]
    slots, k, attend = 4, 4, 64
    rmodel = ref.Llama(cfg, decode_attend_len=attend)
    rng = np.random.default_rng(5)
    lengths = np.array([16, 9, 12, 4], np.int32)
    prompt = rng.integers(0, cfg.vocab_size, size=(slots, 16), dtype=np.int32)
    rcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          refc.cache_shapes(cfg, slots))
    lg, mut = rmodel.apply(
        {"params": params, "cache": rcache}, prompt,
        np.broadcast_to(np.arange(16, dtype=np.int32), (slots, 16)),
        decode=True, mutable=["cache"])
    rcache = mut["cache"]
    logits = np.stack([np.asarray(lg[i, n - 1]) for i, n in
                       enumerate(lengths)])
    def row(i):  # the slot's rows of every cache leaf (not cache_index)
        return jax.tree.map(lambda c: c[:, i:i + 1] if c.ndim > 1 else c,
                            rcache)

    chain = _greedy_chain(rmodel, params, row(0), logits[0],
                          int(lengths[0]), k + 1)
    chain1 = _greedy_chain(rmodel, params, row(1), logits[1],
                           int(lengths[1]), k + 1)
    drafts = np.full((slots, k), -1, np.int32)
    drafts[0] = chain[1:]
    drafts[1] = chain1[1:]
    drafts[1, 2] = (chain1[3] + 1) % cfg.vocab_size
    banned = np.array([-1, -1, 3, -1], np.int32)
    active = np.array([True, True, True, False])
    temps, top_ps = np.zeros(slots, np.float32), np.ones(slots, np.float32)
    top_ks = np.zeros(slots, np.int32)
    rout = refc.make_verify_program(cfg, attend, k)(
        params, jax.tree.map(jnp.array, rcache), jnp.asarray(logits),
        drafts, banned, lengths, active, temps, top_ps, top_ks,
        np.asarray(jax.random.PRNGKey(0)))
    want_cache, want_logits, want_toks, want_acc = jax.tree.map(np.asarray,
                                                                rout)
    assert want_acc.tolist()[:3] == [k, 2, 0]

    pcfg = llama.tiny()
    model = llama.Llama(pcfg, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(params, pcfg))
    cache = llama.KvCache.zeros(pcfg, slots + 1, pcfg.max_seq_len,
                                device="cpu")
    attn = rcache["layers"]["block"]["attn"]
    cache.k[:, :slots, :pcfg.max_seq_len] = torch.from_numpy(
        np.array(attn["cached_key"]))
    cache.v[:, :slots, :pcfg.max_seq_len] = torch.from_numpy(
        np.array(attn["cached_value"]))
    plogits = torch.zeros(slots + 1, pcfg.vocab_size)
    plogits[:slots] = torch.from_numpy(logits)
    verify = continuous.make_verify_program(pcfg, attend, k, filtered)
    with torch.no_grad():
        out = verify(model, cache, plogits, torch.from_numpy(drafts).long(),
                     torch.from_numpy(banned).long(),
                     torch.from_numpy(lengths).long(),
                     torch.from_numpy(active), torch.from_numpy(temps),
                     torch.from_numpy(top_ps),
                     torch.from_numpy(top_ks).long(),
                     torch.rand(k + 1, slots, pcfg.vocab_size)).numpy()
    np.testing.assert_array_equal(out[:, :k + 1], want_toks)
    np.testing.assert_array_equal(out[:, k + 1], want_acc)
    np.testing.assert_allclose(plogits[:slots].numpy(), want_logits,
                               rtol=TOL, atol=TOL)
    want_attn = want_cache["layers"]["block"]["attn"]
    for mine, name in ((cache.k, "cached_key"), (cache.v, "cached_value")):
        np.testing.assert_allclose(
            mine[:, :slots, :pcfg.max_seq_len].numpy(), want_attn[name],
            rtol=TOL, atol=TOL, err_msg=name)


# -- the decode attention with a shared-prefix segment ----------------------


@pytest.mark.parametrize("quant", [False, True],
                         ids=["kv_in_dtype", "kv_int8"])
def test_decode_attend_with_prefix_matches_reference(quant):
    """One attention layer: an 8-token suffix prefill at slot-local
    positions behind segments of 23, 0 and 40 tokens, then one decode step
    in which the last row is inactive (pinned at the end)."""
    torch, llama, _, _ = _port()
    cfg = ref.tiny(quant_kv=quant)
    b, s, sp, attend = 3, 8, 40, 64
    kv, d = cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, s, cfg.hidden_size)).astype(np.float32)
    x1 = rng.standard_normal((b, 1, cfg.hidden_size)).astype(np.float32)
    pk = rng.standard_normal((b, sp, kv, d)).astype(np.float32)
    pv = rng.standard_normal((b, sp, kv, d)).astype(np.float32)
    plen = np.array([23, 0, 40], np.int32)
    local = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    local1 = np.array([[s], [s], [cfg.max_seq_len]], np.int32)
    feeds = [(x, local), (x1, local1)]
    rmod = ref.Attention(cfg, decode=True, decode_attend_len=attend)
    variables = rmod.init(jax.random.PRNGKey(1), x, plen[:, None] + local,
                          prefix=(pk, pv, plen), cache_positions=local)
    params = nn.meta.unbox(variables["params"])
    rcache = jax.tree.map(jnp.zeros_like, variables["cache"])

    pcfg = llama.tiny(quant_kv=quant, num_layers=1)
    attn = llama.Attention(pcfg, "cpu")
    for name in ("wq", "wk", "wv", "wo"):
        getattr(attn, name).data = torch.from_numpy(
            np.asarray(params[name]["kernel"]))
    cache = llama.KvCache.zeros(pcfg, b, pcfg.max_seq_len, device="cpu")
    prefix = (torch.from_numpy(pk), torch.from_numpy(pv),
              torch.from_numpy(plen).long())
    for i, (xi, lpos) in enumerate(feeds):
        gpos = plen[:, None] + lpos
        want, mut = rmod.apply({"params": params, "cache": rcache}, xi,
                               gpos, prefix=(pk, pv, plen),
                               cache_positions=lpos, mutable=["cache"])
        rcache = mut["cache"]
        with torch.no_grad():
            got = attn(torch.from_numpy(xi), torch.from_numpy(gpos).long(),
                       cache, 0, attend, prefix,
                       torch.from_numpy(np.ascontiguousarray(lpos)).long())
        want = np.asarray(want)
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel <= ATTEND_TOL, f"step {i}: rel err {rel}"
        mine = cache.k[0, :, :pcfg.max_seq_len].numpy()
        theirs = np.asarray(rcache["cached_key"])
        if quant:
            assert np.abs(mine.astype(np.int32)
                          - theirs.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(mine, theirs, rtol=TOL, atol=TOL)


def test_empty_segment_rows_equal_plain_decode(models):
    """A row with plen 0 attends nothing of the segment: the same logits
    as the decode path without a prefix."""
    torch, llama, convert, _ = _port()
    pcfg = llama.tiny()
    model = llama.Llama(pcfg, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(models[False][1],
                                                      pcfg))
    toks = torch.arange(1, 13).view(2, 6)
    pos = torch.arange(6).expand(2, 6)
    pk = torch.randn(pcfg.num_layers, 2, 16, pcfg.num_kv_heads,
                     pcfg.head_dim, generator=torch.Generator().manual_seed(0))
    outs = []
    with torch.no_grad():
        for prefix in (None, (pk, pk, torch.zeros(2, dtype=torch.long))):
            cache = llama.KvCache.zeros(pcfg, 2, pcfg.max_seq_len,
                                        device="cpu")
            outs.append(model(toks, pos, cache=cache, attend=64,
                              prefix=prefix, cache_positions=pos))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-6, atol=1e-6)


# -- the engine ---------------------------------------------------------------


@pytest.mark.parametrize("setup", list(SETUPS))
def test_spec_greedy_tokens_match_reference(models, reference_runs, setup):
    tokens, stats = _solo(_port_engine(models, moe=setup == "moe",
                                       **SETUPS[setup]))
    want, want_stats = reference_runs[setup, 4]
    assert tokens == want
    assert want == reference_runs[setup, 0][0]  # spec on = spec off
    assert {c: stats[c] for c in COUNTERS} == {
        c: want_stats[c] for c in COUNTERS}
    assert stats["spec_dispatches_total"] > 0
    assert stats["graph_captures_total"] == 0


def test_spec_off_greedy_tokens_match_reference(models, reference_runs):
    tokens, stats = _solo(_port_engine(models, spec_k=0))
    assert tokens == reference_runs["slot_pool", 0][0]
    assert stats["spec_dispatches_total"] == 0
    assert stats["spec_tokens_proposed_total"] == 0


def test_spec_chunked_fused_verify_matches_reference(models, reference_runs):
    """A prompt's chunks fuse into the verify dispatches of a slot that
    decodes speculatively: both streams equal the reference's."""
    tokens, stats = _victim_and_late(_port_engine(models, prefill_budget=8))
    assert tokens == reference_runs["chunked"][0]
    assert tokens[0] == reference_runs["slot_pool", 0][0]
    assert stats["prefill_chunks_dispatched"] >= 1
    assert stats["spec_dispatches_total"] > 0
    assert stats["graph_captures_total"] == 0


def test_misbehaving_proposer_degrades(models, reference_runs):
    """A proposer that raises, or proposes more than asked, means no
    draft or a clamped one: the tokens stay the reference's."""
    _, _, _, continuous = _port()
    calls = {"n": 0}

    class Evil(continuous.DraftProposer):
        def propose(self, history, k):
            calls["n"] += 1
            if calls["n"] % 3 == 0:
                raise RuntimeError("proposer bug")
            return continuous.NgramProposer(3).propose(history, k) + [1, 2]

    tokens, stats = _solo(_port_engine(models, draft_proposer=Evil()))
    assert calls["n"] > 3
    assert tokens == reference_runs["slot_pool", 0][0]
    assert stats["spec_tokens_proposed_total"] <= 4 * calls["n"]
    assert stats["graph_captures_total"] == 0


def test_eos_inside_an_accepted_run_cuts_at_the_token(models,
                                                      reference_runs):
    want = reference_runs["slot_pool", 0][0]
    first: dict[int, int] = {}
    for i, t in enumerate(want):
        first.setdefault(t, i)
    eos, idx = max(first.items(), key=lambda kv: kv[1])
    tokens, stats = _solo(_port_engine(models, eos_id=eos))
    assert tokens == want[:idx + 1]
    assert stats["spec_dispatches_total"] > 0


def test_sampled_requests_speculate(models):
    """Temperature and top-k slots verify beside a greedy one (the draws
    read the noise planes; the residual bans are armed and consumed)."""
    eng = _port_engine(models)
    try:
        eng.warmup(WARM)
        hot = eng.submit(LOOPY, max_new_tokens=24, temperature=0.7,
                         top_k=8)
        greedy = eng.submit(SHORT, max_new_tokens=8)
        assert len(hot.wait(WAIT_S)) == 24
        assert len(greedy.wait(WAIT_S)) == 8
        assert eng.stats()["graph_captures_total"] == 0
    finally:
        eng.stop()


@pytest.mark.parametrize("knob,value", [("spec_k", -1), ("spec_ngram", 0)])
def test_bad_spec_knobs_raise(models, knob, value):
    with pytest.raises(ValueError, match=knob):
        _port_engine(models, **{knob: value})


def test_build_engine_takes_the_spec_knobs(models):
    _, llama, convert, continuous = _port()
    cfg = llama.tiny()
    eng = continuous.build_engine(
        cfg, convert.state_dict_from_jax(models[False][1], cfg),
        {"num_slots": 2, "decode_chunk": 1, "spec_k": 3, "spec_ngram": 2,
         "warmup_groups": WARM}, device="cpu")
    try:
        assert (eng.spec_k, eng.spec_ngram, eng._proposer.n) == (3, 2, 2)
        assert len(eng.generate(LOOPY, 12, timeout=WAIT_S)) == 12
        assert eng.stats()["graph_captures_total"] == 0
    finally:
        eng.stop()


def test_verify_writes_past_the_end_land_in_scratch(models):
    """A verify at a front whose k + 1 tokens reach past max_seq_len writes
    only the scratch position there."""
    torch, llama, convert, continuous = _port()
    pcfg = llama.tiny()
    model = llama.Llama(pcfg, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(models[False][1],
                                                      pcfg))
    cache = llama.KvCache.zeros(pcfg, 2, pcfg.max_seq_len, device="cpu")
    before = cache.k.clone()
    front = pcfg.max_seq_len - 2
    verify = continuous.make_verify_program(pcfg, pcfg.max_seq_len, 4,
                                            False)
    with torch.no_grad():
        verify(model, cache, torch.zeros(2, pcfg.vocab_size),
               torch.full((1, 4), 3), torch.full((1,), -1),
               torch.tensor([front]), torch.tensor([True]), torch.zeros(1),
               torch.ones(1), torch.zeros(1, dtype=torch.long),
               torch.rand(5, 1, pcfg.vocab_size))
    assert torch.equal(cache.k[:, 1], before[:, 1])  # the scratch row
    assert torch.equal(cache.k[:, 0, :front], before[:, 0, :front])
    assert cache.k[:, 0, front:].abs().sum() > 0
