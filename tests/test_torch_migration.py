"""Live KV migration, the tier ladder and prefill/decode disaggregation in
the port's serving engine (``kubeflow_tpu_torch/serving/continuous.py``)
against the reference's, f32 ``tiny()`` weights carried across with
``convert.state_dict_from_jax``:

- the block programs ``kv_export``/``kv_import`` and the logits take/set on
  the same pool bytes, within 1e-5 (int8 codes within 1);
- a sequence exported mid-decode or mid-prefill and imported into a second
  port engine gives the reference engine's uninterrupted greedy tokens, as
  do the speculative and int8-KV variants, a drain
  (``migrate_live_sequences``) and a held import resumed later; the
  migration counters equal the reference's for the same moves;
- copy then cutover: a destination without room raises and the source
  resumes; a released sequence stays prefix-matchable; a frozen slot's
  logits row survives its neighbours' dispatches; a cancel while frozen
  frees the slot;
- ``TieredEngine`` and the in-process ``DisaggregatedPool`` give the
  reference's tokens, and the ladder's quota admits as the reference's;
- a snapshot the reference engine exported continues in the port engine.

Timing: exports wait for a token count ``n`` of a request with at least
``12 n`` new tokens, and each test asserts its snapshot is mid-decode, so a
late export fails loudly; the mid-prefill export steps the source's
scheduler one dispatch at a time (``_Pacer``). Every engine attaches a ``BlockLedger`` that must
count no leak, and warms its shapes: no capture after warmup. Each
reference engine runs once per module.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.analysis.runtime import BlockLedger as RefLedger
from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.serving import continuous as refc

WAIT_S = 300
TOL = 1e-5
LONG = list(range(1, 65))  # 64 tokens = 4 blocks at block_size 16
SHORT = [7, 8, 9]
LOOPY = [5, 6, 5, 6, 5, 6, 5]
PAGED = dict(num_slots=4, decode_chunk=2, prefix_cache=False, block_size=16)
#: chunked admission: LONG prefills in 16 chunks
CHUNKED = dict(PAGED, prefill_budget=4)
#: the ladder: one slot for requests under 64 tokens in all, one for the rest
TIERS = dict(num_slots=2, decode_chunk=2, prefix_cache=False, block_size=16,
             tier_lens=[64], tier_slots=[1])
MIGRATE_KEYS = ("kv_migrations_total", "kv_migrate_failures_total",
                "kv_migrate_latency_ms_count")


def _port():
    import torch

    from kubeflow_tpu_torch.analysis import runtime
    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import continuous, paged

    torch.set_num_threads(1)
    return torch, llama, convert, continuous, paged, runtime


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


@pytest.fixture(scope="module")
def models(weights):
    """{quant_kv: (the port's cfg, one port Llama shared by its engines)}."""
    _, llama, convert, *_ = _port()
    out = {}
    for quant in (False, True):
        cfg = llama.tiny(quant_kv=quant)
        model = llama.Llama(cfg, device="cpu")
        model.load_state_dict(convert.state_dict_from_jax(weights[quant],
                                                          cfg))
        out[quant] = cfg, model
    return out


def _wait_tokens(req, n: int) -> None:
    deadline = time.time() + WAIT_S
    while len(req.tokens) < n:
        assert time.time() < deadline, "no tokens emitted"
        time.sleep(0.002)


def _export_after(src, req, n: int):
    """Export once ``req`` has ``n`` tokens; the snapshot must be
    mid-decode."""
    _wait_tokens(req, n)
    snap = src.export_sequence(req)
    assert snap is not None, "the request finished before its export"
    assert snap["phase"] == "decode"
    assert len(snap["prompt"]) < snap["position"] and snap["remaining"] > 0
    return snap


@pytest.fixture(scope="module")
def reference(weights):
    """The reference engine's uninterrupted greedy tokens, a reference
    mid-decode migration's and drain's counters, and a reference snapshot
    exported mid-decode."""
    out = {}
    params = weights[False]
    cfg = ref.tiny()

    def engine(**kw):
        eng = refc.ContinuousEngine(cfg, params, **kw)
        eng.attach_block_ledger(RefLedger())
        return eng

    src, dst = engine(**PAGED), engine(**PAGED)
    try:
        out["long40"] = src.generate(LONG, max_new_tokens=40, timeout=WAIT_S)
        out["short12"] = src.generate(SHORT, max_new_tokens=12,
                                      timeout=WAIT_S)
        out["short40"] = src.generate(SHORT, max_new_tokens=40,
                                      timeout=WAIT_S)
        out["loopy96"] = src.generate(LOOPY, max_new_tokens=96,
                                      timeout=WAIT_S)
        # one mid-decode migration
        req = src.submit(LONG, max_new_tokens=40)
        snap = _export_after(src, req, 3)
        dst.import_sequence(snap, req=req)
        src.release_sequence(req)
        assert req.wait(WAIT_S) == out["long40"]
        out["migrate_stats"] = {
            "src": {k: src.stats()[k] for k in MIGRATE_KEYS},
            "dst": {k: dst.stats()[k] for k in MIGRATE_KEYS}}
        # a drain of two live sequences
        r1 = src.submit(LONG, max_new_tokens=40)
        r2 = src.submit(SHORT, max_new_tokens=12)
        _wait_tokens(r1, 2)
        _wait_tokens(r2, 2)
        out["drain_failed"] = refc.migrate_live_sequences(src, dst)[1]
        assert r1.wait(WAIT_S) == out["long40"]
        assert r2.wait(WAIT_S) == out["short12"]
        # a snapshot for the port to import (the source then lets go)
        req = src.submit(LONG, max_new_tokens=40)
        out["snapshot"] = _export_after(src, req, 3)
        src.release_sequence(req)
        req.cancel()
    finally:
        src.stop()
        dst.stop()
    eng = engine(**CHUNKED)
    try:
        out["chunked_long24"] = eng.generate(LONG, max_new_tokens=24,
                                             timeout=WAIT_S)
        out["chunked_short12"] = eng.generate(SHORT, max_new_tokens=12,
                                              timeout=WAIT_S)
    finally:
        eng.stop()
    qcfg = ref.tiny(quant_kv=True)
    eng = refc.ContinuousEngine(qcfg, weights[True], **PAGED)
    try:
        out["int8_long40"] = eng.generate(LONG, max_new_tokens=40,
                                          timeout=WAIT_S)
    finally:
        eng.stop()
    kw = {k: v for k, v in TIERS.items() if k not in ("tier_lens",
                                                      "tier_slots")}
    tiered = refc.TieredEngine(cfg, params, tier_lens=TIERS["tier_lens"],
                               tier_slots=TIERS["tier_slots"], **kw)
    try:
        out["tiered"] = _tier_order(tiered)
    finally:
        tiered.stop()
    return out


def _tier_order(engine):
    """Two long requests and a short one submitted after them, into the
    ladder (one slot a class): the short one admits while the second long
    one waits for the first to finish. (tokens, short admitted before the
    second long)."""
    reqs = [engine.submit(LONG, max_new_tokens=40),
            engine.submit(LONG[:40], max_new_tokens=24),
            engine.submit(SHORT, max_new_tokens=12)]
    tokens = [r.wait(WAIT_S) for r in reqs]
    return tokens, reqs[2].admitted_step < reqs[1].admitted_step


class _Pacer:
    """An admission policy that parks the scheduler in each admission
    cycle until the test grants it a step. A request with ``PROMPT`` waits
    and is never admitted, and every cycle asks about it. ``step`` runs
    exactly one loop iteration (one dispatch) and waits until the
    scheduler is parked again, so a test decides how far a prefill gets,
    however loaded the machine."""

    PROMPT = [3, 1, 4, 1, 5]

    def __init__(self):
        self._steps = threading.Semaphore(0)
        self._free = threading.Event()
        self.asked = 0

    def __call__(self, req) -> bool:
        if req.prompt != self.PROMPT:
            return True
        self.asked += 1
        if not self._free.is_set():
            self._steps.acquire(timeout=WAIT_S)
        return False

    def parked(self, n: int) -> None:
        """Wait until the scheduler has asked ``n`` times."""
        deadline = time.time() + WAIT_S
        while self.asked < n:
            assert time.time() < deadline, "the scheduler never asked"
            time.sleep(0.001)

    def step(self) -> None:
        n = self.asked
        self._steps.release()
        self.parked(n + 1)

    def call(self, eng, fn):
        """``fn()`` (mailbox ops of ``eng``) on another thread, one step
        granted whenever an op waits in the mailbox."""
        out = []

        def run():
            try:
                out.append(fn())
            except Exception as e:  # noqa: BLE001 — re-raised below
                out.append(e)

        t = threading.Thread(target=run)
        t.start()
        deadline = time.time() + WAIT_S
        while t.is_alive():
            assert time.time() < deadline, "the mailbox op never ended"
            if not eng._migrate_q.empty():
                self.step()
            t.join(0.001)
        if isinstance(out[0], Exception):
            raise out[0]
        return out[0]

    def release(self) -> None:
        """Stop parking the scheduler."""
        self._free.set()
        self._steps.release()


def _engine(models, quant=False, ledger=True, warm=True, **kw):
    _, _, _, continuous, _, runtime = _port()
    cfg, model = models[quant]
    eng = continuous.ContinuousEngine(cfg, model, device="cpu",
                                      **{**PAGED, **kw})
    if ledger:
        eng.attach_block_ledger(runtime.BlockLedger())
    if warm:
        eng.warmup([(1, 32), (1, 64)])
    return eng


def _assert_clean(*engines):
    for eng in engines:
        assert eng.audit_blocks() == []
        st = eng.stats()
        assert st["kv_blocks_leaked_total"] == 0
        assert st["graph_captures_total"] == 0
        assert eng.block_ledger.conservation_errors == []


# -- the programs ---------------------------------------------------------------

L, N, BS, KV, D = 2, 6, 4, 2, 3


def _pools(seed: int, quant: bool):
    """(the reference pool tree, its block and seq axes, the port's pool
    with a scratch block of zeros)."""
    torch, llama, *_ = _port()
    rng = np.random.default_rng(seed)
    if quant:
        leaves = {n: rng.integers(-127, 128, size=(L, N, BS, KV, D),
                                  dtype=np.int8) for n in ("k", "v")}
        for n in ("k_scale", "v_scale"):
            leaves[n] = rng.random((L, N, KV, BS)).astype(np.float32)
    else:
        leaves = {n: rng.standard_normal((L, N, BS, KV, D)).astype(
            np.float32) for n in ("k", "v")}
    names = {"k": "cached_key", "v": "cached_value",
             "k_scale": "cached_key_scale", "v_scale": "cached_value_scale"}
    tree = {names[n]: jnp.asarray(a) for n, a in leaves.items()}
    baxes = {names[n]: 1 for n in leaves}
    saxes = {names[n]: (2 if n in ("k", "v") else 3) for n in leaves}

    def with_scratch(a):
        return torch.from_numpy(np.concatenate(
            [a, np.zeros((L, 1, *a.shape[2:]), a.dtype)], axis=1))

    pool = llama.KvCache(**{n: with_scratch(a) for n, a in leaves.items()},
                         seq_len=BS)
    return tree, baxes, saxes, pool, names


def _close(mine, theirs, what):
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    if mine.dtype == np.int8:
        assert np.abs(mine.astype(np.int32)
                      - theirs.astype(np.int32)).max() <= 1, what
    else:
        np.testing.assert_allclose(mine, theirs, rtol=TOL, atol=TOL,
                                   err_msg=what)


@pytest.mark.parametrize("quant", [False, True], ids=["kv", "kv_int8"])
def test_kv_export_import_match_reference(quant):
    """A group of blocks with pad ids: export clips the pads to the last
    block, import writes them nowhere the pool reads. The leaves come out
    in the reference's order (k, k_scale, v, v_scale), block axis first."""
    torch, _, _, _, paged, _ = _port()
    tree, baxes, saxes, pool, names = _pools(0, quant)
    ids = np.array([3, 0, 5, N, N, 1, N, N], np.int32)
    want = refc.make_kv_export_program(baxes, saxes)(tree, ids[:, None])
    got = paged.kv_export(pool, torch.from_numpy(ids))
    order = [n for n in paged.MIGRATE_LEAVES if n in pool.leaves()]
    assert len(got) == len(want) == len(order)
    for n, mine, theirs in zip(order, got, want):
        _close(mine.numpy(), theirs, n)

    rng = np.random.default_rng(1)
    src = [np.asarray(x) for x in want]
    new = [(rng.integers(-127, 128, size=x.shape, dtype=np.int8)
            if x.dtype == np.int8 else
            rng.standard_normal(x.shape).astype(x.dtype)) for x in src]
    dst = np.array([2, 4, N, N, N, N, N, N], np.int32)
    want_pool = refc.make_kv_import_program(baxes, saxes)(
        tree, dst[:, None], tuple(jnp.asarray(x) for x in new))
    paged.kv_import(pool, torch.from_numpy(dst),
                    [torch.from_numpy(x) for x in new])
    for n, leaf in pool.leaves().items():
        _close(leaf[:, :N].numpy(), want_pool[names[n]], n)


def test_logits_take_set_match_reference():
    torch, _, _, continuous, _, _ = _port()
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 16)).astype(np.float32)
    row = rng.standard_normal(16).astype(np.float32)
    want_row = refc.make_logits_take_program()(jnp.asarray(logits),
                                               np.int32(2))
    want = refc.make_logits_set_program()(jnp.asarray(logits), row,
                                          np.int32(1))
    # the port's logits hold one scratch row past the slots
    mine = torch.from_numpy(np.concatenate([logits, np.zeros((1, 16),
                                                             np.float32)]))
    _close(continuous.logits_take(mine, 2).numpy(), want_row, "take")
    continuous.logits_set(mine, torch.from_numpy(row), 1)
    continuous.logits_set(mine, torch.from_numpy(row), 4)  # the scratch row
    _close(mine[:4].numpy(), want, "set")


# -- migration parity -----------------------------------------------------------


def test_mid_decode_migration_matches_reference(models, reference):
    src, dst = _engine(models), _engine(models)
    try:
        req = src.submit(LONG, max_new_tokens=40)
        snap = _export_after(src, req, 3)
        assert dst.import_sequence(snap, req=req) is req
        src.release_sequence(req)
        assert req.wait(WAIT_S) == reference["long40"]
        _assert_clean(src, dst)
        want = reference["migrate_stats"]
        assert {k: src.stats()[k] for k in MIGRATE_KEYS} == want["src"]
        assert {k: dst.stats()[k] for k in MIGRATE_KEYS} == want["dst"]
        assert src.kv_migrate_bytes_total > 0
        assert dst.kv_migrate_bytes_total > 0
    finally:
        src.stop()
        dst.stop()


def test_mid_prefill_migration_matches_reference(models, reference):
    """A sequence exported between prefill chunks (the source's scheduler
    stepped one dispatch at a time) runs its remaining chunks on the
    destination."""
    pacer = _Pacer()
    src = _engine(models, admission_policy=pacer, **CHUNKED)
    dst = _engine(models, **CHUNKED)
    try:
        parked = src.submit(_Pacer.PROMPT, max_new_tokens=4)
        pacer.parked(1)
        busy = src.submit(SHORT, max_new_tokens=12)
        req = src.submit(LONG, max_new_tokens=24)
        while src.prefill_chunks_dispatched < 3:  # SHORT's, LONG's 2
            pacer.step()
        snap = pacer.call(src, lambda: src.export_sequence(req))
        assert snap["phase"] == "prefill" and not snap["generated"]
        assert 0 < snap["position"] < len(LONG)
        assert dst.import_sequence(snap, req=req) is req
        pacer.call(src, lambda: src.release_sequence(req))
        pacer.release()
        parked.cancel()
        assert req.wait(WAIT_S) == reference["chunked_long24"]
        assert busy.wait(WAIT_S) == reference["chunked_short12"]
        _assert_clean(src, dst)
    finally:
        pacer.release()
        src.stop()
        dst.stop()


def test_speculative_migration_matches_reference(models, reference):
    """The residual ban and the front travel with the sequence (the
    pipeline runs at depth 1, and the export lands the in-flight verify
    first)."""
    src = _engine(models, decode_chunk=1, spec_k=4)
    dst = _engine(models, decode_chunk=1, spec_k=4)
    try:
        req = src.submit(LOOPY, max_new_tokens=96)
        snap = _export_after(src, req, 2)
        dst.import_sequence(snap, req=req)
        src.release_sequence(req)
        assert req.wait(WAIT_S) == reference["loopy96"]
        _assert_clean(src, dst)
    finally:
        src.stop()
        dst.stop()


def test_int8_kv_migration_matches_reference(models, reference):
    """int8 codes and their scale leaves move together."""
    src, dst = _engine(models, quant=True), _engine(models, quant=True)
    try:
        req = src.submit(LONG, max_new_tokens=40)
        snap = _export_after(src, req, 3)
        torch = _port()[0]
        assert [x.dtype for x in snap["blocks"][0]] == [
            torch.int8, torch.float32, torch.int8, torch.float32]
        dst.import_sequence(snap, req=req)
        src.release_sequence(req)
        assert req.wait(WAIT_S) == reference["int8_long40"]
        _assert_clean(src, dst)
    finally:
        src.stop()
        dst.stop()


def test_drain_moves_every_live_sequence(models, reference):
    """``migrate_live_sequences`` empties the source: it freezes every
    live sequence first, so each moves, none fails, and each continues to
    the reference's tokens."""
    src, dst = _engine(models), _engine(models)
    try:
        r1 = src.submit(LONG, max_new_tokens=40)
        r2 = src.submit(SHORT, max_new_tokens=40)
        _wait_tokens(r1, 2)
        _wait_tokens(r2, 2)
        moved, failed = _port()[3].migrate_live_sequences(src, dst)
        assert failed == reference["drain_failed"] == 0
        assert moved == 2
        assert r1.wait(WAIT_S) == reference["long40"]
        assert r2.wait(WAIT_S) == reference["short40"]
        _assert_clean(src, dst)
        assert src.stats()["kv_migrate_latency_ms_count"] == moved
        assert dst.stats()["kv_migrations_total"] == moved
        assert all(not b for b in src._slot_blocks)
    finally:
        src.stop()
        dst.stop()


def test_held_import_then_resume(models, reference):
    """``hold=True`` installs the sequence frozen: it decodes only after
    ``resume_sequence``, from the logits row it arrived with."""
    src, dst = _engine(models), _engine(models)
    try:
        req = src.submit(LONG, max_new_tokens=40)
        snap = _export_after(src, req, 3)
        n = len(req.tokens)
        assert dst.import_sequence(snap, req=req, hold=True) is req
        src.release_sequence(req)
        # a neighbour decodes on the destination while the import is held
        other = dst.submit(SHORT, max_new_tokens=12)
        assert other.wait(WAIT_S) == reference["short12"]
        assert len(req.tokens) == n and not req.done.is_set()
        dst.resume_sequence(req)
        assert req.wait(WAIT_S) == reference["long40"]
        _assert_clean(src, dst)
    finally:
        src.stop()
        dst.stop()


# -- copy then cutover ----------------------------------------------------------


def test_destination_exhaustion_raises_and_source_resumes(models, reference):
    src = _engine(models)
    dst = _engine(models, num_slots=2, num_blocks=2)
    try:
        req = src.submit(LONG, max_new_tokens=40)
        snap = _export_after(src, req, 3)
        with pytest.raises(RuntimeError, match="blocks"):
            dst.import_sequence(snap, req=req)
        assert dst.stats()["kv_blocks_free"] == 2
        src.resume_sequence(req)
        assert req.wait(WAIT_S) == reference["long40"]
        assert len(req.tokens) == 40
        _assert_clean(src, dst)
    finally:
        src.stop()
        dst.stop()


def test_released_sequence_stays_prefix_matchable(models):
    src = _engine(models, prefix_cache=True, min_prefix=8)
    dst = _engine(models, prefix_cache=True, min_prefix=8)
    try:
        req = src.submit(LONG, max_new_tokens=24)
        snap = _export_after(src, req, 2)
        dst.import_sequence(snap, req=req)
        src.release_sequence(req)
        req.wait(WAIT_S)
        src.generate(LONG, max_new_tokens=4, timeout=WAIT_S)
        assert src.prefix_hits >= 1
        assert src.stats()["prefix_block_hits_total"] >= 1
        _assert_clean(src, dst)
    finally:
        src.stop()
        dst.stop()


def test_resume_after_other_slots_decoded(models, reference):
    """Every decode dispatch rewrites every slot's logits row: a frozen
    slot's row is stashed at the freeze, a second export reads the stash,
    and the resume reinstalls it."""
    torch = _port()[0]
    src = _engine(models)
    try:
        victim = src.submit(SHORT, max_new_tokens=40)
        noisy = src.submit(LONG, max_new_tokens=40)
        snap1 = _export_after(src, victim, 2)
        n = len(noisy.tokens)
        _wait_tokens(noisy, n + 6)
        snap2 = src.export_sequence(victim)
        assert torch.equal(snap1["logits"], snap2["logits"])
        src.resume_sequence(victim)
        assert victim.wait(WAIT_S) == reference["short40"]
        assert noisy.wait(WAIT_S) == reference["long40"]
        _assert_clean(src)
    finally:
        src.stop()


def test_cancel_while_frozen_frees_the_slot(models):
    src = _engine(models)
    try:
        req = src.submit(LONG, max_new_tokens=40)
        _export_after(src, req, 2)
        req.cancel()
        src.resume_sequence(req)  # a no-op for a cancelled request
        deadline = time.time() + WAIT_S
        while any(r is not None for r in src._slots):
            assert time.time() < deadline
            time.sleep(0.01)
        _assert_clean(src)
        assert src.stats()["kv_blocks_free"] == src.num_blocks
    finally:
        src.stop()


# -- the tier ladder and disaggregation -----------------------------------------


def test_tiered_engine_matches_reference(models, reference):
    """Tokens and the quota's admission order equal the reference
    ladder's: the short request admits ahead of the second long one."""
    _, _, _, continuous, _, _ = _port()
    cfg, model = models[False]
    kw = {k: v for k, v in TIERS.items() if k not in ("tier_lens",
                                                      "tier_slots")}
    tiered = continuous.TieredEngine(
        cfg, model, tier_lens=TIERS["tier_lens"],
        tier_slots=TIERS["tier_slots"], device="cpu", **kw)
    try:
        tiered.warmup([(1, 32), (1, 64)])
        tokens, short_first = _tier_order(tiered)
        assert (tokens, short_first) == reference["tiered"]
        assert short_first
        st = tiered.stats()
        assert [c["quota"] for c in st["classes"]] == [1, 1]
        assert st["graph_captures_total"] == 0
    finally:
        tiered.stop()


def test_disaggregated_pool_matches_reference(models, reference):
    """One prefill engine, two decode engines, in process: each sequence is
    prefilled on the first and decoded on a second, with the tokens of
    the reference's mixed engine."""
    _, _, _, continuous, _, runtime = _port()
    cfg, model = models[False]
    pool = continuous.DisaggregatedPool(cfg, model, prefill_replicas=1,
                                        decode_replicas=2, device="cpu",
                                        **CHUNKED)
    ledger = runtime.BlockLedger()
    for eng in pool.pools:
        eng.attach_block_ledger(ledger)
    try:
        pool.warmup([(1, 32), (1, 64)])
        assert pool.generate(LONG, max_new_tokens=24,
                             timeout=WAIT_S) == reference["chunked_long24"]
        assert pool.generate(SHORT, max_new_tokens=12,
                             timeout=WAIT_S) == reference["chunked_short12"]
        # the handoff worker records a latency after the source released
        # the sequence, which may land after the destination finished it
        deadline = time.time() + WAIT_S
        while pool.stats()["kv_migrate_latency_ms_count"] < 2:
            assert time.time() < deadline, "a handoff was never recorded"
            time.sleep(0.01)
        st = pool.stats()
        assert st["kv_migrations_total"] == 2
        assert st["kv_migrate_latency_ms_count"] == 2
        assert st["graph_captures_total"] == 0
        assert all(e.prefill_chunks_dispatched == 0 for e in pool.decode)
        assert sum(e.tokens_emitted for e in pool.decode) >= 30
        assert pool.tier_pressure()["decode_replicas"] == 2
        for eng in pool.pools:
            assert eng.audit_blocks() == []
        assert ledger.leaked_total == 0 and not ledger.conservation_errors
    finally:
        pool.stop()


def test_reference_snapshot_continues_in_the_port(models, reference):
    """A snapshot the reference engine exported mid-decode imports into
    the port's engine as a fresh request. Leaf mapping: each reference
    block is [cached_key, cached_value], numpy [1, layers, block_size,
    kv_heads, head_dim] (its tree order), which is the port's
    ``MIGRATE_LEAVES`` order and layout (k, v); the logits row is numpy
    [vocab]."""
    snap = reference["snapshot"]
    assert [a.shape for a in snap["blocks"][0]] == [
        (1, 2, 16, 2, 16), (1, 2, 16, 2, 16)]
    dst = _engine(models)
    try:
        req = dst.import_sequence(snap)
        assert req.prompt == snap["prompt"]
        out = req.wait(WAIT_S)
        assert out[:len(snap["generated"])] == snap["generated"]
        assert out == reference["long40"]
        _assert_clean(dst)
    finally:
        dst.stop()
