"""The KV tiers of the port's serving engine against the reference's, f32
``tiny()`` weights carried across with ``convert.state_dict_from_jax``:

- the host tier's ``HostBlockPool`` (the reference's cases, and one
  scripted run against the reference's pool) and the ``BlockLedger``'s
  host-tier conservation check;
- the port's ``KvSpillStore`` (atomic publish, verify on read, a torn
  payload detected, an unreadable manifest refused, stale staging
  collected); a spill either framework's store writes is read by the
  other's, with the same manifest; bfloat16 leaves round-trip with
  ``ml_dtypes`` unimportable;
- hibernate and thaw on the same engine, on another engine and from a torn
  spill (re-prefilled), and a spill/restore through the host tier: the
  reference engine's greedy tokens, and its ``kv_spills_total``,
  ``kv_thaws_total``, ``kv_thaws_degraded_total`` and ``kv_host_*``
  counters for the same requests;
- a prefix exported by one engine and installed into another.

Timing: hibernation waits for a token count ``n`` of a request with at
least ``8 n`` new tokens; the mid-prefill one steps the scheduler one
dispatch at a time (``_Pacer``). Every engine attaches a ``BlockLedger`` that must
count no leak, and warms its shapes. Each reference engine runs once per
module.
"""

import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.analysis.runtime import BlockLedger as RefLedger
from kubeflow_tpu.chaos.plan import FaultPlan
from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.serving import continuous as refc
from kubeflow_tpu.serving import paged as refp
from kubeflow_tpu.serving import storage as refs

WAIT_S = 300
PROMPT = list(range(1, 41))  # 40 tokens: 2.5 blocks at block_size 16
NEW = 80
LONG = list(range(1, 65))    # 64 tokens = 4 blocks
ENGINE = dict(num_slots=4, decode_chunk=2, prefix_cache=True, block_size=16)
HOST = dict(ENGINE, num_blocks=16, host_blocks=32, host_watermark=1.0)
CHURN = [[100 + i, 101 + i, 102 + i] * 12 for i in range(6)]
TIER_KEYS = ("kv_spills_total", "kv_thaws_total", "kv_thaws_degraded_total",
             "kv_spill_verify_failures_total", "kv_migrations_total")
HOST_KEYS = ("kv_blocks_host_tier", "kv_host_spills_total",
             "kv_host_restores_total", "kv_host_evictions_total",
             "kv_spills_total", "kv_thaws_total", "prefix_hits")


def _port():
    import torch

    from kubeflow_tpu_torch.analysis import runtime
    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import continuous, paged, storage

    torch.set_num_threads(1)
    return torch, llama, convert, continuous, paged, storage, runtime


@pytest.fixture(scope="module")
def weights():
    cfg = ref.tiny()
    params = ref.Llama(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


@pytest.fixture(scope="module")
def model(weights):
    """(the port's cfg, one port Llama shared by its engines)."""
    _, llama, convert, *_ = _port()
    cfg = llama.tiny()
    m = llama.Llama(cfg, device="cpu")
    m.load_state_dict(convert.state_dict_from_jax(weights, cfg))
    return cfg, m


def _submit_until(eng, prompt, new, n):
    req = eng.submit(prompt, max_new_tokens=new)
    deadline = time.time() + WAIT_S
    while len(req.tokens) < n:
        assert time.time() < deadline, "engine made no progress"
        time.sleep(0.002)
    return req


def _host_scenario(eng):
    """A sequence spilled to the host tier at retirement, the pool churned
    until its blocks are reused, then the same prompt again (restored from
    host RAM). Returns the last tokens."""
    eng.generate(LONG, max_new_tokens=8, timeout=WAIT_S)
    deadline = time.time() + WAIT_S
    while eng.stats()["kv_blocks_host_tier"] == 0:
        assert time.time() < deadline, "the host tier never spilled"
        time.sleep(0.01)
    for p in CHURN:
        eng.generate(p, max_new_tokens=4, timeout=WAIT_S)
    return eng.generate(LONG, max_new_tokens=8, timeout=WAIT_S)


@pytest.fixture(scope="module")
def reference(weights, tmp_path_factory):
    """The reference engine's uninterrupted tokens, and its tier counters
    after a same-engine hibernate/thaw, a torn-spill thaw and the host-tier
    scenario."""
    cfg = ref.tiny()
    out = {}
    eng = refc.ContinuousEngine(cfg, weights, **ENGINE)
    eng.attach_block_ledger(RefLedger())
    try:
        out["tokens"] = eng.generate(PROMPT, max_new_tokens=NEW,
                                     timeout=WAIT_S)
        out["long8"] = eng.generate(LONG, max_new_tokens=8, timeout=WAIT_S)
        store = refs.KvSpillStore(str(tmp_path_factory.mktemp("ref")))
        eng.attach_spill_store(store)
        req = _submit_until(eng, PROMPT, NEW, 10)
        assert eng.hibernate_sequence(req, "s")
        req2, _ = eng.thaw_sequence("s", req=req)
        assert req2.wait(WAIT_S) == out["tokens"]
        out["thaw"] = {k: eng.stats()[k] for k in TIER_KEYS}
        req = _submit_until(eng, PROMPT, NEW, 10)
        assert eng.hibernate_sequence(req, "t")
        refs.KvSpillStore._tear(store._entry_dir("t"), 64)
        req2, info = eng.thaw_sequence("t")
        assert info["degraded"] and req2.wait(WAIT_S) == out["tokens"]
        out["degraded"] = {k: eng.stats()[k] for k in TIER_KEYS}
    finally:
        eng.stop()
    eng = refc.ContinuousEngine(cfg, weights, **HOST)
    eng.attach_block_ledger(RefLedger())
    try:
        out["host_tokens"] = _host_scenario(eng)
    finally:
        eng.stop()
    out["host"] = {k: eng.stats()[k] for k in HOST_KEYS}
    return out


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


def _engine(model, **kw):
    *_, continuous, _, _, runtime = _port()
    cfg, m = model
    eng = continuous.ContinuousEngine(cfg, m, device="cpu", **{**ENGINE,
                                                                **kw})
    eng.attach_block_ledger(runtime.BlockLedger())
    eng.warmup([(1, 32), (1, 64)])
    return eng


def _assert_clean(*engines):
    for eng in engines:
        assert eng.audit_blocks() == []
        st = eng.stats()
        assert st["kv_blocks_leaked_total"] == 0
        assert st["graph_captures_total"] == 0
        assert eng.block_ledger.conservation_errors == []


# -- the host tier's pool ---------------------------------------------------------


def _block(v, n=3):
    torch = _port()[0]
    return [torch.full((1, 2), float(v)) for _ in range(n)]


def test_host_pool_put_match_take():
    pool = _port()[4].HostBlockPool(capacity_blocks=8, block_size=4)
    toks = [1, 2, 3, 4, 5, 6, 7, 8]
    hid = pool.put(toks, [_block(0), _block(1)])
    assert hid >= 0 and pool.blocks_held == 2
    assert pool.bytes_held == 2 * 3 * 8
    got, n = pool.match(np.asarray(toks, np.int64), len(toks))
    assert got == hid and n == 8
    blks = pool.take(hid, 2)
    assert len(blks) == 2 and float(blks[1][0][0, 0]) == 1.0
    _, n2 = pool.match(np.asarray([1, 2, 3, 4, 99], np.int64), 5)
    assert n2 == 4


def test_host_pool_lru_eviction_and_touch():
    pool = _port()[4].HostBlockPool(capacity_blocks=4, block_size=4)
    a = pool.put([1] * 8, [_block(0), _block(1)])
    b = pool.put([2] * 8, [_block(2), _block(3)])
    assert pool.take(a, 1) is not None  # touch a: b is now the LRU entry
    c = pool.put([3] * 8, [_block(4), _block(5)])
    assert pool.blocks_held == 4 and pool.evictions_total == 1
    assert pool.take(b, 1) is None
    assert pool.take(a, 1) is not None and pool.take(c, 1) is not None


def test_host_pool_entry_wider_than_pool_keeps_its_head():
    pool = _port()[4].HostBlockPool(capacity_blocks=2, block_size=4)
    assert pool.put(list(range(16)), [_block(i) for i in range(4)]) >= 0
    assert pool.blocks_held == 2
    _, n = pool.match(np.asarray(list(range(16)), np.int64), 16)
    assert n == 8


def test_host_pool_contains_prefix():
    pool = _port()[4].HostBlockPool(capacity_blocks=8, block_size=4)
    pool.put([5] * 8, [_block(0), _block(1)])
    assert pool.contains_prefix([5] * 8, min_tokens=8)
    assert not pool.contains_prefix([6] * 8, min_tokens=8)


def _host_script(cls, leaf):
    """One scripted run of the host pool's verbs; every result."""
    pool = cls(5, 4)
    out = [pool.put(list(range(12)), [[leaf(i)] for i in range(3)]),
           pool.put([9] * 8, [[leaf(7)], [leaf(8)]])]
    out.append(pool.match(np.arange(12, dtype=np.int64), 11))
    out.append(len(pool.take(out[0], 2)))
    out.append(pool.put([4] * 12, [[leaf(1)]] * 3))  # evicts two entries
    out.append(pool.take(out[1], 1))
    out.append(pool.contains_prefix([4] * 8, 8))
    out.append(pool.put([], []))
    out.append(pool.stats())
    return out


def test_host_pool_matches_reference():
    torch = _port()[0]
    want = _host_script(refp.HostBlockPool,
                        lambda v: np.full((1, 2), v, np.float32))
    got = _host_script(_port()[4].HostBlockPool,
                       lambda v: torch.full((1, 2), float(v)))
    assert got == want


def test_ledger_host_conservation():
    runtime = _port()[6]
    ledger = runtime.BlockLedger()
    pool = ledger.attach_host_pool(_port()[4].HostBlockPool(4, 4))
    pool.put([1] * 8, [_block(0), _block(1)])
    pool.put([2] * 8, [_block(2), _block(3)])
    # a three-block entry: two evictions before the loop converges, which
    # is not an over-capacity error
    pool.put([3] * 12, [_block(4), _block(5), _block(6)])
    assert pool.blocks_held == 3 and pool.evictions_total == 2
    assert ledger.conservation_errors == [] and ledger.audit_host(pool) == []
    pool.blocks_held += 3  # gauge drift around the wrapped verbs
    errs = ledger.audit_host(pool)
    assert errs and "host tier holds" in errs[0]
    assert pool.blocks_held == 3 and ledger.audit_host(pool) == []


def test_host_pool_concurrent_puts_keep_the_books():
    """Spills land from the host-tier worker while the scheduler matches
    and takes: eight threads at a short switch interval, and the gauges
    must still equal the entries' blocks."""
    ledger = _port()[6].BlockLedger()
    pool = ledger.attach_host_pool(_port()[4].HostBlockPool(16, 4))
    blocks = [_block(0), _block(1)]

    def work(k):
        for i in range(50):
            toks = [k, i] * 4
            hid = pool.put(toks, blocks)
            pool.match(np.asarray(toks, np.int64), 8)
            pool.take(hid, 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert pool.spills_total == 400
    assert pool.blocks_held == sum(
        len(e["blocks"]) for e in pool._seqs.values()) <= 16
    assert ledger.conservation_errors == [] and ledger.audit_host(pool) == []


# -- the storage tier ---------------------------------------------------------


def _snapshot(nblocks=2, torch_leaves=True, dtype=None):
    torch = _port()[0]

    def leaf(shape, v):
        a = np.full(shape, v, np.float32)
        if not torch_leaves:
            return a
        t = torch.from_numpy(a)
        return t.to(dtype) if dtype is not None else t

    snap = {
        "v": 1, "phase": "decode", "block_size": 4,
        "prompt": [1, 2, 3, 4, 5, 6, 7, 8], "generated": [9, 10],
        "position": 10, "remaining": 6, "max_new_tokens": 8,
        "temperature": 0.0, "top_p": 1.0, "top_k": 0, "priority": 1,
        "spec_ban": -1,
        "blocks": [[leaf((1, 2, 4), i), leaf((1, 4, 3), i + 10)]
                   for i in range(nblocks)],
        "logits": leaf((8,), 0.5),
    }
    return snap


def _store(path, **kw):
    return _port()[5].KvSpillStore(str(path), **kw)


def test_spill_store_round_trip(tmp_path):
    torch = _port()[0]
    store = _store(tmp_path)
    store.write("s1", _snapshot(), block_keys=[11, 22])
    assert store.contains("s1") and store.session_count() == 1
    assert store.sessions() == ["s1"]
    snap, ok = store.read("s1")
    assert ok and snap["position"] == 10 and len(snap["blocks"]) == 2
    assert torch.equal(snap["blocks"][1][1], torch.full((1, 4, 3), 11.0))
    assert torch.equal(snap["logits"], torch.full((8,), 0.5))
    assert store.read_manifest("s1")["block_keys"] == [11, 22]
    assert store.stats() == {"kv_spill_writes_total": 1,
                             "kv_spill_reads_total": 1,
                             "kv_spill_verify_failures_total": 0}


def test_spill_store_overwrite_newest_wins(tmp_path):
    store = _store(tmp_path)
    store.write("s", _snapshot())
    newer = _snapshot()
    newer["position"] = 99
    store.write("s", newer)
    snap, ok = store.read("s")
    assert ok and snap["position"] == 99 and store.session_count() == 1


def test_spill_store_old_entry_debris_hidden_and_collected(tmp_path):
    store = _store(tmp_path)
    key = os.path.basename(store.write("s", _snapshot()))
    debris = os.path.join(str(tmp_path), f".old-{key}-deadbeef")
    os.makedirs(debris)
    with open(os.path.join(debris, "spill.json"), "w") as f:
        f.write("{}")
    assert store.session_count() == 1 and store.sessions() == ["s"]
    store.write("s", _snapshot())
    assert not os.path.exists(debris) and store.session_count() == 1


def test_spill_store_torn_payload_is_never_attached(tmp_path):
    store = _store(tmp_path)
    entry = store.write("s", _snapshot())
    store._tear(entry, 32)
    snap, ok = store.read("s")
    assert not ok and "blocks" not in snap and "logits" not in snap
    assert snap["prompt"] == [1, 2, 3, 4, 5, 6, 7, 8]
    assert store.verify_failures_total == 1


def test_spill_store_unreadable_manifest_raises(tmp_path):
    storage = _port()[5]
    store = _store(tmp_path)
    entry = store.write("s", _snapshot())
    with open(os.path.join(entry, "spill.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(storage.SpillCorrupt):
        store.read("s")
    with pytest.raises(storage.SpillCorrupt):
        store.read_manifest("s")
    with pytest.raises(storage.SpillCorrupt):
        store.read("missing")


def test_spill_store_kill_mid_write_publishes_nothing(tmp_path):
    """The reference's ``FaultPlan`` drives the port's store (a duck-typed
    ``chaos``): a writer killed mid-write leaves only staging debris, which
    the next write of the key collects once it is stale."""
    store = _store(tmp_path,
                   chaos=FaultPlan(seed=5).spill_kill_mid_write("meta"))
    with pytest.raises(Exception, match="killed"):
        store.write("s", _snapshot())
    assert not store.contains("s")
    staging = [n for n in os.listdir(str(tmp_path))
               if n.startswith(".staging-")]
    assert staging
    for n in staging:
        os.utime(os.path.join(str(tmp_path), n), (1, 1))
    store.write("s", _snapshot())
    assert store.contains("s")
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(".staging-")]


def test_spills_cross_between_the_frameworks(tmp_path):
    """A spill the reference writes (numpy leaves) is read by the port's
    store, and the reverse; the two manifests agree but for the time."""
    torch = _port()[0]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    refs.KvSpillStore(str(ref_dir)).write(
        "x", _snapshot(torch_leaves=False), block_keys=[5])
    _store(port_dir).write("x", _snapshot(), block_keys=[5])
    a = refs.KvSpillStore(str(ref_dir)).read_manifest("x")
    b = _store(port_dir).read_manifest("x")
    for m in (a, b):
        m.pop("created")
    assert a == b
    snap, ok = _store(ref_dir).read("x")
    assert ok and torch.equal(snap["blocks"][0][1],
                              torch.full((1, 4, 3), 10.0))
    back, ok = refs.KvSpillStore(str(port_dir)).read("x")
    assert ok
    np.testing.assert_array_equal(back["blocks"][1][0],
                                  np.full((1, 2, 4), 1.0, np.float32))
    np.testing.assert_array_equal(back["logits"],
                                  np.full(8, 0.5, np.float32))


def test_bf16_spill_round_trips_without_ml_dtypes(tmp_path, monkeypatch):
    torch = _port()[0]
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    snap = _snapshot(dtype=torch.bfloat16)
    snap["blocks"][0][0][0, 0, 0] = 1.0078125  # needs bf16's 8-bit mantissa
    store = _store(tmp_path)
    store.write("b", snap)
    assert store.read_manifest("b")["leaves"][0]["dtype"] == "bfloat16"
    back, ok = store.read("b")
    assert ok
    for got, want in zip(back["blocks"][0] + [back["logits"]],
                         snap["blocks"][0] + [snap["logits"]]):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# -- hibernate and thaw ---------------------------------------------------------


def test_same_engine_thaw_matches_reference(model, reference, tmp_path):
    eng = _engine(model)
    try:
        eng.attach_spill_store(_store(tmp_path))
        req = _submit_until(eng, PROMPT, NEW, 10)
        free = eng.stats()["kv_blocks_free"]
        assert eng.hibernate_sequence(req, "s")
        st = eng.stats()
        assert st["kv_blocks_free"] > free
        assert st["kv_sessions_hibernated"] == 1 and not req.done.is_set()
        req2, info = eng.thaw_sequence("s", req=req)
        assert req2 is req and not info["degraded"]
        assert req.wait(WAIT_S) == reference["tokens"]
        assert {k: eng.stats()[k] for k in TIER_KEYS} == reference["thaw"]
        assert eng.stats()["kv_sessions_hibernated"] == 0
        _assert_clean(eng)
    finally:
        eng.stop()


def test_cross_engine_thaw_matches_reference(model, reference, tmp_path):
    """Hibernate on A, stop A, thaw on a fresh B from the store alone."""
    store = _store(tmp_path)
    a = _engine(model)
    a.attach_spill_store(store)
    req = _submit_until(a, PROMPT, NEW, 10)
    assert a.hibernate_sequence(req, "x")
    delivered = list(req.tokens)
    _assert_clean(a)
    a.stop()
    b = _engine(model)
    try:
        b.attach_spill_store(store)
        req2, info = b.thaw_sequence("x")
        out = req2.wait(WAIT_S)
        assert out == reference["tokens"]
        assert out[:len(delivered)] == delivered == info["tokens"]
        assert b.stats()["kv_thaws_total"] == 1
        _assert_clean(b)
    finally:
        b.stop()


def test_degraded_thaw_matches_reference(model, reference, tmp_path):
    """A torn spill is never scattered: the session re-prefills from the
    manifest's tokens, with the same greedy continuation."""
    eng = _engine(model)
    try:
        store = _store(tmp_path)
        eng.attach_spill_store(store)
        req = _submit_until(eng, PROMPT, NEW, 10)
        assert eng.hibernate_sequence(req, "s")
        req2, _ = eng.thaw_sequence("s", req=req)
        assert req2.wait(WAIT_S) == reference["tokens"]
        req = _submit_until(eng, PROMPT, NEW, 10)
        assert eng.hibernate_sequence(req, "t")
        store._tear(store._entry_dir("t"), 64)
        req2, info = eng.thaw_sequence("t")
        assert info["degraded"]
        assert req2.wait(WAIT_S) == reference["tokens"]
        assert {k: eng.stats()[k] for k in TIER_KEYS} == \
            reference["degraded"]
        _assert_clean(eng)
    finally:
        eng.stop()


def test_hibernate_of_a_finished_request_does_nothing(model, tmp_path):
    eng = _engine(model)
    try:
        store = _store(tmp_path)
        eng.attach_spill_store(store)
        req = eng.submit([3, 4, 5], max_new_tokens=4)
        req.wait(WAIT_S)
        assert eng.hibernate_sequence(req, "done") is False
        assert not store.contains("done")
    finally:
        eng.stop()


def test_mid_prefill_hibernate_resumes(model, reference, tmp_path):
    """Hibernated between prefill chunks, the session finishes its
    admission on another engine."""
    store = _store(tmp_path)
    pacer = _Pacer()
    a = _engine(model, prefill_budget=4, prefix_cache=False,
                admission_policy=pacer)
    try:
        a.attach_spill_store(store)
        a.submit(_Pacer.PROMPT, max_new_tokens=4)
        pacer.parked(1)
        req = a.submit(PROMPT, max_new_tokens=NEW)
        while a.prefill_chunks_dispatched < 2:
            pacer.step()
        assert pacer.call(a, lambda: a.hibernate_sequence(req, "p"))
    finally:
        pacer.release()
        a.stop()
    meta = store.read_manifest("p")["meta"]
    assert meta["phase"] == "prefill" and 0 < meta["position"] < len(PROMPT)
    b = _engine(model, prefill_budget=4, prefix_cache=False)
    try:
        b.attach_spill_store(store)
        req2, _ = b.thaw_sequence("p")
        assert req2.wait(WAIT_S) == reference["tokens"]
        _assert_clean(b)
    finally:
        b.stop()


def test_idle_sessions_lists_quiet_session_requests(model):
    eng = _engine(model)
    try:
        req = eng.submit(PROMPT, max_new_tokens=NEW, session_id="q")
        anon = eng.submit(PROMPT, max_new_tokens=NEW)
        now = time.perf_counter() + 3600
        deadline = time.time() + WAIT_S
        while req not in eng.idle_sessions(1.0, now=now):
            assert time.time() < deadline
            time.sleep(0.002)
        assert anon not in eng.idle_sessions(1.0, now=now)
        assert eng.idle_sessions(3600 * 2, now=now) == []
        req.cancel()
        anon.cancel()
    finally:
        eng.stop()


# -- the host tier in the engine ------------------------------------------------


def test_host_tier_spill_and_restore_match_reference(model, reference):
    eng = _engine(model, num_blocks=16, host_blocks=32, host_watermark=1.0)
    try:
        assert _host_scenario(eng) == reference["host_tokens"] == \
            reference["long8"]
        _assert_clean(eng)
    finally:
        eng.stop()
    st = eng.stats()
    assert {k: st[k] for k in HOST_KEYS} == reference["host"]
    assert st["kv_host_restores_total"] >= 1
    assert eng.block_ledger.audit_host(eng._host_pool) == []


def test_no_host_spill_without_pressure(model):
    eng = _engine(model, host_blocks=32, host_watermark=0.0)
    try:
        eng.generate(LONG, max_new_tokens=8, timeout=WAIT_S)
    finally:
        eng.stop()
    assert eng.stats()["kv_blocks_host_tier"] == 0


def test_install_prefix_across_engines(model, reference):
    """Engine B installs the prefix blocks engine A exported: B's first
    admission of the prompt shares them instead of prefilling."""
    a, b = _engine(model), _engine(model)
    try:
        a.generate(LONG, max_new_tokens=8, timeout=WAIT_S)
        covered, blocks = a.export_prefix_blocks(LONG)
        assert len(covered) == 64 and len(blocks) == 4
        assert b.install_prefix(covered, blocks)
        st = b.stats()
        assert st["kv_blocks_free"] == st["kv_blocks_total"]
        assert b.generate(LONG, max_new_tokens=8,
                          timeout=WAIT_S) == reference["long8"]
        st = b.stats()
        assert st["prefix_hits"] == 1 and st["prefix_tokens_saved"] >= 48
        assert st["kv_thaws_total"] == 1
        census = b.prefix_census()
        assert any(len(r) >= 64 for r in census)
        _assert_clean(a, b)
    finally:
        a.stop()
        b.stop()


def test_prefix_digest_matches_reference():
    paged = _port()[4]
    records = [np.asarray(LONG, np.int64), np.asarray(PROMPT, np.int64)]
    assert paged.prefix_digest(records, 16) == refp.prefix_digest(records, 16)
    assert paged.prefix_digest(records, 16, max_entries=2) == \
        refp.prefix_digest(records, 16, max_entries=2)
