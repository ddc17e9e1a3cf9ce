"""Built-in rule fixtures: the lint binary validates itself.

The port's copy of ``kubeflow_tpu/analysis/selftest.py``: every
reference fixture has a counterpart here with the same ``name``, the
same ``rule`` and the same expectation, its code in torch's vocabulary
(``.cpu()`` for ``jax.device_get``, ``torch.compile`` for ``jax.jit``),
plus a true-positive/near-miss pair for each torch matcher the
reference has no spelling for (``.cpu()`` past the warmup cut,
``.to("cpu")``, ``torch.cuda.synchronize``, CUDA graph capture in a
loop).

``python -m kubeflow_tpu_torch.analysis --self-test`` runs every fixture
below through the real rule engine in a temp tree — one TRUE POSITIVE
(the rule must fire, with the expected substring in the message) and
one NEAR MISS (the rule must stay silent) per rule — with no pytest in
the loop, so tier-1 CI can smoke the analyzer with nothing but the
interpreter.

The op-table true positive is a SEEDED DRIFT: a published gang op whose
``follow()`` arm was deleted — the exact protocol rot the rule exists
to catch.  The ``host-sync-cross-module`` pair is the call-graph
engine's acceptance case: the blocking helper lives in a DIFFERENT
file than the ``*Engine`` root that reaches it.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

from .astlint import run_lint


@dataclass(frozen=True)
class Fixture:
    rule: str
    name: str          # "<rule>/<true-positive|near-miss>"
    rel: str           # path inside the temp tree (rules scope by path)
    code: str
    expect: int        # minimum findings (0 = must be clean)
    needle: str = ""   # substring every finding message must contain
    #: additional (rel, code) files linted TOGETHER with the main one —
    #: the cross-module fixtures need an effect to live in a different
    #: file than the root that reaches it
    extra: tuple[tuple[str, str], ...] = ()


FIXTURES: tuple[Fixture, ...] = (
    Fixture(
        "host-sync-in-dispatch", "host-sync/true-positive",
        "kubeflow_tpu_torch/serving/_st_dispatch.py",
        """
import torch

class FooEngine:
    def _loop(self):
        return self.buf.cpu()
""",
        1, "host sync"),
    Fixture(
        "host-sync-in-dispatch", "host-sync/near-miss",
        "kubeflow_tpu_torch/serving/_st_dispatch.py",
        """
import torch

class FooEngine:
    def _loop(self):
        return 1

    def debug_dump(self):
        return self.buf.cpu()
""",
        0),
    Fixture(
        "jit-in-loop", "jit-in-loop/true-positive",
        "kubeflow_tpu_torch/serving/_st_jit.py",
        """
import torch

def bad(fns):
    out = []
    for f in fns:
        out.append(torch.compile(f))
    return out
""",
        1, "recompile treadmill"),
    Fixture(
        "jit-in-loop", "jit-in-loop/near-miss",
        "kubeflow_tpu_torch/serving/_st_jit.py",
        """
import torch

def good(fns, cache):
    def getter(k):
        if k not in cache:
            cache[k] = torch.compile(fns[k])
        return cache[k]
    out = []
    for k in range(4):
        out.append(getter(k)(k))
    return out
""",
        0),
    Fixture(
        "lock-order", "lock-order/true-positive",
        "kubeflow_tpu_torch/serving/_st_locks.py",
        """
import threading

a_lock = threading.Lock()
b_lock = threading.Lock()

def one():
    with a_lock:
        with b_lock:
            pass

def two():
    with b_lock:
        with a_lock:
            pass
""",
        1, "cycle"),
    Fixture(
        "lock-order", "lock-order/near-miss",
        "kubeflow_tpu_torch/serving/_st_locks.py",
        """
import threading

a_lock = threading.Lock()
b_lock = threading.Lock()

def one():
    with a_lock:
        with b_lock:
            pass

def two():
    with a_lock:
        with b_lock:
            pass
""",
        0),
    Fixture(
        "swallowed-exception", "swallowed/true-positive",
        "kubeflow_tpu_torch/serving/_st_swallow.py",
        """
def f():
    try:
        risky()
    except Exception:
        pass
""",
        1, "blanket"),
    Fixture(
        "swallowed-exception", "swallowed/near-miss",
        "kubeflow_tpu_torch/serving/_st_swallow.py",
        """
def f():
    try:
        risky()
    except Exception as e:
        raise RuntimeError("wrapped") from e
""",
        0),
    Fixture(
        "unsafe-pickle", "pickle/true-positive",
        "kubeflow_tpu_torch/serving/_st_pickle.py",
        """
import pickle

def recv(sock):
    return pickle.loads(sock.recv(4096))
""",
        1, "arbitrary code execution"),
    Fixture(
        "unsafe-pickle", "pickle/near-miss",
        "kubeflow_tpu_torch/serving/_st_pickle.py",
        """
import pickle

def send(obj):
    return pickle.dumps(obj)
""",
        0),
    Fixture(
        "nondaemon-thread", "nondaemon/true-positive",
        "kubeflow_tpu_torch/serving/_st_thread.py",
        """
import threading

def start(work):
    threading.Thread(target=work).start()
""",
        1, "daemon"),
    Fixture(
        "nondaemon-thread", "nondaemon/near-miss",
        "kubeflow_tpu_torch/serving/_st_thread.py",
        """
import threading

def start(work):
    threading.Thread(target=work, daemon=True).start()
""",
        0),
    Fixture(
        "thread-affinity", "thread-affinity/true-positive",
        "kubeflow_tpu_torch/serving/_st_affinity.py",
        """
import threading

class FooEngine:
    def _loop(self):
        self._admit()

    def _admit(self):
        self._waiting.sort()

    def submit(self, req):
        self._waiting.append(req)
""",
        1, "scheduler-owned"),
    Fixture(
        "thread-affinity", "thread-affinity/near-miss",
        "kubeflow_tpu_torch/serving/_st_affinity.py",
        """
import queue

class FooEngine:
    def _loop(self):
        self._service()

    def _service(self):
        kind, a = self._migrate_q.get_nowait()
        self._waiting.append(a)          # scheduler thread: fine

    def submit(self, req):
        self._migrate_q.put(("admit", req))   # the mailbox seam
""",
        0),
    Fixture(
        # autoscaler/reaper orchestration classes are dispatch-path
        # roots — a device fetch inside a sensor read stalls every tick
        "host-sync-in-dispatch", "host-sync-autoscaler/true-positive",
        "kubeflow_tpu_torch/serving/_st_dispatch_scaler.py",
        """
import torch

class FleetAutoscaler:
    def sense(self):
        return self.buf.cpu()
""",
        1, "host sync"),
    Fixture(
        # same body, unrooted class name: planners that never touch the
        # tick path stay out of scope
        "host-sync-in-dispatch", "host-sync-autoscaler/near-miss",
        "kubeflow_tpu_torch/serving/_st_dispatch_scaler.py",
        """
import torch

class AutoscalePlanner:
    def sense(self):
        return self.buf.cpu()
""",
        0),
    Fixture(
        # program artifact classes are dispatch-path roots — a device
        # fetch inside cache bookkeeping puts host work back on the
        # dispatch path every program consult
        "host-sync-in-dispatch", "host-sync-artifact-cache/true-positive",
        "kubeflow_tpu_torch/serving/_st_dispatch_artifacts.py",
        """
import torch

class ProgramArtifactCache:
    def fingerprint(self, buf):
        return buf.cpu()
""",
        1, "host sync"),
    Fixture(
        # suffix match roots *ArtifactCache, not names that merely
        # contain it: an index over the cache dir is host bookkeeping
        # that never runs on the dispatch path
        "host-sync-in-dispatch", "host-sync-artifact-cache/near-miss",
        "kubeflow_tpu_torch/serving/_st_dispatch_artifacts.py",
        """
import torch

class ArtifactCacheIndex:
    def fingerprint(self, buf):
        return buf.cpu()
""",
        0),
    Fixture(
        # every orchestration-class method is an external entry — writing scheduler-owned state from the
        # decision loop is the race the contract forbids
        "thread-affinity", "thread-affinity-autoscaler/true-positive",
        "kubeflow_tpu_torch/serving/_st_affinity_scaler.py",
        """
class FleetAutoscaler:
    def tick(self):
        self._slots.pop()
""",
        1, "scheduler-owned"),
    Fixture(
        # the blessed shape: GIL-copy reads + the engine's public
        # cross-thread API for writes
        "thread-affinity", "thread-affinity-autoscaler/near-miss",
        "kubeflow_tpu_torch/serving/_st_affinity_scaler.py",
        """
class FleetAutoscaler:
    def tick(self):
        live = len(list(self.engine.slots_view()))
        if live == 0:
            self.engine.submit(None)
""",
        0),
    Fixture(
        # the acceptance bar's seeded drift: op "beta" is published but
        # its follow() arm was deleted
        "op-table", "op-table/true-positive",
        "kubeflow_tpu_torch/serving/_st_ops.py",
        """
def leader(ch, toks):
    ch.publish(("alpha", toks))
    ch.publish(("beta", toks))

def follow(channel):
    while True:
        msg = channel.next()
        op = msg[0]
        if op == "alpha":
            continue
        raise RuntimeError(f"unknown gang op {op!r}")
""",
        1, "`beta`"),
    Fixture(
        "op-table", "op-table/near-miss",
        "kubeflow_tpu_torch/serving/_st_ops.py",
        """
def leader(ch, toks):
    ch.publish(("alpha", toks))

def follow(channel):
    while True:
        msg = channel.next()
        op = msg[0]
        if op == "alpha":
            continue
""",
        0),
    Fixture(
        "metrics-contract", "metrics-contract/true-positive",
        "kubeflow_tpu_torch/serving/_st_metrics.py",
        """
class FooEngine:
    def stats(self):
        return {"tokens_emitted": 1, "kv-blocks.free": 2}
""",
        1, "kv-blocks.free"),
    Fixture(
        "metrics-contract", "metrics-contract/near-miss",
        "kubeflow_tpu_torch/serving/_st_metrics.py",
        """
class FooEngine:
    def stats(self):
        out = {"tokens_emitted": 1}
        out["kv_blocks_free"] = 2
        out.setdefault("queue_depth", 0)
        return out
""",
        0),
    Fixture(
        "fault-pairing", "fault-pairing/true-positive",
        "kubeflow_tpu_torch/chaos/_st_faults.py",
        """
class FaultKind:
    CRASH = "crash"
    GHOST = "ghost"

class Fault:
    def __init__(self, kind, at=0.0):
        self.kind = kind

class Plan:
    def crash(self):
        self.faults.append(Fault(FaultKind.CRASH))

    def ghost(self):
        self.faults.append(Fault(FaultKind.GHOST))

    def due(self):
        return [f for f in self.faults if f.kind == FaultKind.CRASH]
""",
        1, "GHOST"),
    Fixture(
        "fault-pairing", "fault-pairing/near-miss",
        "kubeflow_tpu_torch/chaos/_st_faults.py",
        """
class FaultKind:
    CRASH = "crash"

class Fault:
    def __init__(self, kind, at=0.0):
        self.kind = kind

class Plan:
    def crash(self):
        self.faults.append(Fault(FaultKind.CRASH))

    def due(self):
        return [f for f in self.faults if f.kind == FaultKind.CRASH]
""",
        0),
    Fixture(
        # drift shape: a correlated-failure fault whose actuator poll
        # was deleted — the plan builds domain outages
        # nothing ever fires
        "fault-pairing", "fault-pairing-outage/true-positive",
        "kubeflow_tpu_torch/chaos/_st_faults_outage.py",
        """
class FaultKind:
    CRASH = "crash"
    DOMAIN_OUTAGE = "domain_outage"

class Fault:
    def __init__(self, kind, at=0.0, node=None):
        self.kind = kind
        self.node = node

class Plan:
    def crash(self):
        self.faults.append(Fault(FaultKind.CRASH))

    def domain_outage(self, name):
        self.faults.append(Fault(FaultKind.DOMAIN_OUTAGE, node=name))

    def due(self):
        return [f for f in self.faults if f.kind == FaultKind.CRASH]
""",
        1, "DOMAIN_OUTAGE"),
    Fixture(
        # the paired shape: producer factory + a
        # due_domain_outages-style consumer comparison
        "fault-pairing", "fault-pairing-outage/near-miss",
        "kubeflow_tpu_torch/chaos/_st_faults_outage.py",
        """
class FaultKind:
    DOMAIN_OUTAGE = "domain_outage"

class Fault:
    def __init__(self, kind, at=0.0, node=None):
        self.kind = kind
        self.node = node

class Plan:
    def domain_outage(self, name):
        self.faults.append(Fault(FaultKind.DOMAIN_OUTAGE, node=name))

    def due_domain_outages(self):
        return [f.node for f in self.faults
                if f.kind == FaultKind.DOMAIN_OUTAGE and not f.fired]
""",
        0),
    Fixture(
        # the emergency surge path runs on the autoscaler tick — writing scheduler-owned engine state from
        # it is the race the contract forbids, emergency or not
        "thread-affinity", "thread-affinity-emergency/true-positive",
        "kubeflow_tpu_torch/serving/_st_affinity_emergency.py",
        """
class SurgeAutoscaler:
    def emergency_tick(self):
        self._waiting.clear()
""",
        1, "scheduler-owned"),
    Fixture(
        # BackendHealth is NOT a dispatch root (no Engine/Autoscaler/
        # Scaler/Reaper suffix): its lock-guarded circuit dict is its
        # own to mutate from any request thread
        "thread-affinity", "thread-affinity-emergency/near-miss",
        "kubeflow_tpu_torch/serving/_st_affinity_emergency.py",
        """
class BackendHealth:
    def note_failure(self, backend):
        self._waiting.append(backend)
""",
        0),
    Fixture(
        # the persistence core (PERSIST_PATHS) is always in scope — a bare open(final, "w") tears the live file on crash
        "torn-write", "torn-write/true-positive",
        "kubeflow_tpu_torch/serving/storage.py",
        """
import json

def save_index(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
""",
        1, "commit protocol"),
    Fixture(
        # staged write, but the name commits before the payload is
        # durable — the exact page-cache window the protocol closes
        "torn-write", "torn-write-rename/true-positive",
        "kubeflow_tpu_torch/serving/_st_persist.py",
        """
import json
import os

def save_index(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)
""",
        1, "preceding fsync"),
    Fixture(
        # the full protocol: tmp write -> flush+fsync -> atomic replace
        "torn-write", "torn-write/near-miss",
        "kubeflow_tpu_torch/serving/_st_persist.py",
        """
import json
import os

def save_index(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
""",
        0),
    Fixture(
        # blocking work REACHED through a call edge while a lock is
        # held — invisible to lock-order's direct-site check
        "lock-blocking-call", "lock-blocking/true-positive",
        "kubeflow_tpu_torch/serving/_st_lockblock.py",
        """
import os

class BatchWriter:
    def flush_batch(self):
        with self._lock:
            self._flush()

    def _flush(self):
        self._f.flush()
        os.fsync(self._f.fileno())
""",
        1, "while holding"),
    Fixture(
        # the fix shape: drain under the lock, block outside it
        "lock-blocking-call", "lock-blocking/near-miss",
        "kubeflow_tpu_torch/serving/_st_lockblock.py",
        """
import os

class BatchWriter:
    def flush_batch(self):
        with self._lock:
            batch = self._drain()
        self._write(batch)

    def _drain(self):
        out = list(self._pending)
        self._pending.clear()
        return out

    def _write(self, batch):
        self._f.write(b"".join(batch))
        os.fsync(self._f.fileno())
""",
        0),
    Fixture(
        # the call graph's acceptance case: the helper lives one module
        # away from the *Engine root that reaches it
        "host-sync-in-dispatch", "host-sync-cross-module/true-positive",
        "kubeflow_tpu_torch/serving/_st_xmod_a.py",
        """
from ._st_xmod_b import fetch_stats

class FooEngine:
    def _loop(self):
        return fetch_stats(self.buf)
""",
        1, "host sync",
        extra=(("kubeflow_tpu_torch/serving/_st_xmod_b.py", """
import torch

def fetch_stats(buf):
    return buf.cpu()
"""),)),
    Fixture(
        # same helper, reached only from a non-root method: reachability
        # (not mere import) is what puts an effect on the dispatch path
        "host-sync-in-dispatch", "host-sync-cross-module/near-miss",
        "kubeflow_tpu_torch/serving/_st_xmod_a.py",
        """
from ._st_xmod_b import fetch_stats

class FooEngine:
    def _loop(self):
        return 1

    def debug_dump(self):
        return fetch_stats(self.buf)
""",
        0, "",
        extra=(("kubeflow_tpu_torch/serving/_st_xmod_b.py", """
import torch

def fetch_stats(buf):
    return buf.cpu()
"""),)),
    Fixture(
        # an ambient clock read inside the sim twin — the exact drift
        # the virtual-clock contract forbids
        "wall-clock-in-policy", "wall-clock/true-positive",
        "kubeflow_tpu_torch/sim/_st_twin.py",
        """
import time

def cooldown_over(last, cooldown_s):
    return time.monotonic() - last >= cooldown_s
""",
        1, "virtual-clock policy path"),
    Fixture(
        # transitive, cross-module: the policy function itself is
        # clean, but a helper one module away draws the process rng
        "wall-clock-in-policy", "wall-clock-transitive/true-positive",
        "kubeflow_tpu_torch/sim/_st_twin.py",
        """
from ..serving._st_jitter import spread_hint

def retry_delay(base):
    return spread_hint(base)
""",
        1, "process rng",
        extra=(("kubeflow_tpu_torch/serving/_st_jitter.py", """
import random

def spread_hint(base):
    return base * (1.0 + random.random())
"""),)),
    Fixture(
        # the seam shapes: clock/rng taken from injected callables, and
        # the injectable-default fallback (`if now is None`) — all of
        # them are exactly what the twin threads through, none fire
        "wall-clock-in-policy", "wall-clock/near-miss",
        "kubeflow_tpu_torch/sim/_st_twin.py",
        """
import random
import time


class Bucket:
    def __init__(self, clock=time.monotonic, rng=None):
        self._clock = clock
        self._rng = rng if rng is not None else random.Random(0)

    def take(self):
        now = self._clock()
        return now + self._rng.random()


def activate(plan, now=None):
    plan.t0 = time.time() if now is None else now
""",
        0),
    # -- the torch matchers the reference has no spelling for ----------
    Fixture(
        # a `.cpu()` one helper away from the scheduler root
        "host-sync-in-dispatch", "host-sync-cpu/true-positive",
        "kubeflow_tpu_torch/serving/_st_dispatch_cpu.py",
        """
class FooEngine:
    def _loop(self):
        return self._tokens()

    def _tokens(self):
        return self.toks.cpu()
""",
        1, "`.cpu()`"),
    Fixture(
        # the same copy in a warmup-phase helper: the dispatch walk never
        # descends into warmup (it runs once, before traffic)
        "host-sync-in-dispatch", "host-sync-cpu/near-miss",
        "kubeflow_tpu_torch/serving/_st_dispatch_cpu.py",
        """
class FooEngine:
    def _loop(self):
        self._warmup_ladder()

    def _warmup_ladder(self):
        return self.toks.cpu()
""",
        0),
    Fixture(
        "host-sync-in-dispatch", "host-sync-to-cpu/true-positive",
        "kubeflow_tpu_torch/serving/_st_dispatch_to.py",
        """
class FooEngine:
    def _process(self, toks):
        return toks.to("cpu")
""",
        1, '`.to("cpu")`'),
    Fixture(
        # a host-to-device upload is not a host sync
        "host-sync-in-dispatch", "host-sync-to-cpu/near-miss",
        "kubeflow_tpu_torch/serving/_st_dispatch_to.py",
        """
class FooEngine:
    def _process(self, toks):
        return toks.to(self.device, non_blocking=True)
""",
        0),
    Fixture(
        "host-sync-in-dispatch", "host-sync-cuda-sync/true-positive",
        "kubeflow_tpu_torch/serving/_st_dispatch_sync.py",
        """
import torch

class FooEngine:
    def _loop(self):
        torch.cuda.synchronize()
""",
        1, "`torch.cuda.synchronize`"),
    Fixture(
        # recording and polling an event never blocks the host
        "host-sync-in-dispatch", "host-sync-cuda-sync/near-miss",
        "kubeflow_tpu_torch/serving/_st_dispatch_sync.py",
        """
import torch

class FooEngine:
    def _loop(self):
        self._done.record(self.stream)
        return self._done.query()
""",
        0),
    Fixture(
        # a CUDA graph captured per iteration of the admission loop
        "jit-in-loop", "jit-in-loop-graph/true-positive",
        "kubeflow_tpu_torch/serving/_st_graph.py",
        """
import torch

class FooEngine:
    def _admit(self, keys):
        for k in keys:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                self.run(k)
""",
        1, "recompile treadmill"),
    Fixture(
        # the same loop in warmup: capturing the ladder once per engine,
        # before traffic, is what warmup is for
        "jit-in-loop", "jit-in-loop-graph/near-miss",
        "kubeflow_tpu_torch/serving/_st_graph.py",
        """
import torch

class FooEngine:
    def warmup(self, keys):
        for k in keys:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                self.run(k)
""",
        0),
)


def run_selftest(rules=None, out=print) -> int:
    """Run the fixtures (optionally a rule subset); 0 = all green.

    Each fixture lints ALONE in a fresh temp tree, so table-style rules
    (op-table, fault-pairing) see exactly the fixture's protocol."""
    wanted = set(rules) if rules else None
    ran = failed = 0
    for fx in FIXTURES:
        if wanted is not None and fx.rule not in wanted:
            continue
        ran += 1
        with tempfile.TemporaryDirectory(prefix="platform-lint-st-") as td:
            targets = []
            for rel, code in ((fx.rel, fx.code), *fx.extra):
                target = os.path.join(td, rel)
                os.makedirs(os.path.dirname(target), exist_ok=True)
                with open(target, "w", encoding="utf-8") as fh:
                    fh.write(code)
                targets.append(target)
            report = run_lint(td, paths=targets, rules=[fx.rule])
        n = len(report.findings)
        ok = (n == 0) if fx.expect == 0 else (
            n >= fx.expect
            and all(fx.needle in f.message for f in report.findings))
        if ok:
            out(f"  ok   {fx.name}")
        else:
            failed += 1
            out(f"  FAIL {fx.name}: expected "
                f"{'clean' if fx.expect == 0 else f'>={fx.expect} findings'}"
                f" with {fx.needle!r}, got {n}:")
            for f in report.findings:
                out(f"       {f}")
    out(f"self-test: {ran - failed}/{ran} fixtures green")
    return 1 if failed else 0
