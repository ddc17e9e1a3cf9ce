"""``wall-clock-in-policy``: no ambient time, no process rng, on any
policy path the sim twin replays.

The port's copy of ``kubeflow_tpu/analysis/rules_clock.py``, scoped to
``kubeflow_tpu_torch/sim/`` and the port's policy surfaces.

The fleet twin runs the REAL policy objects — router pick +
circuits + retry budget, the QoS door, ``decide``/``tick`` — on a
virtual clock and a seeded rng.  That only stays true while every one
of those code paths takes time from its ``clock=``/``now=`` seam and
randomness from its ``rng=`` seam: one ``time.monotonic()`` snuck into
a cooldown check and the twin silently diverges from production (same
seed, different bytes), which is exactly the re-modeling drift the
twin exists to rule out.

Scope is explicit: every file under ``kubeflow_tpu_torch/sim/`` (the twin
must be 100% virtual by construction) plus the named policy surfaces
in serving/ that carry seams (:data:`POLICY_SCOPES`).  The
check is transitive over the call graph: a scoped function that
*reaches* a helper reading the wall clock is as broken as one that
reads it directly, so the finding lands at the terminal site, wherever
it lives.  The walk applies the same lifecycle cut as the dispatch
rules — ``__init__``/``start``/``stop`` run once outside the replayed
steady state.

The one excused shape is the injectable-default seam itself::

    def activate(self, now=None):
        self._t0 = time.time() if now is None else now

A wall-clock call lexically under an ``<x> is None`` conditional is
the fallback arm of a ``now=`` parameter — the caller CAN inject
virtual time, which is all the twin needs.  Everything else wants the
seam, or an ``# analysis: ok wall-clock-in-policy`` pragma with a
reason.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from .astlint import Finding, LintContext, rule
from .callgraph import _dotted, get_graph, is_lifecycle

#: the twin package: everything in it is policy scope
SIM_PREFIX = "kubeflow_tpu_torch/sim/"

#: (relpath, qualname prefixes) — the serving policy surfaces with
#: ``clock=``/``rng=`` seams.  Deliberately NOT whole files: the HTTP
#: handler, reconcile loop and gang probes in controller.py live on
#: real wall time (they serve real clients), only the pure pick/
#: circuit/outage policy the twin drives is held to the seam contract.
POLICY_SCOPES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("kubeflow_tpu_torch/serving/traffic.py", (
        "TokenBucket", "PrefixAffinity", "SessionAffinity",
        "KvBlockRegistry", "BackendHealth", "RetryBudget",
        "jittered_retry_after", "smooth_wrr_pick", "live_candidates",
        "door_decision", "_ClassState", "TrafficPlane",
        "ClusterPrefixPoller", "blocks_needed", "best_pending",
        "choose_victim", "EnginePreemptor")),
    ("kubeflow_tpu_torch/serving/autoscale.py", (
        "AutoscalePolicy", "TrendPredictor", "ConcurrencyGate",
        "ActuatorState", "decide", "ClusterAutoscaler",
        "SessionReaper")),
    ("kubeflow_tpu_torch/serving/controller.py", (
        "Router._pick", "Router._note", "Router._backend_down",
        "Router._backend_up", "Router._check_domain_outage",
        "Router.domain_of", "Router.set_domains",
        "Router.set_backends", "Router.backends")),
)

#: ambient-time reads (and sleeps — a policy that sleeps real seconds
#: cannot replay in virtual ones)
_WALL_CLOCK = frozenset({
    "time.time", "time.monotonic", "time.perf_counter",
    "time.time_ns", "time.monotonic_ns", "time.perf_counter_ns",
    "time.sleep",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
})

#: module-level ``random.*`` draws mutate interpreter-global state —
#: unseedable from a scenario.  ``random.Random(seed)`` (constructing
#: the seam) is exactly what the twin wants, so only the drawing
#: functions are listed.
_PROCESS_RNG = frozenset(f"random.{f}" for f in (
    "random", "uniform", "gauss", "normalvariate", "lognormvariate",
    "expovariate", "betavariate", "triangular", "vonmisesvariate",
    "paretovariate", "weibullvariate", "choice", "choices", "sample",
    "shuffle", "randint", "randrange", "getrandbits", "randbytes",
    "seed",
))


def _scoped(relpath: str, qual: str) -> bool:
    if relpath.startswith(SIM_PREFIX):
        return True
    for rel, prefixes in POLICY_SCOPES:
        if relpath != rel:
            continue
        for p in prefixes:
            if qual == p or qual.startswith(p + "."):
                return True
    return False


def _violation(call: ast.Call) -> Optional[str]:
    d = _dotted(call.func)
    if d in _WALL_CLOCK:
        return f"wall-clock `{d}()`"
    if d in _PROCESS_RNG:
        return f"process rng `{d}()`"
    return None


def _fallback_excused(pf, def_node: ast.AST) -> set[int]:
    """ids of Call nodes inside an ``<x> is None`` conditional of this
    def — the injectable-default idiom (``time.time() if now is None
    else now``) IS the seam, so its fallback arm is excused."""
    excused: set[int] = set()
    end = getattr(def_node, "end_lineno", def_node.lineno)
    for node in pf.of_type(ast.IfExp, ast.If):
        if not (def_node.lineno <= node.lineno <= end):
            continue
        test = node.test
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.Is, ast.IsNot))
                and any(isinstance(c, ast.Constant) and c.value is None
                        for c in test.comparators)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                excused.add(id(sub))
    return excused


def policy_reachable(graph, roots: Iterable[str]) -> set[str]:
    """Reachability from the policy roots with the lifecycle cut
    (the rules_dispatch phase contract): construction and teardown run
    once, outside the replayed steady state, so the walk never
    descends INTO ``__init__``/``start``/``stop``/... — a root that IS
    one still gets scanned directly."""
    seen: set[str] = set()
    todo = [r for r in roots if r in graph.funcs]
    while todo:
        fq = todo.pop()
        if fq in seen:
            continue
        seen.add(fq)
        for callee, _node, _g in graph.funcs[fq].edges:
            if callee in seen:
                continue
            bare = callee.split("::", 1)[1].rsplit(".", 1)[-1]
            if is_lifecycle(bare):
                continue
            todo.append(callee)
    return seen


@rule("wall-clock-in-policy")
def wall_clock_in_policy(ctx: LintContext) -> Iterable[Finding]:
    graph = get_graph(ctx)
    roots = [fq for fq, fi in sorted(graph.funcs.items())
             if _scoped(fi.relpath, fq.split("::", 1)[1])]
    for fq in sorted(policy_reachable(graph, roots)):
        fi = graph.funcs[fq]
        pf = ctx.files.get(fi.relpath)
        if pf is None:
            continue
        excused = _fallback_excused(pf, fi.node)
        for call in fi.calls:
            if id(call) in excused:
                continue
            label = _violation(call)
            if label is None:
                continue
            f = ctx.finding(
                pf, "wall-clock-in-policy", call,
                f"{label} on a virtual-clock policy path — take time "
                "from the `clock=`/`now=` seam and randomness from "
                "the `rng=` seam so the sim twin replays it "
                "deterministically")
            if f:
                yield f
