"""Dispatch-hygiene rules: the device queue must never drain.

The port's copy of ``kubeflow_tpu/analysis/rules_dispatch.py``, scoped
to ``kubeflow_tpu_torch/`` and matching torch's spellings (see
:mod:`.callgraph`).

``host-sync-in-dispatch``: the engine's throughput is the card's stream
occupancy (PAPERS.md: "Exploring the limits of Concurrency in ML
Training on Google TPUs" makes the argument for any accelerator queue);
one stray ``.item()`` / ``.cpu()`` / ``torch.cuda.synchronize()`` /
``np.asarray`` on a device value inside the scheduler's dispatch path
serializes host and device and re-introduces the per-token round trip
the dispatch-ahead pipeline exists to hide.  The rule walks the
CROSS-MODULE call graph (:mod:`.callgraph`) from every ``*Engine``
class's scheduler roots (``_loop``/``_admit``/``_process``...) —
``self._helper()`` through the MRO, ``from .x import y`` helpers,
``self.store.write()`` through attribute typing — and flags
host-materialization calls in anything reachable, in whatever file it
lives.  On the same reachability it flags blocking SOCKET I/O
(``sendall``/``recv``/``create_connection``): live KV migration streams
block bytes between replicas, and a socket send on the scheduler thread
would stall every live request for a network round trip (or forever, on
a wedged peer) — the migrate path runs on worker threads, the scheduler
only services its mailbox.  ``*Allocator`` classes (the paged-KV block
economy, serving/paged.py) sit ON the dispatch path — every admission
and block-table assembly runs them between dispatches — so ALL their
methods are roots: block-table math must stay host-side numpy, and a
``.item()`` on the free list can never ride along undeclared.  The
engine DOES need exactly one fetch boundary (delivering sampled tokens)
and host-side numpy scheduler math is legitimate — those sites carry
``# analysis: ok host-sync-in-dispatch`` pragmas, which is the point:
the boundary is *declared*, so a new undeclared one fails tier-1.

``jit-in-loop``: constructing a program (a CUDA graph capture,
``torch.compile``, a ``make_*_program`` factory) inside a loop body
builds a fresh program per iteration — a guaranteed recapture
treadmill.  Program construction belongs in cached getters (the
``_Dispatch.run`` keyed-program pattern); only *calling* a cached
program in a loop is fine.  The cross-module half: an UNGUARDED
loop-body call into a helper whose effect set carries
``jit-unguarded`` (it constructs unconditionally, wherever it lives)
is the same treadmill wearing a function call as a disguise — guarded
call sites (the ``if key not in cache:`` miss path) and memoized
factories stay quiet.  Loops of the warmup phase (``warmup`` and its
``_warmup*`` helpers, ``__init__``) are out: capturing the program
ladder once per engine before traffic is what warmup is for, the
lifecycle contract :data:`~.callgraph.LIFECYCLE_METHODS` states.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from .astlint import Finding, LintContext, rule
from .callgraph import (
    HOST_SYNC_MATCHERS,
    ROOT_METHODS,  # noqa: F401  (re-export: rules_threads roots on it)
    _dotted,  # noqa: F401  (re-export: rules_locks/threads lexical names)
    get_graph,
    is_blocking_socket,
    is_lifecycle,
    is_program_construction,
    walk_skip_defs,  # noqa: F401  (re-export: rules_locks scans with it)
)

#: KV-tier classes: any class named *Tier*/*Spill*/*Hibernat* joins
#: the dispatch-hygiene walk (KvSpillStore, SessionHibernator-style
#: orchestrators) — substring, not suffix, because the tier vocabulary
#: composes into names freely
_TIER_CLASS = re.compile(r"Tier|Spill|Hibernat")

#: scheduler-adjacent orchestration classes whose EVERY method is a
#: dispatch-path root.  The rationale per suffix family: paged-KV
#: allocators run between dispatches on the scheduler thread
#: (block-table assembly, free-list pops, prefix matching — host numpy
#: only); traffic-plane admission classes (``*TrafficPlane``/
#: ``*Admission``/``*Preemptor``) run token-bucket and queue accounting
#: on router/HTTP worker threads AND the engine's admission_policy hook
#: on the scheduler thread — either way a device fetch or a blocking
#: socket in QoS bookkeeping stalls every live request; elastic-resize
#: orchestration (``*Resizer``/``*Reshard``) is rooted so new
#: scheduler-adjacent classes never go unlinted (a resizer's weight
#: fetch is DELIBERATE off-scheduler blocking — each such site carries
#: a declaring pragma instead of silence), while the reshard WIRE
#: classes (ReshardServer/ReshardClient) follow the KvMigrationServer
#: convention — dedicated worker threads whose whole job is socket I/O,
#: never reachable from a dispatch loop — so suffix matching leaves
#: them out on purpose; KV TIER classes (``*BlockPool`` + the
#: _TIER_CLASS names) are rooted because HostBlockPool's match/take run
#: ON the scheduler thread at admission and the spill/hibernate store's
#: device fetches + file I/O are deliberate, declared tier transitions
#: (spill I/O never on the scheduler; the mailbox seam is the only
#: crossing); autoscaling orchestration (``*Autoscaler``/``*Scaler``/
#: ``*Reaper``) senses live-engine state every tick on the reconcile
#: worker — sensing must stay host-side stdlib, heavy actuation goes
#: through the engines' public cross-thread APIs; program ARTIFACT
#: classes (``*ArtifactCache``/``*ProgramStore``) are rooted because
#: artifact load/publish is warmup-only by design and this root makes
#: that promise checkable.
ROOTED_SUFFIXES = ("Allocator", "TrafficPlane", "Admission",
                   "Preemptor", "Resizer", "Reshard",
                   "BlockPool", "Autoscaler", "Scaler",
                   "Reaper", "ArtifactCache", "ProgramStore")


def dispatch_roots(graph) -> list[str]:
    """Every dispatch-path root fqual in the context: ``*Engine``
    scheduler entry points (MRO-resolved, so an inherited ``_loop``
    roots the base-class method wherever it lives) plus ALL own methods
    of the rooted-suffix / tier classes."""
    roots: list[str] = []
    for (mod, cls), ci in graph.classes.items():
        if cls.endswith("Engine"):
            for m in ROOT_METHODS:
                fq = graph.method(mod, cls, m)
                if fq:
                    roots.append(fq)
        if cls.endswith(ROOTED_SUFFIXES) or _TIER_CLASS.search(cls):
            roots.extend(ci.methods.values())
    return roots


#: host-materialization + blocking-socket matchers, in the report order
#: the rule has always used.  The matchers themselves moved to
#: callgraph.py (the effect engine shares them); the LABELS are frozen
#: strings — finding identity depends on them, so a reword would
#: resurrect every pragma'd site as "new".
_HOST_SYNCS = HOST_SYNC_MATCHERS + (
    ("blocking socket I/O (`sendall`/`recv`/`create_connection` — "
     "migration streaming must run off-thread)", is_blocking_socket),
)


def _dispatch_reachable(graph, roots: list[str]) -> set[str]:
    """Reachability with the LIFECYCLE cut: the walk models the
    steady-state dispatch phase, so it never traverses INTO
    ``__init__``/``warmup`` (and its ``_warmup*`` helpers)/``stop``/...
    — those run before the
    scheduler exists or after it joined (the same phase contract
    rules_threads encodes).  A root that IS lifecycle-named (a rooted
    suffix class's ``__init__``) still gets scanned — only transitive
    descent is cut."""
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


@rule("host-sync-in-dispatch")
def host_sync_in_dispatch(ctx: LintContext) -> Iterable[Finding]:
    graph = get_graph(ctx)
    for fq in sorted(_dispatch_reachable(graph, dispatch_roots(graph))):
        fi = graph.funcs[fq]
        pf = ctx.files.get(fi.relpath)
        if pf is None:
            continue
        # fi.calls is the OWN body; nested defs are their own graph
        # nodes reached through the parent's pseudo-edge, so the old
        # full-subtree walk's coverage is preserved piecewise
        for call in fi.calls:
            for label, match in _HOST_SYNCS:
                if match(call):
                    f = ctx.finding(
                        pf, "host-sync-in-dispatch", call,
                        f"host sync {label} reachable from the "
                        "engine dispatch loop")
                    if f:
                        yield f
                    break


def _iter_loop_calls(node: ast.AST, children: dict,
                     guarded: bool = False) -> Iterable[tuple]:
    """(Call, guarded) pairs in a loop's own body: nested defs/lambdas
    skipped (they run later, if ever), ``if``/``try`` bodies marked
    guarded — the lexical shape of the cache-miss idiom."""
    for child in children.get(id(node), ()):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        down = guarded or isinstance(child, (ast.If, ast.Try, ast.IfExp))
        if isinstance(child, ast.Call):
            yield child, guarded
        yield from _iter_loop_calls(child, children, down)


@rule("jit-in-loop")
def jit_in_loop(ctx: LintContext) -> Iterable[Finding]:
    graph = get_graph(ctx)
    for pf in ctx.files.values():
        for loop in pf.of_type(ast.For, ast.While, ast.AsyncFor):
            scope = pf.scope_at(loop.lineno)
            if scope and is_lifecycle(scope.rsplit(".", 1)[-1]):
                # the warmup phase captures each program of its ladder
                # once, before traffic (and __init__ once per object):
                # object-lifecycle capture, not a per-iteration treadmill
                continue
            # scan only this loop's own body (nested defs build programs
            # lazily when *called* — construction is not per-iteration)
            for node, guarded in _iter_loop_calls(loop, pf.children):
                if is_program_construction(node):
                    f = ctx.finding(
                        pf, "jit-in-loop", node,
                        "jit/program construction inside a loop body "
                        "(recompile treadmill — hoist into a cached "
                        "getter)")
                    if f:
                        yield f
                    continue
                if guarded:
                    # the `if key not in cache:` miss path — building
                    # once per novel key is the getter pattern, not a
                    # treadmill
                    continue
                for callee in graph.resolve_call(node):
                    if "jit-unguarded" in graph.effects(callee):
                        f = ctx.finding(
                            pf, "jit-in-loop", node,
                            "loop-body call reaches unguarded "
                            f"jit/program construction in `{callee}` "
                            "(recompile treadmill — guard the call or "
                            "hoist into a cached getter)")
                        if f:
                            yield f
                        break
