"""``thread-affinity``: scheduler-owned state mutates on the scheduler.

The port's copy of ``kubeflow_tpu/analysis/rules_threads.py``, scoped to
``kubeflow_tpu_torch/serving/``.

The serving engine carries one load-bearing concurrency contract: an engine's
scheduler state — the slot table, the waiting list, the paged-KV
allocator and its block tables, the pool buffers, the ``_migrating``
freeze map — is owned by the scheduler thread, and every other thread
(HTTP handlers, migration workers, resize orchestration, supervisors)
mutates it ONLY by posting an op to the migration mailbox that the
scheduler services between dispatches.  Hand-rolled violations of that
contract (abandoned-op races, export-set races) are *lexically
visible*, so this rule makes the bug class mechanical.

The rule builds a per-file THREAD-ROLE graph:

- **scheduler** — the ``*Engine`` scheduler roots (``_loop``/
  ``_admit``/``_process``/...; the same list the dispatch rule walks)
  and everything reachable from them.  The mailbox seam is invisible to
  the call graph on purpose: ``export_sequence`` only *posts* to the
  queue, ``_mig_export`` is reachable only from ``_loop`` — so
  mailbox-routed mutation classifies as scheduler-side without any
  allowlist.
- **external** — every other entry a different thread can run:
  ``threading.Thread(target=...)`` spawn targets, HTTP handler methods
  (``do_GET``/``do_POST``/...), the gang ``follow()``/``_accept_loop``
  replay entries, and the engine's PUBLIC cross-thread API (``submit``,
  ``export_sequence``, ... — anything a server thread calls).

Then it flags, inside ``*Engine`` classes, every write to a
scheduler-owned attribute (assignment, subscript store, or a mutating
method call like ``.append``/``.pop``/``.release``) in a method
reachable from an external role.  A method reachable from BOTH roles is
flagged too — that shared reachability IS the race.  Lifecycle methods
(``__init__``, ``warmup``, ``stop``, ``close``) are out: they run
before the scheduler exists or after it joined, and static analysis
cannot see phases.

A second check catches the same contract violated from OUTSIDE the
engine: ``other.engine._slots[...] = ...``-style foreign writes to
owned attributes from any serving-layer code that is not an engine
scheduler.  The gang ``follow()`` replay executor is the one carved-out
owner: its engine's scheduler never starts (followers never submit), so
the replay loop owns the pool buffers by design.

Intentional cross-thread writes carry the standard pragma::

    self._waiting.clear()  # analysis: ok thread-affinity — post-join

Runtime truth (which thread really ran it) is the LockAudit/chaos
harness's job; this rule is the static floor.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from .astlint import Finding, LintContext, ParsedFile, rule
from .callgraph import get_graph, is_lifecycle
from .rules_dispatch import ROOT_METHODS, walk_skip_defs

#: files whose classes carry the serving thread contract
THREAD_SCOPE_PREFIXES = ("kubeflow_tpu_torch/serving/",)

#: scheduler-owned attribute names (the serving-plane state the mailbox
#: seam exists to protect).  Matching is by NAME — over-approximate on
#: purpose: a non-engine class reusing one of these names for
#: cross-thread state is exactly the confusion worth flagging.
SCHEDULER_OWNED = frozenset({
    # slot table + admission state
    "_slots", "_waiting", "_active", "_positions", "_remaining",
    "_prefilling", "_slot_content", "_slot_plen", "_slot_seg",
    # paged block economy
    "_alloc", "_slot_blocks",
    # pool device buffers (donated across dispatches — an aliased write
    # from another thread corrupts an in-flight dispatch)
    "_pool_cache", "_pool_logits", "_seg_cache",
    # shared-prefix segments
    "_seg_content", "_seg_refs", "_seg_used",
    # migration freeze map
    "_migrating",
})

#: method calls that mutate their receiver (list/dict/set verbs plus
#: the BlockAllocator's economy verbs)
_MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "sort", "reverse", "update", "setdefault", "add", "discard",
    "alloc", "ref", "release", "register",
})

#: HTTP handler entry points (ThreadingHTTPServer runs each on its own
#: worker thread)
_HANDLER_METHODS = frozenset({
    "do_GET", "do_POST", "do_PUT", "do_DELETE", "do_PATCH", "do_HEAD",
})

#: lifecycle methods that run outside the concurrent phase: __init__
#: builds the object before any thread exists, warmup (and its
#: ``_warmup*`` helpers) runs before traffic, stop/close mutate only
#: after setting _stop and joining the scheduler.  Static analysis
#: cannot see phases, so these are excluded by name
#: (:func:`~.callgraph.is_lifecycle`, the one definition every rule
#: shares) — a write here that really does race carries the runtime
#: auditors' burden, not this rule's.


class _RoleGraph:
    """Per-file function index + call graph with INNERMOST-class
    attribution (the cross-module graph resolves more call shapes, but
    this rule's role model is deliberately file-local — the mailbox
    seam argument only holds within one engine module).  Indexes come
    from the parse-time def table; per-function call lists come from
    the shared :class:`~.callgraph.CallGraph` (one body scan total)."""

    def __init__(self, pf: ParsedFile, graph):
        self.pf = pf
        self.graph = graph
        self.mod = None  # set below; the file's module name in the graph
        #: qualname -> def node
        self.funcs: dict[str, ast.AST] = {}
        #: qualname -> innermost enclosing class name ('' = module)
        self.owner: dict[str, str] = {}
        #: innermost class name -> method name -> qualname
        self.by_class: dict[str, dict[str, str]] = {}
        #: bare module-level function name -> qualname
        self.module_funcs: dict[str, str] = {}
        #: class name -> ClassDef node
        self.classes: dict[str, ast.ClassDef] = {}
        for node, _qual, _inner in pf.classdefs:
            self.classes[node.name] = node
        for node, qual, cls, _outer, is_top in pf.defs:
            self.funcs[qual] = node
            self.owner[qual] = cls
            if cls:
                self.by_class.setdefault(cls, {}).setdefault(
                    node.name, qual)
            if is_top:
                self.module_funcs[node.name] = qual
        for mod, rel in graph.modules.items():
            if rel == pf.relpath:
                self.mod = mod
                break
        self._callees_cache: dict[str, set[str]] = {}

    def callees(self, qual: str) -> set[str]:
        """File-local callees of ``qual``'s whole lexical subtree (its
        own body plus nested defs — a closure handed to a thread runs
        that thread's code), resolved with this rule's deliberately
        narrow shapes: bare module functions and ``self.m()``."""
        cached = self._callees_cache.get(qual)
        if cached is not None:
            return cached
        out: set[str] = set()
        self._callees_cache[qual] = out  # placed first: cycle-safe
        fi = self.graph.funcs.get(f"{self.mod}::{qual}")
        if fi is not None:
            cls = self.owner.get(qual, "")
            for node in fi.calls:
                f = node.func
                if isinstance(f, ast.Name):
                    if f.id in self.module_funcs:
                        out.add(self.module_funcs[f.id])
                elif (isinstance(f, ast.Attribute)
                      and isinstance(f.value, ast.Name)
                      and f.value.id == "self" and cls):
                    m = self.by_class.get(cls, {}).get(f.attr)
                    if m:
                        out.add(m)
            for callee, cnode, _g in fi.edges:
                if cnode is None:  # nested def: fold its subtree in
                    out |= self.callees(callee.split("::", 1)[1])
        return out

    def reachable(self, roots: Iterable[str]) -> set[str]:
        seen: set[str] = set()
        todo = [r for r in roots if r in self.funcs]
        while todo:
            q = todo.pop()
            if q in seen:
                continue
            seen.add(q)
            todo.extend(self.callees(q) - seen)
        return seen

    def thread_targets(self) -> list[str]:
        """Qualnames passed as ``threading.Thread(target=...)`` —
        entries another thread runs."""
        out: list[str] = []
        for node in self.pf.of_type(ast.Call):
            f = node.func
            is_thread = (isinstance(f, ast.Attribute) and f.attr == "Thread"
                         ) or (isinstance(f, ast.Name) and f.id == "Thread")
            if not is_thread:
                continue
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None and node.args:
                continue  # positional Thread(group, target) is unused here
            q = self._resolve_ref(target, node)
            if q:
                out.append(q)
        return out

    def _resolve_ref(self, expr: Optional[ast.AST],
                     at: ast.AST) -> Optional[str]:
        """Resolve a first-class function reference (``self._loop``, a
        bare name, or ``obj._method`` by unique method name)."""
        if expr is None:
            return None
        if isinstance(expr, ast.Name):
            return self.module_funcs.get(expr.id)
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                cls = self._class_at(at)
                return self.by_class.get(cls, {}).get(expr.attr)
            # obj._method: unique method name anywhere in the file
            cands = [q for c in self.by_class.values()
                     for n, q in c.items() if n == expr.attr]
            if len(cands) == 1:
                return cands[0]
        return None

    def _class_at(self, node: ast.AST) -> str:
        scope = self.pf.scope_at(getattr(node, "lineno", 1))
        # innermost CLASS on the qualname path
        parts = scope.split(".") if scope else []
        for i in range(len(parts), 0, -1):
            cand = parts[i - 1]
            if cand in self.classes:
                return cand
        return ""


def _owned_base_attr(expr: ast.AST) -> Optional[str]:
    """The scheduler-owned attribute at the base of a ``self.<attr>``
    target chain (``self._slots``, ``self._slot_blocks[i]``,
    ``self._alloc.cow_copies_total``), or None."""
    node = expr
    owned = None
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Attribute):
            if (isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in SCHEDULER_OWNED):
                owned = node.attr
            node = node.value
        else:
            return owned


def _foreign_owned_attr(expr: ast.AST) -> Optional[str]:
    """Owned attribute written through a NON-self object
    (``engine._slots``, ``self.engine._waiting``)."""
    node = expr
    while isinstance(node, ast.Subscript):
        node = node.value
    if not (isinstance(node, ast.Attribute)
            and node.attr in SCHEDULER_OWNED):
        return None
    base = node.value
    if isinstance(base, ast.Name) and base.id == "self":
        return None  # self-writes are the first check's business
    return node.attr


def _iter_owned_writes(fn: ast.AST, children: dict,
                       foreign: bool = False):
    """(node, attr) for every owned-state write lexically in ``fn``'s
    own body (nested defs run on whichever thread calls them — the
    closure handed to the mailbox is the seam working as intended, so
    they are not this method's writes)."""
    pick = _foreign_owned_attr if foreign else _owned_base_attr
    for node in walk_skip_defs(fn, children):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                attr = pick(t)
                if attr:
                    yield node, attr
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                attr = pick(f.value)
                if attr:
                    yield node, attr


@rule("thread-affinity")
def thread_affinity(ctx: LintContext) -> Iterable[Finding]:
    cg = get_graph(ctx)
    for rel, pf in sorted(ctx.files.items()):
        if not rel.startswith(THREAD_SCOPE_PREFIXES):
            continue
        graph = _RoleGraph(pf, cg)
        spawned = set(graph.thread_targets())

        # -- check 1: engine methods, classified by role ------------------
        # Autoscaling/reaper ORCHESTRATION classes
        # (``*Autoscaler``/``*Scaler``/``*Reaper``) ride the same walk
        # with an empty scheduler role: they have no scheduler roots,
        # so EVERY method classifies as an external entry — these
        # classes run on their own worker thread (or the reconcile
        # worker) and may touch engines only through public
        # cross-thread APIs, never by writing owned state directly.
        for cls in sorted(graph.classes):
            if not cls.endswith(("Engine", "Autoscaler", "Scaler",
                                 "Reaper")):
                continue
            methods = graph.by_class.get(cls, {})
            sched_set = graph.reachable(
                methods[m] for m in ROOT_METHODS if m in methods)
            entries: dict[str, str] = {}  # qualname -> entry method name
            for name, qual in sorted(methods.items()):
                if is_lifecycle(name) or name in ROOT_METHODS:
                    continue
                # NOTE: being scheduler-reachable does NOT exempt an
                # entry — a public method the scheduler also calls runs
                # on two threads, and that shared reachability IS the
                # race this rule exists to flag
                if (not name.startswith("_")          # public cross-thread API
                        or qual in spawned            # worker thread body
                        or name in _HANDLER_METHODS
                        or name == "_accept_loop"):
                    entries[qual] = name
            if not entries:
                continue
            reach_from: dict[str, str] = {}  # method -> first entry reaching it
            for qual, name in entries.items():
                for m in graph.reachable([qual]):
                    reach_from.setdefault(m, name)
            for qual in sorted(reach_from):
                name = qual.rsplit(".", 1)[-1]
                if is_lifecycle(name):
                    continue
                fn = graph.funcs[qual]
                role = reach_from[qual]
                shared = qual in sched_set
                for node, attr in _iter_owned_writes(fn, pf.children):
                    f = ctx.finding(
                        pf, "thread-affinity", node,
                        f"write to scheduler-owned `{attr}` from "
                        f"non-scheduler entry `{role}`"
                        + (" (method is ALSO scheduler-reachable — "
                           "shared reachability is the race)"
                           if shared else "")
                        + " — route it through the scheduler mailbox")
                    if f:
                        yield f

        # -- check 2: foreign writes into an engine's owned state ---------
        # the follow() replay executor (and its helpers) owns its
        # engine's pool buffers by design: the follower engine's
        # scheduler never starts, so the replay loop IS that engine's
        # owning thread
        replay = graph.reachable(
            [q for n, q in graph.module_funcs.items()
             if n == "follow" or n.startswith("_follower")])
        for qual in sorted(graph.funcs):
            if qual in replay:
                continue
            fn = graph.funcs[qual]
            for node, attr in _iter_owned_writes(
                    fn, pf.children, foreign=True):
                f = ctx.finding(
                    pf, "thread-affinity", node,
                    f"foreign write to scheduler-owned `{attr}` of "
                    "another object's engine — only the engine's own "
                    "scheduler (or the gang replay executor) may "
                    "mutate it; use the engine's mailbox API")
                if f:
                    yield f
