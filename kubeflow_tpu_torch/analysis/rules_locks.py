"""``lock-order``: the platform-wide lock nesting graph.

The port's copy of ``kubeflow_tpu/analysis/rules_locks.py``, scoped to
``kubeflow_tpu_torch/``; its blocking calls include torch's device
waits (``torch.cuda.synchronize``, ``.synchronize()``, ``.cpu()``,
``.to("cpu")``).

The chaos harness catches a double restart-bump from two reconciles
racing one key — a bug class locks *create* as readily as they fix.
This rule extracts every ``with <lock>:`` nesting across the serving,
controlplane, hpo, and net layers, builds the global acquisition-order
graph, and flags:

- **cycles** (``A`` taken under ``B`` somewhere, ``B`` under ``A``
  elsewhere): a deadlock that needs only the right two-thread schedule —
  exactly what fault injection eventually finds, so find it at lint
  time instead;
- **blocking calls while holding a lock** (``time.sleep``, socket
  send/recv/connect/accept, thread ``join``, ``urlopen``, device
  fetches and syncs):
  every other thread needing that lock now waits on the network/device
  too — the convoy that turns one slow peer into a platform stall.
  The gang channel's bounded ``sendall``-under-lock sites are the
  intentional, documented exception (socket timeouts bound the hold)
  and carry pragmas.

Lock identity is lexical: ``self._lock`` in class ``Foo`` is
``Foo._lock``; a module-level ``_lock`` is ``module._lock``.  Two
*instances* of one class share an identity here — over-approximate for
cycles (a self-edge via two instances is real ONLY if two objects nest;
those are skipped), under-approximate across files.  One level of
interprocedural depth is modeled: a call made under a lock pulls in the
locks that callee (same file) lexically takes.

Runtime truth — orders that only happen under fault injection — is the
:class:`~kubeflow_tpu_torch.analysis.runtime.LockAudit` recorder's job; this
rule is the static floor.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, Optional

from .astlint import Finding, LintContext, ParsedFile, rule
from .callgraph import (
    BLOCKING_EFFECTS,
    _is_cpu,
    _is_to_cpu,
    get_graph,
    is_lifecycle,
)
from .rules_dispatch import _dotted, walk_skip_defs

#: layers whose locking interacts (the cross-component deadlock surface)
LOCK_SCOPE_PREFIXES = (
    "kubeflow_tpu_torch/serving/",
    "kubeflow_tpu_torch/controlplane/",
    "kubeflow_tpu_torch/hpo/",
    "kubeflow_tpu_torch/utils/net.py",
    "kubeflow_tpu_torch/chaos/",
    "kubeflow_tpu_torch/native/",
)

#: lexical lock-name markers.  "cv" is there because serving/resize.py
#: guards reshard acks with a ``threading.Condition`` named ``_ack_cv``
#: and serving/traffic.py parks class waiters on per-class ``cond``s —
#: Conditions ARE locks (they wrap one), so leaving them out of the
#: nesting graph would exempt both modules from the deadlock check.
_LOCKISH = ("lock", "gate", "cond", "mutex", "joined", "cv")


def _lock_name(expr: ast.AST, pf: ParsedFile, cls: str) -> Optional[str]:
    """Canonical lock id for a with-item context expr, or None if the
    expr doesn't look like a lock."""
    d = _dotted(expr)
    if d is None:
        return None
    last = d.rsplit(".", 1)[-1].lower()
    if not any(k in last for k in _LOCKISH):
        return None
    mod = os.path.splitext(os.path.basename(pf.relpath))[0]
    if d == "self" or d.startswith("self."):
        owner = cls or mod
        return f"{owner}.{d[5:]}" if d != "self" else None
    if "." not in d:
        return f"{mod}.{d}"
    return d  # obj._lock style: keep the dotted text as identity


class _WithLock:
    def __init__(self, name: str, node: ast.With, pf: ParsedFile):
        self.name = name
        self.node = node
        self.pf = pf


def _enclosing_class(pf: ParsedFile, line: int) -> str:
    scope = pf.scope_at(line)
    return scope.split(".")[0] if scope else ""


def _iter_with_locks(pf: ParsedFile):
    """Every (lock-name, With-node) in the file, lexical."""
    for node in pf.of_type(ast.With, ast.AsyncWith):
        cls = _enclosing_class(pf, node.lineno)
        for item in node.items:
            name = _lock_name(item.context_expr, pf, cls)
            if name:
                yield name, node


def _locks_in_body(pf: ParsedFile, node: ast.AST) -> list[tuple[str, ast.With]]:
    """with-lock statements lexically inside ``node``'s body (not
    descending into nested defs — they run on other threads/later)."""
    out = []
    for child in walk_skip_defs(node, pf.children):
        if not isinstance(child, (ast.With, ast.AsyncWith)):
            continue
        cls = _enclosing_class(pf, child.lineno)
        for item in child.items:
            name = _lock_name(item.context_expr, pf, cls)
            if name:
                out.append((name, child))
    return out


def _function_index(pf: ParsedFile) -> dict[str, ast.AST]:
    """(class, name) and bare-name keyed defs for 1-level call lookup,
    read off the parse-time def table (no re-recursion)."""
    idx: dict[str, ast.AST] = {}
    for node, _qual, _inner, outer, _top in pf.defs:
        idx[f"{outer}.{node.name}" if outer else node.name] = node
    return idx


_BLOCKING_SOCKET = {"recv", "send", "sendall", "accept", "connect",
                    "create_connection", "recv_into"}


def _blocking_label(call: ast.Call) -> Optional[str]:
    d = _dotted(call.func)
    if d in ("time.sleep", "sleep"):
        return "`time.sleep`"
    if d in ("torch.cuda.synchronize", "cuda.synchronize"):
        return f"`{d}`"
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr in _BLOCKING_SOCKET:
            return f"socket `.{f.attr}`"
        if f.attr == "synchronize":
            return "`.synchronize`"
        if _is_cpu(call):
            return "`.cpu()`"
        if _is_to_cpu(call):
            return "`.to(\"cpu\")`"
        if f.attr == "urlopen" or (isinstance(f.value, ast.Name)
                                   and f.attr == "urlopen"):
            return "`urlopen`"
        if f.attr == "join" and "thread" in (_dotted(f.value) or "").lower():
            return "thread `.join`"
    if isinstance(f, ast.Name) and f.id == "urlopen":
        return "`urlopen`"
    return None


def collect_lock_graph(ctx: LintContext) -> tuple[
        dict[tuple[str, str], tuple[ParsedFile, ast.AST]],
        list[tuple[ParsedFile, ast.AST, str, str]]]:
    """The platform-wide lock graph: ``(edges, blocking_sites)``.

    ``edges`` maps (outer, inner) nesting pairs to the first site that
    creates them; ``blocking_sites`` lists (pf, node, label, lock)
    blocking calls made while a lock is held.  Exposed so tests can
    re-verify acyclicity and coverage (resize.py's ``_ack_cv`` Condition
    and traffic.py's per-class ``cond``s must actually appear in this
    graph)."""
    edges: dict[tuple[str, str], tuple[ParsedFile, ast.AST]] = {}
    blocking: list[tuple[ParsedFile, ast.AST, str, str]] = []

    scoped = [pf for rel, pf in sorted(ctx.files.items())
              if rel.startswith(LOCK_SCOPE_PREFIXES)]

    # per-file: lexical nesting edges + blocking-under-lock + 1-level
    # call expansion
    for pf in scoped:
        fidx = _function_index(pf)
        for outer_name, outer_node in _iter_with_locks(pf):
            body = list(walk_skip_defs(outer_node, pf.children))
            # direct lexical nesting
            for inner_name, inner_node in _locks_in_body(pf, outer_node):
                if inner_name != outer_name:
                    edges.setdefault((outer_name, inner_name),
                                     (pf, inner_node))
            for child in body:
                if not isinstance(child, ast.Call):
                    continue
                # blocking call while the lock is held
                label = _blocking_label(child)
                if label is not None:
                    blocking.append((pf, child, label, outer_name))
                    continue
                # 1-level interprocedural: locks the callee takes are
                # taken under this one
                callee = None
                fn = child.func
                if isinstance(fn, ast.Name):
                    callee = fidx.get(fn.id)
                elif (isinstance(fn, ast.Attribute)
                      and isinstance(fn.value, ast.Name)
                      and fn.value.id == "self"):
                    cls = _enclosing_class(pf, child.lineno)
                    callee = fidx.get(f"{cls}.{fn.attr}")
                if callee is not None:
                    for inner_name, inner_node in _locks_in_body(pf, callee):
                        if inner_name != outer_name:
                            edges.setdefault((outer_name, inner_name),
                                             (pf, child))
    return edges, blocking


def find_cycles(edges: dict[tuple[str, str], tuple[ParsedFile, ast.AST]]
                ) -> list[tuple[list[str], ParsedFile, ast.AST]]:
    """Distinct lock-order cycles in ``edges``: (witness path, anchor
    site) per cycle node-set, anchored at the smallest source node for
    ratchet-stable identity."""
    # cycle detection: edge a->b closes a cycle iff a is reachable back
    # from b.  BFS with parent links reconstructs one witness path;
    # each distinct node set reports once, anchored at the edge whose
    # source node is smallest (stable across runs for the ratchet key).
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    out: list[tuple[list[str], ParsedFile, ast.AST]] = []
    reported: set[frozenset] = set()
    for a, b in sorted(edges):
        parent: dict[str, str] = {b: b}
        queue = [b]
        while queue:
            node = queue.pop(0)
            if node == a:
                break
            for nxt in sorted(graph.get(node, ())):
                if nxt not in parent:
                    parent[nxt] = node
                    queue.append(nxt)
        if a not in parent:
            continue
        path = [a]  # parent-chain hop-back: a, parent[a], ..., b
        node = a
        while node != b:
            node = parent[node]
            path.append(node)
        # forward cycle = a --edge--> b --bfs-walk--> ... --> a
        cycle = [a] + list(reversed(path))[:-1]
        nodes = frozenset(cycle)
        if nodes in reported or min(cycle) != a:
            continue
        reported.add(nodes)
        pf, where = edges[(a, b)]
        out.append((cycle, pf, where))
    return out


@rule("lock-order")
def lock_order(ctx: LintContext) -> Iterable[Finding]:
    edges, blocking = collect_lock_graph(ctx)
    for pf, node, label, outer_name in blocking:
        f = ctx.finding(
            pf, "lock-order", node,
            f"blocking call {label} while holding `{outer_name}`")
        if f:
            yield f
    for cycle, pf, where in find_cycles(edges):
        f = ctx.finding(
            pf, "lock-order", where,
            "lock-order cycle: " + " -> ".join(cycle + [cycle[0]]))
        if f:
            yield f


#: effect -> human label for the lock-blocking-call message
_EFFECT_LABELS = {
    "sleep": "`time.sleep`",
    "socket": "blocking socket I/O",
    "host-sync": "a device sync/fetch",
    "fsync": "`os.fsync`",
    "urlopen": "`urlopen`",
    "thread-join": "thread `.join`",
}


@rule("lock-blocking-call")
def lock_blocking_call(ctx: LintContext) -> Iterable[Finding]:
    """No blocking I/O or device sync REACHABLE while a Lock/RLock/
    Condition is held — the transitive completion of lock-order's
    direct-site check.  ``with self._lock: self._flush()`` is invisible
    to lock-order when ``_flush`` fsyncs (or its callee three modules
    away does); this rule joins the same lexical lock model to the
    call-graph effect sets, so the convoy — every thread needing the
    lock waiting on disk/network/device — is flagged wherever the
    blocking call actually lives.  Direct blocking calls under the
    ``with`` stay lock-order's finding (one site, one rule); this one
    fires only through a resolved call edge, and names the terminal
    site so the fix (or the declaring pragma) lands at the right
    boundary."""
    graph = get_graph(ctx)
    scoped = [pf for rel, pf in sorted(ctx.files.items())
              if rel.startswith(LOCK_SCOPE_PREFIXES)]
    for pf in scoped:
        for lock_name, with_node in _iter_with_locks(pf):
            scope = pf.scope_at(with_node.lineno)
            if is_lifecycle(scope.rsplit(".", 1)[-1]):
                # warmup/__init__/close hold their gate to SERIALIZE a
                # phase transition — blocking while every other thread
                # waits is the intended semantics there, and the phase
                # contract (callgraph.is_lifecycle) already owns it
                continue
            for child in walk_skip_defs(with_node, pf.children):
                if not isinstance(child, ast.Call):
                    continue
                if _blocking_label(child) is not None:
                    continue  # direct site: lock-order reports it
                hit = None
                for callee in graph.resolve_call(child):
                    eff = sorted(graph.effects(callee) & BLOCKING_EFFECTS)
                    if eff:
                        hit = (callee, eff[0])
                        break
                if hit is None:
                    continue
                callee, eff = hit
                site, _label = graph.effect_site(callee, eff) or (callee, "")
                f = ctx.finding(
                    pf, "lock-blocking-call", child,
                    f"call into `{callee}` while holding `{lock_name}` "
                    f"reaches {_EFFECT_LABELS[eff]} (at `{site}`) — "
                    "move the blocking work outside the lock or declare "
                    "the boundary")
                if f:
                    yield f
