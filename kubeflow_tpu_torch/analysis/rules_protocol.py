"""Protocol-completeness rules: op tables and chaos fault pairing.

The port's copy of ``kubeflow_tpu/analysis/rules_protocol.py``, scoped
to ``kubeflow_tpu_torch/serving/`` and ``kubeflow_tpu_torch/chaos/``.

``op-table``: the gang control stream is a leader-publish /
follower-replay protocol — rank 0 publishes ``("<op>", ...)`` tuples
(serving/gang.py, serving/resize.py) and every follower dispatches on
``op == "<op>"`` arms in :func:`serving.gang.follow`.  The protocol's
failure mode is DRIFT: a new dispatch variant publishes an op nobody
replays (followers hit the ``unknown gang op`` raise mid-stream and the
gang goes fatal under live traffic — exactly what the kill-mid-resize
chaos sweep exists to provoke), or an arm survives its last publisher
and rots unexercised.  Both directions are a set difference over
string literals, so this rule computes them at lint time: every
published op must have a replay arm, every arm must have a publisher.
The union is taken across the whole serving layer — resize publishes
``resize``/``resize_abort``/``resize_commit`` that gang.py replays, and
that cross-file pairing is the point.

``fault-pairing``: the chaos plan has the same shape one layer up —
factory methods append ``Fault(FaultKind.X, ...)`` (the failpoint
factories) and actuators consume them by checking ``f.kind ==
FaultKind.X`` (``due_*`` polls, ``pod_script``, ``socket_wrapper``,
``apply_cluster_faults``...).  A kind produced but never consumed is a
fault that can never fire (the chaos test asserts nothing); a kind
consumed but never produced is a dead actuator arm; a declared member
with neither is dead vocabulary.

Both rules anchor findings at the drifting site (the publish with no
arm, the arm with no publish) and carry line-free ratchet keys like
every other rule.  Pragmas silence intentional asymmetry::

    ch.publish(("debug_dump", blob))  # analysis: ok op-table — leader-only
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, Optional

from .astlint import Finding, LintContext, ParsedFile, rule

#: the serving layer IS the protocol scope: publishes in gang.py +
#: resize.py, arms in gang.py's follow() — scanned as ONE table so the
#: cross-file resize/replay pairing holds
OP_SCOPE_PREFIXES = ("kubeflow_tpu_torch/serving/",)

CHAOS_SCOPE_PREFIXES = ("kubeflow_tpu_torch/chaos/",)


def _scope_files(ctx: LintContext,
                 prefixes: tuple[str, ...]) -> list[ParsedFile]:
    """Every scope file, whether or not the lint selected it.

    Both rules here pair sites ACROSS files (resize.py publishes what
    gang.py replays), so a path-scoped run — ``platform_lint.py
    kubeflow_tpu_torch/serving/resize.py``, the advertised pre-commit fast
    path — must still build the table from the WHOLE scope or every
    cross-file pairing reports as drift.  Files the selection left out
    are parsed from disk for table construction only; findings are
    anchored exclusively in ``ctx.files`` (see the callers)."""
    out = [pf for rel, pf in sorted(ctx.files.items())
           if rel.startswith(prefixes)]
    seen = set(ctx.files)
    for prefix in prefixes:
        base = os.path.join(ctx.root, *prefix.rstrip("/").split("/"))
        if not os.path.isdir(base):
            continue
        for fn in sorted(os.listdir(base)):
            if not fn.endswith(".py"):
                continue
            rel = f"{prefix.rstrip('/')}/{fn}"
            if rel in seen:
                continue
            try:
                with open(os.path.join(base, fn), encoding="utf-8") as fh:
                    out.append(ParsedFile(rel, fh.read()))
            except (OSError, SyntaxError):
                continue  # unreadable/broken scope file: table best-effort
    return out


#: the follower dispatch variable name in follow()'s replay loop
_OP_VARS = frozenset({"op"})


def _published_ops(pf: ParsedFile):
    """(op, Call node) for every ``<x>.publish(("<op>", ...))``."""
    for node in pf.of_type(ast.Call):
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "publish"
                and node.args):
            continue
        arg = node.args[0]
        if (isinstance(arg, ast.Tuple) and arg.elts
                and isinstance(arg.elts[0], ast.Constant)
                and isinstance(arg.elts[0].value, str)):
            yield arg.elts[0].value, node


def _replay_scopes(pf: ParsedFile) -> list[ast.AST]:
    """Function bodies that LOOK like a replay dispatch loop: they bind
    ``op = <msg>[0]`` (the follower convention).  Restricting arm
    collection to these scopes keeps unrelated locals named ``op`` (the
    inference-graph condition parser's operator strings) out of the
    table."""
    marks = []
    for stmt in pf.of_type(ast.Assign):
        if (len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id in _OP_VARS
                and isinstance(stmt.value, ast.Subscript)
                and isinstance(stmt.value.slice, ast.Constant)
                and stmt.value.slice.value == 0):
            marks.append(stmt.lineno)
    out, seen = [], set()
    for node, _qual, _inner, _outer, _top in pf.defs:
        end = getattr(node, "end_lineno", node.lineno)
        if id(node) not in seen and any(
                node.lineno <= ln <= end for ln in marks):
            seen.add(id(node))
            out.append(node)
    return out


def _handled_ops(pf: ParsedFile):
    """(op, Compare node) for every ``op == "<op>"`` dispatch arm (and
    ``op in ("a", "b")`` multi-arm membership) inside a replay scope."""
    for fn in _replay_scopes(pf):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Compare):
                continue
            sides = [node.left] + list(node.comparators)
            names = [s for s in sides
                     if isinstance(s, ast.Name) and s.id in _OP_VARS]
            if not names:
                continue
            for s in sides:
                if isinstance(s, ast.Constant) and isinstance(s.value, str):
                    yield s.value, node
                elif isinstance(s, (ast.Tuple, ast.List, ast.Set)):
                    for e in s.elts:
                        if (isinstance(e, ast.Constant)
                                and isinstance(e.value, str)):
                            yield e.value, node


def _site_finding(ctx: LintContext, rule_name: str,
                  sites: list[tuple[ParsedFile, ast.AST]],
                  message: str) -> Optional[Finding]:
    """One finding per completeness violation, anchored at the first
    site inside the lint selection.  A pragma on ANY of the entry's
    sites suppresses it — the table entry is the unit of intent, and
    the declaring comment may legitimately sit on a site other than the
    one sorted first (two files publishing the same leader-only op)."""
    for pf, node in sites:
        if pf.allowed(getattr(node, "lineno", 1), rule_name):
            return None
    for pf, node in sites:
        if pf.relpath in ctx.files:
            return ctx.finding(pf, rule_name, node, message)
    return None  # drift anchored outside the selected paths: the full
    # lint (and tier-1) reports it at its own site


@rule("op-table")
def op_table(ctx: LintContext) -> Iterable[Finding]:
    published: dict[str, list[tuple[ParsedFile, ast.AST]]] = {}
    handled: dict[str, list[tuple[ParsedFile, ast.AST]]] = {}
    any_arms = False
    for pf in _scope_files(ctx, OP_SCOPE_PREFIXES):
        for op, node in _published_ops(pf):
            published.setdefault(op, []).append((pf, node))
        for op, node in _handled_ops(pf):
            any_arms = True
            handled.setdefault(op, []).append((pf, node))
    if not any_arms and not published:
        return
    for op in sorted(set(published) - set(handled)):
        f = _site_finding(
            ctx, "op-table", published[op],
            f"gang op `{op}` is published but has no follower replay "
            "arm — followers will die on `unknown gang op` mid-stream")
        if f:
            yield f
    for op in sorted(set(handled) - set(published)):
        f = _site_finding(
            ctx, "op-table", handled[op],
            f"dead replay arm: gang op `{op}` is handled but nothing "
            "publishes it")
        if f:
            yield f


def _faultkind_attr(node: ast.AST) -> Optional[str]:
    """'X' for a ``FaultKind.X`` attribute reference."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "FaultKind"):
        return node.attr
    return None


@rule("fault-pairing")
def fault_pairing(ctx: LintContext) -> Iterable[Finding]:
    declared: dict[str, list[tuple[ParsedFile, ast.AST]]] = {}
    produced: dict[str, list[tuple[ParsedFile, ast.AST]]] = {}
    consumed: dict[str, list[tuple[ParsedFile, ast.AST]]] = {}
    for pf in _scope_files(ctx, CHAOS_SCOPE_PREFIXES):
        # enum members: assignments inside ``class FaultKind``
        for node in pf.of_type(ast.ClassDef):
            if node.name == "FaultKind":
                for stmt in node.body:
                    if (isinstance(stmt, ast.Assign)
                            and isinstance(stmt.targets[0], ast.Name)):
                        declared.setdefault(
                            stmt.targets[0].id, []).append((pf, stmt))
        # producers: Fault(FaultKind.X, ...) — the failpoint factories
        for node in pf.of_type(ast.Call):
            if (isinstance(node.func, ast.Name)
                    and node.func.id == "Fault"):
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    k = _faultkind_attr(arg)
                    if k:
                        produced.setdefault(k, []).append((pf, node))
        # consumers: comparisons / membership tests on FaultKind.X
        for node in pf.of_type(ast.Compare):
            sides = [node.left] + list(node.comparators)
            for s in sides:
                k = _faultkind_attr(s)
                if k:
                    consumed.setdefault(k, []).append((pf, node))
                elif isinstance(s, (ast.Tuple, ast.List, ast.Set)):
                    for e in s.elts:
                        k = _faultkind_attr(e)
                        if k:
                            consumed.setdefault(k, []).append((pf, node))
    if not declared and not produced:
        return
    for kind in sorted(set(produced) - set(consumed)):
        f = _site_finding(
            ctx, "fault-pairing", produced[kind],
            f"FaultKind.{kind} is produced by a failpoint factory but "
            "no actuator consumes it — the fault can never fire")
        if f:
            yield f
    for kind in sorted(set(consumed) - set(produced)):
        f = _site_finding(
            ctx, "fault-pairing", consumed[kind],
            f"dead actuator arm: FaultKind.{kind} is consumed but no "
            "factory produces it")
        if f:
            yield f
    for kind in sorted(set(declared) - set(produced) - set(consumed)):
        f = _site_finding(
            ctx, "fault-pairing", declared[kind],
            f"FaultKind.{kind} is declared but neither produced nor "
            "consumed — dead chaos vocabulary")
        if f:
            yield f
