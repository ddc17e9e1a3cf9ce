"""AST lint framework: parse once, run rules, ratchet against a baseline.

The port's copy of ``kubeflow_tpu/analysis/astlint.py``: the same
``Finding``/``ParsedFile``/``LintContext``, pragma grammar, rule
registry and baseline ratchet, linting ``kubeflow_tpu_torch/`` against
its own ``baseline.json``.

Pure stdlib by design — the tier-1 ratchet test and the CLI must parse
the whole port in a second or two, so nothing here may import torch,
numpy, or any platform module.

Key ratchet property: finding identity (:meth:`Finding.key`) is
LINE-NUMBER-FREE — ``path::rule::scope::message`` — so unrelated edits
that shift a frozen finding up or down the file do not resurrect it as
"new".  Two identical findings in one scope collapse to a count, and the
baseline stores counts: the ratchet fails when the count for any key
*grows*, shrinking is always allowed (that is the point).
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

#: pragma grammar: ``# analysis: ok <rule>[, <rule>...][ — reason]`` on
#: the offending line or the line directly above it
_PRAGMA = re.compile(
    r"#\s*analysis:\s*ok\s+([a-z0-9-]+(?:\s*,\s*[a-z0-9-]+)*)")

#: hot-path aliases for the single indexing recursion
_AST = ast.AST
_ClassDef = ast.ClassDef
_FunctionDef = ast.FunctionDef
_AsyncFunctionDef = ast.AsyncFunctionDef

#: node shapes the per-def body lists record (what the call-graph body
#: scan consumes); nested defs are recorded by their own branch
_BODY_TYPES = frozenset({ast.Call, ast.With, ast.AsyncWith, ast.Assign})

#: entering these marks the subtree lexically guarded: if/try/ternary
#: are the cache-miss idiom, a lambda body runs later (if ever)
_GUARD_TYPES = frozenset({ast.If, ast.Try, ast.IfExp, ast.Lambda})

#: the established swallowed-exception justification form (the exemplar
#: is hpo/controllers.py's db-retry sites): ``# noqa: BLE001`` is only a
#: justification when a REASON follows the dash — a bare noqa is exactly
#: the silent swallow the rule exists to surface
_NOQA_JUSTIFIED = re.compile(r"#\s*noqa:\s*BLE001\s*(?:—|--|-)\s*\S")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str      # repo-relative, posix separators
    line: int      # 1-based, for humans; NOT part of the ratchet key
    scope: str     # enclosing function/class qualname ('' = module level)
    message: str

    @property
    def key(self) -> str:
        return f"{self.path}::{self.rule}::{self.scope}::{self.message}"

    def __str__(self) -> str:
        where = f"{self.path}:{self.line}"
        scope = f" [{self.scope}]" if self.scope else ""
        return f"{where}: {self.rule}{scope}: {self.message}"


class ParsedFile:
    """One module parsed once and shared by every rule."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=relpath)
        #: id(node) -> ordered child nodes: the ONE tree traversal,
        #: done at parse time, that every later pass reuses.
        #: ``ast.iter_child_nodes`` costs a generator + getattr per
        #: field per visit; over ~250k nodes x several passes that IS
        #: the lint's wall time, so children are extracted once here
        #: (straight from ``__dict__``, which preserves field order)
        #: and every other walk is a dict lookup.  The parser's shared
        #: singletons (Load/Store/Add/... — 36% of all nodes, zero
        #: analytical value; recognizable by their empty ``__dict__``)
        #: are dropped entirely.  Leaves store no entry — read with
        #: ``.get``.
        self.children: dict[int, list[ast.AST]] = {}
        #: node type -> nodes of that type, pre-order.  Rules that scan
        #: for one shape (every With, every Call) index this instead of
        #: re-walking the tree.
        self.by_type: dict[type, list[ast.AST]] = {}
        #: id(def node) -> [(node, lexically_guarded)] for the def's
        #: OWN body: its Call/With/Assign statements and immediate
        #: nested defs, with nested-def SUBTREES attributed to the
        #: nested def and lambda bodies attributed (guarded) to the
        #: enclosing def.  ``guarded`` = under an ``if``/``try``/
        #: ternary/lambda — the lexical shape of the cache-miss idiom.
        #: This is the call-graph body scan, prepaid during indexing so
        #: the graph build never re-walks a body.
        self.body_items: dict[int, list[tuple[ast.AST, bool]]] = {}
        #: (node, qual, innermost_class, outermost_class, is_top_level)
        #: for every def — the shared function table the call graph and
        #: the lock/thread rules index from instead of re-recursing
        self.defs: list[tuple[ast.AST, str, str, str, bool]] = []
        #: (node, qual, innermost enclosing class) for every ClassDef
        self.classdefs: list[tuple[ast.ClassDef, str, str]] = []
        #: line -> set of rule names pragma'd ok on that line
        self.pragmas: dict[int, set[str]] = {}
        for i, ln in enumerate(self.lines, start=1):
            m = _PRAGMA.search(ln)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")}
                self.pragmas.setdefault(i, set()).update(rules)
        # scope map: line -> innermost function/class qualname
        self._scopes: list[tuple[int, int, str]] = []
        self._index(self.tree, "", "", "", True, None, False)

    def _index(self, node: ast.AST, prefix: str, inner_cls: str,
               outer_cls: str, is_top: bool,
               body: Optional[list], guarded: bool) -> None:
        """The single indexing recursion: fills the children map, the
        by-type buckets, the scope spans, the def/class tables, and the
        per-def body-item lists in one pass."""
        kids: list[ast.AST] = []
        for v in node.__dict__.values():
            if type(v) is list:
                for x in v:
                    if isinstance(x, _AST) and x.__dict__:
                        kids.append(x)
            elif isinstance(v, _AST) and v.__dict__:
                kids.append(v)
        if not kids:
            return
        self.children[id(node)] = kids
        by_type = self.by_type
        for child in kids:
            t = type(child)
            b = by_type.get(t)
            if b is None:
                by_type[t] = b = []
            b.append(child)
            if t is _ClassDef:
                qual = prefix + child.name
                end = getattr(child, "end_lineno", child.lineno)
                self._scopes.append((child.lineno, end, qual))
                self.classdefs.append((child, qual, inner_cls))
                # class-level statements of a LOCAL class stay in the
                # enclosing def's body (they run when the def runs)
                self._index(child, qual + ".", child.name,
                            outer_cls or child.name, False, body, guarded)
            elif t is _FunctionDef or t is _AsyncFunctionDef:
                qual = prefix + child.name
                end = getattr(child, "end_lineno", child.lineno)
                self._scopes.append((child.lineno, end, qual))
                self.defs.append((child, qual, inner_cls, outer_cls,
                                  is_top))
                if body is not None:
                    body.append((child, guarded))
                new_body: list = []
                self.body_items[id(child)] = new_body
                self._index(child, qual + ".", inner_cls, outer_cls,
                            False, new_body, False)
            else:
                if body is not None and t in _BODY_TYPES:
                    body.append((child, guarded))
                self._index(child, prefix, inner_cls, outer_cls, is_top,
                            body, guarded or t in _GUARD_TYPES)

    def of_type(self, *types: type) -> list[ast.AST]:
        """Pre-indexed nodes of the given exact types, document order
        per type (concrete ast node classes have no subclasses, so the
        exact-type buckets are exhaustive)."""
        if len(types) == 1:
            return self.by_type.get(types[0], [])
        out: list[ast.AST] = []
        for t in types:
            out.extend(self.by_type.get(t, ()))
        return out

    def scope_at(self, line: int) -> str:
        """Innermost def/class qualname covering ``line``."""
        best, best_span = "", None
        for start, end, qual in self._scopes:
            if start <= line <= end:
                span = end - start
                if best_span is None or span <= best_span:
                    best, best_span = qual, span
        return best

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""

    def allowed(self, line: int, rule: str) -> bool:
        """Pragma on the offending line or the line above silences the
        rule there (the noqa-above convention for long call lines)."""
        for ln in (line, line - 1):
            if rule in self.pragmas.get(ln, set()):
                return True
        return False

    def has_justified_noqa(self, line: int) -> bool:
        for ln in (line, line - 1):
            if _NOQA_JUSTIFIED.search(self.line_text(ln)):
                return True
        return False


@dataclass
class LintContext:
    """Everything the rule set sees: all parsed files, keyed by relpath."""

    root: str
    files: dict[str, ParsedFile] = field(default_factory=dict)

    def finding(self, pf: ParsedFile, rule: str, node: ast.AST,
                message: str) -> Optional[Finding]:
        """Finding at ``node`` unless a pragma silences it."""
        line = getattr(node, "lineno", 1)
        if pf.allowed(line, rule):
            return None
        return Finding(rule=rule, path=pf.relpath, line=line,
                       scope=pf.scope_at(line), message=message)


#: rule registry: name -> fn(ctx) -> iterable of findings.  Rules are
#: whole-context (lock-order needs the cross-module graph); per-file
#: rules just iterate ctx.files.
RuleFn = Callable[[LintContext], Iterable[Finding]]
_RULES: dict[str, RuleFn] = {}


def rule(name: str) -> Callable[[RuleFn], RuleFn]:
    def deco(fn: RuleFn) -> RuleFn:
        _RULES[name] = fn
        return fn
    return deco


def rule_names() -> list[str]:
    _ensure_rules_loaded()
    return sorted(_RULES)


def _ensure_rules_loaded() -> None:
    # rule modules self-register via @rule at import; imported lazily so
    # `from .astlint import Finding` never recurses
    from . import (  # noqa: F401
        rules_clock,
        rules_dispatch,
        rules_hygiene,
        rules_locks,
        rules_metrics,
        rules_persist,
        rules_protocol,
        rules_threads,
    )


#: directories under the repo root that hold the port's code to lint;
#: tests/ is deliberately out (fixture snippets there are true positives
#: on purpose), artifacts/examples hold generated/demo code, and the
#: scripts/ directory belongs to the reference package
LINT_DIRS = ("kubeflow_tpu_torch",)


def discover(root: str) -> list[str]:
    out = []
    for d in LINT_DIRS:
        base = os.path.join(root, d)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [x for x in dirnames if x != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(out)


@dataclass
class LintReport:
    findings: list[Finding]

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.key] = out.get(f.key, 0) + 1
        return out

    def by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out


def parse_paths(root: str, paths: Iterable[str]) -> LintContext:
    ctx = LintContext(root=root)
    for p in paths:
        rel = os.path.relpath(p, root)
        with open(p, "r", encoding="utf-8") as fh:
            text = fh.read()
        try:
            ctx.files[rel.replace(os.sep, "/")] = ParsedFile(rel, text)
        except SyntaxError:
            # a file the platform cannot even parse is somebody else's
            # build break, not a lint finding
            continue
    return ctx


def run_lint(root: str, paths: Optional[Iterable[str]] = None,
             rules: Optional[Iterable[str]] = None) -> LintReport:
    """Parse ``paths`` (default: the platform dirs under ``root``) and
    run ``rules`` (default: all registered)."""
    _ensure_rules_loaded()
    ctx = parse_paths(root, paths if paths is not None else discover(root))
    wanted = list(rules) if rules is not None else sorted(_RULES)
    findings: list[Finding] = []
    for name in wanted:
        findings.extend(_RULES[name](ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return LintReport(findings)


# -- baseline ratchet ------------------------------------------------------

def baseline_path(root: str) -> str:
    return os.path.join(root, "kubeflow_tpu_torch", "analysis", "baseline.json")


def load_baseline(path: str) -> dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def write_baseline(path: str, report: LintReport) -> dict:
    """Freeze the current findings as the new debt ceiling."""
    doc = {
        "comment": (
            "platform_lint ratchet baseline: frozen findings debt. "
            "New findings FAIL tier-1; shrink freely, grow never. "
            "Regenerate with `python -m kubeflow_tpu_torch.analysis "
            "--update-baseline` only for reviewed, intentional debt."),
        "by_rule": report.by_rule(),
        "findings": dict(sorted(report.counts().items())),
    }
    # the analyzer obeys its own torn-write rule: tmp-path write ->
    # flush+fsync -> atomic replace, so a crash mid-update leaves the
    # previous baseline intact rather than a half-written ratchet
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=False)
        fh.write("\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return doc


def compare_to_baseline(report: LintReport,
                        baseline: dict[str, int]) -> list[Finding]:
    """Findings above the frozen debt: for each key, any occurrences
    beyond the baselined count (a brand-new key has baseline 0)."""
    counts: dict[str, int] = {}
    new: list[Finding] = []
    for f in report.findings:
        counts[f.key] = counts.get(f.key, 0) + 1
        if counts[f.key] > baseline.get(f.key, 0):
            new.append(f)
    return new
