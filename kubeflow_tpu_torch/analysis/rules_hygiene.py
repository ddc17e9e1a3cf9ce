"""Hygiene rules: swallowed exceptions, pickle ingestion, thread daemons.

The port's copy of ``kubeflow_tpu/analysis/rules_hygiene.py``; the
pickle allowlist names the port's ``serving/gang.py``.

``swallowed-exception``: a blanket ``except Exception`` that neither
re-raises, logs, nor carries a justification is how the chaos harness's
bug class hides — a double restart-bump survives as long as failure
paths stay quiet.  The contract: every blanket
handler must (a) re-raise, (b) call a logger (``log.debug(...)``,
``log.exception(...)``, ``traceback.print_exc()``...), or (c) carry a
justification — either the pragma ``# analysis: ok swallowed-exception``
or the established ``# noqa: BLE001 — <reason>`` form (reason
REQUIRED; hpo/controllers.py's db-retry sites are the exemplar).

``unsafe-pickle``: ``pickle.load``/``loads`` is code execution on
attacker bytes.  The ONE legitimate ingestion point is the gang
channel's post-auth replay stream (``GangChannel._recv_frame`` —
handshake frames are length-capped JSON *by design* precisely so no
pre-auth pickle ever runs; see serving/gang.py).  Anything else fails.

``nondaemon-thread``: a helper thread without ``daemon=True`` (or a
``t.daemon = True`` assignment right after construction) keeps the
interpreter alive after main exits — the wedged-shutdown class chaos
runs turn into hung CI jobs.  Threads that must outlive main on
purpose carry the pragma.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .astlint import Finding, LintContext, rule
from .rules_dispatch import _dotted

# -- swallowed-exception ---------------------------------------------------

_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log"}
_LOG_FUNCS = {"print", "print_exc", "print_exception", "print_stack"}


def _is_blanket(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare except:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    elif isinstance(t, ast.Name):
        names = [t.id]
    return bool({"Exception", "BaseException"} & set(names))


def _body_handles(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _LOG_METHODS:
                return True
            if isinstance(f, ast.Name) and f.id in _LOG_FUNCS:
                return True
            if isinstance(f, ast.Attribute) and f.attr in _LOG_FUNCS:
                return True
    return False


@rule("swallowed-exception")
def swallowed_exception(ctx: LintContext) -> Iterable[Finding]:
    for pf in ctx.files.values():
        for node in pf.of_type(ast.ExceptHandler):
            if not _is_blanket(node):
                continue
            if _body_handles(node):
                continue
            if pf.has_justified_noqa(node.lineno):
                continue
            f = ctx.finding(
                pf, "swallowed-exception", node,
                "blanket `except Exception` without log, re-raise, or "
                "justification (`# noqa: BLE001 — <reason>` or "
                "`# analysis: ok swallowed-exception`)")
            if f:
                yield f


# -- unsafe-pickle ---------------------------------------------------------

#: the post-auth gang replay ingestion point: the ONLY scope allowed to
#: unpickle wire bytes (path, enclosing scope qualname)
PICKLE_ALLOWLIST = {
    ("kubeflow_tpu_torch/serving/gang.py", "GangChannel._recv_frame"),
}


def _is_pickle_load(call: ast.Call) -> bool:
    d = _dotted(call.func)
    if d in ("pickle.load", "pickle.loads", "cPickle.load",
             "cPickle.loads", "pickle.Unpickler", "dill.load",
             "dill.loads"):
        return True
    return isinstance(call.func, ast.Name) and call.func.id == "Unpickler"


@rule("unsafe-pickle")
def unsafe_pickle(ctx: LintContext) -> Iterable[Finding]:
    for pf in ctx.files.values():
        for node in pf.of_type(ast.Call):
            if not _is_pickle_load(node):
                continue
            scope = pf.scope_at(node.lineno)
            if (pf.relpath, scope) in PICKLE_ALLOWLIST:
                continue
            f = ctx.finding(
                pf, "unsafe-pickle", node,
                "pickle ingestion outside the post-auth gang replay "
                "allowlist (pickle.loads on wire bytes is arbitrary "
                "code execution)")
            if f:
                yield f


# -- nondaemon-thread ------------------------------------------------------

def _is_thread_ctor(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "Thread":
        return True
    return isinstance(f, ast.Name) and f.id == "Thread"


def _daemon_kwarg_true(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon":
            return (isinstance(kw.value, ast.Constant)
                    and kw.value.value is True)
    return False


@rule("nondaemon-thread")
def nondaemon_thread(ctx: LintContext) -> Iterable[Finding]:
    for pf in ctx.files.values():
        for node in pf.of_type(ast.Call):
            if not _is_thread_ctor(node):
                continue
            if _daemon_kwarg_true(node):
                continue
            # `t.daemon = True` immediately after construction counts
            end = getattr(node, "end_lineno", node.lineno)
            if any(".daemon = True" in pf.line_text(ln)
                   for ln in range(node.lineno, end + 4)):
                continue
            f = ctx.finding(
                pf, "nondaemon-thread", node,
                "threading.Thread without daemon=True (wedges "
                "interpreter shutdown; pragma if it must outlive main)")
            if f:
                yield f
