"""``torn-write``: the crash-safety commit protocol, made mechanical.

The port's copy of ``kubeflow_tpu/analysis/rules_persist.py``, scoped to
``kubeflow_tpu_torch/``.

Hand-rolled persistence lives in several modules
(`controlplane/wal.py`, `serving/storage.py`, `serving/programs.py`,
...) that all promise the same thing: a crash at ANY instruction leaves
either the old state or the new state on disk, never a torn hybrid.
The protocol behind that promise is always the same three steps —

    write to a tmp path  ->  flush + ``os.fsync``  ->  ``os.replace``

with a directory fsync where a manifest/rename is the commit point
(the rename is durable only once the directory entry is).  Until now
the discipline was enforced by review and chaos seeds; this rule makes
it a ratchet.  Three orderings are findings, each at the exact call:

- **bare final write** — ``open(final_path, "w"/"a"/"x")`` in a
  persistence module with no tmp staging: a crash mid-write leaves a
  torn file AT THE LIVE NAME.  Tmp-path writes (anything staged under
  a name that says so) are the protocol's first step and stay quiet.
  Append-mode logs that are DESIGNED to be torn-tail-repaired (the
  WAL) declare themselves with a pragma — that's the contract being
  stated, not the rule being dodged.
- **rename without fsync** — ``os.replace``/``os.rename`` with no
  fsync anywhere earlier in the function (direct ``os.fsync`` or a
  call whose effect set carries ``fsync`` — the ``_fsync_file``/
  ``_fsync_dir`` helpers and the WAL's ``_fsync_locked`` count via the
  call graph): the name commits while the payload may still be in the
  page cache, which is precisely the torn-write window.
- **fsync after replace** — a FILE fsync issued after the function's
  last rename: the name is already published before the data is
  durable, so the ordering protects nothing.  Directory fsyncs are
  exempt — ``fsync(dir)`` AFTER the rename is the correct final step
  (it makes the new directory entry itself durable).

Scope: modules that visibly participate in the commit protocol (any
lexical ``os.fsync``/``os.replace``/``os.rename``) plus the named
persistence core — so a random ``open(path, "w")`` in a bench script
is not a finding, but the same line in ``storage.py`` is.  Analysis is
per-function and lexical (event order by source position) with the
call graph supplying fsync effects; dynamic paths degrade to quiet,
like every under-approximation in this package.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from .astlint import Finding, LintContext, rule
from .callgraph import _dotted, get_graph

#: the persistence core is ALWAYS in scope, even if a refactor removed
#: every lexical fsync (which would itself be the regression to catch);
#: ``serving/programs.py`` is listed ahead of its port (the program
#: artifact cache)
PERSIST_PATHS = (
    "kubeflow_tpu_torch/controlplane/wal.py",
    "kubeflow_tpu_torch/serving/storage.py",
    "kubeflow_tpu_torch/serving/programs.py",
)

#: substrings that mark a path expression as STAGED (protocol step 1):
#: tmp/temp dirs, tempfile helpers, .part/.new spill conventions
_STAGED_MARKERS = ("tmp", "temp", "stag", "part", "new")

_RENAMES = ("os.replace", "os.rename")


def _write_mode(call: ast.Call) -> Optional[str]:
    """The mode string of a creating/truncating ``open``, else None."""
    f = call.func
    if not (isinstance(f, ast.Name) and f.id == "open"):
        return None
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    if isinstance(mode, str) and mode.startswith(("w", "a", "x")):
        return mode
    return None


def _path_source(call: ast.Call, assigns: dict[str, str]) -> str:
    """Best-effort text of the open()'s path argument, with one level
    of local-variable resolution so ``tmp = path + '.tmp';
    open(tmp, 'w')`` reads as staged."""
    if not call.args:
        return ""
    arg = call.args[0]
    src = ast.unparse(arg)
    if isinstance(arg, ast.Name) and arg.id in assigns:
        src = f"{src} = {assigns[arg.id]}"
    return src


def _is_staged(path_src: str) -> bool:
    low = path_src.lower()
    return any(m in low for m in _STAGED_MARKERS)


def _in_scope(pf) -> bool:
    if pf.relpath in PERSIST_PATHS:
        return True
    for node in pf.of_type(ast.Call):
        if _dotted(node.func) in ("os.fsync", "os.replace", "os.rename"):
            return True
    return False


def _fsync_kind(call: ast.Call, graph) -> Optional[str]:
    """'file' / 'dir' if this call fsyncs (directly or via a callee
    with the fsync effect), else None.  Ambiguous fd args count as
    'dir' — the exemption direction, never a false positive."""
    d = _dotted(call.func)
    if d in ("os.fsync", "fsync"):
        arg = call.args[0] if call.args else None
        if (isinstance(arg, ast.Call)
                and isinstance(arg.func, ast.Attribute)
                and arg.func.attr == "fileno"):
            return "file"
        return "dir"
    for callee in graph.resolve_call(call):
        if "fsync" in graph.effects(callee):
            name = callee.rsplit(".", 1)[-1].lower()
            return "dir" if "dir" in name else "file"
    return None


@rule("torn-write")
def torn_write(ctx: LintContext) -> Iterable[Finding]:
    graph = get_graph(ctx)
    by_rel: dict[str, list] = {}
    for fq, fi in sorted(graph.funcs.items()):
        by_rel.setdefault(fi.relpath, []).append(fi)
    for rel, pf in sorted(ctx.files.items()):
        if not _in_scope(pf):
            continue
        for fi in by_rel.get(rel, ()):
            # one lexical pass over the OWN body: opens, fsyncs, renames
            pos = lambda n: (n.lineno, n.col_offset)  # noqa: E731
            assigns: dict[str, str] = {}
            for node in ast.walk(fi.node):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    assigns.setdefault(node.targets[0].id,
                                       ast.unparse(node.value))
            opens: list[tuple[tuple, ast.Call, str]] = []
            fsyncs: list[tuple[tuple, str]] = []
            renames: list[tuple[tuple, ast.Call]] = []
            for call in fi.calls:
                mode = _write_mode(call)
                if mode is not None:
                    opens.append((pos(call), call, mode))
                kind = _fsync_kind(call, graph)
                if kind is not None:
                    fsyncs.append((pos(call), kind))
                if _dotted(call.func) in _RENAMES:
                    renames.append((pos(call), call))

            for p, call, mode in opens:
                path_src = _path_source(call, assigns)
                if _is_staged(path_src):
                    continue
                f = ctx.finding(
                    pf, "torn-write", call,
                    f"crash-visible write `open({path_src or '...'}, "
                    f"{mode!r})` outside the tmp->fsync->`os.replace` "
                    "commit protocol — a crash mid-write tears the "
                    "live file")
                if f:
                    yield f

            for p, call in renames:
                if any(fp < p for fp, _k in fsyncs):
                    continue
                target = ast.unparse(call.args[0]) if call.args else "..."
                f = ctx.finding(
                    pf, "torn-write", call,
                    f"`{_dotted(call.func)}` of `{target}` publishes "
                    "without a preceding fsync — the name commits while "
                    "the payload may still be in the page cache")
                if f:
                    yield f

            if renames:
                last_rename, anchor = max(renames)
                for fp, kind in fsyncs:
                    if kind == "file" and fp > last_rename:
                        f = ctx.finding(
                            pf, "torn-write", anchor,
                            "file fsync ordered AFTER the rename commit "
                            "— the name publishes before the data is "
                            "durable; fsync the payload first (dir "
                            "fsync is what belongs after)")
                        if f:
                            yield f
                        break
