"""Cross-module call graph + effect propagation: the analyzer's spine.

The port's copy of ``kubeflow_tpu/analysis/callgraph.py``: the engine
(edges, effect sets, fixpoint, reachability) is the reference's; the
host-sync and program-construction matchers speak torch.

A helper one module away from the scheduler can ``.item()``, ``.cpu()``,
``sendall()`` or fsync, which on the card silently drains the stream
the engine's dispatch-ahead design exists to keep full.  This module
builds ONE graph over every file in the
:class:`~kubeflow_tpu_torch.analysis.astlint.LintContext` and infers
per-function **effect sets** bottom-up, so rules ask "what does calling
this reach?" instead of re-walking ASTs:

- **Edges** resolve ``from .x import y`` / ``import a.b as c`` symbol
  and module aliases, bare ``name(...)`` calls (nested defs, module
  functions, imported functions, class constructors -> ``__init__``),
  ``self._helper()`` through the cross-module MRO (base classes
  resolved through imports), ``self.X(...)`` getter aliases
  (``self.X = nested_fn``), and one level of attribute typing:
  ``self.store = KvSpillStore(...)`` in any method makes
  ``self.store.write()`` resolve to ``KvSpillStore.write``
  (conflicting assignments degrade the attribute to untyped).
  Anything dynamic — ``getattr(o, n)()``, callables passed as
  arguments, dict-of-fns dispatch — degrades to NO edge, never a
  crash: the graph under-approximates by design and the rules say so.
- **Effects** (:data:`EFFECTS`) are inferred per function from its own
  body and propagated callee->caller with a cycle-safe monotone
  fixpoint (recursion and mutual recursion converge because effect
  sets only grow and are bounded).  Each (function, effect) keeps one
  witness site — the terminal call the effect came from — so findings
  can say *where* the blocking call actually lives.
- **Nested defs** get a pseudo-edge from their enclosing function:
  reachability treats a closure built by a reachable function as
  reachable (the scheduler hands closures to dispatch paths).  The one
  exception is ``jit-unguarded`` (below), which nested edges do NOT
  carry — a nested def builds its program lazily when *called*.
- **jit-construct / jit-unguarded**: program construction (CUDA graph
  capture — ``torch.cuda.graph`` / ``torch.cuda.CUDAGraph`` /
  ``.capture_begin`` / ``torch.cuda.make_graphed_callables`` —,
  ``torch.compile`` and the ``make_*_program`` factories) is an effect;
  ``jit-unguarded`` additionally requires the construction NOT be
  under an ``if``/``try`` (the cache-guard idiom) and not in a
  memoizing (``@lru_cache``-style) function, and it propagates only
  through call sites that are themselves unguarded — calling a cached
  getter in a loop is fine, calling an unconditional factory is the
  recapture treadmill.  The effect names are the reference's, so a
  pragma reads the same in both packages.
- **Host sync** (:data:`HOST_SYNC_MATCHERS`): ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")`` /
  ``.to(device="cpu")``, ``torch.cuda.synchronize()``,
  ``Event.synchronize()`` / ``Stream.synchronize()``, numpy
  materialization and the scalarized reduction.  Where the construct is
  the reference's, so is the label.

Consumers: ``host-sync-in-dispatch`` and ``jit-in-loop``
(rules_dispatch); ``lock-blocking-call`` (rules_locks) joins the lock
model to the effect sets; ``torn-write`` (rules_persist) uses the
``fsync`` effect to credit ``_fsync_dir``-style helpers.  The graph is
built once per lint run (memoized on the context).

Pure stdlib, like everything in this package.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .astlint import LintContext, ParsedFile

#: the effect vocabulary.  ``host-sync`` covers device materialization
#: (``.item()``/``.cpu()``/``synchronize``/np-materialize/...),
#: ``socket`` the blocking socket verbs, ``fsync`` the blocking
#: file-commit op (plain buffered writes are ``file-write``), ``lock``
#: any lock/Condition acquisition, and the jit pair (program
#: construction, named as in the reference) is documented in the module
#: docstring.
EFFECTS = (
    "host-sync", "socket", "sleep", "fsync", "file-write",
    "urlopen", "thread-join", "lock", "jit-construct", "jit-unguarded",
)

#: effects that mean "the caller blocks": what lock-blocking-call flags
BLOCKING_EFFECTS = frozenset(
    {"host-sync", "socket", "sleep", "fsync", "urlopen", "thread-join"})

#: scheduler entry points: methods of any ``*Engine`` class from which
#: the dispatch-path reachability walk starts (rules_dispatch roots
#: them through the MRO; rules_threads classifies them as the
#: scheduler role).  The port's engine keeps the reference's names;
#: its program runner ``_Dispatch.run`` is reached from them through
#: the ``self._dispatch`` attribute type, so it needs no root of its own
ROOT_METHODS = ("_loop", "_loop_inner", "_admit", "_process", "step",
                "_dispatch")

#: lifecycle entries that run OUTSIDE the concurrent/steady-state phase
#: (the same contract rules_threads encodes): __init__ builds the
#: object before any thread exists, warmup runs before traffic,
#: stop/close after the scheduler joined.  Dispatch-reachability walks
#: do not traverse INTO these (a root that IS one still gets scanned),
#: and program construction inside __init__/warmup is object-lifecycle
#: capture, not a per-iteration treadmill.
LIFECYCLE_METHODS = frozenset({
    "__init__", "warmup", "stop", "close", "shutdown", "start",
})

#: warmup's private phase helpers (``_warmup_locked``, ``_warmup_paged``)
#: run only inside ``warmup``, under its gate and before traffic: they
#: are the warmup phase, and every rule that cuts lifecycle methods cuts
#: them too
_WARMUP_HELPER = "_warmup"


def is_lifecycle(name: str) -> bool:
    """True for a lifecycle method's bare name (:data:`LIFECYCLE_METHODS`
    or a ``_warmup*`` phase helper)."""
    return name in LIFECYCLE_METHODS or name.startswith(_WARMUP_HELPER)


#: construction sinks: what ``__init__``/warmup construct is
#: object-lifecycle capture, so the jit-unguarded effect stops there
def _is_construction_sink(name: str) -> bool:
    return name == "__init__" or name == "warmup" or name.startswith(
        _WARMUP_HELPER)


_MAKE_PROGRAM = re.compile(r"^make_\w*_program$")

#: lexical lock-name markers (rules_locks keeps its own copy for lock
#: *identity*; this one only decides whether a with-item / .acquire()
#: receiver is lock-ish enough to count as the ``lock`` effect)
_LOCKISH = ("lock", "gate", "cond", "mutex", "cv", "sem")

_WRITE_MODES = ("w", "a", "x")


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def walk_skip_defs(node: ast.AST,
                   children: Optional[dict] = None) -> Iterable[ast.AST]:
    """ast.walk that does NOT descend into nested function/lambda bodies
    — a def inside the scanned region runs later (if ever), not here.
    Pass ``ParsedFile.children`` to reuse the parse-time child map
    instead of re-deriving children per visit (the fast path every
    in-context caller uses)."""
    if children is None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _DEF_NODES):
                continue
            yield child
            yield from walk_skip_defs(child)
        return
    stack = [c for c in reversed(children.get(id(node), ()))
             if not isinstance(c, _DEF_NODES)]
    while stack:
        n = stack.pop()
        yield n
        kids = children.get(id(n))
        if kids:
            for i in range(len(kids) - 1, -1, -1):
                c = kids[i]
                if not isinstance(c, _DEF_NODES):
                    stack.append(c)


# -- host-materialization matchers (shared with rules_dispatch) ------------

def _is_item(call: ast.Call) -> bool:
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "item" and not call.args)


def _is_tolist(call: ast.Call) -> bool:
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "tolist" and not call.args)


def _is_cpu(call: ast.Call) -> bool:
    """``t.cpu()``: a device-to-host copy the caller waits for."""
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "cpu" and not call.args)


def _is_numpy(call: ast.Call) -> bool:
    """``t.numpy()`` / ``t.numpy(force=True)``: host materialization."""
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "numpy" and not call.args)


def _is_cpu_device(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and _dotted(node.func) in ("torch.device", "device")
            and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


def _is_to_cpu(call: ast.Call) -> bool:
    """``t.to("cpu")`` / ``t.to(device="cpu")`` (or a
    ``torch.device("cpu")`` in either place)."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    if call.args and _is_cpu_device(call.args[0]):
        return True
    return any(kw.arg == "device" and _is_cpu_device(kw.value)
               for kw in call.keywords)


_CUDA_SYNCHRONIZE = ("torch.cuda.synchronize", "cuda.synchronize")


def _is_cuda_synchronize(call: ast.Call) -> bool:
    return _dotted(call.func) in _CUDA_SYNCHRONIZE


def _is_stream_synchronize(call: ast.Call) -> bool:
    """``event.synchronize()`` / ``stream.synchronize()``: the host waits
    for the card (``torch.cuda.synchronize`` has its own label)."""
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "synchronize"
            and not _is_cuda_synchronize(call))


def _is_np_materialize(call: ast.Call) -> bool:
    d = _dotted(call.func)
    if d not in _NP_MATERIALIZE:
        return False
    if not call.args:
        return False
    # materializing an obvious host literal is not a device fetch
    return not isinstance(call.args[0], _HOST_LITERALS)


_REDUCERS = {"max", "min", "sum", "mean", "any", "all", "argmax", "argmin"}

#: np.asarray/np.array spellings + the literal arg shapes that make one
#: a host materialization rather than a device fetch (shared between
#: the matcher below and the flattened _BodyScan fast path)
_NP_MATERIALIZE = ("np.asarray", "np.array", "numpy.asarray",
                   "numpy.array", "onp.asarray", "onp.array")
_HOST_LITERALS = (ast.List, ast.ListComp, ast.Tuple, ast.Constant)


def _is_scalarized_reduction(call: ast.Call) -> bool:
    """float(x.max()) / int(a[m].sum()): forces the reduced value to a
    Python scalar — a sync when x lives on the card."""
    if not (isinstance(call.func, ast.Name)
            and call.func.id in ("float", "int", "bool")
            and len(call.args) == 1):
        return False
    a = call.args[0]
    return (isinstance(a, ast.Call) and isinstance(a.func, ast.Attribute)
            and a.func.attr in _REDUCERS)


#: the torch labels (constructs the reference has no spelling for)
LABEL_CPU = "`.cpu()`"
LABEL_NUMPY = "`.numpy()`"
LABEL_TO_CPU = "`.to(\"cpu\")`"
LABEL_CUDA_SYNC = "`torch.cuda.synchronize`"
LABEL_STREAM_SYNC = "`Event.synchronize`/`Stream.synchronize`"

#: (label, matcher) pairs for the ``host-sync`` effect.  The labels of
#: the constructs the reference also has (``.item()``, ``.tolist()``,
#: numpy materialization, the scalarized reduction) are its strings, so
#: a pragma or a finding reads the same in both packages; the torch
#: spellings replace ``jax.device_get`` (``.cpu()``, ``.numpy()``,
#: ``.to("cpu")``) and ``block_until_ready`` (the synchronizes)
HOST_SYNC_MATCHERS = (
    ("`.item()`", _is_item),
    ("`.tolist()`", _is_tolist),
    (LABEL_CPU, _is_cpu),
    (LABEL_NUMPY, _is_numpy),
    (LABEL_TO_CPU, _is_to_cpu),
    (LABEL_CUDA_SYNC, _is_cuda_synchronize),
    (LABEL_STREAM_SYNC, _is_stream_synchronize),
    ("numpy materialization (`np.asarray`/`np.array`)", _is_np_materialize),
    ("scalarized reduction (`int`/`float` of `.max()`-like)",
     _is_scalarized_reduction),
)

_BLOCKING_SOCKET_ATTRS = {"sendall", "recv", "recv_into", "accept"}


def is_blocking_socket(call: ast.Call) -> bool:
    if (isinstance(call.func, ast.Attribute)
            and call.func.attr in _BLOCKING_SOCKET_ATTRS):
        return True
    return _dotted(call.func) in ("socket.create_connection",
                                  "create_connection")


#: dotted spellings of program construction: CUDA graph capture and
#: torch.compile (the port's counterparts of ``jax.jit``/``mesh_jit``)
_CONSTRUCT_DOTTED = frozenset({
    "torch.cuda.graph", "cuda.graph",
    "torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph",
    "torch.cuda.make_graphed_callables", "make_graphed_callables",
    "torch.compile",
})


def is_program_construction(call: ast.Call) -> bool:
    f = call.func
    if _dotted(f) in _CONSTRUCT_DOTTED:
        return True
    name = None
    if isinstance(f, ast.Name):
        name = f.id
    elif isinstance(f, ast.Attribute):
        name = f.attr
    if name is None:
        return False
    return name == "capture_begin" or bool(_MAKE_PROGRAM.match(name))


def _is_sleep(call: ast.Call) -> bool:
    return _dotted(call.func) in ("time.sleep", "sleep")


def _is_fsync(call: ast.Call) -> bool:
    return _dotted(call.func) in ("os.fsync", "fsync")


def _is_urlopen(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Name) and f.id == "urlopen":
        return True
    return isinstance(f, ast.Attribute) and f.attr == "urlopen"


def _is_thread_join(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "join"
            and "thread" in (_dotted(f.value) or "").lower())


def _is_file_write_open(call: ast.Call) -> bool:
    """``open(path, "w"/"a"/"x"...)`` — a creating/truncating write."""
    f = call.func
    name = f.id if isinstance(f, ast.Name) else None
    if name != "open":
        return False
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return isinstance(mode, str) and mode.startswith(_WRITE_MODES)


def _lockish_name(expr: ast.AST) -> Optional[str]:
    d = _dotted(expr)
    if d is None:
        return None
    last = d.rsplit(".", 1)[-1].lower()
    return d if any(k in last for k in _LOCKISH) else None


# -- the graph -------------------------------------------------------------

@dataclass
class FuncInfo:
    """One function/method: identity, own-body calls, outgoing edges."""

    fqual: str                       # "pkg.mod::Cls.meth"
    mod: str
    relpath: str
    cls: str                         # innermost owning class name, '' = none
    node: ast.AST
    #: every Call in the OWN body (nested defs excluded, lambdas
    #: included — a lambda built here is this function's code)
    calls: list[ast.Call] = field(default_factory=list)
    #: (Call, guarded) as collected — consumed by the resolve phase
    raw: list[tuple[ast.Call, bool]] = field(default_factory=list)
    #: (callee fqual, call node | None, guarded) — node None = nested-def
    #: pseudo-edge
    edges: list[tuple[str, Optional[ast.Call], bool]] = (
        field(default_factory=list))
    intrinsic: set[str] = field(default_factory=set)


@dataclass
class ClassInfo:
    mod: str
    name: str
    node: ast.ClassDef
    methods: dict[str, str] = field(default_factory=dict)   # name -> fqual
    bases: list[tuple[str, str]] = field(default_factory=list)
    #: self.<attr> -> (mod, cls) from single-typed ``self.x = Cls(...)``
    attr_types: dict[str, Optional[tuple[str, str]]] = (
        field(default_factory=dict))
    #: self.<attr> -> fqual from ``self.x = <function>`` getter installs
    fn_aliases: dict[str, str] = field(default_factory=dict)


def _module_name(relpath: str) -> str:
    parts = relpath[:-3].split("/") if relpath.endswith(".py") else (
        relpath.split("/"))
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class CallGraph:
    """The whole-context call graph.  Build once via :func:`get_graph`."""

    def __init__(self, ctx: LintContext):
        self.ctx = ctx
        #: module name -> relpath (only modules in the context resolve)
        self.modules: dict[str, str] = {}
        #: module name -> top-level name -> ("func"|"class", local qual)
        self.toplevel: dict[str, dict[str, tuple[str, str]]] = {}
        self.funcs: dict[str, FuncInfo] = {}
        self.classes: dict[tuple[str, str], ClassInfo] = {}
        #: module -> local alias -> ("module", modname) |
        #: ("symbol", modname, name)
        self.imports: dict[str, dict[str, tuple]] = {}
        #: id(Call node) -> tuple of resolved callee fquals
        self._by_site: dict[int, tuple[str, ...]] = {}
        self._effects: dict[str, frozenset] = {}
        #: (fqual, effect) -> (site fqual, human label) witness
        self._origin: dict[tuple[str, str], tuple[str, str]] = {}

        #: (owning FuncInfo, attr, value node) for every single-target
        #: ``self.X = ...`` — collected by the body scan, consumed by
        #: the attr-typing pass
        self._self_assigns: list[tuple[FuncInfo, str, ast.AST]] = []

        for rel, pf in sorted(ctx.files.items()):
            self._index_file(rel, pf)
        self._resolve_imports()
        # two-phase body scan: collect (calls + effects + self-assigns)
        # BEFORE attr typing, resolve edges after — one pass over every
        # body total, no re-walks
        scans = [_BodyScan(self, fi) for fi in self.funcs.values()]
        for s in scans:
            s.collect()
        self._resolve_bases_and_attrs()
        for s in scans:
            s.resolve()
        self._propagate()

    # -- pass 1: per-file symbol indexing ---------------------------------

    def _index_file(self, rel: str, pf: ParsedFile) -> None:
        mod = _module_name(rel)
        self.modules[mod] = rel
        top: dict[str, tuple[str, str]] = {}
        self.toplevel[mod] = top
        self.imports[mod] = {}
        self._collect_imports(mod, pf)
        # the per-file def/class tables were indexed once at parse time
        # (ParsedFile._index) — reuse them instead of re-recursing
        for node, qual, _inner in pf.classdefs:
            ci = self.classes.setdefault(
                (mod, node.name),
                ClassInfo(mod=mod, name=node.name, node=node))
            ci.node = node
            if "." not in qual:
                top.setdefault(node.name, ("class", node.name))
        for node, qual, cls, _outer, is_top in pf.defs:
            fq = f"{mod}::{qual}"
            self.funcs[fq] = FuncInfo(
                fqual=fq, mod=mod, relpath=rel, cls=cls, node=node)
            if is_top:
                top.setdefault(node.name, ("func", qual))
            if cls:
                self.classes.setdefault(
                    (mod, cls),
                    ClassInfo(mod=mod, name=cls, node=None)
                ).methods.setdefault(node.name, fq)

    def _collect_imports(self, mod: str, pf: ParsedFile) -> None:
        imps = self.imports[mod]
        rel = self.modules[mod]
        # the package for relative imports: the dir the file lives in
        pkg_parts = rel.split("/")[:-1]
        for node in pf.of_type(ast.Import):
            for a in node.names:
                alias = a.asname or a.name.split(".")[0]
                target = a.name if a.asname else a.name.split(".")[0]
                imps[alias] = ("module", target)
        for node in pf.of_type(ast.ImportFrom):
            if node.level:
                base = pkg_parts[:len(pkg_parts) - (node.level - 1)]
                base_mod = ".".join(base)
            else:
                base_mod = ""
            src = ".".join(x for x in (base_mod, node.module or "") if x)
            for a in node.names:
                if a.name == "*":
                    continue
                alias = a.asname or a.name
                imps[alias] = ("from", src, a.name)

    # -- pass 2: resolve imports, bases, attribute types ------------------

    def _resolve_imports(self) -> None:
        """Normalize 'from' entries into symbol or module refs."""
        for mod, imps in self.imports.items():
            for alias, entry in list(imps.items()):
                if entry[0] != "from":
                    continue
                _, src, name = entry
                if src in self.toplevel and name in self.toplevel[src]:
                    kind, qual = self.toplevel[src][name]
                    imps[alias] = ("symbol", kind, src, qual)
                elif f"{src}.{name}" in self.modules:
                    imps[alias] = ("module", f"{src}.{name}")
                else:
                    del imps[alias]  # stdlib / out-of-context: no edge

    def _resolve_classref(self, mod: str,
                          expr: ast.AST) -> Optional[tuple[str, str]]:
        """(mod, cls) for a Name/Attribute class reference, else None."""
        if isinstance(expr, ast.Name):
            if (mod, expr.id) in self.classes:
                return (mod, expr.id)
            imp = self.imports.get(mod, {}).get(expr.id)
            if imp and imp[0] == "symbol" and imp[1] == "class":
                return (imp[2], imp[3])
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name):
            imp = self.imports.get(mod, {}).get(expr.value.id)
            if imp and imp[0] == "module" and (
                    imp[1], expr.attr) in self.classes:
                return (imp[1], expr.attr)
        return None

    def _resolve_bases_and_attrs(self) -> None:
        for (mod, name), ci in self.classes.items():
            if ci.node is not None:
                for b in ci.node.bases:
                    ref = self._resolve_classref(mod, b)
                    if ref:
                        ci.bases.append(ref)
        # attribute typing + getter aliases: self.X = Cls(...) /
        # self.X = fn — from the assigns the body scan collected
        for fi, attr, v in self._self_assigns:
            ci = self.classes.get((fi.mod, fi.cls))
            if ci is None:
                continue
            if isinstance(v, ast.Call):
                ref = self._resolve_classref(fi.mod, v.func)
                if ref is None:
                    continue
                prev = ci.attr_types.get(attr, ref)
                # conflicting types degrade to untyped (None)
                ci.attr_types[attr] = ref if prev == ref else None
            elif isinstance(v, ast.Name):
                fq = self._resolve_funcref(fi.mod, fi, v.id)
                if fq:
                    ci.fn_aliases.setdefault(attr, fq)

    def _resolve_funcref(self, mod: str, fi: FuncInfo,
                         name: str) -> Optional[str]:
        """A bare function NAME visible from inside ``fi``: nested def in
        an enclosing scope chain, module function, or imported symbol."""
        qual = fi.fqual.split("::", 1)[1]
        parts = qual.split(".")
        for i in range(len(parts), 0, -1):
            cand = f"{mod}::{'.'.join(parts[:i])}.{name}"
            if cand in self.funcs:
                return cand
        top = self.toplevel.get(mod, {})
        if name in top and top[name][0] == "func":
            return f"{mod}::{top[name][1]}"
        imp = self.imports.get(mod, {}).get(name)
        if imp and imp[0] == "symbol" and imp[1] == "func":
            return f"{imp[2]}::{imp[3]}"
        return None

    # -- queries -----------------------------------------------------------

    def method(self, mod: str, cls: str, name: str,
               _seen: Optional[set] = None) -> Optional[str]:
        """MRO-resolved method fqual: own class first, then bases DFS
        (cross-module bases resolve through imports)."""
        ci = self.classes.get((mod, cls))
        if ci is None:
            return None
        if name in ci.methods:
            return ci.methods[name]
        seen = _seen if _seen is not None else set()
        if (mod, cls) in seen:
            return None
        seen.add((mod, cls))
        for bmod, bcls in ci.bases:
            got = self.method(bmod, bcls, name, seen)
            if got:
                return got
        return None

    def resolve_call(self, call: ast.Call) -> tuple[str, ...]:
        """Callee fquals resolved for this exact Call node ('' none)."""
        return self._by_site.get(id(call), ())

    def effects(self, fqual: str) -> frozenset:
        return self._effects.get(fqual, frozenset())

    def effect_site(self, fqual: str,
                    effect: str) -> Optional[tuple[str, str]]:
        """(site fqual, label) witness for ``effect`` on ``fqual``."""
        return self._origin.get((fqual, effect))

    def reachable(self, roots: Iterable[str]) -> set[str]:
        seen: set[str] = set()
        todo = [r for r in roots if r in self.funcs]
        while todo:
            q = todo.pop()
            if q in seen:
                continue
            seen.add(q)
            for callee, _node, _g in self.funcs[q].edges:
                if callee not in seen:
                    todo.append(callee)
        return seen

    def func_file(self, fqual: str) -> str:
        return self.funcs[fqual].relpath

    # -- pass 4: effect fixpoint ------------------------------------------

    def _propagate(self) -> None:
        """Cycle-safe monotone fixpoint: effects(f) = intrinsic(f) ∪
        ⋃ effects(callees).  ``jit-unguarded`` flows only through
        UNGUARDED real call edges (a guarded call site is the cache
        idiom; a nested def constructs lazily)."""
        eff: dict[str, set[str]] = {
            fq: set(fi.intrinsic) for fq, fi in self.funcs.items()}
        callers: dict[str, list[tuple[str, bool, bool]]] = {}
        for fq, fi in self.funcs.items():
            for callee, node, guarded in fi.edges:
                callers.setdefault(callee, []).append(
                    (fq, guarded, node is None))
        todo = list(self.funcs)
        in_todo = set(todo)
        while todo:
            fq = todo.pop()
            in_todo.discard(fq)
            for caller, guarded, nested in callers.get(fq, ()):
                flow = set(eff[fq])
                if guarded or nested:
                    flow.discard("jit-unguarded")
                # __init__/warmup are jit-unguarded SINKS: whatever
                # their callees construct is object-lifecycle capture
                # (see _BodyScan), so the treadmill effect stops there
                # instead of flowing to constructors' users
                if _is_construction_sink(
                        caller.split("::", 1)[1].rsplit(".", 1)[-1]):
                    flow.discard("jit-unguarded")
                add = flow - eff[caller]
                if not add:
                    continue
                eff[caller] |= add
                for e in add:
                    self._origin.setdefault(
                        (caller, e),
                        self._origin.get((fq, e), (fq, e)))
                if caller not in in_todo:
                    todo.append(caller)
                    in_todo.add(caller)
        self._effects = {fq: frozenset(s) for fq, s in eff.items()}


class _BodyScan:
    """One function's own-body pass: call edges + intrinsic effects,
    with guard tracking for the jit cache idiom.  The traversal itself
    happened at parse time (ParsedFile.body_items carries each def's
    own-body nodes with their guard flags); this class only interprets
    those items."""

    def __init__(self, graph: CallGraph, fi: FuncInfo):
        self.g = graph
        self.fi = fi
        self.pf = graph.ctx.files.get(fi.relpath)
        self.memoized = any(
            "cache" in (_dotted(d if not isinstance(d, ast.Call) else d.func)
                        or "").lower()
            for d in getattr(fi.node, "decorator_list", []))

    def collect(self) -> None:
        """Phase 1: own-body calls, intrinsic effects, self-assigns —
        read off the parse-time body table (ParsedFile.body_items), so
        no body is ever traversed twice."""
        fi, g = self.fi, self.g
        items = (self.pf.body_items.get(id(fi.node), ())
                 if self.pf is not None else ())
        for node, guarded in items:
            t = type(node)
            if t is ast.Call:
                fi.calls.append(node)
                fi.raw.append((node, guarded))
                self._scan_call(node, guarded)
            elif t is ast.Assign:
                tgt = node.targets[0]
                if (len(node.targets) == 1
                        and isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    g._self_assigns.append((fi, tgt.attr, node.value))
            elif t is ast.FunctionDef or t is ast.AsyncFunctionDef:
                nested = f"{fi.fqual}.{node.name}"
                if nested in g.funcs:
                    fi.edges.append((nested, None, guarded))
            else:  # With / AsyncWith
                for item in node.items:
                    if _lockish_name(item.context_expr):
                        self._effect("lock", node,
                                     _dotted(item.context_expr) or "lock")

    def resolve(self) -> None:
        """Phase 2 (after attr typing): raw calls -> resolved edges."""
        fi, g = self.fi, self.g
        for call, guarded in fi.raw:
            callees = self._resolve(call)
            if callees:
                g._by_site[id(call)] = callees
                for c in callees:
                    fi.edges.append((c, call, guarded))

    def _effect(self, effect: str, node: ast.AST, label: str) -> None:
        self.fi.intrinsic.add(effect)
        self.g._origin.setdefault((self.fi.fqual, effect),
                                  (self.fi.fqual, label))

    def _scan_call(self, call: ast.Call, guarded: bool) -> None:
        """Intrinsic effects of one call site.  This is the matcher set
        of HOST_SYNC_MATCHERS + the blocking/jit predicates, flattened
        to compute ``_dotted`` ONCE per site — the predicates each
        re-derive it, and at ~40k call sites that shows up in the
        whole-platform wall time.  Labels and match order are the
        frozen originals (finding identity depends on them)."""
        fi = self.fi
        f = call.func
        ftype = type(f)
        attr = f.attr if ftype is ast.Attribute else None
        name = f.id if ftype is ast.Name else None
        d = _dotted(f) if (attr is not None or name is not None) else None
        # a site already DECLARED as host math / a deliberate fetch
        # boundary (`# analysis: ok host-sync-in-dispatch — ...`) is
        # not a device sync: the declaration suppresses the effect for
        # every transitive consumer (lock-blocking-call etc.), not just
        # the direct rule
        if not (self.pf is not None
                and self.pf.allowed(call.lineno, "host-sync-in-dispatch")):
            label = None
            if attr == "item" and not call.args:
                label = "`.item()`"
            elif attr == "tolist" and not call.args:
                label = "`.tolist()`"
            elif attr == "cpu" and not call.args:
                label = LABEL_CPU
            elif attr == "numpy" and not call.args:
                label = LABEL_NUMPY
            elif attr == "to" and _is_to_cpu(call):
                label = LABEL_TO_CPU
            elif d in _CUDA_SYNCHRONIZE:
                label = LABEL_CUDA_SYNC
            elif attr == "synchronize":
                label = LABEL_STREAM_SYNC
            elif (d in _NP_MATERIALIZE and call.args
                  and not isinstance(call.args[0], _HOST_LITERALS)):
                label = ("numpy materialization "
                         "(`np.asarray`/`np.array`)")
            elif name in ("float", "int", "bool") and len(call.args) == 1:
                a = call.args[0]
                if (isinstance(a, ast.Call)
                        and isinstance(a.func, ast.Attribute)
                        and a.func.attr in _REDUCERS):
                    label = ("scalarized reduction "
                             "(`int`/`float` of `.max()`-like)")
            if label is not None:
                self._effect("host-sync", call, label)
        if attr in _BLOCKING_SOCKET_ATTRS or d in (
                "socket.create_connection", "create_connection"):
            self._effect("socket", call,
                         (d or f".{attr}") if attr is not None else "socket")
        if d in ("time.sleep", "sleep"):
            self._effect("sleep", call, "`time.sleep`")
        if d in ("os.fsync", "fsync"):
            self._effect("fsync", call, "`os.fsync`")
        if name == "open" and _is_file_write_open(call):
            self._effect("file-write", call, "`open(.., 'w')`")
        if name == "urlopen" or attr == "urlopen":
            self._effect("urlopen", call, "`urlopen`")
        if attr == "join" and "thread" in (_dotted(f.value) or "").lower():
            self._effect("thread-join", call, "thread `.join`")
        if attr == "acquire" and _lockish_name(f.value):
            self._effect("lock", call, _dotted(f.value) or "lock")
        nm = name if name is not None else attr
        if d in _CONSTRUCT_DOTTED or (
                nm is not None and (nm == "capture_begin" or (
                    nm.startswith("make_") and _MAKE_PROGRAM.match(nm)))):
            self._effect("jit-construct", call, "program construction")
            bare = fi.fqual.split("::", 1)[1].rsplit(".", 1)[-1]
            if (not guarded and not self.memoized
                    and not _is_construction_sink(bare)):
                # __init__/warmup construction is object-lifecycle
                # capture (N objects = N programs, by design);
                # jit-unguarded flags only re-construction treadmills
                self._effect("jit-unguarded", call, "program construction")

    def _resolve(self, call: ast.Call) -> tuple[str, ...]:
        fi, g = self.fi, self.g
        f = call.func
        if isinstance(f, ast.Name):
            fq = g._resolve_funcref(fi.mod, fi, f.id)
            if fq:
                return (fq,)
            ref = g._resolve_classref(fi.mod, f)
            if ref:
                init = g.method(ref[0], ref[1], "__init__")
                return (init,) if init else ()
            return ()
        if not isinstance(f, ast.Attribute):
            return ()
        base = f.value
        # self.m(...) -> MRO; self.X(...) -> getter alias
        if isinstance(base, ast.Name):
            if base.id == "self" and fi.cls:
                m = g.method(fi.mod, fi.cls, f.attr)
                out = (m,) if m else ()
                ci = g.classes.get((fi.mod, fi.cls))
                if ci:
                    a = ci.fn_aliases.get(f.attr)
                    if a and a not in out:
                        out = out + (a,)
                return out
            imp = g.imports.get(fi.mod, {}).get(base.id)
            if imp and imp[0] == "module":
                top = g.toplevel.get(imp[1], {})
                if f.attr in top:
                    kind, qual = top[f.attr]
                    if kind == "func":
                        return (f"{imp[1]}::{qual}",)
                    init = g.method(imp[1], qual, "__init__")
                    return (init,) if init else ()
            return ()
        # self.<attr>.m(...) through the attr-type map
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self" and fi.cls):
            ci = g.classes.get((fi.mod, fi.cls))
            ref = ci.attr_types.get(base.attr) if ci else None
            if ref:
                m = g.method(ref[0], ref[1], f.attr)
                if m:
                    return (m,)
        return ()


def get_graph(ctx: LintContext) -> CallGraph:
    """The context's call graph, built once and memoized on ``ctx``."""
    g = getattr(ctx, "_callgraph", None)
    if g is None:
        g = CallGraph(ctx)
        ctx._callgraph = g
    return g
