"""``metrics-contract``: engine ``stats()`` keys must be exportable.

The port's copy of ``kubeflow_tpu/analysis/rules_metrics.py``, scoped to
``kubeflow_tpu_torch/serving/``.

Every serving-layer ``stats()`` dict is auto-exported by the model
server's /metrics walk (``kft_engine_<key>`` gauges) and scraped by the
router probes, the recovery/serving benches and — next — the
autoscaler.  That gives stats keys a CONTRACT the type system cannot
see:

- every key must render to a valid Prometheus metric name once the
  exporter splices it into ``kft_engine_<key>`` — one hyphenated or
  dotted key poisons the whole scrape (the regression class that moved
  per-tenant CLASS names out of metric names);
- a key ending in ``_total`` claims OpenMetrics counter semantics:
  monotonically non-decreasing.  Scrapes rate() counters; a "counter"
  that goes down (a gauge misnamed ``_total``, a counter rebuilt from a
  live walk) silently corrupts every rate over it.

The static half here enforces the NAME rule at lint time: string keys
in dict literals / subscript assignments / ``setdefault`` calls inside
any serving-layer ``stats()`` function body must match
``[a-zA-Z_][a-zA-Z0-9_]*``.  The monotonicity half is value-dependent,
so it lives in :mod:`.runtime` (:func:`audit_stats_pair`) and is pinned
by the engine test suites across an audit pair.  Pragma:
``# analysis: ok metrics-contract — reason``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from .astlint import Finding, LintContext, ParsedFile, rule

#: a key is spliced into ``kft_engine_<key>`` — the key itself must be
#: a valid metric-name SUFFIX (letters, digits, underscores; the prefix
#: supplies the leading letter)
_NAME = re.compile(r"^[a-zA-Z0-9_]+$")

SCOPE_PREFIXES = ("kubeflow_tpu_torch/serving/",)


def _stats_functions(pf: ParsedFile):
    for node in pf.of_type(ast.FunctionDef):
        if node.name == "stats":
            yield node


def _string_keys(fn: ast.FunctionDef):
    """(key, node) for every string key this stats() body builds:
    dict-literal keys, ``out["k"] = ...`` subscript writes, and
    ``.setdefault("k", ...)`` calls."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    yield k.value, k
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.slice, ast.Constant)
                        and isinstance(tgt.slice.value, str)):
                    yield tgt.slice.value, tgt
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "setdefault" and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value, node


@rule("metrics-contract")
def metrics_contract(ctx: LintContext) -> Iterable[Finding]:
    for rel, pf in sorted(ctx.files.items()):
        if not rel.startswith(SCOPE_PREFIXES):
            continue
        for fn in _stats_functions(pf):
            seen: set[str] = set()
            for key, node in _string_keys(fn):
                if key in seen:
                    continue
                seen.add(key)
                if _NAME.match(key):
                    continue
                f = ctx.finding(
                    pf, "metrics-contract", node,
                    f"stats() key `{key}` does not render to a valid "
                    "Prometheus name (kft_engine_<key>): use "
                    "[a-zA-Z0-9_] only — one bad key poisons the whole "
                    "/metrics scrape")
                if f is not None:
                    yield f
