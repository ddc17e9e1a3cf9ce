"""``python -m kubeflow_tpu_torch.analysis`` — the port's lint CLI.

The port's copy of ``kubeflow_tpu/analysis/__main__.py``: the same
flags and exit codes, over ``kubeflow_tpu_torch/`` and its own
``baseline.json``.

Modes:
  (default)            lint, compare to the baseline, exit 1 on NEW
                       findings (the ratchet CI/tier-1 runs)
  --update-baseline    freeze the current findings as the new debt
  --json               machine-readable findings + summary on stdout
  --baseline PATH      compare/write a non-default baseline file
  --rule NAME          run a subset: a rule name OR a group alias
                       (``threads`` -> thread-affinity, ``protocol`` ->
                       op-table + fault-pairing, ``locks`` -> lock-order
                       + lock-blocking-call, ``persist`` -> torn-write,
                       ``dispatch``, ``hygiene``); repeatable
  --changed            parse the WHOLE platform (the call graph needs
                       every module) but report only findings in files
                       changed vs HEAD (+ untracked) — the fast
                       pre-commit loop
  --all                list every finding, not just the new ones
  --self-test          run the built-in rule fixtures (selftest.py) —
                       the lint binary validating itself, no pytest

Exit codes (CI contract, also asserted by tests/test_torch_analysis.py):
  0  no findings above the baseline / self-test green / baseline written
  1  NEW findings above the ratchet baseline, or a self-test fixture
     failed (a rule stopped firing on its true positive or started
     firing on its near miss)
  2  usage error (argparse; e.g. --update-baseline with a subset lint)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from .astlint import (
    LintReport,
    baseline_path,
    compare_to_baseline,
    load_baseline,
    rule_names,
    run_lint,
    write_baseline,
)

#: CLI group aliases -> registered rule names (the ``--rule threads`` /
#: ``--rule protocol`` filters): one word selects a concern, not a file
RULE_GROUPS: dict[str, tuple[str, ...]] = {
    "dispatch": ("host-sync-in-dispatch", "jit-in-loop"),
    "hygiene": ("swallowed-exception", "unsafe-pickle",
                "nondaemon-thread"),
    "locks": ("lock-order", "lock-blocking-call"),
    "threads": ("thread-affinity",),
    "protocol": ("op-table", "fault-pairing"),
    "metrics": ("metrics-contract",),
    "persist": ("torn-write",),
}


def resolve_rules(names) -> list[str] | None:
    """Expand group aliases into registered rule names (dedup, stable
    order)."""
    if names is None:
        return None
    out: list[str] = []
    for n in names:
        for r in RULE_GROUPS.get(n, (n,)):
            if r not in out:
                out.append(r)
    return out


def repo_root() -> str:
    """The checkout root = two levels above this package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def changed_paths(root: str) -> set[str]:
    """Repo-relative paths changed vs HEAD plus untracked files, from
    git.  Returns empty (-> report nothing) when git is unavailable:
    the --changed mode is a convenience filter, never a gate."""
    out: set[str] = set()
    for cmd in (("git", "diff", "--name-only", "HEAD"),
                ("git", "ls-files", "--others", "--exclude-standard")):
        try:
            res = subprocess.run(cmd, cwd=root, capture_output=True,
                                 text=True, check=True)
        except (OSError, subprocess.CalledProcessError):
            continue
        out.update(ln.strip() for ln in res.stdout.splitlines()
                   if ln.strip())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.analysis",
        description="The port's analyzer: AST lint with a findings "
                    "ratchet")
    ap.add_argument("paths", nargs="*",
                    help="files to lint (default: kubeflow_tpu_torch/)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON path (default: "
                         "kubeflow_tpu_torch/analysis/baseline.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="freeze current findings as the new baseline")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit machine-readable JSON")
    ap.add_argument("--rule", action="append", default=None,
                    choices=rule_names() + sorted(RULE_GROUPS),
                    help="run only this rule or group alias "
                         "(threads, protocol, locks, dispatch, hygiene; "
                         "repeatable)")
    ap.add_argument("--changed", action="store_true",
                    help="report only findings in files changed vs HEAD "
                         "(+ untracked); the full platform is still "
                         "parsed so cross-module effects stay visible")
    ap.add_argument("--all", action="store_true",
                    help="print every finding, not only new ones")
    ap.add_argument("--self-test", action="store_true", dest="self_test",
                    help="run the built-in rule fixtures instead of "
                         "linting the repo (0 = all green)")
    args = ap.parse_args(argv)

    rules = resolve_rules(args.rule)
    if args.self_test:
        if (args.paths or args.baseline or args.update_baseline
                or args.as_json or args.all or args.changed):
            # the fixtures lint synthetic sources, not the repo: a
            # --json/--baseline caller would get fixture chatter + exit
            # 0 where it expects the documented lint contract
            ap.error("--self-test runs the built-in fixtures only; it "
                     "is incompatible with paths, --baseline, "
                     "--update-baseline, --json, --all, and --changed "
                     "(--rule filters which fixtures run)")
        from .selftest import run_selftest
        return run_selftest(rules=rules)

    root = os.path.abspath(args.root) if args.root else repo_root()
    bpath = args.baseline or baseline_path(root)
    paths = [os.path.abspath(p) for p in args.paths] or None
    if args.update_baseline and (paths or args.rule or args.changed):
        # a subset lint would OVERWRITE the baseline with only the
        # subset's findings, silently erasing every other frozen entry —
        # the next full run then fails tier-1 on debt nobody added
        ap.error("--update-baseline requires a full lint "
                 "(no positional paths, no --rule, no --changed)")
    if args.changed and paths:
        ap.error("--changed derives its scope from git; positional "
                 "paths would fight it — pass one or the other")
    t0 = time.perf_counter()
    report = run_lint(root, paths=paths, rules=rules)
    elapsed_s = round(time.perf_counter() - t0, 3)
    scope_note = ""
    if args.changed:
        changed = changed_paths(root)
        report = LintReport([f for f in report.findings
                             if f.path in changed])
        scope_note = f" [--changed: {len(changed)} files in scope]"

    if args.update_baseline:
        doc = write_baseline(bpath, report)
        if args.as_json:
            print(json.dumps(doc, indent=1))
        else:
            print(f"baseline updated: {bpath} "
                  f"({len(report.findings)} findings frozen: "
                  f"{doc['by_rule']})")
        return 0

    baseline = load_baseline(bpath)
    new = compare_to_baseline(report, baseline)

    if args.as_json:
        print(json.dumps({
            "total": len(report.findings),
            "by_rule": report.by_rule(),
            "baseline_total": sum(baseline.values()),
            "new": [vars(f) for f in new],
            "elapsed_s": elapsed_s,
            "changed_only": bool(args.changed),
        }, indent=1))
    else:
        shown = report.findings if args.all else new
        for f in shown:
            print(f)
        print(f"platform_lint: {len(report.findings)} findings "
              f"({report.by_rule() or 'clean'}), "
              f"{sum(baseline.values())} baselined, {len(new)} NEW "
              f"in {elapsed_s}s{scope_note}")
        if new:
            print("new findings above the ratchet baseline — fix them, "
                  "pragma them with a reason, or (for reviewed debt) "
                  "re-freeze with --update-baseline", file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
