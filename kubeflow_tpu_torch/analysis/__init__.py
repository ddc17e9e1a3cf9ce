"""The port's analyzer: AST lint rules + runtime auditors.

The port's copy of ``kubeflow_tpu/analysis/``.  Its lint enforces the
serving engine's contract as code over ``kubeflow_tpu_torch/``, in
torch's vocabulary:

- :mod:`.astlint` — rule framework: parse every module of the port once,
  run the rule set, compare against the port's ratchet baseline
  (``baseline.json``): existing findings are frozen debt, NEW findings
  fail tier-1 (``tests/test_torch_analysis.py``).
- :mod:`.callgraph` — the cross-module call-graph + effect-propagation
  engine: ``from .x import y`` / ``self._helper()`` / MRO /
  attribute-typed edges across every parsed file, per-function effect
  sets (host-sync, socket, sleep, fsync, lock, unguarded program
  construction) at a cycle-safe fixpoint, reachability queries for
  rules.  Dynamic calls degrade to no-edge — under-approximate, never
  crash.  Its matchers speak torch: ``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()``/``.to("cpu")``/``torch.cuda.synchronize()``/
  ``Event.synchronize()`` are host syncs, and CUDA graph capture,
  ``torch.compile`` and the ``make_*_program`` factories are program
  construction.
- :mod:`.rules_dispatch` — ``host-sync-in-dispatch`` (a host sync
  reachable from the engine's dispatch loop stalls the card's stream —
  transitively, in whatever module the helper lives) and
  ``jit-in-loop`` (program construction inside a loop body — or
  reached unguarded from one — is a recapture treadmill; the warmup
  phase is out).
- :mod:`.rules_locks` — ``lock-order`` (the global ``with <lock>:``
  nesting graph across serving/controlplane/hpo/net; cycles and
  blocking calls under a lock) and ``lock-blocking-call`` (blocking
  effects *reachable* through call edges while a lock is held).
- :mod:`.rules_persist` — ``torn-write``: the crash-safety commit
  protocol (tmp write -> flush+fsync -> ``os.replace``, dir-fsync at
  manifest commit points).
- :mod:`.rules_hygiene` — ``swallowed-exception``, ``unsafe-pickle``
  (pickle ingestion outside the post-auth gang replay path),
  ``nondaemon-thread``.
- :mod:`.rules_threads` — ``thread-affinity``: writes to
  scheduler-owned engine state from a non-scheduler role fail unless
  routed through the migration mailbox.
- :mod:`.rules_clock` — ``wall-clock-in-policy``: no ambient ``time.*``
  and no process-global ``random.*`` on any path the sim twin replays.
- :mod:`.rules_protocol` — ``op-table`` (every published gang op needs
  a ``follow()`` replay arm and vice versa, across gang.py/resize.py)
  and ``fault-pairing`` (chaos ``FaultKind`` producers vs consumers).
- :mod:`.rules_metrics` — ``metrics-contract``: ``stats()`` keys must
  render to Prometheus names.
- :mod:`.runtime` — the *runtime* half: :class:`~.runtime.CaptureCounter`
  (graph captures after warmup, the ``graph_captures_total`` gauge),
  :class:`~.runtime.LockAudit` (real acquisition order, inversions),
  :class:`~.runtime.BlockLedger` (the paged-KV block economy) and
  :func:`~.runtime.audit_stats_pair` (the metrics contract's
  value-dependent half).
- :mod:`.selftest` — built-in true-positive/near-miss fixtures per
  rule; ``--self-test`` runs them with no pytest in the loop.

Intentional violations carry the reference's inline pragma on the
offending line (or the line above)::

    toks = out.numpy().copy()  # analysis: ok host-sync-in-dispatch — why

For ``swallowed-exception`` the justification comment form
``# noqa: BLE001 — <reason>`` (reason REQUIRED, em- or double-dash) is
honored too.

Run it: ``python -m kubeflow_tpu_torch.analysis``; ``--update-baseline``
re-freezes debt after an intentional change; ``--json`` emits
machine-readable findings with timing; ``--changed`` scopes the report
(not the parse) to your git diff; ``--rule`` accepts rule names or group
aliases (``threads``, ``protocol``, ``locks``, ``dispatch``,
``hygiene``, ``metrics``, ``persist``); ``--self-test`` validates the
rules against their own fixtures.  Exit codes: 0 = clean (or self-test
green), 1 = NEW findings above the ratchet baseline (or a failed
fixture), 2 = usage error.  This package imports no torch — the lint
half is pure stdlib so the CLI and the tier-1 ratchet test stay fast.
"""

from .astlint import (  # noqa: F401
    Finding,
    LintReport,
    baseline_path,
    compare_to_baseline,
    load_baseline,
    run_lint,
    write_baseline,
)
