"""Pod process entrypoint: ``python -m kubeflow_tpu_torch.runtime.pod_main``.

The port's copy of ``kubeflow_tpu/runtime/pod_main.py``: what the kubelet
execs for containers that declare a python ``entrypoint``
(``module:function``). Sequence: parse the env contract -> join the job
(``bootstrap.initialize``) -> pass the gang barrier (stamping the startup
probe on the pod's device) -> run the user function. The user function
receives the ``PodContext`` and its return value is ignored; failures map to
exit codes the controller's RestartPolicy understands (SURVEY.md §5 failure
detection).

Two differences from the reference: a ``NotImplementedError`` from the
rendezvous exits 1, permanent, where any other rendezvous failure exits
42, retryable (what the port still lacks raises from the user function,
and exits 1 with every such failure: a mesh larger than the job's
processes, ``MeshPlanError`` naming ROADMAP A13); and the last line of a
failure's traceback is written to the status dir's ``TERMINATION_FILE``
(Kubernetes' termination message), which the kubelet folds into the pod's
status message.
"""

from __future__ import annotations

import importlib
import os
import sys
import traceback

from . import bootstrap

#: the status dir's termination message: the failure's last line
TERMINATION_FILE = "termination-log"


def resolve_target(spec: str):
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(f"entrypoint {spec!r} must be 'module:function'")
    mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


def _fail(ctx: bootstrap.PodContext, code: int) -> int:
    """Write the last line of the traceback being handled as the
    termination message, return ``code`` (the handler prints it)."""
    text = traceback.format_exc()
    if ctx.status_dir:
        os.makedirs(ctx.status_dir, exist_ok=True)
        lines = [x for x in text.strip().splitlines() if x.strip()]
        with open(os.path.join(ctx.status_dir, TERMINATION_FILE), "w") as f:
            f.write(lines[-1] if lines else f"exit {code}")
    return code


def main() -> int:
    ctx = bootstrap.PodContext.from_env()
    target_spec = os.environ.get(bootstrap.ENV_ENTRYPOINT)
    if not target_spec:
        print("pod_main: no KFT_ENTRYPOINT set", file=sys.stderr)
        return 2
    try:
        fn = resolve_target(target_spec)
    except Exception:
        traceback.print_exc()
        return _fail(ctx, 2)
    try:
        bootstrap.initialize(ctx)
        bootstrap.barrier(ctx)
    except NotImplementedError:
        traceback.print_exc()
        return _fail(ctx, 1)
    except Exception:
        traceback.print_exc()
        # rendezvous failures are retryable by convention (another rank may
        # have died first; a gang restart can heal it)
        return _fail(ctx, 42)
    try:
        fn(ctx)
        return 0
    except SystemExit as e:
        return int(e.code or 0)
    except Exception:
        traceback.print_exc()
        return _fail(ctx, 1)


if __name__ == "__main__":
    sys.exit(main())
