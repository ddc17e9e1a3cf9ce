"""Pod process entrypoint: ``python -m kubeflow_tpu_torch.runtime.pod_main``.

The port's copy of ``kubeflow_tpu/runtime/pod_main.py``: what the kubelet
execs for containers that declare a python ``entrypoint``
(``module:function``). Sequence: parse the env contract -> join the job
(``bootstrap.initialize``) -> pass the gang barrier (stamping the startup
probe on the pod's device) -> run the user function. The user function
receives the ``PodContext`` and its return value is ignored; failures map to
exit codes the controller's RestartPolicy understands (SURVEY.md §5 failure
detection).

Differences from the reference:

- One process drives one card, so a pod of k cards in the job's process
  group (``KFT_POD_CARDS``) runs k local ranks, torchrun's
  ``nproc_per_node`` (``run_local_ranks``): process ``pod index * k +
  local`` of ``pods * k``, each on its own card. The pod acts as one: it
  passes its startup probe once every local rank passed its barrier, the
  first rank to fail ends the others, and the pod's exit code and
  termination message are that rank's. The reference runs one process
  over the host's k chips.
- A ``NotImplementedError`` from the rendezvous exits 1, permanent, where
  any other rendezvous failure exits 42, retryable.
- The last line of a failure's traceback is written to the status dir's
  ``TERMINATION_FILE`` (Kubernetes' termination message), which the
  kubelet folds into the pod's status message.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import signal
import subprocess
import sys
import time
import traceback

from . import bootstrap

#: the status dir's termination message: the failure's last line
TERMINATION_FILE = "termination-log"
#: seconds a local rank gets to exit after SIGTERM, before SIGKILL
LOCAL_GRACE_S = 3.0


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
    path = bootstrap.status_file(ctx, TERMINATION_FILE)
    if path:
        os.makedirs(ctx.status_dir, exist_ok=True)
        lines = [x for x in text.strip().splitlines() if x.strip()]
        with open(path, "w") as f:
            f.write(lines[-1] if lines else f"exit {code}")
    return code


def _exit_code(code: int) -> int:
    # a signal death (-N) as a kubelet reports it: 128 + N
    return 128 - code if code < 0 else code


def _rank_file(ctx: bootstrap.PodContext, local: int, name: str) -> str:
    """Local rank ``local``'s status file ``name`` in the pod's dir."""
    return bootstrap.status_file(
        dataclasses.replace(ctx, local_rank=local), name)


def _stamp_barrier(ctx: bootstrap.PodContext, k: int) -> bool:
    """Stamp the pod's ``BARRIER_FILE`` once all ``k`` local ranks stamped
    theirs (the latest of their times); True once stamped."""
    times = []
    for j in range(k):
        try:
            with open(_rank_file(ctx, j, bootstrap.BARRIER_FILE)) as f:
                times.append(float(f.read().strip()))
        except (OSError, ValueError):
            return False
    with open(bootstrap.status_file(ctx, bootstrap.BARRIER_FILE), "w") as f:
        f.write(repr(max(times)))
    return True


def _first_failure(ctx: bootstrap.PodContext, failed: list[int]) -> int:
    """Of the local ranks ``failed``, the one whose termination message is
    oldest (the first to fail; the others may have died of its loss)."""
    def written(j: int) -> float:
        try:
            return os.stat(_rank_file(ctx, j, TERMINATION_FILE)).st_mtime
        except OSError:
            return float("inf")

    return min(failed, key=lambda j: (written(j), j))


def run_local_ranks(ctx: bootstrap.PodContext, poll_s: float = 0.05) -> int:
    """Run the pod's k local ranks (``bootstrap.local_rank_env``), each
    this entrypoint again, and return the pod's exit code. The pod's
    barrier is stamped once every rank's is; when a rank fails the others
    get SIGTERM (SIGKILL after ``LOCAL_GRACE_S``), and its exit code and
    termination message become the pod's."""
    k = len(ctx.cards)
    argv = [sys.executable, "-m", "kubeflow_tpu_torch.runtime.pod_main"]
    procs = [subprocess.Popen(argv, env=bootstrap.local_rank_env(ctx, j))
             for j in range(k)]
    # without a status dir there is nothing to stamp or hand over
    stamped = not ctx.status_dir
    try:
        while True:
            if not stamped:
                stamped = _stamp_barrier(ctx, k)
            codes = [p.poll() for p in procs]
            failed = [j for j, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                j = _first_failure(ctx, failed) if ctx.status_dir else failed[0]
                _end(procs)
                if ctx.status_dir and os.path.exists(
                        _rank_file(ctx, j, TERMINATION_FILE)):
                    with open(_rank_file(ctx, j, TERMINATION_FILE)) as f:
                        msg = f.read()
                    with open(bootstrap.status_file(ctx, TERMINATION_FILE),
                              "w") as f:
                        f.write(msg)
                print(f"pod_main: local rank {j} exited "
                      f"{_exit_code(codes[j])}; the pod's other ranks ended",
                      flush=True)
                return _exit_code(codes[j])
            if all(c == 0 for c in codes):
                return 0
            time.sleep(poll_s)
    finally:
        _end(procs)


def _end(procs: list) -> None:
    """SIGTERM every live process of ``procs``, SIGKILL what outlives the
    grace."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + LOCAL_GRACE_S
    for p in live:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def main() -> int:
    ctx = bootstrap.PodContext.from_env()
    target_spec = os.environ.get(bootstrap.ENV_ENTRYPOINT)
    if not target_spec:
        print("pod_main: no KFT_ENTRYPOINT set", file=sys.stderr)
        return 2
    if (len(ctx.cards) > 1 and ctx.local_rank is None
            and ctx.coordinator_address):
        return run_local_ranks(ctx)
    cards = ",".join(map(str, ctx.cards)) or "none"
    where = ctx.device or "cuda:0"
    local = "" if ctx.local_rank is None else f", local rank {ctx.local_rank}"
    print(f"pod_main: process {ctx.process_id} of {ctx.num_processes}"
          f"{local} on {where}; the pod's cards {cards}", flush=True)
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
    code = main()
    if code:
        # a failed pod's exit code is its contract: the interpreter's
        # teardown of a live process group can abort the process
        # (SIGABRT, 134), turning a permanent failure into a retryable one
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    sys.exit(code)
