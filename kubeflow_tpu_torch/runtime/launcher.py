"""LocalKubelet: runs bound Pods as real OS processes.

The port's copy of ``kubeflow_tpu/runtime/launcher.py``. The kubelet tier
the reference outsources to Kubernetes (SURVEY.md §4). Responsibilities,
mirroring a real kubelet + the operator's pod watching:

- spawn a process per bound pod (env from the pod template + the status-dir
  contract), capture stdout/stderr to per-pod log files (the ``kubectl
  logs`` surface the SDK and the HPO metrics collector read);
- poll liveness; fold exit codes into ``Pod.status`` (phase, exit_code) and
  a failed pod's termination message (``pod_main.TERMINATION_FILE``) into
  ``Pod.status.message``;
- surface the gang-barrier stamp from the status dir into
  ``Pod.status.barrier_time`` (gang-startup metric source);
- kill processes whose pods are deleted (suspend, gang restart, cleanup) —
  the SIGTERM-then-SIGKILL grace path.

Differences from the reference: pods run ``kubeflow_tpu_torch.runtime.
pod_main``, and there is no CPU default: a pod computes on its cards
unless ``KFT_POD_DEVICE`` (the pod template's env, ``env_overrides``, or
this process's env) says otherwise. A pod sees only the cards the
scheduler gave it (``Pod.spec.device_ids``, the device plugin's
``Allocate``): its ``CUDA_VISIBLE_DEVICES`` names them, and
``KFT_POD_CARDS`` lists them as bound (a time-sliced card repeated, so
pods bound to one card share it). This process's
``CUDA_VISIBLE_DEVICES`` does not pass through; ``KFT_POD_DEVICE`` and
``KFT_DIST_BACKEND`` do.
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..controlplane.objects import KIND_POD, Pod, PodPhase
from ..controlplane.store import DELETED, TOO_OLD, NotFound, Store, WatchEvent
from . import bootstrap
from .pod_main import TERMINATION_FILE

log = logging.getLogger("kubeflow_tpu_torch.kubelet")

GRACE_SECONDS = 3.0


@dataclass
class _Proc:
    popen: subprocess.Popen
    pod_uid: str
    status_dir: str
    log_path: str
    barrier_reported: bool = False


class LocalKubelet:
    def __init__(
        self,
        store: Store,
        root_dir: str,
        node_names: Optional[set[str]] = None,
        interval: float = 0.03,
        env_overrides: Optional[dict[str, str]] = None,
    ) -> None:
        self.store = store
        self.root_dir = root_dir
        self.node_names = node_names  # None = adopt every bound pod
        self.interval = interval
        self.env_overrides = env_overrides or {}
        self._procs: dict[str, _Proc] = {}  # ns/name -> proc
        self._kill_threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watch = None
        os.makedirs(self.logs_dir, exist_ok=True)

    @property
    def logs_dir(self) -> str:
        return os.path.join(self.root_dir, "logs")

    def pod_log_path(self, namespace: str, name: str) -> str:
        return os.path.join(self.logs_dir, namespace, f"{name}.log")

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self._watch = self.store.watch([KIND_POD])
        self._thread = threading.Thread(target=self._loop, name="local-kubelet", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        if self._watch is not None:
            self.store.stop_watch(self._watch)
        for key in list(self._procs):
            self._kill(key)
        for t in list(self._kill_threads):
            t.join(timeout=2 * GRACE_SECONDS + 1)
        self._kill_threads.clear()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._drain_deletions()
                self.step()
            except Exception:  # noqa: BLE001
                log.exception("kubelet step failed")
            self._stop.wait(self.interval)

    def _drain_deletions(self) -> None:
        assert self._watch is not None
        while True:
            try:
                ev: WatchEvent = self._watch.q.get_nowait()
            except queue.Empty:
                return
            if ev.type == TOO_OLD:
                # the bounded watch overflowed and closed: events were
                # dropped, so re-subscribe THEN relist — a pod deleted in
                # the lost window has no store object; its process must
                # still die, never linger unkilled
                self._watch = self.store.watch([KIND_POD])
                live = {p.key for p in self.store.list(KIND_POD)}
                for key in [k for k in self._procs if k not in live]:
                    self._kill(key)
                continue
            if ev.type == DELETED and ev.obj.kind == KIND_POD:
                self._kill(ev.obj.key)

    # -- core ------------------------------------------------------------------

    def step(self) -> None:
        for pod in self.store.list(KIND_POD):
            assert isinstance(pod, Pod)
            if self.node_names is not None and pod.spec.node_name not in self.node_names:
                continue
            key = pod.key
            if pod.status.phase == PodPhase.PENDING and pod.spec.node_name:
                if key not in self._procs:
                    self._spawn(pod)
            elif pod.status.phase == PodPhase.RUNNING:
                self._check(pod)

    def _build_env(self, pod: Pod, status_dir: str) -> dict[str, str]:
        base_keys = ("PATH", "HOME", "PYTHONPATH", "TMPDIR", "LD_LIBRARY_PATH",
                     bootstrap.ENV_POD_DEVICE, bootstrap.ENV_DIST_BACKEND)
        env = {k: os.environ[k] for k in base_keys if k in os.environ}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (os.getcwd(), env.get("PYTHONPATH")) if p
        )
        # no device default: the pod runs on its cards unless
        # KFT_POD_DEVICE (passed through above, or the template's, or an
        # override) says otherwise
        env.update(pod.spec.container.env)
        env.update(self.env_overrides)
        # the cards the scheduler bound, and only they, are the pod's
        ids = pod.spec.device_ids
        env["CUDA_VISIBLE_DEVICES"] = ",".join(
            map(str, bootstrap.visible_cards(ids)))
        env[bootstrap.ENV_POD_CARDS] = ",".join(map(str, ids))
        env[bootstrap.ENV_STATUS_DIR] = status_dir
        if pod.spec.container.entrypoint:
            env[bootstrap.ENV_ENTRYPOINT] = pod.spec.container.entrypoint
        return env

    def _spawn(self, pod: Pod) -> None:
        status_dir = os.path.join(
            self.root_dir, "status", pod.metadata.namespace, pod.metadata.name
        )
        shutil.rmtree(status_dir, ignore_errors=True)
        os.makedirs(status_dir, exist_ok=True)
        log_path = self.pod_log_path(pod.metadata.namespace, pod.metadata.name)
        os.makedirs(os.path.dirname(log_path), exist_ok=True)

        c = pod.spec.container
        if c.entrypoint:
            argv = [sys.executable, "-m", "kubeflow_tpu_torch.runtime.pod_main"]
        elif c.command:
            argv = list(c.command) + list(c.args)
        else:
            self._set_status(pod, PodPhase.FAILED, exit_code=2, message="no command/entrypoint")
            return

        env = self._build_env(pod, status_dir)
        logf = open(log_path, "ab", buffering=0)
        try:
            popen = subprocess.Popen(
                argv,
                env=env,
                stdout=logf,
                stderr=subprocess.STDOUT,
                cwd=c.working_dir or os.getcwd(),
                start_new_session=True,  # own process group -> clean gang kill
            )
        except OSError as e:
            self._set_status(pod, PodPhase.FAILED, exit_code=2, message=str(e))
            return
        finally:
            logf.close()  # child holds its own dup of the fd
        self._procs[pod.key] = _Proc(
            popen=popen,
            pod_uid=pod.metadata.uid or "",
            status_dir=status_dir,
            log_path=log_path,
        )
        self._set_status(
            pod, PodPhase.RUNNING, pid=popen.pid, start_time=time.time()
        )
        log.info("spawned %s pid=%s", pod.key, popen.pid)

    def _check(self, pod: Pod) -> None:
        proc = self._procs.get(pod.key)
        if proc is None or proc.pod_uid != (pod.metadata.uid or ""):
            return
        # surface the gang-barrier stamp as soon as it exists
        if not proc.barrier_reported:
            bfile = os.path.join(proc.status_dir, bootstrap.BARRIER_FILE)
            if os.path.exists(bfile):
                try:
                    with open(bfile) as f:
                        t = float(f.read().strip())
                    self._set_status(pod, None, barrier_time=t)
                    proc.barrier_reported = True
                except (ValueError, OSError):
                    pass
        # surface activity heartbeats (notebook culling signal); only write
        # through when the stamp moved, to keep status churn low
        afile = os.path.join(proc.status_dir, "activity")
        try:
            t = float(open(afile).read().strip())
            if t > (pod.status.last_activity or 0.0) + 0.5:
                self._set_status(pod, None, last_activity=t)
        except (ValueError, OSError):
            pass
        code = proc.popen.poll()
        if code is None:
            return
        del self._procs[pod.key]
        if code < 0:
            # Popen reports signal deaths as -N; real kubelets report
            # 128+N (SIGKILL -> 137, SIGTERM -> 143), which is what the
            # RestartPolicy ExitCode allowlist treats as retryable.
            code = 128 - code
        phase = PodPhase.SUCCEEDED if code == 0 else PodPhase.FAILED
        fields = {}
        if code != 0:
            try:
                with open(os.path.join(proc.status_dir, TERMINATION_FILE)) as f:
                    fields["message"] = f.read().strip()
            except OSError:
                pass
        self._set_status(
            pod, phase, exit_code=code, finish_time=time.time(), **fields
        )
        log.info("pod %s exited code=%s", pod.key, code)

    def _kill(self, key: str) -> None:
        """SIGTERM -> grace -> SIGKILL, OFF the kubelet loop thread: the
        grace wait used to block the single-threaded loop, delaying the
        NEXT incarnation's spawn by up to GRACE_SECONDS whenever a gang
        restart's survivor was wedged in a collective with its dead peer
        (measured as a 3.1s respawn phase in the restart decomposition,
        scripts/gang_startup_bench.py)."""
        proc = self._procs.pop(key, None)
        if proc is None:
            return
        popen = proc.popen
        if popen.poll() is not None:
            return

        def grace_kill():
            try:
                os.killpg(os.getpgid(popen.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
            try:
                popen.wait(timeout=GRACE_SECONDS)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(os.getpgid(popen.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                try:
                    popen.wait(timeout=GRACE_SECONDS)
                except subprocess.TimeoutExpired:
                    pass

        t = threading.Thread(
            target=grace_kill, name=f"pod-kill-{popen.pid}", daemon=True)
        t.start()
        # prune finished grace threads as we go — a long-lived kubelet
        # restarting gangs must not accumulate one dead Thread per kill
        self._kill_threads = [
            x for x in self._kill_threads if x.is_alive()]
        self._kill_threads.append(t)

    # -- status writes ---------------------------------------------------------

    def _set_status(self, pod: Pod, phase: Optional[PodPhase], **fields) -> None:
        def mut(o):
            assert isinstance(o, Pod)
            if phase is not None:
                o.status.phase = phase
            for k, v in fields.items():
                if k == "message":
                    o.status.message = str(v)
                else:
                    setattr(o.status, k, v)

        try:
            self.store.update_with_retry(
                KIND_POD, pod.metadata.name, pod.metadata.namespace, mut
            )
        except NotFound:
            self._kill(pod.key)
