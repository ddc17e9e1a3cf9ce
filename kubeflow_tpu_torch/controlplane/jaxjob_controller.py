"""JaxJob reconciler: JaxJob -> PodGroup + Pods + Services -> status.

The training-operator core loop rebuilt TPU-first (SURVEY.md §3.1)
[upstream: kubeflow/training-operator -> pkg/controller.v1/common/job.go
ReconcileJobs, pkg/controller.v1/jax/ JAXJobReconciler]:

1. admission (defaulting+validation) happens at store-create via webhooks;
2. ensure a PodGroup with ``min_member`` (Volcano analog) so the gang
   scheduler admits all-or-nothing;
3. ensure one Pod + headless Service per replica index, with the
   ``jax.distributed.initialize`` triple injected as env — the TPU-native
   replacement for MASTER_ADDR/RANK/WORLD_SIZE and TF_CONFIG;
4. aggregate pod phases into ReplicaStatus + JobConditions; apply RunPolicy
   (backoff, deadlines, gang timeout, TTL, clean-pod policy) and per-replica
   RestartPolicy (ExitCode-aware retries);
5. record the gang-startup metric (create -> every process past its first
   barrier) on job status — a headline BASELINE metric.

The port's copy of ``kubeflow_tpu/controlplane/jaxjob_controller.py``,
device-free like it, with the same names; it imports nothing of the
reference package.
"""

from __future__ import annotations

import json
import time
import zlib
from typing import Optional

from ..api.common import (
    JobCondition,
    JobConditionType,
    ObjectMeta,
    OwnerReference,
    ReplicaStatus,
    RestartPolicy,
    get_condition,
    has_condition,
    is_retryable_exit,
    replica_pod_name,
    replica_service_dns,
    set_condition,
)
from ..api.jaxjob import KIND_JAXJOB, WORKER, JaxJob
from ..api.common import CleanPodPolicy
from ..api.validation import default_jaxjob
from .controller import Controller, Result
from .expectations import Expectations
from .objects import (
    GROUP_NAME_ANNOTATION,
    KIND_POD,
    KIND_PODGROUP,
    KIND_SERVICE,
    LABEL_JOB_NAME,
    LABEL_REPLICA_INDEX,
    LABEL_REPLICA_TYPE,
    Pod,
    PodGroup,
    PodGroupPhase,
    PodPhase,
    PodSpec,
    Service,
    ServiceSpec,
)
from .store import ADDED, AlreadyExists, DELETED, NotFound, Store, WatchEvent
from ..utils.net import allocate_port

#: Env var names — the runtime bootstrap contract
#: (kubeflow_tpu_torch.runtime.bootstrap reads exactly these).
ENV_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_JOB_NAME = "KFT_JOB_NAME"
ENV_JOB_NAMESPACE = "KFT_JOB_NAMESPACE"
ENV_REPLICA_TYPE = "KFT_REPLICA_TYPE"
ENV_REPLICA_INDEX = "KFT_REPLICA_INDEX"
ENV_MESH = "KFT_MESH"  # json dict axis -> size


class JaxJobController(Controller):
    kind = KIND_JAXJOB
    owned_kinds = (KIND_POD, KIND_SERVICE, KIND_PODGROUP)
    workers = 2

    def __init__(self, store: Store) -> None:
        super().__init__(store)
        # Intentionally NOT durable: in-flight create/delete intent died
        # with the old process, and a fresh ledger is all-satisfied, so
        # the first post-restart reconcile trusts the store listing.
        # That listing already contains the pods that outlived a crash
        # because kubelet resync runs BEFORE controllers start
        # (cluster.py crash-restart order) — the HasSynced-before-
        # reconcile half of the upstream expectations contract.
        self.expectations = Expectations()

    # -- expectation accounting (SatisfiedExpectations pattern) ---------------

    def observe(self, ev: WatchEvent) -> None:
        if ev.obj.kind != KIND_POD:
            return
        key = self.owner_key_for(ev.obj)
        if key is None:
            return
        if ev.type == ADDED:
            self.expectations.creation_observed(key)
        elif ev.type == DELETED:
            self.expectations.deletion_observed(key)

    # -- reconcile ------------------------------------------------------------

    def reconcile(self, namespace: str, name: str) -> Optional[Result]:
        try:
            return self._reconcile(namespace, name)
        except NotFound:
            # the job (or an object mid-update) vanished under this pass —
            # a benign race with deletion, not a reconcile error: the
            # deletion's own watch event re-enqueues the key and the next
            # pass runs orphan cleanup (controller-runtime's IsNotFound
            # convention)
            return Result(requeue_after=0.02)

    def _reconcile(self, namespace: str, name: str) -> Optional[Result]:
        key = f"{namespace}/{name}"
        job = self.store.try_get(KIND_JAXJOB, name, namespace)
        if job is None:
            self._cleanup_orphans(namespace, name)
            self.expectations.forget(key)
            return None
        assert isinstance(job, JaxJob)

        if not self.expectations.satisfied(key):
            return Result(requeue_after=0.02)

        pods = [
            p
            for p in self.store.list(KIND_POD, namespace, labels={LABEL_JOB_NAME: name})
            if isinstance(p, Pod)
        ]

        # terminal jobs: only TTL cleanup remains
        terminal = has_condition(job.status.conditions, JobConditionType.SUCCEEDED) or (
            has_condition(job.status.conditions, JobConditionType.FAILED)
        )
        if terminal:
            return self._handle_ttl(job)

        if job.spec.run_policy.suspend:
            return self._handle_suspend(job, pods)

        resize_msg = self._resize_needed(job, pods)
        if resize_msg:
            return self._handle_resize(job, pods, resize_msg)

        self._ensure_condition(job, JobConditionType.CREATED, "JobCreated", "JaxJob accepted")

        pg = self._ensure_podgroup(job)
        if self._gang_timed_out(job, pg):
            self._fail(job, pods, "GangScheduleTimeout", "pod group unschedulable past timeout")
            return None

        job = self._resolve_coordinator_port(job)

        # restart pacing: while a gang restart's backoff window is open,
        # hold pod re-creation (a requeue alone would not — any owned-pod
        # event re-enqueues the key immediately)
        hold = self._restart_hold(job)
        if hold > 0:
            return Result(requeue_after=hold)
        self._ensure_pods_services(job, pods)

        # refresh pod view after creations for status aggregation
        pods = [
            p
            for p in self.store.list(KIND_POD, namespace, labels={LABEL_JOB_NAME: name})
            if isinstance(p, Pod)
        ]
        return self._update_status(job, pods)

    # -- ensure: PodGroup ------------------------------------------------------

    def _ensure_podgroup(self, job: JaxJob) -> Optional[PodGroup]:
        sp = job.spec.run_policy.scheduling_policy
        min_member = sp.min_available if sp and sp.min_available else job.spec.total_replicas
        pg = self.store.try_get(KIND_PODGROUP, job.metadata.name, job.metadata.namespace)
        if pg is None:
            pg = PodGroup(
                metadata=ObjectMeta(
                    name=job.metadata.name,
                    namespace=job.metadata.namespace,
                    owner_references=[self._owner_ref(job)],
                ),
                spec={
                    "min_member": min_member,
                    "queue": sp.queue if sp else "default",
                    "priority_class": sp.priority_class if sp else None,
                },
            )
            try:
                pg = self.store.create(pg)
                self.emit_event(job, "PodGroupCreated", f"gang minMember={min_member}")
            except AlreadyExists:
                pg = self.store.try_get(
                    KIND_PODGROUP, job.metadata.name, job.metadata.namespace
                )
        return pg  # type: ignore[return-value]

    def _gang_timed_out(self, job: JaxJob, pg: Optional[PodGroup]) -> bool:
        sp = job.spec.run_policy.scheduling_policy
        if not sp or sp.schedule_timeout_seconds is None or pg is None:
            return False
        if pg.status.phase == PodGroupPhase.RUNNING:
            return False
        created = pg.metadata.creation_timestamp or time.time()
        return (time.time() - created) > sp.schedule_timeout_seconds

    # -- coordinator port ------------------------------------------------------

    def _resolve_coordinator_port(self, job: JaxJob) -> JaxJob:
        """Allocate the rendezvous port at bind time, not submit time.

        spec.coordinator_port == 0 means "controller's choice": the port is
        picked here — in the one process that sees every gang on the host —
        and persisted to status so it survives gang restarts (r1 weak #6:
        SDK-side free_port() raced between pick and pod spawn, and parallel
        HPO trials could collide).
        """
        if job.spec.coordinator_port or job.status.coordinator_port:
            return job
        port = allocate_port()
        updated = self.store.update_with_retry(
            KIND_JAXJOB,
            job.metadata.name,
            job.metadata.namespace,
            lambda o: setattr(o.status, "coordinator_port", o.status.coordinator_port or port),
        )
        assert isinstance(updated, JaxJob)
        return updated

    def _job_port(self, job: JaxJob) -> int:
        return job.spec.coordinator_port or job.status.coordinator_port or 0

    # -- ensure: pods + headless services -------------------------------------

    def _ensure_pods_services(self, job: JaxJob, pods: list[Pod]) -> None:
        self._adopt_orphans(job, pods)
        existing = {
            (p.metadata.labels.get(LABEL_REPLICA_TYPE), int(p.metadata.labels.get(LABEL_REPLICA_INDEX, -1))): p
            for p in pods
        }
        to_create: list[Pod] = []
        for rtype, rspec in job.spec.replica_specs.items():
            for idx in range(rspec.replicas):
                if (rtype, idx) in existing:
                    continue
                to_create.append(self._build_pod(job, rtype, idx))
        if not to_create:
            return
        key = job.key
        self.expectations.expect_creations(key, len(to_create))
        created = 0
        for pod in to_create:
            try:
                self.store.create(pod)
                created += 1
            except AlreadyExists:
                self.expectations.creation_observed(key)
            self._ensure_service(job, pod)
        if created:
            self.emit_event(job, "PodsCreated", f"created {created} pods")

    def _adopt_orphans(self, job: JaxJob, pods: list[Pod]) -> None:
        """Pods matching this job's labels but missing its owner-ref are
        ADOPTED (owner-ref patched in) rather than shadowed by a
        recreate: after a control-plane crash a kubelet re-reports the
        pods that outlived it, and those must re-enter ownership — the
        ControllerRefManager adoption path [upstream: k8s
        controller_ref_manager.go], which is what keeps a restart from
        turning survivors into unadoptable orphans."""
        for p in pods:
            if any(r.kind == KIND_JAXJOB and r.name == job.metadata.name
                   and r.controller for r in p.metadata.owner_references):
                continue

            def mut(o, ref=self._owner_ref(job)):
                if not any(r.kind == ref.kind and r.name == ref.name
                           for r in o.metadata.owner_references):
                    o.metadata.owner_references.append(ref)

            try:
                self.store.update_with_retry(
                    KIND_POD, p.metadata.name, p.metadata.namespace, mut)
                self.emit_event(job, "PodAdopted",
                                f"adopted orphaned pod {p.metadata.name}")
            except NotFound:
                pass  # raced deletion: nothing to adopt

    def _build_pod(self, job: JaxJob, rtype: str, idx: int) -> Pod:
        rspec = job.spec.replica_specs[rtype]
        container = rspec.template.model_copy(deep=True)
        n_workers = job.spec.worker_count
        coord_dns = replica_service_dns(
            job.metadata.name, WORKER, 0, job.metadata.namespace
        )
        env = {
            ENV_JOB_NAME: job.metadata.name,
            ENV_JOB_NAMESPACE: job.metadata.namespace,
            ENV_REPLICA_TYPE: rtype,
            ENV_REPLICA_INDEX: str(idx),
            ENV_MESH: json.dumps(job.spec.mesh),
        }
        if rtype == WORKER:
            # only workers join the jax.distributed collective; auxiliary
            # roles (e.g. a dataset service) run outside it
            env[ENV_COORDINATOR_ADDRESS] = f"{coord_dns}:{self._job_port(job)}"
            env[ENV_NUM_PROCESSES] = str(n_workers)
            env[ENV_PROCESS_ID] = str(idx)
        container.env = {**env, **container.env}
        return Pod(
            metadata=ObjectMeta(
                name=replica_pod_name(job.metadata.name, rtype, idx),
                namespace=job.metadata.namespace,
                labels={
                    LABEL_JOB_NAME: job.metadata.name,
                    LABEL_REPLICA_TYPE: rtype,
                    LABEL_REPLICA_INDEX: str(idx),
                },
                annotations={GROUP_NAME_ANNOTATION: job.metadata.name},
                owner_references=[self._owner_ref(job)],
            ),
            spec=PodSpec(
                container=container,
                scheduler_name="gang",
                restart_policy=rspec.restart_policy.value,
            ),
        )

    def _ensure_service(self, job: JaxJob, pod: Pod) -> None:
        try:
            self.store.create(
                Service(
                    metadata=ObjectMeta(
                        name=pod.metadata.name,
                        namespace=pod.metadata.namespace,
                        owner_references=[self._owner_ref(job)],
                    ),
                    spec=ServiceSpec(
                        selector=dict(pod.metadata.labels),
                        ports=[self._job_port(job)],
                    ),
                )
            )
        except AlreadyExists:
            pass

    # -- status ----------------------------------------------------------------

    def _update_status(self, job: JaxJob, pods: list[Pod]) -> Optional[Result]:
        by_type: dict[str, ReplicaStatus] = {}
        failed_pods: list[Pod] = []
        barrier_times: list[float] = []
        workers_total = job.spec.worker_count
        for p in pods:
            rtype = p.metadata.labels.get(LABEL_REPLICA_TYPE, "")
            rs = by_type.setdefault(rtype, ReplicaStatus())
            if p.status.phase == PodPhase.SUCCEEDED:
                rs.succeeded += 1
            elif p.status.phase == PodPhase.FAILED:
                rs.failed += 1
                failed_pods.append(p)
            else:
                rs.active += 1
            if rtype == WORKER and p.status.barrier_time is not None:
                barrier_times.append(p.status.barrier_time)

        def mut(o):
            assert isinstance(o, JaxJob)
            o.status.replica_statuses = by_type
            if (
                o.status.gang_startup_seconds is None
                and len(barrier_times) == workers_total
                and workers_total > 0
            ):
                created = o.metadata.creation_timestamp or 0.0
                o.status.gang_startup_seconds = max(barrier_times) - created

        job = self._update_job(job, mut)

        worker_rs = by_type.get(WORKER, ReplicaStatus())
        any_running = any(
            p.status.phase == PodPhase.RUNNING for p in pods
        )
        if any_running and not has_condition(job.status.conditions, JobConditionType.RUNNING):
            job = self._set_cond(job, JobConditionType.RUNNING, "JobRunning", "workers running")
            job = self._update_job(job, lambda o: setattr(o.status, "start_time", o.status.start_time or time.time()))

        running_workers = sum(
            1 for p in pods
            if p.metadata.labels.get(LABEL_REPLICA_TYPE) == WORKER
            and p.status.phase == PodPhase.RUNNING
        )
        if not failed_pods and workers_total > 0 and running_workers == workers_total:
            job = self._observe_recovery(job)
            job = self._maybe_reset_restart_budget(job)

        # deadline
        rp = job.spec.run_policy
        if rp.active_deadline_seconds and job.status.start_time:
            if time.time() - job.status.start_time > rp.active_deadline_seconds:
                self._fail(job, pods, "DeadlineExceeded", "activeDeadlineSeconds exceeded")
                return None

        # success: every worker pod succeeded
        if workers_total > 0 and worker_rs.succeeded >= workers_total:
            job = self._set_cond(job, JobConditionType.SUCCEEDED, "JobSucceeded", "all workers succeeded")
            self._update_job(job, lambda o: setattr(o.status, "completion_time", time.time()))
            self.emit_event(job, "JobSucceeded", "all workers succeeded")
            self._clean_pods(job, pods)
            return self._handle_ttl(self.store.get(KIND_JAXJOB, job.metadata.name, job.metadata.namespace))  # type: ignore[arg-type]

        # failures: restart-policy + backoff decision
        if failed_pods:
            return self._handle_failures(job, pods, failed_pods)

        # keep polling while pods run (deadline / straggler watching)
        return Result(requeue_after=0.05) if any_running or worker_rs.active else None

    def _observe_recovery(self, job: JaxJob) -> JaxJob:
        """Every worker is Running again after a gang restart: close the
        Restarting condition and record restart->RUNNING latency (the
        recovery metric scripts/recovery_bench.py tracks the way
        gang_startup_bench.py tracks startup)."""
        cond = get_condition(job.status.conditions, JobConditionType.RESTARTING)
        if cond is None or not cond.status:
            return job
        # a resize also rides the Restarting condition but does not stamp
        # last_restart_time; its re-forming must not mint a bogus
        # recovery-latency sample off a stale failure timestamp
        recovery = (
            time.time() - job.status.last_restart_time
            if cond.reason == "PodsRestarting"
            and job.status.last_restart_time is not None else None
        )

        def mut(o):
            assert isinstance(o, JaxJob)
            o.status.conditions = set_condition(
                o.status.conditions,
                JobCondition(type=JobConditionType.RESTARTING, status=False,
                             reason="GangRecovered", message="gang re-formed"),
            )
            if recovery is not None:
                o.status.last_recovery_seconds = recovery

        job = self._update_job(job, mut)
        self.emit_event(
            job, "GangRecovered",
            json.dumps({"restart": job.status.restart_count,
                        "recovery_seconds":
                            round(recovery, 3) if recovery is not None else None}))
        return job

    def _maybe_reset_restart_budget(self, job: JaxJob) -> JaxJob:
        """Stable past the restart window -> restart_count goes back to 0,
        so backoff_limit bounds *flapping*, not lifetime bad luck."""
        rp = job.spec.run_policy
        if (rp.restart_window_seconds is None or not job.status.restart_count
                or has_condition(job.status.conditions, JobConditionType.RESTARTING)):
            return job
        anchor = job.status.last_restart_time or job.status.start_time
        if anchor is None:
            return job
        anchor += job.status.last_recovery_seconds or 0.0
        if time.time() - anchor <= rp.restart_window_seconds:
            return job
        job = self._update_job(
            job, lambda o: setattr(o.status, "restart_count", 0))
        self.emit_event(
            job, "RestartBudgetReset",
            f"stable for {rp.restart_window_seconds}s; restart budget restored")
        return job

    def _handle_failures(
        self, job: JaxJob, pods: list[Pod], failed_pods: list[Pod]
    ) -> Optional[Result]:
        retryable: list[Pod] = []
        for p in failed_pods:
            policy = RestartPolicy(p.spec.restart_policy)
            code = p.status.exit_code if p.status.exit_code is not None else 1
            if policy == RestartPolicy.ALWAYS or policy == RestartPolicy.ON_FAILURE:
                retryable.append(p)
            elif policy == RestartPolicy.EXIT_CODE and is_retryable_exit(code):
                retryable.append(p)
            else:
                self._fail(
                    job,
                    pods,
                    "PodFailed",
                    f"pod {p.metadata.name} exit={code} policy={policy.value}",
                )
                return None

        if job.status.restart_count + 1 > job.spec.run_policy.backoff_limit:
            self._fail(job, pods, "BackoffLimitExceeded", f"restarts={job.status.restart_count}")
            return None

        # gang restart: a failed member invalidates the collective; delete ALL
        # pods so the gang re-forms (jax.distributed cannot patch one rank).
        key = job.key
        live = [p for p in pods if self.store.try_get(KIND_POD, p.metadata.name, p.metadata.namespace)]
        self.expectations.expect_deletions(key, len(live))
        for p in live:
            if not self.store.try_delete(KIND_POD, p.metadata.name, p.metadata.namespace):
                self.expectations.deletion_observed(key)
        job = self._set_cond(job, JobConditionType.RESTARTING, "PodsRestarting", "gang restart after failure")

        def bump(o):
            o.status.restart_count += 1
            o.status.last_restart_time = time.time()
            if not o.spec.coordinator_port:
                # fresh coordinator port for the new incarnation: the old
                # coordinator process may hold the previous port through
                # its kill-grace window, and jax.distributed's bind/
                # connect retry backoff was the dominant term of
                # restart->resume (measured ~10.5s of 11s p50,
                # scripts/gang_startup_bench.py phase decomposition) —
                # the new gang's pods are rebuilt anyway, so they carry
                # the new port in their env
                o.status.coordinator_port = None

        job = self._update_job(job, bump)
        delay = self._restart_backoff(job)
        self.emit_event(
            job, "Restarting",
            json.dumps({"restart": job.status.restart_count,
                        "backoff_seconds": round(delay, 3)}),
            "Warning")
        return Result(requeue_after=delay)

    # -- restart pacing --------------------------------------------------------

    def _restart_backoff(self, job: JaxJob) -> float:
        """Delay before the gang's next incarnation: exponential in the
        restart count, capped, with deterministic +-50% jitter (stable
        across reconcile passes — a random draw here would make the hold
        gate flicker — but decorrelated across jobs, so N gangs felled by
        one node do not re-form in lockstep)."""
        rp = job.spec.run_policy
        n = max(job.status.restart_count - 1, 0)
        base = min(rp.restart_backoff_seconds * (2 ** n),
                   rp.restart_backoff_max_seconds)
        salt = f"{job.metadata.uid}:{job.status.restart_count}".encode()
        jitter = 0.5 + (zlib.crc32(salt) % 1000) / 1000.0
        return base * jitter

    def _restart_hold(self, job: JaxJob) -> float:
        """Seconds the backoff window still has open, 0 when clear."""
        if not has_condition(job.status.conditions, JobConditionType.RESTARTING):
            return 0.0
        if job.status.last_restart_time is None:
            return 0.0
        return max(
            0.0,
            job.status.last_restart_time + self._restart_backoff(job) - time.time(),
        )

    # -- terminal helpers ------------------------------------------------------

    def _fail(self, job: JaxJob, pods: list[Pod], reason: str, message: str) -> None:
        job = self._set_cond(job, JobConditionType.FAILED, reason, message)
        self._update_job(job, lambda o: setattr(o.status, "completion_time", time.time()))
        self.emit_event(job, reason, message, "Warning")
        self._clean_pods(job, pods)

    def _clean_pods(self, job: JaxJob, pods: list[Pod]) -> None:
        policy = job.spec.run_policy.clean_pod_policy
        if policy == CleanPodPolicy.NONE:
            return
        for p in pods:
            if policy == CleanPodPolicy.RUNNING and p.terminal:
                continue
            self.store.try_delete(KIND_POD, p.metadata.name, p.metadata.namespace)

    # -- elastic resize --------------------------------------------------------

    def _resize_needed(self, job: JaxJob, pods: list[Pod]) -> Optional[str]:
        """A live worker whose stamped world size (or index range) no longer
        matches the spec means the user changed ``replicas`` on a running
        job — the PyTorchJob ElasticPolicy capability, TPU-style: the
        collective cannot be patched one rank at a time, so the whole gang
        re-forms on the new world size and resumes from checkpoint
        (reshape-restore, SURVEY §2.5 elastic row)."""
        want = job.spec.worker_count
        for p in pods:
            if p.metadata.labels.get(LABEL_REPLICA_TYPE) != WORKER or p.terminal:
                continue
            stamped = p.spec.container.env.get(ENV_NUM_PROCESSES)
            if stamped is not None and int(stamped) != want:
                return f"world size {stamped} -> {want}"
            idx = int(p.metadata.labels.get(LABEL_REPLICA_INDEX, 0))
            if idx >= want:
                return f"worker index {idx} out of range for {want} replicas"
        return None

    def _handle_resize(
        self, job: JaxJob, pods: list[Pod], msg: str
    ) -> Optional[Result]:
        """suspend gang -> recompute stale defaults -> re-gang on the new
        size.  Deleted workers get SIGTERM and save-on-preemption; the new
        gang's ``restore_or_init`` reshape-restores onto the new mesh.
        Resizes do not consume the failure backoff budget."""

        def mut(o: JaxJob) -> None:
            # the new gang is all-or-nothing at its new size: a stamped
            # min_available from the old world size would under-admit
            # (scale-up) or over-demand (scale-down) the collective
            sp = o.spec.run_policy.scheduling_policy
            if sp is not None:
                sp.min_available = o.spec.total_replicas
            default_jaxjob(o)

        job = self._update_job(job, mut)
        # PodGroup is recreated next reconcile with the new min_member
        self.store.try_delete(KIND_PODGROUP, job.metadata.name, job.metadata.namespace)
        # per-replica Services for removed indices would otherwise leak
        # until job deletion; drop them all — the next reconcile recreates
        # one per surviving pod
        for svc in self.store.list(KIND_SERVICE, job.metadata.namespace):
            if any(
                r.kind == KIND_JAXJOB and r.name == job.metadata.name
                for r in svc.metadata.owner_references
            ):
                self.store.try_delete(
                    KIND_SERVICE, svc.metadata.name, job.metadata.namespace)
        key = job.key
        live = [
            p for p in pods
            if self.store.try_get(KIND_POD, p.metadata.name, p.metadata.namespace)
        ]
        self.expectations.expect_deletions(key, len(live))
        for p in live:
            if not self.store.try_delete(KIND_POD, p.metadata.name, p.metadata.namespace):
                self.expectations.deletion_observed(key)
        self._set_cond(
            job, JobConditionType.RESTARTING, "Resizing", f"elastic resize: {msg}")
        self.emit_event(job, "Resizing", msg)
        return Result(requeue_after=0.05)

    def _handle_suspend(self, job: JaxJob, pods: list[Pod]) -> Optional[Result]:
        for p in pods:
            self.store.try_delete(KIND_POD, p.metadata.name, p.metadata.namespace)
        self.store.try_delete(KIND_PODGROUP, job.metadata.name, job.metadata.namespace)
        self._set_cond(job, JobConditionType.SUSPENDED, "JobSuspended", "suspend=true")
        return None

    def _handle_ttl(self, job: JaxJob) -> Optional[Result]:
        ttl = job.spec.run_policy.ttl_seconds_after_finished
        if ttl is None:
            return None
        done = job.status.completion_time or time.time()
        remaining = done + ttl - time.time()
        if remaining > 0:
            return Result(requeue_after=remaining)
        self._cleanup_orphans(job.metadata.namespace, job.metadata.name)
        self.store.try_delete(KIND_JAXJOB, job.metadata.name, job.metadata.namespace)
        return None

    def _cleanup_orphans(self, namespace: str, name: str) -> None:
        for kind in (KIND_POD, KIND_SERVICE):
            for obj in self.store.list(kind, namespace, labels={LABEL_JOB_NAME: name}):
                self.store.try_delete(kind, obj.metadata.name, namespace)
        # services created per-pod carry the owner ref but not the job label
        for svc in self.store.list(KIND_SERVICE, namespace):
            if any(r.kind == KIND_JAXJOB and r.name == name for r in svc.metadata.owner_references):
                self.store.try_delete(KIND_SERVICE, svc.metadata.name, namespace)
        self.store.try_delete(KIND_PODGROUP, name, namespace)

    # -- small utils -----------------------------------------------------------

    def _owner_ref(self, job: JaxJob) -> OwnerReference:
        return OwnerReference(kind=KIND_JAXJOB, name=job.metadata.name, uid=job.metadata.uid)

    def _set_cond(self, job: JaxJob, ctype: JobConditionType, reason: str, msg: str) -> JaxJob:
        def mut(o):
            assert isinstance(o, JaxJob)
            o.status.conditions = set_condition(
                o.status.conditions, JobCondition(type=ctype, reason=reason, message=msg)
            )

        return self._update_job(job, mut)

    def _ensure_condition(self, job: JaxJob, ctype: JobConditionType, reason: str, msg: str) -> JaxJob:
        if has_condition(job.status.conditions, ctype):
            return job
        return self._set_cond(job, ctype, reason, msg)

    def _update_job(self, job: JaxJob, mut) -> JaxJob:
        out = self.store.update_with_retry(
            KIND_JAXJOB, job.metadata.name, job.metadata.namespace, mut
        )
        assert isinstance(out, JaxJob)
        return out
