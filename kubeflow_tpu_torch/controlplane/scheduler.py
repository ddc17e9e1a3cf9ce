"""Gang scheduler: all-or-nothing admission of PodGroups onto Nodes.

The Volcano analog [upstream: volcano-sh/volcano; SURVEY.md §1 L1]: pods
carrying a ``group-name`` annotation stay Pending until *every* member of
their PodGroup (>= ``min_member``) fits the cluster simultaneously; then the
whole gang binds atomically.  Non-gang pods (``scheduler_name: default``)
bind individually, best-fit.  This is where gang-startup latency is born
(SURVEY.md §3.1 step 4), so admission timestamps feed the baseline metric.

GPU placement rule: pods requesting ``gpu`` cards are packed
domain-first — all members of one gang land on nodes of as few NVLink
domains as possible (NVLink before the network).

The port's copy of ``kubeflow_tpu/controlplane/scheduler.py``, device-
free like it, with the same names and the same placements, counting
``gpu`` cards where the reference counts ``tpu`` chips; it imports
nothing of the reference package. Binding also allocates cards, as the
NVIDIA device plugin's ``Allocate`` does: a pod gets as many free ids of
its node's ``device_ids`` as it asks ``gpu`` for, distinct cards first,
recorded on ``PodSpec.device_ids`` beside ``node_name``; the ids of a pod
that ended or was deleted are free again.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

log = logging.getLogger("kubeflow_tpu_torch.scheduler")

from .objects import (
    GROUP_NAME_ANNOTATION,
    KIND_NODE,
    KIND_POD,
    KIND_PODGROUP,
    Node,
    Pod,
    PodGroup,
    PodGroupPhase,
    PodPhase,
    node_device_ids,
    pod_resources,
)
from .store import NotFound, Store

RESOURCE_KEYS = ("cpu", "memory_gb", "gpu")


def _fits(need: dict[str, float], free: dict[str, float]) -> bool:
    return all(need.get(k, 0.0) <= free.get(k, 0.0) + 1e-9 for k in RESOURCE_KEYS)


def _quota_fits(need: dict[str, float], quota: dict[str, float]) -> bool:
    """A quota constrains only the resources it names (upstream
    ResourceQuota semantics)."""
    return all(need.get(k, 0.0) <= v + 1e-9 for k, v in quota.items())


def _quota_sub(quota: dict[str, float], need: dict[str, float]) -> None:
    """Subtract usage from the resources the quota names — ONLY those, or
    unnamed resources would accumulate negative phantom limits."""
    for k in list(quota):
        quota[k] -= need.get(k, 0.0)


def _sub(free: dict[str, float], need: dict[str, float]) -> None:
    for k in RESOURCE_KEYS:
        free[k] = free.get(k, 0.0) - need.get(k, 0.0)


def _take_ids(free: list[int], n: int) -> list[int]:
    """``n`` ids taken out of ``free``, distinct cards first (a
    time-sliced card repeats only when no other card is free)."""
    got: list[int] = []
    while len(got) < n and free:
        fresh = [i for i in free if i not in got]
        pick = fresh[0] if fresh else free[0]
        free.remove(pick)
        got.append(pick)
    return got


class GangScheduler:
    """One scheduling pass = ``schedule_once``; ``run`` loops it in a thread."""

    def __init__(self, store: Store, interval: float = 0.02) -> None:
        self.store = store
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="gang-scheduler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.schedule_once()
            except Exception:  # noqa: BLE001 — scheduler must survive races
                log.exception("scheduling pass failed")
            self._stop.wait(self.interval)

    # -- core ------------------------------------------------------------------

    def _free_by_node(self) -> dict[str, dict[str, float]]:
        nodes = {n.metadata.name: dict(n.spec.capacity) for n in self.store.list(KIND_NODE)}
        for pod in self.store.list(KIND_POD):
            assert isinstance(pod, Pod)
            if pod.spec.node_name and not pod.terminal:
                if pod.spec.node_name in nodes:
                    _sub(nodes[pod.spec.node_name], pod_resources(pod))
        return nodes

    def _free_ids_by_node(self) -> dict[str, list[int]]:
        """Node -> the card ids no live bound pod holds."""
        free = {n.metadata.name: node_device_ids(n)
                for n in self.store.list(KIND_NODE)}
        for pod in self.store.list(KIND_POD):
            assert isinstance(pod, Pod)
            ids = free.get(pod.spec.node_name or "")
            if ids is None or pod.terminal:
                continue
            for i in pod.spec.device_ids:
                if i in ids:
                    ids.remove(i)
        return free

    def _node_order(self, nodes: dict[str, dict[str, float]]) -> list[str]:
        """Domain-first order: group node names by NVLink domain so a gang
        packs one domain before spilling to the next."""
        domain_of: dict[str, str] = {}
        for n in self.store.list(KIND_NODE):
            assert isinstance(n, Node)
            domain_of[n.metadata.name] = n.spec.nvlink_domain
        return sorted(nodes, key=lambda name: (domain_of.get(name, ""), name))

    def _quota_left(self) -> dict[str, dict[str, float]]:
        """Tenant namespace -> remaining Profile quota (SURVEY §2.4: the
        ResourceQuota capability, enforced here so gangs stay atomic)."""
        from ..api.platform import KIND_PROFILE, Profile

        left: dict[str, dict[str, float]] = {}
        for prof in self.store.list(KIND_PROFILE):
            if isinstance(prof, Profile) and prof.spec.resource_quota:
                left[prof.metadata.name] = dict(prof.spec.resource_quota)
        if not left:
            return left
        for pod in self.store.list(KIND_POD):
            assert isinstance(pod, Pod)
            if (
                pod.spec.node_name
                and not pod.terminal
                and pod.metadata.namespace in left
            ):
                _quota_sub(left[pod.metadata.namespace], pod_resources(pod))
        return left

    def _bind(self, pod: Pod, node_name: str, free_ids: list[int]) -> None:
        """Bind ``pod`` to ``node_name`` with its cards taken out of the
        node's ``free_ids``."""
        ids = _take_ids(free_ids, int(pod_resources(pod)["gpu"]))

        def mut(o):
            assert isinstance(o, Pod)
            o.spec.node_name = node_name
            o.spec.device_ids = list(ids)

        self.store.update_with_retry(KIND_POD, pod.metadata.name, pod.metadata.namespace, mut)

    def schedule_once(self) -> int:
        """Returns the number of pods bound this pass."""
        free = self._free_by_node()
        free_ids = self._free_ids_by_node()
        order = self._node_order(free)
        quota = self._quota_left()
        bound = 0

        all_pods = [p for p in self.store.list(KIND_POD) if isinstance(p, Pod)]
        pending = [
            p for p in all_pods if p.status.phase == PodPhase.PENDING and not p.spec.node_name
        ]
        # live gang membership counts bound members too, so a single
        # recreated member of an already-admitted gang still schedules
        live_members: dict[str, int] = {}
        for p in all_pods:
            group = p.metadata.annotations.get(GROUP_NAME_ANNOTATION)
            if group and not p.terminal:
                key = f"{p.metadata.namespace}/{group}"
                live_members[key] = live_members.get(key, 0) + 1

        # --- gang pods, grouped -------------------------------------------------
        gangs: dict[str, list[Pod]] = {}
        singles: list[Pod] = []
        for p in pending:
            group = p.metadata.annotations.get(GROUP_NAME_ANNOTATION)
            if p.spec.scheduler_name == "gang" and group:
                gangs.setdefault(f"{p.metadata.namespace}/{group}", []).append(p)
            else:
                singles.append(p)

        for group_key, pods in sorted(gangs.items()):
            ns, gname = group_key.split("/", 1)
            try:
                pg = self.store.get(KIND_PODGROUP, gname, ns)
            except NotFound:
                continue  # controller hasn't created the group yet
            assert isinstance(pg, PodGroup)
            if live_members.get(group_key, 0) < pg.spec.min_member:
                continue  # gang not fully materialized yet
            if ns in quota:
                need_total: dict[str, float] = {}
                for p in pods:
                    for k, v in pod_resources(p).items():
                        need_total[k] = need_total.get(k, 0.0) + v
                if not _quota_fits(need_total, quota[ns]):
                    self._set_group_phase(
                        pg, PodGroupPhase.PENDING,
                        f"profile quota exceeded in namespace {ns}")
                    continue
            placement = self._plan_gang(pods, free, order)
            if placement is None:
                self._set_group_phase(pg, PodGroupPhase.PENDING, "insufficient capacity")
                continue
            for pod, node_name in placement:
                self._bind(pod, node_name, free_ids[node_name])
                _sub(free[node_name], pod_resources(pod))
                if ns in quota:
                    _quota_sub(quota[ns], pod_resources(pod))
                bound += 1
            self._set_group_phase(pg, PodGroupPhase.RUNNING, "gang admitted")

        # --- singles ------------------------------------------------------------
        for pod in singles:
            need = pod_resources(pod)
            ns = pod.metadata.namespace
            if ns in quota and not _quota_fits(need, quota[ns]):
                continue  # over profile quota: stays Pending
            for node_name in order:
                if _fits(need, free[node_name]):
                    self._bind(pod, node_name, free_ids[node_name])
                    _sub(free[node_name], need)
                    if ns in quota:
                        _quota_sub(quota[ns], need)
                    bound += 1
                    break
        return bound

    def _plan_gang(
        self,
        pods: list[Pod],
        free: dict[str, dict[str, float]],
        order: list[str],
    ) -> Optional[list[tuple[Pod, str]]]:
        """All-or-nothing placement over a *copy* of the free map."""
        trial = {n: dict(f) for n, f in free.items()}
        placement: list[tuple[Pod, str]] = []
        for pod in sorted(pods, key=lambda p: p.metadata.name):
            need = pod_resources(pod)
            target = next((n for n in order if _fits(need, trial[n])), None)
            if target is None:
                return None
            _sub(trial[target], need)
            placement.append((pod, target))
        return placement

    def _set_group_phase(self, pg: PodGroup, phase: PodGroupPhase, msg: str) -> None:
        if pg.status.phase == phase and pg.status.message == msg:
            return

        def mut(o):
            assert isinstance(o, PodGroup)
            o.status.phase = phase
            o.status.message = msg
            if phase == PodGroupPhase.RUNNING and o.status.admitted_time is None:
                o.status.admitted_time = time.time()

        try:
            self.store.update_with_retry(
                KIND_PODGROUP, pg.metadata.name, pg.metadata.namespace, mut
            )
        except NotFound:
            pass
