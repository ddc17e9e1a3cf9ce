"""Expectations cache — suppress reconciles against a stale informer view.

The one subtle concurrency mechanism SURVEY.md §5 calls out as worth keeping
conceptually [upstream: kubeflow/training-operator ->
pkg/controller.v1/expectation/ (from k8s controller_utils.go)]: after a
controller issues N creates/deletes, it must not trust its cached listing
until the N watch events land, or it will double-create.  Our store is
strongly consistent, but reconcilers still interleave with the scheduler,
kubelet, and user writes across threads, so the same guard applies.

The port's copy of ``kubeflow_tpu/controlplane/expectations.py``,
device-free like it, with the same names; it imports nothing of the
reference package.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class _Exp:
    adds: int = 0
    dels: int = 0
    timestamp: float = field(default_factory=time.time)


#: Expectations older than this are considered expired (controller restart /
#: lost event safety valve), same 5-minute TTL as upstream.
EXPECTATION_TTL_SECONDS = 300.0


class Expectations:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_key: dict[str, _Exp] = {}

    def expect_creations(self, key: str, n: int) -> None:
        with self._lock:
            e = self._by_key.setdefault(key, _Exp())
            e.adds += n
            e.timestamp = time.time()

    def expect_deletions(self, key: str, n: int) -> None:
        with self._lock:
            e = self._by_key.setdefault(key, _Exp())
            e.dels += n
            e.timestamp = time.time()

    def creation_observed(self, key: str) -> None:
        with self._lock:
            e = self._by_key.get(key)
            if e and e.adds > 0:
                e.adds -= 1

    def deletion_observed(self, key: str) -> None:
        with self._lock:
            e = self._by_key.get(key)
            if e and e.dels > 0:
                e.dels -= 1

    def satisfied(self, key: str) -> bool:
        with self._lock:
            e = self._by_key.get(key)
            if e is None:
                return True
            if e.adds <= 0 and e.dels <= 0:
                return True
            return (time.time() - e.timestamp) > EXPECTATION_TTL_SECONDS

    def forget(self, key: str) -> None:
        with self._lock:
            self._by_key.pop(key, None)
