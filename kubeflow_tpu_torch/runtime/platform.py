"""LocalPlatform: a whole "cluster" in one process tree.

Cluster (store + admission + gang scheduler + reconcilers) + LocalKubelet
(real OS processes) — the fully-wired stack the SDK talks to, standing in
for {k8s apiserver + Volcano + training-operator + kubelet} (SURVEY.md §4c).
Every JaxJob submitted here runs real pod processes that form a
``torch.distributed`` group: on the pod's own cards, or on the CPU where
``KFT_POD_DEVICE=cpu`` (``env_overrides`` or this process's env) says so.
Its hosts are GPU hosts where the reference's are TPU slices.

The port's copy of ``kubeflow_tpu/runtime/platform.py``, device-free
like it, with the same names; it imports nothing of the reference
package.
"""

from __future__ import annotations

import tempfile
from typing import Optional

from ..controlplane.cluster import Cluster
from .launcher import LocalKubelet


class LocalPlatform:
    """``num_domains`` NVLink domains of ``num_hosts`` GPU hosts, each
    exposing ``gpus_per_host`` cards (``device_ids``, default
    ``range(gpus_per_host)``, the same on every host: the local stand-in
    of a host of several cards may name one card several times)."""

    def __init__(
        self,
        num_hosts: int = 1,
        gpus_per_host: int = 4,
        num_domains: int = 1,
        root_dir: Optional[str] = None,
        env_overrides: Optional[dict[str, str]] = None,
        device_ids: Optional[list[int]] = None,
    ) -> None:
        self.cluster = Cluster()
        for d in range(num_domains):
            self.cluster.add_gpu_hosts(f"domain-{d}", num_hosts,
                                       gpus_per_host, device_ids=device_ids)
        self.root_dir = root_dir or tempfile.mkdtemp(prefix="kft-")
        self.kubelet = LocalKubelet(
            self.cluster.store, self.root_dir, env_overrides=env_overrides
        )
        self.cluster.enable_hpo(
            metrics_root=self.root_dir, log_path_for=self.kubelet.pod_log_path
        )
        self.cluster.enable_serving()

    @property
    def store(self):
        return self.cluster.store

    def start(self) -> "LocalPlatform":
        self.cluster.start()
        self.kubelet.start()
        return self

    def stop(self) -> None:
        self.kubelet.stop()
        self.cluster.stop()

    def __enter__(self) -> "LocalPlatform":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
