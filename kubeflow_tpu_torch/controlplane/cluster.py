"""Cluster facade: wire the store, admission webhooks, scheduler, controllers.

The ``cmd/training-operator.v1/main.go`` analog [upstream:
kubeflow/training-operator]: one manager that registers schemes/webhooks and
starts every reconciler, plus (unlike the reference, which assumes a real
cluster underneath) the substrate itself — Nodes and a gang scheduler.

The port's copy of ``kubeflow_tpu/controlplane/cluster.py``, device-free
like it, with the same names; it imports nothing of the reference
package. It registers the port's runtimes, and its ux and hpo tiers are
the port's copies. Its metrics endpoint listens with
``BurstHTTPServer``'s backlog. Its nodes are GPU hosts (``add_gpu_host``,
``add_gpu_hosts`` over an NVLink domain) where the reference models TPU
slices (``add_tpu_slice``).
"""

from __future__ import annotations

from typing import Optional

from ..api import (
    default_experiment,
    default_inference_service,
    default_jaxjob,
    validate_experiment,
    validate_inference_service,
    validate_jaxjob,
)
from ..api.common import ObjectMeta
from ..api.experiment import KIND_EXPERIMENT
from ..api.inference import KIND_INFERENCE_SERVICE
from ..api.jaxjob import KIND_JAXJOB
from .controller import Controller
from .jaxjob_controller import JaxJobController
from .objects import KIND_NODE, Node, NodeSpec
from .scheduler import GangScheduler
from .store import Store


def register_default_admission(store: Store) -> None:
    """The platform's webhook set — defaulting + validation per kind.
    Every store that accepts user writes (Cluster-owned OR a standalone
    durable ApiServer's) must register these, or un-defaulted/invalid
    specs get WAL-persisted and replayed admission-free forever."""
    store.register_admission(
        KIND_JAXJOB, mutate=default_jaxjob, validate=validate_jaxjob)
    store.register_admission(
        KIND_EXPERIMENT, mutate=default_experiment,
        validate=validate_experiment)
    store.register_admission(
        KIND_INFERENCE_SERVICE,
        mutate=default_inference_service,
        validate=validate_inference_service,
    )


class Cluster:
    def __init__(self, data_dir: Optional[str] = None,
                 wal_crashpoint=None) -> None:
        """``data_dir`` turns on control-plane durability: the store is
        recovered from (and keeps logging to) a WAL + snapshot there, so
        a crash-restarted Cluster resumes every JaxJob/ISvc/pod where
        the log left them.  ``wal_crashpoint`` is the chaos harness's
        kill switch (``FaultPlan.wal_crashpoint()``).

        Crash-restart order matters: re-attach surviving kubelets
        (``FakeKubelet.attach_store``) BEFORE ``start()`` so controllers
        adopt the pods that outlived the crash instead of re-creating
        them — the informer-cache-sync-before-reconcile contract."""
        self.store = (
            Store.open(data_dir, crashpoint=wal_crashpoint)
            if data_dir is not None else Store())
        self._register_admission()
        self.scheduler = GangScheduler(self.store)
        self.controllers: list[Controller] = [JaxJobController(self.store)]
        self._started = False

    def _register_admission(self) -> None:
        register_default_admission(self.store)

    def add_controller(self, c: Controller) -> None:
        self.controllers.append(c)
        if self._started:
            c.start()

    def enable_serving(self) -> None:
        """Register the KServe-tier reconciler + the builtin ServingRuntimes,
        the port's torch predictors under the reference's runtime names
        (``kft-torch`` in place of ``kft-jax``)."""
        from ..api.inference import ServingRuntime, ServingRuntimeSpec, SupportedModelFormat
        from ..serving.controller import InferenceServiceController

        rt = "kubeflow_tpu_torch.serving.runtimes"
        for name, formats, server_class in (
            ("kft-echo", ["echo"], f"{rt}:EchoModel"),
            ("kft-torch", ["torch", "pytorch"], f"{rt}:TorchFunctionModel"),
            ("kft-llama", ["llama", "llm"], f"{rt}:LlamaGenerator"),
            ("kft-llama-continuous", ["llama-continuous"],
             "kubeflow_tpu_torch.serving.continuous:ContinuousLlamaGenerator"),
            ("kft-text-llm", ["text-llm"],
             "kubeflow_tpu_torch.serving.text:TextGenerator"),
            ("kft-bert", ["bert"], f"{rt}:BertClassifierModel"),
        ):
            try:
                self.store.create(
                    ServingRuntime(
                        metadata=ObjectMeta(name=name),
                        spec=ServingRuntimeSpec(
                            supported_model_formats=[
                                SupportedModelFormat(name=f) for f in formats
                            ],
                            server_class=server_class,
                        ),
                    )
                )
            except Exception:  # noqa: BLE001 — already registered
                pass
        self.add_controller(InferenceServiceController(self.store))
        from ..serving.graph import InferenceGraphController

        self.add_controller(InferenceGraphController(self.store))

    def enable_platform_ux(self) -> None:
        """Register the L7 shell tier (SURVEY.md §2.4): Profile multi-
        tenancy (quota enforced by the gang scheduler), Notebook workbenches,
        PodDefault injection.  The dashboard is ``serve_dashboard``."""
        from ..controlplane.objects import KIND_POD
        from ..ux.notebooks import NotebookController
        from ..ux.poddefaults import pod_default_mutator
        from ..ux.profiles import ProfileController

        self.store.register_admission(KIND_POD, mutate=pod_default_mutator(self.store))
        self.add_controller(ProfileController(self.store))
        self.add_controller(NotebookController(self.store))

    def serve_api(self, port: int = 0, token: "str | None" = None,
                  profile_tokens: "dict[str, str] | None" = None) -> str:
        """Start the REST API server (kube-apiserver analog) over this
        cluster's store; returns its URL for the kft CLI ($KFT_SERVER).
        Stopped with the cluster.  ``token`` (or $KFT_API_TOKEN) turns on
        admin bearer-token authn; ``profile_tokens`` (or $KFT_API_TOKENS,
        or Profile.spec.api_token) adds per-tenant identities whose
        mutations scope to their profile namespace (apiserver.py
        docstring)."""
        from .apiserver import ApiServer

        self._apiserver = ApiServer(
            self.store, port=port or None,
            profile_tokens=profile_tokens,
            log_path_for=getattr(self, "_log_path_for", None),
            token=token)
        return self._apiserver.url

    def serve_dashboard(self, port: int = 0) -> str:
        """Start the central dashboard over this cluster's store; returns
        its URL.  Stopped with the cluster.  When HPO is enabled the
        dashboard also gets the observation DB (experiment curves) and
        the pod-log resolver (log views)."""
        from ..ux.dashboard import Dashboard

        self._dashboard = Dashboard(
            self.store, port=port or None,
            db=getattr(self, "_db_client", None),
            log_path_for=getattr(self, "_log_path_for", None))
        return self._dashboard.url

    def enable_hpo(
        self,
        metrics_root: Optional[str] = None,
        log_path_for=None,
        db_path: Optional[str] = None,
    ) -> None:
        """Register the Katib-tier reconcilers (SURVEY.md §2.3).  Separate
        from __init__ because the trial metrics collector needs the kubelet's
        filesystem layout, which only the platform knows.

        ``db_path`` (defaulting to ``<metrics_root>/observations.sqlite``
        when a metrics root exists) stands up the durable observation store
        behind its gRPC facade (hpo/db.py, the katib-db-manager analog):
        completed-trial history then survives control-plane restarts."""
        import os

        from ..hpo.controllers import (
            ExperimentController,
            SuggestionController,
            TrialController,
        )
        from ..hpo.db import DbManagerClient, DbManagerServer

        self._log_path_for = log_path_for  # also feeds dashboard + apiserver
        dashboard = getattr(self, "_dashboard", None)
        if dashboard is not None:
            # dashboard started before HPO: hand it the log source now
            dashboard.log_path_for = log_path_for
        apiserver = getattr(self, "_apiserver", None)
        if apiserver is not None:
            apiserver.log_path_for = log_path_for  # kft logs
        if db_path is None and metrics_root is not None:
            db_path = os.path.join(metrics_root, "observations.sqlite")
        db_client = None
        if db_path is not None:
            self._db_server = DbManagerServer(db_path).start()
            db_client = self._db_client = DbManagerClient(self._db_server.address)
            if dashboard is not None:
                dashboard.db = db_client

        self.add_controller(ExperimentController(self.store, db=db_client))
        self.add_controller(SuggestionController(self.store, db=db_client))
        self.add_controller(
            TrialController(
                self.store, metrics_root=metrics_root,
                log_path_for=log_path_for, db=db_client,
            )
        )

    def add_node(
        self,
        name: str,
        cpu: float = 64.0,
        memory_gb: float = 128.0,
        gpu: int = 0,
        nvlink_domain: str = "domain-0",
        device_ids: Optional[list[int]] = None,
    ) -> Node:
        node = Node(
            metadata=ObjectMeta(name=name),
            spec=NodeSpec(
                capacity={"cpu": cpu, "memory_gb": memory_gb, "gpu": float(gpu)},
                nvlink_domain=nvlink_domain,
                device_ids=list(device_ids or ()),
            ),
        )
        created = self.store.create(node)
        assert isinstance(created, Node)
        return created

    def add_gpu_host(
        self,
        name: str,
        gpus: int,
        device_ids: Optional[list[int]] = None,
        nvlink_domain: str = "domain-0",
    ) -> Node:
        """A host exposing ``gpus`` NVIDIA cards, their ids ``device_ids``
        (default ``range(gpus)``; an id may repeat, as time-slicing
        advertises one card as several)."""
        return self.add_node(name, gpu=gpus, nvlink_domain=nvlink_domain,
                             device_ids=device_ids)

    def add_gpu_hosts(
        self, domain: str, num_hosts: int, gpus_per_host: int = 8,
        device_ids: Optional[list[int]] = None,
    ) -> list[Node]:
        """``num_hosts`` hosts of one NVLink domain (``<domain>-host-<i>``),
        each exposing ``gpus_per_host`` cards (an HGX H100 board has 8),
        ``device_ids`` on every host."""
        return [
            self.add_gpu_host(f"{domain}-host-{i}", gpus_per_host,
                              device_ids=device_ids, nvlink_domain=domain)
            for i in range(num_hosts)
        ]

    def metrics_text(self) -> str:
        """Prometheus exposition for every reconciler (the manager's
        ``--metrics-bind-address`` surface [upstream: training-operator
        cmd/training-operator.v1/main.go])."""
        parts = [
            "# TYPE kft_reconcile_total counter",
            "# TYPE kft_reconcile_errors_total counter",
            "# TYPE kft_reconcile_time_seconds histogram",
            "# TYPE kft_workqueue_depth gauge",
        ]
        for c in self.controllers:
            parts.append(c.metrics.prometheus(len(c.queue)).rstrip("\n"))
        return "\n".join(parts) + "\n"

    def serve_metrics(self, port: int = 0) -> str:
        """Expose ``/metrics`` over HTTP; returns the bound URL."""
        import threading
        from http.server import BaseHTTPRequestHandler

        from ..utils.net import BurstHTTPServer, allocate_port

        cluster = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                if self.path != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                body = cluster.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        port = port or allocate_port()
        self._metrics_httpd = BurstHTTPServer(("127.0.0.1", port), Handler)
        threading.Thread(
            target=self._metrics_httpd.serve_forever,
            name="cluster-metrics", daemon=True,
        ).start()
        return f"http://127.0.0.1:{port}/metrics"

    def start(self) -> None:
        self.scheduler.start()
        for c in self.controllers:
            c.start()
        self._started = True

    def stop(self) -> None:
        for c in self.controllers:
            c.stop()
        self.scheduler.stop()
        if getattr(self, "_metrics_httpd", None) is not None:
            self._metrics_httpd.shutdown()
            self._metrics_httpd.server_close()
            self._metrics_httpd = None
        if getattr(self, "_dashboard", None) is not None:
            self._dashboard.stop()
            self._dashboard = None
        if getattr(self, "_apiserver", None) is not None:
            self._apiserver.stop()
            self._apiserver = None
        if getattr(self, "_db_client", None) is not None:
            self._db_client.close()
            self._db_client = None
        if getattr(self, "_db_server", None) is not None:
            self._db_server.stop()
            self._db_server = None
        self.store.close()  # flush + detach the WAL (no-op in-memory)
        self._started = False

    def __enter__(self) -> "Cluster":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
