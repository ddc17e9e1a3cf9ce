"""Cluster facade: wire the store, admission webhooks, scheduler, controllers.

The ``cmd/training-operator.v1/main.go`` analog [upstream:
kubeflow/training-operator]: one manager that registers schemes/webhooks and
starts every reconciler, plus (unlike the reference, which assumes a real
cluster underneath) the substrate itself — Nodes and a gang scheduler.

The port's copy of ``kubeflow_tpu/controlplane/cluster.py``, device-free
like it, with the same names; it imports nothing of the reference
package. It registers the port's runtimes; the ux and hpo tiers raise
naming ROADMAP A15 until they are copied. Its metrics endpoint listens
with ``BurstHTTPServer``'s backlog.
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


def _not_copied(what: str, modules: str) -> None:
    raise NotImplementedError(
        f"Cluster.{what} needs {modules}, which is not copied into the "
        "port yet (ROADMAP A15)")


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
        """The L7 shell tier (Profiles' controller, Notebooks, PodDefaults):
        ``ux/`` is not copied into the port yet."""
        _not_copied("enable_platform_ux", "ux/")

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
        """The central dashboard: ``ux/`` is not copied into the port yet."""
        _not_copied("serve_dashboard", "ux/")

    def enable_hpo(
        self,
        metrics_root: Optional[str] = None,
        log_path_for=None,
        db_path: Optional[str] = None,
    ) -> None:
        """The Katib-tier reconcilers: the hpo controllers, service, db and
        algorithms are not copied into the port yet (its ``hpo/`` holds
        ``nas.py`` alone)."""
        _not_copied("enable_hpo", "hpo/{controllers,service,db,algorithms}.py")

    def add_node(
        self,
        name: str,
        cpu: float = 64.0,
        memory_gb: float = 128.0,
        tpu: int = 0,
        slice_id: str = "slice-0",
    ) -> Node:
        node = Node(
            metadata=ObjectMeta(name=name),
            spec=NodeSpec(
                capacity={"cpu": cpu, "memory_gb": memory_gb, "tpu": float(tpu)},
                slice_id=slice_id,
            ),
        )
        created = self.store.create(node)
        assert isinstance(created, Node)
        return created

    def add_tpu_slice(
        self, slice_id: str, num_hosts: int, chips_per_host: int = 4
    ) -> list[Node]:
        """Model a TPU pod slice: ``num_hosts`` VMs sharing ICI, each exposing
        ``chips_per_host`` chips (v5e default: 4 chips/VM, so v5e-16 = 4 hosts)."""
        return [
            self.add_node(
                f"{slice_id}-host-{i}",
                tpu=chips_per_host,
                slice_id=slice_id,
            )
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
