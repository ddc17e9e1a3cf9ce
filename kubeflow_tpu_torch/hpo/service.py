"""Suggestion service: the algorithm behind a real gRPC boundary.

Katib runs each algorithm as a per-experiment gRPC Deployment the suggestion
controller calls ``GetSuggestions`` on [upstream: kubeflow/katib ->
pkg/apis/manager/v1beta1/api.proto, pkg/suggestion/v1beta1/].  Same shape
here: a gRPC server per experiment, spoken to over localhost.  protoc stubs
aren't available in this image (no grpcio-tools), so the service uses
grpc's generic handler with JSON payloads — still a real network RPC with
the same request/response content as Katib's proto.

The port's copy of ``kubeflow_tpu/hpo/service.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc

from ..api.experiment import ObjectiveType, ParameterSpec
from ..utils.grpcjson import bind_insecure
from ..utils.grpcjson import deserialize as _deserialize
from ..utils.grpcjson import serialize as _serialize
from ..utils.net import allocate_port
from . import algorithms

SERVICE = "kubeflow_tpu_torch.hpo.Suggestion"
METHOD = f"/{SERVICE}/GetSuggestions"


class _Handler(grpc.GenericRpcHandler):
    def __init__(self) -> None:
        self._methods = {
            METHOD: grpc.unary_unary_rpc_method_handler(
                self._get_suggestions,
                request_deserializer=_deserialize,
                response_serializer=_serialize,
            )
        }

    def service(self, handler_call_details):
        return self._methods.get(handler_call_details.method)

    def _get_suggestions(self, request: dict, context) -> dict:
        try:
            req = algorithms.SuggestRequest(
                parameters=[ParameterSpec(**p) for p in request["parameters"]],
                objective_type=ObjectiveType(request["objective_type"]),
                history=[
                    algorithms.Observation(**ob) for ob in request.get("history", [])
                ],
                count=int(request.get("count", 1)),
                settings=request.get("settings", {}),
                seed=request.get("seed"),
                issued=int(request.get("issued", 0)),
            )
            suggester = algorithms.get_suggester(request["algorithm"])
            return {"assignments": suggester.suggest(req)}
        except Exception as e:  # noqa: BLE001 — surface as RPC error
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"{type(e).__name__}: {e}")


class SuggestionServer:
    """One algorithm service instance (the Katib suggestion Deployment analog)."""

    def __init__(self, port: Optional[int] = None, max_workers: int = 2):
        self.port = port or allocate_port()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((_Handler(),))
        bind_insecure(self._server, "127.0.0.1", self.port)

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "SuggestionServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=1.0)


class SuggestionClient:
    def __init__(self, address: str):
        self._channel = grpc.insecure_channel(address)
        self._call = self._channel.unary_unary(
            METHOD, request_serializer=_serialize, response_deserializer=_deserialize)

    def get_suggestions(
        self,
        algorithm: str,
        parameters: list[ParameterSpec],
        objective_type: ObjectiveType,
        history: list[algorithms.Observation],
        count: int,
        settings: Optional[dict[str, str]] = None,
        issued: int = 0,
        timeout: float = 30.0,
    ) -> list[dict[str, object]]:
        resp = self._call(
            {
                "algorithm": algorithm,
                "parameters": [p.model_dump(mode="json") for p in parameters],
                "objective_type": objective_type.value,
                "history": [
                    {"assignments": ob.assignments, "value": ob.value,
                     "trial": ob.trial}
                    for ob in history
                ],
                "count": count,
                "settings": settings or {},
                "issued": issued,
            },
            timeout=timeout,
        )
        return resp["assignments"]

    def close(self) -> None:
        self._channel.close()
