"""V2 inference protocol over gRPC — the data plane's second wire format.

[upstream: kserve/kserve -> python/kserve grpc server implementing
inference.GRPCInferenceService (ModelInfer/ModelReady/ServerLive...)].
Same service surface here, attached to an existing ModelServer so both
protocols share one model repository and one micro-batcher.  protoc stubs
aren't available in this image (no grpcio-tools), so like hpo/service.py
the methods ride grpc's generic handler with JSON payloads carrying the
exact V2 message content.

The port's copy of ``kubeflow_tpu/serving/grpc_server.py``, device-free
like it, with the same names; it imports nothing of the reference
package.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc

from ..utils.grpcjson import bind_insecure, deserialize as _de, serialize as _ser
from ..utils.net import allocate_port
from .server import ModelServer

SERVICE = "inference.GRPCInferenceService"


class _Handler(grpc.GenericRpcHandler):
    def __init__(self, server: ModelServer):
        self.server = server
        unary = grpc.unary_unary_rpc_method_handler
        self._methods = {
            f"/{SERVICE}/ServerLive": unary(
                self._server_live, _de, _ser),
            f"/{SERVICE}/ServerReady": unary(
                self._server_ready, _de, _ser),
            f"/{SERVICE}/ModelReady": unary(
                self._model_ready, _de, _ser),
            f"/{SERVICE}/ModelMetadata": unary(
                self._model_metadata, _de, _ser),
            f"/{SERVICE}/ModelInfer": unary(
                self._model_infer, _de, _ser),
        }

    def service(self, handler_call_details):
        return self._methods.get(handler_call_details.method)

    def _server_live(self, request: dict, context) -> dict:
        return {"live": True}

    def _server_ready(self, request: dict, context) -> dict:
        return {"ready": all(m.ready for m in self.server.models().values())}

    def _model_ready(self, request: dict, context) -> dict:
        m = self.server.models().get(request.get("name", ""))
        if m is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"model {request.get('name')!r} not found")
        return {"ready": m.ready}

    def _model_metadata(self, request: dict, context) -> dict:
        m = self.server.models().get(request.get("name", ""))
        if m is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"model {request.get('name')!r} not found")
        return m.metadata()

    def _model_infer(self, request: dict, context) -> dict:
        import time

        name = request.get("model_name", "")
        t0 = time.perf_counter()
        if name not in self.server.models():
            self.server.metrics.observe(name, time.perf_counter() - t0, error=True)
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"model {name!r} not found")
        try:
            instances = ModelServer.v2_to_instances(request)
        except (KeyError, IndexError, TypeError) as e:
            self.server.metrics.observe(name, time.perf_counter() - t0, error=True)
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"malformed V2 request: {e}")
        try:
            # through the SAME micro-batcher as the HTTP path, so gRPC
            # requests coalesce with HTTP ones into full XLA batches
            out = self.server._dispatch(name, instances)
            self.server.metrics.observe(
                name, time.perf_counter() - t0, error=False)
            return ModelServer.v2_response(name, out)
        except KeyError as e:
            # the unregister race: model vanished between check and dispatch
            self.server.metrics.observe(
                name, time.perf_counter() - t0, error=True)
            if str(e).strip("'") == name:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"model {name!r} not found")
            context.abort(grpc.StatusCode.INTERNAL, f"KeyError: {e}")
        except Exception as e:  # noqa: BLE001 — surface as RPC error
            self.server.metrics.observe(
                name, time.perf_counter() - t0, error=True)
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")


class GrpcInferenceServer:
    """V2 gRPC front for a ModelServer (kserve's grpc_port analog)."""

    def __init__(self, model_server: ModelServer,
                 port: Optional[int] = None, max_workers: int = 4):
        self.port = port or allocate_port()
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((_Handler(model_server),))
        bind_insecure(self._server, "127.0.0.1", self.port)

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "GrpcInferenceServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=1.0)


class GrpcInferenceClient:
    """Minimal V2 gRPC client (infer/ready/metadata), JSON payloads."""

    def __init__(self, address: str):
        self._channel = grpc.insecure_channel(address)
        self._calls: dict = {}

    def _call(self, method: str, payload: dict, timeout: float = 30.0) -> dict:
        fn = self._calls.get(method)
        if fn is None:  # one multicallable per method, built once
            fn = self._channel.unary_unary(
                f"/{SERVICE}/{method}", request_serializer=_ser,
                response_deserializer=_de)
            self._calls[method] = fn
        return fn(payload, timeout=timeout)

    def server_live(self) -> bool:
        return bool(self._call("ServerLive", {})["live"])

    def model_ready(self, name: str) -> bool:
        return bool(self._call("ModelReady", {"name": name})["ready"])

    def model_metadata(self, name: str) -> dict:
        return self._call("ModelMetadata", {"name": name})

    def infer(self, model_name: str, data: list, shape: Optional[list] = None,
              timeout: float = 60.0) -> list:
        out = self._call("ModelInfer", {
            "model_name": model_name,
            "inputs": [{
                "name": "input0",
                "shape": shape or [len(data)],
                "datatype": "FP32",
                "data": data,
            }],
        }, timeout=timeout)
        return out["outputs"][0]["data"]

    def close(self) -> None:
        self._channel.close()
