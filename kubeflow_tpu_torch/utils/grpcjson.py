"""Shared JSON-over-gRPC transport bits.

protoc stubs aren't available in this image (no grpcio-tools), so every
gRPC boundary here (hpo suggestion service, V2 inference service) rides
grpc's generic handler with JSON payloads.  The encoding and the bind
check live in one place so the wire fronts cannot drift.

The port's copy of ``kubeflow_tpu/utils/grpcjson.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import json


def serialize(payload: dict) -> bytes:
    return json.dumps(payload).encode()


def deserialize(data: bytes) -> dict:
    return json.loads(data.decode())


def bind_insecure(server, host: str, port: int) -> None:
    """add_insecure_port with a loud failure: grpc signals a failed bind by
    returning 0, which would otherwise yield a silently dead server."""
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise OSError(f"could not bind gRPC port {host}:{port}")
