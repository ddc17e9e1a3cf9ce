"""Small networking helpers for the local runtime.

The port's copy of ``kubeflow_tpu/utils/net.py``, device-free like it,
with the same names; it imports nothing of the reference package. It adds
``BurstHTTPServer``, the port's HTTP server class.
"""

from __future__ import annotations

import collections
import socket
import threading
from http.server import ThreadingHTTPServer

_issued_lock = threading.Lock()
#: recently-issued ports, bounded: old entries age out so long-lived control
#: planes with replica churn can't exhaust the ephemeral range
_issued: "collections.deque[int]" = collections.deque(maxlen=2048)


def free_port() -> int:
    """Ask the kernel for an unused TCP port (coordinator rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return s.getsockname()[1]


def allocate_port() -> int:
    """A free port that has not been issued to anyone else in this process.

    Control-plane port allocation (coordinator rendezvous for gangs, gRPC
    services) funnels through here so that concurrent reconciles — e.g. N
    parallel HPO trials submitted in the same tick — can never be handed the
    same port even if the kernel would recycle it between ``free_port`` calls.
    The reservation window is the deque's length, not forever.
    """
    with _issued_lock:
        for _ in range(128):
            p = free_port()
            if p not in _issued:
                _issued.append(p)
                return p
        raise OSError("could not allocate an unissued port after 128 attempts")


class BurstHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog that takes a burst.

    The standard library listens with a backlog of 5: a burst of clients
    connecting at once (a Router fanning out, sixteen completions sent
    together) overflows it, and each dropped SYN is retried by the client's
    kernel a second later. Every HTTP server of the port (model server,
    Router, inference graph, API server, metrics endpoint) uses this class.
    Handler threads are daemons, as each server set before.
    """

    request_queue_size = 1024
    daemon_threads = True
