"""ChaosSocket: fault-injecting wrapper around a real socket.

The injectable seam :class:`~..serving.gang.GangChannel` exposes
(``sock_wrap=``): every socket the channel creates — leader accepts,
follower dials, follower *re*-dials — passes through the wrapper, so a
:class:`~.plan.FaultPlan` can kill or slow the gang control stream at a
precise point mid-protocol without touching the channel code.

A drop closes the underlying socket and surfaces as ``OSError`` on the
next call — exactly what a yanked cable / OOM-killed peer looks like to
the channel's recovery machinery.

The port's copy of ``kubeflow_tpu/chaos/net.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import socket
import time
from typing import Optional


class ChaosSocket:
    """Wraps a socket; counts sendall/recv calls and injects faults.

    ``drop_after_calls``: total sendall+recv calls before the connection
    dies (None with ``send_delay`` unset means drop immediately).
    ``send_delay``: seconds added to every sendall (slow link).
    """

    def __init__(self, sock: socket.socket,
                 drop_after_calls: Optional[int] = None,
                 send_delay: float = 0.0) -> None:
        self._sock = sock
        self._calls = 0
        self._send_delay = send_delay
        if send_delay and drop_after_calls is None:
            self._drop_after = None  # delay-only wrapper never drops
        else:
            self._drop_after = drop_after_calls or 0
        self._dropped = False

    def _tick(self) -> None:
        if self._drop_after is None:
            return
        self._calls += 1
        if self._calls > self._drop_after and not self._dropped:
            self._dropped = True
            try:
                self._sock.close()
            except OSError:
                pass
        if self._dropped:
            raise OSError("chaos: injected connection drop")

    def sendall(self, data: bytes) -> None:
        if self._send_delay:
            time.sleep(self._send_delay)
        self._tick()
        return self._sock.sendall(data)

    def recv(self, n: int) -> bytes:
        self._tick()
        return self._sock.recv(n)

    def close(self) -> None:
        self._dropped = True
        try:
            self._sock.close()
        except OSError:
            pass

    def __getattr__(self, name):
        # settimeout / setsockopt / getpeername / fileno ... pass through
        return getattr(self._sock, name)
