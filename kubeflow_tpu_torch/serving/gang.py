"""Multi-GPU serving: the predictor as a gang, the port of
``kubeflow_tpu/serving/gang.py``.

One process drives one card, so a tensor-parallel predictor (an engine
with ``mesh_axes={"model": N}``, or ``{"expert": E, "model": N}`` for an
MoE model, ``sharded.py``) is a gang of N (E x N) processes, each one rank
of a ``torch.distributed`` group, on one host as on several:

- every member loads the same snapshot and builds the same engine (the
  knobs byte-identical, ``engine_kwargs``) over its shards of the weights
  (its experts, its ``model`` slice) and ``num_kv_heads / N`` heads of the
  KV pool;
- rank 0 owns the HTTP frontend (``ModelServer``) and the engine's
  scheduler, a :class:`GangEngine`. Its decisions are host numpy arrays:
  the engine's one dispatch chokepoint, ``_Dispatch.run(key, build,
  host)``, publishes ``(key, host)`` over :class:`GangChannel` before rank 0
  runs the program, and a follower (:func:`follow`) rebuilds the program
  from ``key`` and runs it on the same host inputs, so every rank issues
  the same programs and their collectives line up. The device mutations
  outside that chokepoint are published too: the noise of a sampling
  draw (the generator is seeded alike on every rank), the block gathers
  of an export (a collective: a snapshot gathers every head), the block
  scatters of an import or a host-tier restore (the full-head bytes; each
  rank keeps its heads) and a migration's logits row;
- device data never crosses the channel; rank 0 reads its own sampled
  tokens, which are bitwise equal on every rank (the same gathered logits,
  the same noise).

Failure semantics are the reference's: the control stream heals a dropped
socket (heartbeats, a bounded replay log, token-authenticated re-attach);
a follower gone past the re-attach grace, or any failure of rank 0's
dispatch after a publish, marks the engine dead (``GangEngine._fatal``),
``serve_main`` exits non-zero and the JaxJob controller restarts the gang.
A follower blocked in a collective of a dead peer gets an error from the
process group (its timeout is finite, ``bootstrap.DIST_TIMEOUT_S``) and
exits non-zero too, instead of holding the card.

The kv_migrate wire (``migrate_sequence``, ``fetch_kv_prefix``,
``KvMigrationServer``) is framed JSON headers and raw tensor bytes, never
pickle; it carries ``ContinuousEngine.export_sequence`` snapshots, whose
leaves are torch CPU tensors (bf16 included) or the reference's numpy
ones.

Each gang pod owns one card, allocated by the scheduler
(``CUDA_VISIBLE_DEVICES`` from its ``device_ids``), and every rank
computes on its pod's first visible card.

The autoscaler's TP-degree decisions reach a gang through rank 0's
control route (``RESIZE_ROUTE``, guarded by the gang token as the control
stream is): it runs the gang's own ``GangResizer.resize_to_degree``
(``resize.py``), under the lock the ``ElasticGangSupervisor`` takes too,
and the decision caps the supervisor's grow-back. ``post_resize`` is the
controller's side of it.

Chaos testing: every socket the channel creates passes through an
injectable ``sock_wrap`` (``kubeflow_tpu_torch.chaos.FaultPlan.
socket_wrapper``).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import signal
import socket
import struct
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from . import continuous as contlib
from . import programs as programslib
from . import sharded
from ..runtime import bootstrap

log = logging.getLogger("kubeflow_tpu_torch.serving")


#: pod-env key holding the JSON serving config (engine knobs +
#: storage_path + serve_port + gang_port) the ISvc controller freezes at
#: gang-placement time
ENV_SERVE_CONFIG = "KFT_SERVE_CONFIG"
#: rank 0's POST route taking the autoscaler's target TP degree
RESIZE_ROUTE = "/v2/gang/resize"
#: the request header carrying the gang token on ``RESIZE_ROUTE``
TOKEN_HEADER = "X-KFT-Gang-Token"

_LEN = struct.Struct("!Q")


class ChannelClosed(RuntimeError):
    """The control stream died (a peer crashed or shut down)."""


class GangChannel:
    """Rank-0 -> followers control stream: length-prefixed pickles over
    TCP.  Carries ONLY host-side scheduler decisions (op tag + numpy
    args) between mutually-trusting gang members of one job — never
    request payloads to the outside world and never device data.

    Trust boundary: the stream is pickle between processes of ONE JaxJob,
    so admission is guarded by a per-job shared ``token`` (delivered to
    the gang's pods through a side channel — a 0600 token file, the
    Secret-mount analog — NOT the cluster-readable env).  A follower must
    present it before it may occupy a slot; a token-valid connection for
    an already-connected rank REPLACES that rank's connection (reconnect
    semantics) rather than consuming another slot, and rank 0 closes
    anything that fails the handshake.  Deserialization still trusts
    rank 0, which is the same trust a follower already extends to the
    process that chose its dispatch stream.

    Liveness + recovery (module docstring): rank 0 heartbeats every
    ``hb_interval`` and keeps the last ``replay_log`` published frames;
    followers ack their applied sequence.  A follower socket that errors
    or goes silent past ``dead_peer_timeout`` is EVICTED (publishing
    continues into the log); a follower that reconnects within
    ``reattach_timeout`` re-auths, reports its last applied seq and has
    exactly the missed frames replayed.  Past the grace — or off the end
    of the replay log — the channel goes fatal and the JaxJob gang
    restart takes over.

    ``sock_wrap`` wraps every socket the channel creates (chaos
    injection seam, kubeflow_tpu_torch.chaos).
    """

    #: wire frame tags (leader->follower: msg/hb/gone; follower->leader:
    #: hello/ack)
    _MSG, _HB, _GONE, _HELLO, _ACK = "msg", "hb", "gone", "hello", "ack"

    def __init__(self, rank: int, *, token: str = "",
                 hb_interval: float = 0.5, dead_peer_timeout: float = 3.0,
                 reattach_timeout: float = 10.0,
                 reconnect_timeout: float = 10.0, replay_log: int = 1024,
                 sock_wrap=None) -> None:
        self.rank = rank
        self._token = token
        self._hb_interval = hb_interval
        self._dead_peer_timeout = dead_peer_timeout
        self._reattach_timeout = reattach_timeout
        self._reconnect_timeout = reconnect_timeout
        self._sock_wrap = sock_wrap or (lambda s: s)
        self._lock = threading.Lock()
        self._joined = threading.Condition(self._lock)
        self._closing = threading.Event()
        # leader state
        self._srv: Optional[socket.socket] = None
        self._want = 0
        self._followers: dict[int, Any] = {}
        self._last_ack: dict[int, float] = {}
        self._lost: dict[int, float] = {}
        from collections import deque

        self._log: "deque[tuple[int, bytes]]" = deque(maxlen=max(replay_log, 1))
        self._seq = 0
        self._dead: Optional[Exception] = None
        #: ranks admitted with no shared history (elastic fresh joins) —
        #: the supervisor drains this and rebuilds them via a resize
        self._fresh_joins: set[int] = set()
        # follower state
        self._sock: Optional[Any] = None
        self._addr: Optional[tuple[str, int]] = None
        #: highest sequence this follower has returned from next()
        self.last_seq = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def listen(cls, port: int, num_followers: int, token: str = "",
               timeout: float = 60.0, **kw) -> "GangChannel":
        """Rank 0: accept every follower (they dial after the gang
        barrier, so all are alive or the job already failed), then keep
        the listener open for re-attaches.  A connection that fails the
        token handshake is dropped without consuming a follower slot."""
        ch = cls(0, token=token, **kw)
        ch._want = num_followers
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", port))
        srv.listen(max(num_followers, 1))
        srv.settimeout(0.2)
        ch._srv = srv
        threading.Thread(
            target=ch._accept_loop, name="gang-accept", daemon=True).start()
        threading.Thread(
            target=ch._hb_loop, name="gang-hb", daemon=True).start()
        deadline = time.monotonic() + timeout
        with ch._lock:
            while len(ch._followers) < num_followers:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                ch._joined.wait(remaining)
            got = len(ch._followers)
        if got < num_followers:
            ch.close()
            raise TimeoutError(
                f"only {got}/{num_followers} followers "
                "passed the gang handshake")
        return ch

    @classmethod
    def connect(cls, host: str, port: int, rank: int, token: str = "",
                timeout: float = 60.0, fresh: bool = False,
                **kw) -> "GangChannel":
        """``fresh=True`` marks an ELASTIC join: this member
        has no shared dispatch history, so it asks for no replay
        (last_seq = -1) and starts at the stream's current position —
        the grow-back resize rebuilds its pool state from scratch, so
        the missed frames are genuinely irrelevant, not a gap."""
        ch = cls(rank, token=token, **kw)
        if fresh:
            ch.last_seq = -1
        ch._addr = (host, port)
        ch._dial(timeout)
        threading.Thread(
            target=ch._ack_loop, name=f"gang-ack-{rank}", daemon=True).start()
        return ch

    # -- leader: accept / admit / evict / heartbeat ------------------------

    #: handshake frames are JSON (never pickle: they arrive from
    #: UNAUTHENTICATED peers — pre-auth pickle.loads would be arbitrary
    #: code execution) and length-capped before the body is even read
    _HELLO_MAX = 4096

    def _accept_loop(self) -> None:
        import hmac

        while not self._closing.is_set():
            srv = self._srv
            if srv is None:  # close() raced us and nulled the listener
                return
            try:
                raw, _addr = srv.accept()
            except (socket.timeout, TimeoutError):
                continue
            except OSError:
                return
            c = self._sock_wrap(raw)
            try:
                c.settimeout(5.0)
                (n,) = _LEN.unpack(self._read_exact(c, _LEN.size))
                if n > self._HELLO_MAX:
                    raise ChannelClosed("oversized handshake")
                hello = json.loads(self._read_exact(c, n).decode())
                if not isinstance(hello, dict) or hello.get("t") != self._HELLO:
                    raise ChannelClosed("bad handshake")
                if not hmac.compare_digest(
                        str(hello.get("token", "")), self._token):
                    raise ChannelClosed("bad gang token")
                rank = int(hello.get("rank", -1))
                last_seq = int(hello.get("last_seq", 0))
                # _want == 0 means UNCAPPED (the channel's contract: quota
                # is enforced by token + rank-slot replacement, not a
                # bound) — under elastic resize that is also the
                # designed behavior: a shrunk-away member that returns
                # SHOULD be admitted and trigger the grow-back
                if rank < 1 or (self._want and rank > self._want):
                    raise ChannelClosed(f"rank {rank} out of range")
                # bounded sends from here on: a wedged-but-alive follower
                # whose receive buffer fills must stall the leader for at
                # most dead_peer_timeout, not forever (see publish)
                c.settimeout(self._dead_peer_timeout)
                try:
                    c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                self._admit(c, rank, last_seq)
            except (OSError, ChannelClosed, EOFError, struct.error,
                    ValueError):
                try:
                    c.close()
                except OSError:
                    pass

    def _admit(self, c, rank: int, last_seq: int) -> None:
        """Install (or re-install) a follower connection after a valid
        handshake, replaying exactly the frames it missed."""
        with self._lock:
            if last_seq < 0:
                # fresh elastic member: no shared history to
                # replay — it enters at the stream's current position
                # and the grow-back resize rebuilds its state
                self._fresh_joins.add(rank)
            elif last_seq < self._seq:
                oldest = self._log[0][0] if self._log else self._seq + 1
                if last_seq + 1 < oldest:
                    # the gap rolled off the replay log: this follower can
                    # no longer be resynced at the channel layer — tell it
                    # to die so the JaxJob gang restart takes over
                    try:
                        # send bounded by dead_peer_timeout by design
                        # analysis: ok lock-order — bounded send
                        c.sendall(self._frame(
                            (self._GONE, "replay log exhausted")))
                    except OSError:
                        pass
                    try:
                        c.close()
                    except OSError:
                        pass
                    return
                for s, fb in list(self._log):
                    if s > last_seq:
                        # analysis: ok lock-order — bounded by dead_peer_timeout
                        c.sendall(fb)  # OSError -> caller drops the conn
            old = self._followers.pop(rank, None)
            self._followers[rank] = c
            self._lost.pop(rank, None)
            self._last_ack[rank] = time.monotonic()
            self._joined.notify_all()
        if old is not None:
            # an extra token-valid connection REPLACES its rank's slot
            try:
                old.close()
            except OSError:
                pass
        threading.Thread(
            target=self._ack_reader, args=(rank, c),
            name=f"gang-ackr-{rank}", daemon=True).start()

    def _ack_reader(self, rank: int, c) -> None:
        """Per-follower reader: acks refresh liveness; EOF/error evicts.
        A recv timeout alone is NOT an eviction — the socket carries
        dead_peer_timeout so leader SENDS stay bounded, and ack staleness
        is judged by _hb_loop against _last_ack."""
        while not self._closing.is_set():
            try:
                frame = self._recv_frame(c)
            except (socket.timeout, TimeoutError):
                continue
            except (ChannelClosed, OSError, EOFError, struct.error,
                    pickle.UnpicklingError):
                self._evict(rank, c)
                return
            if (isinstance(frame, tuple) and len(frame) == 3
                    and frame[0] == self._ACK):
                with self._lock:
                    if self._followers.get(rank) is c:
                        self._last_ack[rank] = time.monotonic()

    def _evict(self, rank: int, c=None) -> None:
        with self._lock:
            self._evict_locked(rank, c)

    def _evict_locked(self, rank: int, c=None) -> None:
        cur = self._followers.get(rank)
        if cur is None or (c is not None and cur is not c):
            return
        del self._followers[rank]
        self._last_ack.pop(rank, None)
        self._lost[rank] = time.monotonic()
        try:
            cur.close()
        except OSError:
            pass

    def _hb_loop(self) -> None:
        """Leader liveness pump: heartbeat every interval (so an idle
        stream still proves rank 0 alive), evict silent followers, and go
        fatal when an evicted rank overstays the re-attach grace."""
        while not self._closing.wait(self._hb_interval):
            now = time.monotonic()
            with self._lock:
                frame = self._frame((self._HB, self._seq))
                for rank, c in list(self._followers.items()):
                    if now - self._last_ack.get(rank, now) > self._dead_peer_timeout:
                        self._evict_locked(rank)
                        continue
                    try:
                        # analysis: ok lock-order — bounded by dead_peer_timeout
                        c.sendall(frame)
                    except OSError:
                        self._evict_locked(rank)
                if self._dead is None:
                    for rank, t in self._lost.items():
                        if now - t > self._reattach_timeout:
                            self._dead = ChannelClosed(
                                f"follower rank {rank} gone for "
                                f"{self._reattach_timeout:.1f}s; "
                                "gang must restart")
                            break

    @property
    def missing_ranks(self) -> list[int]:
        """Evicted followers awaiting re-attach (leader side)."""
        with self._lock:
            return sorted(self._lost)

    def lost_since(self) -> dict[int, float]:
        """Evicted rank -> monotonic eviction time (leader side): the
        elastic supervisor's escalation input."""
        with self._lock:
            return dict(self._lost)

    def follower_ranks(self) -> list[int]:
        """Currently connected follower ranks (leader side)."""
        with self._lock:
            return sorted(self._followers)

    def set_want(self, n: int) -> None:
        """Adjust the handshake ADMISSION CAP (the max rank a hello may
        carry): an elastic grow raises it so new ranks can join; 0
        removes the cap entirely (the channel's contract — admission is then
        guarded by the token alone, and a returning member can always
        rejoin and grow the gang back).  It is a bound, not a member
        count — a shrink must NOT lower it below surviving ranks, or
        they would be refused at their next reconnect (rank ids are
        stable)."""
        with self._lock:
            self._want = max(int(n), 0)

    def forget_rank(self, rank: int) -> None:
        """Drop an evicted rank from the re-attach ledger (the elastic
        shrink path): its absence becomes a PLANNED degree
        change instead of a ticking fatality — the hb loop stops
        counting it toward ``reattach_timeout``."""
        with self._lock:
            self._lost.pop(rank, None)

    def touch_lost(self, ranks) -> None:
        """Restart the re-attach fatality clock for evicted ranks: the
        elastic supervisor touches them when it COMMITS to a shrink, so
        a rebuild that outlives the remaining grace (weight reshard +
        new-degree warmup) cannot kill the gang mid-resize.  The
        supervisor bounds its touches (max attempts), so the
        JaxJob-restart backstop stays reachable when resizes keep
        failing."""
        with self._lock:
            now = time.monotonic()
            for r in ranks:
                if r in self._lost:
                    self._lost[r] = now

    def take_fresh_joins(self) -> list[int]:
        """Drain the fresh-join ledger (leader side): ranks admitted
        with no shared dispatch history since the last call.  A fresh
        member SKIPS ops until a resize rebuilds its pool, so the
        elastic supervisor must answer every entry here with a resize —
        even a same-degree one (resync-by-rebuild for a member that
        died and returned inside the resize deadline)."""
        with self._lock:
            out = sorted(self._fresh_joins)
            self._fresh_joins.clear()
            return out

    # -- follower: dial / reconnect / ack ----------------------------------

    def _dial(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        delay = 0.05
        while True:
            try:
                raw = socket.create_connection(self._addr, timeout=5.0)
                c = self._sock_wrap(raw)
                try:
                    c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                hello = json.dumps({
                    "t": self._HELLO, "token": self._token,
                    "rank": self.rank, "last_seq": self.last_seq,
                }).encode()
                c.sendall(_LEN.pack(len(hello)) + hello)
                c.settimeout(self._dead_peer_timeout)
                with self._lock:
                    old, self._sock = self._sock, c
                if old is not None:
                    try:
                        old.close()
                    except OSError:
                        pass
                return
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 1.0)

    def _reconnect(self) -> None:
        with self._lock:
            old, self._sock = self._sock, None
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        try:
            self._dial(self._reconnect_timeout)
        except OSError as e:
            raise ChannelClosed(
                f"rank 0 unreachable after {self._reconnect_timeout:.1f}s "
                f"of reconnect attempts: {e}") from e

    def _ack_loop(self) -> None:
        while not self._closing.wait(self._hb_interval):
            with self._lock:
                c = self._sock
            if c is None:
                continue
            try:
                c.sendall(self._frame((self._ACK, self.rank, self.last_seq)))
            except OSError:
                pass  # next() notices the dead socket and reconnects

    # -- wire --------------------------------------------------------------

    def publish(self, msg: tuple) -> None:
        """Leader: sequence, log, and fan out one control frame.  A send
        failure evicts that follower (the frame is in the replay log for
        its re-attach); the call only raises once a follower has
        overstayed the re-attach grace — the point where the gang can no
        longer heal at this layer."""
        with self._lock:
            if self._dead is not None:
                raise self._dead
            self._seq += 1
            frame = self._frame((self._MSG, self._seq, msg))
            self._log.append((self._seq, frame))
            for rank, c in list(self._followers.items()):
                try:
                    # bounded sends: the conn carries dead_peer_timeout,
                    # a wedged follower stalls publish at most that long
                    # analysis: ok lock-order — bounded send, then evict
                    c.sendall(frame)
                except OSError:
                    self._evict_locked(rank)

    def next(self) -> tuple:
        """Follower: the next control message, transparently surviving
        socket drops (reconnect + leader-side replay) and filtering
        liveness frames."""
        while True:
            with self._lock:
                c = self._sock
            if c is None:
                self._reconnect()
                continue
            try:
                frame = self._recv_frame(c)
            except (socket.timeout, TimeoutError):
                # no data and no heartbeat for dead_peer_timeout: the
                # leader is silent — treat as a dead link and re-dial
                self._reconnect()
                continue
            except (ChannelClosed, OSError, EOFError, struct.error,
                    pickle.UnpicklingError):
                if self._closing.is_set():
                    raise ChannelClosed("channel closed")
                self._reconnect()
                continue
            tag = frame[0] if isinstance(frame, tuple) and frame else None
            if tag == self._HB:
                continue
            if tag == self._MSG:
                _, seq, payload = frame
                if seq <= self.last_seq:
                    continue  # replay overlap after a reconnect race
                self.last_seq = seq
                return payload
            if tag == self._GONE:
                raise ChannelClosed(f"rank 0 rejected re-attach: {frame[1]}")
            raise ChannelClosed(f"unknown control frame {tag!r}")

    @classmethod
    def _frame(cls, obj) -> bytes:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        return _LEN.pack(len(payload)) + payload

    @classmethod
    def _recv_frame(cls, c):
        (n,) = _LEN.unpack(cls._read_exact(c, _LEN.size))
        return pickle.loads(cls._read_exact(c, n))

    @staticmethod
    def _read_exact(c, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = c.recv(n - len(buf))
            if not chunk:
                raise ChannelClosed("peer closed the control stream")
            buf += chunk
        return buf

    def close(self) -> None:
        self._closing.set()
        with self._lock:
            socks = list(self._followers.values())
            self._followers.clear()
            if self._sock is not None:
                socks.append(self._sock)
                self._sock = None
            srv, self._srv = self._srv, None
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        if srv is not None:
            try:
                srv.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# kv_migrate: live paged-KV migration between engines
# ---------------------------------------------------------------------------
#
# The transfer stream reuses GangChannel's trust shape — a per-deployment
# shared token, a length-capped JSON handshake (never pre-auth pickle) —
# but NOT its pickle body: every kv_migrate frame is a length-framed
# JSON header plus RAW numpy bytes, so the analyzer's unsafe-pickle
# allowlist stays exactly one entry.  Protocol (client = the SOURCE
# engine's migration worker, server = the DESTINATION):
#
#   client -> kv_hello {token, mid}          server -> kv_ready
#   client -> kv_begin {meta, leaf specs}    (no allocation yet)
#   client -> kv_block {i} + leaf bytes      (buffered host-side)
#   client -> kv_logits + row bytes
#   client -> kv_commit                      server imports, -> kv_ack
#
# The destination allocates blocks ONLY at kv_commit (inside
# import_sequence), so a socket death mid-stream leaks nothing on either
# side — the source still holds the sequence (copy-then-cutover) and the
# buffered frames are garbage-collected host memory.

#: per-frame hard caps: a kv_migrate peer is authenticated, but a
#: corrupted length prefix must cost a closed connection, not an OOM
KV_HELLO_MAX = 4096
KV_HEADER_MAX = 1 << 20
KV_FRAME_MAX = 1 << 30

_HDR = struct.Struct("!I")

#: migration-id registry: the front server keeps the REQUEST HANDLE when
#: a sequence moves between co-hosted replicas — the source registers
#: the handle under a fresh mid, the destination's KvMigrationServer
#: resolves it, and the SSE stream keeps reading the same object (slot
#: re-targeting, no client reconnect).  Cross-process imports simply
#: never resolve and build a fresh Request from the snapshot.
_MIGRATION_HANDLES: dict[str, Any] = {}
_MIGRATION_LOCK = threading.Lock()


def register_migration_handle(req) -> str:
    import uuid

    mid = uuid.uuid4().hex
    with _MIGRATION_LOCK:
        _MIGRATION_HANDLES[mid] = req
    return mid


def resolve_migration_handle(mid: str):
    with _MIGRATION_LOCK:
        return _MIGRATION_HANDLES.pop(mid, None)


def unregister_migration_handle(mid: str) -> bool:
    """Withdraw a handle after a failed transfer.  True = the handle was
    still pending, so the destination never reached kv_commit and the
    source may resume immediately.  False = the destination consumed it
    (commit arrived; only the ACK was lost) — the classic two-generals
    tail of copy-then-cutover.  The orchestrator then polls destination
    ownership instead of resuming blind: resuming while the destination
    installs the same request handle would DOUBLE-decode it (duplicate
    client tokens), the one corruption the cutover discipline exists to
    prevent."""
    with _MIGRATION_LOCK:
        return _MIGRATION_HANDLES.pop(mid, None) is not None


def _dtype_name(x) -> str:
    """A leaf's dtype on the wire: the numpy name, which the reference
    writes too ("bfloat16" for bf16, which numpy itself lacks)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _leaf_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().reshape(-1)
        return x.view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _leaf_from_bytes(payload, name: str, shape) -> torch.Tensor:
    """A torch CPU tensor of ``shape`` from raw bytes (any dtype torch
    names, bf16 included)."""
    dt = getattr(torch, name)
    n = int(np.prod(shape, dtype=np.int64))
    if n == 0:
        return torch.empty(tuple(shape), dtype=dt)
    return torch.frombuffer(bytearray(payload), dtype=dt).reshape(
        tuple(shape))


def _leaf_nbytes(spec: dict) -> int:
    return (int(np.prod(spec["shape"], dtype=np.int64))
            * torch.empty(0, dtype=getattr(torch, spec["dtype"]))
            .element_size())


def _kv_send(c, header: dict, payload: bytes = b"") -> None:
    hb = json.dumps(header).encode()
    c.sendall(_LEN.pack(_HDR.size + len(hb) + len(payload))
              + _HDR.pack(len(hb)) + hb + payload)


def _kv_recv(c, max_len: int = KV_FRAME_MAX) -> tuple[dict, bytes]:
    (n,) = _LEN.unpack(GangChannel._read_exact(c, _LEN.size))
    if n < _HDR.size or n > max_len:
        raise ChannelClosed(f"kv_migrate frame length {n} out of range")
    (hn,) = _HDR.unpack(GangChannel._read_exact(c, _HDR.size))
    if hn > min(n - _HDR.size, KV_HEADER_MAX):
        raise ChannelClosed(f"kv_migrate header length {hn} out of range")
    header = json.loads(GangChannel._read_exact(c, hn).decode())
    payload = GangChannel._read_exact(c, n - _HDR.size - hn)
    if not isinstance(header, dict):
        raise ChannelClosed("kv_migrate header is not an object")
    return header, payload


def _specs_of(leaves) -> list[dict]:
    return [{"dtype": _dtype_name(x), "shape": list(x.shape)}
            for x in leaves]


def _leaf_specs(snapshot: dict) -> list[dict]:
    if not snapshot.get("blocks"):
        return []
    return _specs_of(snapshot["blocks"][0])


def _pack_leaves(leaves) -> bytes:
    return b"".join(_leaf_bytes(x) for x in leaves)


def _unpack_leaves(payload: bytes, specs: list[dict]) -> list:
    out, off = [], 0
    for s in specs:
        n = _leaf_nbytes(s)
        out.append(_leaf_from_bytes(payload[off:off + n], s["dtype"],
                                    s["shape"]))
        off += n
    if off != len(payload):
        raise ChannelClosed(
            f"kv_block payload {len(payload)}B != leaf specs {off}B")
    return out


def migrate_sequence(snapshot: dict, host: str, port: int, *,
                     token: str = "", mid: Optional[str] = None,
                     timeout: float = 30.0,
                     sock_wrap=None) -> Optional[bool]:
    """Source side of a kv_migrate transfer: stream one exported
    snapshot (``ContinuousEngine.export_sequence``) to a destination
    :class:`KvMigrationServer`.  Tri-state result, because the
    cutover decision needs to distinguish how a transfer ended:

    - ``True``  — the destination acked the commit: CUTOVER (release).
    - ``False`` — DEFINITIVELY not installed: the failure happened
      before ``kv_commit`` went out, or the destination answered an
      explicit rejection ack — the source may resume immediately.
    - ``None``  — INDETERMINATE: the socket died after ``kv_commit``
      was sent (the two-generals tail) — the destination may or may
      not install; the orchestrator must consult the migration-handle
      registry / destination ownership before resuming, or it risks
      double-decoding the request.

    Runs on a migration worker thread, never an engine scheduler (the
    analyzer's blocking-socket rule)."""
    meta = {k: v for k, v in snapshot.items()
            if k not in ("blocks", "logits", "blocks_dev", "logits_dev")}
    blocks = snapshot.get("blocks", [])
    logits = snapshot.get("logits")
    try:
        raw = socket.create_connection((host, port), timeout=timeout)
    except OSError:
        return False
    c = (sock_wrap or (lambda s: s))(raw)
    committed = False
    try:
        try:
            c.settimeout(timeout)
        except OSError:
            pass
        # the trace context rides the handshake header too:
        # a destination can correlate even a transfer that dies before
        # kv_begin with the source's request trace
        _kv_send(c, {"t": "kv_hello", "token": token, "mid": mid,
                     "trace": snapshot.get("trace")})
        ready, _ = _kv_recv(c, KV_HELLO_MAX)
        if ready.get("t") != "kv_ready":
            return False
        _kv_send(c, {"t": "kv_begin", "meta": meta,
                     "nblocks": len(blocks),
                     "leaves": _leaf_specs(snapshot),
                     "logits": (None if logits is None else
                                _specs_of([logits])[0])})
        for i, blk in enumerate(blocks):
            _kv_send(c, {"t": "kv_block", "i": i}, _pack_leaves(blk))
        if logits is not None:
            _kv_send(c, {"t": "kv_logits"}, _pack_leaves([logits]))
        _kv_send(c, {"t": "kv_commit"})
        committed = True
        ack, _ = _kv_recv(c, KV_HELLO_MAX)
        if ack.get("t") == "kv_ack":
            return bool(ack.get("ok"))  # explicit reject = definitive
        return None
    except (OSError, ChannelClosed, ValueError, struct.error):
        return None if committed else False
    finally:
        try:
            c.close()
        except OSError:
            pass


def fetch_kv_prefix(host: str, port: int, tokens, *, token: str = "",
                    timeout: float = 30.0,
                    sock_wrap=None) -> tuple[list, list]:
    """Cluster prefix fetch: ask a peer replica's
    :class:`KvMigrationServer` for its longest block-registered prefix
    of ``tokens`` — live slots or the free-list-as-cache registry.
    Returns ``(covered_tokens, host block leaf-lists)``; ``([], [])``
    on any miss or failure (the caller just prefills — a registry
    fetch is an optimization, never a correctness dependency).

    The cold side installs the result with
    ``engine.install_prefix(covered, blocks)`` so the next same-prefix
    admission shares it: prefill-once-per-cluster, the vLLM free-list
    economy lifted to fleet scope.  Same trust shape as kv_migrate
    (token hmac, length-framed JSON + raw numpy, never pickle); runs on
    router/worker threads, never an engine scheduler."""
    try:
        raw = socket.create_connection((host, port), timeout=timeout)
    except OSError:
        return [], []
    c = (sock_wrap or (lambda s: s))(raw)
    try:
        try:
            c.settimeout(timeout)
        except OSError:
            pass
        _kv_send(c, {"t": "kv_hello", "token": token, "mid": None})
        ready, _ = _kv_recv(c, KV_HELLO_MAX)
        if ready.get("t") != "kv_ready":
            return [], []
        _kv_send(c, {"t": "kv_fetch",
                     "tokens": [int(t) for t in tokens]})
        head, _ = _kv_recv(c)
        if head.get("t") != "kv_prefix":
            return [], []
        specs = list(head.get("leaves") or [])
        nblocks = int(head.get("nblocks", 0))
        covered = int(head.get("covered", 0))
        blocks = []
        for _i in range(nblocks):
            hdr, payload = _kv_recv(c)
            if hdr.get("t") != "kv_block":
                return [], []
            blocks.append(_unpack_leaves(payload, specs))
        return [int(t) for t in tokens][:covered], blocks
    except (OSError, ChannelClosed, ValueError, struct.error):
        return [], []
    finally:
        try:
            c.close()
        except OSError:
            pass


class KvMigrationServer:
    """Destination side of the kv_migrate message family: authenticated
    acceptor that assembles streamed snapshots and installs them through
    ``engine.import_sequence`` at commit time.

    One thread per transfer connection; the engine's scheduler is only
    touched through its migration mailbox (import runs between decode
    dispatches).  ``resolve_request`` maps a migration id to a live
    Request handle (co-hosted replica handoff — the front server keeps
    streaming the same object); default = the module registry."""

    def __init__(self, engine, port: Optional[int] = None,
                 token: str = "", sock_wrap=None, resolve_request=None,
                 host: str = "127.0.0.1"):
        from ..utils.net import allocate_port

        self.engine = engine
        self.port = port or allocate_port()
        self._token = token
        self._sock_wrap = sock_wrap or (lambda s: s)
        self._resolve = resolve_request or resolve_migration_handle
        self._closing = threading.Event()
        self.imports_total = 0
        self.rejects_total = 0
        self.prefix_serves_total = 0
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # loopback by DEFAULT: a cross-host deployment opts into
        # host="0.0.0.0" explicitly AND must set a non-empty token —
        # an empty-token listener on all interfaces would let any
        # network peer allocate real KV blocks (the gang-token rule)
        if host != "127.0.0.1" and not token:
            raise ValueError(
                "a non-loopback KvMigrationServer requires a token")
        srv.bind((host, self.port))
        srv.listen(8)
        srv.settimeout(0.2)
        self._srv = srv
        threading.Thread(target=self._accept_loop, name="kv-migrate-srv",
                         daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            srv = self._srv
            if srv is None:
                return
            try:
                raw, _addr = srv.accept()
            except (socket.timeout, TimeoutError):
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve_one, args=(self._sock_wrap(raw),),
                name="kv-migrate-conn", daemon=True).start()

    def _serve_one(self, c) -> None:
        import hmac

        try:
            c.settimeout(30.0)
            hello, _ = _kv_recv(c, KV_HELLO_MAX)
            if hello.get("t") != "kv_hello" or not hmac.compare_digest(
                    str(hello.get("token", "")), self._token):
                raise ChannelClosed("bad kv_migrate handshake")
            mid = hello.get("mid")
            if hello.get("trace"):
                # correlation for operators tailing both sides of a
                # migration: the hello's trace id matches the source
                # request's /traces row
                log.debug("kv_migrate transfer for trace %s",
                          (hello["trace"] or {}).get("id"))
            _kv_send(c, {"t": "kv_ready"})
            meta: Optional[dict] = None
            specs: list[dict] = []
            nblocks = 0
            logits_spec = None
            blocks: list[list[np.ndarray]] = []
            logits = None
            while True:
                header, payload = _kv_recv(c)
                t = header.get("t")
                if t == "kv_begin":
                    meta = dict(header.get("meta") or {})
                    specs = list(header.get("leaves") or [])
                    nblocks = int(header.get("nblocks", 0))
                    logits_spec = header.get("logits")
                elif t == "kv_block":
                    if meta is None or len(blocks) >= nblocks:
                        raise ChannelClosed("kv_block outside transfer")
                    blocks.append(_unpack_leaves(payload, specs))
                elif t == "kv_logits":
                    if meta is None or logits_spec is None:
                        raise ChannelClosed("unexpected kv_logits")
                    logits = _unpack_leaves(payload, [logits_spec])[0]
                elif t == "kv_fetch":
                    # cluster prefix fetch: serve the
                    # longest block-registered prefix of the peer's
                    # tokens — the engine dispatches gathers on its
                    # scheduler, the fetch materializes HERE on this
                    # connection thread, then streams kv_block frames
                    toks = [int(x) for x in (header.get("tokens") or [])]
                    try:
                        covered, pblocks = \
                            self.engine.export_prefix_blocks(toks)
                    except (RuntimeError, TimeoutError):
                        # stopping/wedged engine: a registry fetch is
                        # an optimization — answer "nothing" instead of
                        # killing the connection thread
                        covered, pblocks = [], []
                    _kv_send(c, {
                        "t": "kv_prefix", "covered": len(covered),
                        "nblocks": len(pblocks),
                        "leaves": (_specs_of(pblocks[0])
                                   if pblocks else [])})
                    for i, blk in enumerate(pblocks):
                        _kv_send(c, {"t": "kv_block", "i": i},
                                 _pack_leaves(blk))
                    self.prefix_serves_total += 1
                elif t == "kv_commit":
                    break
                else:
                    raise ChannelClosed(f"unknown kv_migrate frame {t!r}")
            if meta is None or len(blocks) != nblocks:
                raise ChannelClosed(
                    f"kv_commit with {len(blocks)}/{nblocks} blocks")
            snapshot = dict(meta)
            snapshot["blocks"] = blocks
            if logits is not None:
                snapshot["logits"] = logits
            req = self._resolve(mid) if mid else None
            try:
                self.engine.import_sequence(snapshot, req=req)
                self.imports_total += 1
                _kv_send(c, {"t": "kv_ack", "ok": True})
            except Exception as e:  # noqa: BLE001 — rejection (pool
                # exhausted, mismatched config) is a protocol answer,
                # not a server death: the source resumes in place
                self.rejects_total += 1
                _kv_send(c, {"t": "kv_ack", "ok": False,
                             "error": f"{type(e).__name__}: {e}"[:500]})
        except (OSError, ChannelClosed, ValueError, struct.error,
                EOFError) as e:
            log.debug("kv_migrate transfer aborted: %s", e)
        finally:
            try:
                c.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closing.set()
        srv, self._srv = self._srv, None
        if srv is not None:
            try:
                srv.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# the gang engine and its followers
# ---------------------------------------------------------------------------


class GangEngine(contlib.ContinuousEngine):
    """Rank 0's engine: a tensor-parallel ``ContinuousEngine`` that
    publishes every device step before it runs it, so the followers
    (:func:`follow`) issue the same steps on their shards.

    The scheduler, admission, chunking, speculation, prefix reuse and
    warmup run unmodified; the publishes sit at the engine's few device
    seams: ``_Dispatch.run`` (``("run", key, host)``), the sampling noise
    (``("noise",)``, after ``("seed", s)`` at construction seeds every
    rank's generator alike), the block export (``("export", ids)``), the
    block import (``("import", ids, leaves)``) and a migration's logits
    row (``("logits", row, slot)``). Any failure of a publish, or of rank
    0's own step after one, marks the engine dead (``_fatal``)."""

    def __init__(self, cfg, params, *, channel: GangChannel, **kw) -> None:
        if sharded.degree_of(kw.get("mesh_axes")) < 2:
            raise ValueError("a serving gang needs mesh_axes of degree > 1")
        self._channel = channel
        #: an elastic resize (``resize.py``) replaces this engine but keeps
        #: the channel and the follower processes for the successor: the
        #: resizer sets this before ``stop()``
        self.keep_channel_open = False
        super().__init__(cfg, params, **kw)
        seed = int.from_bytes(os.urandom(4), "little")
        self.publish(("seed", seed))
        self._gen.manual_seed(seed)
        self._dispatch.publish = (
            lambda key, host: self.publish(("run", key, host)))
        inner = self._dispatch.run

        def run(key, build, host):
            try:
                return inner(key, build, host)
            except Exception as e:  # noqa: BLE001 — see _fatal
                raise self._fatal(e)

        self._dispatch.run = run

    def publish(self, msg: tuple) -> None:
        try:
            self._channel.publish(msg)
        except Exception as e:  # noqa: BLE001 — see _fatal
            raise self._fatal(e)

    def _fatal(self, e: Exception) -> Exception:
        """A failed publish, or a failure of rank 0's step after a
        successful publish, means the ranks' pools can no longer be
        trusted to agree (a follower may have applied a step rank 0
        skipped). Mark the engine dead, so per-request error handling
        cannot paper over it: ``serve_main``'s watchdog exits non-zero and
        the JaxJob controller restarts the gang. Lock-free, as in the
        reference (warmup holds the gate while it dispatches)."""
        if self._error is None:
            self._error = e
        return e

    def _draw_noise(self) -> None:
        if bool((self._temps[self._active] > 0).any()):
            self.publish(("noise",))
        super()._draw_noise()

    def _export_blocks(self, ids: list[int]) -> list[torch.Tensor]:
        self.publish(("export", [int(i) for i in ids]))
        try:
            return super()._export_blocks(ids)
        except Exception as e:  # noqa: BLE001 — see _fatal
            raise self._fatal(e)

    def _import_blocks(self, ids: list[int], leaves: list) -> None:
        self.publish(("import", [int(i) for i in ids],
                      [x.cpu() for x in leaves]))
        super()._import_blocks(ids, leaves)

    def _install_logits(self, row: torch.Tensor, slot: int) -> None:
        self.publish(("logits", row.cpu(), int(slot)))
        super()._install_logits(row, slot)

    def stop(self) -> None:
        super().stop()
        if self.keep_channel_open:
            return
        try:
            self._channel.publish(("stop",))
        except ChannelClosed:
            pass
        self._channel.close()


def follow(engine: Optional[contlib.ContinuousEngine], channel: GangChannel,
           fresh: bool = False, on_engine=None) -> None:
    """Follower executor: replay rank 0's stream on this rank's engine.

    ``engine`` is a ``ContinuousEngine`` built from the same config; its
    scheduler never starts (followers never submit), only its programs
    and pool are used. Returns on ``stop``; raises :class:`ChannelClosed`
    when rank 0 dies, which fails this pod and restarts the gang.

    A resize (``resize.py``) hands this rank a new engine at the new
    degree, or parks it (``None``: a rank the new degree leaves out skips
    every step until a resize takes it back); the previous engine is kept
    until ``resize_commit``, and ``resize_abort`` returns to it. A
    ``fresh`` joiner (no shared history) skips every step until its first
    resize."""
    prev: Optional[tuple] = None
    skipping = fresh
    device = None if engine is None else engine.device
    #: the program-artifact cache, carried over a parked stretch too
    cache = getattr(engine, "program_cache", None)
    while True:
        msg = channel.next()
        op = msg[0]
        if op == "stop":
            return
        if op == "resize":
            from .resize import follower_resize

            prev = (engine, skipping)
            engine = follower_resize(engine, channel, msg[1], device,
                                     program_cache=cache)
            skipping = engine is None
            if engine is not None:
                device = engine.device
            if on_engine is not None:
                on_engine(engine)
            continue
        if op == "resize_abort":
            if prev is not None:
                from .resize import follower_abort

                failed = engine
                engine, skipping = prev
                prev = None
                follower_abort(failed, engine, channel, msg[1])
                if on_engine is not None:
                    on_engine(engine)
            continue
        if op == "resize_commit":
            # the leader cut over: the previous engine (weights and pool)
            # is freed now instead of at the next resize
            if prev is not None and prev[0] not in (None, engine):
                prev[0].stop()
            prev = None
            continue
        if skipping:
            continue
        with engine._dispatch.stream_ctx():
            if op == "run":
                _, key, host = msg
                engine.replay(key, host)
            elif op == "seed":
                engine._gen.manual_seed(int(msg[1]))
            elif op == "noise":
                torch.rand(engine._noise.shape, generator=engine._gen,
                           device=engine.device, out=engine._noise)
            elif op == "export":
                # the head gather is a collective: join it, keep nothing
                engine._export_blocks(msg[1])
            elif op == "import":
                _, ids, leaves = msg
                engine._import_blocks(ids, leaves)
            elif op == "logits":
                _, row, slot = msg
                engine._install_logits(row, slot)
            elif op == "params":
                # a resize gathers the weights whole: join the gather
                from .resize import full_params

                full_params(engine)
            else:
                raise RuntimeError(f"unknown gang op {op!r}")


# ---------------------------------------------------------------------------
# the gang's entry point (what the ISvc controller's JaxJob runs in every pod)
# ---------------------------------------------------------------------------


def _resolve_gang_token(conf: dict) -> str:
    """The gang token arrives over a side channel, ``gang_token_file`` (a
    0600 file the ISvc controller writes, the Secret-mount analog), not
    the JaxJob env, which is cluster-readable. Inline ``gang_token`` is
    kept for hand-rolled and test configs."""
    path = conf.get("gang_token_file")
    if path:
        # a missing file must fail the pod loudly: an empty token would
        # silently open the gang
        with open(path) as f:
            return f.read().strip()
    return str(conf.get("gang_token", ""))


def resize_route(resizer, channel: GangChannel, token: str,
                 supervisor=None):
    """The handler of ``RESIZE_ROUTE`` on rank 0's ``ModelServer``:
    ``{"degree": d}`` resizes the live gang to TP degree ``d`` through its
    own ``resizer`` (``GangResizer.resize_to_degree``) and answers
    ``{"from": old, "degree": new, "resized": bool}``. Refused: a wrong
    token (403), a degree below 1 (400), a target above the gang's live
    members, an engine without the paged pool, and a resize that aborted
    with the old degree resumed in place (409). The target caps the
    ``supervisor``'s grow-back, so a membership tick does not undo it."""
    import hmac

    from .resize import ResizeAborted

    def handle(payload: dict, headers) -> tuple[int, dict]:
        if not hmac.compare_digest(
                str(headers.get(TOKEN_HEADER) or "").encode(),
                token.encode()):
            return 403, {"error": "bad gang token"}
        try:
            d = int(payload["degree"])
        except (KeyError, TypeError, ValueError):
            return 400, {"error": "want {\"degree\": n}"}
        if d < 1:
            return 400, {"error": f"target TP degree must be >= 1, got {d}"}
        if resizer is None:
            return 409, {"error": "resize requires the paged pool "
                                  "(block_size > 0)"}
        live = 1 + len(channel.follower_ranks())
        if d > live:
            return 409, {"error": f"target TP degree {d} is above the "
                                  f"gang's {live} live members"}
        old = resizer.degree()
        if supervisor is not None:
            supervisor.max_degree = d
        try:
            resizer.resize_to_degree(d)
        except ResizeAborted as e:
            return 409, {"error": f"resize to {d} aborted, degree {old} "
                                  f"resumed in place: {e}"}
        except ValueError as e:
            # refused before anything moved (an 'expert' axis)
            return 409, {"error": str(e)}
        new = resizer.degree()
        return 200, {"from": old, "degree": new,
                     "resized": new == d and old != d}

    return handle


def post_resize(url: str, degree: int, token: str,
                timeout: float = 600.0) -> dict:
    """POST the autoscaler's target TP ``degree`` to the gang whose rank 0
    serves ``url``; returns its answer (``resize_route``), raises
    ``RuntimeError`` carrying its error when it refuses."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + RESIZE_ROUTE, data=json.dumps({"degree": int(degree)}).encode(),
        headers={"Content-Type": "application/json", TOKEN_HEADER: token})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            why = json.loads(e.read()).get("error", "")
        except ValueError:
            why = ""
        raise RuntimeError(
            f"gang resize to TP degree {degree} refused ({e.code}): "
            f"{why}") from None


def serve_main(ctx: bootstrap.PodContext) -> None:
    """Entry point of every member of a serving gang (through
    ``runtime/pod_main``: the process group is initialized and the gang
    barrier passed when this runs). One rank per pod, on the pod's own
    card (the first its ``CUDA_VISIBLE_DEVICES`` names; ``KFT_POD_DEVICE``
    overrides it, the CPU with ``"cpu"``). Rank 0 serves ``RESIZE_ROUTE``
    when its engine is paged.

    Config (``KFT_SERVE_CONFIG`` JSON): engine knobs per ``engine_kwargs``
    plus ``mesh_axes`` (``{"model": N}``, or ``{"expert": E, "model":
    N}`` for an MoE model; their product the gang's size),
    ``storage_path`` or ``params_ref`` (every member loads the same
    weights), ``serve_port`` (rank 0's HTTP frontend, stable across gang
    restarts) and ``gang_port`` (the control stream). ``elastic`` adds the
    shrink-to-survive and grow-back supervisor (``resize.py``)."""
    conf = json.loads(os.environ[ENV_SERVE_CONFIG])
    if conf.get("short_pool_len") or conf.get("tier_lens"):
        raise ValueError(
            "tiered pools (short_pool_len / tier_lens) are not "
            "gang-capable: the control stream drives ONE engine's "
            "dispatch order")
    cfg, params = contlib.resolve_model_source(
        conf, name=conf.get("model_name", "model"))
    cfg, params = contlib.apply_serving_quant(cfg, params, conf)
    kw = contlib.engine_kwargs(conf, default_eos=conf.get("eos_id"))
    kw["seq_buckets"] = conf.get("seq_buckets")
    # AOT artifact cache: EVERY rank consults the same root (the config
    # is identical gang-wide), so each rank's records and libraries are
    # the leader's — the publish rename is atomic, concurrent ranks race
    # safely and the losers verify the winner's entry
    kw["program_cache"] = programslib.build_program_cache(conf)
    kw["device"] = bootstrap.pod_device(ctx)
    gang_port = int(conf["gang_port"])
    token = _resolve_gang_token(conf)
    elastic = conf.get("elastic") or {}
    chan_kw = dict(
        hb_interval=float(conf.get("gang_hb_interval", 0.5)),
        dead_peer_timeout=float(conf.get("gang_dead_peer_timeout", 3.0)),
        reattach_timeout=float(conf.get("gang_reattach_timeout", 10.0)),
        reconnect_timeout=float(conf.get("gang_reconnect_timeout", 10.0)),
    )
    if elastic:
        # the supervisor must turn a permanent loss into a shrink before
        # the channel's re-attach clock goes fatal
        chan_kw["reattach_timeout"] = max(
            chan_kw["reattach_timeout"],
            float(elastic.get("resize_deadline_s", 2.0)) * 4)
    followers = ctx.num_processes - 1
    dev = kw["device"]
    if dev.type == "cuda":
        if dev.index is None:
            # the pod's first own card: only its cards are visible
            dev = kw["device"] = torch.device(
                "cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)

    if ctx.process_id == 0:
        from .server import ModelServer

        channel = GangChannel.listen(
            gang_port, followers, token=token, **chan_kw)
        engine = GangEngine(cfg, params, channel=channel, **kw)
        groups = conf.get("warmup_groups")
        if groups != []:
            engine.warmup([tuple(g) for g in groups] if groups else None)
        if conf.get("runtime") == "text":
            # rank 0 owns the tokenizer and the OpenAI surface
            from .text import TextGenerator

            model = TextGenerator(
                conf.get("model_name", "model"), conf, engine=engine)
        else:
            model = contlib.ContinuousLlamaGenerator(
                conf.get("model_name", "model"), conf, engine=engine)
        server = ModelServer(port=int(conf["serve_port"]))
        server.register(model)
        if conf.get("logger_url"):
            server.set_logger(conf["logger_url"],
                              conf.get("logger_mode", "all"),
                              service=conf.get("model_name", "model"))
        # the frontend port is stable across gang restarts; the previous
        # incarnation's listener may need its SIGTERM grace to vacate it
        deadline = time.monotonic() + 15.0
        while True:
            try:
                server.start()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        supervisor = None
        resizer = None
        if elastic or engine.paged:
            from .resize import ElasticGangSupervisor, GangResizer, degree_of

            # a new degree's engine warms the groups the boot warmed
            resizer = GangResizer(
                engine, reshard_token=token, warmup_groups=groups,
                set_engine=lambda e: (
                    model.swap_engine(e)
                    if hasattr(model, "swap_engine")
                    else setattr(model, "engine", e)))
        if elastic:
            sharded.refuse_expert(conf.get("mesh_axes"),
                                  "an elastic gang (shrink and grow-back)")
            degree = degree_of(conf.get("mesh_axes"))
            supervisor = ElasticGangSupervisor(
                resizer, channel,
                degree_per_member=max(degree // ctx.num_processes, 1),
                max_degree=degree,
                min_degree=int(elastic.get("min_degree", 1)),
                resize_deadline_s=float(
                    elastic.get("resize_deadline_s", 2.0)))
        server.add_control_route(
            RESIZE_ROUTE, resize_route(resizer, channel, token, supervisor))
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        try:
            while not stop.is_set():
                # a dead follower surfaces as a failed publish (engine
                # error); an idle gang publishes nothing, so the channel's
                # own fatal flag is watched too. Non-zero exit: the JaxJob
                # controller restarts the gang.
                live = resizer.engine if resizer is not None else engine
                if live._error is not None or channel._dead is not None:
                    raise SystemExit(1)
                stop.wait(0.2)
        finally:
            if supervisor is not None:
                supervisor.stop()
            server.stop()
            (resizer.engine if resizer is not None else engine).stop()
            if resizer is not None:
                resizer.close()
    else:
        host, _, _ = bootstrap.resolve_coordinator(
            ctx.coordinator_address or "127.0.0.1:0").rpartition(":")
        fresh = False
        while True:
            channel = GangChannel.connect(
                host, gang_port, rank=ctx.process_id, token=token,
                fresh=fresh, **chan_kw)
            engine = contlib.ContinuousEngine(cfg, params, **kw)
            try:
                follow(engine, channel, fresh=fresh)
                break
            except ChannelClosed as e:
                # a restarted member whose replay gap rolled off the log
                # rejoins fresh (no replay) and waits for a grow resize
                if elastic and not fresh and "re-attach" in str(e):
                    fresh = True
                    continue
                raise
            finally:
                channel.close()
