"""Elastic serving gangs: TP-degree resize of a live gang, the port of
``kubeflow_tpu/serving/resize.py``.

- :class:`GangResizer`: a copy-then-cutover degree change of a live
  engine. Admissions quiesce at a dispatch boundary; every live sequence
  freezes and snapshots (``export_sequence``: the source keeps every
  block, and a tensor-parallel snapshot holds every head); the weights
  are gathered whole and repartitioned by ``parallel.sharding.
  reshard_plan``; the new-degree engine, its pool and its programs are
  built; every sequence imports frozen onto its original ``Request``
  handle; and only once the new shape has acknowledged does ownership
  flip. Streams survive on their handles and greedy tokens stay
  bit-identical.
- the ``reshard`` wire family (``rs_*``): the weights reach the gang's
  other members over a kv_migrate-shaped stream (token-authenticated
  hello, framed JSON headers and raw tensor bytes, never pickle), and a
  member allocates its new-degree engine only at ``rs_commit``.
- :class:`ElasticGangSupervisor`: shrink-to-survive (a member evicted past
  ``resize_deadline_s`` escalates into a resize to the surviving degree)
  and grow-back (a returned member triggers the inverse resize).

What differs from the reference, and why: one process drives one card, so
a degree is the size of a ``torch.distributed`` group, and such a group
cannot drop a dead member (``new_group`` is collective over the whole
default group) nor admit one after init. So a degree change re-forms the
group: rank 0 publishes a fresh rendezvous (a new store port) in the
``resize`` op, and every member of the new degree calls
``destroy_process_group`` and ``init_process_group`` at the new size,
then builds its shards from the full weights by the plan; a rank the new
degree leaves out leaves the group and parks (it skips the stream until a
resize takes it back). The copy-then-cutover contract holds: everything
that needs the old group (the exports, the weight gather) happens before
the re-form, and an abort after it re-forms the old group (``resize_abort``
carries its rendezvous), re-points the old engine at it
(``sharded.rebind``) and resumes every frozen sequence in place, with zero
leaked blocks. At degree 1 rank 0 runs a plain engine (there is no group)
and keeps the channel for grow-back.
"""

from __future__ import annotations

import datetime
import logging
import socket
import threading
import time
from struct import error as struct_error
from typing import Any, Callable, Optional

import torch

from ..parallel.sharding import param_shardings, reshard_plan
from . import continuous as contlib
# ``GangEngine`` is read off ``gang`` at each use, as ``ContinuousEngine``
# is off ``continuous``: a resize checks and builds the class installed
# there when it runs, whenever this module was first imported
from . import gang as ganglib
from . import sharded
from .gang import (
    KV_HELLO_MAX,
    ChannelClosed,
    _kv_recv,
    _kv_send,
    _leaf_bytes,
    _leaf_from_bytes,
    _leaf_nbytes,
)
from .sharded import degree_of

log = logging.getLogger("kubeflow_tpu_torch.serving")


class ResizeAborted(RuntimeError):
    """A resize died before cutover; the source resumed in place."""

    def __init__(self, phase: str, cause: Optional[BaseException] = None):
        super().__init__(
            f"gang resize aborted during {phase}: {cause!r} — "
            "old-degree engine resumed in place")
        self.phase = phase
        self.cause = cause


def resize_block_budget(num_blocks: int, src_degree: int, dst_degree: int,
                        *, reserved: int = 0) -> int:
    """Block count for a pool rebuilt at a new TP degree: each rank's pool
    holds ``1 / degree`` of the heads, so the per-card pool bytes stay
    constant at ``num_blocks * dst / src`` blocks, floored at ``reserved``
    (the worst-case span the live sequences already hold: a resize never
    evicts mid-decode) and at 1."""
    if src_degree < 1 or dst_degree < 1:
        raise ValueError("degrees must be >= 1")
    scaled = (int(num_blocks) * int(dst_degree)) // int(src_degree)
    return max(scaled, int(reserved), 1)


# ---------------------------------------------------------------------------
# weights <-> wire leaves
# ---------------------------------------------------------------------------


def flatten_params(params) -> list[tuple[str, torch.Tensor]]:
    """Sorted (name, CPU tensor) pairs of a state dict, the reshard wire's
    transfer unit."""
    # analysis: ok host-sync-in-dispatch — resize worker thread copy
    return [(k, torch.as_tensor(v).detach().cpu())
            for k, v in sorted(params.items())]


def unflatten_params(leaves) -> dict:
    """The state dict of wire (name, tensor) leaves."""
    return dict(leaves)


def full_params(engine) -> dict:
    """Every weight of ``engine``'s model unsharded on the CPU. On a
    tensor-parallel engine this gathers over its group: every rank calls
    it (a gang leader publishes ``("params",)`` first)."""
    layout = getattr(engine.model, "layout", None)
    if layout is None:
        # analysis: ok host-sync-in-dispatch — resize worker thread copy
        return {k: v.detach().cpu()
                for k, v in engine.model.state_dict().items()}
    return layout.full_state_dict()


# ---------------------------------------------------------------------------
# the process group of a degree
# ---------------------------------------------------------------------------


def reform_group(group: dict, rank: int, host: str = "127.0.0.1") -> bool:
    """Leave the current process group and, when ``rank`` is a member of
    ``group`` (``{"ranks": {gang rank: group rank}, "port", "backend",
    "timeout_s"}``) of more than one rank, join its fresh rendezvous.
    True when this rank is a member."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    ranks = {int(k): int(v) for k, v in group["ranks"].items()}
    if rank not in ranks:
        return False
    if len(ranks) > 1:
        dist.init_process_group(
            group["backend"], init_method=f"tcp://{host}:{group['port']}",
            world_size=len(ranks), rank=ranks[rank],
            timeout=datetime.timedelta(seconds=float(group["timeout_s"])))
    return True


def _mesh_of(n: int) -> Optional[dict]:
    return {"model": n} if n > 1 else None


# ---------------------------------------------------------------------------
# the reshard wire family (rs_*): JSON headers + raw tensor bytes
# ---------------------------------------------------------------------------
#
#   member -> rs_hello {token, rank}        leader -> rs_ready
#   leader -> rs_plan {degree, leaves: [{path, shape, dtype, src, dst}]}
#   leader -> rs_leaf {i, path} + bytes     (buffered host-side)
#   leader -> rs_commit
#   member builds its new-degree engine (allocation at commit), then
#   member -> rs_ack {ok, rank, error?}
#
# Each full leaf streams; a member keeps its shards of it (the plan's dst
# specs say which).


class ReshardServer:
    """Leader side of the ``reshard`` wire family: serves the plan and the
    full weight leaves to each member of the new degree and collects its
    post-build ack, the "new shape acks" gate of copy-then-cutover."""

    def __init__(self, leaves: list, plan: list[dict], *, degree: int,
                 token: str = "", port: Optional[int] = None,
                 host: str = "127.0.0.1", sock_wrap=None,
                 trace_ctx: Optional[dict] = None):
        from ..utils.net import allocate_port

        if host != "127.0.0.1" and not token:
            raise ValueError(
                "a non-loopback ReshardServer requires a token")
        self._leaves = leaves
        self._plan = plan
        self._trace_ctx = trace_ctx
        self._degree = int(degree)
        self._token = token
        self._sock_wrap = sock_wrap or (lambda s: s)
        self._closing = threading.Event()
        self._acks: dict[int, tuple[bool, str]] = {}
        self._ack_cv = threading.Condition()
        self.port = port or allocate_port()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, self.port))
        srv.listen(8)
        srv.settimeout(0.2)
        self._srv = srv
        threading.Thread(target=self._accept_loop, name="reshard-srv",
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
                name="reshard-conn", daemon=True).start()

    def _serve_one(self, c) -> None:
        import hmac

        rank = -1
        try:
            c.settimeout(30.0)
            hello, _ = _kv_recv(c, KV_HELLO_MAX)
            if hello.get("t") != "rs_hello" or not hmac.compare_digest(
                    str(hello.get("token", "")), self._token):
                raise ChannelClosed("bad reshard handshake")
            rank = int(hello.get("rank", -1))
            _kv_send(c, {"t": "rs_ready"})
            _kv_send(c, {"t": "rs_plan", "degree": self._degree,
                         "nleaves": len(self._leaves),
                         "leaves": self._plan, "trace": self._trace_ctx})
            for i, (path, leaf) in enumerate(self._leaves):
                _kv_send(c, {"t": "rs_leaf", "i": i, "path": path},
                         _leaf_bytes(leaf))
            _kv_send(c, {"t": "rs_commit"})
            # the member joins the new group and builds its engine now
            c.settimeout(300.0)
            ack, _ = _kv_recv(c, 1 << 16)
            if ack.get("t") != "rs_ack":
                raise ChannelClosed(f"expected rs_ack, got {ack.get('t')!r}")
            rank = int(ack.get("rank", rank))
            with self._ack_cv:
                self._acks[rank] = (bool(ack.get("ok")),
                                    str(ack.get("error", "")))
                self._ack_cv.notify_all()
        except (OSError, ChannelClosed, ValueError, struct_error,
                EOFError) as e:
            log.debug("reshard transfer aborted (rank %d): %s", rank, e)
            if rank >= 0:
                with self._ack_cv:
                    self._acks.setdefault(rank, (False, str(e)))
                    self._ack_cv.notify_all()
        finally:
            try:
                c.close()
            except OSError:
                pass

    def await_acks(self, ranks, timeout: float = 120.0) -> dict[int, tuple]:
        """Block until every rank in ``ranks`` acked (or the deadline):
        rank -> (ok, error); a missing rank reports a timeout failure."""
        deadline = time.monotonic() + timeout
        want = set(int(r) for r in ranks)
        with self._ack_cv:
            while not want.issubset(self._acks):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._ack_cv.wait(remaining)
            return {r: self._acks.get(r, (False, "no ack before deadline"))
                    for r in want}

    def close(self) -> None:
        self._closing.set()
        srv, self._srv = self._srv, None
        if srv is not None:
            try:
                srv.close()
            except OSError:
                pass


class ReshardClient:
    """Member side of the ``reshard`` wire family: receive the plan and
    the leaves (host memory only until the caller builds its engine),
    then ack the build's outcome on the same connection."""

    def __init__(self, host: str, port: int, *, token: str = "",
                 rank: int = 0, sock_wrap=None, timeout: float = 120.0):
        raw = socket.create_connection((host, port), timeout=timeout)
        self._c = (sock_wrap or (lambda s: s))(raw)
        self._rank = int(rank)
        try:
            self._c.settimeout(timeout)
        except OSError:
            pass
        _kv_send(self._c, {"t": "rs_hello", "token": token,
                           "rank": self._rank})
        ready, _ = _kv_recv(self._c, KV_HELLO_MAX)
        if ready.get("t") != "rs_ready":
            raise ChannelClosed("reshard server refused the handshake")

    def receive(self) -> tuple[dict, dict]:
        """(plan header, name -> CPU tensor). Raises on a short or
        malformed stream; the caller then acks failure."""
        header, _ = _kv_recv(self._c)
        if header.get("t") != "rs_plan":
            raise ChannelClosed(f"expected rs_plan, got {header.get('t')!r}")
        specs = {e["path"]: e for e in header.get("leaves") or []}
        nleaves = int(header.get("nleaves", 0))
        leaves: dict = {}
        while True:
            frame, payload = _kv_recv(self._c)
            t = frame.get("t")
            if t == "rs_leaf":
                path = str(frame.get("path"))
                spec = specs.get(path)
                if spec is None:
                    raise ChannelClosed(f"rs_leaf for unplanned {path!r}")
                want = _leaf_nbytes(spec)
                if len(payload) != want:
                    raise ChannelClosed(
                        f"rs_leaf {path!r}: {len(payload)}B != spec {want}B")
                leaves[path] = _leaf_from_bytes(payload, spec["dtype"],
                                                spec["shape"])
            elif t == "rs_commit":
                break
            else:
                raise ChannelClosed(f"unknown reshard frame {t!r}")
        if len(leaves) != nleaves:
            raise ChannelClosed(
                f"rs_commit with {len(leaves)}/{nleaves} leaves")
        return header, leaves

    def ack(self, ok: bool, error: str = "") -> None:
        _kv_send(self._c, {"t": "rs_ack", "ok": bool(ok),
                           "rank": self._rank, "error": error[:500]})

    def close(self) -> None:
        try:
            self._c.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the follower's side of a resize (gang.follow's resize arms)
# ---------------------------------------------------------------------------


def _follower_device(engine, conf: dict, device) -> torch.device:
    if engine is not None:
        return engine.device
    if device is not None:
        return torch.device(device)
    if conf.get("device_type") == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def follower_resize(engine, channel, conf: dict, device=None,
                    program_cache=None):
    """A follower's ``resize``: receive the full weights over the rs wire
    (a member of the new degree), leave the old group and join the new
    one, build the new-degree engine and ack. Returns the new engine, or
    None when this rank is parked (not a member). A failed build acks the
    failure and returns ``engine``: the leader then aborts, and
    ``follower_abort`` re-forms the old group. The wire kwargs are
    JSON-safe: the program-artifact cache carries over from the follower's
    first engine instead (``program_cache``, which ``follow`` keeps over a
    parked stretch)."""
    rank = channel.rank
    group = conf["group"]
    ranks = {int(k): int(v) for k, v in group["ranks"].items()}
    host = (channel._addr or ("127.0.0.1", 0))[0]
    dev = _follower_device(engine, conf, device)
    client = None
    try:
        if rank in ranks:
            rs = conf["reshard"]
            client = ReshardClient(
                host, int(rs["port"]), token=str(rs.get("token", "")),
                rank=rank, sock_wrap=channel._sock_wrap)
            _plan, leaves = client.receive()
        reform_group(group, rank, host)
        if rank not in ranks:
            return None
        new = contlib.ContinuousEngine(
            conf["cfg"], unflatten_params(leaves),
            mesh_axes=_mesh_of(len(ranks)), device=dev,
            program_cache=program_cache,
            **dict(conf.get("kwargs") or {}))
        client.ack(True)
        return new
    except Exception as e:  # noqa: BLE001 — a member that cannot rebuild
        # must answer, not die: the leader aborts on the failed ack and
        # the old degree keeps serving
        log.warning("follower resize failed: %s", e)
        if client is not None:
            try:
                client.ack(False, f"{type(e).__name__}: {e}")
            except (OSError, ChannelClosed):
                pass
        return engine
    finally:
        if client is not None:
            client.close()


def follower_abort(failed, engine, channel, conf: dict) -> None:
    """A follower's ``resize_abort``: drop the half-built engine, re-form
    the old degree's group and re-point ``engine`` (the old one, or None
    when this rank was parked before) at it."""
    if failed is not None and failed is not engine:
        failed.stop()
    host = (channel._addr or ("127.0.0.1", 0))[0]
    if reform_group(conf["group"], channel.rank, host) and engine is not None:
        rebind_engine(engine)


def rebind_engine(engine) -> None:
    """Re-point a tensor-parallel engine (its model's groups and its own)
    at the process group formed again for its degree."""
    if degree_of(engine.mesh_axes) > 1:
        engine.mesh = sharded.build_serving_mesh(engine.mesh_axes)
        engine._tp = sharded.rebind(engine.model, engine.mesh)


# ---------------------------------------------------------------------------
# GangResizer: the copy-then-cutover orchestration
# ---------------------------------------------------------------------------


class GangResizer:
    """Copy-then-cutover TP-degree resize of a live engine or gang.

    Runs on a supervisor or worker thread, never an engine scheduler.
    Phases, with the chaos seam's failpoints (``FaultPlan.
    resize_failpoint``) between their items:

      quiesce  — admissions defer (the old pool keeps decoding);
      export   — every live sequence freezes and snapshots (the source
                 keeps everything);
      reshard  — the weights gathered whole, the plan made, the gang's
                 members told (``resize``) and fed over the rs wire, the
                 group re-formed at the new degree, the new engine, pool
                 and programs built and warmed;
      commit   — snapshots import ``hold=True`` on their original handles;
      cutover  — once the new shape acked: release on the old, resume on
                 the new, the waiting queue adopted, the engine swapped.

    ``set_engine`` re-points the serving runtime; ``on_event(reason,
    message)`` receives ``GangResized``/``ResizeAborted``."""

    PHASES = ("export", "reshard", "commit")

    def __init__(self, engine, *, set_engine: Optional[Callable] = None,
                 reshard_token: str = "",
                 failpoint: Optional[Callable] = None,
                 on_event: Optional[Callable] = None,
                 warmup_groups: Optional[list] = None, sock_wrap=None,
                 ack_timeout_s: float = 120.0, tracer=None,
                 group_timeout_s: float = 120.0):
        if not getattr(engine, "paged", False):
            raise ValueError(
                "elastic resize requires the paged pool (block_size > 0):"
                " the transferable unit of sequence state is the block")
        self.engine = engine
        self.tracer = (tracer if tracer is not None
                       else getattr(engine, "tracer", None))
        #: the gang's control stream, kept across degrees (a degree-1
        #: leader runs a plain engine but grows back through it)
        self.channel = getattr(engine, "_channel", None)
        #: the group backend a re-formed degree uses
        self.backend = getattr(engine, "backend", None) or (
            "nccl" if engine.device.type == "cuda" else "gloo")
        self._set_engine = set_engine
        self._token = reshard_token
        self._failpoint = failpoint
        self._on_event = on_event
        self._warmup_groups = warmup_groups
        self._sock_wrap = sock_wrap
        self._ack_timeout = float(ack_timeout_s)
        self._group_timeout = float(group_timeout_s)
        self._lock = threading.Lock()
        self.resizes_total = 0
        self.resize_failures_total = 0
        #: phase timings of the last successful resize: drain_s =
        #: quiesce + export, reshard_s = weights + group + build + warmup,
        #: resume_s = commit + cutover
        self.last_timings: dict[str, float] = {}

    def _fail(self, phase: str) -> None:
        if self._failpoint is not None:
            self._failpoint(phase)

    def _emit(self, reason: str, message: str) -> None:
        if self._on_event is not None:
            try:
                self._on_event(reason, message)
            except Exception:  # noqa: BLE001 — an observer must never
                # turn a resize into a failure
                log.debug("resize event sink failed", exc_info=True)

    @staticmethod
    def _engine_kwargs_of(src, *, orig_policy) -> dict:
        """The knobs of a live engine, read back off the instance."""
        return dict(
            num_slots=src.num_slots, decode_chunk=src.decode_chunk,
            prefill_budget=src.prefill_budget,
            temperature=src.temperature, eos_id=src.eos_id,
            seq_buckets=list(src.seq_buckets),
            default_max_new_tokens=src.default_max_new_tokens,
            pipeline_depth=src.pipeline_depth,
            prefix_cache=src.prefix_cache, min_prefix=src.min_prefix,
            spec_k=src.spec_k, spec_ngram=src.spec_ngram,
            draft_proposer=src._proposer, block_size=src.block_size,
            host_blocks=src.host_blocks,
            host_watermark=(src._host_watermark_blocks
                            / max(src.num_blocks, 1)),
            admission_policy=orig_policy, role=src.role, device=src.device,
            # the artifact cache carries over from the engine replaced
            program_cache=getattr(src, "program_cache", None))

    @staticmethod
    def _wire_kwargs(kw: dict, num_blocks: int) -> dict:
        """The kwargs a member's rebuild needs (no proposer or policy
        objects: members never schedule)."""
        out = {k: kw[k] for k in (
            "num_slots", "decode_chunk", "prefill_budget", "temperature",
            "eos_id", "seq_buckets", "default_max_new_tokens",
            "pipeline_depth", "prefix_cache", "min_prefix", "spec_k",
            "spec_ngram", "block_size", "role")}
        out["num_blocks"] = int(num_blocks)
        return out

    @staticmethod
    def _snapshot_blocks(snap: dict) -> int:
        bs = int(snap["block_size"])
        if snap.get("phase") == "prefill":
            total = len(snap["prompt"]) + int(snap["max_new_tokens"])
        else:
            total = int(snap["position"]) + int(snap["remaining"])
        return max(-(-total // bs), len(snap.get("blocks", ())), 1)

    def degree(self) -> int:
        """Current TP degree (1 = unsharded)."""
        return int(getattr(self.engine, "tp_degree", 1))

    def resize_to_degree(self, degree: int) -> Any:
        """The autoscaler's entry point: a target degree as ``{"model":
        N}``; a same-degree target returns the live engine."""
        sharded.refuse_expert(getattr(self.engine, "mesh_axes", None),
                              "a resize")
        d = int(degree)
        if d < 1:
            raise ValueError(f"target TP degree must be >= 1, got {d}")
        if d == self.degree():
            return self.engine
        return self.resize({"model": d})

    def resize(self, mesh_axes: Optional[dict], *,
               num_blocks: Optional[int] = None) -> Any:
        """Resize the live engine to ``mesh_axes`` (None = degree 1).
        Returns the new engine (also installed through ``set_engine`` and
        as ``self.engine``); raises :class:`ResizeAborted` with the old
        engine resumed in place on any failure before cutover."""
        # the reference's resizes target {"model": N} too
        sharded.refuse_expert(getattr(self.engine, "mesh_axes", None),
                              "a resize")
        sharded.refuse_expert(mesh_axes, "a resize")
        with self._lock:
            # the lock is the drain barrier: one resize at a time
            # analysis: ok lock-blocking-call — lock is the drain barrier
            return self._resize_locked(mesh_axes, num_blocks)

    def _group(self, ranks: list[int]) -> dict:
        """The rendezvous of a degree over gang ranks ``ranks`` (rank 0
        first), on a fresh port of this host."""
        from ..utils.net import free_port

        return {"ranks": {r: i for i, r in enumerate(ranks)},
                "port": free_port(), "backend": self.backend,
                "timeout_s": self._group_timeout}

    def _resize_locked(self, mesh_axes, num_blocks):
        src = self.engine
        channel = self.channel
        old_degree = self.degree()
        new_degree = degree_of(mesh_axes)
        phase = "export"
        t0 = time.perf_counter()
        timings: dict[str, float] = {}
        rtr = None
        if self.tracer is not None:
            from .trace import Trace

            rtr = Trace(name="resize", old_degree=old_degree,
                        new_degree=new_degree)
            rtr.phase("resize.export")
        orig_policy = src.admission_policy
        exported: list[tuple[Any, dict]] = []
        published = False
        old_ranks: list[int] = []
        server: Optional[ReshardServer] = None
        new = None
        try:
            if new_degree > 1 and channel is None:
                raise ValueError(
                    f"a tensor-parallel degree of {new_degree} needs a gang "
                    f"of {new_degree} ranks (serving/gang.py); this engine "
                    "has no gang")
            # QUIESCE: new admissions defer; live slots decode on until
            # their export freezes them
            td = time.perf_counter()
            src.admission_policy = lambda req: False
            # EXPORT: read the live set on the scheduler thread, then
            # freeze and snapshot each (every head, on a TP source)
            for req in src.quiesced_live_requests():
                snap = src.export_sequence(req)
                if snap is not None:
                    exported.append((req, snap))
                    if req.trace is not None:
                        req.trace.phase("resize.frozen",
                                        resize=(rtr.trace_id
                                                if rtr else ""))
                self._fail("export")
            timings["drain_s"] = time.perf_counter() - td

            # RESHARD: the weights whole, the plan, the members told and
            # fed, the group re-formed, the new engine built
            phase = "reshard"
            t1 = time.perf_counter()
            if rtr is not None:
                rtr.phase("resize.reshard")
            if isinstance(src, ganglib.GangEngine):
                # the gather is a collective of the old group
                src.publish(("params",))
            full = full_params(src)
            plan = reshard_plan(
                full, param_shardings(full, src.mesh_axes or {}),
                param_shardings(full, _mesh_of(new_degree) or {}))
            self._fail("reshard")
            reserved = sum(self._snapshot_blocks(s) for _, s in exported)
            nb = int(num_blocks) if num_blocks else resize_block_budget(
                src.num_blocks, old_degree, new_degree, reserved=reserved)
            kw = self._engine_kwargs_of(src, orig_policy=orig_policy)
            kw["num_blocks"] = nb
            if channel is not None:
                members = channel.follower_ranks()
                if len(members) + 1 < new_degree:
                    raise RuntimeError(
                        f"degree {new_degree} needs {new_degree} ranks; "
                        f"the gang has {len(members) + 1}")
                old_ranks = [0] + sorted(members)[:old_degree - 1]
                new_ranks = [0] + sorted(members)[:new_degree - 1]
                group = self._group(new_ranks)
                server = ReshardServer(
                    flatten_params(full), plan, degree=new_degree,
                    token=self._token, sock_wrap=self._sock_wrap,
                    trace_ctx=(rtr.wire_context() if rtr else None))
                channel.publish(("resize", {
                    "cfg": src.cfg, "group": group,
                    "device_type": src.device.type,
                    "kwargs": self._wire_kwargs(kw, nb),
                    "reshard": {"port": server.port, "token": self._token},
                    "trace": rtr.wire_context() if rtr else None,
                }))
                published = True
                # the old pool's blocks cannot be gathered once its group
                # is gone: the source spills nothing at its release
                src._host_pool = None
                reform_group(group, 0)
                if new_degree > 1:
                    new = ganglib.GangEngine(src.cfg, full, channel=channel,
                                     mesh_axes=_mesh_of(new_degree), **kw)
                else:
                    new = contlib.ContinuousEngine(src.cfg, full, **kw)
                acks = server.await_acks(new_ranks[1:],
                                         timeout=self._ack_timeout)
                bad = {r: e for r, (ok, e) in acks.items() if not ok}
                if bad:
                    raise RuntimeError(
                        f"member rebuild failed: {bad} — the new shape "
                        "never acked")
            else:
                new = contlib.ContinuousEngine(src.cfg, full, **kw)
            if self.tracer is not None and getattr(new, "tracer",
                                                   None) is None:
                new.tracer = self.tracer
            if getattr(src, "block_ledger", None) is not None:
                # one ledger across both degrees' allocators
                new.attach_block_ledger(src.block_ledger)
            if getattr(src, "spill_store", None) is not None:
                new.attach_spill_store(src.spill_store)
            self._fail("reshard")
            groups = self._warmup_groups
            if groups != []:
                new.warmup([tuple(g) for g in groups] if groups else None)
            timings["reshard_s"] = time.perf_counter() - t1

            # COMMIT: every sequence installed frozen on its own handle
            phase = "commit"
            t2 = time.perf_counter()
            if rtr is not None:
                rtr.phase("resize.commit")
            for req, _snap in exported:
                new.import_sequence(_snap, req=req, hold=True)
                self._fail("commit")
        except Exception as e:  # noqa: BLE001 — any death before cutover
            # takes the same rollback: discard the new shape, resume in
            # place
            self.resize_failures_total += 1
            if new is not None:
                for req, _snap in exported:
                    try:
                        new.release_sequence(req)
                    except (RuntimeError, TimeoutError):
                        pass
                if isinstance(new, ganglib.GangEngine):
                    new.keep_channel_open = True
                new.stop()
            if published:
                back = self._group(old_ranks)
                try:
                    channel.publish(("resize_abort", {"group": back}))
                except ChannelClosed:
                    pass
                reform_group(back, 0)
                rebind_engine(src)
            for req, _snap in exported:
                try:
                    src.resume_sequence(req)
                except (RuntimeError, TimeoutError):
                    log.warning("resize rollback: resume failed for a "
                                "sequence", exc_info=True)
            src.admission_policy = orig_policy
            if rtr is not None:
                rtr.meta["aborted"] = phase
                self.tracer.finish(rtr)
            self._emit("ResizeAborted",
                       f"resize {old_degree}->{new_degree} died during "
                       f"{phase}; old degree resumed")
            raise ResizeAborted(phase, e) from e
        finally:
            if server is not None:
                server.close()

        # CUTOVER (forward only): the new shape acked
        cut_err: Optional[Exception] = None
        if rtr is not None:
            rtr.phase("resize.cutover")
        if channel is not None:
            try:
                channel.publish(("resize_commit",))
            except ChannelClosed as e:
                cut_err = e

        def _adopt(req) -> None:
            nonlocal cut_err
            try:
                new.adopt_request(req)
            except Exception as e:  # noqa: BLE001 — resolve, not strand
                cut_err = cut_err or e
                if not req.done.is_set():
                    req.error = RuntimeError(
                        f"resize cutover failed: {e!r}")
                    req.done.set()

        for req, _snap in exported:
            try:
                src.release_sequence(req)
            except Exception as e:  # noqa: BLE001 — the source still
                # owns this one: drop the held copy
                cut_err = cut_err or e
                try:
                    new.release_sequence(req)
                except (RuntimeError, TimeoutError):
                    pass
                continue
            try:
                new.resume_sequence(req)
            except Exception as e:  # noqa: BLE001 — the source let go:
                # resolve the handle, never strand the client
                cut_err = cut_err or e
                if not req.done.is_set():
                    req.error = RuntimeError(
                        f"resize cutover failed: {e!r}")
                    req.done.set()
        try:
            for req in src.take_waiting():
                _adopt(req)
        except (RuntimeError, TimeoutError) as e:
            cut_err = cut_err or e
        self.engine = new
        if self._set_engine is not None:
            self._set_engine(new)
        try:
            for req in src.take_waiting():
                _adopt(req)
        except (RuntimeError, TimeoutError) as e:
            cut_err = cut_err or e
        if isinstance(src, ganglib.GangEngine):
            src.keep_channel_open = True
        src.stop()
        if cut_err is not None:
            self.resize_failures_total += 1
            if rtr is not None:
                rtr.meta["aborted"] = "cutover"
                self.tracer.finish(rtr)
            self._emit("ResizeAborted",
                       f"cutover completed forward with an error: "
                       f"{cut_err!r}")
            raise ResizeAborted("cutover", cut_err) from cut_err
        timings["resume_s"] = time.perf_counter() - t2
        timings["total_s"] = time.perf_counter() - t0
        self.last_timings = timings
        self.resizes_total += 1
        if rtr is not None:
            rtr.meta["sequences"] = len(exported)
            self.tracer.finish(rtr)
        self._emit(
            "GangResized",
            f"TP {old_degree} -> {new_degree}: {len(exported)} live "
            f"conversations repartitioned in {timings['total_s']:.3f}s "
            f"(drain {timings['drain_s']:.3f}s, reshard "
            f"{timings['reshard_s']:.3f}s, resume "
            f"{timings['resume_s']:.3f}s)")
        return new

    def close(self) -> None:
        """End the gang's stream when the live engine no longer owns it (a
        degree-1 leader's plain engine): followers return from
        ``follow``."""
        if self.channel is None or isinstance(self.engine,
                                              ganglib.GangEngine):
            return
        try:
            self.channel.publish(("stop",))
        except ChannelClosed:
            pass
        self.channel.close()


# ---------------------------------------------------------------------------
# ElasticGangSupervisor: shrink-to-survive / grow-back
# ---------------------------------------------------------------------------


class ElasticGangSupervisor:
    """Rank 0's watcher that turns gang membership changes into resizes,
    the reference's: a follower evicted from the channel and still gone
    past ``resize_deadline_s`` escalates into a resize to the surviving
    degree (``degree_per_member * live members``, floored at
    ``min_degree``; the rank is forgotten on the channel once the resize
    landed); a member count above the current degree's (a re-attached
    rank, or a fresh join) triggers the inverse resize, capped at
    ``max_degree``."""

    def __init__(self, resizer: GangResizer, channel, *,
                 degree_per_member: int, max_degree: int,
                 min_degree: int = 1, resize_deadline_s: float = 2.0,
                 max_resize_attempts: int = 5,
                 poll_s: float = 0.1, on_event: Optional[Callable] = None):
        sharded.refuse_expert(
            getattr(getattr(resizer, "engine", None), "mesh_axes", None),
            "an elastic shrink")
        self.resizer = resizer
        self.channel = channel
        self.degree_per_member = int(degree_per_member)
        self.max_degree = int(max_degree)
        self.min_degree = int(min_degree)
        self.resize_deadline_s = float(resize_deadline_s)
        #: attempts before the supervisor stops restarting the re-attach
        #: fatality clock (the JaxJob restart stays the backstop)
        self.max_resize_attempts = int(max_resize_attempts)
        self._shrink_attempts = 0
        self._grow_attempts = 0
        self._last_live: tuple = ()
        self._poll = float(poll_s)
        self._on_event = on_event
        self._pending_fresh = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="elastic-gang", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def _loop(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — a failed escalation must
                # not kill the watcher; the next tick retries
                log.warning("elastic supervisor tick failed",
                            exc_info=True)

    def _tick(self) -> None:
        now = time.monotonic()
        lost = self.channel.lost_since()
        live = self.channel.follower_ranks()
        if self.channel.take_fresh_joins():
            self._pending_fresh = True
        cur = self.resizer.degree()
        if tuple(live) != self._last_live:
            self._last_live = tuple(live)
            self._grow_attempts = 0
            self._shrink_attempts = 0
        overdue = [r for r, t in lost.items()
                   if now - t > self.resize_deadline_s]
        if overdue:
            target = self.degree_per_member * (1 + len(live))
            if target < self.min_degree:
                return  # nothing legal to shrink to: the restart backstop
            if self._shrink_attempts < self.max_resize_attempts:
                self.channel.touch_lost(overdue)
            self._shrink_attempts += 1
            if target != cur or self._pending_fresh:
                self.resizer.resize(self._axes_for(target))
            for r in overdue:
                self.channel.forget_rank(r)
            self._pending_fresh = False
            self._shrink_attempts = 0
            return
        target = min(self.degree_per_member * (1 + len(live)),
                     self.max_degree)
        if target > cur or self._pending_fresh:
            if self._grow_attempts >= self.max_resize_attempts:
                return
            self._grow_attempts += 1
            self.resizer.resize(self._axes_for(max(target, cur)))
            self._grow_attempts = 0
            self._pending_fresh = False

    @staticmethod
    def _axes_for(degree: int) -> Optional[dict]:
        return {"model": int(degree)}
