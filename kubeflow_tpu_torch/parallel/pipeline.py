"""Pipeline parallelism over the ``pipeline`` mesh axis: the port of
``kubeflow_tpu/parallel/pipeline.py``.

Each rank of the axis holds one stage of the block stack
(``sharding.shard_model`` lays ``("layers", "pipeline")`` out as this rank's
blocks, or under interleaving its model chunks ``{d, P+d, ...}``), and the
host runs the reference's lockstep schedules tick by tick:

- ``gpipe``: fill, steady state and drain over ``M + P - 1`` ticks for ``M``
  microbatches over ``P`` stages, the activations handed on by an open
  chain (``collectives.ring_permute``); the MoE aux sum counts real ticks
  only; the last stage's finished buffer is summed over the axis (the
  others add zeros) so that the head and the loss run on every rank. It is
  one autograd node: its backward runs the reverse ticks, each re-running
  the stage from the stashed input (``remat``) and sending the input's
  cotangent back down the chain;
- ``schedule_1f1b`` and ``Schedule1F1B``: the reference's tick tables,
  device-free numpy, as they are;
- ``one_f_one_b``: the executor of those tables, value and gradient in one
  pass (microbatch i's backward runs while i + k's forward is in flight).

The host knows every slot, so an idle slot computes nothing, but every rank
calls every shift of every tick (an idle slot sends zeros): the ranks'
collectives stay in step, forward and backward. ``mesh`` is a
``DeviceMesh`` (default ``mesh.current_mesh()``) or the ``pipeline`` axis's
``sharding.AxisGroup``. Gradients: a stage's parameters get theirs on their
rank; of what is replicated over the axis, the input's gradient is nonzero
on the first stage only and the head's (``one_f_one_b``'s ``loss_fn``) on
the last, so that the sum over the axis (``Layout.sync_grads``) is the
gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .collectives import ring_permute
from .sharding import axis_group

AXIS = "pipeline"


def pipeline_axis(mesh):
    """The ``pipeline`` axis's ``AxisGroup``, or None for one stage."""
    return axis_group(mesh, AXIS)


def pipeline_degree(mesh) -> int:
    """The number of stages (1 with no ``pipeline`` axis)."""
    axis = pipeline_axis(mesh)
    return 1 if axis is None else axis.size


def _with_aux(block_apply, with_aux: bool):
    if with_aux:
        return block_apply

    def plain(blk, h):
        return block_apply(blk, h), h.new_zeros((), dtype=torch.float32)
    return plain


def _apply_stage(block_apply, blocks, h, remat: bool):
    """``blocks`` in order over ``h``: (output, the sum of their aux in
    f32); each block under ``checkpoint`` when ``remat`` and grad is on."""
    aux = h.new_zeros((), dtype=torch.float32)
    remat = remat and torch.is_grad_enabled()
    for blk in blocks:
        if remat:
            h, a = checkpoint(block_apply, blk, h, use_reentrant=False)
        else:
            h, a = block_apply(blk, h)
        aux = aux + a.float()
    return h, aux


def _microbatches(x, m: int):
    if x.shape[0] % m:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {m} microbatches")
    return x.reshape(m, x.shape[0] // m, *x.shape[1:])


def _backward(outs, cts) -> None:
    """``torch.autograd.backward`` over the outputs that carry a graph."""
    pairs = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
    torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])


@dataclasses.dataclass
class _GPipeRun:
    block_apply: Callable
    blocks: list
    axis: Any
    m: int
    remat: bool
    grad: bool


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, run: _GPipeRun):
        p, d = run.axis.size, run.axis.rank
        x_mb = _microbatches(x.detach(), run.m)
        ticks = run.m + p - 1
        out_buf = torch.zeros_like(x_mb)
        aux_acc = x.new_zeros((), dtype=torch.float32)
        stash: dict[int, tuple] = {}
        state = None
        for t in range(ticks):
            mb = t - d  # the microbatch this stage holds at tick t
            if 0 <= mb < run.m:
                cur = x_mb[mb] if d == 0 else state
                if run.grad and not run.remat:
                    h = cur.detach().requires_grad_()
                    with torch.enable_grad():
                        y, aux = _apply_stage(run.block_apply, run.blocks, h,
                                              False)
                    stash[t] = (h, y, aux)
                    y, aux = y.detach(), aux.detach()
                else:
                    y, aux = _apply_stage(run.block_apply, run.blocks, cur,
                                          False)
                    stash[t] = (cur,)
                aux_acc = aux_acc + aux
                if d == p - 1:
                    out_buf[mb] = y
            else:
                y = torch.zeros_like(x_mb[0])  # fill or drain: zeros
            if t < ticks - 1:
                state = ring_permute(y, run.axis.group, 1, wrap=False)
        # the finished buffer from the last stage to every rank, and the aux
        # summed over the stages (each holds its own layers')
        import torch.distributed as dist

        dist.all_reduce(out_buf, group=run.axis.group)
        dist.all_reduce(aux_acc, group=run.axis.group)
        ctx.run, ctx.stash = run, stash
        return out_buf.reshape(x.shape), aux_acc

    @staticmethod
    def backward(ctx, d_out, d_aux):
        run, stash = ctx.run, ctx.stash
        p, d = run.axis.size, run.axis.rank
        d_out = _microbatches(d_out, run.m)
        dx = torch.zeros_like(d_out)
        ticks = run.m + p - 1
        send = torch.zeros_like(d_out[0])
        for t in reversed(range(ticks)):
            dy = (ring_permute(send, run.axis.group, -1, wrap=False)
                  if t < ticks - 1 else torch.zeros_like(send))
            send = torch.zeros_like(send)
            mb = t - d
            if not 0 <= mb < run.m:
                continue
            if d == p - 1:
                # the last stage's buffer is the output; every rank's head
                # sees the same output, so its own cotangent is the one
                dy = dy + d_out[mb]
            if run.remat:
                h = stash.pop(t)[0].detach().requires_grad_()
                with torch.enable_grad():
                    y, aux = _apply_stage(run.block_apply, run.blocks, h,
                                          False)
            else:
                h, y, aux = stash.pop(t)
            _backward((y, aux), (dy, d_aux))
            if d == 0:
                dx[mb] = h.grad
            else:
                send = h.grad
        return dx.reshape(d_out.shape[0] * d_out.shape[1],
                          *d_out.shape[2:]), None


def gpipe(block_apply: Callable, blocks, x, *, mesh=None,
          num_microbatches: Optional[int] = None, remat: bool = True,
          with_aux: bool = False):
    """Run this stage's ``blocks`` over ``x`` as a P-stage microbatch
    pipeline; returns the last stage's output on every rank (and with
    ``with_aux`` the sum of every block's aux over every layer and real
    microbatch).

    ``block_apply(block, h) -> h`` (``-> (h, aux)`` with ``with_aux``)
    applies one block. ``x`` [batch, ...] is the same on every rank of the
    axis; the batch splits into ``num_microbatches`` (default the degree).
    ``remat``: the forward keeps each microbatch's stage input only and the
    backward runs the stage again. With no ``pipeline`` axis the blocks run
    in order (under ``checkpoint`` with ``remat``)."""
    axis = pipeline_axis(mesh)
    fn = _with_aux(block_apply, with_aux)
    if axis is None:
        out, aux = _apply_stage(fn, list(blocks), x, remat)
        return (out, aux) if with_aux else out
    m = num_microbatches or axis.size
    _microbatches(x, m)
    run = _GPipeRun(fn, list(blocks), axis, m, remat,
                    torch.is_grad_enabled())
    out, aux = _GPipe.apply(x, run)
    return (out, aux) if with_aux else out


def interleave_permutation(num_layers: int, p: int, v: int) -> np.ndarray:
    """Layer-axis permutation for the interleaved executor.

    ``perm[new] = canonical`` such that taking the canonical stacked
    layers at ``perm`` yields device-contiguous storage: device d's slice
    holds model chunks {d, P+d, ..., (V-1)P+d} in local order.  The
    inverse (for gradients) is ``np.argsort(perm)``.  On TPU this is one
    weight reshard per step (cheap over ICI; over DCN it is charged in
    the projection model — BASELINE.md).
    """
    if num_layers <= 0 or num_layers % (p * v):
        raise ValueError(
            f"{num_layers} layers not divisible by {p} stages x {v} chunks")
    cl = num_layers // (p * v)
    order = []
    for d in range(p):
        for lv in range(v):
            c = lv * p + d
            order.extend(range(c * cl, (c + 1) * cl))
    return np.asarray(order, np.int32)


# -- 1F1B (perf-grade schedule) ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class Schedule1F1B:
    """Static 1F1B tick tables for ``p`` devices x ``m`` microbatches x
    ``v`` virtual stages per device (Megatron interleaving; v=1 is the
    classic non-interleaved schedule).

    The model's ``p*v`` chunks are assigned round-robin: chunk ``c`` runs
    on device ``c % p`` as its local chunk ``c // p`` — consecutive chunks
    sit on consecutive devices, so activations ride the same +1 ppermute
    ring (with a wraparound edge for the chunk-(kP-1) -> chunk-(kP)
    transition).  Each tick is one chunk-fwd slot + one chunk-bwd slot
    per device; tables give, per [tick, device]:

    - ``fwd``/``fwd_lv``: microbatch + local chunk of the fwd slot (-1 idle)
    - ``fwd_slot``: act-stash slot holding the input (-1 = read x_mb,
      i.e. model chunk 0)
    - ``fwd_seed_slot``: grad-stash slot to seed with the loss cotangent
      (>=0 only when the slot forwards the LAST model chunk)
    - ``bwd``/``bwd_lv``/``bwd_slot``/``bwd_gslot``: same for the bwd slot
    - ``ra_slot``/``rg_slot``: stash slot the activation/cotangent
      arriving over the ring this tick is written to (-1 = ignore)

    ``act_slots``/``grad_slots`` are exact stash high-waters from the
    simulation — the schedule's memory bound, reported (not assumed).
    """

    p: int
    m: int
    v: int
    fwd: np.ndarray           # [T, P] microbatch (-1 idle)
    fwd_lv: np.ndarray        # [T, P] local chunk index
    fwd_slot: np.ndarray      # [T, P] act slot (-1 = x_mb)
    fwd_seed_slot: np.ndarray  # [T, P] grad slot to seed (-1 = not last)
    bwd: np.ndarray
    bwd_lv: np.ndarray
    bwd_slot: np.ndarray
    bwd_gslot: np.ndarray
    ra_slot: np.ndarray
    rg_slot: np.ndarray
    act_slots: int
    grad_slots: int

    @property
    def ticks(self) -> int:
        return self.fwd.shape[0]

    @property
    def useful_fraction(self) -> float:
        """Filled fwd+bwd slots over total slots (1 - bubble fraction).
        Slot units are CHUNK work items: at v>1 a device fills m*v of
        each direction, so fractions compare across v."""
        filled = int((self.fwd >= 0).sum() + (self.bwd >= 0).sum())
        return filled / (2 * self.ticks * self.p)


class _SlotPool:
    """Exact slot allocator: reuse the lowest free slot, track high-water."""

    def __init__(self):
        self.free: list[int] = []
        self.next = 0
        self.high = 0

    def alloc(self) -> int:
        if self.free:
            return self.free.pop()
        s = self.next
        self.next += 1
        self.high = max(self.high, self.next)
        return s

    def release(self, s: int) -> None:
        self.free.append(s)


def schedule_1f1b(p: int, m: int, v: int = 1,
                  cap: Optional[int] = None) -> Schedule1F1B:
    """Simulate the (interleaved) 1F1B schedule event-by-event and emit
    static tick tables plus exact stash-slot assignments.

    Rules (Megatron-style, adapted to a lockstep SPMD program with a
    1-tick ppermute latency):

    - fwd work follows the Megatron interleaved order — rounds of P
      microbatches per chunk, lower chunks first within a round — as
      activations arrive, throttled so a device holds at most ``cap``
      forwarded-not-yet-backwarded chunk inputs (the memory throttle;
      default p+2 at v=1, p+2+(v-1) interleaved);
    - bwd work follows the mirrored order (higher chunks first within a
      round) as cotangents arrive; the device owning the LAST model chunk
      seeds that cotangent from the loss at forward time, so it can run
      fwd and bwd of the same microbatch in one tick;
    - within a tick the fwd slot runs before the bwd slot, and a
      bwd-completing-this-tick frees its in-flight slot for the fwd
      admission check.
    """
    if p < 1 or m < 1 or v < 1:
        raise ValueError("need p >= 1, m >= 1, v >= 1")
    C = p * v
    # default throttle = the warmup depth the latency-optimal schedule
    # needs (p*v + 2; p + 2 at v=1, the classic 1F1B bound).  The
    # simulator achieves the model's exact lower bound T = mv + p + pv - 2
    # at this cap (see PERF.md "interleaved 1F1B" for the bound's proof).
    cap = cap if cap is not None else min(p * v + 2, m * v)

    next_f = [0] * C
    next_b = [0] * C
    recv_act = [set() for _ in range(C)]   # mb whose input arrived
    recv_grad = [set() for _ in range(C)]  # mb whose cotangent arrived
    fwd_done = [set() for _ in range(C)]
    act_slot_of: dict[tuple[int, int], int] = {}
    grad_slot_of: dict[tuple[int, int], int] = {}
    act_pool = [_SlotPool() for _ in range(p)]
    grad_pool = [_SlotPool() for _ in range(p)]

    def fkey(c: int, mb: int) -> tuple:
        # Megatron interleaved fwd order: rounds of p microbatches per
        # chunk, chunk-major within the round
        return (mb // p, c // p, mb % p, c)

    def bkey(c: int, mb: int) -> tuple:
        # mirrored for bwd: higher chunks drain first within a round
        return (mb // p, (v - 1) - c // p, mb % p, c)

    rows: dict[str, list] = {k: [] for k in (
        "fwd", "fwd_lv", "fwd_slot", "fwd_seed_slot",
        "bwd", "bwd_lv", "bwd_slot", "bwd_gslot", "ra", "rg")}
    # deliveries computed at tick t land in the tables at t+1
    pending_ra = [-1] * p
    pending_rg = [-1] * p

    t = 0
    while any(nb < m for nb in next_b):
        frow = [-1] * p
        flv = [-1] * p
        fslot = [-1] * p
        fseed = [-1] * p
        brow = [-1] * p
        blv = [-1] * p
        bslot = [-1] * p
        bgslot = [-1] * p
        rows["ra"].append(list(pending_ra))
        rows["rg"].append(list(pending_rg))
        pending_ra = [-1] * p
        pending_rg = [-1] * p

        fwd_chosen: list[Optional[tuple[int, int]]] = [None] * p
        bwd_chosen: list[Optional[tuple[int, int]]] = [None] * p
        for d in range(p):
            chunks = [c for c in range(d, C, p)]
            # tentative bwd readiness (ignoring this tick's own fwd seed)
            ready0 = [
                (c, next_b[c]) for c in chunks
                if next_b[c] < m and (
                    (c < C - 1 and next_b[c] in recv_grad[c])
                    or (c == C - 1 and next_b[c] in fwd_done[c]))
            ]
            in_flight = sum(next_f[c] - next_b[c] for c in chunks)
            fcands = [
                (c, next_f[c]) for c in chunks
                if next_f[c] < m and next_f[c] < next_b[c] + m  # sanity
                and (c == 0 or next_f[c] in recv_act[c])
            ]
            if fcands and in_flight - (1 if ready0 else 0) < cap:
                c, mb = min(fcands, key=lambda cm: fkey(*cm))
                fwd_chosen[d] = (c, mb)
            # bwd: include a same-tick seed from this tick's fwd
            bcands = list(ready0)
            fc = fwd_chosen[d]
            if (fc is not None and fc[0] == C - 1
                    and next_b[C - 1] == fc[1]
                    and all((cc, mm) != fc for cc, mm in bcands)):
                bcands.append(fc)
            if bcands:
                bwd_chosen[d] = min(bcands, key=lambda cm: bkey(*cm))

        for d in range(p):
            fc = fwd_chosen[d]
            if fc is not None:
                c, mb = fc
                frow[d], flv[d] = mb, c // p
                fslot[d] = act_slot_of.get((c, mb), -1) if c > 0 else -1
                next_f[c] += 1
                fwd_done[c].add(mb)
                if c == C - 1:
                    s = grad_pool[d].alloc()
                    grad_slot_of[(c, mb)] = s
                    fseed[d] = s
                    recv_grad[c].add(mb)
            bc = bwd_chosen[d]
            if bc is not None:
                c, mb = bc
                brow[d], blv[d] = mb, c // p
                bslot[d] = act_slot_of.get((c, mb), -1) if c > 0 else -1
                bgslot[d] = grad_slot_of[(c, mb)]
                next_b[c] += 1
                # frees happen at end of tick (slot read during the tick)

        # deliveries (land next tick) + slot frees
        for d in range(p):
            fc = fwd_chosen[d]
            if fc is not None:
                c, mb = fc
                if c + 1 < C:
                    d2 = (c + 1) % p
                    s = act_pool[d2].alloc()
                    act_slot_of[(c + 1, mb)] = s
                    pending_ra[d2] = s
                    recv_act[c + 1].add(mb)
            bc = bwd_chosen[d]
            if bc is not None:
                c, mb = bc
                if c - 1 >= 0:
                    d2 = (c - 1) % p
                    s = grad_pool[d2].alloc()
                    grad_slot_of[(c - 1, mb)] = s
                    pending_rg[d2] = s
                    recv_grad[c - 1].add(mb)
                # free the consumed stash entries
                if c > 0:
                    act_pool[d].release(act_slot_of.pop((c, mb)))
                grad_pool[d].release(grad_slot_of.pop((c, mb)))

        for key, row in (("fwd", frow), ("fwd_lv", flv), ("fwd_slot", fslot),
                         ("fwd_seed_slot", fseed), ("bwd", brow),
                         ("bwd_lv", blv), ("bwd_slot", bslot),
                         ("bwd_gslot", bgslot)):
            rows[key].append(row)
        t += 1
        if t > 4 * (m * v + p) + 16 * v:
            raise RuntimeError(
                f"1F1B schedule deadlocked at p={p} m={m} v={v} cap={cap}")

    arr = {k: np.array(rows[k], np.int32) for k in rows}
    return Schedule1F1B(
        p=p, m=m, v=v,
        fwd=arr["fwd"], fwd_lv=arr["fwd_lv"], fwd_slot=arr["fwd_slot"],
        fwd_seed_slot=arr["fwd_seed_slot"],
        bwd=arr["bwd"], bwd_lv=arr["bwd_lv"], bwd_slot=arr["bwd_slot"],
        bwd_gslot=arr["bwd_gslot"],
        ra_slot=arr["ra"], rg_slot=arr["rg"],
        act_slots=max(1, max(pl.high for pl in act_pool)),
        grad_slots=max(1, max(pl.high for pl in grad_pool)),
    )




def one_f_one_b(block_apply: Callable, loss_fn: Callable, blocks, x,
                loss_args, *, mesh=None,
                num_microbatches: Optional[int] = None, remat: bool = True,
                with_aux: bool = False, aux_weight: float = 0.0,
                interleave: int = 1):
    """Loss **and gradients** of this stage's ``blocks`` under the 1F1B
    schedule: returns ``(loss, dx)``, the loss (0-d f32, the same on every
    rank of the axis) and its gradient for ``x``, nonzero on the first
    stage; the blocks' and the head's parameters' gradients are added to
    their ``.grad``.

    ``loss = mean_mb loss_fn(blocks(x_mb), args_mb)`` (+ ``aux_weight`` x
    the sum of the aux of every layer and microbatch, with ``with_aux``).
    ``loss_fn(y, args) -> scalar`` runs on the rank holding the last model
    chunk, when a microbatch's forward leaves it; ``loss_args`` (a tensor or
    a tuple of them, each leading with the batch dim, e.g. the targets) is
    microbatched like ``x``. Each backward slot runs the chunk again from
    the stashed input and backpropagates the cotangent that arrived at
    once, sending the input's cotangent upstream: a pipeline stage holds one
    chunk's activations at a time whatever ``remat`` says, which applies
    (each block under ``checkpoint``) only with no ``pipeline`` axis.

    ``interleave=V``: the Megatron interleaved schedule; ``blocks`` are this
    rank's V model chunks in local order (chunk ``c`` on rank ``c % P``;
    ``interleave_permutation``), and the activations ride full rings rather
    than open chains. With no ``pipeline`` axis the loss and its gradients
    come from one backward pass."""
    axis = pipeline_axis(mesh)
    fn = _with_aux(block_apply, with_aux)
    blocks = list(blocks)
    args = loss_args if isinstance(loss_args, (tuple, list)) else (loss_args,)
    if axis is None:
        h = x.detach().requires_grad_()
        y, aux = _apply_stage(fn, blocks, h, remat)
        loss = loss_fn(y, *args) + aux_weight * aux
        loss.backward()
        return loss.detach(), h.grad
    p, d = axis.size, axis.rank
    m = num_microbatches or p
    x_mb = _microbatches(x.detach(), m)
    args_mb = [_microbatches(a, m) for a in args]
    if len(blocks) % interleave:
        raise ValueError(
            f"{len(blocks) * p} layers not divisible by {p} stages x "
            f"{interleave} virtual chunks")
    cl = len(blocks) // interleave
    sched = schedule_1f1b(p, m, v=interleave)
    rows = np.stack([sched.fwd, sched.fwd_lv, sched.fwd_slot,
                     sched.fwd_seed_slot, sched.bwd, sched.bwd_lv,
                     sched.bwd_slot, sched.bwd_gslot, sched.ra_slot,
                     sched.rg_slot], axis=-1)[:, d].tolist()
    wrap = interleave > 1
    acts: list = [None] * sched.act_slots
    grads: list = [None] * sched.grad_slots
    zeros = torch.zeros_like(x_mb[0])
    y_prev = dh_prev = zeros
    sums = x.new_zeros(2, dtype=torch.float32)  # loss, aux
    dx = torch.zeros_like(x_mb)

    def chunk(lv: int, h, remat: bool):
        return _apply_stage(fn, blocks[lv * cl:(lv + 1) * cl], h, remat)

    for f, f_lv, f_slot, f_seed, b, b_lv, b_slot, b_gslot, ra, rg in rows:
        # 1-2: what the neighbours sent last tick, activation and cotangent
        got = ring_permute(y_prev, axis.group, 1, wrap)
        if ra >= 0:
            acts[ra] = got
        got = ring_permute(dh_prev, axis.group, -1, wrap)
        if rg >= 0:
            grads[rg] = got
        y_prev = dh_prev = zeros
        # 3: the forward slot; the last model chunk seeds its cotangent
        if f >= 0:
            with torch.no_grad():
                y, aux = chunk(f_lv, x_mb[f] if f_slot < 0 else acts[f_slot],
                               False)
            sums[1] += aux
            if f_seed >= 0:
                yy = y.requires_grad_()
                with torch.enable_grad():
                    loss_f = loss_fn(yy, *(a[f] for a in args_mb)) / m
                loss_f.backward()  # the head's gradients, / m
                grads[f_seed] = yy.grad.to(x.dtype)
                sums[0] += loss_f.detach()
                y = y.detach()
            y_prev = y
        # 4: the backward slot, from the stashed input
        if b >= 0:
            h = (x_mb[b] if b_slot < 0 else acts[b_slot]).detach()
            h.requires_grad_()
            # the chunk's graph lives only until the backward just below,
            # so no checkpoint: remat's recompute would be a third forward
            with torch.enable_grad():
                y, aux = chunk(b_lv, h, False)
            _backward((y, aux), (grads[b_gslot],
                                 torch.tensor(aux_weight, device=x.device)))
            grads[b_gslot] = None
            if b_slot < 0:
                dx[b] = h.grad
            else:
                acts[b_slot] = None
            dh_prev = h.grad
    import torch.distributed as dist

    dist.all_reduce(sums, group=axis.group)
    return sums[0] + aux_weight * sums[1], dx.reshape(x.shape)
