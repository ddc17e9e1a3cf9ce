"""Mixture-of-Experts MLP: the port of ``kubeflow_tpu/models/moe.py`` on one
device.

Routing is the reference's: an f32 router, softmax, top-k, gates
renormalised over the k choices, and the Switch load-balancing loss, which
the layer returns beside its output (``(y, aux)``) instead of sowing it.
Two dispatches:

- ``"dense"``: GShard capacity dispatch, one-hot einsums, tokens past an
  expert's capacity dropped;
- ``"ragged"``: dropless. Each token is repeated for its k choices and the
  copies are sorted by expert (stable), so every expert owns one contiguous
  row range, and the experts run on the grouped GEMM
  (``ops/grouped_matmul.py``: the Hopper kernels on the card, their plain
  versions on the CPU).

The ragged path with an expert axis of 1 is the reference's single-device
branch with its grouped compute. Its offsets are computed on the device
(``searchsorted`` over the sorted expert ids), so the layer makes no host
sync, and no rows are padded: the kernels mask the ragged row tile. The
reference's other expert compute, masked per-expert matmuls over every row
(its ``moe_ragged_compute="masked"``, chosen off a TPU), is not ported: the
grouped GEMM gives the same result on every device.

Laid out on a mesh (``parallel.sharding.shard_model``):

- ``expert`` axis of ``d > 1`` (``ep``), capacity dispatch: each rank
  fills the capacity slots of its own rows and ``all_to_all`` moves them
  to their experts' ranks and back (``_dense``);
- ``expert`` axis of ``d > 1``, ragged dispatch: the reference's
  ``shard_body`` branch. Each rank holds ``e / d`` experts and its own
  rows of the batch.
  The ``[d, d]`` matrix of token counts (source rank x destination rank)
  is all-gathered and copied to the host once per layer in the forward
  pass (``dist.all_to_all_single`` takes its split sizes on the host; the
  recomputed forward of the backward pass reuses the copy, and
  ``HOST_COPIES`` counts them). Tokens go to their experts' ranks by
  ``parallel.collectives.ragged_all_to_all``, run through the local
  experts on ``grouped_matmul`` with local offsets, and come back by the
  reverse exchange. The reference's ``b % d`` fallback to the one-device
  branch never fires here: each rank holds its own rows, and the trainer
  refuses a global batch that its batch shards do not divide;
- ``model`` axis (``tp``): every expert's ``mlp`` dim is split, the gate
  and up products column-parallel and the down product row-parallel, the
  layer's output summed over the group (the gradients of the experts'
  input and of the gates sum over it too);
- the batch axes (``batch``): the load-balancing loss is taken over the
  global batch, its two means all-reduced over them;
- serving (``shard_model(serving=True)``): every rank of a gang replays
  the same host inputs, so its rows are replicated over ``expert``, not
  sharded along it. Each rank runs its ``e / d`` experts over their own
  window of the expert-sorted token copies (the reference's one-program
  fallback for rows the expert axis does not divide, whose math this
  is), and the partial outputs sum over the ``expert`` x ``model`` ranks
  (``sum_group``) in one all-reduce. Neither the aux loss's all-reduce
  nor the count matrix's host copy runs, so the layer holds no host sync
  and captures in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grouped_matmul import grouped_matmul
from ..parallel.collectives import (
    _all_reduce,
    all_gather_rows,
    all_to_all,
    all_reduce_sum,
    copy_to_group,
    ragged_all_to_all,
    reduce_from_group,
)

#: host copies of the expert-parallel count matrix, one per MoE layer's
#: forward pass (reset by setting the entry to 0)
HOST_COPIES = {"moe_ep_counts": 0}


class _Permute(torch.autograd.Function):
    """``x[order]`` whose backward is ``g[inv]``: a gather, not the
    scatter-add autograd derives for an index's transpose."""

    @staticmethod
    def forward(ctx, x, order, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, order)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g.index_select(0, inv), None, None


class _GatherTokens(torch.autograd.Function):
    """``xf[order // k]`` (each token fanned out to its k expert copies, in
    expert order) whose backward is a gather by ``inv`` and a k-way
    reshape-sum, with no scatter-add."""

    @staticmethod
    def forward(ctx, xf, order, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return xf.index_select(0, order // k)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        g_tok = g.index_select(0, inv)
        return g_tok.reshape(-1, ctx.k, *g.shape[1:]).sum(1), None, None, None


def _one_hot(idx, n: int) -> torch.Tensor:
    """``idx`` one-hot over ``n`` classes, in f32."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class MoeMlp(nn.Module):
    """Drop-in MoE replacement for the gated MLP; ``forward`` returns
    ``(y, aux)`` with aux the layer's Switch load-balancing loss (f32)."""

    #: the mesh's ``model``, ``expert`` and batch axis groups
    #: (``parallel.sharding.AxisGroup``), set by ``shard_model``
    tp = ep = batch = None
    #: a serving layout's ``expert`` x ``model`` group when ``ep`` is set:
    #: the rows are replicated over ``expert`` and each rank's partial
    #: output (its experts, its mlp shard) sums over this group
    sum_group = None

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        #: the host count matrix of the last forward pass (expert axis)
        self._counts = None
        from .llama import leaf_dtype  # llama.py imports this module

        e, h, m = cfg.moe_experts, cfg.hidden_size, cfg.intermediate_size
        for name, shape in (("router", (h, e)), ("w_gate", (e, h, m)),
                            ("w_up", (e, h, m)), ("w_down", (e, m, h))):
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape, dtype=leaf_dtype(name, cfg), device=device)))

    def init_weights(self, gen):
        """Router normal(0.02); experts fan-in truncated normal over axis 1
        (the reference's ``in_axis=(1,)``)."""
        from .llama import _trunc_normal  # llama.py imports this module

        self.router.normal_(0.0, 0.02, generator=gen)
        for w in (self.w_gate, self.w_up, self.w_down):
            _trunc_normal(w, w.shape[1], gen)

    def route(self, x):
        """(probs [b,s,e] f32, gates [b,s,k] f32, expert ids [b,s,k])."""
        cfg = self.cfg
        probs = (x.float() @ self.router.float()).softmax(dim=-1)
        gates, idx = probs.topk(cfg.moe_top_k, dim=-1)
        if cfg.moe_normalize_topk:
            gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
        return probs, gates, idx

    def forward(self, x):
        cfg = self.cfg
        e, k = cfg.moe_experts, cfg.moe_top_k
        s = x.shape[1]
        probs, gates, idx = self.route(x)
        # Switch aux loss over assignments before capacity: uniform routing
        # gives 1, collapse onto one expert ~e
        expert_mask = _one_hot(idx, e)                       # [b, s, k, e]
        frac_tokens = expert_mask.sum(dim=(1, 2)).mean(0) / (s * k)
        mean_prob = probs.mean(dim=(0, 1))
        if self.batch is not None:
            # the global batch's means: every batch shard has as many rows
            n = self.batch.size
            frac_tokens = _all_reduce(frac_tokens, self.batch.group) / n
            mean_prob = all_reduce_sum(mean_prob, self.batch.group) / n
        aux = e * (frac_tokens * mean_prob).sum()
        # under TP each rank's expert outputs are partial sums over its mlp
        # shard: the gradients of their inputs and of the gates that weigh
        # them sum over the group
        # (serving under ``expert``: over the expert x model group)
        group = self.tp if self.sum_group is None else self.sum_group
        xe, ge = x, gates
        if group is not None:
            xe = copy_to_group(x, group.group)
            ge = copy_to_group(gates, group.group)
        if cfg.moe_dispatch == "ragged":
            y = (self._ragged(xe, idx, ge)
                 if self.ep is None or self.sum_group is not None
                 else self._ragged_ep(xe, idx, ge))
        else:
            y = self._dense(xe, ge, expert_mask)
        if group is not None:
            y = reduce_from_group(y, group.group)
        return y, aux

    def _window(self) -> tuple[int, int]:
        """(first, count) of the global experts this rank computes: all of
        them, or under a serving ``expert`` axis its own ``e / d``."""
        el = self.w_gate.shape[0]
        return (0 if self.sum_group is None else self.ep.rank * el), el

    def _dense(self, x, gates, expert_mask):
        """GShard capacity dispatch (sequence-major priority). Under an
        expert axis of ``d`` ranks each rank fills the ``[e, b, c, h]``
        slots of its own rows (capacity per sequence, so no rank waits on
        another's queue), ``all_to_all`` hands every rank the slots of its
        ``e / d`` experts from all of them, ``[e / d, d b, c, h]``, and the
        outputs go back the inverse way: the all-to-all GSPMD inserts at
        the reference's ``expert`` constraint."""
        cfg = self.cfg
        dt = cfg.dtype
        b, s, k, e = expert_mask.shape
        capacity = max(1, int(cfg.moe_capacity_factor * k * s / e))
        flat = expert_mask.transpose(1, 2).reshape(b, k * s, e)
        pos_flat = flat.cumsum(dim=1) - flat                 # queue index
        pos = pos_flat.reshape(b, k, s, e).transpose(1, 2)   # [b, s, k, e]
        dispatch_k = expert_mask * (pos < capacity).float()
        cpos = (pos * dispatch_k).sum(-1).long()             # [b, s, k]
        cap_onehot = _one_hot(cpos, capacity)
        dispatch = torch.einsum("bske,bskc->bsec", dispatch_k, cap_onehot)
        combine = torch.einsum("bske,bskc,bsk->bsec", dispatch_k, cap_onehot,
                               gates)
        xin = torch.einsum("bsec,bsh->ebch", dispatch.to(dt), x)
        if self.sum_group is not None:
            # rows replicated over ``expert``: this rank's experts' slots
            # of every row, no exchange; the partial output sums in forward
            first, el = self._window()
            xin = xin[first:first + el]
            combine = combine[:, :, first:first + el]
        elif self.ep is not None:
            d, h = self.ep.size, x.shape[-1]
            # chunk j (experts of rank j) to rank j; chunk i back from i
            xin = all_to_all(xin.reshape(d, e // d, b, capacity, h),
                             self.ep.group)
            xin = xin.transpose(0, 1).reshape(e // d, d * b, capacity, h)
        hidden = (F.silu(torch.einsum("ebch,ehm->ebcm", xin,
                                      self.w_gate.to(dt)))
                  * torch.einsum("ebch,ehm->ebcm", xin, self.w_up.to(dt)))
        out_e = torch.einsum("ebcm,emh->ebch", hidden, self.w_down.to(dt))
        if self.ep is not None and self.sum_group is None:
            out_e = all_to_all(
                out_e.reshape(e // d, d, b, capacity, h).transpose(0, 1),
                self.ep.group).reshape(e, b, capacity, h)
        return torch.einsum("bsec,ebch->bsh", combine.to(dt), out_e)

    def _ragged(self, x, idx, gates):
        """Dropless dispatch: sort the token copies by expert, run the
        experts over contiguous row ranges, unsort, combine with the gates.
        Under a serving ``expert`` axis only this rank's experts run, over
        their window of the sorted copies: the grouped GEMM leaves the
        rows before ``offsets[0]`` and after ``offsets[-1]`` zero, so the
        window needs no host sync to cut."""
        cfg = self.cfg
        dt = cfg.dtype
        b, s, h = x.shape
        k = cfg.moe_top_k
        first, el = self._window()
        n = b * s
        flat_expert = idx.reshape(n * k)
        order = torch.argsort(flat_expert, stable=True)
        inv = torch.argsort(order)
        sorted_expert = flat_expert.index_select(0, order)
        xs = _GatherTokens.apply(x.reshape(n, h), order, inv, k).to(dt)
        wg, wu, wd = (w.to(dt) for w in (self.w_gate, self.w_up, self.w_down))
        offsets = torch.searchsorted(
            sorted_expert, torch.arange(first, first + el + 1,
                                        device=x.device),
            out_int32=True)
        hidden = (F.silu(grouped_matmul(xs, wg, offsets))
                  * grouped_matmul(xs, wu, offsets))
        y_sorted = grouped_matmul(hidden, wd, offsets)
        y = _Permute.apply(y_sorted, inv, order).reshape(n, k, h)
        y = (y * gates.reshape(n, k, 1).to(dt)).sum(1)
        return y.reshape(b, s, h)


    def _host_counts(self, send):
        """The [d, d] matrix of every rank's ``send`` counts (row = source
        rank), on the host: all-gathered and copied once in the forward
        pass; the forward that remat recomputes inside the backward pass
        reuses it (the same routing gives the same counts)."""
        if torch._C._current_graph_task_id() != -1 and self._counts is not None:
            return self._counts
        d = self.ep.size
        m = all_gather_rows(send, self.ep.group)
        HOST_COPIES["moe_ep_counts"] += 1
        self._counts = m.cpu().numpy().reshape(d, d)
        return self._counts

    def _ragged_ep(self, x, idx, gates):
        """The reference's ``shard_body`` for an expert axis of ``d > 1``:
        this rank's rows out to the ranks of their experts and back."""
        cfg = self.cfg
        dt = cfg.dtype
        b, s, h = x.shape
        k = cfg.moe_top_k
        d, me = self.ep.size, self.ep.rank
        el = self.w_gate.shape[0]                    # experts on this rank
        n = b * s
        flat_expert = idx.reshape(n * k)
        order = torch.argsort(flat_expert, stable=True)
        inv = torch.argsort(order)
        sorted_expert = flat_expert.index_select(0, order)
        xs = _GatherTokens.apply(x.reshape(n, h), order, inv, k).to(dt)
        dest = sorted_expert // el
        send = torch.zeros(d, dtype=torch.int64, device=x.device)
        send.scatter_add_(0, dest, torch.ones_like(dest))
        m = self._host_counts(send)
        # exclusive cumsums: mc over sources (receiver-side layout), mr over
        # destinations (sender-side layout)
        mc = np.cumsum(m, axis=0) - m
        mr = np.cumsum(m, axis=1) - m
        sizes, recv = m[me], m[:, me]
        starts = mc[:, me]
        rows = int(recv.sum())
        recv_x = ragged_all_to_all(
            xs, xs.new_zeros((rows, h)), mr[me], sizes, mc[me], recv,
            group=self.ep.group, recv_offsets=starts)
        ids = ragged_all_to_all(
            sorted_expert.to(torch.int32),
            torch.full((rows,), -1, dtype=torch.int32, device=x.device),
            mr[me], sizes, mc[me], recv, group=self.ep.group,
            recv_offsets=starts)
        # regroup the received rows by local expert for the grouped GEMM
        lid = ids - me * el
        order2 = torch.argsort(lid, stable=True)
        inv2 = torch.argsort(order2)
        xs2 = _Permute.apply(recv_x, order2, inv2)
        offsets = torch.searchsorted(
            lid.index_select(0, order2),
            torch.arange(el + 1, device=x.device, dtype=torch.int32),
            out_int32=True)
        wg, wu, wd = (w.to(dt) for w in (self.w_gate, self.w_up, self.w_down))
        hidden = (F.silu(grouped_matmul(xs2, wg, offsets))
                  * grouped_matmul(xs2, wu, offsets))
        y_buf = _Permute.apply(grouped_matmul(hidden, wd, offsets), inv2,
                               order2)
        # reverse transport: each received chunk back to its source, at the
        # source's sorted position
        y_sorted = ragged_all_to_all(
            y_buf, y_buf.new_zeros((n * k, h)), starts, recv, mr[:, me],
            sizes, group=self.ep.group, recv_offsets=mr[me])
        y = _Permute.apply(y_sorted, inv, order).reshape(n, k, h)
        y = (y * gates.reshape(n, k, 1).to(dt)).sum(1)
        return y.reshape(b, s, h)
