"""Collectives of the port's parallel layouts, each differentiable.

- ``ragged_all_to_all``: the dropless-MoE transport, with the semantics of
  ``kubeflow_tpu/parallel/collectives.py`` (``lax.ragged_all_to_all``):
  rank ``i`` sends, for each destination ``d``,
  ``operand[input_offsets[d] : +send_sizes[d]]``, which lands on ``d`` at
  ``output_offsets[d]`` (the *receiver-side* offset); rows of ``output``
  that no received chunk writes keep their values. It is built on
  ``dist.all_to_all_single`` with split sizes, which NCCL and gloo take on
  the host: the offsets and sizes are host integers. Its backward is the
  reverse exchange.
- The tensor-parallel pair of Megatron-LM: ``copy_to_group`` (identity
  forward, all-reduce of the gradient backward) in front of a
  column-parallel product, ``reduce_from_group`` (all-reduce forward,
  identity backward) after a row-parallel one, and ``gather_last_dim``
  (all-gather forward, this rank's slice of the gradient backward). With
  them every rank computes the same loss and exact gradients for its own
  shards and for the parameters it holds whole.
- ``all_reduce_sum``: the all-reduce whose backward is the all-reduce of the
  gradients, for a global statistic that enters a loss every rank of the
  group computes.

The all-reduces are ``torch.distributed._functional_collectives`` ops.
``subgroup`` gives the process group of several mesh dimensions together.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _wait(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import (
        AsyncCollectiveTensor,
    )

    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    return _wait(funcol.all_reduce(x.contiguous(), "sum", group))


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` stacked along dim 0, in rank order."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    # the newer name of all_gather_into_tensor, where torch has it
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, x.contiguous(), group=group)
    return out


def _all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    return torch.cat(all_gather_rows(x, group).chunk(n, dim=0), dim=-1)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = dist.get_rank(group)
        ctx.width = x.shape[-1]
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.rank * w:(ctx.rank + 1) * w].contiguous(), None


def copy_to_group(x, group):
    """Identity; the gradient is all-reduced over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """Sum over ``group``; the gradient passes unchanged."""
    return _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x, group):
    """Sum over ``group``; the gradient is summed over ``group`` too."""
    return _AllReduceSum.apply(x, group)


def gather_last_dim(x, group):
    """The group's shards of the last dim, concatenated in rank order."""
    return _GatherLastDim.apply(x, group)


def _host_ints(v) -> list[int]:
    if isinstance(v, torch.Tensor):
        return [int(a) for a in v.tolist()]
    return [int(a) for a in v]


def _exclusive_cumsum(sizes: Sequence[int]) -> list[int]:
    return [0, *itertools.accumulate(sizes)][:-1]


def _exchange(src, src_offsets, src_sizes, dst_rows, dst_offsets,
              dst_sizes, group):
    """Rows of ``src`` at (``src_offsets``, ``src_sizes``) go out, one
    chunk per rank; returns (the received chunks, in rank order, and
    whether they tile a buffer of ``dst_rows`` rows exactly at
    ``dst_offsets``)."""
    if src_offsets == _exclusive_cumsum(src_sizes):
        send = src.narrow(0, 0, sum(src_sizes))
    else:
        send = torch.cat([src.narrow(0, o, s)
                          for o, s in zip(src_offsets, src_sizes)])
    recv = src.new_empty((sum(dst_sizes), *src.shape[1:]))
    dist.all_to_all_single(recv, send.contiguous(), dst_sizes, src_sizes,
                           group=group)
    exact = (dst_offsets == _exclusive_cumsum(dst_sizes)
             and sum(dst_sizes) == dst_rows)
    return recv, exact


def _place(buf, recv, offsets, sizes):
    """``buf`` with ``recv``'s consecutive chunks written at ``offsets``."""
    out = buf.clone()
    pos = 0
    for o, s in zip(offsets, sizes):
        out.narrow(0, o, s).copy_(recv.narrow(0, pos, s))
        pos += s
    return out


class _RaggedAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, operand, output, group, in_offs, send, recv_offs, recv):
        ctx.group = group
        ctx.meta = (operand.shape[0], in_offs, send, recv_offs, recv)
        got, exact = _exchange(operand, in_offs, send, output.shape[0],
                               recv_offs, recv, group)
        return got if exact else _place(output, got, recv_offs, recv)

    @staticmethod
    def backward(ctx, g):
        rows, in_offs, send, recv_offs, recv = ctx.meta
        back, exact = _exchange(g, recv_offs, recv, rows, in_offs, send,
                                ctx.group)
        if not exact:
            back = _place(g.new_zeros((rows, *g.shape[1:])), back, in_offs,
                          send)
        keep = g.clone()
        for o, s in zip(recv_offs, recv):
            keep.narrow(0, o, s).zero_()
        return back, keep, None, None, None, None, None


def ragged_all_to_all(operand, output, input_offsets, send_sizes,
                      output_offsets, recv_sizes, *, group,
                      recv_offsets: Optional[Sequence[int]] = None):
    """``lax.ragged_all_to_all`` over ``group``: see the module docstring.

    The four index arrays are this rank's, as the primitive takes them
    (host integers or tensors, one entry per rank of the group). Each
    incoming chunk's place in ``output`` is the sender's
    ``output_offsets`` entry for this rank: they are exchanged first,
    unless the caller knows them (``recv_offsets``: where the chunk from
    each rank lands here), as a caller holding every rank's sizes does."""
    in_offs, send = _host_ints(input_offsets), _host_ints(send_sizes)
    recv = _host_ints(recv_sizes)
    if recv_offsets is None:
        out_offs = torch.tensor(_host_ints(output_offsets),
                                dtype=torch.int64, device=operand.device)
        mine = torch.empty_like(out_offs)
        dist.all_to_all_single(mine, out_offs, group=group)
        recv_offsets = mine
    return _RaggedAllToAll.apply(operand, output, group, in_offs, send,
                                 _host_ints(recv_offsets), recv)


def subgroup(mesh, dims: Sequence[str]):
    """The process group of this rank's ranks over mesh dimensions
    ``dims`` together (the others fixed): ``mesh.get_group`` for one
    dimension, else ``dist.new_group`` for every such set of ranks, made
    in the same order on every rank (a collective call: every rank makes
    the same calls)."""
    dims = tuple(d for d in mesh.mesh_dim_names if d in dims)
    if not dims:
        return None
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    names = mesh.mesh_dim_names
    ranks = mesh.mesh
    keep = [names.index(d) for d in dims]
    other = [i for i in range(len(names)) if i not in keep]
    width = 1
    for i in keep:
        width *= ranks.shape[i]
    me = dist.get_rank()
    mine = None
    for row in ranks.permute(*other, *keep).reshape(-1, width).tolist():
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine
