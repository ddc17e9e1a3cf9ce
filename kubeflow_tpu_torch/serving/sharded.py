"""Tensor-parallel serving: the port of ``kubeflow_tpu/serving/sharded.py``.

The reference's serving mesh is one process over N local devices: its
programs are SPMD, and one ``jit`` drives every chip. PyTorch has no
counterpart to that, so here one process drives one card, and a
tensor-parallel engine is one rank of a ``torch.distributed`` group whose
``model`` axis is the mesh; an MoE model may add an ``expert`` axis
(``{"expert": 2, "model": 2}``: four ranks). The gang (``serving/gang.py``:
rank 0 decides, every rank dispatches) is the only way to run one, on one
host as on several; ``serve_main`` runs one rank in each pod.

- ``build_serving_mesh``: a ``DeviceMesh`` of the axes over the process
  group (``parallel/mesh.py``; ``expert`` outer, so the ranks of one
  ``model`` group are adjacent); the product of the axes must equal the
  group's size, and without a group of that size a ``ValueError`` says a
  TP engine needs a gang of that many ranks;
- ``place_params``: the model built on the meta device, laid out by
  ``parallel.sharding.shard_model(serving=True)`` over the mesh (the
  trainer's layout: heads, kv heads, mlp and vocab on ``model``, experts
  on ``expert``; every rank holds every row, so an MoE layer runs its
  experts over all of them and sums over the group), each rank
  allocating and loading its shards only from the full state dict every
  rank reads;
- the cache and logits placement of the reference's ``constrain_*`` are
  statements about local shapes on a rank: the pool holds
  ``num_kv_heads / N`` heads for a ``model`` axis of N, the same heads on
  every rank of an ``expert`` group (``Llama.kv_heads``; the
  ``kv_heads_axis`` of
  every leaf: dim 3 of ``k``/``v`` ``[layers, rows, seq, kv, d]``, dim 2 of
  the scales ``[layers, rows, kv, seq]``); the logits are whole on every
  rank, because the model's ``Head`` all-gathers them; the sampled tokens
  are equal on every rank, drawn from the same logits with the same noise.
- ``gather_heads``/``local_heads``: a block snapshot moves with every head
  (the reference's global array fetch gathers them), so a TP engine's
  export gathers its ``model`` group's head shards and an import keeps
  this rank's slice: a snapshot is the same whatever the degree.

A gang with an ``expert`` axis serves; resizing it, an elastic shrink and
a kv_migrate export of its sequences are refused by name
(``refuse_expert``): the reference's resizes target ``{"model": N}`` too.

``mesh_jit`` and ``_lowered`` have no counterpart: nothing is traced, the
engine's programs are plain functions on this rank's tensors, and the
collectives inside them (``models/llama.py``) line the ranks up.
"""

from __future__ import annotations

import math
from typing import Any, Optional

from ..parallel import mesh as meshlib
from ..parallel import sharding as shardlib


def degree_of(mesh_axes: Optional[dict]) -> int:
    """TP degree a mesh-axes dict denotes: the number of ranks a serving
    mesh spans (None/empty = 1)."""
    return math.prod(int(v) for v in (mesh_axes or {}).values()) or 1


#: the axes a serving mesh may have
SERVING_AXES = ("expert", "model")


def expert_degree(mesh_axes: Optional[dict]) -> int:
    """The ``expert`` axis's size in a mesh-axes dict (1 when absent)."""
    return int((mesh_axes or {}).get("expert", 1))


def refuse_expert(mesh_axes: Optional[dict], what: str) -> None:
    """Raise ``ValueError`` naming the ``expert`` axis when ``mesh_axes``
    has one: ``what`` (a resize, an elastic shrink, a kv_migrate export)
    is defined for ``{"model": N}`` gangs only, as in the reference."""
    if expert_degree(mesh_axes) > 1:
        raise ValueError(
            f"{what} is not supported on a gang whose mesh has an 'expert' "
            f"axis ({dict(mesh_axes)}): only {{'model': N}} gangs resize "
            "and export")


def build_serving_mesh(mesh_axes: dict[str, int]):
    """A ``DeviceMesh`` of ``mesh_axes`` over the initialised process
    group, one rank per card. The ``model`` axis (tensor parallelism) and
    an MoE model's ``expert`` axis are served; the group's size must be
    the axes' product."""
    import torch.distributed as dist

    other = sorted(a for a, s in mesh_axes.items()
                   if a not in SERVING_AXES and int(s) != 1)
    if other:
        raise NotImplementedError(
            f"serving mesh axes {other}: only 'model' (tensor parallelism) "
            "and 'expert' (an MoE model's experts) are served; replicas "
            "are separate engines")
    n = degree_of(mesh_axes)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise ValueError(
            f"a tensor-parallel engine of mesh {mesh_axes} needs a gang of "
            f"{n} ranks, one process a card (serving/gang.py); this "
            + ("process is in no process group" if not have
               else f"process group has {have}"))
    return meshlib.build_mesh({a: int(mesh_axes[a]) for a in SERVING_AXES
                               if int(mesh_axes.get(a, 1)) > 1})


def logical_axis(mesh, name: str) -> Optional[str]:
    """Mesh axis a logical axis name rides on this mesh (the shared rule
    table restricted to present axes); None degrades to replication."""
    return dict(shardlib.rules_for_mesh(mesh)).get(name)


def kv_heads_axis(mesh) -> Optional[str]:
    """Mesh axis the cache's kv_heads dim rides."""
    return logical_axis(mesh, "kv_heads")


def place_params(cfg, params: Any, mesh, device):
    """A ``Llama`` on ``device`` laid out on ``mesh``, loaded from
    ``params`` (the full state dict every rank holds, or a ``Llama`` on the
    CPU): built on the meta device, ``shard_model``, then each rank
    allocates and copies its shards only. Returns the model; its
    ``layout`` is the ``parallel.sharding.Layout``."""
    import torch

    from ..models.llama import Llama

    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    model = Llama(cfg, device="meta")
    layout = shardlib.shard_model(model, mesh, serving=True)
    model.to_empty(device=device)
    layout.load_full_state_dict(params)
    return model


def rebind(model, mesh):
    """Re-point a laid-out model at ``mesh`` (its degree's process group
    formed again, as a resize's abort does): the layout's groups and
    every module's ``tp``. Returns the new ``model`` axis group. A layout
    with an ``expert`` axis is never resized, so never rebound."""
    layout = model.layout
    refuse_expert(layout.axes, "rebinding a laid-out model")
    layout.mesh = mesh
    layout._groups = {}
    tp = layout.group(("model",))
    for mod in model.modules():
        if getattr(mod, "tp", None) is not None:
            mod.tp = tp
    return tp


def tp_group(model):
    """The ``model`` axis group of a laid-out model (``AxisGroup``), or
    None for an unsharded one."""
    layout = getattr(model, "layout", None)
    return None if layout is None else layout.group(("model",))


#: the kv-heads dim of each leaf a block export carries
#: (``paged.MIGRATE_LEAVES`` order, block axis first): k/v
#: ``[n, layers, bs, kv, d]``, scales ``[n, layers, kv, bs]``
_HEAD_DIM = {"k": 3, "v": 3, "k_scale": 2, "v_scale": 2}


def head_dims(names) -> list[int]:
    return [_HEAD_DIM[n] for n in names]


def gather_heads(leaves: list, dims: list[int], group) -> list:
    """Every rank's head shard of each exported leaf, joined along its
    kv-heads dim in rank order (a collective over ``group``: every rank
    calls it with the same block count)."""
    from ..parallel.collectives import all_gather_rows

    return [all_gather_rows(x.movedim(d, 0).contiguous(), group.group)
            .movedim(0, d).contiguous() for x, d in zip(leaves, dims)]


def local_heads(leaves: list, dims: list[int], group) -> list:
    """This rank's slice of each full-head leaf (an import's)."""
    out = []
    for x, d in zip(leaves, dims):
        step = x.shape[d] // group.size
        out.append(x.narrow(d, group.rank * step, step))
    return out
