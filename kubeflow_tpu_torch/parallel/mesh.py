"""Named-axis device mesh over the job's processes: the port of
``kubeflow_tpu/parallel/mesh.py``.

The axis vocabulary, the placement rule and ``plan_mesh`` are the
reference's, copied as they are (pure Python): ``replica``, ``data``,
``fsdp``, ``pipeline``, ``expert``, ``seq``, ``model``, outermost first; the
DCN-tolerant axes (``replica``, ``pipeline``, ``data``) may cross slice
boundaries, the bandwidth-hungry ones must not.

``build_mesh`` makes the plan a ``torch.distributed.device_mesh.DeviceMesh``
over the world's ranks, one process per device: rank ``r`` is device ``r``
of the row-major mesh, and with ``num_slices > 1`` the rank array is laid
out DCN-outermost by hand, as the reference lays out its CPU devices. The
port runs one process a card (a pod of k cards runs k processes,
``runtime/pod_main``), so a mesh of more devices than the process group
has processes is refused: where the reference drives several devices from
one process, the port's group has a process for each.

The batch of a step is split over the ``BATCH_AXES`` present: each rank
holds the rows of its coordinate on those axes (``batch_sharding``), so the
ranks of one ``model``, ``seq`` or ``pipeline`` group share their rows; a
``seq`` axis splits each row's sequence into blocks (``seq_slice``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

#: Canonical mesh-axis order, outermost (most DCN-tolerant) first.
AXIS_ORDER = ("replica", "data", "fsdp", "pipeline", "expert", "seq", "model")

#: Axes whose collectives amortize well over slow links (DCN).
DCN_TOLERANT_AXES = ("replica", "pipeline", "data")

#: Axes that shard the batch dimension (their product is the data-parallel
#: degree for input pipelines and loss scaling).  ``expert`` doubles as a
#: data axis outside MoE layers (the GShard convention: EP groups share
#: DP), which is what makes the MoE dispatch a true all-to-all instead of
#: a batch replication.
BATCH_AXES = ("replica", "data", "fsdp", "expert")


class MeshPlanError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A validated axis->size assignment plus its ICI/DCN split."""

    axes: dict[str, int]
    ici_axes: dict[str, int]
    dcn_axes: dict[str, int]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.axes.values())

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def batch_degree(self) -> int:
        return math.prod(s for a, s in self.axes.items() if a in BATCH_AXES)


def _ordered(axes: dict[str, int]) -> dict[str, int]:
    unknown = [a for a in axes if a not in AXIS_ORDER]
    if unknown:
        raise MeshPlanError(f"unknown mesh axes {unknown}; known: {AXIS_ORDER}")
    return {a: axes[a] for a in AXIS_ORDER if a in axes}


def plan_mesh(
    axes: dict[str, int],
    num_devices: Optional[int] = None,
    num_slices: int = 1,
) -> MeshPlan:
    """Validate axis sizes against the device count and split ICI vs DCN.

    With ``num_slices > 1`` the outermost axes (in canonical order) are
    assigned to DCN until the per-slice product fits one slice; a
    bandwidth-hungry axis landing on DCN is an error, not a warning —
    mis-placement silently destroys step time, so it must not compile.
    """
    axes = _ordered({a: s for a, s in axes.items() if s != 1} or {"data": 1})
    total = math.prod(axes.values())
    if num_devices is not None and total != num_devices:
        raise MeshPlanError(f"mesh {axes} needs {total} devices, have {num_devices}")
    ici: dict[str, int] = dict(axes)
    dcn: dict[str, int] = {}
    if num_slices > 1:
        remaining = num_slices
        # factor slices onto DCN-tolerant axes FIRST: {pipeline: 2, fsdp: 16}
        # on 2 slices must put pipeline (not fsdp) over DCN even though fsdp
        # precedes it in canonical mesh order
        order = [a for a in axes if a in DCN_TOLERANT_AXES] + [
            a for a in axes if a not in DCN_TOLERANT_AXES]
        for a in order:
            if remaining == 1:
                break
            s = axes[a]
            take = math.gcd(s, remaining)
            if take > 1:
                if a not in DCN_TOLERANT_AXES:
                    raise MeshPlanError(
                        f"axis {a!r} (size {s}) would span {take} slices over DCN; "
                        f"only {DCN_TOLERANT_AXES} may cross slice boundaries"
                    )
                dcn[a] = take
                ici[a] = s // take
                remaining //= take
        if remaining != 1:
            raise MeshPlanError(
                f"cannot factor {num_slices} slices into DCN-tolerant axes of {axes}"
            )
        ici = {a: s for a, s in ici.items() if s != 1}
    return MeshPlan(axes=axes, ici_axes=ici, dcn_axes=dcn)


def rank_layout(plan: MeshPlan) -> list:
    """The mesh's rank array (nested lists, ``plan.shape``): row-major, or
    with DCN factors, each axis's slice factor outermost (slice-major rank
    order), as the reference lays out devices without a ``slice_index``."""
    import numpy as np

    ranks = np.arange(plan.num_devices)
    if not plan.dcn_axes:
        # analysis: ok host-sync-in-dispatch — host topology math
        return ranks.reshape(plan.shape).tolist()
    n = len(plan.axis_names)
    per_slice = tuple(plan.ici_axes.get(a, 1) for a in plan.axis_names)
    dcn = tuple(plan.dcn_axes.get(a, 1) for a in plan.axis_names)
    arr = ranks.reshape(*dcn, *per_slice)
    order = [i for pair in ((k, k + n) for k in range(n)) for i in pair]
    # analysis: ok host-sync-in-dispatch — host topology math
    return arr.transpose(order).reshape(plan.shape).tolist()


def build_mesh(axes: dict[str, int], num_slices: int = 1,
               device_type: Optional[str] = None):
    """A ``DeviceMesh`` of the plan over the initialised process group's
    ranks, its dimensions named ``plan.axis_names``. ``device_type``
    defaults to ``cuda`` on an NCCL group and ``cpu`` otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialised process group "
                           "(runtime.bootstrap.initialize)")
    world = dist.get_world_size()
    total = math.prod(s for s in axes.values() if s != 1)
    if total > world:
        raise MeshPlanError(
            f"mesh {axes} needs {total} devices but the process group has "
            f"{world} processes: the port runs one process a card (a pod "
            "with k cards runs k processes)")
    plan = plan_mesh(axes, num_devices=world, num_slices=num_slices)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, rank_layout(plan),
                      mesh_dim_names=plan.axis_names)


_ACTIVE_MESH: list = []


class active_mesh:
    """Context manager making ``mesh`` discoverable by the functions that
    take no mesh: ``ring_attention``, ``ulysses_attention``, ``gpipe`` and
    ``one_f_one_b`` find it by ``current_mesh`` when none is passed, as the
    reference's do (a laid-out model passes the groups ``shard_model`` put
    on its modules instead)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _ACTIVE_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc) -> None:
        _ACTIVE_MESH.pop()


def current_mesh():
    """The innermost ``active_mesh``'s mesh, or None."""
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def axis_size(mesh, name: str) -> int:
    """Size of mesh axis ``name``; 1 when the mesh has no such axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 when absent)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in (mesh.mesh_dim_names or ()) if a in BATCH_AXES)


def batch_sharding(mesh) -> tuple[int, int]:
    """(this rank's batch shard, the number of shards): the batch dim split
    over every batch-like axis present, row-major over them. The ranks of
    a ``model`` group hold the same shard."""
    if mesh is None:
        return 0, 1
    index, count = 0, 1
    for a in batch_axes(mesh):
        index = index * axis_size(mesh, a) + axis_index(mesh, a)
        count *= axis_size(mesh, a)
    return index, count


def seq_slice(mesh, seq_len: int) -> slice:
    """This rank's block of a ``seq_len`` sequence (the ``act_seq`` rule):
    block ``i`` of the ``seq`` axis's ``n`` equal blocks; the whole of it
    with no ``seq`` axis. Raises when the blocks do not divide it."""
    n = axis_size(mesh, "seq")
    if seq_len % n:
        raise MeshPlanError(
            f"sequence length {seq_len} not divisible by the mesh's {n} "
            "sequence blocks")
    i, step = axis_index(mesh, "seq"), seq_len // n
    return slice(i * step, (i + 1) * step)


def local_batch_size(mesh, global_batch: int) -> int:
    """Rows of the global batch one rank holds; raises when the batch
    shards do not divide it."""
    n = batch_sharding(mesh)[1]
    if global_batch % n:
        raise MeshPlanError(
            f"global batch {global_batch} not divisible by the mesh's {n} "
            "batch shards")
    return global_batch // n
