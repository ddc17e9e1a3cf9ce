"""Logical-axis sharding rules and the port's parallel layout.

``LOGICAL_RULES`` and ``rules_for_mesh`` are ``kubeflow_tpu/parallel/
sharding.py``'s, copied as they are: model-space axis names ("embed",
"heads", "mlp", "vocab", "expert", ...) map to mesh axes, and a rule whose
mesh axis is absent melts into replication. ``PARAM_AXES`` gives each port
parameter the logical names the reference's ``nn.with_logical_partitioning``
calls give its leaf, and ``param_shardings`` turns them into one placement
per mesh dimension (``Shard(dim)`` or ``Replicate()``).

``shard_model`` lays a ``Llama`` out on a ``DeviceMesh`` by those rules:

- ``model`` (tensor parallelism): each rank keeps its slice of every
  parameter the rules shard over ``model`` (heads, kv heads, mlp, vocab);
  the model's projections then run column- and row-parallel
  (``models/llama.py``);
- ``expert``: each rank keeps ``e / d`` experts (``models/moe.py`` sends
  tokens to them by ``ragged_all_to_all``, or its capacity slots by
  ``all_to_all``);
- ``fsdp``: FSDP2 ``fully_shard`` on every ``Block`` and at the root, each
  parameter sharded on the dim its ``fsdp`` rule names; with a ``data``
  axis too, HSDP on the 2-D (data, fsdp) mesh. Beside a ``pipeline`` axis
  the schedules run the embedding, the stage's blocks and the head outside
  the root module's forward, where FSDP2's hooks would gather them, so
  there the root is the one FSDP2 unit: its shards are what a rank holds
  between steps, and the trainer gathers the stage whole around each step
  and averages its gradients over the FSDP2 dims once, after the last
  microbatch (``Layout.gathered``);
- ``seq`` (sequence parallelism): parameters are replicated; each rank
  holds one block of every row's sequence (``mesh.seq_slice``) and the
  model's attention runs ``parallel/ring_attention.py`` over the axis;
- ``pipeline``: the ``("layers", "pipeline")`` rule: each rank holds its
  stage of the block stack (``llama.StageLayers``), contiguous, or under
  interleaving its model chunks ``{d, P+d, ...}``
  (``pipeline.interleave_permutation``); the embedding and the head are
  replicated and ``parallel/pipeline.py`` runs the schedules;
- the batch axes FSDP2 does not cover (``data`` without ``fsdp``,
  ``expert``, ``replica``) and ``seq`` sum each gradient over the ranks
  that hold the parameter whole (``Layout.sync_grads``), and ``pipeline``
  sums the gradients of what it replicates (each is nonzero on one stage).

Every rank's loss is the mean over its own rows (and sequence block), so
the synced gradient is the mean over the batch shards and sequence blocks:
the gradient of the global batch's loss. ``reshard_plan`` keeps the
reference's JSON entries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional, Sequence

from .mesh import BATCH_AXES, MeshPlanError, active_mesh

#: logical axis -> mesh axis (or tuple of mesh axes) the data rides.
#: Entries referencing mesh axes absent from the actual mesh are dropped at
#: lookup time, which is what makes one table serve every parallelism mix.
LOGICAL_RULES: tuple[tuple[str, Any], ...] = (
    # -- activations ----------------------------------------------------
    # expert doubles as a data axis outside MoE layers (GShard convention)
    ("batch", ("replica", "data", "fsdp", "expert")),
    # batch dim INSIDE expert groups (the expert axis is spent on the
    # expert dim there, so it must not reappear on batch)
    ("expert_batch", ("replica", "data", "fsdp")),
    ("act_seq", "seq"),                      # sequence dim under SP/CP
    ("act_embed", None),                     # residual stream feature dim
    ("act_heads", "model"),                  # per-head activations under TP
    ("act_kv_heads", "model"),
    ("act_mlp", "model"),                    # mlp hidden activations under TP
    ("act_vocab", "model"),                  # logits vocab dim under TP
    # -- parameters -----------------------------------------------------
    ("embed", "fsdp"),                       # ZeRO-3 shard of the feature dim
    ("vocab", "model"),                      # embedding/unembedding vocab dim
    ("heads", "model"),                      # attention heads under TP
    ("kv_heads", "model"),
    ("head_dim", None),
    ("mlp", "model"),                        # ffn hidden dim under TP
    ("layers", "pipeline"),                  # scanned layer stack
    ("norm", None),
    ("expert", "expert"),                    # MoE expert dim (params + groups)
    ("expert_dim", None),                    # router logits output dim
)

#: the mesh axes whose shards ``shard_model`` cuts out of each parameter
#: itself (FSDP2 shards ``fsdp``)
MANUAL_AXES = ("model", "expert")

#: (in axes, out axes) of each Einsum projection, the reference's
#: ``Einsum(..., logical_axes)`` of ``models/llama.py``
_PROJECTION_AXES = {
    "wq": (("embed",), ("heads", "head_dim")),
    "wk": (("embed",), ("kv_heads", "head_dim")),
    "wv": (("embed",), ("kv_heads", "head_dim")),
    "wo": (("heads", "head_dim"), ("embed",)),
    "w_gate": (("embed",), ("mlp",)),
    "w_up": (("embed",), ("mlp",)),
    "w_down": (("mlp",), ("embed",)),
}

#: the reference's ``models/moe.py`` leaves
_MOE_AXES = {
    "router": ("embed", "expert_dim"),
    "w_gate": ("expert", "embed", "mlp"),
    "w_up": ("expert", "embed", "mlp"),
    "w_down": ("expert", "mlp", "embed"),
}

PARAM_AXES = {
    "embedder.embedding": ("vocab", "embed"),
    "head.unembedding": ("embed", "vocab"),
    "head.unembedding_scale": ("vocab",),
    "norm.scale": ("norm",),
}


def param_axes(key: str, moe: bool = False) -> tuple[str, ...]:
    """The logical axis names of port parameter ``key`` (a ``Llama``
    state dict key): a kernel's, its int8 ``_scale`` (the out axes) and
    its LoRA ``_lora_a`` (in axes + "lora") and ``_lora_b``."""
    if key in PARAM_AXES:
        return PARAM_AXES[key]
    if key.endswith("norm.scale"):
        return PARAM_AXES["norm.scale"]
    mod, _, name = key.rpartition(".")
    if moe and mod.endswith(".mlp"):
        return _MOE_AXES[name]
    for suffix in ("_lora_a", "_lora_b", "_scale"):
        if name.endswith(suffix) and name[:-len(suffix)] in _PROJECTION_AXES:
            ins, outs = _PROJECTION_AXES[name[:-len(suffix)]]
            return {"_lora_a": (*ins, "lora"), "_lora_b": ("lora", *outs),
                    "_scale": outs}[suffix]
    ins, outs = _PROJECTION_AXES[name]
    return (*ins, *outs)


def mesh_axes(mesh) -> dict[str, int]:
    """{axis: size} of a ``DeviceMesh``, a ``MeshPlan``, a jax ``Mesh`` or
    an axis dict."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if hasattr(mesh, "axes") and isinstance(mesh.axes, dict):
        return dict(mesh.axes)
    if hasattr(mesh, "axis_names"):
        return dict(mesh.shape)
    return dict(mesh)


def rules_for_mesh(
    mesh, overrides: Optional[Sequence[tuple[str, Any]]] = None
) -> tuple[tuple[str, Any], ...]:
    """LOGICAL_RULES restricted to axes that exist in ``mesh``.

    A rule whose mesh axis is absent degrades to replication for that logical
    axis — e.g. on a pure-DP mesh every parameter rule melts away and the
    model is replicated, with zero model-code changes.
    """
    present = set(mesh_axes(mesh))

    def keep(target: Any) -> Any:
        if target is None:
            return None
        if isinstance(target, str):
            return target if target in present else None
        kept = tuple(t for t in target if t in present)
        return kept if kept else None

    merged: dict[str, Any] = {name: keep(t) for name, t in LOGICAL_RULES}
    for name, t in overrides or ():
        merged[name] = keep(t)
    return tuple(merged.items())


@dataclasses.dataclass(frozen=True)
class ParamSharding:
    """One parameter's layout: for each mesh dimension (``axes``, sizes
    ``shape``), the tensor dim it shards, or None (replicated)."""

    axes: tuple[str, ...]
    shape: tuple[int, ...]
    dims: tuple[Optional[int], ...]

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        return tuple(Replicate() if d is None else Shard(d)
                     for d in self.dims)

    def dim_of(self, axis: str) -> Optional[int]:
        return (self.dims[self.axes.index(axis)] if axis in self.axes
                else None)

    def shard_count(self, dim: int) -> int:
        """How many ways tensor dim ``dim`` splits."""
        return math.prod(s for s, d in zip(self.shape, self.dims) if d == dim)

    def spec(self, ndim: int) -> list:
        """The reference's JSON form: per tensor dim None, the mesh axis,
        or the list of mesh axes."""
        out: list = []
        for dim in range(ndim):
            names = [a for a, d in zip(self.axes, self.dims) if d == dim]
            out.append(None if not names else names[0] if len(names) == 1
                       else names)
        return out


def _placement_dims(logical: Sequence[str], rules) -> dict[str, int]:
    """{mesh axis: tensor dim} of a leaf's logical names under ``rules``."""
    table = dict(rules)
    out: dict[str, int] = {}
    for dim, name in enumerate(logical):
        target = table.get(name)
        for axis in ((target,) if isinstance(target, str) else target or ()):
            out.setdefault(axis, dim)
    return out


def param_shardings(params, mesh, moe: bool = False,
                    overrides=None) -> dict[str, ParamSharding]:
    """{key: ParamSharding} of a state dict (or any ``{key: tensor}``,
    or a ``Llama``) on ``mesh`` by the logical rules. ``moe``: the model's
    MLPs are ``MoeMlp``s (a ``Llama`` says so itself)."""
    if hasattr(params, "cfg") and hasattr(params, "state_dict"):
        moe = params.cfg.moe_experts > 0
        params = dict(params.named_parameters())
    axes = mesh_axes(mesh)
    rules = rules_for_mesh(axes, overrides)
    names, shape = tuple(axes), tuple(axes.values())
    out = {}
    for key in params:
        dims = _placement_dims(param_axes(key, moe), rules)
        out[key] = ParamSharding(names, shape,
                                 tuple(dims.get(a) for a in names))
    return out


class shard_context:
    """Makes ``mesh`` the active mesh (``mesh.current_mesh``) for the
    functions that look it up when no mesh is passed, as the reference's
    context does: ``ring_attention``, ``ulysses_attention`` and the
    pipeline schedules (a laid-out model passes its axis groups itself)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._ctx = active_mesh(mesh)

    def __enter__(self):
        return self._ctx.__enter__()

    def __exit__(self, *exc) -> None:
        self._ctx.__exit__(*exc)


def reshard_plan(params, src_shardings, dst_shardings) -> list[dict]:
    """Per-leaf repartition plan for moving a weight tree between two mesh
    layouts: each entry records the leaf's path, shape, dtype and its
    source/destination spec as plain JSON values. Its consumer is the gang
    resizer's reshard wire (``serving/resize.py``). ``src_shardings`` /
    ``dst_shardings`` are ``param_shardings`` results (a missing entry or
    None = replicated).

    Validates feasibility up front: a destination that does not divide the
    leaf's dim (e.g. 8 heads onto a TP=3 mesh) raises ValueError naming the
    leaf, before anything is moved."""
    plan: list[dict] = []
    for name, leaf in params.items():
        shape = tuple(int(d) for d in getattr(leaf, "shape", ()))
        src = (src_shardings or {}).get(name)
        dst = (dst_shardings or {}).get(name)
        for dim, size in enumerate(shape):
            n = dst.shard_count(dim) if dst is not None else 1
            if n > 1 and size % n:
                raise ValueError(
                    f"reshard_plan: leaf {name!r} dim {dim} (size {size}) "
                    f"does not divide into {n} destination shards — the "
                    "target degree is illegal for this model")
        dtype = getattr(leaf, "dtype", None)
        plan.append({
            "path": name,
            "shape": list(shape),
            "dtype": str(dtype).removeprefix("torch."),
            "src": src.spec(len(shape)) if src else [None] * len(shape),
            "dst": dst.spec(len(shape)) if dst else [None] * len(shape),
        })
    return plan


# -- the layout of a model on a mesh -----------------------------------------


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """A mesh axis (or several together) as the model code uses it: the
    process group, its size and this rank's index in it."""

    group: Any
    size: int
    rank: int


def axis_group(mesh, name: str) -> Optional[AxisGroup]:
    """Mesh axis ``name`` of ``mesh`` (a ``DeviceMesh``; by default
    ``mesh.current_mesh()``) as an ``AxisGroup``, or None when it has one
    rank; an ``AxisGroup`` passed as ``mesh`` is that axis already."""
    from .mesh import axis_index, axis_size, current_mesh

    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or isinstance(mesh, AxisGroup):
        return mesh
    if axis_size(mesh, name) == 1:
        return None
    return AxisGroup(mesh.get_group(name), axis_size(mesh, name),
                     axis_index(mesh, name))


def _axis_group(mesh, dims: Sequence[str]) -> Optional[AxisGroup]:
    """The group of ``dims`` together, or None when it has one rank."""
    import torch.distributed as dist

    from .collectives import subgroup

    dims = [d for d in dims if d in mesh.mesh_dim_names]
    size = math.prod(mesh.size(mesh.mesh_dim_names.index(d)) for d in dims)
    if size == 1:
        return None
    group = subgroup(mesh, dims)
    return AxisGroup(group, size, dist.get_rank(group))


def _shard_slice(t, dim: int, parts: int, index: int):
    size = t.shape[dim]
    if size % parts:
        raise MeshPlanError(
            f"dim {dim} of size {size} does not split into {parts} shards")
    step = size // parts
    return t.narrow(dim, index * step, step)


class Layout:
    """A ``Llama`` laid out on a mesh (``shard_model``): what the trainer,
    the optimizer and checkpoints need to know of it."""

    def __init__(self, model, mesh):
        from .mesh import axis_size

        self.model, self.mesh = model, mesh
        self.cfg = model.cfg
        self.axes = mesh_axes(mesh)
        full = dict(model.named_parameters())
        #: the unsharded shape of every parameter, in the whole model's order
        self.full_shapes = {k: tuple(p.shape) for k, p in full.items()}
        #: the global indices of the blocks this rank holds (all of them
        #: without a ``pipeline`` axis)
        self.stage = list(range(self.cfg.num_layers))
        self.shardings = param_shardings(full, self.axes,
                                         moe=self.cfg.moe_experts > 0)
        present = [a for a in self.axes if a in BATCH_AXES]
        fsdp = "fsdp" in self.axes
        #: the mesh dims FSDP2 shards and replicates over
        self.fsdp_dims: tuple[str, ...] = ()
        if fsdp:
            self.fsdp_dims = (("data", "fsdp") if "data" in self.axes
                              and "replica" not in self.axes else ("fsdp",))
        #: the dims whose gradient sum ``sync_grads`` makes: the batch dims
        #: FSDP2 does not cover, ``seq``, and ``pipeline`` (a sum, not a
        #: mean: a replicated parameter's gradient is one stage's)
        self.sync_dims = tuple(
            a for a in self.axes if a in ("seq", "pipeline")
            or (a in present and a not in self.fsdp_dims))
        self.sync_divisor = math.prod(axis_size(mesh, a)
                                      for a in self.sync_dims
                                      if a != "pipeline")
        #: ``pipeline`` beside FSDP2: the trainer runs each step on the
        #: stage gathered whole (``gathered``)
        self.gathers = bool(self.fsdp_dims) and self.axes.get(
            "pipeline", 1) > 1
        self._groups: dict = {}

    # -- placements ------------------------------------------------------

    def sharded_over(self, key: str) -> set[str]:
        """The mesh dims parameter ``key``'s shards differ over: its
        manual ones, under FSDP2 ``fsdp``, and ``pipeline`` for a block's."""
        s = self.shardings[key]
        dims = {a for a in MANUAL_AXES if s.dim_of(a) is not None}
        if self.fsdp_dims:
            dims.add("fsdp")
        if "pipeline" in self.axes and key.startswith("layers."):
            dims.add("pipeline")
        return dims

    def fsdp_dim(self, key: str) -> Optional[int]:
        """The dim FSDP2 shards parameter ``key`` on: its ``fsdp`` rule's,
        dim 0 when it has none (None without FSDP2)."""
        if not self.fsdp_dims:
            return None
        dim = self.shardings[key].dim_of("fsdp")
        return 0 if dim is None else dim

    def cut_axes(self, key: str) -> dict[int, tuple[str, ...]]:
        """{dim: the mesh dims that split it} of parameter ``key`` on this
        layout: its manual ``model``/``expert`` dims and FSDP2's (dims of
        one rank split nothing)."""
        s = self.shardings[key]
        out: dict[int, list] = {}
        for axis in MANUAL_AXES:
            dim = s.dim_of(axis)
            if dim is not None and self.axes.get(axis, 1) > 1:
                out.setdefault(dim, []).append(axis)
        dim = self.fsdp_dim(key)
        if dim is not None and self.axes.get("fsdp", 1) > 1:
            out.setdefault(dim, []).append("fsdp")
        return {d: tuple(a) for d, a in out.items()}

    def replication(self, key: str) -> int:
        """How many ranks hold each element of ``key``."""
        over = self.sharded_over(key)
        return math.prod(s for a, s in self.axes.items() if a not in over)

    def group(self, dims: Sequence[str]) -> Optional[AxisGroup]:
        """The ``AxisGroup`` of mesh dims ``dims`` together (None for one
        rank), made once per layout."""
        key = tuple(dims)
        if key not in self._groups:
            self._groups[key] = _axis_group(self.mesh, key)
        return self._groups[key]

    # -- full <-> local --------------------------------------------------

    def local_slice(self, key: str, full, drop: Optional[int] = None):
        """This rank's manual shard of a full tensor of ``key`` (before
        FSDP2's own). ``drop``: the tensor is ``key``'s with that dim
        reduced away (an optimizer statistic), whole over whatever split
        it."""
        from .mesh import axis_index, axis_size

        s = self.shardings[key]
        for axis in MANUAL_AXES:
            dim = _after_drop(s.dim_of(axis), drop)
            if dim is not None and axis_size(self.mesh, axis) > 1:
                full = _shard_slice(full, dim, axis_size(self.mesh, axis),
                                    axis_index(self.mesh, axis))
        return full

    def gather_full(self, key: str, local, like=None,
                    drop: Optional[int] = None):
        """The full tensor of ``key`` from every rank's ``local`` shard
        (a DTensor parameter's or a plain tensor laid out as parameter
        ``like``; with ``drop``, as ``local_slice`` lays it out); every
        rank of the group gets it."""
        import torch
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        if isinstance(local, DTensor):
            local = _full_of(local.to_local(), local.device_mesh,
                             local.placements, tuple(local.shape))
        elif like is not None and isinstance(like, DTensor):
            shape = tuple(like.shape)
            if drop is not None:
                shape = shape[:drop] + shape[drop + 1:]
            local = _full_of(local, like.device_mesh,
                             _drop_placements(like, drop), shape)
        s = self.shardings[key]
        for axis in reversed(MANUAL_AXES):
            dim = _after_drop(s.dim_of(axis), drop)
            g = self.group((axis,))
            if dim is None or g is None:
                continue
            parts = [torch.empty_like(local) for _ in range(g.size)]
            dist.all_gather(parts, local.contiguous(), group=g.group)
            local = torch.cat(parts, dim=dim)
        return local

    def to_param_layout(self, key: str, full, param,
                        drop: Optional[int] = None):
        """``full`` as ``param`` holds it on this rank (manual slice, then
        FSDP2's shard): the local tensor (``drop``: as ``local_slice``)."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        local = self.local_slice(key, full, drop).to(param.device,
                                                     param.dtype)
        if isinstance(param, DTensor):
            local = distribute_tensor(local, param.device_mesh,
                                      _drop_placements(param, drop)
                                      ).to_local()
        return local

    def load_full_state_dict(self, sd: dict) -> None:
        """Copy a full (unsharded) state dict into the sharded model."""
        missing = set(self.full_shapes) - set(sd)
        if missing:
            raise ValueError(f"state dict does not match the model: missing "
                             f"{sorted(missing)}")
        self.load_full_params(sd)

    def load_full_params(self, sd: dict) -> None:
        """Copy full (unsharded) parameters, some or all of the model's,
        into their shards (those of the blocks another pipeline stage
        holds are passed over)."""
        import torch

        params = dict(self.model.named_parameters())
        extra = set(sd) - set(self.full_shapes)
        if extra:
            raise ValueError(f"state dict does not match the model: "
                             f"unexpected {sorted(extra)}")
        with torch.no_grad():
            for key, full in sd.items():
                if tuple(full.shape) != self.full_shapes[key]:
                    raise ValueError(
                        f"{key}: shape {tuple(full.shape)} != "
                        f"{self.full_shapes[key]}")
                if key in params:
                    p = params[key]
                    _local(p).copy_(self.to_param_layout(key, full, p))

    def full_state_dict(self) -> dict:
        """Every parameter unsharded, on the CPU, in the whole model's
        order (every rank joins)."""
        return self.all_stages({k: self.gather_full(k, p.detach()).cpu()
                                for k, p in self.model.named_parameters()})

    def all_stages(self, part: dict) -> dict:
        """``part`` ({key: CPU tensor} of this rank's parameters) joined
        with every other pipeline stage's, in the whole model's key order
        (every rank joins; ``part`` itself without a ``pipeline`` axis)."""
        import torch.distributed as dist

        g = self.group(("pipeline",)) if "pipeline" in self.axes else None
        if g is None:
            return part
        parts: list = [None] * g.size
        dist.all_gather_object(parts, part, group=g.group)
        merged = {k: v for p in parts for k, v in p.items()}
        return {k: merged[k] for k in self.full_shapes if k in merged}

    # -- gradients -------------------------------------------------------

    def sync_grads(self, params) -> None:
        """Sum each gradient over the ``sync_dims`` across the ranks that
        hold its parameter whole, and divide by their size but
        ``pipeline``'s: with FSDP2's mean over its own dims, the mean over
        every batch shard and sequence block. A parameter with no gradient
        (the head on a stage that ran no loss) takes zeros first."""
        import torch
        import torch.distributed as dist

        if not self.sync_dims:
            return
        names = {id(p): k for k, p in self.model.named_parameters()}
        buckets: dict[tuple, list] = {}
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            over = self.sharded_over(names[id(p)])
            dims = tuple(a for a in self.sync_dims if a not in over)
            buckets.setdefault(dims, []).append(_local(p.grad))
        for dims, grads in buckets.items():
            g = self.group(dims) if dims else None
            if g is not None:
                flat = torch.cat([t.reshape(-1) for t in grads])
                dist.all_reduce(flat, group=g.group)
                pos = 0
                for t in grads:
                    t.copy_(flat[pos:pos + t.numel()].view_as(t))
                    pos += t.numel()
            if self.sync_divisor > 1:
                for t in grads:
                    t.div_(self.sync_divisor)

    @contextlib.contextmanager
    def gathered(self):
        """Under ``pipeline`` beside FSDP2 (``gathers``), one step's
        forward and backward passes on the stage whole: every FSDP2 shard
        is all-gathered into a plain parameter in its module, and on exit
        each gradient is averaged over the FSDP2 dims (FSDP2's own mean)
        once, after the last microbatch: reduce-scattered straight into
        its shard (``_grad_shard_of``), which becomes the sharded
        parameter's ``.grad``, and the whole gradient dropped. Elsewhere
        it does nothing."""
        if not self.gathers:
            yield
            return
        import torch
        from torch import nn
        from torch.distributed.tensor import DTensor

        held = []
        with torch.no_grad():
            for key, p in list(self.model.named_parameters()):
                mod_name, _, leaf = key.rpartition(".")
                mod = self.model.get_submodule(mod_name)
                whole = nn.Parameter(
                    _full_of(p.to_local(), p.device_mesh, p.placements,
                             tuple(p.shape)), requires_grad=p.requires_grad)
                held.append((mod, leaf, p, whole))
                setattr(mod, leaf, whole)
        try:
            yield
            with torch.no_grad():
                for _, _, p, w in held:
                    if not p.requires_grad:
                        continue
                    grad = (w.grad if w.grad is not None
                            else torch.zeros_like(w))
                    w.grad = None
                    shard = DTensor.from_local(
                        _grad_shard_of(grad, p), p.device_mesh,
                        p.placements, shape=p.shape, stride=p.stride())
                    p.grad = shard if p.grad is None else p.grad + shard
        finally:
            for mod, leaf, p, _ in held:
                setattr(mod, leaf, p)

    def norm_weights(self, params) -> list[float]:
        """1 / replication of each parameter: the weight of its local
        squared gradient in a global-norm sum over the world."""
        names = {id(p): k for k, p in self.model.named_parameters()}
        return [1.0 / self.replication(names[id(p)]) for p in params]


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _after_drop(dim: Optional[int], drop: Optional[int]) -> Optional[int]:
    """Tensor dim ``dim`` once dim ``drop`` is reduced away (None: gone,
    or no dim)."""
    if dim is None or drop is None:
        return dim
    return None if dim == drop else dim - (dim > drop)


def _drop_placements(dtensor, drop: Optional[int]) -> tuple:
    """``dtensor``'s placements for its tensor with dim ``drop`` reduced
    away: a shard of that dim becomes a replica."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for pl in dtensor.placements:
        if drop is None or not pl.is_shard():
            out.append(pl)
        else:
            dim = _after_drop(pl.dim, drop)
            out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def _full_of(local, mesh, placements, shape):
    """The whole tensor (``shape``) of this rank's ``local`` shard laid
    out by ``placements`` over ``mesh``: each sharded mesh dim gathered by
    ``all_gather_into_tensor`` over its group, ``torch.chunk``'s short or
    missing last chunks padded, as FSDP2 gathers. (DTensor's own
    ``full_tensor`` goes through the functional all-gather, which crashes
    on a CUDA tensor over gloo.)"""
    import torch
    import torch.distributed as dist

    for i in reversed(range(len(placements))):
        pl = placements[i]
        if not pl.is_shard():
            continue
        n, size = mesh.size(i), shape[pl.dim]
        chunk = -(-size // n)
        x = local.movedim(pl.dim, 0)
        if x.shape[0] < chunk:
            x = torch.cat([x, x.new_zeros((chunk - x.shape[0],
                                           *x.shape[1:]))])
        out = x.new_empty((n * chunk, *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=mesh.get_group(i))
        local = out[:size].movedim(0, pl.dim)
    return local.contiguous()


def _grad_shard_of(full, like):
    """This rank's shard (as DTensor ``like`` places it) of the mean over
    ``like``'s mesh of every rank's ``full`` gradient: a reduce-scatter
    over each sharded mesh dim, the chunks padded to ``torch.chunk``'s
    size as ``_full_of`` pads them, and an all-reduce over each
    replicated one (HSDP's)."""
    import torch
    import torch.distributed as dist

    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    out = full
    for i, pl in enumerate(like.placements):
        group = mesh.get_group(i)
        if not pl.is_shard():
            out = out.contiguous()
            dist.all_reduce(out, group=group)
            continue
        n, size = mesh.size(i), out.shape[pl.dim]
        chunk = -(-size // n)
        x = out.movedim(pl.dim, 0)
        if n * chunk > size:
            x = torch.cat([x, x.new_zeros((n * chunk - size,
                                           *x.shape[1:]))])
        mine = x.new_empty((chunk, *x.shape[1:]))
        dist.reduce_scatter_tensor(mine, x.contiguous(), group=group)
        keep = max(0, min(chunk, size - coord[i] * chunk))
        out = mine[:keep].movedim(0, pl.dim)
    return (out / mesh.size()).contiguous()


def shard_model(model, mesh, interleave: int = 1,
                serving: bool = False) -> Layout:
    """Lay ``model`` (a ``Llama`` holding full parameters, or on the meta
    device) out on ``mesh`` in place: this rank's pipeline stage (its model
    chunks under ``interleave`` > 1), manual ``model``/``expert`` shards,
    the ``seq`` axis on the attention, then FSDP2 over ``fsdp`` (HSDP with
    ``data``). Returns its ``Layout``.

    A ``seq`` axis needs ``attention_impl="ring"``. LoRA adapters and
    int8 weights follow their kernel (``param_axes``: an adapter's ``lora``
    dim and the factor beside the split one are whole on every rank of the
    ``model`` group), as do the MoE dispatches under ``expert``.

    ``serving``: the layout of a serving gang, whose every rank replays
    the same host inputs, so no axis shards the rows: each ``MoeMlp``
    takes no batch group (its balancing loss is its own rows') and, under
    ``expert``, runs its experts over all of them and sums its partial
    output over the ``expert`` x ``model`` ranks (``MoeMlp.sum_group``)
    instead of exchanging rows."""
    import torch
    from torch import nn

    from ..models.llama import Attention, Embedder, Head, Mlp, StageLayers
    from ..models.moe import MoeMlp
    from .mesh import axis_index, axis_size

    cfg = model.cfg
    if axis_size(mesh, "seq") > 1 and cfg.attention_impl != "ring":
        raise ValueError(
            f"a 'seq' mesh axis needs attention_impl='ring', not "
            f"{cfg.attention_impl!r}: each rank holds one block of the "
            "sequence")
    layout = Layout(model, mesh)
    stages = axis_size(mesh, "pipeline")
    if stages > 1:
        from .pipeline import interleave_permutation

        order = interleave_permutation(cfg.num_layers, stages, interleave)
        per = cfg.num_layers // stages
        d = axis_index(mesh, "pipeline")
        layout.stage = [int(i) for i in order[d * per:(d + 1) * per]]
        model.layers = StageLayers(
            {i: model.layers[i] for i in layout.stage})
        model.pipe = layout.group(("pipeline",))
    if axis_size(mesh, "expert") > 1 and cfg.moe_experts % axis_size(
            mesh, "expert"):
        raise MeshPlanError(
            f"{cfg.moe_experts} experts not divisible by expert axis "
            f"{axis_size(mesh, 'expert')}")
    with torch.no_grad():
        for key, p in list(model.named_parameters()):
            local = layout.local_slice(key, p.detach())
            if local.shape != p.shape:
                mod_name, _, leaf = key.rpartition(".")
                mod = model.get_submodule(mod_name)
                setattr(mod, leaf, nn.Parameter(
                    local.clone(), requires_grad=p.requires_grad))
    tp_group = layout.group(("model",))
    ep_group = layout.group(("expert",))
    seq_group = layout.group(("seq",))
    # the tokens a balancing loss is taken over: every batch shard's and
    # sequence block's
    batch_group = (None if serving else layout.group(
        [a for a in layout.axes if a in BATCH_AXES or a == "seq"]))
    sum_group = (layout.group(("expert", "model"))
                 if serving and ep_group is not None else None)
    model.seq = seq_group
    for mod in model.modules():
        if isinstance(mod, (Attention, Mlp, Embedder, Head)):
            mod.tp = tp_group
        if isinstance(mod, Attention):
            mod.seq = seq_group
        if isinstance(mod, MoeMlp):
            mod.tp, mod.ep, mod.batch = tp_group, ep_group, batch_group
            mod.sum_group = sum_group
    if layout.fsdp_dims:
        _fully_shard(model, layout)
    model.layout = layout
    return layout


def _fully_shard(model, layout: Layout) -> None:
    """FSDP2 on every Block and at the root, each parameter sharded on
    ``Layout.fsdp_dim``; beside a ``pipeline`` axis at the root only
    (``Layout.gathered``: the schedules never run the root's forward, so
    FSDP2's hooks never gather a block there)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    mesh = layout.mesh
    dp = (mesh[layout.fsdp_dims] if len(layout.fsdp_dims) > 1
          else mesh[layout.fsdp_dims[0]])
    names = {id(p): k for k, p in model.named_parameters()}

    def placement(p):
        return Shard(layout.fsdp_dim(names[id(p)]))

    if not layout.gathers:
        for blk in model.layers:
            fully_shard(blk, mesh=dp, shard_placement_fn=placement)
    fully_shard(model, mesh=dp, shard_placement_fn=placement)
