"""The training loop of the port: the counterpart of
``kubeflow_tpu/train/trainer.py::Trainer``.

One step: next-token cross-entropy (f32, mean) of the model's logits on
``tokens[:, 1:]`` given ``tokens[:, :-1]`` (plus ``aux_loss_coef`` times the
MoE load-balancing loss averaged over layers, for an MoE model), backward
through the remat blocks, then the optax-exact clipped AdamW or Adafactor of
``optim.py``. With ``accum_steps`` > 1 the batch runs as that many
microbatches of the reference's strided rows (``i, accum+i, ...``): their
gradients sum in f32 and the sum and the loss are divided by ``accum``.

Fine-tuning: ``init_from`` loads a snapshot (``models/llama.py``
``load_pretrained``, this layout or a transformers one) before step 0, and a
newer checkpoint in ``checkpoint_dir`` wins (resume > init). With
``lora_rank`` > 0 the base is frozen (``requires_grad`` False, so no weight
gradient of it is computed): the optimizer and its clip norm cover the
adapters alone, as the reference's ``multi_transform`` does, and checkpoints
hold the adapters and their optimizer state only. The adapters start from
``np.random.RandomState(0)`` normal(0, 0.02) in the reference tree's sorted
path order, B zero, so both packages start from the same adapters.

Metering (tokens/s, MFU of the active FLOPs against the card's bf16 peak)
follows the reference: the host blocks on the device only at log
boundaries. SIGTERM saves a checkpoint and exits 143; the final step is
always saved; ``final_state`` holds the last state for the publish hook.

Sharded (``mesh_axes``, on an initialised process group, one device per
process; the reference's ``TrainConfig.mesh_axes`` and ``num_slices``): the
model is built on the meta device and laid out by ``parallel.sharding.
shard_model`` (tensor parallel over ``model``, expert parallel over
``expert``, FSDP2 over ``fsdp``, HSDP with ``data``), so each rank allocates
its shards only and the init draws one module at a time
(``Llama.init_streamed``); each rank steps on its rows of the global batch
(``batch_index``/``batch_count``, the mesh's batch axes), its gradients are
synced to the global batch's mean and AdamW updates the shards it holds
under the global norm. The loss and the metrics are global means, MFU
counts every rank's device, and checkpoints hold the full state in the
whole model's layer order, written once by rank 0 and restored onto any
mesh; a SIGTERM is read at the next log or checkpoint step, where every
rank stops. Every rank calls every public method (SPMD), as in the
reference.

A ``seq`` axis (sequence parallelism, ``attention_impl="ring"``): the
inputs and targets are shifted first, then each rank takes its sequence
block (``mesh.seq_slice``) and its rope positions from the block's offset;
the loss is the global token mean. A ``pipeline`` axis: each rank builds
and draws its stage only; ``pipeline_schedule="gpipe"`` runs the loss
through ``llama.pipelined_apply`` (``num_microbatches``, default the
degree) and ``"1f1b"`` through ``parallel.pipeline.one_f_one_b`` (the
embedding's backward after it, the head and the loss in its last stage;
``pipeline_interleave`` model chunks a rank), both composing with
``accum_steps``, tied embeddings and the MoE balancing loss
(``aux_loss_coef`` / (layers x microbatches) on each microbatch's sum).
Beside ``fsdp`` a stage is gathered whole for each step and its gradients
averaged over the FSDP2 dims once, after the last microbatch
(``Layout.gathered``). Adafactor runs on any of these layouts: each leaf's
factored axes are the unsharded tree's, its means and block sums
all-reduced over the ranks that split it (``optim.LeafCut``), and its
moments checkpoint whole.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import convert
from ..models import llama as llamalib
from ..parallel import mesh as meshlib
from ..parallel import sharding as shardlib
from . import checkpoint as ckptlib
from . import data as datalib
from .optim import Adafactor, AdamW, LeafCut

#: dense bf16 peak TFLOP/s by ``torch.cuda.get_device_name``, for MFU
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}

#: the architecture fields a snapshot and the model config must share
_ARCH_FIELDS = ("vocab_size", "hidden_size", "intermediate_size",
                "num_layers", "num_heads", "num_kv_heads", "head_dim",
                "tie_embeddings", "moe_experts")


@dataclasses.dataclass
class TrainConfig:
    model: llamalib.LlamaConfig = dataclasses.field(
        default_factory=llamalib.tiny)
    #: mesh axis -> size; {} = one process unsharded, or pure data
    #: parallelism over every process of an initialised group
    mesh_axes: dict[str, int] = dataclasses.field(default_factory=dict)
    num_slices: int = 1
    global_batch: int = 8
    seq_len: int = 128
    steps: int = 20
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    #: "adamw" (default) or "adafactor" (optax's, no weight decay)
    optimizer: str = "adamw"
    #: dtype of AdamW's first moment (None = the param dtype, f32)
    mu_dtype: Optional[torch.dtype] = torch.bfloat16
    #: weight of the MoE load-balancing loss (no effect on a dense model)
    aux_loss_coef: float = 0.01
    #: gradient accumulation: microbatches per global batch
    accum_steps: int = 1
    #: microbatches of the pipeline schedules on a ``pipeline`` axis
    #: (default: its degree); no effect without one
    num_microbatches: Optional[int] = None
    #: "gpipe" (a differentiable forward: every microbatch's stage input
    #: lives through the step) or "1f1b" (value and gradient in one pass,
    #: about P microbatches in flight)
    pipeline_schedule: str = "gpipe"
    #: model chunks a rank under "1f1b" (Megatron interleaving): chunk c on
    #: rank c % P, a shorter fill and drain
    pipeline_interleave: int = 1
    checkpoint_dir: Optional[str] = None
    save_interval_steps: int = 100
    #: snapshot directory to fine-tune from (``load_pretrained``)
    init_from: Optional[str] = None
    log_every: int = 10
    #: when set, a ``torch.profiler`` trace of steps [profile_start,
    #: profile_stop) is written into this directory (chrome trace JSON)
    profile_dir: Optional[str] = None
    profile_start: int = 3
    profile_stop: int = 6


@dataclasses.dataclass
class StepMetrics:
    step: int
    loss: float
    grad_norm: float
    step_time_s: float
    tokens_per_sec: float
    tokens_per_sec_per_chip: float
    mfu: float


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _from_rank0(value):
    """``value`` as rank 0 has it, on every rank (one process: itself)."""
    if _world() == 1:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _cross_entropy(logits, targets) -> torch.Tensor:
    """Mean next-token cross-entropy in f32."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None):
        self.cfg = cfg
        if cfg.optimizer not in ("adamw", "adafactor"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        if cfg.accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        if cfg.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"unknown pipeline_schedule {cfg.pipeline_schedule!r}")
        if cfg.pipeline_interleave < 1 or (cfg.num_microbatches or 1) < 1:
            raise ValueError(
                "pipeline_interleave and num_microbatches must be >= 1")
        if cfg.model.lora_rank > 0 and not cfg.init_from:
            # without a base snapshot the frozen base stays at random init
            raise ValueError(
                "lora_rank > 0 requires init_from: adapters train "
                "against a frozen base snapshot "
                "(TrainingClient.train(model=..., lora_rank=...))")
        self.device = resolve_device(device)
        self.mesh = self._plan_mesh()
        # on a mesh the full model is never held: it is laid out on the
        # meta device and each rank allocates its shards only
        self.model = llamalib.Llama(
            cfg.model, device=self.device if self.mesh is None else "meta")
        if cfg.model.lora_rank > 0:
            for name, p in self.model.named_parameters():
                p.requires_grad_(llamalib.is_lora_path(name))
        #: the model's layout on the mesh (None: one process, unsharded)
        self.layout = None
        if self.mesh is not None:
            self.layout = shardlib.shard_model(
                self.model, self.mesh,
                interleave=(cfg.pipeline_interleave
                            if cfg.pipeline_schedule == "1f1b" else 1))
            self.model.to_empty(device=self.device)
        #: this rank's shard of the global batch, and the shard count
        self.batch_index, self.batch_count = meshlib.batch_sharding(
            self.mesh)
        meshlib.local_batch_size(self.mesh, cfg.global_batch)  # divides
        self.opt: Optional[AdamW | Adafactor] = None
        self.ckpt = (ckptlib.CheckpointManager(
            cfg.checkpoint_dir, save_interval_steps=cfg.save_interval_steps)
            if cfg.checkpoint_dir else None)
        #: LoRA + init_from: checkpoints hold the adapters and their
        #: optimizer state only (the base reloads from the snapshot)
        self._adapter_ckpt = cfg.model.lora_rank > 0 and bool(cfg.init_from)
        #: the state after ``train()``: the publish hook's source
        self.final_state: Optional[dict] = None
        self._preempted = False
        #: on a mesh: the newest checkpointed step (rank 0's manager's)
        self._last_saved: Optional[int] = None

    def _plan_mesh(self):
        """The ``DeviceMesh`` of ``cfg.mesh_axes`` over the process group;
        None for one process with no axis of size > 1. In a group of one
        the axes named are kept at size 1 (FSDP2 over ``{"fsdp": 1}``, the
        layout each rank of a job with one card per process runs);
        ``plan_mesh`` drops such axes, so the mesh is built here."""
        axes = {a: s for a, s in self.cfg.mesh_axes.items() if s != 1}
        import torch.distributed as dist

        if _world() == 1 and not axes and self.cfg.num_slices == 1:
            if not (dist.is_initialized() and self.cfg.mesh_axes):
                return None
            from torch.distributed.device_mesh import DeviceMesh

            meshlib.plan_mesh(self.cfg.mesh_axes, num_devices=1)  # names
            names = tuple(a for a in meshlib.AXIS_ORDER
                          if a in self.cfg.mesh_axes)
            return DeviceMesh(self.device.type,
                              torch.zeros((1,) * len(names), dtype=torch.int),
                              mesh_dim_names=names)
        if not dist.is_initialized():
            raise RuntimeError(
                f"mesh {self.cfg.mesh_axes} needs an initialised process "
                "group (runtime.bootstrap.initialize)")
        return meshlib.build_mesh(axes or {"data": _world()},
                                  num_slices=self.cfg.num_slices,
                                  device_type=self.device.type)

    # -- state ------------------------------------------------------------

    def _trainable(self) -> list[tuple[str, torch.nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters()
                if p.requires_grad]

    def _trains(self, name: str) -> bool:
        """Whether parameter ``name`` (any stage's) is trained: the
        adapters alone under LoRA."""
        return self.cfg.model.lora_rank == 0 or llamalib.is_lora_path(name)

    def _leaves(self, names) -> dict[tuple, list[str]]:
        """``names`` grouped into the reference tree's leaves (scan-
        stacked), in tree order: {(layered, path): [names]}."""
        groups: dict[tuple, list] = {}
        moe = self.cfg.model.moe_experts > 0
        for name in names:
            layer, path = convert.tree_path(name, moe)
            groups.setdefault((layer is not None, path), []).append(name)
        return groups

    def _leaf_groups(self) -> list[tuple]:
        """The trainable params as the reference tree's leaves (scan-
        stacked): (stacked shape, [per-layer params], ``optim.LeafCut``)
        in tree order; on a mesh the shape is the whole leaf's."""
        params = dict(self._trainable())
        out = []
        for (layered, _), names in self._leaves(params).items():
            parts = [params[n] for n in names]
            if self.layout is None:
                shape = tuple(parts[0].shape)
                out.append(((len(parts), *shape) if layered else shape,
                            parts, LeafCut()))
                continue
            lay = self.layout
            shape = lay.full_shapes[names[0]]
            if layered:
                shape = (self.cfg.model.num_layers, *shape)
            cut = {d: g.group for d, axes in lay.cut_axes(names[0]).items()
                   if (g := lay.group(axes)) is not None}
            whole = lay.group(sorted(lay.sharded_over(names[0])))
            out.append((shape, parts, LeafCut(
                cut, None if whole is None else whole.group)))
        return out

    def _opt_order(self) -> list[str]:
        """The whole model's trainable parameter names in the order of the
        unsharded optimizer's state (AdamW: the model's; Adafactor: the
        tree's leaves)."""
        names = [k for k in (self.layout.full_shapes if self.layout
                             else dict(self.model.named_parameters()))
                 if self._trains(k)]
        if self.cfg.optimizer == "adafactor":
            names = [n for group in self._leaves(names).values()
                     for n in group]
        return names

    def _fresh_optimizer(self) -> None:
        cfg = self.cfg
        sched = dict(learning_rate=cfg.learning_rate,
                     warmup_steps=cfg.warmup_steps,
                     decay_steps=max(cfg.steps, cfg.warmup_steps + 1),
                     grad_clip_norm=cfg.grad_clip_norm)
        if cfg.optimizer == "adafactor":
            groups = self._leaf_groups()
            params = [p for g in groups for p in g[1]]
            self.opt = Adafactor(
                groups, norm_weights=(self.layout.norm_weights(params)
                                      if self.layout else None), **sched)
        else:
            params = [p for _, p in self._trainable()]
            self.opt = AdamW(
                params, b1=cfg.b1, b2=cfg.b2,
                weight_decay=cfg.weight_decay, mu_dtype=cfg.mu_dtype,
                norm_weights=(self.layout.norm_weights(params)
                              if self.layout else None),
                **sched)

    def init_state(self, seed: int = 0) -> None:
        """Random params from ``seed`` (or, with ``init_from``, the
        snapshot's, and fresh adapters under LoRA) and a fresh optimizer
        at step 0."""
        if self.cfg.init_from:
            self._pretrained_params()
        elif self.layout is None:
            self.model.init_weights(seed)
        else:
            # the unsharded model's draws, one module at a time, each
            # rank keeping its shards of them
            self.model.init_streamed(seed, self.device,
                                     self.layout.load_full_params)
        self._fresh_optimizer()

    def _load_full(self, sd: dict) -> None:
        """A full (unsharded) state dict into the model, sharded when it
        is laid out on a mesh."""
        if self.layout is None:
            self.model.load_state_dict(sd, strict=True)
        else:
            self.layout.load_full_state_dict(sd)

    def full_state_dict(self) -> dict:
        """The model's state dict, unsharded (every rank joins)."""
        if self.layout is None:
            return self.model.state_dict()
        return self.layout.full_state_dict()

    def load_params(self, jax_params) -> None:
        """Params from the reference's param tree (numpy leaves, either
        layer layout) and a fresh optimizer at step 0."""
        sd = convert.state_dict_from_jax(jax_params, self.cfg.model)
        self._load_full(sd)
        self._fresh_optimizer()

    @torch.no_grad()
    def _fresh_adapters(self) -> dict[str, torch.Tensor]:
        """A ~ normal(0, 0.02) from ``np.random.RandomState(0)`` drawn leaf
        by leaf in the reference's sorted (scan-stacked) path order, B
        zeros: the reference's ``_fresh_adapters``."""
        cfg = self.cfg.model
        # the whole model's shapes: a laid-out rank holds some of them
        shapes = (self.layout.full_shapes if self.layout is not None else
                  {k: tuple(p.shape)
                   for k, p in self.model.named_parameters()})
        leaves: dict[tuple, dict[int, tuple]] = {}
        for key, shape in shapes.items():
            if not llamalib.is_lora_path(key):
                continue
            layer, path = convert.tree_path(key, cfg.moe_experts > 0)
            leaves.setdefault(("layers", "block", *path), {})[layer] = (
                key, shape)
        rng = np.random.RandomState(0)
        out = {}
        for path, by_layer in sorted(leaves.items()):
            shape = (len(by_layer), *by_layer[0][1])
            if path[-1] == "lora_a":
                host = rng.normal(0.0, 0.02, size=shape).astype(np.float32)
            else:
                host = np.zeros(shape, np.float32)
            for layer, (key, _) in by_layer.items():
                out[key] = torch.from_numpy(host[layer].copy())
        return out

    def _pretrained_params(self, adapters: Optional[dict] = None) -> None:
        """Load the ``init_from`` snapshot into the model. Its architecture
        must match the config's. Under LoRA with a base snapshot, the
        adapters come from ``adapters`` (a checkpoint's) or fresh."""
        snap_cfg, sd = llamalib.load_pretrained(self.cfg.init_from)
        mcfg = self.cfg.model
        for f in _ARCH_FIELDS:
            if getattr(snap_cfg, f) != getattr(mcfg, f):
                raise ValueError(
                    f"init_from snapshot {self.cfg.init_from}: {f}="
                    f"{getattr(snap_cfg, f)} != model config "
                    f"{getattr(mcfg, f)}; the snapshot defines the "
                    "architecture — build TrainConfig.model from "
                    "load_pretrained_config")
        snap_has_lora = any(llamalib.is_lora_path(k) for k in sd)
        if mcfg.lora_rank > 0 and not snap_has_lora:
            sd = {**sd, **(adapters if adapters is not None
                           else self._fresh_adapters())}
        try:
            self._load_full(sd)
        except (RuntimeError, ValueError) as e:
            raise ValueError(
                f"init_from snapshot {self.cfg.init_from} does not match "
                f"the model's parameter tree: {e}") from None

    def _opt_keys(self) -> list[str]:
        """The names of the optimizer's parameters."""
        names = {id(p): k for k, p in self.model.named_parameters()}
        return [names[id(p)] for p in self.opt.params]

    def _moment_drops(self) -> dict[str, list]:
        """{moment: per parameter, the dim it reduces away or None}."""
        if isinstance(self.opt, Adafactor):
            return self.opt.moment_drops()
        return {what: [None] * len(self.opt.params) for what in ("mu", "nu")}

    def _opt_state_full(self) -> dict:
        """The optimizer's state with every moment unsharded, in the
        unsharded optimizer's order (``_opt_order``; every rank joins)."""
        state = self.opt.state_dict()
        if self.layout is None:
            return state
        keys, order = self._opt_keys(), self._opt_order()
        for what, drops in self._moment_drops().items():
            full = self.layout.all_stages({
                k: None if t is None else self.layout.gather_full(
                    k, t, like=p, drop=drop).cpu()
                for k, t, p, drop in zip(keys, state[what], self.opt.params,
                                         drops)})
            state[what] = [full[k] for k in order]
        return state

    def _load_opt_state(self, state: dict) -> None:
        """A full optimizer state (``_opt_state_full``'s) into the
        optimizer, each moment this rank's shard (every rank joins)."""
        if self.layout is not None:
            keys, order = self._opt_keys(), self._opt_order()
            state = dict(state)
            for what, drops in self._moment_drops().items():
                full = dict(zip(order, state[what]))
                state[what] = [
                    None if full[k] is None else self.layout.to_param_layout(
                        k, full[k], p, drop=drop)
                    for k, p, drop in zip(keys, self.opt.params, drops)]
        self.opt.load_state_dict(state)

    def _to_ckpt(self) -> dict:
        """The state as persisted, unsharded: adapter-only under LoRA
        fine-tunes (every rank joins)."""
        state = {"step": self.opt.count, "opt_state": self._opt_state_full()}
        if self._adapter_ckpt:
            _, state["adapters"] = llamalib.split_lora(self.full_state_dict())
        else:
            state["params"] = self.full_state_dict()
        return state

    def _save(self, step: int, force: bool = False) -> None:
        """Checkpoint ``step`` when the manager says so. On a mesh every
        rank takes rank 0's manager's decision from the newest step it
        saved (``_last_saved``) with no collective; every rank gathers the
        state and rank 0 writes it."""
        if _world() == 1:
            self.ckpt.save(step, self._to_ckpt(), force=force)
            return
        last = self._last_saved
        if last is not None and step <= last:
            return
        if not (force or last is None
                or step % self.ckpt.save_interval_steps == 0):
            return
        state = self._to_ckpt()
        if _rank() == 0:
            self.ckpt.save(step, state, force=True)
        self._last_saved = step

    def _any_preempted(self) -> bool:
        """Whether a rank has had SIGTERM: on a mesh one all-reduce of a
        flag, so that every rank stops (and saves) together."""
        if _world() == 1:
            return self._preempted
        import torch.distributed as dist

        flag = torch.tensor(float(self._preempted), device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag)

    def restore_or_init(self, seed: int = 0) -> None:
        """Resume from the newest checkpoint if one exists, else
        ``init_state``."""
        latest = _from_rank0(self.ckpt.latest_step() if self.ckpt else None)
        if latest is None:
            self.init_state(seed)
            return
        state = self.ckpt.restore(
            latest, map_location="cpu" if self.layout else self.device)
        if self._adapter_ckpt:
            self._pretrained_params(adapters=state["adapters"])
        else:
            self._load_full(state["params"])
        self._fresh_optimizer()
        self._load_opt_state(state["opt_state"])

    # -- step -------------------------------------------------------------

    def _microbatch_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """Under a ``pipeline`` axis beside batch shards: this rank's slice
        of each of the ``m`` microbatches of the whole batch, in microbatch
        order, for its contiguous rows ``tokens``. The reference splits the
        global batch into microbatches (rows ``[i b/m, (i+1) b/m)``); the
        MoE balancing loss is not linear in the rows, so each microbatch
        must hold those rows whatever shard a rank was fed. The batch
        shards' rows are gathered (token ids, a few KB) and each rank keeps
        its part of every microbatch."""
        group = self.layout.group(meshlib.batch_axes(self.mesh))
        m = self.cfg.num_microbatches or self.model.pipe.size
        if group is None or m == 1:
            return tokens
        from ..parallel.collectives import all_gather_rows

        whole = all_gather_rows(tokens, group.group)  # rank order = shards
        if whole.shape[0] % (m * group.size):
            raise ValueError(
                f"batch {whole.shape[0]} not divisible by {m} microbatches "
                f"x {group.size} batch shards")
        part = whole.shape[0] // (m * group.size)
        return whole.reshape(m, group.size, part, -1)[:, group.rank].reshape(
            m * part, -1)

    def _inputs_targets(self, tokens: torch.Tensor):
        """(inputs, targets) of this rank: its microbatch rows under a
        ``pipeline`` axis, shifted, then its sequence block on a ``seq``
        axis."""
        if self.model.pipe is not None:
            tokens = self._microbatch_rows(tokens)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        if self.mesh is not None:
            cut = meshlib.seq_slice(self.mesh, inputs.shape[1])
            inputs, targets = inputs[:, cut], targets[:, cut]
        return inputs, targets

    def _with_aux(self) -> bool:
        return self.cfg.model.moe_experts > 0 and self.cfg.aux_loss_coef > 0

    def _loss(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        inputs, targets = self._inputs_targets(tokens)
        with_aux = self._with_aux()
        if self.model.pipe is not None:
            out = llamalib.pipelined_apply(
                cfg.model, self.model, inputs,
                num_microbatches=cfg.num_microbatches, with_aux=with_aux)
            logits, aux = out if with_aux else (out, None)
        elif with_aux:
            logits, aux = self.model(inputs, return_aux=True)
        else:
            logits = self.model(inputs)
        loss = _cross_entropy(logits, targets)
        if with_aux:
            loss = loss + cfg.aux_loss_coef * aux
        return loss

    def _loss_backward(self, tokens: torch.Tensor) -> torch.Tensor:
        """The loss of ``tokens``, its gradients added to ``.grad``."""
        loss = self._loss(tokens)
        loss.backward()
        return loss.detach()

    def _loss_1f1b(self, tokens: torch.Tensor) -> torch.Tensor:
        """The loss of ``tokens`` through the 1F1B executor, its gradients
        added to ``.grad``: the embedding runs on every rank and takes its
        backward from the executor's input gradient (the first stage's);
        the head and the loss run in the last stage, the tied table's
        gradient there too. The same blocks and microbatch mean as
        ``pipelined_apply``."""
        from ..parallel import pipeline as pipelib

        cfg, mcfg, model = self.cfg, self.cfg.model, self.model
        inputs, targets = self._inputs_targets(tokens)
        positions = llamalib.seq_positions(model, inputs.shape[1],
                                           inputs.device)
        x = model.embedder(inputs)
        m = cfg.num_microbatches or model.pipe.size
        aux_weight = (cfg.aux_loss_coef / (mcfg.num_layers * m)
                      if self._with_aux() else 0.0)
        table = model.embedder.embedding if mcfg.tie_embeddings else None

        def loss_fn(y, tgt):
            return _cross_entropy(model.head(y, table), tgt)

        loss, dx = pipelib.one_f_one_b(
            llamalib.block_apply_with_aux(mcfg, positions), loss_fn,
            model.layers, x, targets, mesh=model.pipe,
            num_microbatches=cfg.num_microbatches, remat=mcfg.remat,
            with_aux=True, aux_weight=aux_weight,
            interleave=cfg.pipeline_interleave)
        x.backward(dx)
        return loss

    def loss_and_grads(self, tokens) -> torch.Tensor:
        """Forward + backward on one global batch [b, seq+1]; the grads are
        left in the trainable params' ``.grad``. Returns the loss (0-d, on
        device), the load-balancing term included."""
        if not isinstance(tokens, torch.Tensor):
            tokens = np.asarray(tokens)
        tokens = torch.as_tensor(tokens, device=self.device)
        if self.layout is None:
            return self._accumulate(tokens)
        with self.layout.gathered():
            return self._accumulate(tokens)

    def _accumulate(self, tokens: torch.Tensor) -> torch.Tensor:
        """``loss_and_grads`` over ``accum_steps`` microbatches."""
        accum = self.cfg.accum_steps
        grads = (self._loss_1f1b if self.model.pipe is not None
                 and self.cfg.pipeline_schedule == "1f1b"
                 else self._loss_backward)
        if accum <= 1:
            return grads(tokens)
        b = tokens.shape[0]
        if b % accum:
            raise ValueError(
                f"global_batch {b} not divisible by accum_steps {accum}")
        # the reference's strided microbatches: rows i, accum+i, ...
        micro = tokens.reshape(b // accum, accum, -1).transpose(0, 1)
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            loss_sum = loss_sum + grads(micro[i])  # sums into .grad, f32
        for _, p in self._trainable():
            if p.grad is not None:
                p.grad.div_(accum)
        return loss_sum / accum

    def step(self, tokens) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on this rank's rows of the global batch;
        returns (loss, grad_norm) as device scalars, the loss the global
        batch's mean (the norm over the trainable params: the adapters
        under LoRA)."""
        if self.opt is None:
            raise RuntimeError(
                "call init_state(), restore_or_init() or load_params() first")
        loss = self.loss_and_grads(tokens)
        if self.layout is not None:
            self.layout.sync_grads(self.opt.params)
            loss = self.global_mean(loss)
        grad_norm = self.opt.step()
        self.model.zero_grad(set_to_none=True)
        return loss, grad_norm

    def global_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank scalar over every rank (the ranks of a
        ``model`` group hold the same value, so this is the mean over the
        batch shards)."""
        if _world() == 1:
            return x
        import torch.distributed as dist

        x = x.detach().clone()
        dist.all_reduce(x)
        return x / _world()

    def data_source(self):
        """The default batch source: this rank's rows of the
        ``SyntheticLm`` stream."""
        cfg = self.cfg
        return datalib.SyntheticLm(
            cfg.global_batch, cfg.seq_len, cfg.model.vocab_size,
            process_index=self.batch_index, process_count=self.batch_count)

    # -- loop -------------------------------------------------------------

    def train(self, source=None,
              on_metrics: Optional[Callable[[StepMetrics], None]] = None
              ) -> Optional[StepMetrics]:
        """Steps from the optimizer's count to ``cfg.steps`` on ``source``
        (a ``local_batch(step)`` source; default the ``SyntheticLm``
        stream), resuming or initialising first when there is no state
        yet; returns the last logged metrics."""
        cfg = self.cfg
        if self.opt is None:
            self.restore_or_init(0)
        source = source or self.data_source()
        self._preempted = False
        if self.ckpt and _world() > 1:
            self._last_saved = _from_rank0(self.ckpt.latest_step())
        prev, installed = None, False
        if self.ckpt and threading.current_thread() is threading.main_thread():
            def _on_sigterm(signum, frame):
                self._preempted = True
            prev = signal.signal(signal.SIGTERM, _on_sigterm)
            installed = True
        try:
            return self._run_loop(source, on_metrics)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_loop(self, source, on_metrics) -> Optional[StepMetrics]:
        cfg = self.cfg
        flops_tok = llamalib.flops_per_token(cfg.model, cfg.seq_len)
        peak = (PEAK_TFLOPS.get(torch.cuda.get_device_name(self.device), 0.0)
                if self.device.type == "cuda" else 0.0)
        tokens_per_step = cfg.global_batch * cfg.seq_len
        chips = _world()
        metrics, prof = None, None
        self._sync()
        window_t0, window_steps = time.perf_counter(), 0
        for step in range(self.opt.count, cfg.steps):
            if cfg.profile_dir and step == cfg.profile_start:
                prof = self._start_profile()
            loss, grad_norm = self.step(source.local_batch(step)["tokens"])
            window_steps += 1
            if prof is not None and step + 1 >= cfg.profile_stop:
                prof = self._stop_profile(prof)
            logged = (step + 1) % cfg.log_every == 0 or step == cfg.steps - 1
            if logged:
                loss_f = float(loss)  # blocks on the device
                now = time.perf_counter()
                dt = (now - window_t0) / window_steps
                tps = tokens_per_step / dt
                metrics = StepMetrics(
                    step=step + 1, loss=loss_f, grad_norm=float(grad_norm),
                    step_time_s=dt, tokens_per_sec=tps,
                    tokens_per_sec_per_chip=tps / chips,
                    mfu=(tps / chips * flops_tok / (peak * 1e12)
                         if peak else 0.0))
                window_t0, window_steps = now, 0
                if on_metrics:
                    on_metrics(metrics)
            if not self.ckpt:
                continue
            self._save(step + 1)
            # on a mesh SIGTERM is read where the host waits anyway (a log
            # or a checkpoint step): the flag's all-reduce blocks on it
            if ((_world() == 1 or logged
                 or (step + 1) % cfg.save_interval_steps == 0)
                    and self._any_preempted()):
                self._save(step + 1, force=True)
                self.ckpt.wait_until_finished()
                raise SystemExit(143)
        if prof is not None:
            # the loop ended inside the window: write what was traced
            self._stop_profile(prof)
        if self.ckpt:
            self._save(cfg.steps, force=True)
            self.ckpt.wait_until_finished()
        self.final_state = {"step": self.opt.count,
                            "params": self.full_state_dict(),
                            "opt_state": self._opt_state_full()}
        return metrics

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        self._sync()
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.cfg.profile_dir,
            f"trace_steps_{self.cfg.profile_start}_{self.cfg.profile_stop}"
            ".json"))
        return None
