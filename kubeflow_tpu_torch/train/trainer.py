"""The training loop of the port: the counterpart of
``kubeflow_tpu/train/trainer.py::Trainer`` for one device.

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
from . import checkpoint as ckptlib
from . import data as datalib
from .optim import Adafactor, AdamW

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


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None):
        self.cfg = cfg
        if cfg.optimizer not in ("adamw", "adafactor"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        if cfg.accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        if cfg.model.lora_rank > 0 and not cfg.init_from:
            # without a base snapshot the frozen base stays at random init
            raise ValueError(
                "lora_rank > 0 requires init_from: adapters train "
                "against a frozen base snapshot "
                "(TrainingClient.train(model=..., lora_rank=...))")
        self.device = resolve_device(device)
        self.model = llamalib.Llama(cfg.model, device=self.device)
        if cfg.model.lora_rank > 0:
            for name, p in self.model.named_parameters():
                p.requires_grad_(llamalib.is_lora_path(name))
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

    # -- state ------------------------------------------------------------

    def _trainable(self) -> list[tuple[str, torch.nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters()
                if p.requires_grad]

    def _leaf_groups(self) -> list[tuple[tuple, list]]:
        """The trainable params as the reference tree's leaves (scan-
        stacked): (stacked shape, [per-layer params]) in tree order."""
        groups: dict[tuple, list] = {}
        moe = self.cfg.model.moe_experts > 0
        for name, p in self._trainable():
            layer, path = convert.tree_path(name, moe)
            groups.setdefault((layer is not None, path), []).append(p)
        out = []
        for (layered, _), parts in groups.items():
            shape = tuple(parts[0].shape)
            out.append(((len(parts), *shape) if layered else shape, parts))
        return out

    def _fresh_optimizer(self) -> None:
        cfg = self.cfg
        sched = dict(learning_rate=cfg.learning_rate,
                     warmup_steps=cfg.warmup_steps,
                     decay_steps=max(cfg.steps, cfg.warmup_steps + 1),
                     grad_clip_norm=cfg.grad_clip_norm)
        if cfg.optimizer == "adafactor":
            self.opt = Adafactor(self._leaf_groups(), **sched)
        else:
            self.opt = AdamW(
                [p for _, p in self._trainable()], b1=cfg.b1, b2=cfg.b2,
                weight_decay=cfg.weight_decay, mu_dtype=cfg.mu_dtype,
                **sched)

    def init_state(self, seed: int = 0) -> None:
        """Random params from ``seed`` (or, with ``init_from``, the
        snapshot's, and fresh adapters under LoRA) and a fresh optimizer
        at step 0."""
        if self.cfg.init_from:
            self._pretrained_params()
        else:
            self.model.init_weights(seed)
        self._fresh_optimizer()

    def load_params(self, jax_params) -> None:
        """Params from the reference's param tree (numpy leaves, either
        layer layout) and a fresh optimizer at step 0."""
        sd = convert.state_dict_from_jax(jax_params, self.cfg.model)
        self.model.load_state_dict(sd, strict=True)
        self._fresh_optimizer()

    @torch.no_grad()
    def _fresh_adapters(self) -> dict[str, torch.Tensor]:
        """A ~ normal(0, 0.02) from ``np.random.RandomState(0)`` drawn leaf
        by leaf in the reference's sorted (scan-stacked) path order, B
        zeros: the reference's ``_fresh_adapters``."""
        cfg = self.cfg.model
        _, lora = llamalib.split_lora(self.model)
        leaves: dict[tuple, dict[int, tuple]] = {}
        for key, t in lora.items():
            layer, path = convert.tree_path(key, cfg.moe_experts > 0)
            leaves.setdefault(("layers", "block", *path), {})[layer] = (
                key, tuple(t.shape))
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
            self.model.load_state_dict(sd, strict=True)
        except RuntimeError as e:
            raise ValueError(
                f"init_from snapshot {self.cfg.init_from} does not match "
                f"the model's parameter tree: {e}") from None

    def _to_ckpt(self) -> dict:
        """The state as persisted: adapter-only under LoRA fine-tunes."""
        state = {"step": self.opt.count, "opt_state": self.opt.state_dict()}
        if self._adapter_ckpt:
            _, state["adapters"] = llamalib.split_lora(self.model)
        else:
            state["params"] = self.model.state_dict()
        return state

    def restore_or_init(self, seed: int = 0) -> None:
        """Resume from the newest checkpoint if one exists, else
        ``init_state``."""
        if not (self.ckpt and self.ckpt.latest_step() is not None):
            self.init_state(seed)
            return
        state = self.ckpt.restore(map_location=self.device)
        if self._adapter_ckpt:
            self._pretrained_params(adapters=state["adapters"])
        else:
            self.model.load_state_dict(state["params"], strict=True)
        self._fresh_optimizer()
        self.opt.load_state_dict(state["opt_state"])

    # -- step -------------------------------------------------------------

    def _loss(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        with_aux = cfg.model.moe_experts > 0 and cfg.aux_loss_coef > 0
        if with_aux:
            logits, aux = self.model(inputs, return_aux=True)
        else:
            logits = self.model(inputs)
        loss = F.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            targets.reshape(-1).long())
        if with_aux:
            loss = loss + cfg.aux_loss_coef * aux
        return loss

    def loss_and_grads(self, tokens) -> torch.Tensor:
        """Forward + backward on one global batch [b, seq+1]; the grads are
        left in the trainable params' ``.grad``. Returns the loss (0-d, on
        device), the load-balancing term included."""
        if not isinstance(tokens, torch.Tensor):
            tokens = np.asarray(tokens)
        tokens = torch.as_tensor(tokens, device=self.device)
        accum = self.cfg.accum_steps
        if accum <= 1:
            loss = self._loss(tokens)
            loss.backward()
            return loss.detach()
        b = tokens.shape[0]
        if b % accum:
            raise ValueError(
                f"global_batch {b} not divisible by accum_steps {accum}")
        # the reference's strided microbatches: rows i, accum+i, ...
        micro = tokens.reshape(b // accum, accum, -1).transpose(0, 1)
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            loss = self._loss(micro[i])
            loss.backward()  # sums into .grad, f32
            loss_sum = loss_sum + loss.detach()
        for _, p in self._trainable():
            if p.grad is not None:
                p.grad.div_(accum)
        return loss_sum / accum

    def step(self, tokens) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step; returns (loss, grad_norm) as device scalars
        (the norm over the trainable params: the adapters under LoRA)."""
        if self.opt is None:
            raise RuntimeError(
                "call init_state(), restore_or_init() or load_params() first")
        loss = self.loss_and_grads(tokens)
        grad_norm = self.opt.step()
        self.model.zero_grad(set_to_none=True)
        return loss, grad_norm

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
        source = source or datalib.SyntheticLm(
            cfg.global_batch, cfg.seq_len, cfg.model.vocab_size)
        self._preempted = False
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
            if (step + 1) % cfg.log_every == 0 or step == cfg.steps - 1:
                loss_f = float(loss)  # blocks on the device
                now = time.perf_counter()
                dt = (now - window_t0) / window_steps
                tps = tokens_per_step / dt
                metrics = StepMetrics(
                    step=step + 1, loss=loss_f, grad_norm=float(grad_norm),
                    step_time_s=dt, tokens_per_sec=tps,
                    tokens_per_sec_per_chip=tps,
                    mfu=tps * flops_tok / (peak * 1e12) if peak else 0.0)
                window_t0, window_steps = now, 0
                if on_metrics:
                    on_metrics(metrics)
            if self.ckpt:
                self.ckpt.save(step + 1, self._to_ckpt())
            if self._preempted and self.ckpt:
                self.ckpt.save(step + 1, self._to_ckpt(), force=True)
                self.ckpt.wait_until_finished()
                raise SystemExit(143)
        if prof is not None:
            # the loop ended inside the window: write what was traced
            self._stop_profile(prof)
        if self.ckpt:
            self.ckpt.save(cfg.steps, self._to_ckpt(), force=True)
            self.ckpt.wait_until_finished()
        self.final_state = {"step": self.opt.count,
                            "params": self.model.state_dict(),
                            "opt_state": self.opt.state_dict()}
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
