"""The training loop of the port: the counterpart of
``kubeflow_tpu/train/trainer.py::Trainer`` for one device.

One step: next-token cross-entropy (f32, mean) of the model's logits on
``tokens[:, 1:]`` given ``tokens[:, :-1]`` (plus ``aux_loss_coef`` times the
MoE load-balancing loss averaged over layers, for an MoE model), backward
through the remat blocks, then the optax-exact clipped AdamW of
``optim.py``. Metering (tokens/s, MFU of the active FLOPs against the card's
bf16 peak) follows the reference: the host blocks on the device only at log
boundaries.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import convert
from ..models import llama as llamalib
from . import data as datalib
from .optim import AdamW

#: dense bf16 peak TFLOP/s by ``torch.cuda.get_device_name``, for MFU
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}


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
    #: dtype of AdamW's first moment (None = the param dtype, f32)
    mu_dtype: Optional[torch.dtype] = torch.bfloat16
    log_every: int = 10
    #: weight of the MoE load-balancing loss (no effect on a dense model)
    aux_loss_coef: float = 0.01


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
        self.device = resolve_device(device)
        self.model = llamalib.Llama(cfg.model, device=self.device)
        self.opt: Optional[AdamW] = None

    # -- state ------------------------------------------------------------

    def _fresh_optimizer(self) -> None:
        cfg = self.cfg
        self.opt = AdamW(
            self.model.parameters(), learning_rate=cfg.learning_rate,
            warmup_steps=cfg.warmup_steps,
            decay_steps=max(cfg.steps, cfg.warmup_steps + 1),
            b1=cfg.b1, b2=cfg.b2, weight_decay=cfg.weight_decay,
            grad_clip_norm=cfg.grad_clip_norm, mu_dtype=cfg.mu_dtype)

    def init_state(self, seed: int = 0) -> None:
        """Random params from ``seed`` and a fresh optimizer at step 0."""
        self.model.init_weights(seed)
        self._fresh_optimizer()

    def load_params(self, jax_params) -> None:
        """Params from the reference's param tree (numpy leaves, either
        layer layout) and a fresh optimizer at step 0."""
        sd = convert.state_dict_from_jax(jax_params, self.cfg.model)
        self.model.load_state_dict(sd, strict=True)
        self._fresh_optimizer()

    # -- step -------------------------------------------------------------

    def loss_and_grads(self, tokens) -> torch.Tensor:
        """Forward + backward on one global batch [b, seq+1]; the grads are
        left in the params' ``.grad``. Returns the loss (0-d, on device),
        the load-balancing term included."""
        cfg = self.cfg
        if not isinstance(tokens, torch.Tensor):
            tokens = np.asarray(tokens)
        tokens = torch.as_tensor(tokens, device=self.device)
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
        loss.backward()
        return loss.detach()

    def step(self, tokens) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step; returns (loss, grad_norm) as device scalars."""
        if self.opt is None:
            raise RuntimeError("call init_state() or load_params() first")
        loss = self.loss_and_grads(tokens)
        grad_norm = self.opt.step()
        self.model.zero_grad(set_to_none=True)
        return loss, grad_norm

    # -- loop -------------------------------------------------------------

    def train(self, on_metrics: Optional[Callable[[StepMetrics], None]] = None
              ) -> Optional[StepMetrics]:
        """Steps from the optimizer's count to ``cfg.steps`` on the
        ``SyntheticLm`` stream (random init from seed 0 if no state yet);
        returns the last logged metrics."""
        cfg = self.cfg
        if self.opt is None:
            self.init_state(0)
        source = datalib.SyntheticLm(
            cfg.global_batch, cfg.seq_len, cfg.model.vocab_size)
        flops_tok = llamalib.flops_per_token(cfg.model, cfg.seq_len)
        peak = (PEAK_TFLOPS.get(torch.cuda.get_device_name(self.device), 0.0)
                if self.device.type == "cuda" else 0.0)
        tokens_per_step = cfg.global_batch * cfg.seq_len
        metrics = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_t0, window_steps = time.perf_counter(), 0
        for step in range(self.opt.count, cfg.steps):
            loss, grad_norm = self.step(source.local_batch(step)["tokens"])
            window_steps += 1
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
        return metrics
