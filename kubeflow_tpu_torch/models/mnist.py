"""MNIST-class smoke model: a tiny MLP trained by a JaxJob pod.

The port of ``kubeflow_tpu/models/mnist.py``: the baseline config-1
equivalent (BASELINE.md row 1: "TFJob MNIST single-worker"). Synthetic data
from a fixed linear teacher keeps the job hermetic (no dataset downloads).
The ``train_main`` entrypoint is what JaxJob manifests name as
``kubeflow_tpu_torch.models.mnist:train_main``. Parameters are flax's
``Dense_0``/``Dense_1`` as ``nn.Linear`` modules (``convert.
mnist_from_reference`` carries the reference's across); the batches come
from numpy generators, so their values differ from the reference's jax
draws. Runs on the pod's device (``KFT_POD_DEVICE``, default the card);
several processes train data parallel (``resnet.data_parallel``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .llama import _trunc_normal

IMAGE_DIM = 64
NUM_CLASSES = 10


class MLP(nn.Module):
    def __init__(self, hidden: int = 128, device=None):
        super().__init__()
        device = resolve_device(device)
        self.Dense_0 = nn.Linear(IMAGE_DIM, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, NUM_CLASSES, device=device)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """flax ``Dense`` initializers (lecun normal kernels, zero biases);
        the draws differ from the reference's."""
        gen = torch.Generator(device=self.Dense_0.weight.device)
        gen.manual_seed(seed)
        for lin in (self.Dense_0, self.Dense_1):
            _trunc_normal(lin.weight, lin.in_features, gen)
            lin.bias.zero_()

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


_TEACHER: dict[tuple, np.ndarray] = {}


def _teacher(seed: int, shape: tuple) -> np.ndarray:
    """A fixed random projection (the deterministic teacher)."""
    key = (seed, shape)
    if key not in _TEACHER:
        _TEACHER[key] = np.random.default_rng(seed).standard_normal(
            shape).astype(np.float32)
    return _TEACHER[key]


def synthetic_batch(key: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic teacher: labels from a fixed random projection; the
    batch is a numpy generator's draw keyed by ``key``."""
    x = np.random.default_rng([1, key]).standard_normal(
        (batch, IMAGE_DIM)).astype(np.float32)
    y = np.argmax(x @ _teacher(7, (IMAGE_DIM, NUM_CLASSES)), axis=-1)
    return x, y


def train_main(ctx, *, device=None) -> MLP:
    """Entrypoint for JaxJob pods: SGD with momentum 0.9 on the pod's
    device; emits ``loss`` and ``accuracy`` of the last step. With several
    processes, data parallel over the job's group as ``resnet.train_main``
    is, both metrics the global batch's means. Returns the model."""
    from ..runtime import bootstrap
    from .resnet import data_parallel, global_mean

    steps = int(os.environ.get("KFT_STEPS", "30"))
    global_batch = int(os.environ.get("KFT_BATCH", "64"))
    lr = float(os.environ.get("KFT_LR", "0.05"))
    bootstrap.initialize(ctx)
    dev = bootstrap.pod_device(ctx, device)
    print(f"mnist: training on {dev}", flush=True)
    model = MLP(device=dev)
    model.init_weights(0)
    net = data_parallel(model, ctx, dev)
    # optax.sgd(lr, momentum=0.9): trace = g + 0.9 trace; p -= lr trace
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    local_bs = global_batch // ctx.num_processes
    loss = acc = None
    for i in range(steps):
        x, y = synthetic_batch(i * ctx.num_processes + ctx.process_id,
                               local_bs)
        x = torch.from_numpy(x).to(dev)
        y = torch.from_numpy(y).to(dev)
        logits = net(x)
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    bootstrap.emit_metric(ctx, "loss", global_mean(loss, ctx))
    bootstrap.emit_metric(ctx, "accuracy", global_mean(acc, ctx))
    return model
