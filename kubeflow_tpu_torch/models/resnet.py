"""ResNet family (v1.5 bottlenecks) in PyTorch: the port of
``kubeflow_tpu/models/resnet.py``.

Capability target: baseline config 2 — "PyTorchJob DDP ResNet-50" [local:
BASELINE.json configs], launched as an ordinary JaxJob (``train_main``).
The reference's choices are kept: NHWC images in, bf16 activations with
f32 params, GroupNorm instead of BatchNorm, the stride-2 convolutions in
the 3x3 as v1.5 puts them. The convolutions run in ``torch.channels_last``
(an NHWC input viewed as NCHW is already that layout).

Where flax and torch differ, the port follows flax:

- ``nn.Conv(padding="SAME")`` pads ``(out - 1) * stride + k - n`` in all,
  the odd one on the HIGH side: a 7x7/2 stem on 32 pixels pads (2, 3), a
  3x3/2 on 16 pads (0, 1). ``Conv2d(padding=k // 2)`` would shift every
  window, so the high side's extra row and column come from ``F.pad``;
- ``nn.max_pool(padding="SAME")`` pads with -inf on the same split;
- flax ``GroupNorm``: epsilon 1e-6 (torch's default is 1e-5), statistics
  in f32, the groups of ``_norm``, output in the activation dtype;
- the global mean pool rounds to the activation dtype (jnp.mean of bf16)
  and the head is an f32 ``Dense``.

Parameters are torch's: conv kernels ``[out, in, kh, kw]`` (flax HWIO),
GroupNorm ``weight``/``bias`` (flax ``scale``/``bias``), the head an
``nn.Linear``; ``convert.resnet_from_reference`` carries the reference's
across. Module names are flax's (``stem``, ``stage{s}_block{b}``,
``conv1``, ``norm1``, ``proj``, ``proj_norm``, ``head``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .llama import _trunc_normal


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)  # resnet-50
    num_filters: int = 64
    num_classes: int = 1000
    bottleneck: bool = True
    norm_groups: int = 32
    #: activation dtype; params are f32 and cast before each convolution
    dtype: torch.dtype = torch.bfloat16


def tiny(**kw) -> ResNetConfig:
    """Test/smoke config: 2 stages of basic blocks, tiny widths."""
    return ResNetConfig(**{**dict(
        stage_sizes=(1, 1), num_filters=8, num_classes=10,
        bottleneck=False, norm_groups=4, dtype=torch.float32,
    ), **kw})


def resnet18(**kw) -> ResNetConfig:
    return ResNetConfig(**{**dict(
        stage_sizes=(2, 2, 2, 2), bottleneck=False), **kw})


def resnet50(**kw) -> ResNetConfig:
    return ResNetConfig(**kw)


def resnet101(**kw) -> ResNetConfig:
    return ResNetConfig(**{**dict(stage_sizes=(3, 4, 23, 3)), **kw})


PRESETS = {"tiny": tiny, "resnet-18": resnet18, "resnet-50": resnet50,
           "resnet-101": resnet101}


def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME" for ``n`` inputs: the odd pad
    on the high side."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, stride: int, value: float = 0.0):
    """``x`` [b, c, h, w] with its "SAME" high-side excess padded by
    ``F.pad``; returns (x, the symmetric padding left to apply)."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], k, stride),
                          same_pads(x.shape[3], k, stride))
    if hl != wl:
        raise ValueError("non-square SAME padding")
    if hh > hl or wh > wl:
        last = x.is_contiguous(memory_format=torch.channels_last)
        x = F.pad(x, (0, wh - wl, 0, hh - hl), value=value)
        if last:
            x = x.contiguous(memory_format=torch.channels_last)
    return x, hl


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (s, s), use_bias=False)``: "SAME"
    padding, the kernel cast to the activation dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype, device):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k,
                                               device=device))

    def forward(self, x):
        x, pad = _pad_same(x, self.k, self.stride)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=pad)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon=1e-6)``: f32 statistics,
    f32 scale and bias, output in ``dtype``."""

    def __init__(self, groups: int, channels: int, dtype: torch.dtype,
                 device):
        super().__init__()
        self.groups, self.dtype = groups, dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight, self.bias,
                            eps=1e-6).to(self.dtype)


def _norm(cfg: ResNetConfig, features: int, device) -> GroupNorm:
    groups = min(cfg.norm_groups, features)
    while features % groups:
        groups -= 1
    return GroupNorm(groups, features, cfg.dtype, device)


class Block(nn.Module):
    """Basic residual block (3x3 + 3x3)."""

    def __init__(self, cfg: ResNetConfig, cin: int, filters: int,
                 strides: int, device):
        super().__init__()
        dt = cfg.dtype
        self.conv1 = Conv(cin, filters, 3, strides, dt, device)
        self.norm1 = _norm(cfg, filters, device)
        self.conv2 = Conv(filters, filters, 3, 1, dt, device)
        self.norm2 = _norm(cfg, filters, device)
        if cin != filters or strides != 1:
            self.proj = Conv(cin, filters, 1, strides, dt, device)
            self.proj_norm = _norm(cfg, filters, device)

    def forward(self, x):
        residual = x
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if hasattr(self, "proj"):
            residual = self.proj_norm(self.proj(residual))
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """v1.5 bottleneck: 1x1 reduce, 3x3 (stride here), 1x1 expand."""

    def __init__(self, cfg: ResNetConfig, cin: int, filters: int,
                 strides: int, device):
        super().__init__()
        dt, out = cfg.dtype, filters * 4
        self.conv1 = Conv(cin, filters, 1, 1, dt, device)
        self.norm1 = _norm(cfg, filters, device)
        self.conv2 = Conv(filters, filters, 3, strides, dt, device)
        self.norm2 = _norm(cfg, filters, device)
        self.conv3 = Conv(filters, out, 1, 1, dt, device)
        self.norm3 = _norm(cfg, out, device)
        if cin != out or strides != 1:
            self.proj = Conv(cin, out, 1, strides, dt, device)
            self.proj_norm = _norm(cfg, out, device)

    def forward(self, x):
        residual = x
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        if hasattr(self, "proj"):
            residual = self.proj_norm(self.proj(residual))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """NHWC images [b, h, w, 3] -> class logits [b, num_classes] (f32)."""

    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.stem = Conv(3, cfg.num_filters, 7, 2, cfg.dtype, device)
        self.stem_norm = _norm(cfg, cfg.num_filters, device)
        block_cls = BottleneckBlock if cfg.bottleneck else Block
        cin = cfg.num_filters
        self.blocks = []
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            filters = cfg.num_filters * 2 ** stage
            for b in range(n_blocks):
                name = f"stage{stage}_block{b}"
                setattr(self, name, block_cls(
                    cfg, cin, filters, 2 if stage > 0 and b == 0 else 1,
                    device))
                self.blocks.append(name)
                cin = filters * 4 if cfg.bottleneck else filters
        self.head = nn.Linear(cin, cfg.num_classes, device=device)
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """flax's initializers: lecun-normal kernels (fan-in k*k*in),
        GroupNorm scale 1 and bias 0, the head's bias 0; the draws differ
        from the reference's."""
        gen = torch.Generator(device=self.head.weight.device)
        gen.manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, Conv):
                w = mod.weight
                _trunc_normal(w, w.shape[1] * w.shape[2] * w.shape[3], gen)
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        _trunc_normal(self.head.weight, self.head.in_features, gen)
        self.head.bias.zero_()

    def forward(self, x):
        cfg = self.cfg
        x = x.permute(0, 3, 1, 2).to(cfg.dtype)  # NHWC memory, NCHW view
        x = F.relu(self.stem_norm(self.stem(x)))
        x, pad = _pad_same(x, 3, 2, value=float("-inf"))
        x = F.max_pool2d(x, 3, 2, padding=pad)
        for name in self.blocks:
            x = getattr(self, name)(x)
        # jnp.mean of the activations: f32 sum, rounded to their dtype
        x = x.float().mean(dim=(2, 3)).to(cfg.dtype)
        return self.head(x.float())


# -- JaxJob entrypoint (baseline config 2) ----------------------------------

IMAGE_SIZE = 32  # synthetic-data default; real ImageNet would use 224

_TEACHER: dict[tuple, np.ndarray] = {}


def synthetic_batch(key: int, batch: int, num_classes: int,
                    image_size: int = IMAGE_SIZE
                    ) -> tuple[np.ndarray, np.ndarray]:
    """NHWC f32 images from a numpy generator keyed by ``key``, labels from
    a fixed projection of the image (the deterministic teacher)."""
    x = np.random.default_rng([1, key]).standard_normal(
        (batch, image_size, image_size, 3)).astype(np.float32)
    shape = (image_size * image_size * 3, num_classes)
    if shape not in _TEACHER:
        _TEACHER[shape] = np.random.default_rng(11).standard_normal(
            shape).astype(np.float32)
    y = np.argmax(x.reshape(batch, -1) @ _TEACHER[shape], axis=-1)
    return x, y


def train_main(ctx, *, device=None) -> ResNet:
    """ResNet entrypoint for JaxJob pods (BASELINE config 2 analog): on the
    pod's device (``KFT_POD_DEVICE``, default the card), SGD with momentum
    0.9, per-step ``loss`` on stdout. With several processes, data parallel
    (``DistributedDataParallel`` over the job's group): each rank's batch
    is keyed by ``i * num_processes + process_id``, as in the reference,
    and ``loss`` is the global batch's mean, the same line on every rank.
    Returns the model."""
    from ..runtime import bootstrap

    steps = int(os.environ.get("KFT_STEPS", "10"))
    global_batch = int(os.environ.get("KFT_BATCH", "32"))
    lr = float(os.environ.get("KFT_LR", "0.1"))
    preset = os.environ.get("KFT_RESNET", "tiny")
    bootstrap.initialize(ctx)
    dev = bootstrap.pod_device(ctx, device)
    print(f"resnet: training {preset} on {dev}", flush=True)
    cfg = PRESETS[preset](num_classes=10)
    model = ResNet(cfg, device=dev)
    model.init_weights(0)
    net = data_parallel(model, ctx, dev)
    # optax.sgd(lr, momentum=0.9): trace = g + 0.9 trace; p -= lr trace
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    local_bs = global_batch // ctx.num_processes
    for i in range(steps):
        x, y = synthetic_batch(i * ctx.num_processes + ctx.process_id,
                               local_bs, cfg.num_classes)
        loss = F.cross_entropy(net(torch.from_numpy(x).to(dev)),
                               torch.from_numpy(y).to(dev))
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        bootstrap.emit_metric(ctx, "loss", global_mean(loss, ctx), step=i)
    return model


def data_parallel(model, ctx, dev):
    """``model`` under ``DistributedDataParallel`` over the job's group
    when the job has several processes (gradients averaged over the ranks,
    the parameters broadcast from rank 0 first), else ``model``."""
    if ctx.num_processes == 1:
        return model
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(
        model, device_ids=[dev] if dev.type == "cuda" else None)


def global_mean(value, ctx) -> float:
    """A per-rank scalar's mean over the job's processes (each holds as
    many rows)."""
    value = value.detach().float().reshape(())
    if ctx.num_processes > 1:
        import torch.distributed as dist

        value = value.clone()
        dist.all_reduce(value)
        value = value / ctx.num_processes
    return float(value)
