"""The reference's optax optimizers, operation by operation: the trainer's
AdamW and Adafactor (below), and the plain ``Adam`` (``optax.adam`` /
``optax.adamw`` at a constant rate: the DARTS supernet's two).

AdamW exactly as the reference trainer builds it with optax.

``optax.chain(clip_by_global_norm(clip), adamw(warmup_cosine_decay_schedule(
0, lr, warmup, max(steps, warmup + 1)), b1, b2, eps=1e-8, weight_decay,
mu_dtype))``, reproduced operation by operation (``torch.optim.AdamW`` differs:
its learning rate is not evaluated at the pre-increment count, it decays
weights before the moment update, and it has no bf16 first moment). In order,
for every parameter:

1. clip: g = g if n < clip else (g / n) * clip, with n the global grad
   norm: optax's predicate, on the device (no host read), so a NaN norm
   takes the clipping branch and every parameter turns NaN, as in optax;
2. mu = (1 - b1) * g + b1 * mu, in f32 from the stored mu; when mu is stored
   in bf16, ``b1 * mu`` is a bf16 product with b1 rounded to bf16 (jax's weak
   typing of the python scalar);
3. nu = (1 - b2) * g * g + b2 * nu, f32;
4. u = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps) with t = count+1;
5. u = u + weight_decay * p, for every parameter (no mask);
6. p = p + (-lr(count)) * u, with the schedule at the pre-increment count,
   so the first step's learning rate is the warmup's initial value, 0;
7. mu is stored back in its dtype, count += 1.

Parameters are updated in place. On a mesh (``parallel.sharding``) each
rank updates the shards it holds: the moments are local tensors shaped like
them, and the global norm sums every rank's local squares, each parameter
weighted by 1 / the number of ranks holding each of its elements
(``norm_weights``), so a parameter replicated over ``model`` counts once and
the norm equals the unsharded one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

#: optax's adam eps (the reference trainer leaves it at the default)
EPS = 1e-8


def warmup_cosine_decay(count: int, peak: float, warmup_steps: int,
                        decay_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps) at
    ``count``, in f32 arithmetic like the reference."""
    f32 = np.float32
    if count < warmup_steps:
        frac = f32(1) - f32(count) / f32(warmup_steps)
        return float(f32(-peak) * frac + f32(peak))
    t = f32(min(count - warmup_steps, decay_steps - warmup_steps))
    cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t
                                      / f32(decay_steps - warmup_steps)))
    return float(f32(peak) * cos)


class AdamW:
    def __init__(self, params, *, learning_rate: float, warmup_steps: int,
                 decay_steps: int, b1: float = 0.9, b2: float = 0.95,
                 weight_decay: float = 0.1,
                 grad_clip_norm: float = 1.0,
                 mu_dtype: torch.dtype | None = torch.bfloat16,
                 norm_weights: list[float] | None = None):
        self.params = list(params)
        #: the sharded global norm's weights (None: one process, unsharded)
        self.norm_weights = norm_weights
        self.lr, self.warmup, self.decay_steps = (
            learning_rate, warmup_steps, decay_steps)
        self.b1, self.b2 = b1, b2
        self.weight_decay, self.clip = weight_decay, grad_clip_norm
        self.mu = [torch.zeros_like(_local(p), dtype=mu_dtype or p.dtype)
                   for p in self.params]
        # b1 rounded to mu's dtype: the product then rounds like jax's
        # weak-typed python scalar
        self._b1_mu = [float(torch.tensor(b1, dtype=mu.dtype))
                       for mu in self.mu]
        self.nu = [torch.zeros_like(_local(p)) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the params' ``.grad``; returns the global
        grad norm before clipping (a 0-d tensor on the params' device)."""
        grads = [_local(p.grad) for p in self.params]
        norm = _global_norm(grads, self.norm_weights)
        lr = -warmup_cosine_decay(self.count, self.lr, self.warmup,
                                  self.decay_steps)
        t = self.count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(t))
        for p, g, mu, nu, b1_mu in zip(map(_local, self.params), grads,
                                       self.mu, self.nu, self._b1_mu):
            g = torch.where(norm < self.clip, g, (g / norm) * self.clip)
            m = (1 - self.b1) * g + (mu * b1_mu).float()
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (m / bc1) / (torch.sqrt(nu / bc2) + EPS)
            u = u + self.weight_decay * p
            p.add_(u * lr)
            mu.copy_(m)
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        _load_list(self.mu, state["mu"], "mu")
        _load_list(self.nu, state["nu"], "nu")
        self.count = int(state["count"])


def _load_list(dst: list, src: list, what: str) -> None:
    if len(dst) != len(src):
        raise ValueError(f"optimizer state {what}: {len(src)} tensors for "
                         f"{len(dst)} parameters")
    for d, x in zip(dst, src):
        if d.shape != x.shape:
            raise ValueError(f"optimizer state {what}: shape "
                             f"{tuple(x.shape)} != {tuple(d.shape)}")
        d.copy_(x)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (FSDP2's parameters and gradients);
    any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _global_norm(grads, weights=None) -> torch.Tensor:
    """The L2 norm of every gradient. With ``weights`` the gradients are
    this rank's shards: each local square sum is weighted and the sum is
    all-reduced over the world."""
    if weights is None:
        return torch.sqrt(sum(g.float().square().sum() for g in grads))
    import torch.distributed as dist

    sq = sum(w * g.float().square().sum() for g, w in zip(grads, weights))
    dist.all_reduce(sq)
    return torch.sqrt(sq)


def factored_dims(shape, factored: bool = True,
                  min_dim_size_to_factor: int = 128):
    """optax's ``_factored_dims``: the two largest axes (second largest,
    largest) when the second largest is at least the minimum, else None."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


@dataclasses.dataclass(frozen=True)
class LeafCut:
    """How a leaf's tensors are split over ranks on a mesh
    (``Trainer._leaf_groups``): ``dims`` maps a dim of one tensor to the
    process group whose ranks hold its slices, and ``whole`` is the group
    of every rank holding a part of the leaf (its slices and, under
    ``pipeline``, its other layers), over which its block sums run. The
    default is a leaf held whole by this process."""

    dims: dict = dataclasses.field(default_factory=dict)
    whole: Any = None


class Adafactor:
    """``optax.chain(clip_by_global_norm(clip), adafactor(schedule,
    min_dim_size_to_factor=128))`` as the reference trainer builds it, with
    optax's defaults: factored second moments with the ``1 - t^-0.8``
    decay, eps 1e-30, block-RMS clipping at 1.0, the learning rate at the
    pre-increment count, ``multiply_by_parameter_scale`` (min scale 1e-3),
    no momentum and no weight decay. Not ``torch.optim.Adafactor``, whose
    update and defaults differ.

    A "block" is one leaf of the reference's tree: with scan-stacked
    layers the stack of one projection over every layer. So ``groups``
    lists each leaf as ``(stacked shape, [its tensors], LeafCut)``; its
    factored
    axes come from the stacked shape, and its block RMS and parameter
    scale are taken over all its tensors. In order, per leaf:

    1. clip: as ``AdamW`` (on the device, optax's branch on a NaN norm);
    2. g2 = g*g + eps; factored (axes d1 < d0 by size): v_row =
       d*v_row + (1-d)*mean(g2, d0), v_col likewise over d1, u = g *
       (v_row / mean(v_row, d1))^-1/2 * v_col^-1/2; else v = d*v +
       (1-d)*g2, u = g * v^-1/2; with d = 1 - (count+1)^-0.8 in f32;
    3. u /= max(1, rms(u));
    4. u = lr(count) * u;
    5. u *= max(rms(p), 1e-3) (rms(p) when above 1e-3, else 1e-3);
    6. p += -u.

    On a mesh each tensor is this rank's shard, and the shape is still
    the whole leaf's (every layer's, each tensor unsharded), so the
    factored axes are the unsharded tree's. A mean over a split dim is the
    local sum all-reduced over the group that splits it (``LeafCut.dims``,
    keyed by the parameter's dim), over the whole size; the
    block sums of u and p are all-reduced over every rank holding part of
    the leaf; the global norm weighs each local square sum as ``AdamW``'s
    (``norm_weights``). The moments are shaped like the shards, minus the
    dim each reduces.
    """

    def __init__(self, groups, *, learning_rate: float, warmup_steps: int,
                 decay_steps: int, grad_clip_norm: float = 1.0,
                 min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
                 eps: float = 1e-30, clipping_threshold: float = 1.0,
                 min_scale: float = 1e-3,
                 norm_weights: list[float] | None = None):
        self.lr, self.warmup, self.decay_steps = (
            learning_rate, warmup_steps, decay_steps)
        self.clip, self.decay_rate, self.eps = grad_clip_norm, decay_rate, eps
        self.threshold, self.min_scale = clipping_threshold, min_scale
        self.norm_weights = norm_weights
        #: each leaf's (tensors, factored axes of the stacked shape, of one
        #: tensor, stacked shape, ``LeafCut``)
        self.groups = []
        self.v_row, self.v_col, self.v = [], [], []
        for shape, parts, cut in groups:
            parts = list(parts)
            shape = tuple(shape)
            layered = len(shape) == parts[0].dim() + 1
            one = tuple(parts[0].shape)
            if cut.whole is None and shape != ((len(parts), *one)
                                               if layered else one):
                raise ValueError(f"leaf of shape {shape} from {len(parts)} "
                                 f"tensors of {one}")
            dims = factored_dims(shape, True, min_dim_size_to_factor)
            off = 1 if layered else 0
            if dims is not None and off and 0 in dims:
                raise NotImplementedError(
                    f"factoring leaf {shape} over its layer axis")
            # the factored axes within one tensor of the leaf
            local = None if dims is None else (dims[0] - off, dims[1] - off)
            self.groups.append((parts, dims, local, shape, cut))
            for p in map(_local, parts):
                if local is None:
                    self.v_row.append(None)
                    self.v_col.append(None)
                    self.v.append(torch.zeros_like(p))
                else:
                    d1, d0 = local
                    self.v_row.append(torch.zeros_like(p.sum(d0)))
                    self.v_col.append(torch.zeros_like(p.sum(d1)))
                    self.v.append(None)
        self.params = [p for parts, *_ in self.groups for p in parts]
        self.count = 0

    @staticmethod
    def _mean(tensors, dim: int, size: int, group) -> list:
        """``t.mean(dim)`` of each tensor of a leaf, whose dim ``dim`` holds
        ``size`` elements in all: one all-reduce of their local sums over
        ``group``, the ranks that split that dim (None: none does)."""
        if group is None:
            return [t.mean(dim) for t in tensors]
        import torch.distributed as dist

        sums = torch.stack([t.sum(dim) for t in tensors])
        dist.all_reduce(sums, group=group)
        return list(sums / size)

    def moment_drops(self) -> dict[str, list]:
        """{moment: for each parameter, the dim of it that the moment
        reduces away (None: shaped like it, or no moment)}: how a
        checkpoint gathers and lays out each one."""
        out: dict[str, list] = {"v_row": [], "v_col": [], "v": []}
        for parts, _, local, *_ in self.groups:
            for _ in parts:
                out["v_row"].append(None if local is None else local[1])
                out["v_col"].append(None if local is None else local[0])
                out["v"].append(None)
        return out

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the params' ``.grad``; returns the global
        grad norm before clipping (a 0-d tensor on the params' device)."""
        f32 = np.float32
        grads = [_local(p.grad) for p in self.params]
        norm = _global_norm(grads, self.norm_weights)
        lr = warmup_cosine_decay(self.count, self.lr, self.warmup,
                                 self.decay_steps)
        decay = f32(1.0) - f32(self.count + 1) ** f32(-self.decay_rate)
        d, one_minus_d = float(decay), float(f32(1.0) - decay)
        i = 0
        for parts, _, local, shape, cut in self.groups:
            n = len(parts)
            gs = [torch.where(norm < self.clip, g, (g / norm) * self.clip)
                  for g in grads[i:i + n]]
            g2s = [g * g + self.eps for g in gs]
            if local is None:
                updates = []
                for v, g, g2 in zip(self.v[i:i + n], gs, g2s):
                    v.copy_(d * v + one_minus_d * g2)
                    updates.append(g * v ** -0.5)
            else:
                d1, d0 = local
                full = shape[len(shape) - gs[0].dim():]
                vrs, vcs = self.v_row[i:i + n], self.v_col[i:i + n]
                rows = self._mean(g2s, d0, full[d0], cut.dims.get(d0))
                cols = self._mean(g2s, d1, full[d1], cut.dims.get(d1))
                for vr, vc, r, c in zip(vrs, vcs, rows, cols):
                    vr.copy_(d * vr + one_minus_d * r)
                    vc.copy_(d * vc + one_minus_d * c)
                # v_row's dim that was the parameter's d1; the group that
                # splits it is d1's
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                means = self._mean(vrs, reduced_d1, full[d1],
                                   cut.dims.get(d1))
                updates = [
                    g * ((vr / m.unsqueeze(reduced_d1)) ** -0.5).unsqueeze(d0)
                    * (vc ** -0.5).unsqueeze(d1)
                    for g, vr, vc, m in zip(gs, vrs, vcs, means)]
            held = [_local(p) for p in parts]
            if cut.whole is None:
                rms_u, rms_p = self._rms(updates), self._rms(held)
            else:
                import torch.distributed as dist

                sq = torch.stack([sum(t.square().sum() for t in updates),
                                  sum(t.square().sum() for t in held)])
                dist.all_reduce(sq, group=cut.whole)
                rms_u, rms_p = torch.sqrt(sq / math.prod(shape))
            denom = torch.clamp_min(rms_u / self.threshold, 1.0)
            scale = torch.where(rms_p <= self.min_scale,
                                torch.full_like(rms_p, self.min_scale), rms_p)
            for p, u in zip(held, updates):
                u = lr * (u / denom)
                u = u * scale
                p.add_(u * -1)
            i += n
        self.count += 1
        return norm

    @staticmethod
    def _rms(tensors) -> torch.Tensor:
        n = sum(t.numel() for t in tensors)
        return torch.sqrt(sum(t.square().sum() for t in tensors) / n)

    def state_dict(self) -> dict:
        return {"count": self.count, "v_row": list(self.v_row),
                "v_col": list(self.v_col), "v": list(self.v)}

    def load_state_dict(self, state: dict) -> None:
        for what in ("v_row", "v_col", "v"):
            mine = getattr(self, what)
            if len(mine) != len(state[what]):
                raise ValueError(f"optimizer state {what}: "
                                 f"{len(state[what])} entries for "
                                 f"{len(mine)} parameters")
            for dst, src in zip(mine, state[what]):
                if (dst is None) != (src is None):
                    raise ValueError(f"optimizer state {what}: factoring "
                                     "differs from the saved state")
                if dst is not None:
                    _load_list([dst], [src], what)
        self.count = int(state["count"])


class Adam:
    """``optax.adam(lr, b1, b2, eps)``, or ``optax.adamw(lr, b1, b2, eps,
    weight_decay)`` with ``weight_decay`` > 0 (optax's adamw default is
    1e-4, torch's 1e-2), at a constant learning rate, no clipping. Per
    parameter: mu = (1 - b1) g + b1 mu; nu = (1 - b2) g g + b2 nu;
    u = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps), t = count + 1;
    u += weight_decay * p; p += -lr * u. Parameters are updated in place."""

    def __init__(self, params, *, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = EPS,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        t = self.count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(t))
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * -self.lr)
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

