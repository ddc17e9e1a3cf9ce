"""AdamW exactly as the reference trainer builds it with optax.

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

Parameters are updated in place.
"""

from __future__ import annotations

import math

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
                 mu_dtype: torch.dtype | None = torch.bfloat16):
        self.params = list(params)
        self.lr, self.warmup, self.decay_steps = (
            learning_rate, warmup_steps, decay_steps)
        self.b1, self.b2 = b1, b2
        self.weight_decay, self.clip = weight_decay, grad_clip_norm
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        # b1 rounded to mu's dtype: the product then rounds like jax's
        # weak-typed python scalar
        self._b1_mu = [float(torch.tensor(b1, dtype=mu.dtype))
                       for mu in self.mu]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the params' ``.grad``; returns the global
        grad norm before clipping (a 0-d tensor on the params' device)."""
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        lr = -warmup_cosine_decay(self.count, self.lr, self.warmup,
                                  self.decay_steps)
        t = self.count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(t))
        for p, g, mu, nu, b1_mu in zip(self.params, grads, self.mu, self.nu,
                                       self._b1_mu):
            g = torch.where(norm < self.clip, g, (g / norm) * self.clip)
            m = (1 - self.b1) * g + (mu * b1_mu).float()
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (m / bc1) / (torch.sqrt(nu / bc2) + EPS)
            u = u + self.weight_decay * p
            p.add_(u * lr)
            mu.copy_(m)
        self.count += 1
        return norm
