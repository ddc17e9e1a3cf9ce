"""Mixture-of-Experts MLP: the port of ``kubeflow_tpu/models/moe.py`` on one
device.

Routing is the reference's: an f32 router, softmax, top-k, gates
renormalised over the k choices, and the Switch load-balancing loss, which
the layer returns beside its output (``(y, aux)``) instead of sowing it.
Two dispatches:

- ``"dense"``: GShard capacity dispatch, one-hot einsums, tokens past an
  expert's capacity dropped;
- ``"ragged"``: dropless. Each token is repeated for its k choices and the
  copies are sorted by expert (stable), so every expert owns one contiguous
  row range, and the experts run on the grouped GEMM
  (``ops/grouped_matmul.py``: the Hopper kernels on the card, their plain
  versions on the CPU).

The ragged path is the reference's single-device branch (expert axis of 1)
with its grouped compute. Its offsets are computed on the device
(``searchsorted`` over the sorted expert ids), so the layer makes no host
sync, and no rows are padded: the kernels mask the ragged row tile. The
reference's other expert compute, masked per-expert matmuls over every row
(its ``moe_ragged_compute="masked"``, chosen off a TPU), is not ported: the
grouped GEMM gives the same result on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grouped_matmul import grouped_matmul


class _Permute(torch.autograd.Function):
    """``x[order]`` whose backward is ``g[inv]``: a gather, not the
    scatter-add autograd derives for an index's transpose."""

    @staticmethod
    def forward(ctx, x, order, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, order)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g.index_select(0, inv), None, None


class _GatherTokens(torch.autograd.Function):
    """``xf[order // k]`` (each token fanned out to its k expert copies, in
    expert order) whose backward is a gather by ``inv`` and a k-way
    reshape-sum, with no scatter-add."""

    @staticmethod
    def forward(ctx, xf, order, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return xf.index_select(0, order // k)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        g_tok = g.index_select(0, inv)
        return g_tok.reshape(-1, ctx.k, *g.shape[1:]).sum(1), None, None, None


def _one_hot(idx, n: int) -> torch.Tensor:
    """``idx`` one-hot over ``n`` classes, in f32."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class MoeMlp(nn.Module):
    """Drop-in MoE replacement for the gated MLP; ``forward`` returns
    ``(y, aux)`` with aux the layer's Switch load-balancing loss (f32)."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        e, h, m = cfg.moe_experts, cfg.hidden_size, cfg.intermediate_size
        self.router = nn.Parameter(torch.empty(h, e, device=device))
        self.w_gate = nn.Parameter(torch.empty(e, h, m, device=device))
        self.w_up = nn.Parameter(torch.empty(e, h, m, device=device))
        self.w_down = nn.Parameter(torch.empty(e, m, h, device=device))

    def init_weights(self, gen):
        """Router normal(0.02); experts fan-in truncated normal over axis 1
        (the reference's ``in_axis=(1,)``)."""
        from .llama import _trunc_normal  # llama.py imports this module

        self.router.normal_(0.0, 0.02, generator=gen)
        for w in (self.w_gate, self.w_up, self.w_down):
            _trunc_normal(w, w.shape[1], gen)

    def route(self, x):
        """(probs [b,s,e] f32, gates [b,s,k] f32, expert ids [b,s,k])."""
        cfg = self.cfg
        probs = (x.float() @ self.router).softmax(dim=-1)
        gates, idx = probs.topk(cfg.moe_top_k, dim=-1)
        if cfg.moe_normalize_topk:
            gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
        return probs, gates, idx

    def forward(self, x):
        cfg = self.cfg
        e, k = cfg.moe_experts, cfg.moe_top_k
        s = x.shape[1]
        probs, gates, idx = self.route(x)
        # Switch aux loss over assignments before capacity: uniform routing
        # gives 1, collapse onto one expert ~e
        expert_mask = _one_hot(idx, e)                       # [b, s, k, e]
        frac_tokens = expert_mask.sum(dim=(1, 2)).mean(0) / (s * k)
        aux = e * (frac_tokens * probs.mean(dim=(0, 1))).sum()
        if cfg.moe_dispatch == "ragged":
            return self._ragged(x, idx, gates), aux
        return self._dense(x, gates, expert_mask), aux

    def _dense(self, x, gates, expert_mask):
        """GShard capacity dispatch (sequence-major priority)."""
        cfg = self.cfg
        dt = cfg.dtype
        b, s, k, e = expert_mask.shape
        capacity = max(1, int(cfg.moe_capacity_factor * k * s / e))
        flat = expert_mask.transpose(1, 2).reshape(b, k * s, e)
        pos_flat = flat.cumsum(dim=1) - flat                 # queue index
        pos = pos_flat.reshape(b, k, s, e).transpose(1, 2)   # [b, s, k, e]
        dispatch_k = expert_mask * (pos < capacity).float()
        cpos = (pos * dispatch_k).sum(-1).long()             # [b, s, k]
        cap_onehot = _one_hot(cpos, capacity)
        dispatch = torch.einsum("bske,bskc->bsec", dispatch_k, cap_onehot)
        combine = torch.einsum("bske,bskc,bsk->bsec", dispatch_k, cap_onehot,
                               gates)
        xin = torch.einsum("bsec,bsh->ebch", dispatch.to(dt), x)
        hidden = (F.silu(torch.einsum("ebch,ehm->ebcm", xin,
                                      self.w_gate.to(dt)))
                  * torch.einsum("ebch,ehm->ebcm", xin, self.w_up.to(dt)))
        out_e = torch.einsum("ebcm,emh->ebch", hidden, self.w_down.to(dt))
        return torch.einsum("bsec,ebch->bsh", combine.to(dt), out_e)

    def _ragged(self, x, idx, gates):
        """Dropless dispatch: sort the token copies by expert, run the
        experts over contiguous row ranges, unsort, combine with the gates."""
        cfg = self.cfg
        dt = cfg.dtype
        b, s, h = x.shape
        e, k = cfg.moe_experts, cfg.moe_top_k
        n = b * s
        flat_expert = idx.reshape(n * k)
        order = torch.argsort(flat_expert, stable=True)
        inv = torch.argsort(order)
        sorted_expert = flat_expert.index_select(0, order)
        xs = _GatherTokens.apply(x.reshape(n, h), order, inv, k).to(dt)
        wg, wu, wd = (w.to(dt) for w in (self.w_gate, self.w_up, self.w_down))
        offsets = torch.searchsorted(
            sorted_expert, torch.arange(e + 1, device=x.device),
            out_int32=True)
        hidden = (F.silu(grouped_matmul(xs, wg, offsets))
                  * grouped_matmul(xs, wu, offsets))
        y_sorted = grouped_matmul(hidden, wd, offsets)
        y = _Permute.apply(y_sorted, inv, order).reshape(n, k, h)
        y = (y * gates.reshape(n, k, 1).to(dt)).sum(1)
        return y.reshape(b, s, h)

