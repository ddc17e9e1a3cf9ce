"""Llama-family decoder in PyTorch: the port of ``kubeflow_tpu/models/llama.py``.

Covers the training path of the bench models: RMSNorm, split-halves rope,
GQA attention (``dense`` or the Hopper ``flash`` kernels), SwiGLU MLP or the
Mixture-of-Experts MLP of ``moe.py``, embedding and head (optionally tied),
with per-block rematerialisation. Parameters keep the reference's Einsum
kernel layouts (wq ``[E,H,D]``, wk/wv ``[E,K,D]``, wo ``[H,D,E]``,
w_gate/w_up ``[E,M]``, w_down ``[M,E]``, unembedding ``[E,V]``; MoE router
``[E,X]`` and experts ``[X,E,M]``/``[X,M,E]``) in f32 and are cast to the
activation dtype before each product, as the reference does, so
``convert.py`` maps weights by name alone.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from .moe import MoeMlp


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    #: activation dtype; params are always f32 and cast before each product
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    #: "dots" keeps every matmul output and recomputes the rest of the block
    #: in the backward pass (flash attention's forward runs again); "nothing"
    #: recomputes the whole block
    remat_policy: str = "dots"
    #: "dense" = plain causal attention; "flash" = the Hopper kernels
    attention_impl: str = "dense"
    tie_embeddings: bool = False
    #: Mixture-of-Experts MLP (``moe.py``): 0 = the dense MLP; > 0 = number
    #: of experts, each token routed to its top ``moe_top_k``
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_normalize_topk: bool = True
    #: "dense" = capacity dispatch (tokens past capacity dropped); "ragged" =
    #: dropless sort-by-expert dispatch
    moe_dispatch: str = "dense"

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if self.attention_impl not in ("dense", "flash"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.remat_policy not in ("dots", "nothing"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.moe_dispatch not in ("dense", "ragged"):
            raise ValueError(f"unknown moe_dispatch {self.moe_dispatch!r}")


def tiny(**kw) -> LlamaConfig:
    """Test config: runs on the CPU in well under a second."""
    return LlamaConfig(**{
        **dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               dtype=torch.float32, remat=False),
        **kw,
    })


def bench_model(**kw) -> LlamaConfig:
    """The ~271M bench model of ``__graft_entry__._bench_model``."""
    return LlamaConfig(**{
        **dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
               num_layers=16, num_heads=8, num_kv_heads=8, head_dim=128,
               remat=True, attention_impl="flash"),
        **kw,
    })


def bench_moe_model(**kw) -> LlamaConfig:
    """The MoE bench model: the 271M trunk with 8 experts, top-2, dropless
    (``scripts/moe_bench.py``'s configuration at full depth); 1.24B params,
    410M active per token."""
    return bench_model(**{
        **dict(moe_experts=8, moe_top_k=2, moe_dispatch="ragged"),
        **kw,
    })


def _param_count(cfg: LlamaConfig, experts: int) -> int:
    """Parameters of the model with ``experts`` expert MLPs per layer (plus
    the router when the config has experts)."""
    h, v, m = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    attn = (h * cfg.num_heads * cfg.head_dim * 2
            + h * cfg.num_kv_heads * cfg.head_dim * 2)
    router = h * cfg.moe_experts
    per_layer = attn + experts * 3 * h * m + router + 2 * h
    out = v * h if cfg.tie_embeddings else 2 * v * h
    return per_layer * cfg.num_layers + out + h


def num_params(cfg: LlamaConfig) -> int:
    """Closed-form count of every parameter. (The reference's counts one
    expert MLP and no router for an MoE model.)"""
    return _param_count(cfg, cfg.moe_experts or 1)


def active_params(cfg: LlamaConfig) -> int:
    """Parameters one token passes through: its top-k experts and the
    router for an MoE model, every parameter for a dense one."""
    return _param_count(cfg, cfg.moe_top_k if cfg.moe_experts else 1)


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Train FLOPs/token: 6 x the active params plus the causal attention
    term (lower triangle only: 6*L*h*d*s)."""
    attn = 6 * cfg.num_layers * cfg.num_heads * cfg.head_dim * seq_len
    return 6.0 * active_params(cfg) + attn


# -- building blocks --------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.scale).to(self.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding, split halves; x: [b, s, heads, head_dim]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[:, None].float() * freqs          # [s, half]
    cos, sin = angles.cos()[:, None, :], angles.sin()[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _causal_attention(q, k, v, q_per_kv: int):
    """Dense causal GQA attention in f32 (the reference's dense path)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qh = q.reshape(b, s, kv, q_per_kv, d).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float()) / math.sqrt(d)
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~keep, -1e30)
    probs = logits.softmax(dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        e, h, k, d = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim)
        self.wq = nn.Parameter(torch.empty(e, h, d, device=device))
        self.wk = nn.Parameter(torch.empty(e, k, d, device=device))
        self.wv = nn.Parameter(torch.empty(e, k, d, device=device))
        self.wo = nn.Parameter(torch.empty(h, d, e, device=device))

    def init_weights(self, gen):
        e, hd = self.cfg.hidden_size, self.cfg.num_heads * self.cfg.head_dim
        for w, fan_in in ((self.wq, e), (self.wk, e), (self.wv, e),
                          (self.wo, hd)):
            _trunc_normal(w, fan_in, gen)

    def forward(self, x, positions):
        cfg = self.cfg
        b, s, e = x.shape
        dt = cfg.dtype
        q = (x @ self.wq.to(dt).reshape(e, -1)).view(
            b, s, cfg.num_heads, cfg.head_dim)
        k = (x @ self.wk.to(dt).reshape(e, -1)).view(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        v = (x @ self.wv.to(dt).reshape(e, -1)).view(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, q_per_kv=cfg.q_per_kv)
        else:
            out = _causal_attention(q, k, v, cfg.q_per_kv)
        return out.reshape(b, s, -1) @ self.wo.to(dt).reshape(-1, e)


class Mlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        e, m = cfg.hidden_size, cfg.intermediate_size
        self.w_gate = nn.Parameter(torch.empty(e, m, device=device))
        self.w_up = nn.Parameter(torch.empty(e, m, device=device))
        self.w_down = nn.Parameter(torch.empty(m, e, device=device))

    def init_weights(self, gen):
        e, m = self.cfg.hidden_size, self.cfg.intermediate_size
        for w, fan_in in ((self.w_gate, e), (self.w_up, e), (self.w_down, m)):
            _trunc_normal(w, fan_in, gen)

    def forward(self, x):
        dt = self.cfg.dtype
        h = F.silu(x @ self.w_gate.to(dt)) * (x @ self.w_up.to(dt))
        return h @ self.w_down.to(dt)


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                                 device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                                device)
        self.mlp = (MoeMlp(cfg, device) if cfg.moe_experts > 0
                    else Mlp(cfg, device))

    def forward(self, x, positions):
        """(x, aux): aux is the MoE layer's load-balancing loss, else None."""
        x = x + self.attn(self.attn_norm(x), positions)
        if isinstance(self.mlp, MoeMlp):
            y, aux = self.mlp(self.mlp_norm(x))
            return x + y, aux
        return x + self.mlp(self.mlp_norm(x)), None


class Embedder(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, device=device))

    def forward(self, tokens):
        # out-of-range ids clamp, like the reference's gather
        tokens = tokens.clamp(0, self.cfg.vocab_size - 1)
        return F.embedding(tokens, self.embedding.to(self.cfg.dtype))


class Head(nn.Module):
    """Final norm + unembedding; logits in the activation dtype."""

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  cfg.dtype, device)
        if not cfg.tie_embeddings:
            self.unembedding = nn.Parameter(
                torch.empty(cfg.hidden_size, cfg.vocab_size, device=device))

    def forward(self, x, embed_table=None):
        x = self.final_norm(x)
        dt = self.cfg.dtype
        if self.cfg.tie_embeddings:
            return x @ embed_table.to(dt).t()
        return x @ self.unembedding.to(dt)


def _trunc_normal(w, fan_in, gen):
    """flax variance_scaling(1.0, "fan_in", "truncated_normal")."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


#: what the "dots" policy keeps across the backward pass: matmul outputs
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embedder = Embedder(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.num_layers))
        self.head = Head(cfg, device)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Random init from ``seed``: embeddings and MoE routers
        normal(0.02), projections and experts fan-in truncated normal, norm
        scales one (the reference's initializers; its random draws
        differ)."""
        gen = torch.Generator(device=self.embedder.embedding.device)
        gen.manual_seed(seed)
        self.embedder.embedding.normal_(0.0, 0.02, generator=gen)
        for blk in self.layers:
            blk.attn.init_weights(gen)
            blk.mlp.init_weights(gen)
            blk.attn_norm.scale.fill_(1.0)
            blk.mlp_norm.scale.fill_(1.0)
        self.head.final_norm.scale.fill_(1.0)
        if not self.cfg.tie_embeddings:
            self.head.unembedding.normal_(0.0, 0.02, generator=gen)

    def forward(self, tokens, return_aux: bool = False):
        """Logits; with ``return_aux``, (logits, the MoE load-balancing loss
        averaged over layers, or None for a dense model)."""
        cfg = self.cfg
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
        x = self.embedder(tokens)
        remat = cfg.remat and torch.is_grad_enabled()
        auxes = []
        for blk in self.layers:
            if not remat:
                x, aux = blk(x, positions)
            elif cfg.remat_policy == "dots":
                x, aux = checkpoint(
                    blk, x, positions, use_reentrant=False,
                    context_fn=functools.partial(
                        create_selective_checkpoint_contexts, _DOTS))
            else:
                x, aux = checkpoint(blk, x, positions, use_reentrant=False)
            if aux is not None:
                auxes.append(aux)
        table = self.embedder.embedding if cfg.tie_embeddings else None
        logits = self.head(x, table)
        if not return_aux:
            return logits
        return logits, torch.stack(auxes).mean() if auxes else None
