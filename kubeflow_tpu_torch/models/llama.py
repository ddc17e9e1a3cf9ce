"""Llama-family decoder in PyTorch: the port of ``kubeflow_tpu/models/llama.py``.

Covers the training path of the bench models: RMSNorm, split-halves rope,
GQA attention (``dense`` or the Hopper ``flash`` kernels), SwiGLU MLP or the
Mixture-of-Experts MLP of ``moe.py``, embedding and head (optionally tied),
with per-block rematerialisation. Parameters keep the reference's Einsum
kernel layouts (wq ``[E,H,D]``, wk/wv ``[E,K,D]``, wo ``[H,D,E]``,
w_gate/w_up ``[E,M]``, w_down ``[M,E]``, unembedding ``[E,V]``; MoE router
``[E,X]`` and experts ``[X,E,M]``/``[X,M,E]``) in f32 (``param_dtype``:
bf16 for a bf16 snapshot) and are cast to the activation dtype before each
product, as the reference does, so ``convert.py`` maps weights by name
alone.

A projection ``w`` may carry LoRA adapters ``w_lora_a`` ``[in..., r]`` and
``w_lora_b`` ``[r, out...]`` (``lora_rank``; the reference's
``lora_a``/``lora_b`` leaves) and, for serving, be stored int8 with a
per-output-channel f32 ``w_scale`` (``quant_weights``; the reference's
``kernel``/``scale``). The snapshot I/O, the adapter functions and
``quantize_for_serving`` are the reference's, on the port's state dicts.

Laid out on a mesh (``parallel.sharding.shard_model``), the model runs
tensor parallel over a ``model`` axis (Megatron-LM's layout: column- and
row-parallel projections, h/tp query and kv/tp KV heads per rank, the
vocabulary split over the embedding and the head) and its MoE layers
expert parallel (``moe.py``); FSDP2 shards what each rank holds.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.collectives import (
    copy_to_group,
    gather_last_dim,
    reduce_from_group,
)
from ..parallel.ring_attention import ring_attention
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
    #: KV-cache length of the decode path (``KvCache``), the serving
    #: engine's context limit
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    #: activation dtype; params are cast to it before each product
    dtype: torch.dtype = torch.bfloat16
    #: the parameters' dtype: f32, or bf16 for a snapshot written so (the
    #: reference's ``param_dtype``: its ``config.json`` key, halving the
    #: bytes a serving engine holds and streams); the norms' scales and
    #: the MoE router stay f32 whatever it says, as in the reference
    #: (``leaf_dtype``)
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    #: "dots" keeps every matmul output and recomputes the rest of the block
    #: in the backward pass (flash attention's forward runs again); "nothing"
    #: recomputes the whole block
    remat_policy: str = "dots"
    #: "dense" = plain causal attention; "flash" = the Hopper kernels;
    #: "ring" = ring attention over the layout's ``seq`` axis
    #: (``parallel/ring_attention.py``: K1-K3 blocks on the card, the plain
    #: fold on the CPU); where there is none, flash attention on the card
    #: and dense attention on the CPU
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
    #: serving only: every projection kernel and the unembedding stored
    #: int8 with per-output-channel f32 scales applied to the product
    #: (``quantize_for_serving``)
    quant_weights: bool = False
    #: serving only: the KV cache in int8 with one f32 absmax scale per
    #: (row, kv head, position), dequantized into the f32 attend math
    quant_kv: bool = False
    #: LoRA: rank > 0 adds ``y += ((x @ a) @ b) * lora_scale`` to each
    #: projection named in ``lora_targets`` (never merged while training)
    lora_rank: int = 0
    lora_alpha: float = 0.0  # 0 -> alpha = rank (scale 1.0)
    lora_targets: tuple[str, ...] = ("wq", "wv")

    @property
    def lora_scale(self) -> float:
        return (self.lora_alpha or float(self.lora_rank)) / max(
            self.lora_rank, 1)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if self.attention_impl not in ("dense", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.remat_policy not in ("dots", "nothing"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.moe_dispatch not in ("dense", "ragged"):
            raise ValueError(f"unknown moe_dispatch {self.moe_dispatch!r}")


#: parameters the reference keeps in f32 whatever ``param_dtype`` says:
#: the norms' scales, the MoE router, and int8 kernels' scales
_F32_LEAVES = ("norm.scale", "router", "_scale")


def leaf_dtype(key: str, cfg: LlamaConfig) -> torch.dtype:
    """The dtype floating parameter ``key`` (a ``Llama`` state dict key)
    has under ``cfg.param_dtype``."""
    return torch.float32 if key.endswith(_F32_LEAVES) else cfg.param_dtype


def tiny(**kw) -> LlamaConfig:
    """Test config: runs on the CPU in well under a second."""
    return LlamaConfig(**{
        **dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
               max_seq_len=128, dtype=torch.float32, remat=False),
        **kw,
    })


def llama2_7b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama_1b(**kw) -> LlamaConfig:
    """~1.19B: the 7B recipe at half width, 21L / 2048h / 16 heads / 5504
    ffn, full-recompute remat and flash attention."""
    return LlamaConfig(**{
        **dict(hidden_size=2048, intermediate_size=5504, num_layers=21,
               num_heads=16, num_kv_heads=16, max_seq_len=2048,
               remat_policy="nothing", attention_impl="flash"),
        **kw,
    })


def llama2_13b(**kw) -> LlamaConfig:
    return LlamaConfig(**{
        **dict(hidden_size=5120, intermediate_size=13824, num_layers=40,
               num_heads=40, num_kv_heads=40),
        **kw,
    })


def llama2_70b(**kw) -> LlamaConfig:
    return LlamaConfig(**{
        **dict(hidden_size=8192, intermediate_size=28672, num_layers=80,
               num_heads=64, num_kv_heads=8),
        **kw,
    })


def llama3_8b(**kw) -> LlamaConfig:
    return LlamaConfig(**{
        **dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
               num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
               rope_theta=500000.0),
        **kw,
    })


#: the reference's preset table (no ``llama_1b`` entry, as there)
PRESETS = {
    "tiny": tiny,
    "llama2-7b": llama2_7b,
    "llama2-13b": llama2_13b,
    "llama2-70b": llama2_70b,
    "llama3-8b": llama3_8b,
}


def bench_model(**kw) -> LlamaConfig:
    """The ~271M bench model of ``__graft_entry__._bench_model``."""
    return LlamaConfig(**{
        **dict(vocab_size=32000, hidden_size=1024, intermediate_size=2816,
               num_layers=16, num_heads=8, num_kv_heads=8, head_dim=128,
               max_seq_len=1024, remat=True, attention_impl="flash"),
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
    """Rotary embedding, split halves; x: [b, s, heads, head_dim];
    positions [s], or [b, s] for per-row positions."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs        # [..., s, half]
    cos, sin = angles.cos()[..., None, :], angles.sin()[..., None, :]
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


class KvCache:
    """The decode path's KV cache: one stacked tensor per leaf, on one
    device, updated in place by ``Llama.forward(..., cache=...)``.

    - ``k``, ``v``: ``[layers, rows, seq, kv_heads, head_dim]`` in the
      activation dtype, int8 with ``quant_kv``;
    - ``k_scale``, ``v_scale`` (``quant_kv`` only): ``[layers, rows,
      kv_heads, seq]`` f32, seq last as in the reference.

    ``seq_len`` is the logical length. A cache the model writes holds at
    least one position past it, scratch that nothing attends: a write at a
    position ``>= seq_len`` lands there. The reference drops such scatters
    (``mode="drop"``: an inactive serving slot is pinned at the end of the
    cache); an out-of-range index on a CUDA tensor would fire a device-side
    assert instead. (A paged block pool, which the model never writes
    directly, has no scratch positions: ``serving/paged.py``.)
    """

    LEAVES = ("k", "v", "k_scale", "v_scale")

    def __init__(self, k, v, k_scale=None, v_scale=None, *, seq_len: int):
        if k.shape[2] < seq_len:
            raise ValueError(
                f"cache of {k.shape[2]} positions is shorter than its "
                f"seq_len {seq_len}")
        self.k, self.v, self.k_scale, self.v_scale = k, v, k_scale, v_scale
        self.seq_len = seq_len

    @classmethod
    def zeros(cls, cfg: "LlamaConfig", rows: int, seq_len: int, *,
              device, scratch: int = 1,
              kv_heads: Optional[int] = None) -> "KvCache":
        """A zeroed cache of ``rows`` rows and ``seq_len`` positions plus
        ``scratch`` positions of scratch, holding ``kv_heads`` heads (all
        of the config's by default; a tensor-parallel rank's own
        ``Llama.kv_heads``)."""
        kv = cfg.num_kv_heads if kv_heads is None else kv_heads
        shape = (cfg.num_layers, rows, seq_len + scratch, kv, cfg.head_dim)
        dt = torch.int8 if cfg.quant_kv else cfg.dtype
        k, v = (torch.zeros(shape, dtype=dt, device=device) for _ in "kv")
        scales = [None, None]
        if cfg.quant_kv:
            sshape = (cfg.num_layers, rows, kv, seq_len + scratch)
            scales = [torch.zeros(sshape, device=device) for _ in "kv"]
        return cls(k, v, *scales, seq_len=seq_len)

    def leaves(self) -> dict[str, torch.Tensor]:
        return {n: t for n in self.LEAVES
                if (t := getattr(self, n)) is not None}

    def _map(self, fn) -> "KvCache":
        out = {n: fn(n, t) for n, t in self.leaves().items()}
        return KvCache(**out, seq_len=self.seq_len)

    def head_rows(self, n: int) -> "KvCache":
        """A view of the first ``n`` rows."""
        return self._map(lambda _, t: t[:, :n])

    def select_rows(self, idx) -> "KvCache":
        """A copy of the rows ``idx`` (a device index tensor)."""
        return self._map(lambda _, t: t.index_select(1, idx))

    def put_rows(self, idx, rows: "KvCache") -> None:
        """Write ``rows`` back at the rows ``idx``."""
        for n, t in self.leaves().items():
            t.index_copy_(1, idx, getattr(rows, n))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.leaves().values())


def _quantize(x):
    """int8 values and f32 absmax scales over head_dim (``[b, s, kv]``)."""
    x32 = x.float()
    s = x32.abs().amax(-1).clamp_min(1e-8) / 127.0
    q8 = (x32 / s[..., None]).round().clamp(-127, 127).to(torch.int8)
    return q8, s


#: the projections that contract a dim the ``model`` axis shards: their
#: products are partial sums over the tensor-parallel group
ROW_PARALLEL = ("wo", "w_down")


class _Projections(nn.Module):
    """A module of Einsum projections: each kernel ``[in..., out...]`` in
    f32 (int8 plus ``{name}_scale`` ``[out...]`` with ``quant_weights``),
    and with ``lora_rank`` > 0 the adapters ``{name}_lora_a`` ``[in...,
    r]`` (normal 0.02) and ``{name}_lora_b`` ``[r, out...]`` (zeros) of
    every name in ``lora_targets``.

    Under tensor parallelism (``tp``, set by ``parallel.sharding.
    shard_model``) each kernel is this rank's shard: column-parallel
    kernels hold a slice of their out dims, the ``ROW_PARALLEL`` ones a
    slice of their in dims, whose products are summed over the group."""

    #: name -> (in dims, out dims), set by each subclass's __init__
    shapes: dict[str, tuple[tuple[int, ...], tuple[int, ...]]]
    #: the ``model`` axis group (``parallel.sharding.AxisGroup``), if any
    tp = None

    def _make_projections(self, cfg: LlamaConfig, device) -> None:
        #: fan-in of each kernel, and the names that carry adapters
        self._fan_in = {n: math.prod(ins) for n, (ins, _) in
                        self.shapes.items()}
        self._lora = []
        for name, (ins, outs) in self.shapes.items():
            if cfg.quant_weights:
                self.register_parameter(name, nn.Parameter(torch.zeros(
                    *ins, *outs, dtype=torch.int8, device=device),
                    requires_grad=False))
                self.register_parameter(f"{name}_scale", nn.Parameter(
                    torch.ones(*outs, device=device)))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(*ins, *outs, device=device)))
            if cfg.lora_rank > 0 and name in cfg.lora_targets:
                r = cfg.lora_rank
                self._lora.append(name)
                # rounded to the dtype once, as ``jnp.asarray(scale, dtype)``
                self._lora_scale = float(
                    torch.tensor(cfg.lora_scale, dtype=cfg.dtype))
                self.register_parameter(f"{name}_lora_a", nn.Parameter(
                    torch.zeros(*ins, r, device=device)))
                self.register_parameter(f"{name}_lora_b", nn.Parameter(
                    torch.zeros(r, *outs, device=device)))

    def init_weights(self, gen):
        """Kernels fan-in truncated normal (zeros and unit scales when
        int8, as the reference initialises a quantized tree)."""
        if self.cfg.quant_weights:
            return
        for name, fan_in in self._fan_in.items():
            _trunc_normal(getattr(self, name), fan_in, gen)

    def init_adapters(self, gen):
        for name in self._lora:
            getattr(self, f"{name}_lora_a").normal_(0.0, 0.02, generator=gen)
            getattr(self, f"{name}_lora_b").zero_()

    def project(self, name: str, x):
        """``x [..., in]`` (the in dims flattened) through projection
        ``name``: ``[..., out]`` flat, in the activation dtype. int8:
        ``(x @ w.to(dtype)) * scale.to(dtype)``; LoRA adds
        ``((x @ a) @ b) * lora_scale``. Under tensor parallelism ``x`` and
        the result are this rank's shards, and a row-parallel product is
        all-reduced over the group; int8 scales are this rank's out slice
        (column-parallel) or scale the partial sum before its all-reduce
        (row-parallel, linear); an adapter's split factor follows its
        kernel, and the gradient of the one held whole is summed over
        the group."""
        cfg = self.cfg
        dt = cfg.dtype
        w = getattr(self, name).to(dt)
        if w.dim() > 2:
            n_in = len(self.shapes[name][0])
            w = w.reshape(math.prod(w.shape[:n_in]), -1)
        y = x @ w
        if cfg.quant_weights:
            y = y * getattr(self, f"{name}_scale").to(dt).reshape(-1)
        if name in self._lora:
            r = cfg.lora_rank
            a = getattr(self, f"{name}_lora_a")
            b = getattr(self, f"{name}_lora_b")
            if self.tp is not None:
                # the factor every rank holds whole (a of a column-parallel
                # product, b of a row-parallel one) gets only this rank's
                # part of its gradient: the rest flows through the other
                # ranks' slices of the split factor
                if name in ROW_PARALLEL:
                    b = copy_to_group(b, self.tp.group)
                else:
                    a = copy_to_group(a, self.tp.group)
            a = a.to(dt).reshape(-1, r)
            b = b.to(dt).reshape(r, -1)
            y = y + ((x @ a) @ b) * self._lora_scale
        if self.tp is not None and name in ROW_PARALLEL:
            y = reduce_from_group(y, self.tp.group)
        return y

    def _tp_input(self, x):
        """The input of this module's column-parallel products: its
        gradient is all-reduced over the tensor-parallel group."""
        return x if self.tp is None else copy_to_group(x, self.tp.group)


class Attention(_Projections):
    #: the ``seq`` axis group ring attention runs over (``parallel.
    #: sharding.shard_model``), if any
    seq = None

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        e, h, k, d = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim)
        self.shapes = {"wq": ((e,), (h, d)), "wk": ((e,), (k, d)),
                       "wv": ((e,), (k, d)), "wo": ((h, d), (e,))}
        self._make_projections(cfg, device)

    def forward(self, x, positions, cache=None, layer: int = 0,
                attend=None, prefix=None, cache_positions=None):
        """Causal self-attention over ``x``; with ``cache`` (a ``KvCache``)
        the decode path: this layer's keys and values are written into the
        cache at ``positions`` [b, s] (``cache_positions`` when given) and
        the queries attend the cache's first ``attend`` positions, after
        this layer's shared-prefix segment ``prefix`` when given
        (``_decode_attend``)."""
        cfg = self.cfg
        b, s, e = x.shape
        x = self._tp_input(x)
        # this rank's heads: all of them, or h/tp and kv/tp under TP
        heads, kv_heads = self.wq.shape[1], self.wk.shape[1]
        q = self.project("wq", x).view(b, s, heads, cfg.head_dim)
        k = self.project("wk", x).view(b, s, kv_heads, cfg.head_dim)
        v = self.project("wv", x).view(b, s, kv_heads, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cache is not None:
            out = self._decode_attend(q, k, v, positions, cache, layer,
                                      attend or cache.seq_len, prefix,
                                      cache_positions)
        elif cfg.attention_impl == "ring":
            out = ring_attention(q, k, v, q_per_kv=cfg.q_per_kv,
                                 mesh=self.seq)
        elif cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, q_per_kv=cfg.q_per_kv)
        else:
            out = _causal_attention(q, k, v, cfg.q_per_kv)
        return self.project("wo", out.reshape(b, s, -1))


    def _decode_attend(self, q, k, v, positions, cache, layer, attend,
                       prefix=None, cache_positions=None):
        """The reference's ``Attention._decode_attend``: a per-row scatter
        of this step's keys and values at each row's cache positions
        (``cache_positions``, default ``positions``; writes past
        ``cache.seq_len`` land in the scratch), then f32 attention over the
        first ``attend`` positions with the per-row causal mask
        ``slot <= cache position``.

        Shared-prefix mode: ``prefix = (pk, pv, plen)`` is the per-row KV
        [b, sp, kv, d] of an immutable segment holding global positions
        [0, plen), already roped there, in the activation dtype whatever
        ``quant_kv`` says; the row's own cache then holds only its suffix,
        at slot-local ``cache_positions`` (rope and causality stay global
        through ``positions``). The attention is one softmax over
        [segment ; private]."""
        cfg = self.cfg
        b, sc = q.shape[:2]
        kc, vc = cache.k[layer], cache.v[layer]
        if kc.shape[1] <= cache.seq_len:
            raise ValueError("the decode path writes into a cache with "
                             "scratch past its seq_len (KvCache)")
        cpos = positions if cache_positions is None else \
            cache_positions.expand(b, sc)
        rows = torch.arange(b, device=q.device)[:, None]
        # a verify's rejected tail or an inactive row pinned at the end may
        # reach past seq_len: every such write lands in the scratch
        widx = cpos.clamp(max=cache.seq_len)
        # the cache says whether it is int8: a shared-prefix engine's
        # segment pool is not, whatever the model's quant_kv
        if cache.k_scale is not None:
            kq, ks = _quantize(k)
            vq, vs = _quantize(v)
            kc[rows, widx] = kq
            vc[rows, widx] = vq
            heads = torch.arange(k.shape[2], device=q.device)
            srow, shead, spos = rows[:, :, None], heads, widx[:, :, None]
            kscale, vscale = cache.k_scale[layer], cache.v_scale[layer]
            kscale[srow, shead, spos] = ks
            vscale[srow, shead, spos] = vs
            kf = (kc[:, :attend].float()
                  * kscale[:, :, :attend].transpose(1, 2)[..., None])
            vf = (vc[:, :attend].float()
                  * vscale[:, :, :attend].transpose(1, 2)[..., None])
        else:
            kc[rows, widx] = k.to(cfg.dtype)
            vc[rows, widx] = v.to(cfg.dtype)
            kf, vf = kc[:, :attend].float(), vc[:, :attend].float()
        # this rank's heads (all of them, or h/tp and kv/tp under TP)
        heads, kv_heads = q.shape[2], k.shape[2]
        qh = q.reshape(b, sc, kv_heads, cfg.q_per_kv, cfg.head_dim).float()
        logits = torch.einsum("bqkgh,bskh->bkgqs", qh, kf)
        valid = (torch.arange(attend, device=q.device)[None, None, :]
                 <= cpos[:, :, None])                       # [b, q, s]
        logits = logits.masked_fill(~valid[:, None, None], -1e30)
        scale = torch.tensor(math.sqrt(cfg.head_dim), dtype=torch.float32)
        if prefix is not None:
            pk, pv, plen = prefix
            plogits = torch.einsum("bqkgh,bskh->bkgqs", qh, pk.float())
            # the whole live segment precedes every query position
            pvalid = (torch.arange(pk.shape[1], device=q.device)[None, :]
                      < plen[:, None])                      # [b, sp]
            plogits = plogits.masked_fill(
                ~pvalid[:, None, None, None, :], -1e30)
            probs = (torch.cat([plogits, logits], dim=-1) / scale).softmax(
                dim=-1)
            sp = pk.shape[1]
            out = (torch.einsum("bkgqs,bskh->bqkgh", probs[..., :sp],
                                pv.float())
                   + torch.einsum("bkgqs,bskh->bqkgh", probs[..., sp:], vf))
            return out.reshape(b, sc, heads, cfg.head_dim).to(cfg.dtype)
        logits = logits / scale
        out = torch.einsum("bkgqs,bskh->bqkgh", logits.softmax(dim=-1), vf)
        return out.reshape(b, sc, heads, cfg.head_dim).to(cfg.dtype)


class Mlp(_Projections):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        e, m = cfg.hidden_size, cfg.intermediate_size
        self.shapes = {"w_gate": ((e,), (m,)), "w_up": ((e,), (m,)),
                       "w_down": ((m,), (e,))}
        self._make_projections(cfg, device)

    def forward(self, x):
        x = self._tp_input(x)
        h = F.silu(self.project("w_gate", x)) * self.project("w_up", x)
        return self.project("w_down", h)


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

    def forward(self, x, positions, cache=None, layer: int = 0,
                attend=None, prefix=None, cache_positions=None):
        """(x, aux): aux is the MoE layer's load-balancing loss, else None."""
        x = x + self.attn(self.attn_norm(x), positions, cache, layer, attend,
                          prefix, cache_positions)
        if isinstance(self.mlp, MoeMlp):
            y, aux = self.mlp(self.mlp_norm(x))
            return x + y, aux
        return x + self.mlp(self.mlp_norm(x)), None


class Embedder(nn.Module):
    """The token embedding; under tensor parallelism each rank holds a
    contiguous slice of the vocabulary, looks up the tokens it holds, and
    the rows are summed over the group (Megatron's vocab-parallel
    embedding)."""

    #: the ``model`` axis group, if any (``parallel.sharding``)
    tp = None

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, device=device))

    def forward(self, tokens):
        # out-of-range ids clamp, like the reference's gather
        tokens = tokens.clamp(0, self.cfg.vocab_size - 1)
        table = self.embedding.to(self.cfg.dtype)
        if self.tp is None:
            return F.embedding(tokens, table)
        rows = table.shape[0]
        local = tokens - self.tp.rank * rows
        mine = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), table)
        return reduce_from_group(x * mine[..., None].to(x.dtype),
                                 self.tp.group)


class Head(nn.Module):
    """Final norm + unembedding; logits in the activation dtype. Under
    tensor parallelism each rank computes the logits of its vocabulary
    slice and they are all-gathered (a vocab-parallel loss that never
    gathers them is ROADMAP A5b)."""

    #: the ``model`` axis group, if any (``parallel.sharding``)
    tp = None

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  cfg.dtype, device)
        if cfg.tie_embeddings:
            return
        if cfg.quant_weights:
            self.unembedding = nn.Parameter(torch.zeros(
                cfg.hidden_size, cfg.vocab_size, dtype=torch.int8,
                device=device), requires_grad=False)
            self.unembedding_scale = nn.Parameter(
                torch.ones(cfg.vocab_size, device=device))
        else:
            self.unembedding = nn.Parameter(
                torch.empty(cfg.hidden_size, cfg.vocab_size, device=device))

    def forward(self, x, embed_table=None):
        x = self.final_norm(x)
        dt = self.cfg.dtype
        if self.tp is not None:
            x = copy_to_group(x, self.tp.group)
        if self.cfg.tie_embeddings:
            logits = x @ embed_table.to(dt).t()
        else:
            logits = x @ self.unembedding.to(dt)
            if self.cfg.quant_weights:
                logits = logits * self.unembedding_scale.to(dt)
        if self.tp is not None:
            logits = gather_last_dim(logits, self.tp.group)
        return logits


class StageLayers(nn.Module):
    """The blocks a pipeline stage holds (``parallel.sharding.
    shard_model``), in its local order, each registered under its index in
    the whole stack so that parameter names stay ``layers.{i}....``;
    iterates like a ``ModuleList``."""

    def __init__(self, blocks: dict):
        super().__init__()
        for i, blk in blocks.items():
            self.add_module(str(i), blk)

    def __iter__(self):
        return iter(self._modules.values())


def _trunc_normal(w, fan_in, gen):
    """flax variance_scaling(1.0, "fan_in", "truncated_normal")."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


#: what the "dots" policy keeps across the backward pass: matmul outputs
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


class Llama(nn.Module):
    #: the ``seq`` axis group (``parallel.sharding.shard_model``), if any:
    #: this rank holds sequence block ``seq.rank`` of every row
    seq = None
    #: the ``pipeline`` axis group, if any: ``layers`` is then this rank's
    #: stage (``StageLayers``), run by ``pipelined_apply``
    #: or the trainer's 1F1B step
    pipe = None

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embedder = Embedder(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.num_layers))
        self.head = Head(cfg, device)
        if cfg.param_dtype != torch.float32:
            for key, p in self.named_parameters():
                # floating leaves only: int8 serving kernels stay int8
                if p.is_floating_point():
                    p.data = p.data.to(leaf_dtype(key, cfg))

    @property
    def kv_heads(self) -> int:
        """The kv heads this rank's blocks hold: all of the config's, or
        ``num_kv_heads / tp`` under tensor parallelism (the decode path's
        caches hold this many)."""
        return next(iter(self.layers)).attn.wk.shape[1]

    def _init_plan(self) -> list:
        """``init_weights``' draws in order: (submodule name, fill,
        adapters only) triples, each ``fill(module, gen)`` one Embedder,
        Block or Head."""
        cfg = self.cfg

        def embed(m, gen):
            m.embedding.normal_(0.0, 0.02, generator=gen)

        def block(m, gen):
            m.attn.init_weights(gen)
            m.mlp.init_weights(gen)
            m.attn_norm.scale.fill_(1.0)
            m.mlp_norm.scale.fill_(1.0)

        def head(m, gen):
            m.final_norm.scale.fill_(1.0)
            if not cfg.tie_embeddings and not cfg.quant_weights:
                m.unembedding.normal_(0.0, 0.02, generator=gen)

        def adapters(m, gen):
            m.attn.init_adapters(gen)
            if isinstance(m.mlp, Mlp):
                m.mlp.init_adapters(gen)

        layers = [f"layers.{i}" for i in range(cfg.num_layers)]
        # adapters last: the base draws are those of the plain model
        return ([("embedder", embed, False)]
                + [(n, block, False) for n in layers]
                + [("head", head, False)]
                + [(n, adapters, True) for n in layers
                   if cfg.lora_rank > 0])

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Random init from ``seed``: embeddings and MoE routers
        normal(0.02), projections and experts fan-in truncated normal, norm
        scales one, LoRA A normal(0.02) and B zeros (the reference's
        initializers; its random draws differ)."""
        gen = torch.Generator(device=self.embedder.embedding.device)
        gen.manual_seed(seed)
        for name, fill, _ in self._init_plan():
            fill(self.get_submodule(name), gen)

    @torch.no_grad()
    def init_streamed(self, seed: int, device, sink) -> None:
        """``init_weights(seed)``'s values on ``device``, drawn one module
        at a time into a fresh Embedder, Block or Head and handed to
        ``sink({full parameter name: tensor})``; this model (on the meta
        device, say) holds none of them. The peak is one module, not the
        model: a sharded trainer keeps only its shards of each. A pipeline
        stage builds its own blocks only; the other stages' draws still
        advance the one random stream, into a single scratch block."""
        cfg = self.cfg
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        make = {"embedder": Embedder, "head": Head}
        held = {name for name, _ in self.named_modules()}
        scratch = None
        for name, fill, adapters_only in self._init_plan():
            if name not in held:
                scratch = scratch or Block(cfg, device)
                fill(scratch, gen)
                continue
            module = make.get(name, Block)(cfg, device)
            fill(module, gen)
            sink({f"{name}.{k}": p for k, p in module.named_parameters()
                  if not adapters_only or is_lora_path(k)})
            del module

    def forward(self, tokens, positions=None, return_aux: bool = False, *,
                cache: KvCache | None = None, attend: int | None = None,
                prefix=None, cache_positions=None):
        """Logits; with ``return_aux``, (logits, the MoE load-balancing loss
        averaged over layers, or None for a dense model).

        With ``cache``, the decode path of the reference's ``decode=True``:
        ``positions`` [b, s] (default ``arange(s)`` in every row) are each
        token's global position, the cache is written in place there (at
        ``cache_positions`` when given), and attention reads its first
        ``attend`` positions (default all). ``prefix = (pk, pv, plen)``
        adds a shared-prefix segment per row: pk/pv [layers, b, sp, kv, d],
        plen [b] (``Attention._decode_attend``)."""
        cfg = self.cfg
        if self.pipe is not None:
            raise ValueError("a pipeline stage holds some of the blocks: "
                             "run it through pipelined_apply")
        if positions is None:
            positions = seq_positions(self, tokens.shape[-1], tokens.device)
        if cache is not None:
            positions = positions.expand(tokens.shape)
        x = self.embedder(tokens)
        remat = cfg.remat and torch.is_grad_enabled() and cache is None
        auxes = []
        for i, blk in enumerate(self.layers):
            if cache is not None:
                seg = None if prefix is None else (
                    prefix[0][i], prefix[1][i], prefix[2])
                x, aux = blk(x, positions, cache, i, attend, seg,
                             cache_positions)
            elif not remat:
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


def seq_positions(model: Llama, s: int, device):
    """Global positions of a rank's ``s`` tokens: its sequence block's
    offset on the ``seq`` axis (0 with none) plus the local index."""
    offset = model.seq.rank * s if model.seq is not None else 0
    return torch.arange(offset, offset + s, device=device)


def block_apply_with_aux(cfg: LlamaConfig, positions):
    """``block_apply(block, h) -> (h, aux)`` for the pipeline executors:
    one Block forward that also gives the layer's MoE load-balancing loss
    (0 for a dense layer) in f32, how the balancing loss flows through
    GPipe and 1F1B."""

    def apply(block, h):
        y, aux = block(h, positions)
        if aux is None:
            return y, h.new_zeros((), dtype=torch.float32)
        return y, aux.float()

    return apply


class _HeadGradOnLastStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, last):
        ctx.last = last
        return logits.view_as(logits)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def pipelined_apply(cfg: LlamaConfig, model: Llama, tokens, *, mesh=None,
                    num_microbatches: int | None = None,
                    with_aux: bool = False):
    """The forward with the block stack run as a GPipe microbatch pipeline
    (``parallel.pipeline.gpipe``) over this rank's stage of ``model``.

    The embedding and the head run on every rank (they are replicated over
    the ``pipeline`` axis), so every rank gets the logits; their gradient
    flows on the last stage only, so that the head's and the embedding's
    gradients, summed over the axis (``Layout.sync_grads``), are the whole
    model's. The same blocks in the same order as ``Llama.forward``.

    ``with_aux=True`` returns ``(logits, aux_mean)``: the MoE balancing loss
    summed over layers and microbatches / (num_layers x microbatches), one
    microbatch at degree 1, as the reference normalises it."""
    from ..parallel import pipeline as pipelib

    mesh = mesh if mesh is not None else model.pipe
    positions = seq_positions(model, tokens.shape[-1], tokens.device)
    x = model.embedder(tokens)
    x, aux_sum = pipelib.gpipe(
        block_apply_with_aux(cfg, positions), model.layers, x, mesh=mesh,
        num_microbatches=num_microbatches, remat=cfg.remat, with_aux=True)
    table = model.embedder.embedding if cfg.tie_embeddings else None
    logits = model.head(x, table)
    axis = pipelib.pipeline_axis(mesh)
    if axis is not None:
        logits = _HeadGradOnLastStage.apply(logits,
                                            axis.rank == axis.size - 1)
    if not with_aux:
        return logits
    deg = pipelib.pipeline_degree(mesh)
    m = (num_microbatches or deg) if deg > 1 else 1
    return logits, aux_sum / (cfg.num_layers * m)


# -- snapshots, adapters and serving quantization -----------------------------
#
# The reference's functions on the port's state dicts (``{key: tensor}`` as
# ``Llama.state_dict()`` keys them; a ``Llama`` module is taken too). Files
# are the reference's: ``config.json`` plus ``weights.msgpack`` or
# ``adapter.msgpack`` in flax's msgpack form, the tree scan-stacked.

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

#: the reference's LlamaConfig fields the port has no counterpart for, and
#: the values the port can honour (None: any value; the same computation)
_REFERENCE_ONLY = {
    "scan_layers": None,            # only the tree's layout
    "embed_one_hot": None,          # the same lookup as a gather
    "moe_ragged_compute": ("auto", "masked", "grouped"),
}


def _state_dict(params) -> dict:
    if isinstance(params, nn.Module):
        return params.state_dict()
    return params


#: the parameter dtypes a snapshot's ``param_dtype`` may name
PARAM_DTYPES = ("float32", "bfloat16")


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def param_dtype_of(params) -> torch.dtype:
    """The dtype of a state dict's (or a module's) floating leaves that
    ``param_dtype`` governs (``leaf_dtype``: not the norms, the router or
    int8 scales), the ``param_dtype`` a snapshot of them declares; raises
    when they mix dtypes (one ``param_dtype`` cannot say that)."""
    found = {v.dtype for k, v in _state_dict(params).items()
             if v.is_floating_point() and not k.endswith(_F32_LEAVES)}
    if len(found) > 1:
        raise ValueError(
            "a snapshot's floating leaves must share one dtype (its "
            f"param_dtype), not {sorted(map(_dtype_name, found))}")
    return found.pop() if found else torch.float32


def config_to_dict(cfg: LlamaConfig) -> dict:
    """``config.json`` of a snapshot: the reference's ``save_pretrained``
    dict (every key its ``LlamaConfig(**d)`` accepts, dtypes by name,
    the scan-stacked layout the port writes)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = _dtype_name(cfg.dtype)
    d["param_dtype"] = _dtype_name(cfg.param_dtype)
    d["lora_targets"] = list(cfg.lora_targets)
    d.update(scan_layers=True, embed_one_hot=False,
             moe_ragged_compute="auto")
    return d


def config_from_dict(d: dict) -> LlamaConfig:
    """The port's config of a snapshot's ``config.json`` dict. The
    reference-only keys are taken where the port computes the same thing
    and refused, by name, where it cannot."""
    d = dict(d)
    for key, allowed in _REFERENCE_ONLY.items():
        if key not in d:
            continue
        value = d.pop(key)
        if allowed is not None and value not in allowed:
            raise ValueError(
                f"snapshot config {key}={value!r} is not supported by the "
                f"port (it takes {', '.join(map(repr, allowed))})")
    if "dtype" in d:
        if d["dtype"] not in _DTYPES:
            raise ValueError(f"snapshot config dtype={d['dtype']!r} is not "
                             "supported by the port")
        d["dtype"] = _DTYPES[d["dtype"]]
    if "param_dtype" in d:
        if d["param_dtype"] not in PARAM_DTYPES:
            raise ValueError(
                f"snapshot config param_dtype={d['param_dtype']!r} is not "
                "supported by the port (it takes "
                f"{', '.join(map(repr, PARAM_DTYPES))})")
        d["param_dtype"] = _DTYPES[d["param_dtype"]]
    if "lora_targets" in d:
        d["lora_targets"] = tuple(d["lora_targets"])  # json round-trip
    return LlamaConfig(**d)


def publish_file(path: str, write, binary: bool = False) -> None:
    """Write ``path`` through the commit protocol: ``write(f)`` into a
    staging name, flush and fsync, then an atomic rename. A reader, or a
    crash, never sees a torn file at the final name."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb" if binary else "w") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_config(path: str, cfg: LlamaConfig) -> None:
    publish_file(os.path.join(path, "config.json"),
                 lambda f: json.dump(config_to_dict(cfg), f, indent=1))


def _write_msgpack(path: str, tree: dict) -> None:
    from . import _msgpack

    publish_file(path, lambda f: _msgpack.dump(tree, f), binary=True)


def save_pretrained(path: str, cfg: LlamaConfig, params) -> None:
    """Write a snapshot the reference's ``load_pretrained`` reads:
    ``config.json`` plus ``weights.msgpack``, the tree scan-stacked. Each
    leaf streams from its per-layer tensors (on any device), in its own
    dtype, which ``param_dtype`` names (bf16 leaves: ``"bfloat16"``)."""
    from . import convert

    os.makedirs(path, exist_ok=True)
    _write_config(path, dataclasses.replace(
        cfg, param_dtype=param_dtype_of(params)))
    tree = convert.tree_from_state_dict(_state_dict(params), cfg, lazy=True)
    _write_msgpack(os.path.join(path, "weights.msgpack"), tree)


def load_pretrained_config(path: str) -> LlamaConfig:
    """The snapshot's architecture, without touching the weights: this
    layout's ``config.json`` or a transformers snapshot's
    (``hf_checkpoint``, auto-detected)."""
    from . import hf_checkpoint

    if hf_checkpoint.is_hf_snapshot(path):
        return hf_checkpoint.config_from_hf(path)
    with open(os.path.join(path, "config.json")) as f:
        return config_from_dict(json.load(f))


def load_pretrained(path: str) -> tuple[LlamaConfig, dict]:
    """(config, state dict of CPU tensors) of a snapshot written by either
    package's ``save_pretrained`` (either layer layout), or of a
    transformers-layout safetensors snapshot (auto-detected). The
    floating leaves are in the config's ``param_dtype``: a bf16 snapshot
    stays bf16, once, here."""
    from . import _msgpack, convert, hf_checkpoint

    if hf_checkpoint.is_hf_snapshot(path):
        cfg, tree = hf_checkpoint.load_hf_llama(path)
    else:
        cfg = load_pretrained_config(path)
        tree = _msgpack.load(os.path.join(path, "weights.msgpack"))
    return cfg, convert.state_dict_from_jax(tree, cfg,
                                            partial=cfg.lora_rank > 0)


def is_lora_path(path) -> bool:
    """True for adapter leaves: a state dict key (``..._lora_a``) or a
    flattened tree path tuple (``(..., "lora_a")``)."""
    if isinstance(path, str):
        return path.endswith(("_lora_a", "_lora_b"))
    return any(p in ("lora_a", "lora_b") for p in path)


def split_lora(params) -> tuple[dict, dict]:
    """(base, adapters) of a state dict: the partition the trainer's
    freeze, adapter-only checkpoints and ``save_adapter`` share."""
    sd = _state_dict(params)
    base = {k: v for k, v in sd.items() if not is_lora_path(k)}
    lora = {k: v for k, v in sd.items() if is_lora_path(k)}
    return base, lora


def save_adapter(path: str, cfg: LlamaConfig, params) -> None:
    """Publish the adapter weights alone (plus the full config, lora
    fields included): ``config.json`` and ``adapter.msgpack``."""
    from . import convert

    _, lora = split_lora(params)
    if not lora:
        raise ValueError("save_adapter: params contain no lora_a/lora_b "
                         "leaves (model has lora_rank == 0?)")
    os.makedirs(path, exist_ok=True)
    _write_config(path, cfg)
    _write_msgpack(os.path.join(path, "adapter.msgpack"),
                   convert.tree_from_state_dict(lora, cfg, lazy=True))


def load_adapter(path: str) -> tuple[LlamaConfig, dict]:
    """(config with the lora fields, adapter state dict) of a
    ``save_adapter`` snapshot of either package."""
    from . import _msgpack, convert

    cfg = load_pretrained_config(path)
    tree = _msgpack.load(os.path.join(path, "adapter.msgpack"))
    lora = convert.state_dict_from_jax(tree, cfg, partial=True)
    return cfg, lora


@torch.no_grad()
def merge_adapter(cfg: LlamaConfig, base_params, adapters
                  ) -> tuple[LlamaConfig, dict]:
    """Fold adapters into the base for serving, ``kernel += reshape(A @ B)
    * scale`` in f32 per adapted projection: the result is a plain Llama
    (lora_rank 0) that every serving path takes unchanged. Refuses an int8
    base: a model-space delta added to int8 codes corrupts them."""
    if cfg.quant_weights:
        raise ValueError(
            "merge_adapter needs an UNQUANTIZED base: adding a "
            "model-space delta to int8 codes corrupts them — merge "
            "first, then quantize_for_serving")
    scale = cfg.lora_scale
    merged, _ = split_lora(base_params)
    merged = dict(merged)
    ada = _state_dict(adapters)
    for key, a in ada.items():
        if not key.endswith("_lora_a"):
            continue
        kkey = key[:-len("_lora_a")]
        kernel = merged[kkey]
        if kernel.dtype == torch.int8:
            raise ValueError(
                f"merge_adapter: base kernel {kkey} is int8 — merge "
                "before quantizing")
        b = ada[kkey + "_lora_b"].to(kernel.device, torch.float32)
        a = a.to(kernel.device, torch.float32)
        r = a.shape[-1]
        delta = (a.reshape(-1, r) @ b.reshape(r, -1)).reshape(kernel.shape)
        merged[kkey] = (kernel.float() + scale * delta).to(kernel.dtype)
    return dataclasses.replace(cfg, lora_rank=0, lora_alpha=0.0), merged


def _quantize_kernel(w: torch.Tensor, fan_in_dims: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel absmax int8 over the first
    ``fan_in_dims`` dims: (codes, f32 scales [out...])."""
    arr = w.float()
    dims = tuple(range(fan_in_dims))
    s = arr.abs().amax(dim=dims).clamp_min(1e-8) / 127.0
    q8 = (arr / s).round().clamp(-127, 127).to(torch.int8)
    return q8, s


@torch.no_grad()
def quantize_for_serving(cfg: LlamaConfig, params, *, weights: bool = True,
                         kv: bool = True) -> tuple[LlamaConfig, dict]:
    """f32 weights -> int8 serving weights (and the int8 KV flag): every
    projection kernel and the unembedding (unless tied) quantized per
    output channel, ``y = (x @ w_q) * s`` exactly as the scales vary only
    over the non-contracted dims. The embedding and the norm scales stay
    f32. Returns the serving config and its state dict (``params`` as
    they are when only ``kv``)."""
    if cfg.moe_experts > 0 and weights:
        raise ValueError(
            "int8 weight quantization does not cover MoE expert trees yet "
            "(MoeMlp owns raw stacked params, not Einsum kernels); serve "
            "MoE bf16 or pass weights=False for int8 KV only")
    qcfg = dataclasses.replace(cfg, quant_weights=bool(weights),
                               quant_kv=bool(kv))
    if not weights:
        return qcfg, params
    sd = dict(_state_dict(params))
    fan_in = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
              "w_down": 1}
    for i in range(cfg.num_layers):
        for mod in ("attn", "mlp"):
            for name, n_in in fan_in.items():
                key = f"layers.{i}.{mod}.{name}"
                if key in sd:
                    sd[key], sd[f"{key}_scale"] = _quantize_kernel(
                        sd[key], n_in)
    if not cfg.tie_embeddings:
        sd["head.unembedding"], sd["head.unembedding_scale"] = \
            _quantize_kernel(sd["head.unembedding"], 1)
    return qcfg, sd
