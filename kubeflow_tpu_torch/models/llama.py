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
    #: KV-cache length of the decode path (``KvCache``), the serving
    #: engine's context limit
    max_seq_len: int = 4096
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
    #: serving only: the KV cache in int8 with one f32 absmax scale per
    #: (row, kv head, position), dequantized into the f32 attend math
    quant_kv: bool = False

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
               max_seq_len=128, dtype=torch.float32, remat=False),
        **kw,
    })


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
              device, scratch: int = 1) -> "KvCache":
        """A zeroed cache of ``rows`` rows and ``seq_len`` positions plus
        ``scratch`` positions of scratch."""
        shape = (cfg.num_layers, rows, seq_len + scratch, cfg.num_kv_heads,
                 cfg.head_dim)
        dt = torch.int8 if cfg.quant_kv else cfg.dtype
        k, v = (torch.zeros(shape, dtype=dt, device=device) for _ in "kv")
        scales = [None, None]
        if cfg.quant_kv:
            sshape = (cfg.num_layers, rows, cfg.num_kv_heads,
                      seq_len + scratch)
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
        dt = cfg.dtype
        q = (x @ self.wq.to(dt).reshape(e, -1)).view(
            b, s, cfg.num_heads, cfg.head_dim)
        k = (x @ self.wk.to(dt).reshape(e, -1)).view(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        v = (x @ self.wv.to(dt).reshape(e, -1)).view(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cache is not None:
            out = self._decode_attend(q, k, v, positions, cache, layer,
                                      attend or cache.seq_len, prefix,
                                      cache_positions)
        elif cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, q_per_kv=cfg.q_per_kv)
        else:
            out = _causal_attention(q, k, v, cfg.q_per_kv)
        return out.reshape(b, s, -1) @ self.wo.to(dt).reshape(-1, e)


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
            heads = torch.arange(cfg.num_kv_heads, device=q.device)
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
        qh = q.reshape(b, sc, cfg.num_kv_heads, cfg.q_per_kv,
                       cfg.head_dim).float()
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
            return out.reshape(b, sc, cfg.num_heads,
                               cfg.head_dim).to(cfg.dtype)
        logits = logits / scale
        out = torch.einsum("bkgqs,bskh->bqkgh", logits.softmax(dim=-1), vf)
        return out.reshape(b, sc, cfg.num_heads, cfg.head_dim).to(cfg.dtype)


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
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
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
