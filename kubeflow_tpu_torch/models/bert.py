"""BERT-family bidirectional encoder in PyTorch: the port of
``kubeflow_tpu/models/bert.py``.

Capability target: baseline config 3 — "KServe BERT-base InferenceService"
[local: BASELINE.json configs]: the encoder the ``kft-bert`` runtime serves
(``serving/runtimes.py`` ``BertClassifierModel``). bf16 activations and f32
parameters, cast before each product; attention is bidirectional (padding
mask only) and dense, as in the reference, which runs it as XLA einsums.
``param_dtype`` bf16 (a bf16 snapshot's) keeps every parameter but the
LayerNorms' in bf16, as the reference does (``leaf_dtype``).

Parameters keep the reference's Einsum kernel layouts (q/k/v ``[E, H, D]``,
o ``[H, D, E]``, ffn_in ``[E, M]``, ffn_out ``[M, E]``, pooler ``[E, E]``,
classifier ``[E, C]``) under the reference's names, so
``convert.bert_from_reference`` maps a flax tree by name alone (either
layer layout: ``layers`` scan-stacked or ``layer_{i}``). Where torch's
defaults differ, the port follows the reference:

- the padding mask fills with ``finfo(float32).min``, not -inf, so a row
  with no key at all (a padded batch row) gets a uniform softmax;
- the MLP's gelu is the tanh approximation (flax ``nn.gelu``);
- LayerNorm computes in f32 with eps 1e-12, then casts to the activation
  dtype;
- the scores are f32, scaled by ``1/sqrt(head_dim)`` in f32; the
  probabilities are cast to the activation dtype before ``P @ V``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .llama import _trunc_normal, publish_file


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_classes: int = 2
    dtype: torch.dtype = torch.bfloat16
    #: the kernels' and embeddings' dtype: f32, or bf16 for a bf16
    #: snapshot; the LayerNorms' scale and bias stay f32 (``leaf_dtype``)
    param_dtype: torch.dtype = torch.float32
    #: recompute each layer in the backward pass
    remat: bool = False
    #: the snapshot's layer layout: scan-stacked ``layers`` or ``layer_{i}``
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must divide by num_heads")
        if self.param_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                "the port keeps BERT parameters in float32 or bfloat16, "
                f"not {self.param_dtype}")


def leaf_dtype(key: str, cfg: BertConfig) -> torch.dtype:
    """The dtype of parameter ``key`` (a state dict key, or a module's own
    name for it) under ``cfg.param_dtype``: the LayerNorms' scale and
    bias are f32 whatever it says, as in the reference."""
    if key.endswith(("norm.scale", "norm.bias")):
        return torch.float32
    return cfg.param_dtype


def tiny(**kw) -> BertConfig:
    """Test/smoke config: one CPU device, <1s."""
    return BertConfig(**{**dict(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position=64, dtype=torch.float32,
        scan_layers=False,
    ), **kw})


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_large(**kw) -> BertConfig:
    return BertConfig(**{**dict(
        hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096,
    ), **kw})


PRESETS = {"tiny": tiny, "bert-base": bert_base, "bert-large": bert_large}

#: the Einsum kernels (a flax ``{name: {"kernel": ...}}``)
EINSUMS = ("q", "k", "v", "o", "ffn_in", "ffn_out", "pooler", "classifier")


def num_params(cfg: BertConfig) -> int:
    """Every parameter of ``BertClassifier(cfg)`` (no projection biases)."""
    e, m, l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    per_layer = 4 * e * e + 2 * e * m + 4 * e
    emb = (cfg.vocab_size + cfg.max_position + cfg.type_vocab_size) * e
    return emb + 2 * e + l * per_layer + e * e + e * cfg.num_classes


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return y.to(self.dtype)


def _project(x, w, dtype, n_in: int = 1):
    """``x [..., in]`` through an Einsum kernel ``w [in..., out...]`` (its
    first ``n_in`` dims contracted), in ``dtype``: ``[..., out]`` flat."""
    w = w.to(dtype)
    return x @ w.reshape(math.prod(w.shape[:n_in]), -1)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        dt = leaf_dtype("q", cfg)
        for name in ("q", "k", "v"):
            self.register_parameter(name, nn.Parameter(
                torch.empty(e, h, d, dtype=dt, device=device)))
        self.o = nn.Parameter(torch.empty(h, d, e, dtype=dt, device=device))
        #: 1/sqrt(d) in f32, as ``jnp.sqrt(d).astype(float32)``
        self._sqrt_d = float(np.sqrt(np.float32(d)))

    def _heads(self, x, name: str):
        b, s, _ = x.shape
        return (_project(x, getattr(self, name), self.cfg.dtype)
                .view(b, s, self.cfg.num_heads, -1).transpose(1, 2))

    def attention_probs(self, x, mask):
        """The f32 softmax [b, h, q, k] over the keys ``mask`` keeps."""
        scores = (self._heads(x, "q")
                  @ self._heads(x, "k").transpose(-1, -2)).float()
        scores = scores / torch.tensor(self._sqrt_d, dtype=torch.float32)
        neg = torch.finfo(torch.float32).min
        scores = scores.masked_fill(~mask[:, None, None, :], neg)
        return scores.softmax(dim=-1)

    def forward(self, x, mask):
        """x [b, s, e]; mask [b, s] bool (False = padding)."""
        dt, (b, s, _) = self.cfg.dtype, x.shape
        probs = self.attention_probs(x, mask).to(dt)
        out = (probs @ self._heads(x, "v")).transpose(1, 2).reshape(b, s, -1)
        return _project(out, self.o, dt, n_in=2)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        e, m = cfg.hidden_size, cfg.intermediate_size
        self.attention = SelfAttention(cfg, device)
        self.attn_norm = LayerNorm(e, cfg.layer_norm_eps, cfg.dtype, device)
        dt = leaf_dtype("ffn_in", cfg)
        self.ffn_in = nn.Parameter(torch.empty(e, m, dtype=dt, device=device))
        self.ffn_out = nn.Parameter(torch.empty(m, e, dtype=dt,
                                                device=device))
        self.ffn_norm = LayerNorm(e, cfg.layer_norm_eps, cfg.dtype, device)

    def forward(self, x, mask):
        dt = self.cfg.dtype
        x = self.attn_norm(x + self.attention(x, mask))
        h = F.gelu(_project(x, self.ffn_in, dt), approximate="tanh")
        return self.ffn_norm(x + _project(h, self.ffn_out, dt))


class BertEncoder(nn.Module):
    """Token ids -> (sequence_output [b, s, e], pooled [b, e])."""

    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        e, dt = cfg.hidden_size, leaf_dtype("token_embedding", cfg)
        for name, rows in (("token_embedding", cfg.vocab_size),
                           ("position_embedding", cfg.max_position),
                           ("segment_embedding", cfg.type_vocab_size)):
            self.register_parameter(name, nn.Parameter(torch.empty(
                rows, e, dtype=dt, device=device)))
        self.embed_norm = LayerNorm(e, cfg.layer_norm_eps, cfg.dtype, device)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.pooler = nn.Parameter(torch.empty(e, e, dtype=dt,
                                               device=device))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        cfg = self.cfg
        b, s = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.bool, device=dev)
        else:
            attention_mask = attention_mask.to(torch.bool)
        if token_type_ids is None:
            token_type_ids = torch.zeros(b, s, dtype=torch.long, device=dev)
        # out-of-range ids clamp, like the reference's gather
        ids = input_ids.long().clamp(0, cfg.vocab_size - 1)
        x = (self.token_embedding[ids]
             + self.position_embedding[torch.arange(s, device=dev)][None]
             + self.segment_embedding[token_type_ids.long()]).to(cfg.dtype)
        x = self.embed_norm(x)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, attention_mask, use_reentrant=False)
            else:
                x = layer(x, attention_mask)
        pooled = torch.tanh(_project(x[:, 0, :], self.pooler, cfg.dtype))
        return x, pooled


class BertClassifier(nn.Module):
    """Pooled [CLS] -> class logits (the sequence-classification head), in
    the activation dtype."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = BertEncoder(cfg, device)
        self.classifier = nn.Parameter(torch.empty(
            cfg.hidden_size, cfg.num_classes,
            dtype=leaf_dtype("classifier", cfg), device=device))

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """The reference's initializers from ``seed``: embeddings
        normal(0.02), Einsum kernels fan-in truncated normal (fan-in the
        contracted dims), LayerNorm scale 1 and bias 0. The draws differ
        from the reference's."""
        gen = torch.Generator(device=self.classifier.device)
        gen.manual_seed(seed)
        enc = self.encoder
        for emb in (enc.token_embedding, enc.position_embedding,
                    enc.segment_embedding):
            emb.normal_(0.0, 0.02, generator=gen)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in EINSUMS:
                fan_in = p.shape[0] * (p.shape[1] if leaf == "o" else 1)
                _trunc_normal(p, fan_in, gen)
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        dt = self.cfg.dtype
        _, pooled = self.encoder(input_ids, attention_mask, token_type_ids)
        return _project(pooled.to(dt), self.classifier, dt)


# -- pretrained snapshot IO (HF-layout directories) -------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def save_pretrained(path: str, cfg: BertConfig, params) -> None:
    """Write the reference's snapshot layout: ``config.json`` +
    ``weights.msgpack`` (flax's msgpack form of ``{"params": tree}``, the
    layers in ``cfg.scan_layers``'s layout), which the reference's
    ``load_pretrained`` reads too. ``params``: a state dict or a
    ``BertClassifier``."""
    from . import _msgpack, convert

    if isinstance(params, nn.Module):
        params = params.state_dict()
    os.makedirs(path, exist_ok=True)
    d = dataclasses.asdict(cfg)
    d["dtype"] = _dtype_name(cfg.dtype)
    d["param_dtype"] = _dtype_name(cfg.param_dtype)
    publish_file(os.path.join(path, "config.json"),
                 lambda f: json.dump(d, f, indent=1))
    tree = convert.bert_to_reference(params, cfg)
    publish_file(os.path.join(path, "weights.msgpack"),
                 lambda f: _msgpack.dump(tree, f), binary=True)


def load_pretrained(path: str) -> tuple[BertConfig, dict]:
    """(config, state dict of CPU tensors) of a snapshot written by either
    package's ``save_pretrained`` (either layer layout)."""
    from . import _msgpack, convert

    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    for key in ("dtype", "param_dtype"):
        if d.get(key) not in _DTYPES:
            raise ValueError(f"snapshot config {key}={d.get(key)!r} is not "
                             "supported by the port")
        d[key] = _DTYPES[d[key]]
    cfg = BertConfig(**d)
    tree = _msgpack.load(os.path.join(path, "weights.msgpack"))
    return cfg, convert.bert_from_reference(tree, cfg)
