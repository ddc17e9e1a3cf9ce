"""One-shot NAS: a DARTS-style weight-sharing supernet over Llama shapes.

The port of ``kubeflow_tpu/hpo/nas.py``. SURVEY §2.3 lists NAS
(ENAS/DARTS) among the reference's suggestion services. ONE supernet trains
with continuous architecture parameters, and good discrete architectures
read off the learned mixture:

- **depth**: the supernet runs all ``L_max`` blocks and mixes the
  per-depth hidden states with ``softmax(alpha_depth)``;
- **FFN width**: width choices nest, so the mixture over masked widths is
  one column gate, ``softmax(alpha_ffn) @ nested`` (``nested[c, j]`` = 1
  when column j lies inside choice c): one max-width MLP;
- first-order BILEVEL DARTS: weights step on training batches, alphas on
  held-out batches.

Where the results could drift from the reference, the port follows it:

- two optimizers over disjoint parameters, each with its own moments:
  ``optax.adamw(weights_lr)`` (weight decay 1e-4, optax's default; torch's
  ``AdamW`` has 1e-2) steps the weights only, ``optax.adam(arch_lr)`` the
  alphas only (``train/optim.py`` ``Adam``);
- the stream is consumed in the reference's order: the first batch is
  drawn before init and trains step 0; each step then draws a validation
  batch, then the next training batch (from the same iterator when
  ``val_batches`` is None), the last step's extra draw included;
- dtype promotion: the width gate is f32, so in a bf16 model the gated
  hidden units, the down projection (its kernel rounded to bf16 first) and
  the residual stream after it are f32, as jax promotes them.

The attention is the port's ``llama.Attention``: with
``attention_impl="flash"`` on the card, the Hopper kernels K1-K3.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..models import llama as llamalib


@dataclasses.dataclass(frozen=True)
class ArchSpace:
    """The searched slice of the Llama shape space."""

    max_layers: int = 6
    ffn_widths: tuple[int, ...] = (64, 128)  # intermediate sizes, ascending

    def __post_init__(self):
        if list(self.ffn_widths) != sorted(set(self.ffn_widths)):
            raise ValueError("ffn_widths must be ascending and unique")


class _GatedMlp(llamalib._Projections):
    """Llama gated MLP with a per-column width gate (the nested-mask
    mixture over FFN width choices)."""

    def __init__(self, cfg: llamalib.LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        e, m = cfg.hidden_size, cfg.intermediate_size
        self.shapes = {"w_gate": ((e,), (m,)), "w_up": ((e,), (m,)),
                       "w_down": ((m,), (e,))}
        self._make_projections(cfg, device)

    def forward(self, x, gate):
        hidden = (F.silu(self.project("w_gate", x)) * self.project("w_up", x)
                  * gate)  # gate: [m] soft width mask (f32: promotes)
        w = self.w_down.to(self.cfg.dtype).to(hidden.dtype)
        return hidden @ w


class _SuperBlock(nn.Module):
    def __init__(self, cfg: llamalib.LlamaConfig, device):
        super().__init__()
        self.attn_norm = llamalib.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                          cfg.dtype, device)
        self.attn = llamalib.Attention(cfg, device)
        self.mlp_norm = llamalib.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                         cfg.dtype, device)
        self.mlp = _GatedMlp(cfg, device)

    def forward(self, x, positions, gate):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x), gate)


class SupernetLM(nn.Module):
    """Weight-sharing Llama supernet with architecture parameters
    ``alpha_depth`` [L_max] and ``alpha_ffn`` [len(ffn_widths)] (zeros at
    init: a uniform mixture)."""

    def __init__(self, cfg: llamalib.LlamaConfig, space: ArchSpace,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.space = cfg, space
        self.alpha_depth = nn.Parameter(
            torch.zeros(space.max_layers, device=device))
        self.alpha_ffn = nn.Parameter(
            torch.zeros(len(space.ffn_widths), device=device))
        self.embedder = llamalib.Embedder(cfg, device)
        self.layers = nn.ModuleList(
            _SuperBlock(cfg, device) for _ in range(space.max_layers))
        self.head = llamalib.Head(cfg, device)
        widths = torch.tensor(space.ffn_widths, device=device)
        cols = torch.arange(cfg.intermediate_size, device=device)
        self.register_buffer(
            "nested", (cols[None, :] < widths[:, None]).float(),
            persistent=False)

    def arch_parameters(self) -> list[nn.Parameter]:
        return [self.alpha_depth, self.alpha_ffn]

    def weight_parameters(self) -> list[nn.Parameter]:
        arch = {id(p) for p in self.arch_parameters()}
        return [p for p in self.parameters() if id(p) not in arch]

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """The reference's initializers from ``seed`` (embedding and
        unembedding normal(0.02), projections fan-in truncated normal,
        norm scales one, alphas zero); the draws differ from jax's."""
        gen = torch.Generator(device=self.alpha_depth.device)
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
        self.alpha_depth.zero_()
        self.alpha_ffn.zero_()

    def forward(self, tokens):
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
        # nested width masks -> one soft column gate [intermediate_size]
        gate = self.alpha_ffn.softmax(-1) @ self.nested
        x = self.embedder(tokens)
        depth_w = self.alpha_depth.softmax(-1)
        mix = torch.zeros_like(x)
        for layer, blk in enumerate(self.layers):
            x = blk(x, positions, gate)
            mix = mix + depth_w[layer] * x
        table = self.embedder.embedding if self.cfg.tie_embeddings else None
        return self.head(mix, table)


@dataclasses.dataclass
class NasResult:
    alpha_depth: np.ndarray
    alpha_ffn: np.ndarray
    #: (layers, ffn_width) ranked by joint architecture probability
    ranked: list[tuple[int, int]]
    final_loss: float


def supernet_config(base_cfg: llamalib.LlamaConfig, space: ArchSpace
                    ) -> llamalib.LlamaConfig:
    """The supernet's config: ``base_cfg`` at the space's max shape."""
    return dataclasses.replace(
        base_cfg, num_layers=space.max_layers,
        intermediate_size=space.ffn_widths[-1], remat=False)


def darts_search(
    base_cfg: llamalib.LlamaConfig,
    space: ArchSpace,
    batches: Iterator[Any],
    *,
    steps: int = 200,
    weights_lr: float = 3e-3,
    arch_lr: float = 3e-2,
    seed: int = 0,
    val_batches: Optional[Iterator[Any]] = None,
    device=None,
    init_state: Optional[dict] = None,
    on_init: Optional[Callable[[SupernetLM], None]] = None,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> NasResult:
    """Train the supernet for ``steps`` step pairs and read off ranked
    architectures.

    ``batches`` yields int [b, s] token arrays (next-token LM objective, as
    the trainer's). Each step pair: one weight step on a training batch,
    then one alpha step on a validation batch (``val_batches``, else the
    next draw of ``batches``). ``device``: the card by default;
    ``init_state``: a ``SupernetLM`` state dict to start from (else random
    init from ``seed``). Two seams for instrumentation, the port's own:
    ``on_init(model)`` sees the supernet once its weights are in place,
    before step 0; ``on_step(i, loss)`` sees each pair's weight-step loss as
    a device scalar after the pair (the loop itself makes no host sync).
    """
    cfg = supernet_config(base_cfg, space)
    dev = resolve_device(device)
    model = SupernetLM(cfg, space, device=dev)
    first = next(batches)
    if init_state is None:
        model.init_weights(seed)
    else:
        model.load_state_dict(init_state, strict=True)
    if on_init is not None:
        on_init(model)
    arch, weights = model.arch_parameters(), model.weight_parameters()
    # optax.adamw's default weight decay (1e-4); adam for the alphas
    opt_w = _Phase(weights, arch, weights_lr, 1e-4)
    opt_a = _Phase(arch, weights, arch_lr, 0.0)

    def step(phase: "_Phase", tokens) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(tokens), device=dev).long()
        phase.enter()
        logits = model(t[:, :-1])
        loss = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               t[:, 1:].reshape(-1))
        loss.backward()
        phase.opt.step()
        phase.opt.zero_grad()
        return loss.detach()

    if val_batches is None:
        # alternate draws from the one stream: train/val never share a
        # batch (a real split for i.i.d. streams)
        train_stream, val_stream = batches, batches
    else:
        train_stream, val_stream = batches, val_batches

    loss = torch.tensor(float("inf"))
    tokens = first
    for i in range(steps):
        loss = step(opt_w, tokens)
        step(opt_a, next(val_stream))
        tokens = next(train_stream)
        if on_step is not None:
            on_step(i, loss)
    for p in model.parameters():
        p.requires_grad_(True)

    a_d = model.alpha_depth.detach().cpu().double().numpy()
    a_f = model.alpha_ffn.detach().cpu().double().numpy()
    p_d = np.exp(a_d - a_d.max()); p_d /= p_d.sum()
    p_f = np.exp(a_f - a_f.max()); p_f /= p_f.sum()
    combos = [
        (int(layer + 1), int(w), float(p_d[layer] * p_f[c]))
        for layer in range(space.max_layers)
        for c, w in enumerate(space.ffn_widths)
    ]
    combos.sort(key=lambda t: -t[2])
    return NasResult(
        alpha_depth=a_d, alpha_ffn=a_f,
        ranked=[(layers, w) for layers, w, _ in combos],
        final_loss=float(loss),
    )


class _Phase:
    """One half of the bilevel step: its optimizer over ``own`` params;
    ``enter`` freezes the ``other`` group, so no gradient of it is
    computed (the reference's ``set_to_zero`` discards it)."""

    def __init__(self, own, other, lr: float, weight_decay: float):
        from ..train.optim import Adam

        self.own, self.other = own, other
        self.opt = Adam(own, learning_rate=lr, weight_decay=weight_decay)

    def enter(self) -> None:
        for p in self.own:
            p.requires_grad_(True)
        for p in self.other:
            p.requires_grad_(False)


# -- suggester integration ----------------------------------------------------

#: task registry: experiments point the darts suggester at a supernet task
#: via settings {"task_ref": "<key>"}; the value is a zero-arg callable ->
#: (base_cfg, ArchSpace, batch_iterator), or with a fourth element, a dict
#: of ``darts_search`` keywords (the port's ``device`` and ``init_state``)
_TASKS: dict[str, Callable[[], tuple]] = {}


def register_task(key: str, factory: Callable[[], tuple]) -> str:
    _TASKS[key] = factory
    return key


#: supernet runs keyed by (task, steps, seed) — MODULE level, because the
#: suggestion service constructs a fresh suggester per RPC; a per-instance
#: cache would retrain the supernet on every GetSuggestions call
_RANKING_CACHE: dict[str, list[tuple[int, int]]] = {}


class OneShotNas:
    """Katib-style suggester façade over ``darts_search``: the supernet
    runs on the first call (one shot), then architectures are suggested in
    ranked order for verification trials. Stateless-replay safe: same
    settings + seed -> same supernet run -> same ranking (cached per
    settings fingerprint). The request is duck-typed (``settings``,
    ``seed``, ``count``, ``issued``), as the reference's
    ``SuggestRequest``."""

    name = "darts"

    def suggest(self, req) -> list[dict[str, object]]:
        settings = req.settings
        key = settings.get("task_ref", "")
        if key not in _TASKS:
            raise ValueError(
                f"darts suggester needs settings.task_ref naming a "
                f"registered nas task; got {key!r}")
        fp = f"{key}:{settings.get('supernet_steps', '')}:{req.seed}"
        if fp not in _RANKING_CACHE:
            base_cfg, space, batches, *extra = _TASKS[key]()
            result = darts_search(
                base_cfg, space, batches,
                steps=int(settings.get("supernet_steps", 200)),
                seed=req.seed or 0,
                **(extra[0] if extra else {}),
            )
            _RANKING_CACHE[fp] = result.ranked
        ranked = _RANKING_CACHE[fp]
        out = []
        # finite space: stop at the end instead of cycling — returning
        # fewer than requested is the suggester-exhausted contract
        for i in range(req.count):
            pos = req.issued + i
            if pos >= len(ranked):
                break
            layers, width = ranked[pos]
            out.append({"layers": layers, "ffn_width": width})
        return out
