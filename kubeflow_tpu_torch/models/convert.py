"""Weight bridge: the reference's flax param tree -> the port's state_dict.

The port keeps the reference's kernel layouts, so the bridge renames and, for
the scan-stacked layout, unstacks the leading layer axis; nothing is
transposed. An MoE layer's router and experts are raw params (no ``kernel``
key), ``[L, E, h, m]`` when scan-stacked. Input is the ``params`` tree as
nested dicts of numpy arrays (or anything ``numpy.asarray`` accepts), in
either layout:

- scan-stacked: ``params["layers"]["block"][...]`` with a leading L axis;
- unrolled: ``params["layer_{i}"][...]``.
"""

from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaConfig

_BLOCK = {
    "attn_norm.scale": ("attn_norm", "scale"),
    "attn.wq": ("attn", "wq", "kernel"),
    "attn.wk": ("attn", "wk", "kernel"),
    "attn.wv": ("attn", "wv", "kernel"),
    "attn.wo": ("attn", "wo", "kernel"),
    "mlp_norm.scale": ("mlp_norm", "scale"),
}
_MLP = {f"mlp.{n}": ("mlp", n, "kernel") for n in ("w_gate", "w_up", "w_down")}
_MOE_MLP = {f"mlp.{n}": ("mlp", n)
            for n in ("router", "w_gate", "w_up", "w_down")}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.array(tree, dtype=np.float32)


def state_dict_from_jax(params, cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """CPU f32 tensors keyed like ``Llama(cfg).state_dict()``."""
    out = {
        "embedder.embedding": _get(params, ("embedder", "embedding")),
        "head.final_norm.scale": _get(params, ("head", "final_norm", "scale")),
    }
    if not cfg.tie_embeddings:
        out["head.unembedding"] = _get(params, ("head", "unembedding"))
    stacked = "layers" in params
    block = {**_BLOCK, **(_MOE_MLP if cfg.moe_experts > 0 else _MLP)}
    for name, path in block.items():
        if stacked:
            arr = _get(params["layers"]["block"], path)
            if arr.shape[0] != cfg.num_layers:
                raise ValueError(
                    f"{name}: {arr.shape[0]} stacked layers, config has "
                    f"{cfg.num_layers}")
            for i in range(cfg.num_layers):
                out[f"layers.{i}.{name}"] = arr[i]
        else:
            for i in range(cfg.num_layers):
                out[f"layers.{i}.{name}"] = _get(params[f"layer_{i}"], path)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
