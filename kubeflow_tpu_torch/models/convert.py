"""Weight bridge between the reference's flax param tree and the port's
state_dict, both ways.

The port keeps the reference's kernel layouts, so the bridge renames and, for
the scan-stacked layout, stacks or unstacks the leading layer axis; nothing
is transposed. The tree is nested dicts (numpy arrays, anything
``numpy.asarray`` accepts, or torch tensors), in either layout:

- scan-stacked: ``params["layers"]["block"][...]`` with a leading L axis;
- unrolled: ``params["layer_{i}"][...]``.

Names: a projection ``w`` of ``attn``/``mlp`` is the tree's
``{w: {"kernel", "scale", "lora_a", "lora_b"}}`` and the port's ``w``,
``w_scale``, ``w_lora_a`` and ``w_lora_b``. An MoE layer's router and
experts are raw params (no ``kernel`` key), ``[L, E, h, m]`` when stacked.
The head's ``unembedding`` and ``unembedding_scale`` keep their names.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _msgpack
from .llama import Llama, LlamaConfig

_SUFFIXES = (("_lora_a", "lora_a"), ("_lora_b", "lora_b"),
             ("_scale", "scale"))


def tree_path(key: str, moe: bool = False) -> tuple[int | None, tuple]:
    """(layer or None, the path inside the layer's block or the tree) of a
    state_dict key."""
    parts = key.split(".")
    layer = None
    if parts[0] == "layers":
        layer, parts = int(parts[1]), parts[2:]
    if len(parts) == 2 and parts[0] in ("attn", "mlp"):
        mod, name = parts
        if mod == "mlp" and moe:
            return layer, (mod, name)
        for suffix, leaf in _SUFFIXES:
            if name.endswith(suffix):
                return layer, (mod, name[:-len(suffix)], leaf)
        return layer, (mod, name, "kernel")
    return layer, tuple(parts)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _host(x) -> torch.Tensor:
    """A tree leaf as a CPU tensor: integer leaves keep their dtype,
    floating ones become f32 (the port's params are f32)."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        if not np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32, copy=False)
        if not arr.flags.writeable:  # torch takes only writable memory
            arr = arr.copy()
        x = torch.from_numpy(arr)
    if x.is_floating_point() and x.dtype != torch.float32:
        x = x.float()
    return x.detach().cpu()


def state_dict_keys(cfg: LlamaConfig) -> dict[str, torch.Size]:
    """Every key of ``Llama(cfg).state_dict()`` and its shape."""
    return {k: v.shape for k, v in
            Llama(cfg, device="meta").state_dict().items()}


def state_dict_from_jax(params, cfg: LlamaConfig, *, partial: bool = False
                        ) -> dict[str, torch.Tensor]:
    """CPU tensors keyed like ``Llama(cfg).state_dict()``. With ``partial``
    only the keys the tree holds (a base without its adapters, adapters
    alone), else every key, or ``KeyError``."""
    stacked = "layers" in params
    moe = cfg.moe_experts > 0
    out = {}
    for key, shape in state_dict_keys(cfg).items():
        layer, path = tree_path(key, moe)
        try:
            if layer is None:
                leaf = _get(params, path)
            elif stacked:
                leaf = _get(params["layers"]["block"], path)
            else:
                leaf = _get(params[f"layer_{layer}"], path)
        except KeyError:
            if partial:
                continue
            raise KeyError(f"{key}: the tree has no {'/'.join(path)}") \
                from None
        t = _host(leaf)
        if layer is not None and stacked:
            if t.shape[0] != cfg.num_layers:
                raise ValueError(
                    f"{key}: {t.shape[0]} stacked layers, config has "
                    f"{cfg.num_layers}")
            t = t[layer]
        if t.shape != shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != expected "
                             f"{tuple(shape)}")
        out[key] = t.contiguous()
    return out


def tree_from_state_dict(sd: dict, cfg: LlamaConfig, *, stacked: bool = True,
                         lazy: bool = False) -> dict:
    """The reference's param tree of a (full or partial) state dict, in the
    scan-stacked or unrolled layout: numpy arrays (torch tensors for
    bfloat16); with ``lazy`` the tensors as they are and each stacked leaf
    a ``_msgpack.Stacked`` (written without being stacked in memory)."""
    moe = cfg.moe_experts > 0
    tree: dict = {}
    layered: dict[tuple, dict[int, torch.Tensor]] = {}
    for key, value in sd.items():
        layer, path = tree_path(key, moe)
        if layer is None:
            _put(tree, path, value if lazy else _numpy(value))
        elif stacked:
            layered.setdefault(path, {})[layer] = value
        else:
            _put(tree, (f"layer_{layer}", *path),
                 value if lazy else _numpy(value))
    for path, by_layer in layered.items():
        if sorted(by_layer) != list(range(cfg.num_layers)):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(by_layer)} "
                             f"of {cfg.num_layers}")
        parts = [by_layer[i].detach() for i in range(cfg.num_layers)]
        leaf = _msgpack.Stacked(parts)
        if not lazy:
            leaf = _numpy(leaf.materialize())
        _put(tree, ("layers", "block", *path), leaf)
    return tree


def _numpy(t: torch.Tensor):
    """A CPU numpy array of ``t`` (bfloat16 stays a torch tensor)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
