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
from .llama import Llama, LlamaConfig, leaf_dtype

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


def _host(x, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A tree leaf as a CPU tensor: integer leaves keep their dtype,
    floating ones become ``dtype`` (the config's ``param_dtype``)."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            # ml_dtypes' bfloat16 (a reference tree in memory): its bits
            x = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            if not np.issubdtype(arr.dtype, np.integer):
                arr = arr.astype(np.float32, copy=False)
            if not arr.flags.writeable:  # torch takes only writable memory
                arr = arr.copy()
            x = torch.from_numpy(arr)
    if x.is_floating_point() and x.dtype != dtype:
        x = x.to(dtype)
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
        t = _host(leaf, leaf_dtype(key, cfg))
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


# -- the other model families ---------------------------------------------------
#
# Reference param trees (numpy leaves; a top ``{"params": ...}`` wrapper, as
# ``model.init`` returns, is taken too) in, the port's state dicts (CPU
# tensors, each leaf in the dtype the module holds it in: its config's
# ``param_dtype``, norms f32) out. Each checks that the result covers the
# port module's keys and shapes.


def _unwrap(params):
    return params["params"] if set(params) == {"params"} else params


def _flatten(tree, prefix: tuple = ()):
    """(path, leaf) of every leaf of a nested dict, in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _checked(out: dict, module: torch.nn.Module, what: str) -> dict:
    """``out`` when its keys and shapes are ``module.state_dict()``'s, each
    floating leaf cast to the module's dtype for it."""
    held = module.state_dict()
    want = {k: v.shape for k, v in held.items()}
    got = {k: v.shape for k, v in out.items()}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        bad = sorted(k for k in set(got) & set(want) if got[k] != want[k])
        raise ValueError(f"{what}: the tree does not match the port's "
                         f"module (missing {missing}, extra {extra}, "
                         f"shapes differ {bad})")
    return {k: v.to(held[k].dtype) if v.is_floating_point() else v
            for k, v in out.items()}


def _einsum_key(path: tuple) -> str:
    """A state dict key of a tree path: ``layer_{i}`` -> ``layers.{i}``,
    Einsum ``kernel`` leaves dropped (the port's param is the kernel)."""
    parts = []
    for p in path:
        if p.startswith("layer_") and p[6:].isdigit():
            parts += ["layers", p[6:]]
        elif p != "kernel":
            parts.append(p)
    return ".".join(parts)


def _unstack(tree: dict, n: int) -> list[dict]:
    """A scan-stacked subtree (leading axis ``n``) as ``n`` per-layer
    subtrees."""
    flat = dict(_flatten(tree))
    layers = []
    for i in range(n):
        layer: dict = {}
        for path, leaf in flat.items():
            arr = np.asarray(leaf) if not isinstance(leaf, torch.Tensor) \
                else leaf
            if arr.shape[0] != n:
                raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} stacked "
                                 f"layers, config has {n}")
            _put(layer, path, arr[i])
        layers.append(layer)
    return layers


def bert_from_reference(params, cfg) -> dict[str, torch.Tensor]:
    """The port's ``BertClassifier`` state dict of a reference BERT tree,
    in either layer layout (``encoder/layers`` scan-stacked with a leading
    axis, or ``encoder/layer_{i}``)."""
    from .bert import BertClassifier

    params = dict(_unwrap(params))
    enc = dict(params["encoder"])
    if "layers" in enc:
        for i, layer in enumerate(_unstack(enc.pop("layers"),
                                           cfg.num_layers)):
            enc[f"layer_{i}"] = layer
    params["encoder"] = enc
    out = {_einsum_key(path): _host(leaf).contiguous()
           for path, leaf in _flatten(params)}
    return _checked(out, BertClassifier(cfg, device="meta"), "BERT")


def bert_to_reference(sd: dict, cfg) -> dict:
    """The reference's ``{"params": tree}`` of a port BERT state dict, in
    ``cfg.scan_layers``'s layout, each leaf in its ``bert.leaf_dtype``
    (numpy; bf16 ones torch tensors)."""
    from .bert import EINSUMS, leaf_dtype

    tree: dict = {}
    layered: dict[tuple, dict[int, np.ndarray]] = {}
    for key, value in sd.items():
        parts = key.split(".")
        leaf = _numpy(value.to(leaf_dtype(key, cfg)))
        if parts[-1] in EINSUMS:
            parts.append("kernel")
        if parts[:2] == ["encoder", "layers"]:
            i, rest = int(parts[2]), tuple(parts[3:])
            if cfg.scan_layers:
                layered.setdefault(rest, {})[i] = leaf
            else:
                _put(tree, ("encoder", f"layer_{i}", *rest), leaf)
        else:
            _put(tree, tuple(parts), leaf)
    for rest, by_layer in layered.items():
        _put(tree, ("encoder", "layers", *rest), _msgpack.Stacked(
            [by_layer[i] for i in range(cfg.num_layers)]).materialize())
    return {"params": tree}


def linen_from_reference(params, module: torch.nn.Module, what: str
                         ) -> dict[str, torch.Tensor]:
    """The state dict of a torch module whose submodules carry flax's
    names, from the flax tree: ``Conv`` kernels HWIO -> ``weight`` OIHW,
    ``Dense`` kernels ``(in, out)`` -> ``weight`` ``(out, in)``, GroupNorm
    ``scale`` -> ``weight``, biases as they are."""
    out = {}
    for path, leaf in _flatten(_unwrap(params)):
        t = _host(leaf)
        name = path[-1]
        if name == "kernel":
            t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
            name = "weight"
        elif name == "scale":
            name = "weight"
        out[".".join((*path[:-1], name))] = t.contiguous()
    return _checked(out, module, what)


def resnet_from_reference(params, cfg) -> dict[str, torch.Tensor]:
    """The port's ``ResNet`` state dict of a reference ResNet tree."""
    from .resnet import ResNet

    return linen_from_reference(params, ResNet(cfg, device="meta"),
                                "ResNet")


def mnist_from_reference(params, hidden: int = 128
                         ) -> dict[str, torch.Tensor]:
    """The port's MNIST ``MLP`` state dict of a reference MLP tree."""
    from .mnist import MLP

    return linen_from_reference(params, MLP(hidden, device="meta"), "MLP")


def supernet_from_reference(params, cfg, space) -> dict[str, torch.Tensor]:
    """The port's ``SupernetLM`` state dict of the reference supernet's
    tree (``alpha_depth``, ``alpha_ffn``, ``embedder``, ``layer_{i}``,
    ``head``). ``cfg`` is the supernet's config (``darts_search``'s, at
    max shape)."""
    from ..hpo.nas import SupernetLM

    out = {_einsum_key(path): _host(leaf).contiguous()
           for path, leaf in _flatten(_unwrap(params))}
    return _checked(out, SupernetLM(cfg, space, device="meta"), "supernet")
