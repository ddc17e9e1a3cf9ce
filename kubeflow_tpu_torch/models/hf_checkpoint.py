"""Published-Llama checkpoint interop: safetensors -> the reference's
param tree, which ``convert.state_dict_from_jax`` turns into the port's
state dict.

The port's copy of ``kubeflow_tpu/models/hf_checkpoint.py``: numpy only, a
pure-numpy safetensors reader (an 8-byte little-endian header length, a
JSON header, raw tensor bytes; it only ever touches local files) plus the
name/layout map onto the scan-stacked tree. It returns the port's
``LlamaConfig``; params are f32, the port's only param dtype.

Layout notes:

- torch ``nn.Linear`` stores ``[out, in]``; every Einsum kernel here is
  input-major, so projections transpose.  Attention out dims unfold
  head-major: ``q_proj [H*D, E] -> wq.kernel [E, H, D]`` (HF's
  ``.view(num_heads, head_dim)`` order), ``o_proj [E, H*D] ->
  wo.kernel [H, D, E]``.
- rotary needs NO re-permutation: HF applies ``rotate_half`` over a
  split-at-half layout (the GPT-NeoX convention its conversion script
  permutes Meta weights into), and ``llama.rope`` uses the same
  split-half form — ``[x1*cos - x2*sin, x2*cos + x1*sin]``.
- per-layer tensors stack along a leading layer axis (the reference's
  scan-stacked layout).
- ``lm_head.weight`` absent + ``tie_word_embeddings`` true -> the
  config maps to ``tie_embeddings`` and the head reuses the table.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def _decode(raw: bytes, dtype: str, shape: list[int]) -> np.ndarray:
    if dtype == "BF16":
        # numpy has no bfloat16: widen via the bit pattern (bf16 is the
        # top 16 bits of f32)
        u16 = np.frombuffer(raw, dtype="<u2")
        return (u16.astype(np.uint32) << 16).view(np.float32).reshape(shape)
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported safetensors dtype {dtype!r}")
    return np.frombuffer(
        raw, dtype=np.dtype(_DTYPES[dtype]).newbyteorder("<")
    ).reshape(shape)


class SafetensorsView:
    """Lazy, mmap-backed view over one or more safetensors files.

    A 7B bf16 snapshot is ~13.5 GB; eagerly decoding every tensor while
    also building the stacked f32 param tree would peak at several times
    the model size in host RSS.  Files mmap instead (pages stream in on
    access and are evictable), and ``__getitem__`` decodes ONE tensor per
    call — non-BF16 tensors come back as zero-copy views into the map,
    BF16 widens per tensor.  The converter touches each tensor exactly
    once, so peak = final params + one tensor.
    """

    def __init__(self) -> None:
        self._entries: dict[str, tuple[memoryview, dict]] = {}
        self._maps: list = []  # keep mmaps alive

    def add_file(self, path: str) -> None:
        import mmap as mmaplib

        f = open(path, "rb")
        try:
            mm = mmaplib.mmap(f.fileno(), 0, access=mmaplib.ACCESS_READ)
        finally:
            f.close()  # the map holds its own reference
        self._maps.append(mm)
        if len(mm) < 8:
            raise ValueError(f"{path}: not a safetensors file")
        (hlen,) = np.frombuffer(mm[:8], dtype="<u8")
        hlen = int(hlen)
        if 8 + hlen > len(mm):
            raise ValueError(f"{path}: header length {hlen} exceeds file")
        header = json.loads(bytes(mm[8 : 8 + hlen]))
        data = memoryview(mm)[8 + hlen :]
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            begin, end = meta["data_offsets"]
            if not (0 <= begin <= end <= len(data)):
                raise ValueError(
                    f"{path}: tensor {name!r} offsets out of range")
            self._entries[name] = (data[begin:end], meta)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return self._entries.keys()

    def __getitem__(self, name: str) -> np.ndarray:
        raw, meta = self._entries[name]
        return _decode(raw, meta["dtype"], meta["shape"])


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """One ``*.safetensors`` file -> {name: array}, eager (small files /
    tests; the checkpoint-sized path goes through SafetensorsView)."""
    view = SafetensorsView()
    view.add_file(path)
    return {name: np.array(view[name]) for name in view}


def load_safetensors_dir(path: str) -> SafetensorsView:
    """All tensors of a snapshot directory — single ``model.safetensors``
    or the sharded ``model-XXXXX-of-YYYYY.safetensors`` + index layout —
    as one lazy mmap-backed view."""
    view = SafetensorsView()
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map: dict[str, str] = json.load(f)["weight_map"]
        for fname in sorted(set(weight_map.values())):
            view.add_file(os.path.join(path, fname))
        missing = set(weight_map) - set(view.keys())
        if missing:
            raise ValueError(
                f"index names missing tensors: {sorted(missing)[:5]}")
        return view
    files = sorted(
        f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    for fname in files:
        view.add_file(os.path.join(path, fname))
    return view


def is_hf_snapshot(path: str) -> bool:
    """Transformers-layout detector: a ``model_type`` key in config.json
    (this repo's ``save_pretrained`` writes the LlamaConfig dataclass,
    which has none) or any safetensors file."""
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        try:
            with open(cfg_path) as f:
                if "model_type" in json.load(f):
                    return True
        except (OSError, json.JSONDecodeError):
            pass
    return any(
        f.endswith(".safetensors") for f in os.listdir(path)
    ) if os.path.isdir(path) else False


def config_from_hf(path: str):
    """transformers ``config.json`` -> the port's LlamaConfig
    (architecture fields only; dtype, remat and attention_impl keep the
    defaults and stay overridable with dataclasses.replace)."""
    from . import llama as llamalib

    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    mt = d.get("model_type", "llama")
    if mt not in ("llama", "mistral"):
        raise ValueError(
            f"unsupported checkpoint model_type {mt!r} (llama-family only)")
    sw = d.get("sliding_window")
    if sw and int(sw) < int(d.get("max_position_embeddings", sw)):
        # attending past the trained window silently degrades output —
        # refuse loudly like the rope_scaling guard below
        raise ValueError(
            f"sliding_window={sw} attention is not implemented by "
            "the port's llama.py; refusing a checkpoint that would silently "
            "mis-generate past the window")
    rs = d.get("rope_scaling") or {}
    if rs and rs.get("rope_type", rs.get("type")) not in (None, "default"):
        # silently dropping llama3/linear/yarn rope scaling would load a
        # model that runs but generates garbage — fail loudly instead
        raise ValueError(
            f"rope_scaling {rs.get('rope_type', rs.get('type'))!r} is not "
            "implemented by the port's llama.rope(); refusing to load a "
            "checkpoint that would silently mis-generate")
    heads = int(d["num_attention_heads"])
    hidden = int(d["hidden_size"])
    return llamalib.LlamaConfig(
        vocab_size=int(d["vocab_size"]),
        hidden_size=hidden,
        intermediate_size=int(d["intermediate_size"]),
        num_layers=int(d["num_hidden_layers"]),
        num_heads=heads,
        num_kv_heads=int(d.get("num_key_value_heads", heads)),
        head_dim=int(d.get("head_dim", hidden // heads)),
        max_seq_len=int(d.get("max_position_embeddings", 4096)),
        rope_theta=float(d.get("rope_theta", 10000.0)),
        rms_norm_eps=float(d.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(d.get("tie_word_embeddings", False)),
    )


def llama_params_from_hf(cfg, tensors) -> Any:
    """HF tensor mapping (dict or SafetensorsView) -> the reference's
    (scan-stacked) param tree, in f32."""
    E, M = cfg.hidden_size, cfg.intermediate_size
    H, KV, D, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    pd = np.dtype(np.float32)

    def t(name: str, shape: tuple[int, ...]) -> np.ndarray:
        if name not in tensors:
            raise KeyError(f"checkpoint missing tensor {name!r}")
        arr = tensors[name]
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"{name}: shape {arr.shape} != expected {shape}")
        return arr.astype(pd)

    def stack(fmt: str, shape, reshape=None, transpose=False):
        rows = []
        for layer in range(L):
            arr = t(fmt.format(layer), shape)
            if transpose:
                arr = arr.T
            if reshape is not None:
                arr = arr.reshape(reshape)
            rows.append(arr)
        return np.stack(rows)

    p = "model.layers.{}."
    block = {
        "attn_norm": {"scale": stack(p + "input_layernorm.weight", (E,))},
        "mlp_norm": {
            "scale": stack(p + "post_attention_layernorm.weight", (E,))},
        "attn": {
            "wq": {"kernel": stack(
                p + "self_attn.q_proj.weight", (H * D, E),
                reshape=(E, H, D), transpose=True)},
            "wk": {"kernel": stack(
                p + "self_attn.k_proj.weight", (KV * D, E),
                reshape=(E, KV, D), transpose=True)},
            "wv": {"kernel": stack(
                p + "self_attn.v_proj.weight", (KV * D, E),
                reshape=(E, KV, D), transpose=True)},
            # o_proj [E, H*D] -> [H*D, E] -> [H, D, E]
            "wo": {"kernel": stack(
                p + "self_attn.o_proj.weight", (E, H * D),
                reshape=(H, D, E), transpose=True)},
        },
        "mlp": {
            "w_gate": {"kernel": stack(
                p + "mlp.gate_proj.weight", (M, E), transpose=True)},
            "w_up": {"kernel": stack(
                p + "mlp.up_proj.weight", (M, E), transpose=True)},
            "w_down": {"kernel": stack(
                p + "mlp.down_proj.weight", (E, M), transpose=True)},
        },
    }
    params: dict[str, Any] = {
        "embedder": {
            "embedding": t("model.embed_tokens.weight", (cfg.vocab_size, E))},
        "layers": {"block": block},
        "head": {"final_norm": {"scale": t("model.norm.weight", (E,))}},
    }
    if not cfg.tie_embeddings:
        if "lm_head.weight" not in tensors:
            raise KeyError(
                "checkpoint has no lm_head.weight but config does not tie "
                "embeddings")
        params["head"]["unembedding"] = t(
            "lm_head.weight", (cfg.vocab_size, E)).T.copy()
    return params


def load_hf_llama(path: str):
    """(LlamaConfig, param tree) from a transformers-layout snapshot dir."""
    cfg = config_from_hf(path)
    params = llama_params_from_hf(cfg, load_safetensors_dir(path))
    return cfg, params
