"""CPU measurements behind two limits of ``chip_smoke.py``'s card checks,
the port against the reference on the same weights (small shapes):

    JAX_PLATFORMS=cpu python -m tests._torch_measure int8
    JAX_PLATFORMS=cpu python -m tests._torch_measure tp

``int8``: how far int8 serving weights (``quantize_for_serving``) move
the logits from the plain model's, per position, as a relative L2
distance: the reference's full forward and the port's, and the port's
forward through an int8 KV cache fed the plain greedy streams
(``chip_smoke._forced_distance``, as ``finetune_serve`` holds it), at
the parity tests' tiny config and at llama_1b's depth, layout and dtype
with its width cut.
``finetune_serve``'s ``INT8_TEACHER_TOL`` comes from it.

``tp``: how far a two-way tensor-parallel model's logits sit from the
same model unsharded, on the same bf16 weights and streams: the
reference's ``mesh_axes`` engine (two virtual CPU devices) and the port's
engine layout on two gloo ranks (``parallel.dryrun.spawn``).

Each prints one JSON object. Imports the reference and the port; not a
test module.
"""

import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel_l2(got, want) -> float:
    """The largest per-position relative L2 distance of two logit arrays
    [..., vocab]."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


def _greedy(model, prompts, new: int):
    import torch

    out = []
    with torch.no_grad():
        for p in prompts:
            seq = list(p)
            for _ in range(new):
                logits = model(torch.tensor([seq]))
                seq.append(int(logits[0, -1].argmax()))
            out.append(seq[len(p):])
    return out


def int8_distance(name: str, kw: dict, rows: int = 4, plen: int = 48,
                  new: int = 24) -> dict:
    import jax.numpy as jnp
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from kubeflow_tpu.models import llama as ref
    from kubeflow_tpu_torch.models import convert, llama

    torch.set_num_threads(4)
    base = llama.tiny if name == "tiny" else llama.llama_1b
    rbase = ref.tiny if name == "tiny" else ref.llama_1b
    cfg = base(**kw, max_seq_len=plen + new)
    rkw = {k: (jnp.float32 if v is torch.float32 else
               jnp.bfloat16 if v is torch.bfloat16 else v)
           for k, v in kw.items()}
    rcfg = rbase(**rkw, max_seq_len=plen + new)
    plain = llama.Llama(cfg, device="cpu")
    plain.init_weights(0)
    sd = {k: v.detach().clone() for k, v in plain.state_dict().items()}
    qcfg, qsd = llama.quantize_for_serving(cfg, sd)
    int8 = llama.Llama(qcfg, device="cpu")
    int8.load_state_dict(qsd)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (rows, plen)).tolist()
    streams = _greedy(plain, prompts, new)
    tokens = np.array([p + s for p, s in zip(prompts, streams)], np.int32)
    at = slice(plen - 1, plen + new - 1)  # the positions scoring the streams
    with torch.no_grad():
        port = {k: m(torch.from_numpy(tokens)).float().numpy()[:, at]
                for k, m in (("plain", plain), ("int8", int8))}
    rparams = convert.tree_from_state_dict(sd, cfg, stacked=rcfg.scan_layers)
    rqcfg, rq = ref.quantize_for_serving(rcfg, rparams)
    reference = {
        "plain": np.asarray(ref.Llama(rcfg).apply({"params": rparams},
                                                  tokens), np.float32)[:, at],
        "int8": np.asarray(ref.Llama(rqcfg).apply({"params": rq}, tokens),
                           np.float32)[:, at]}
    tf = chip_smoke._forced_distance(plain, int8, prompts, streams)
    return {
        "config": name, "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "dtype": str(cfg.dtype), "rows": rows, "prompt_len": plen,
        "new": new,
        "reference_int8_vs_plain": _rel_l2(reference["int8"],
                                           reference["plain"]),
        "port_int8_vs_plain": _rel_l2(port["int8"], port["plain"]),
        "port_cache_int8_vs_plain": tf["rel_l2_max"],
        "port_cache_argmax_agree": [tf["argmax_agree"], tf["positions"]],
        "port_vs_reference_plain": _rel_l2(port["plain"], reference["plain"]),
        "port_vs_reference_int8": _rel_l2(port["int8"], reference["int8"]),
    }


#: the C10 shapes: the bench model's layout, depth and dtype (16 layers,
#: head_dim 128, bf16) with its width cut to 256 (two heads, one a rank)
TP_KW = dict(hidden_size=256, intermediate_size=704, num_heads=2,
             num_kv_heads=2, max_seq_len=128)
TP_ROWS, TP_PROMPT, TP_NEW = 4, 48, 24


def _tp_rank(rank: int, prompts, streams) -> dict:
    """One rank of the port's two-way TP model (``serving/sharded.py``
    ``place_params``, the TP engine's layout) beside the unsharded model of
    the same seed: the decode path fed the streams
    (``chip_smoke._teacher_forced_check``, as ``tp_serve`` holds it) and
    the full forward."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.sharded import (
        build_serving_mesh, place_params)

    torch.set_num_threads(2)
    cfg = llama.bench_model(**TP_KW)
    plain = llama.Llama(cfg, device="cpu")
    plain.init_weights(0)
    tp = place_params(cfg, plain, build_serving_mesh({"model": 2}), "cpu")
    decode = chip_smoke._teacher_forced_check(plain, tp, prompts, streams)
    tokens = torch.tensor([p + s for p, s in zip(prompts, streams)])
    at = slice(TP_PROMPT - 1, TP_PROMPT + TP_NEW - 1)
    with torch.no_grad():
        full = _rel_l2(tp(tokens).float().numpy()[:, at],
                       plain(tokens).float().numpy()[:, at])
    return {"rank": rank, "decode_rel_l2_max": decode["rel_l2_max"],
            "decode_argmax_agree": [decode["argmax_agree"],
                                    decode["positions"]],
            "full_forward_rel_l2_max": full}


def tp_distance() -> dict:
    """C10: the port's TP=2 distance (two gloo ranks) and the reference's
    (``mesh_axes`` {"model": 2} over two virtual CPU devices, its serving
    ``place_params`` + ``mesh_jit``), each from its own unsharded model,
    on the same bf16 weights (the port's init from seed 0, converted),
    prompts and the port's unsharded greedy streams."""
    import jax
    import jax.numpy as jnp
    import torch

    from kubeflow_tpu.models import llama as ref
    from kubeflow_tpu.serving import sharded as ref_sharded
    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.parallel.dryrun import spawn

    torch.set_num_threads(4)
    cfg = llama.bench_model(**TP_KW)
    plain = llama.Llama(cfg, device="cpu")
    plain.init_weights(0)
    sd = {k: v.detach().clone() for k, v in plain.state_dict().items()}
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (TP_ROWS, TP_PROMPT)).tolist()
    streams = _greedy(plain, prompts, TP_NEW)
    tokens = np.array([p + s for p, s in zip(prompts, streams)], np.int32)
    at = slice(TP_PROMPT - 1, TP_PROMPT + TP_NEW - 1)
    ranks = spawn(2, _tp_rank, prompts, streams, timeout=900)

    sys.path.insert(0, ROOT)
    from __graft_entry__ import _bench_model

    rcfg = dataclasses.replace(_bench_model(), attention_impl="dense",
                               **TP_KW)
    params = convert.tree_from_state_dict(sd, cfg, stacked=rcfg.scan_layers)
    fwd = lambda p, t: ref.Llama(rcfg).apply({"params": p}, t)  # noqa: E731
    want = np.asarray(jax.jit(fwd)(params, jnp.asarray(tokens)),
                      np.float32)[:, at]
    mesh = ref_sharded.build_serving_mesh({"model": 2})
    placed = ref_sharded.place_params(rcfg, params, mesh)
    got = np.asarray(ref_sharded.mesh_jit(mesh, fwd)(placed,
                                                     jnp.asarray(tokens)),
                     np.float32)[:, at]
    with torch.no_grad():
        port_plain = plain(torch.from_numpy(tokens)).float().numpy()[:, at]
    return {"config": "bench_model", "kw": TP_KW, "rows": TP_ROWS,
            "prompt_len": TP_PROMPT, "new": TP_NEW,
            "jax_devices": len(jax.devices()),
            "reference_tp2_vs_unsharded": _rel_l2(got, want),
            "reference_argmax_agree": int((got.argmax(-1)
                                           == want.argmax(-1)).sum()),
            "port_tp2_ranks": ranks,
            "port_vs_reference_unsharded": _rel_l2(port_plain, want)}


def main(argv) -> None:
    # the reference's mesh needs two devices: virtual CPU devices, set
    # before jax loads
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=2")
    what = argv[1] if len(argv) > 1 else "int8"
    if what == "int8":
        import torch

        cases = [
            ("tiny", {}),
            ("llama_1b", dict(hidden_size=256, intermediate_size=688,
                              num_heads=2, num_kv_heads=2)),
            ("llama_1b", dict(hidden_size=512, intermediate_size=1376,
                              num_heads=4, num_kv_heads=4)),
        ]
        for name, kw in cases:
            print(json.dumps(int8_distance(name, kw)), flush=True)
        del torch
    elif what == "tp":
        print(json.dumps(tp_distance()), flush=True)
    else:
        raise SystemExit(f"unknown measurement {what!r}: int8 or tp")


if __name__ == "__main__":
    main(sys.argv)
