"""Where the time of the serving engine's decode goes on the card.

    python -m kubeflow_tpu_torch.serving.profile
        [--model bench|bench_moe|llama_1b] [--quant none|weights|kv|both]
        [--rounds 3]

Serves ``bench.py``'s serving row through the port's ``ContinuousEngine``
(``llama_1b`` at ``max_seq_len`` 512; ``--quant``: ``quantize_for_serving``'s
int8 weights, int8 KV or both):
random weights from seed 0, 8 prompts of 128 tokens from
``numpy.random.default_rng(0)``, 8 slots, ``decode_chunk`` 16, pipeline depth
3, warmup at ``[(8, 128), (1, 128)]`` and a 16-token priming round. Then it
times ``--rounds`` rounds of 64 new tokens a prompt unprofiled, traces as
many with ``torch.profiler`` and prints one JSON line: wall ms per round
(unprofiled and profiled), device busy ms per round (the kernels' summed
time: one stream, so they do not overlap), the device's idle share of an
unprofiled round, decode dispatches and kernel launches per round, device ms
per round by kind of kernel (``train/profile.py``'s kinds), and the top
kernels. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models.llama import (Llama, bench_model, bench_moe_model, llama_1b,
                            quantize_for_serving)
from ..train.profile import _device_us, _kind
from .continuous import ContinuousEngine

MODELS = {"bench": bench_model, "bench_moe": bench_moe_model,
          "llama_1b": lambda: llama_1b(max_seq_len=512)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="bench")
    ap.add_argument("--quant", choices=["none", "weights", "kv", "both"],
                    default="none")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device is visible")
    cfg = MODELS[args.model]()
    model = Llama(cfg)
    model.init_weights(0)
    params = model
    if args.quant != "none":
        cfg, params = quantize_for_serving(
            cfg, model, weights=args.quant in ("weights", "both"),
            kv=args.quant in ("kv", "both"))
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(8, 128)).tolist()
    eng = ContinuousEngine(cfg, params, num_slots=8, decode_chunk=16,
                           pipeline_depth=3)

    def rounds(n: int) -> tuple[float, float]:
        """(wall ms per round, decode dispatches per round) over ``n``
        rounds of 64 new tokens a prompt."""
        steps0 = eng.stats()["decode_steps"]
        t0 = time.perf_counter()
        for _ in range(n):
            for r in [eng.submit(p, max_new_tokens=64) for p in prompts]:
                r.wait(600)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        return ms, (eng.stats()["decode_steps"] - steps0) / n

    try:
        eng.warmup([(8, 128), (1, 128)])
        for r in [eng.submit(p, max_new_tokens=16) for p in prompts]:
            r.wait(600)
        wall_ms, dispatches = rounds(args.rounds)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled_ms, _ = rounds(args.rounds)
        captures = eng.stats()["graph_captures_total"]
    finally:
        eng.stop()
    by_kind, kernels, launches = defaultdict(float), [], 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = _device_us(evt) / 1e3 / args.rounds
        if ms <= 0:
            continue
        by_kind[_kind(evt.key)] += ms
        launches += evt.count
        kernels.append((ms, evt.count / args.rounds, evt.key[:90]))
    busy = sum(by_kind.values())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    out = {
        "card": card, "model": args.model, "quant": args.quant,
        "rounds": args.rounds,
        "tokens_per_round": 8 * 64,
        "wall_ms_per_round": wall_ms,
        "profiled_wall_ms_per_round": profiled_ms,
        "decode_dispatches_per_round": dispatches,
        "device_busy_ms_per_round": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "launches_per_round": launches / args.rounds,
        "graph_captures_after_warmup": captures,
        "device_ms_per_round_by_kind": dict(
            sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"ms_per_round": ms, "launches_per_round": n, "name": name}
            for ms, n, name in sorted(kernels, reverse=True)[:20]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
