"""Where the time of the bench train step goes on the card.

    python -m kubeflow_tpu_torch.train.profile [--model bench|bench_moe]
        [--steps 3] [--warmup 3]

Trains the 271M bench model (or, with ``--model bench_moe``, the 1.24B MoE
bench model: 8 experts, top-2, dropless) at batch 14 x seq 1024 for
``--warmup`` steps, times ``--steps`` steps unprofiled, then traces as many
with ``torch.profiler`` and prints one JSON line: wall ms per step
(unprofiled and profiled), device busy ms per step (the kernels' summed time;
one stream, so they do not overlap), the device's idle share of an
unprofiled step, kernel launches per step, device ms per step by kind of
kernel, the top kernels by device time, and the time the model's FLOPs
(active ones for the MoE model) would take at the bf16 peak. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..models.llama import bench_model, bench_moe_model, flops_per_token
from .data import SyntheticLm
from .trainer import PEAK_TFLOPS, TrainConfig, Trainer

#: kernel-name fragments -> kind, first match wins
KINDS = (
    ("flash_fwd", "flash K1"), ("flash_bwd_dkv", "flash K2"),
    ("flash_bwd_dq", "flash K3"), ("tgmm", "grouped GEMM K4b (tgmm)"),
    ("gmm", "grouped GEMM K4a (gmm)"), ("sort", "sort/top-k"),
    ("topk", "sort/top-k"), ("indexselect", "gather (index_select)"),
    ("gemm", "matmul"), ("nvjet", "matmul"), ("cutlass", "matmul"),
    ("xmma", "matmul"), ("cublas", "matmul"),
    ("reduce", "reduction"), ("softmax", "softmax/cross-entropy"),
    ("nll", "softmax/cross-entropy"), ("embedding", "embedding"),
    ("index", "embedding"), ("copy", "copy/cast"), ("Memcpy", "copy/cast"),
    ("Memset", "memset"), ("elementwise", "elementwise"),
    ("foreach", "elementwise"),
)


MODELS = {"bench": bench_model, "bench_moe": bench_moe_model}


def _kind(name: str) -> str:
    for frag, kind in KINDS:
        if frag.lower() in name.lower():
            return kind
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="bench")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device is visible")
    total = args.warmup + 2 * args.steps
    cfg = TrainConfig(model=MODELS[args.model](), global_batch=14,
                      seq_len=1024, steps=total, warmup_steps=2)
    trainer = Trainer(cfg)
    trainer.init_state(0)
    source = SyntheticLm(cfg.global_batch, cfg.seq_len, cfg.model.vocab_size)

    def run(steps) -> float:
        """Wall ms per step over ``steps``, ending in a device sync."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in steps:
            trainer.step(source.local_batch(step)["tokens"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(steps)

    run(range(args.warmup))
    wall_ms = run(range(args.warmup, args.warmup + args.steps))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = run(range(args.warmup + args.steps, total))
    by_kind, kernels, launches = defaultdict(float), [], 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = _device_us(evt) / 1e3 / args.steps
        if ms <= 0:
            continue
        by_kind[_kind(evt.key)] += ms
        launches += evt.count
        kernels.append((ms, evt.count // args.steps, evt.key[:90]))
    busy = sum(by_kind.values())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    model_tflop = (flops_per_token(cfg.model, cfg.seq_len)
                   * cfg.global_batch * cfg.seq_len / 1e12)
    out = {
        "card": card, "model": args.model, "steps": args.steps,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": profiled_ms,
        "device_busy_ms_per_step": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "launches_per_step": launches / args.steps,
        "model_tflop_per_step": model_tflop,
        "model_ms_at_bf16_peak": (
            model_tflop / PEAK_TFLOPS[torch.cuda.get_device_name()] * 1e3),
        "device_ms_per_step_by_kind": dict(
            sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"ms_per_step": ms, "launches_per_step": n, "name": name}
            for ms, n, name in sorted(kernels, reverse=True)[:20]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
