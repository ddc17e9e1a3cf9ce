#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kubeflow_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written Hopper flash-attention kernels from ``kubeflow_tpu_torch/
ops/csrc`` into ``build/kernels/``, holds each kernel against its plain f32
version, times them, trains the 271M bench Llama for 13 steps at batch 14 x
seq 1024 through the port's ``Trainer``, checks that the step really launched
the kernels, and compares one small bf16 step on the card with the same step
on the CPU. Each phase prints one JSON line; the line before the last is the
card's name and power limit from nvidia-smi, the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line. Needs a CUDA card; imports nothing of jax or kubeflow_tpu.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

#: H100 SXM published peaks (NVIDIA data sheet): dense bf16 and HBM rate
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
#: kernel vs plain f32 version: max |kernel - plain| / max |plain|
REL_TOL = 1e-2
LSE_ATOL = 1e-3
#: the bench shape: b=14 x seq 1024, h=kv=8, head_dim 128
BENCH = dict(b=14, s=1024, h=8, kv=8, d=128)
SEED = 0
TPU_SOURCE = "kubeflow_tpu/ops/flash_attention.py"
KERNEL_INFO = {
    "flash_fwd": ("kubeflow_tpu_torch/ops/csrc/flash_fwd.cu",
                  f"{TPU_SOURCE}:72 (_fwd_kernel)"),
    "flash_bwd_dkv": ("kubeflow_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      f"{TPU_SOURCE}:168 (_bwd_dkv_kernel)"),
    "flash_bwd_dq": ("kubeflow_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     f"{TPU_SOURCE}:216 (_bwd_dq_kernel)"),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median device time of one call, from CUDA events around each call."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bounds(b, s, h, kv, d, causal=True) -> dict[str, dict]:
    """Each kernel's work on this shape (bytes: each input read once, each
    output written once; FLOPs: the tile products over the unmasked pairs)
    and the least time it could take: the larger of bytes over the HBM rate
    and FLOPs over the bf16 peak."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    act_q, act_kv, row = b * s * h * d * 2, b * s * kv * d * 2, b * h * s * 4
    work = {
        "flash_fwd": (2 * act_q + 2 * act_kv + row, 4 * pairs * d),
        "flash_bwd_dkv": (2 * act_q + 4 * act_kv + 2 * row, 8 * pairs * d),
        "flash_bwd_dq": (3 * act_q + 2 * act_kv + 2 * row, 6 * pairs * d),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
        out[name] = {"bound_ms": max(tb, tf),
                     "bound_by": "bytes" if tb >= tf else "operations",
                     "bytes": nbytes, "flops": flops}
    return out


def rel_err(x, ref) -> float:
    return float((x.detach().float() - ref).abs().max() / ref.abs().max())


def abs_err(x, ref) -> float:
    return float((x.detach().float() - ref).abs().max())


# -- phases -----------------------------------------------------------------


def phase_env() -> str:
    import torch

    from kubeflow_tpu_torch.ops import _build

    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    line = card_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc[-1] if nvcc else None, card=line,
         device=torch.cuda.get_device_name(0))
    return line


def phase_build() -> None:
    from kubeflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit("build", seconds=seconds, built=sorted(logs), ptxas=ptxas)


def _inputs(b, s, h, kv, d, gen):
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    return rnd(b, s, h, d), rnd(b, s, kv, d), rnd(b, s, kv, d), rnd(b, s, h, d)


def check_kernels_case(b, s, h, kv, d, causal, gen) -> dict[str, float]:
    """Each kernel against its plain version on the same bf16 inputs."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(b, s, h, kv, d, gen)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal=causal)
    delta = (do.float() * o_p).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, causal=causal)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                        causal=causal)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, causal=causal)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, causal=causal)
    return {
        "o_rel": rel_err(o, o_p), "lse_abs": abs_err(lse, lse_p),
        "dq_rel": rel_err(dq, dq_p), "dk_rel": rel_err(dk, dk_p),
        "dv_rel": rel_err(dv, dv_p),
        "o_abs": abs_err(o, o_p), "dq_abs": abs_err(dq, dq_p),
        "dk_abs": abs_err(dk, dk_p), "dv_abs": abs_err(dv, dv_p),
    }


def check_autograd_case(b, s, h, kv, d, gen) -> dict[str, float]:
    """flash_attention (forward + backward through the autograd function) at
    a ragged length against the plain formulas."""
    import torch

    from kubeflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(b, s, h, kv, d, gen)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(q, k, v, q_per_kv=h // kv)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    with torch.no_grad():
        o_p, lse_p = fa.flash_fwd_plain(q, k, v)
        delta = (do.float() * o_p).sum(-1).transpose(1, 2)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta)
        dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta)
    return {"o_rel": rel_err(out, o_p), "dq_rel": rel_err(dq, dq_p),
            "dk_rel": rel_err(dk, dk_p), "dv_rel": rel_err(dv, dv_p)}


def phase_kernels_check() -> dict[str, float]:
    """Returns the max abs error of each kernel at the bench shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("bench_causal", dict(BENCH), True),
        ("bench_noncausal", dict(BENCH), False),
        ("gqa_causal", dict(b=4, s=1024, h=8, kv=2, d=128), True),
        ("gqa_noncausal", dict(b=4, s=1024, h=8, kv=2, d=128), False),
        ("gqa_d64_ragged", dict(b=2, s=333, h=4, kv=2, d=64), True),
    ]
    results, bench_abs = {}, {}
    for name, shape, causal in cases:
        r = check_kernels_case(**shape, causal=causal, gen=gen)
        results[name] = r
        require(max(r["o_rel"], r["dq_rel"], r["dk_rel"], r["dv_rel"])
                <= REL_TOL and r["lse_abs"] <= LSE_ATOL,
                f"kernel disagrees with its plain version on {name}: {r}")
        if name == "bench_causal":
            bench_abs = {"flash_fwd": r["o_abs"], "flash_bwd_dq": r["dq_abs"],
                         "flash_bwd_dkv": max(r["dk_abs"], r["dv_abs"])}
    for name, shape in (("ragged_1023", dict(BENCH, s=1023)),
                        ("ragged_1023_gqa",
                         dict(b=4, s=1023, h=8, kv=2, d=128))):
        r = check_autograd_case(**shape, gen=gen)
        results[name] = r
        require(max(r.values()) <= REL_TOL,
                f"flash_attention disagrees with the plain formulas on "
                f"{name}: {r}")
    emit("kernels_check", rel_tol=REL_TOL, lse_atol=LSE_ATOL, cases=results)
    return bench_abs


def phase_kernels_time() -> dict[str, dict]:
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q, k, v, do = _inputs(**BENCH, gen=gen)
    o, lse = fa.flash_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    runs = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v),
                      lambda: fa.flash_fwd_plain(q, k, v)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
                          lambda: fa.flash_bwd_dkv_plain(
                              q, k, v, do, lse, delta)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
                         lambda: fa.flash_bwd_dq_plain(
                             q, k, v, do, lse, delta)),
    }
    bnd = bounds(**BENCH)
    out, detail = {}, {}
    for name, (kernel, plain) in runs.items():
        ms = time_ms(kernel, 30)
        out[name] = {"ms": ms, "plain_ms": time_ms(plain, 5),
                     "bound_ms": bnd[name]["bound_ms"],
                     "bound_by": bnd[name]["bound_by"], "library_ms": None}
        detail[name] = {"bytes": bnd[name]["bytes"],
                        "flops": bnd[name]["flops"],
                        "tflops": bnd[name]["flops"] / ms / 1e9,
                        "bound_share": bnd[name]["bound_ms"] / ms}
    # yardstick only: PyTorch's fused attention on the same inputs (the
    # port never calls it); it computes K1's function in one call
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        30)
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(y, (qg, kg, vg), dot)

    emit("kernels_time", shape=BENCH, kernels=out, work=detail,
         sdpa_fwd_bwd_ms=time_ms(sdpa_fwd_bwd, 30),
         kernels_fwd_bwd_ms=sum(r["ms"] for r in out.values()))
    return out


def phase_slice() -> dict[str, int]:
    import torch

    from kubeflow_tpu_torch.models.llama import (
        bench_model,
        flops_per_token,
        num_params,
    )
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    warmup, timed = 3, 10
    cfg = TrainConfig(model=bench_model(), global_batch=14, seq_len=1024,
                      steps=warmup + timed, warmup_steps=2, log_every=1)
    trainer = Trainer(cfg)
    trainer.init_state(SEED)
    metrics = []
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.train(on_metrics=metrics.append)
    launches = dict(fa.LAUNCHES)
    losses = [m.loss for m in metrics]
    require(len(losses) == cfg.steps and all(map(math.isfinite, losses)),
            f"bench train losses not finite: {losses}")
    step_s = sum(m.step_time_s for m in metrics[warmup:])
    tps = timed * cfg.global_batch * cfg.seq_len / step_s
    layers, steps = cfg.model.num_layers, cfg.steps
    # remat "dots" keeps matmul outputs only, so the flash forward runs again
    # in the backward pass: K1 twice per layer per step, K2 and K3 once
    expect = {"flash_fwd": 2 * layers * steps, "flash_bwd_dkv": layers * steps,
              "flash_bwd_dq": layers * steps}
    require(launches == expect,
            f"kernel launches {launches} != expected {expect}")
    emit("slice", model="bench_model", params=num_params(cfg.model),
         global_batch=cfg.global_batch, seq_len=cfg.seq_len, steps=steps,
         timed_steps=timed, losses=losses,
         step_ms=[m.step_time_s * 1e3 for m in metrics],
         tokens_per_sec=tps,
         mfu=tps * flops_per_token(cfg.model, cfg.seq_len) / PEAK_FLOPS,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         launches=launches, launches_per_step={
             k: n // steps for k, n in launches.items()})
    return launches


def phase_parity_on_card() -> None:
    import torch

    from kubeflow_tpu_torch.models.llama import tiny
    from kubeflow_tpu_torch.train.data import SyntheticLm
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(
        model=tiny(head_dim=64, attention_impl="flash", dtype=torch.bfloat16),
        global_batch=4, seq_len=128, steps=1)
    gpu, cpu = Trainer(cfg), Trainer(cfg, device="cpu")
    gpu.init_state(SEED)
    cpu.model.load_state_dict(gpu.model.state_dict())
    tokens = SyntheticLm(cfg.global_batch, cfg.seq_len,
                         cfg.model.vocab_size).local_batch(0)["tokens"]
    loss_g = float(gpu.loss_and_grads(tokens))
    loss_c = float(cpu.loss_and_grads(tokens))
    grads_c = dict(cpu.model.named_parameters())
    worst = max(
        (rel_err(p.grad.cpu(), grads_c[n].grad.float()), n)
        for n, p in gpu.model.named_parameters())
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    emit("parity_on_card", loss_card=loss_g, loss_cpu=loss_c,
         loss_rel=loss_rel, worst_grad_rel=worst[0], worst_grad=worst[1])
    require(loss_rel <= 1e-2, f"loss card {loss_g} vs cpu {loss_c}")
    require(worst[0] <= 5e-2, f"grad {worst[1]} differs by {worst[0]}")


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    # outside a checkout of the repo this fails before anything is printed
    import kubeflow_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = phase_env()
    phase_build()
    max_abs = phase_kernels_check()
    times = phase_kernels_time()
    launches = phase_slice()
    phase_parity_on_card()
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max_abs[name], **times[name]})
    print(json.dumps({"kernels": kernels}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
