#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kubeflow_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels (flash attention K1-K3, grouped GEMM
K4a/K4b) from ``kubeflow_tpu_torch/ops/csrc`` into ``build/kernels/``,
checks in their SASS that every kernel runs on wgmma and TMA and that no
kernel spills, holds each kernel against its plain f32 version (outputs in
NaN-poisoned memory, each kernel launched twice for bitwise equality),
times them, runs one MoE
layer's forward and backward with host syncs forbidden and holds it against
the same layer on the CPU, trains the 271M bench Llama and the 1.24B MoE
bench Llama (8 experts, top-2, dropless) for 13 steps each at batch 14 x seq
1024 through the port's ``Trainer``, checks that each run really launched
its kernels, and compares one small bf16 step (dense, then
MoE, its routing pinned to the card's) on the card with the same step on the
CPU. Then one full bench-model ``Trainer.step`` runs with host syncs made
errors, and the serving engine (``kubeflow_tpu_torch.serving``, every program
a CUDA graph) serves the bench model as ``bench.py``'s serving row does
(``serve``), in its three pool and admission variants (``serve_variants``),
and serves the MoE bench model (``moe_serve``, on ``gmm``, which is also
checked and timed at the serving shapes); then speculation and prefix reuse
(``spec_serve``, ``moe_spec_serve``, ``prefix_serve``) and moving and
storing sequences (``migrate_serve``, ``moe_migrate_serve``,
``hibernate_serve``, ``host_tier_serve``, ``disagg_serve``), and the
serving plane over HTTP (``http_serve``: ``ModelServer`` and
``TextGenerator`` over the bench model, every greedy completion held to the
engine's own text, SSE streams timed, a QoS preemption, then the MoE bench
model behind the same server launching ``gmm``). Last, the
fine-tune job on llama_1b (1.19B, full width and depth): ``finetune`` writes
a base snapshot and runs the pod entry ``train_main`` twice (a rank-8 LoRA,
8 x 2048, checkpointed, resumed at step 4, the adapter published),
``adafactor_step`` trains every parameter with Adafactor and gradient
accumulation (host syncs made errors; the first step held against the CPU),
and ``finetune_serve`` serves the merged fine-tune with int8 weights and KV
against the same model unquantized. Each phase
prints one JSON
line; the line before the last is the card's name and power limit from
nvidia-smi, the last line is ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero before that line. Needs a CUDA card; imports
nothing of jax or kubeflow_tpu.
"""

from __future__ import annotations

import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

#: H100 SXM published peaks (NVIDIA data sheet): dense bf16 and HBM rate
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
#: kernel vs plain f32 version: max |kernel - plain| / max |plain|
REL_TOL = 1e-2
LSE_ATOL = 1e-3
#: the bench shape: b=14 x seq 1024, h=kv=8, head_dim 128
BENCH = dict(b=14, s=1024, h=8, kv=8, d=128)
#: the fine-tune path's attention: llama_1b at 8 x 2048, h = kv = 16
LLAMA_1B_ATTN = dict(b=8, s=2048, h=16, kv=16, d=128)
#: the MoE bench's expert products: 14 x 1023 tokens x top-2 rows, hidden
#: 1024, intermediate 2816, 8 experts
GMM_BENCH = dict(b=14 * 1023 * 2, k=1024, n=2816, e=8)
SEED = 0
TPU_SOURCE = "kubeflow_tpu/ops/flash_attention.py"
GMM_SOURCE = "kubeflow_tpu/ops/grouped_matmul.py"
KERNEL_INFO = {
    "flash_fwd": ("kubeflow_tpu_torch/ops/csrc/flash_fwd.cu",
                  f"{TPU_SOURCE}:72 (_fwd_kernel)"),
    "flash_bwd_dkv": ("kubeflow_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      f"{TPU_SOURCE}:168 (_bwd_dkv_kernel)"),
    "flash_bwd_dq": ("kubeflow_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     f"{TPU_SOURCE}:216 (_bwd_dq_kernel)"),
    "gmm": ("kubeflow_tpu_torch/ops/csrc/gmm.cu",
            f"{GMM_SOURCE}:89 (_gmm: MegaBlox gmm)"),
    "tgmm": ("kubeflow_tpu_torch/ops/csrc/tgmm.cu",
             f"{GMM_SOURCE}:127 (_vjp_bwd: MegaBlox tgmm)"),
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


def graph_time_ms(fn, calls: int = 50, reps: int = 20) -> float:
    """Median device time of one call, from ``calls`` calls captured in one
    CUDA graph and replayed ``reps`` times between CUDA events: a call
    whose kernel is shorter than its host launch cost is timed without
    that cost (the graph launches the kernels back to back)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / calls


def roofline(nbytes: int, flops: int) -> dict:
    """The least time the card could take for this work: the larger of the
    bytes over the HBM rate and the FLOPs over the bf16 peak."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations",
            "bytes": nbytes, "flops": flops}


def bounds(b, s, h, kv, d, causal=True) -> dict[str, dict]:
    """Each flash kernel's work on this shape (bytes: each input read once,
    each output written once; FLOPs: the tile products over the unmasked
    pairs) and its roofline."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    act_q, act_kv, row = b * s * h * d * 2, b * s * kv * d * 2, b * h * s * 4
    return {
        "flash_fwd": roofline(2 * act_q + 2 * act_kv + row, 4 * pairs * d),
        "flash_bwd_dkv": roofline(2 * act_q + 4 * act_kv + 2 * row,
                                  8 * pairs * d),
        "flash_bwd_dq": roofline(3 * act_q + 2 * act_kv + 2 * row,
                                 6 * pairs * d),
    }


def grouped_roofline(b, k, n, e, rows) -> dict:
    """gmm's or tgmm's work: x [b,k], the [b,n] operand or result and the
    [e,k,n] weights or gradient each once, plus the offsets; 2*k*n FLOPs for
    each of the ``rows`` rows that lie in a group."""
    return roofline(2 * (b * k + b * n + e * k * n) + 4 * (e + 1),
                    2 * rows * k * n)


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


#: kernels whose SASS must hold wgmma (HGMMA) fed by TMA loads (UTMALDG)
HOPPER_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "gmm", "tgmm")
HOPPER_OPS = ("HGMMA", "UTMALDG")


def _cuobjdump(*args: str) -> str:
    from pathlib import Path

    from kubeflow_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), *args], check=True, capture_output=True,
                          text=True).stdout


def phase_build() -> None:
    """Builds every kernel library, then reads what was compiled: the SASS
    of every library in ``HOPPER_KERNELS`` must hold wgmma and TMA loads, and
    no kernel may spill (ptxas's report for what was built now, the
    registers and local memory of every library from cuobjdump, cached ones
    too)."""
    from kubeflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "wgmma" in ln
                    or "setmaxnreg" in ln]
             for name, log in logs.items()}
    spills = [f"{name}: {ln}" for name, lines in ptxas.items() for ln in lines
              if any(int(v) for v in re.findall(r"(\d+) bytes spill", ln))]
    resources, sass = {}, {}
    for name in _build.KERNELS:
        lib = str(_build.library_path(name))
        resources[name] = [ln.strip() for ln in _cuobjdump(
            "-res-usage", lib).splitlines() if "REG:" in ln]
        spills += [f"{name}: {ln}" for ln in resources[name]
                   if re.search(r"LOCAL:(\d+)", ln).group(1) != "0"]
        if name in HOPPER_KERNELS:
            text = _cuobjdump("-sass", lib)
            sass[name] = {op: text.count(op) for op in HOPPER_OPS}
    emit("build", seconds=seconds, built=sorted(logs), ptxas=ptxas,
         resources=resources, sass=sass)
    require(not spills, f"kernels spill registers: {spills}")
    for name, counts in sass.items():
        require(all(counts.values()),
                f"{name} does not use Hopper's paths in its SASS: {counts}")


def _inputs(b, s, h, kv, d, gen):
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    return rnd(b, s, h, d), rnd(b, s, kv, d), rnd(b, s, kv, d), rnd(b, s, h, d)


def _poison(*shapes) -> None:
    """Fill fresh blocks of these (shape, dtype) sizes with NaN and free
    them: the caching allocator hands that memory to the next outputs of
    those sizes, so an element a kernel failed to write reads back as NaN."""
    import torch

    blocks = [torch.full(shape, float("nan"), dtype=dtype, device="cuda")
              for shape, dtype in shapes]
    del blocks


def check_kernels_case(b, s, h, kv, d, causal, gen) -> dict[str, float]:
    """Each kernel against its plain version on the same bf16 inputs, its
    outputs written into NaN-poisoned memory; then each kernel again on the
    same inputs, which must give the same bits (one owner per output
    element, no atomics)."""
    import torch

    from kubeflow_tpu_torch.ops import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    q, k, v, do = _inputs(b, s, h, kv, d, gen)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal=causal)
    delta = (do.float() * o_p).sum(-1).transpose(1, 2).contiguous()

    def launch_all():
        _poison((q.shape, bf16), ((b, h, s), f32))
        o, lse = fa.flash_fwd(q, k, v, causal=causal)
        _poison((k.shape, bf16), (k.shape, bf16))
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, causal=causal)
        _poison((q.shape, bf16))
        dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, causal=causal)
        return o, lse, dk, dv, dq

    outs = launch_all()
    o, lse, dk, dv, dq = outs
    repeat = all(map(torch.equal, outs, launch_all()))
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                        causal=causal)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, causal=causal)
    return {
        "o_rel": rel_err(o, o_p), "lse_abs": abs_err(lse, lse_p),
        "dq_rel": rel_err(dq, dq_p), "dk_rel": rel_err(dk, dk_p),
        "dv_rel": rel_err(dv, dv_p),
        "o_abs": abs_err(o, o_p), "dq_abs": abs_err(dq, dq_p),
        "dk_abs": abs_err(dk, dk_p), "dv_abs": abs_err(dv, dv_p),
        "finite": all(bool(x.isfinite().all()) for x in outs),
        "repeat_bitwise_equal": repeat,
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


def _split(rows: int, parts: int) -> list[int]:
    """``rows`` over ``parts`` groups, as evenly as whole rows allow."""
    return [rows // parts + (i < rows % parts) for i in range(parts)]


def heavy_last(b: int, e: int) -> list[int]:
    """The last of ``e`` experts takes half the rows."""
    return _split(b - b // 2, e - 1) + [b // 2]


#: a decode step's 16 expert rows over 8 experts, two of them empty
SERVE_DECODE_SIZES = [3, 0, 5, 1, 0, 2, 4, 1]


def skewed_split(b: int, e: int) -> list[int]:
    """``b`` rows over ``e`` experts in the proportions 1 : 2 : ... : e
    with the first expert empty, as a prefill's routing might fall."""
    w = list(range(e))
    sizes = [b * i // sum(w) for i in w]
    sizes[-1] += b - sum(sizes)
    return sizes


def one_expert(b: int, e: int, which: int = 3) -> list[int]:
    """Expert ``which`` takes every row; the other groups are empty."""
    return [b if i == which else 0 for i in range(e)]


def grouped_cases() -> dict[str, tuple]:
    """(b, k, n, group sizes, trans_w) of each gmm/tgmm check case."""
    b, k, n, e = (GMM_BENCH[key] for key in "bkne")
    live = _split(b, 5)
    tail = _split(b - 4144, e - 1)
    return {
        "bench_balanced": (b, k, n, _split(b, e), False),
        "bench_skewed": (b, k, n, [b // 2] + _split(b - b // 2, e - 1),
                         False),
        # leading, middle and trailing empty groups
        "bench_empty_groups": (b, k, n, [0, *live[:2], 0, *live[2:], 0],
                               False),
        # offsets[-1] < b: 4144 rows of no group, and an empty group
        "bench_tail_rows": (b, k, n, [*tail[:2], 0, *tail[2:]], False),
        # the dx product: [b, 2816] @ w[e]^T with w [8, 1024, 2816]
        "bench_trans_w": (b, n, k, _split(b, e), True),
        "small_odd": (333, 64, 96, [100, 0, 150, 50], False),
        "bench_heavy_last": (b, k, n, heavy_last(b, e), False),
        # seven empty groups around the one that takes every row
        "bench_one_expert": (b, k, n, one_expert(b, e), False),
        "bench_e1": (b, k, n, [b], False),
        "fewer_rows_than_a_tile": (100, 64, 96, [30, 0, 70], False),
        # K = 40: the 64-deep slices read past K (TMA fills zeros)
        "k40": (333, 40, 96, [100, 0, 150, 83], False),
        # trans_w with N = 104 (not a multiple of 64) and K = 40
        "trans_w_odd": (333, 40, 104, [0, 120, 1, 200], True),
        # 200 groups of 0 to 6 rows: the schedules' searches and sort
        "many_groups": (700, 64, 96, [i % 7 for i in range(200)], False),
        # the serving shapes of the MoE bench model: a decode step's 16
        # rows (8 slots x top-2) over 8 experts, most groups 0-3 rows, and
        # a prefill's 256 and 2,048 rows
        "serve_decode_16": (16, k, n, SERVE_DECODE_SIZES, False),
        "serve_decode_16_down": (16, n, k, SERVE_DECODE_SIZES, False),
        "serve_prefill_256": (256, k, n, skewed_split(256, e), False),
        "serve_prefill_2048": (2048, k, n, skewed_split(2048, e), False),
    }


def _offsets(sizes):
    import torch

    return torch.tensor([0, *itertools.accumulate(sizes)],
                        dtype=torch.int32, device="cuda")


def check_grouped_case(b, k, n, sizes, trans_w, gen) -> dict:
    """gmm and tgmm against their plain versions on bf16 inputs; rows of no
    group and empty groups' blocks must come back exactly 0, and a second
    launch on the same inputs bitwise equal to the first (the kernels'
    schedules use no atomics). x's and g's rows of no group hold NaN: the
    tiles and slices that read them past a group's end must not carry them
    into the group's results."""
    import torch

    from kubeflow_tpu_torch.ops import grouped_matmul as gm

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    e = len(sizes)
    x, g = rnd(b, k), rnd(b, n)
    w = rnd(e, n, k) if trans_w else rnd(e, k, n)
    offs = _offsets(sizes)
    end = sum(sizes)
    x[end:], g[end:] = float("nan"), float("nan")
    # poison the memory the outputs will reuse: a row or block the kernels
    # failed to write would not read back as 0
    torch.full((b, n), float("nan"), dtype=torch.bfloat16, device="cuda")
    out = gm.gmm(x, w, offs, trans_w=trans_w)
    torch.full((e, k, n), float("nan"), dtype=torch.bfloat16, device="cuda")
    dw = gm.tgmm(x, g, offs)
    out_p = gm.gmm_plain(x, w, offs, trans_w=trans_w)
    dw_p = gm.tgmm_plain(x, g, offs)
    repeat = (torch.equal(out, gm.gmm(x, w, offs, trans_w=trans_w))
              and torch.equal(dw, gm.tgmm(x, g, offs)))
    return {
        "gmm_rel": rel_err(out, out_p), "tgmm_rel": rel_err(dw, dw_p),
        "gmm_abs": abs_err(out, out_p), "tgmm_abs": abs_err(dw, dw_p),
        "tail_rows": b - end,
        "tail_rows_zero": bool((out[end:] == 0).all()),
        "empty_groups": sizes.count(0),
        "empty_blocks_zero": all(bool((dw[i] == 0).all())
                                 for i, size in enumerate(sizes) if size == 0),
        "repeat_bitwise_equal": repeat,
    }


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
        # 128-row tiles: a half tile at the end, fewer rows than one tile
        ("half_tile_960", dict(b=2, s=960, h=8, kv=8, d=128), True),
        ("short_100", dict(b=3, s=100, h=4, kv=2, d=128), True),
        ("gqa4_d64_noncausal", dict(b=2, s=1024, h=8, kv=2, d=64), False),
        # a one-row last query tile (its second warpgroup has no real row)
        # and a one-key ragged key tile
        ("one_row_tile_129", dict(b=2, s=129, h=8, kv=2, d=128), True),
        # the ragged key mask without the causal mask beside it
        ("ragged_333_noncausal", dict(b=2, s=333, h=8, kv=2, d=64), False),
        # the fine-tune path's shape (llama_1b: s 2048, 16 heads, d 128)
        ("llama_1b_causal", dict(LLAMA_1B_ATTN, b=2), True),
    ]
    results, bench_abs = {}, {}
    for name, shape, causal in cases:
        r = check_kernels_case(**shape, causal=causal, gen=gen)
        results[name] = r
        require(max(r["o_rel"], r["dq_rel"], r["dk_rel"], r["dv_rel"])
                <= REL_TOL and r["lse_abs"] <= LSE_ATOL and r["finite"]
                and r["repeat_bitwise_equal"],
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
    for name, (b, k, n, sizes, trans_w) in grouped_cases().items():
        r = check_grouped_case(b, k, n, sizes, trans_w, gen)
        results[name] = {"shape": [b, k, n], "sizes": sizes,
                         "trans_w": trans_w, **r}
        require(max(r["gmm_rel"], r["tgmm_rel"]) <= REL_TOL
                and r["tail_rows_zero"] and r["empty_blocks_zero"]
                and r["repeat_bitwise_equal"],
                f"gmm/tgmm disagree with their plain versions on {name}: "
                f"{r}")
        if name == "bench_balanced":
            bench_abs.update(gmm=r["gmm_abs"], tgmm=r["tgmm_abs"])
    emit("kernels_check", rel_tol=REL_TOL, lse_atol=LSE_ATOL, cases=results)
    return bench_abs


def phase_kernels_time() -> dict[str, dict]:
    """K1-K3 at the bench shape (the returned readings, the ``kernels``
    line's) and at the fine-tune path's llama_1b shape."""
    out = _kernels_time("kernels_time", BENCH, plain_reps=5)
    _kernels_time("kernels_time_llama_1b", LLAMA_1B_ATTN, plain_reps=2)
    return out


def _kernels_time(phase: str, shape: dict, plain_reps: int
                  ) -> dict[str, dict]:
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q, k, v, do = _inputs(**shape, gen=gen)
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
    bnd = bounds(**shape)
    out, detail = {}, {}
    for name, (kernel, plain) in runs.items():
        ms = time_ms(kernel, 30)
        out[name] = {"ms": ms, "plain_ms": time_ms(plain, plain_reps),
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

    fwd_bwd_ms = time_ms(sdpa_fwd_bwd, 30)
    # no single call computes dK/dV (K2) or dQ (K3) alone: SDPA's backward,
    # its forward and backward less its forward, is the yardstick of the two
    emit(phase, shape=shape, kernels=out, work=detail,
         sdpa_fwd_bwd_ms=fwd_bwd_ms,
         kernels_fwd_bwd_ms=sum(r["ms"] for r in out.values()),
         sdpa_bwd_ms=fwd_bwd_ms - out["flash_fwd"]["library_ms"],
         kernels_bwd_ms=out["flash_bwd_dkv"]["ms"] + out["flash_bwd_dq"]["ms"])
    return out


def phase_grouped_time() -> dict[str, dict]:
    """gmm and tgmm at the MoE bench shapes, balanced routing. The kernels
    line's rows are the gate/up products; every shape a step runs is timed
    too, with its launches per layer, for the step's K4 total; the gate/up
    products once more under three skews (the first expert takes half the
    rows, the last takes half, one takes them all); and the host's time per
    call."""
    import torch

    from kubeflow_tpu_torch.ops import grouped_matmul as gm

    b, k, n, e = (GMM_BENCH[key] for key in "bkne")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    xh, xm = rnd(b, k), rnd(b, n)            # [b, 1024] and [b, 2816] rows
    w_in, w_out = rnd(e, k, n), rnd(e, n, k)  # gate/up and down weights
    offs = _offsets(_split(b, e))
    skewed = _offsets([b // 2] + _split(b - b // 2, e - 1))
    last = _offsets(heavy_last(b, e))
    single = _offsets(one_expert(b, e))
    # name: (kernel call, plain call, launches per layer per step, shape)
    runs = {
        "gmm": (lambda: gm.gmm(xh, w_in, offs),
                lambda: gm.gmm_plain(xh, w_in, offs), 4, (k, n)),
        "gmm_down": (lambda: gm.gmm(xm, w_out, offs),
                     lambda: gm.gmm_plain(xm, w_out, offs), 2, (n, k)),
        "gmm_dx_gate_up": (lambda: gm.gmm(xm, w_in, offs, trans_w=True),
                           None, 2, (n, k)),
        "gmm_dx_down": (lambda: gm.gmm(xh, w_out, offs, trans_w=True),
                        None, 1, (k, n)),
        "tgmm": (lambda: gm.tgmm(xh, xm, offs),
                 lambda: gm.tgmm_plain(xh, xm, offs), 2, (k, n)),
        "tgmm_down": (lambda: gm.tgmm(xm, xh, offs), None, 1, (n, k)),
        "gmm_skewed": (lambda: gm.gmm(xh, w_in, skewed), None, 0, (k, n)),
        "tgmm_skewed": (lambda: gm.tgmm(xh, xm, skewed), None, 0, (k, n)),
        "gmm_heavy_last": (lambda: gm.gmm(xh, w_in, last), None, 0, (k, n)),
        "tgmm_heavy_last": (lambda: gm.tgmm(xh, xm, last), None, 0, (k, n)),
        "gmm_one_expert": (lambda: gm.gmm(xh, w_in, single), None, 0,
                           (k, n)),
        "tgmm_one_expert": (lambda: gm.tgmm(xh, xm, single), None, 0,
                            (k, n)),
    }
    shapes, per_layer_ms = {}, 0.0
    for name, (kernel, plain, per_layer, (kk, nn)) in runs.items():
        ms = time_ms(kernel, 20)
        bnd = grouped_roofline(b, kk, nn, e, b)
        shapes[name] = {"k": kk, "n": nn, "ms": ms, **bnd,
                        "tflops": bnd["flops"] / ms / 1e9,
                        "bound_share": bnd["bound_ms"] / ms,
                        "launches_per_layer": per_layer}
        if plain is not None:
            shapes[name]["plain_ms"] = time_ms(plain, 3)
        per_layer_ms += per_layer * ms
    # yardstick only (the port never calls it): PyTorch's grouped GEMM on
    # the same inputs, 2d x 3d for gmm and 2d x 2d over the rows for tgmm
    ends = offs[1:].contiguous()
    library = {
        "gmm": (lambda: torch._grouped_mm(xh, w_in, offs=ends),
                lambda: gm.gmm_plain(xh, w_in, offs)),
        "tgmm": (lambda: torch._grouped_mm(xh.t(), xm, offs=ends),
                 lambda: gm.tgmm_plain(xh, xm, offs)),
    }
    lib_ms, lib_note = {}, {}
    for name, (call, plain) in library.items():
        try:
            err = rel_err(call(), plain())
        except (AttributeError, RuntimeError, TypeError) as exc:
            lib_ms[name], lib_note[name] = None, f"{type(exc).__name__}: {exc}"
            continue
        if err > REL_TOL:
            lib_ms[name], lib_note[name] = None, f"disagrees: rel err {err}"
            continue
        lib_ms[name] = time_ms(call, 20)
        lib_note[name] = f"torch._grouped_mm, rel err {err}"
    out = {name: {"ms": shapes[name]["ms"],
                  "plain_ms": shapes[name]["plain_ms"],
                  "bound_ms": shapes[name]["bound_ms"],
                  "bound_by": shapes[name]["bound_by"],
                  "library_ms": lib_ms[name]} for name in ("gmm", "tgmm")}
    emit("grouped_time", shape=GMM_BENCH, kernels=out, shapes=shapes,
         library=lib_note, k4_ms_per_layer_step=per_layer_ms,
         host_us_per_call=grouped_host_us(xh, w_in, xm, offs))
    return out


#: a speculative verify step's expert rows: 8 slots x (spec_k + 1 = 5)
#: tokens x top-2, every expert live
SERVE_VERIFY_SIZES = _split(8 * 5 * 2, 8)


def _serve_gmm_reading(sizes, gen) -> dict:
    """gmm at a serving shape (``sizes`` rows over 8 experts; the gate/up
    product, K 1024 -> N 2816): against its plain version and
    ``torch._grouped_mm`` on the same inputs. The kernel is shorter than
    its host launch, so ``ms`` and ``library_ms`` come from launches
    captured in a CUDA graph, as the serving engine runs them
    (``eager_ms``: one launch between events, the host's launch included).
    Its bound counts what this routing needs: x, the output and the
    weights of the experts that have rows."""
    import torch

    from kubeflow_tpu_torch.ops import grouped_matmul as gm

    b, k, n, e = sum(sizes), GMM_BENCH["k"], GMM_BENCH["n"], len(sizes)
    x = torch.randn(b, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(e, k, n, generator=gen, device="cuda").to(torch.bfloat16)
    offs = _offsets(sizes)
    live = sum(1 for size in sizes if size)
    bnd = roofline(2 * (b * k + b * n + live * k * n) + 4 * (e + 1),
                   2 * b * k * n)
    out = {"ms": graph_time_ms(lambda: gm.gmm(x, w, offs)),
           "plain_ms": time_ms(lambda: gm.gmm_plain(x, w, offs), 20),
           "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
           "library_ms": None}
    ends = offs[1:].contiguous()
    try:
        err = rel_err(torch._grouped_mm(x, w, offs=ends),
                      gm.gmm_plain(x, w, offs))
        note = f"torch._grouped_mm, rel err {err}"
        if err <= REL_TOL:
            out["library_ms"] = graph_time_ms(
                lambda: torch._grouped_mm(x, w, offs=ends))
    except (AttributeError, RuntimeError, TypeError) as exc:
        note = f"{type(exc).__name__}: {exc}"
    return {**out, "rows": b, "k": k, "n": n, "sizes": sizes,
            "eager_ms": time_ms(lambda: gm.gmm(x, w, offs), 200),
            "bytes": bnd["bytes"], "flops": bnd["flops"], "library": note,
            "bound_share": bnd["bound_ms"] / out["ms"]}


def phase_serve_gmm_time() -> dict:
    """gmm at a serving decode step's shape (16 rows over 8 experts, two
    groups empty) and at a speculative verify's (80 rows, 8 slots x 5
    tokens x top-2, every group live), each read by ``_serve_gmm_reading``;
    the verify shape is first checked as ``check_grouped_case`` checks the
    kernels (from NaN-poisoned memory, against the plain version under
    REL_TOL, a repeat bitwise equal). Returns the two readings."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    decode = _serve_gmm_reading(SERVE_DECODE_SIZES, gen)
    k, n = GMM_BENCH["k"], GMM_BENCH["n"]
    check = check_grouped_case(sum(SERVE_VERIFY_SIZES), k, n,
                               SERVE_VERIFY_SIZES, False, gen)
    verify = {**_serve_gmm_reading(SERVE_VERIFY_SIZES, gen), "check": check}
    emit("serve_gmm_time", **decode,
         launches_per_decode_step=3 * bench_moe_layers(), verify=verify)
    require(check["gmm_rel"] <= REL_TOL and check["tgmm_rel"] <= REL_TOL
            and check["repeat_bitwise_equal"],
            f"gmm at the verify shape: {check}")
    return {"decode": decode, "verify": verify}


def bench_moe_layers() -> int:
    from kubeflow_tpu_torch.models.llama import bench_moe_model

    return bench_moe_model().num_layers


def host_us(fn, calls: int = 100) -> float:
    """Host time of one call, in µs, with the card busy: the calls queue
    behind a sleeping kernel, so the clock reads only the host's work (the
    Python wrapper, the tensor maps, the launch). Fails if the card caught up
    with the host before the last call."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about a tenth of a second at H100 clocks
    asleep = torch.cuda.Event()
    asleep.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    require(not asleep.query(), "the card caught up with the host calls")
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def grouped_host_us(x, w, g, offs, rounds: int = 5) -> dict[str, list]:
    """``host_us`` of gmm (x @ w) and tgmm (x^T g), ``rounds`` readings each,
    alternated."""
    from kubeflow_tpu_torch.ops import grouped_matmul as gm

    out = {"gmm": [], "tgmm": []}
    for _ in range(rounds):
        out["gmm"].append(host_us(lambda: gm.gmm(x, w, offs)))
        out["tgmm"].append(host_us(lambda: gm.tgmm(x, g, offs)))
    return out


def _pin_routing(layer, idx) -> None:
    """Make ``layer`` route every token to the experts ``idx`` names, its
    gates taken from its own router probabilities at those experts. Two
    devices' runs of one layer then compare value for value even where a
    near-tie rounds to another expert on one of them."""
    route = type(layer).route

    def pinned(self, x):
        probs = route(self, x)[0]
        gates = probs.gather(-1, idx)
        if self.cfg.moe_normalize_topk:
            gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
        return probs, gates, idx

    layer.route = types.MethodType(pinned, layer)


def phase_moe_no_sync() -> None:
    """One MoE layer forward and backward at the bench shape with host syncs
    made errors: the routing, offsets and kernels must stay on the device.
    The same layer then runs on the CPU (the plain versions) with the same
    weights and inputs and the card's routing: its output, input gradient
    and every weight gradient are held at ``REL_TOL``."""
    import torch

    from kubeflow_tpu_torch.models.llama import bench_moe_model
    from kubeflow_tpu_torch.models.moe import MoeMlp
    from kubeflow_tpu_torch.ops import grouped_matmul as gm

    cfg = bench_moe_model()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    layer = MoeMlp(cfg, device="cuda")
    with torch.no_grad():
        layer.init_weights(gen)
    shape = (14, 1023, cfg.hidden_size)
    x = torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    dy = torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def fwd_bwd(mod, xx, dyy):
        """(y, grads wrt x and each parameter, in named_parameters order)."""
        y, aux = mod(xx)
        params = [p for _, p in mod.named_parameters()]
        return y, torch.autograd.grad(
            (y, aux), [xx, *params], (dyy, torch.ones_like(aux)))

    fwd_bwd(layer, x, dy)  # first use: cuBLAS handles, kernel libraries
    torch.cuda.synchronize()
    before = dict(gm.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, grads = fwd_bwd(layer, x, dy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = {key: gm.LAUNCHES[key] - before[key] for key in before}
    require(launches == {"gmm": 6, "tgmm": 3},
            f"one MoE layer fwd+bwd launched {launches}")

    cpu = MoeMlp(cfg, device="cpu")
    cpu.load_state_dict(layer.state_dict())
    x_c = x.detach().cpu().requires_grad_()
    with torch.no_grad():
        ids = layer.route(x)[2].cpu()
        flipped = int((cpu.route(x_c)[2].sort(-1).values
                       != ids.sort(-1).values).any(-1).sum())
    _pin_routing(cpu, ids)
    t0 = time.perf_counter()
    y_c, grads_c = fwd_bwd(cpu, x_c, dy.cpu())
    cpu_s = time.perf_counter() - t0
    names = ["y", "x"] + [n for n, _ in cpu.named_parameters()]
    errs = {f"{n}_rel": rel_err(a.cpu(), b.float()) for n, a, b in zip(
        names, (y, *grads), (y_c.detach(), *grads_c))}
    emit("moe_no_sync", shape=list(shape), sync_debug_mode="error",
         launches=launches, tokens_routed_differently_on_cpu=flipped,
         cpu_seconds=cpu_s, rel_tol=REL_TOL, card_vs_cpu=errs)
    require(max(errs.values()) <= REL_TOL,
            f"MoE layer on the card vs the CPU: {errs}")


def _counters() -> list[dict]:
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import grouped_matmul as gm

    return [fa.LAUNCHES, gm.LAUNCHES]


def train_slice(phase: str, model_name: str, expect_per_layer: dict
                ) -> dict[str, int]:
    """13 steps of a bench model at 14 x 1024 through ``Trainer.train``;
    every kernel's launches over the run must be ``expect_per_layer`` x
    layers x steps."""
    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    warmup, timed = 3, 10
    cfg = TrainConfig(model=getattr(llama, model_name)(), global_batch=14,
                      seq_len=1024, steps=warmup + timed, warmup_steps=2,
                      log_every=1, aux_loss_coef=0.01)
    trainer = Trainer(cfg)
    trainer.init_state(SEED)
    metrics = []
    for counts in _counters():
        for key in counts:
            counts[key] = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.train(on_metrics=metrics.append)
    launches = {k: v for counts in _counters() for k, v in counts.items()}
    losses = [m.loss for m in metrics]
    require(len(losses) == cfg.steps and all(map(math.isfinite, losses)),
            f"{model_name} train losses not finite: {losses}")
    step_s = sum(m.step_time_s for m in metrics[warmup:])
    tps = timed * cfg.global_batch * cfg.seq_len / step_s
    layers, steps = cfg.model.num_layers, cfg.steps
    expect = {k: expect_per_layer.get(k, 0) * layers * steps
              for k in launches}
    require(launches == expect,
            f"kernel launches {launches} != expected {expect}")
    emit(phase, model=model_name, params=llama.num_params(cfg.model),
         active_params=llama.active_params(cfg.model),
         global_batch=cfg.global_batch, seq_len=cfg.seq_len, steps=steps,
         timed_steps=timed, losses=losses,
         step_ms=[m.step_time_s * 1e3 for m in metrics],
         tokens_per_sec=tps,
         mfu=tps * llama.flops_per_token(cfg.model, cfg.seq_len) / PEAK_FLOPS,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         launches=launches, launches_per_step={
             k: n // steps for k, n in launches.items()})
    return launches


#: remat "dots" keeps matmul outputs only, so the flash forward runs again in
#: the backward pass (K1 twice per layer, K2 and K3 once), and so does every
#: gmm forward: 3 forward + 3 recomputed + 3 dx gmm and 3 tgmm per MoE layer
FLASH_PER_LAYER = {"flash_fwd": 2, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
MOE_PER_LAYER = {**FLASH_PER_LAYER, "gmm": 9, "tgmm": 3}


def parity_on_card(phase: str, **model_kw) -> None:
    """One bf16 step of a small model on the card against the same step on
    the CPU (the kernels' plain versions): the loss within 1e-2 and every
    gradient within 5e-2, relative. For an MoE model each CPU layer is
    pinned to the experts the card chose for its tokens (``_pin_routing``):
    a near-tie that rounds to another expert on one device moves a token's
    output by O(1). The tokens the CPU alone would route differently are
    counted."""
    import torch

    from kubeflow_tpu_torch.models.llama import tiny
    from kubeflow_tpu_torch.models.moe import MoeMlp
    from kubeflow_tpu_torch.train.data import SyntheticLm
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(
        model=tiny(head_dim=64, attention_impl="flash", dtype=torch.bfloat16,
                   **model_kw),
        global_batch=4, seq_len=128, steps=1)
    gpu, cpu = Trainer(cfg), Trainer(cfg, device="cpu")
    gpu.init_state(SEED)
    cpu.model.load_state_dict(gpu.model.state_dict())
    routes = {"card": [], "cpu": []}

    def record(seen):
        # the layer's own routing (unpinned) of this forward's input
        return lambda m, inp, out: seen.append(
            type(m).route(m, inp[0].detach())[2].detach().cpu())

    for side, trainer in (("card", gpu), ("cpu", cpu)):
        for mod in trainer.model.modules():
            if isinstance(mod, MoeMlp):
                mod.register_forward_hook(record(routes[side]))
    tokens = SyntheticLm(cfg.global_batch, cfg.seq_len,
                         cfg.model.vocab_size).local_batch(0)["tokens"]
    loss_g = float(gpu.loss_and_grads(tokens))
    layers = [m for m in cpu.model.modules() if isinstance(m, MoeMlp)]
    for layer, ids in zip(layers, routes["card"]):
        _pin_routing(layer, ids)
    loss_c = float(cpu.loss_and_grads(tokens))
    flipped = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                  for a, b in zip(routes["card"], routes["cpu"]))
    grads_c = dict(cpu.model.named_parameters())
    worst = max(
        (rel_err(p.grad.cpu(), grads_c[n].grad.float()), n)
        for n, p in gpu.model.named_parameters())
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    held = loss_rel <= 1e-2 and worst[0] <= 5e-2
    emit(phase, loss_card=loss_g, loss_cpu=loss_c, loss_rel=loss_rel,
         worst_grad_rel=worst[0], worst_grad=worst[1],
         routed_tokens=sum(r.shape[0] * r.shape[1] for r in routes["card"]),
         tokens_routed_differently=flipped,
         routing_pinned_to_card=bool(layers), grads_held=held)
    require(loss_rel <= 1e-2, f"loss card {loss_g} vs cpu {loss_c}")
    require(worst[0] <= 5e-2, f"grad {worst[1]} differs by {worst[0]}")


def phase_step_no_sync() -> None:
    """One full ``Trainer.step`` of the 271M bench model (forward, backward,
    clipped AdamW) with host syncs made errors; the batch reaches the card
    before the checked region."""
    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.data import SyntheticLm
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=llama.bench_model(), global_batch=14,
                      seq_len=1024, steps=2, warmup_steps=1)
    trainer = Trainer(cfg)
    trainer.init_state(SEED)
    data = SyntheticLm(cfg.global_batch, cfg.seq_len, cfg.model.vocab_size)
    trainer.step(data.local_batch(0)["tokens"])  # first use: handles, libs
    batch = torch.as_tensor(data.local_batch(1)["tokens"], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, norm = trainer.step(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loss, norm = float(loss), float(norm)
    emit("step_no_sync", model="bench_model", sync_debug_mode="error",
         loss=loss, grad_norm=norm)
    require(math.isfinite(loss) and math.isfinite(norm),
            f"step under sync debug: loss {loss}, grad norm {norm}")


#: bench.py's serving row (bench_serving): 8 prompts of 128 tokens, 8
#: slots, chunk 16, pipeline depth 3, 16 primed then 64 timed new tokens
SERVE = dict(prompts=8, prompt_len=128, prime=16, new=64)
SERVE_ENGINE = dict(num_slots=8, decode_chunk=16, pipeline_depth=3,
                    prefix_cache=False)
#: bench.py's roofline: every decoded token streams the f32 weights
#: (batched over the live slots) and its ~256 attended positions of f32 KV
SERVE_ATTENDED = 256
#: the row's timed round lasts about a quarter of a second on the card:
#: repeat it for a spread, report the median
SERVE_ROUNDS = 5


def _serve_model(model_name: str):
    """(cfg, the port's Llama on the card with random weights from SEED)."""
    import torch

    from kubeflow_tpu_torch.models import llama

    cfg = getattr(llama, model_name)()
    model = llama.Llama(cfg, device="cuda")
    model.init_weights(SEED)
    torch.cuda.synchronize()
    return cfg, model


def _prompts(cfg, n: int, length: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(0)
    return rng.integers(1, cfg.vocab_size, size=(n, length)).tolist()


def _serve(cfg, model, prompts, new: int, warmup, prime: int = 0,
           rounds: int = 1, counters: bool = False, ledger=None,
           **engine_kw) -> dict:
    """Serve ``prompts`` through a fresh ContinuousEngine: warmup, an
    optional priming round of ``prime`` tokens a prompt, then ``rounds``
    rounds of ``new`` tokens a prompt, each timed on the host clock (the
    medians are reported, the tokens are the first round's). With
    ``counters`` the kernel launch counts are set to 0 just before the
    first timed round and read just after the last; a ``ledger`` is
    attached to a paged engine before warmup."""
    from kubeflow_tpu_torch.serving.continuous import ContinuousEngine

    eng = ContinuousEngine(cfg, model, **engine_kw)
    if ledger is not None:
        eng.attach_block_ledger(ledger)
    seconds, dispatches, streams = [], [], []
    try:
        t0 = time.perf_counter()
        eng.warmup(warmup)
        warmup_s = time.perf_counter() - t0
        if prime:
            for r in [eng.submit(p, max_new_tokens=prime) for p in prompts]:
                r.wait(600)
        if counters:
            for c in _counters():
                for key in c:
                    c[key] = 0
        for _ in range(rounds):
            steps0 = eng.stats()["decode_steps"]
            t0 = time.perf_counter()
            reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
            streams.append([r.wait(600) for r in reqs])
            seconds.append(time.perf_counter() - t0)
            dispatches.append(eng.stats()["decode_steps"] - steps0)
        launches = {k: v for c in _counters() for k, v in c.items()}
        stats = eng.stats()
    finally:
        eng.stop()
    vocab = cfg.vocab_size
    for tokens in streams:
        require(all(len(t) == new for t in tokens), "short token streams")
        require(all(0 <= x < vocab for t in tokens for x in t),
                "tokens out of the vocabulary")
    tps = [len(prompts) * new / s for s in seconds]
    ms = [s / max(d, 1) * 1e3 for s, d in zip(seconds, dispatches)]
    return {"tokens": streams[0], "seconds": seconds, "warmup_s": warmup_s,
            "tokens_per_sec": statistics.median(tps),
            "tokens_per_sec_rounds": tps, "decode_dispatches": dispatches,
            "ms_per_dispatch": statistics.median(ms),
            "launches": launches, "stats": stats}


def phase_serve() -> None:
    """bench.py's serving row on the port: the 271M bench model at full
    width and depth, random weights, 8 x 128-token prompts, 64 new tokens
    each after a 16-token priming round, every program a CUDA graph."""
    import torch

    from kubeflow_tpu_torch.models import llama

    cfg, model = _serve_model("bench_model")
    torch.cuda.reset_peak_memory_stats()
    r = _serve(cfg, model, _prompts(cfg, SERVE["prompts"],
                                    SERVE["prompt_len"]),
               SERVE["new"], [(8, 128), (1, 128)], prime=SERVE["prime"],
               rounds=SERVE_ROUNDS, **SERVE_ENGINE)
    st = r["stats"]
    wbytes = llama.num_params(cfg) * 4
    kvbytes = (2 * cfg.num_layers * SERVE_ATTENDED * cfg.num_kv_heads
               * cfg.head_dim * 4)
    slots = SERVE_ENGINE["num_slots"]
    roofline_tps = slots / ((wbytes + slots * kvbytes) / PEAK_BYTES)
    emit("serve", model="bench_model", engine=SERVE_ENGINE, **SERVE,
         rounds=SERVE_ROUNDS, tokens_per_sec=r["tokens_per_sec"],
         tokens_per_sec_rounds=r["tokens_per_sec_rounds"],
         seconds=r["seconds"],
         decode_dispatches=r["decode_dispatches"],
         ms_per_dispatch=r["ms_per_dispatch"], warmup_s=r["warmup_s"],
         graph_captures_warmup=st["graph_captures_warmup"],
         graph_captures_after_warmup=st["graph_captures_total"],
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         kv_pool_bytes=st["kv_pool_bytes"],
         kv_pool_bytes_allocated=st["kv_pool_bytes_allocated"],
         roofline_tokens_per_sec=roofline_tps,
         roofline_inputs={"weight_bytes": wbytes, "kv_bytes_per_slot":
                          kvbytes, "bytes_per_sec": PEAK_BYTES},
         vs_roofline=r["tokens_per_sec"] / roofline_tps,
         first_tokens=r["tokens"][0][:8])
    require(st["graph_captures_total"] == 0,
            f"{st['graph_captures_total']} captures after warmup")
    require(st["kv_pool_bytes"] == 536_870_912,
            f"KV pool of {st['kv_pool_bytes']} B")


def _router_margin(model, seq, lo: int, hi: int) -> float:
    """The smallest top-k boundary margin of every MoE layer's router over
    the tokens [lo, hi) of ``seq`` in the model's plain forward: the gap
    of the k-th and (k+1)-th expert probabilities, relative to the k-th.
    A routing decision that close can round to another expert when the
    same tokens run in another GEMM shape."""
    import torch

    from kubeflow_tpu_torch.models.moe import MoeMlp

    margins = []
    layers = [blk.mlp for blk in model.layers if isinstance(blk.mlp, MoeMlp)]
    for layer in layers:
        route = type(layer).route

        def recording(self, x, _route=route):
            out = _route(self, x)
            top = out[0][0, lo:hi].topk(self.cfg.moe_top_k + 1, dim=-1).values
            margins.append(((top[:, -2] - top[:, -1]) / top[:, -2]).min())
            return out

        layer.route = types.MethodType(recording, layer)
    try:
        with torch.no_grad():
            model(seq)
    finally:
        for layer in layers:
            del layer.route
    return float(min(margins))


def _first_difference(cfg, model, prompts, a, b) -> list[dict]:
    """For each prompt whose streams ``a`` and ``b`` differ: the first
    differing position and the top-2 margin of the logits there (the
    model's plain forward over the prompt and ``a``'s tokens before it),
    relative to the top logit; for an MoE model also the smallest router
    margin over the generated tokens fed before it (``_router_margin``):
    the tokens whose forward shapes differ between two serving runs."""
    import torch

    out = []
    for i, (p, ta, tb) in enumerate(zip(prompts, a, b)):
        at = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y),
                  None)
        if at is None:
            continue
        seq = torch.tensor([p + ta[:at]], device="cuda")
        with torch.no_grad():
            logits = model(seq)[0, -1].float()
        top = logits.topk(2).values
        diff = {"prompt": i, "position": at, "tokens": [ta[at], tb[at]],
                "margin_rel": float((top[0] - top[1]) / top[0].abs())}
        if cfg.moe_experts and at > 0:
            diff["router_margin_rel"] = _router_margin(model, seq, len(p),
                                                       len(p) + at)
        out.append(diff)
    return out


def _near_tie(d: dict) -> bool:
    """A first difference two runs' rounding can explain: the logits'
    top-2 margin there, or a router margin before it, below 2e-2."""
    return min(d["margin_rel"], d.get("router_margin_rel", 1.0)) < 2e-2


def phase_serve_variants() -> None:
    """The bench model's 4 prompts x 32 new tokens through the slot pool,
    the slot pool with chunked admission (prefill_budget 64), and the paged
    pool (block_size 16) with the same chunked admission. Paged and slot
    pool run the same shapes: their streams must be equal. Whole-prompt and
    chunked admission run different GEMM shapes, so cuBLAS may round
    differently: each difference must sit where the top-2 margin is below
    2e-2 relative. The paged pool's BlockLedger must count no leak."""
    from kubeflow_tpu_torch.analysis.runtime import BlockLedger

    cfg, model = _serve_model("bench_model")
    prompts = _prompts(cfg, 4, 128)
    kw = SERVE_ENGINE
    runs = {}
    for name, extra in (("slot", {}), ("chunked", {"prefill_budget": 64}),
                        ("paged", {"prefill_budget": 64, "block_size": 16})):
        ledger = BlockLedger()
        r = _serve(cfg, model, prompts, 32, [(4, 128), (1, 128)],
                   ledger=ledger if "block_size" in extra else None,
                   **kw, **extra)
        runs[name] = r
        r["leaked"] = ledger.leaked_total
        r["ledger_errors"] = ledger.conservation_errors
    diffs = _first_difference(cfg, model, prompts, runs["slot"]["tokens"],
                              runs["chunked"]["tokens"])
    paged_equal = runs["paged"]["tokens"] == runs["chunked"]["tokens"]
    emit("serve_variants", prompts=4, new=32, engine=kw,
         tokens_per_sec={k: r["tokens_per_sec"] for k, r in runs.items()},
         captures_after_warmup={k: r["stats"]["graph_captures_total"]
                                for k, r in runs.items()},
         paged_equal_to_slot_pool=paged_equal,
         slot_vs_chunked_differences=diffs,
         blocks_leaked=runs["paged"]["leaked"],
         ledger_errors=runs["paged"]["ledger_errors"],
         kv_blocks_free=runs["paged"]["stats"]["kv_blocks_free"],
         kv_blocks_total=runs["paged"]["stats"]["kv_blocks_total"])
    require(paged_equal, "paged and slot pool streams differ")
    require(all(d["margin_rel"] < 2e-2 for d in diffs),
            f"whole-prompt vs chunked admission differ where the top-2 "
            f"margin is not small: {diffs}")
    require(runs["paged"]["leaked"] == 0
            and not runs["paged"]["ledger_errors"],
            "the paged pool leaked blocks")
    require(all(r["stats"]["graph_captures_total"] == 0
                for r in runs.values()), "captures after warmup")


def phase_moe_serve() -> dict:
    """The MoE bench model (8 experts, top-2, dropless, on K4a ``gmm``)
    serving 4 prompts x 128 tokens, 32 new tokens each, in the slot pool;
    the gmm launches of the timed round are counted."""
    import torch

    cfg, model = _serve_model("bench_moe_model")
    torch.cuda.reset_peak_memory_stats()
    r = _serve(cfg, model, _prompts(cfg, 4, 128), 32, [(4, 128), (1, 128)],
               rounds=3, counters=True, **SERVE_ENGINE)
    st = r["stats"]
    emit("moe_serve", model="bench_moe_model", prompts=4, new=32, rounds=3,
         tokens_per_sec=r["tokens_per_sec"],
         tokens_per_sec_rounds=r["tokens_per_sec_rounds"],
         seconds=r["seconds"],
         decode_dispatches=r["decode_dispatches"],
         ms_per_dispatch=r["ms_per_dispatch"], warmup_s=r["warmup_s"],
         launches=r["launches"],
         graph_captures_warmup=st["graph_captures_warmup"],
         graph_captures_after_warmup=st["graph_captures_total"],
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    require(r["launches"]["gmm"] > 0, "MoE serving launched no gmm")
    require(st["graph_captures_total"] == 0, "captures after warmup")
    return r["launches"]


#: the speculation phases: the slot pool, one token a dispatch when plain
SPEC_ENGINE = dict(num_slots=8, decode_chunk=1, prefix_cache=False)
SPEC_K = 4


def _replay_proposer(prompts, streams):
    """A DraftProposer that drafts ``streams`` (a run's own tokens for
    ``prompts``): for a history of a prompt and the stream's first n
    tokens, the k tokens after the next one, as the alignment contract
    asks. A history that left its stream (a near tie that the verify's
    wider forward rounded the other way) gets no draft: the recorded
    tokens no longer continue it."""
    from kubeflow_tpu_torch.serving.continuous import DraftProposer

    book = {tuple(p): s for p, s in zip(prompts, streams)}
    plen = len(prompts[0])

    class Replay(DraftProposer):
        def propose(self, history, k):
            stream = book.get(tuple(history[:plen]), [])
            n = len(history) - plen
            if stream[:n] != history[plen:]:
                return []
            return stream[n + 1:n + 1 + k]

    return Replay()


def _spec_runs(phase: str, model_name: str, n_prompts: int, new: int,
               counters: bool) -> dict:
    """Four runs of ``n_prompts`` x 128-token prompts, ``new`` tokens
    each, through ``SPEC_ENGINE``: speculation off, ``spec_k=4`` with the
    NgramProposer, and ``spec_k=4`` twice with a replay proposer that
    drafts a run's own tokens. ``replay_first`` drafts the plain run's;
    where a near tie rounds its way apart from them, that slot has no draft
    to the end of the round, so one early tie could leave the round with
    no dispatch saved. ``replay`` drafts ``replay_first``'s tokens,
    computed in the verify's shapes. Every stream of a speculating run must
    equal the plain run's, or first differ where the top-2 margin is below
    2e-2 relative (a [slots, 5] forward runs other GEMM shapes than a
    [slots, 1] one); the replay run must accept more than half of its
    drafts in fewer decode dispatches; no run may capture after warmup."""
    cfg, model = _serve_model(model_name)
    prompts = _prompts(cfg, n_prompts, 128)
    warm = [(n_prompts, 128), (1, 128)]
    runs = {"off": _serve(cfg, model, prompts, new, warm, counters=counters,
                          **SPEC_ENGINE)}
    runs["ngram"] = _serve(cfg, model, prompts, new, warm,
                           counters=counters, spec_k=SPEC_K, **SPEC_ENGINE)
    for name, base in (("replay_first", "off"), ("replay", "replay_first")):
        runs[name] = _serve(
            cfg, model, prompts, new, warm, counters=counters, spec_k=SPEC_K,
            draft_proposer=_replay_proposer(prompts, runs[base]["tokens"]),
            **SPEC_ENGINE)
    keys = ("spec_dispatches_total", "spec_tokens_proposed_total",
            "spec_tokens_accepted_total", "spec_acceptance_rate",
            "graph_captures_total", "graph_captures_warmup")
    diffs = {name: _first_difference(cfg, model, prompts,
                                     runs["off"]["tokens"], r["tokens"])
             for name, r in runs.items() if name != "off"}
    emit(phase, model=model_name, prompts=n_prompts, prompt_len=128,
         new=new, engine=SPEC_ENGINE, spec_k=SPEC_K,
         tokens_per_sec={n: r["tokens_per_sec"] for n, r in runs.items()},
         decode_dispatches={n: r["decode_dispatches"][0]
                            for n, r in runs.items()},
         ms_per_dispatch={n: r["ms_per_dispatch"] for n, r in runs.items()},
         warmup_s={n: r["warmup_s"] for n, r in runs.items()},
         stats={n: {k: r["stats"][k] for k in keys}
                for n, r in runs.items()},
         launches=({n: r["launches"] for n, r in runs.items()}
                   if counters else None),
         differences_from_off=diffs)
    for name, r in runs.items():
        require(r["stats"]["graph_captures_total"] == 0,
                f"{name}: captures after warmup")
    for name, d in diffs.items():
        require(all(map(_near_tie, d)),
                f"{name} differs from plain decode where no margin is "
                f"small: {d}")
    rep = runs["replay"]["stats"]
    require(rep["spec_tokens_accepted_total"]
            > rep["spec_tokens_proposed_total"] / 2,
            f"replay drafts accepted {rep['spec_tokens_accepted_total']} of "
            f"{rep['spec_tokens_proposed_total']}")
    require(runs["replay"]["decode_dispatches"][0]
            < runs["off"]["decode_dispatches"][0],
            "speculation did not save decode dispatches")
    return runs


def phase_spec_serve() -> None:
    """Speculative decoding on the 271M bench model: 8 prompts, 64 new
    tokens each."""
    _spec_runs("spec_serve", "bench_model", 8, 64, counters=False)


def phase_moe_spec_serve() -> None:
    """Speculative decoding on the MoE bench model: 4 prompts, 32 new
    tokens each; every verify runs the experts on gmm at [slots x 5 x
    top-2] rows."""
    runs = _spec_runs("moe_spec_serve", "bench_moe_model", 4, 32,
                      counters=True)
    for name in ("ngram", "replay"):
        require(runs[name]["launches"]["gmm"] > 0,
                f"{name}: the MoE spec run launched no gmm")


#: the prefix phase: 8 prompts of a shared 760-token prefix and a distinct
#: 24-token tail (the suffix stays in the smallest bucket, 32; 760 is not a
#: multiple of the block size, so a paged match forks its last block)
PREFIX = dict(prompts=8, shared=760, tail=24, new=32)
PREFIX_ENGINE = dict(num_slots=8, decode_chunk=4, prefill_budget=0)


def _prefix_prompts(cfg) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    shared = rng.integers(1, cfg.vocab_size, size=PREFIX["shared"]).tolist()
    return [shared + rng.integers(1, cfg.vocab_size,
                                  size=PREFIX["tail"]).tolist()
            for _ in range(PREFIX["prompts"])]


def _serve_prefix(cfg, model, prompts, ledger=None, **engine_kw) -> dict:
    """The first prompt served alone, then the other seven together,
    through a fresh engine; the seven's median TTFT (``Request.ttft_s``)."""
    from kubeflow_tpu_torch.serving.continuous import ContinuousEngine

    eng = ContinuousEngine(cfg, model, **PREFIX_ENGINE, **engine_kw)
    if ledger is not None:
        eng.attach_block_ledger(ledger)
    new = PREFIX["new"]
    try:
        t0 = time.perf_counter()
        eng.warmup([(1, 1023), (8, 1023)])
        warmup_s = time.perf_counter() - t0
        first = eng.submit(prompts[0], max_new_tokens=new)
        tokens = [first.wait(600)]
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts[1:]]
        tokens += [r.wait(600) for r in reqs]
        seconds = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        eng.stop()
    require(all(len(t) == new for t in tokens), "short token streams")
    return {"tokens": tokens, "warmup_s": warmup_s,
            "first_ttft_s": first.ttft_s,
            "ttft_s_median": statistics.median(r.ttft_s for r in reqs),
            "tokens_per_sec": len(reqs) * new / seconds, "stats": stats,
            "leaked": None if ledger is None else ledger.leaked_total,
            "ledger_errors": None if ledger is None
            else ledger.conservation_errors}


def phase_prefix_serve() -> None:
    """Prefix reuse on the 271M bench model: the slot pool with the prefix
    cache off and on, the paged pool (block_size 16, a BlockLedger
    attached) off and on, and shared-prefix segments (2 of 768 tokens).
    With reuse on, seven prompts share what the first one left: 7 hits in
    the slot and paged pools, a COW fork in the paged pool, no block
    leaked, no capture after warmup, and every stream equal to the
    prefix-off stream of the same pool or first apart at a near tie."""
    from kubeflow_tpu_torch.analysis.runtime import BlockLedger

    cfg, model = _serve_model("bench_model")
    prompts = _prefix_prompts(cfg)
    engines = {
        "slot_off": dict(prefix_cache=False),
        "slot_on": dict(prefix_cache=True),
        "paged_off": dict(prefix_cache=False, block_size=16),
        "paged_on": dict(prefix_cache=True, block_size=16),
        "segments": dict(prefix_cache=False, prefix_segments=2,
                         segment_len=768),
    }
    runs = {name: _serve_prefix(cfg, model, prompts,
                                BlockLedger() if "block_size" in kw
                                else None, **kw)
            for name, kw in engines.items()}
    base = {"slot_on": "slot_off", "paged_on": "paged_off",
            "segments": "slot_off", "paged_off": "slot_off"}
    diffs = {name: _first_difference(cfg, model, prompts,
                                     runs[ref]["tokens"],
                                     runs[name]["tokens"])
             for name, ref in base.items()}
    keys = ("prefix_hits", "prefix_tokens_saved", "prefix_block_hits_total",
            "kv_blocks_cow_copies_total", "segment_hits",
            "segment_tokens_shared", "graph_captures_total",
            "graph_captures_warmup")
    emit("prefix_serve", model="bench_model", **PREFIX,
         engine=PREFIX_ENGINE, engines=engines,
         ttft_s_median={n: r["ttft_s_median"] for n, r in runs.items()},
         first_ttft_s={n: r["first_ttft_s"] for n, r in runs.items()},
         tokens_per_sec={n: r["tokens_per_sec"] for n, r in runs.items()},
         warmup_s={n: r["warmup_s"] for n, r in runs.items()},
         stats={n: {k: r["stats"][k] for k in keys}
                for n, r in runs.items()},
         blocks_leaked={n: r["leaked"] for n, r in runs.items()},
         ledger_errors={n: r["ledger_errors"] for n, r in runs.items()},
         differences=diffs)
    for name in ("slot_on", "paged_on"):
        require(runs[name]["stats"]["prefix_hits"] == 7,
                f"{name}: {runs[name]['stats']['prefix_hits']} prefix hits")
    require(runs["paged_on"]["stats"]["kv_blocks_cow_copies_total"] >= 1,
            "the paged pool forked no block")
    for name, r in runs.items():
        require(r["stats"]["graph_captures_total"] == 0,
                f"{name}: captures after warmup")
        require(r["leaked"] in (None, 0) and not r["ledger_errors"],
                f"{name}: blocks leaked")
    for name, d in diffs.items():
        require(all(map(_near_tie, d)),
                f"{name} differs from {base[name]} where the top-2 margin "
                f"is not small: {d}")


#: the migration and KV-tier phases: the paged pool, block_size 16
MIGRATE_ENGINE = dict(num_slots=8, decode_chunk=4, block_size=16,
                      prefix_cache=False)
MIGRATE = dict(prompts=8, prompt_len=128, new=64, at=32)


def _paged_engine(cfg, model, ledger=None, **kw):
    """A ContinuousEngine with ``MIGRATE_ENGINE``'s knobs (``kw`` override
    them), ``ledger`` attached before traffic."""
    from kubeflow_tpu_torch.serving.continuous import ContinuousEngine

    eng = ContinuousEngine(cfg, model, **{**MIGRATE_ENGINE, **kw})
    if ledger is not None:
        eng.attach_block_ledger(ledger)
    return eng


def _wait_tokens(reqs, n: int, what: str) -> None:
    deadline = time.perf_counter() + 600
    while min(len(r.tokens) for r in reqs) < n:
        require(time.perf_counter() < deadline, f"{what}: no progress")
        require(not any(r.done.is_set() for r in reqs),
                f"{what}: a request finished before {n} tokens")
        time.sleep(0.0005)


def _serve_all(eng, prompts, new: int) -> tuple[list, float]:
    """(streams, seconds) of one round of ``prompts`` through ``eng``."""
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    streams = [r.wait(600) for r in reqs]
    return streams, time.perf_counter() - t0


def _require_streams(name: str, diffs: list) -> None:
    require(all(map(_near_tie, diffs)),
            f"{name}: a stream differs from the uninterrupted one where no "
            f"margin is small: {diffs}")


def _require_clean(name: str, ledger, *engines) -> dict:
    """0 captures after warmup and 0 leaked blocks (a consistent-boundary
    audit on each engine and the shared ledger's books)."""
    leaks = [eng.audit_blocks() for eng in engines]
    out = {"captures_after_warmup": [e.stats()["graph_captures_total"]
                                     for e in engines],
           "blocks_leaked": ledger.leaked_total,
           "ledger_errors": list(ledger.conservation_errors)}
    require(all(n == 0 for n in out["captures_after_warmup"]),
            f"{name}: captures after warmup {out['captures_after_warmup']}")
    require(not any(leaks) and ledger.leaked_total == 0
            and not ledger.conservation_errors, f"{name}: leaked blocks "
            f"{leaks} {ledger.conservation_errors}")
    return out


def pinned_copy_rate(nbytes: int = 64 << 20) -> dict:
    """The host-card copy rate on ``nbytes``, pinned each way and pageable
    to the host (device time from CUDA events, median of 5): the bound of
    a migration's copies."""
    import torch

    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(nbytes, dtype=torch.uint8)
    ms = {"d2h": time_ms(lambda: pinned.copy_(dev, non_blocking=True), 5),
          "h2d": time_ms(lambda: dev.copy_(pinned, non_blocking=True), 5),
          "d2h_pageable": time_ms(lambda: pageable.copy_(dev), 5)}
    return {"bytes": nbytes, **{f"{k}_ms": v for k, v in ms.items()},
            **{f"{k}_gb_per_s": nbytes / v / 1e6 for k, v in ms.items()}}


def phase_migrate_serve() -> None:
    """Live migration on the 271M bench model: 8 x 128-token prompts, 64
    new tokens, served uninterrupted on engine A, then again with
    ``migrate_live_sequences(A, B)`` after 32 tokens (export and import
    timed per sequence on the host clock); one held import into the idle
    B, resumed; one sequence moved mid-prefill between two chunked engines
    (prefill_budget 64, a 960-token prompt: 15 chunks, so the export lands
    between two of them however the host is scheduled). One BlockLedger
    spans the engines."""
    import torch

    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.serving.continuous import migrate_live_sequences

    cfg, model = _serve_model("bench_model")
    prompts = _prompts(cfg, MIGRATE["prompts"], MIGRATE["prompt_len"])
    new, warm = MIGRATE["new"], [(8, 128), (1, 128)]
    ledger = BlockLedger()
    a, b = _paged_engine(cfg, model, ledger), _paged_engine(cfg, model, ledger)
    c = _paged_engine(cfg, model, ledger, prefill_budget=64)
    d = _paged_engine(cfg, model, ledger, prefill_budget=64)
    out = {}
    try:
        for eng in (a, b):
            eng.warmup(warm)
        for eng in (c, d):
            eng.warmup([(1, 960)])
        plain, _ = _serve_all(a, prompts, new)
        reqs = [a.submit(p, max_new_tokens=new) for p in prompts]
        _wait_tokens(reqs, MIGRATE["at"], "migrate_serve")
        export_ms, import_ms, latency_ms = [], [], []
        export = a.export_sequence

        def timed_export(req, timeout=60.0):
            t0 = time.perf_counter()
            snap = export(req, timeout)
            export_ms.append((time.perf_counter() - t0) * 1e3)
            return snap

        def send(snap, req):
            t0 = time.perf_counter()
            b.import_sequence(snap, req=req)
            import_ms.append((time.perf_counter() - t0) * 1e3)
            return True

        bytes0 = a.kv_migrate_bytes_total, b.kv_migrate_bytes_total
        a.export_sequence = timed_export
        t0 = time.perf_counter()
        try:
            moved, failed = migrate_live_sequences(
                a, b, send=send, on_latency=latency_ms.append)
        finally:
            del a.export_sequence
        drain_ms = (time.perf_counter() - t0) * 1e3
        migrated = [r.wait(600) for r in reqs]
        out_bytes = a.kv_migrate_bytes_total - bytes0[0]
        in_bytes = b.kv_migrate_bytes_total - bytes0[1]
        # a held import into the idle B, timed to the end of its copies
        req = a.submit(prompts[0], max_new_tokens=new)
        _wait_tokens([req], MIGRATE["at"], "migrate_serve hold")
        snap = a.export_sequence(req)
        hold_bytes = (sum(x.nbytes for blk in snap["blocks"] for x in blk)
                      + snap["logits"].nbytes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.import_sequence(snap, req=req, hold=True)
        torch.cuda.synchronize()
        hold_ms = (time.perf_counter() - t0) * 1e3
        a.release_sequence(req)
        n = len(req.tokens)
        time.sleep(0.05)
        held_still = len(req.tokens) == n and not req.done.is_set()
        b.resume_sequence(req)
        held = req.wait(600)
        # mid-prefill, between chunked engines
        long_prompt = _prompts(cfg, 1, 960)
        plain_long, _ = _serve_all(c, long_prompt, 32)
        chunks0 = c.prefill_chunks_dispatched
        req = c.submit(long_prompt[0], max_new_tokens=32)
        deadline = time.perf_counter() + 600
        while c.prefill_chunks_dispatched - chunks0 < 2:
            require(time.perf_counter() < deadline, "prefill never started")
            time.sleep(0.0002)
        snap = c.export_sequence(req)
        mid_position = snap["position"]
        require(snap["phase"] == "prefill" and 0 < mid_position < 960,
                f"mid-prefill export at {snap['phase']} {mid_position}")
        d.import_sequence(snap, req=req)
        c.release_sequence(req)
        mid = [req.wait(600)]
        clean = _require_clean("migrate_serve", ledger, a, b, c, d)
    finally:
        for eng in (a, b, c, d):
            eng.stop()
    copy = pinned_copy_rate()
    diffs = {"drain": _first_difference(cfg, model, prompts, plain,
                                        migrated),
             "held": _first_difference(cfg, model, prompts[:1], plain[:1],
                                       [held]),
             "mid_prefill": _first_difference(cfg, model, long_prompt,
                                              plain_long, mid)}
    out.update(
        moved=moved, failed=failed, bytes_exported=out_bytes,
        bytes_imported=in_bytes, export_ms=export_ms, import_ms=import_ms,
        export_ms_median=statistics.median(export_ms),
        import_ms_median=statistics.median(import_ms),
        cutover_ms=latency_ms, drain_ms=drain_ms,
        export_gb_per_s=out_bytes / sum(export_ms) / 1e6,
        import_gb_per_s=in_bytes / sum(import_ms) / 1e6,
        held_import_bytes=hold_bytes, held_import_ms=hold_ms,
        held_import_gb_per_s=hold_bytes / hold_ms / 1e6,
        held_until_resume=held_still, mid_prefill_position=mid_position,
        pinned_copy=copy, differences=diffs, **clean)
    emit("migrate_serve", model="bench_model", engine=MIGRATE_ENGINE,
         **MIGRATE, **out)
    require(moved == MIGRATE["prompts"] and failed == 0,
            f"moved {moved}, failed {failed}")
    require(held_still, "a held import decoded before its resume")
    for name, d in diffs.items():
        _require_streams(f"migrate_serve {name}", d)


def phase_moe_migrate_serve() -> dict:
    """Live migration on the MoE bench model: 4 x 128-token prompts, 32 new
    tokens, migrated from A to B after 16; the kernel counts are set to 0
    once the drain returns (A then holds nothing) and read when the streams
    end: B's decode runs the experts on K4a ``gmm``."""
    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.serving.continuous import migrate_live_sequences

    cfg, model = _serve_model("bench_moe_model")
    prompts = _prompts(cfg, 4, 128)
    ledger = BlockLedger()
    a, b = _paged_engine(cfg, model, ledger), _paged_engine(cfg, model, ledger)
    try:
        for eng in (a, b):
            eng.warmup([(4, 128), (1, 128)])
        plain, _ = _serve_all(a, prompts, 32)
        reqs = [a.submit(p, max_new_tokens=32) for p in prompts]
        _wait_tokens(reqs, 16, "moe_migrate_serve")
        moved, failed = migrate_live_sequences(a, b)
        for counter in _counters():
            for key in counter:
                counter[key] = 0
        migrated = [r.wait(600) for r in reqs]
        launches = {k: v for c in _counters() for k, v in c.items()}
        clean = _require_clean("moe_migrate_serve", ledger, a, b)
    finally:
        a.stop()
        b.stop()
    diffs = _first_difference(cfg, model, prompts, plain, migrated)
    emit("moe_migrate_serve", model="bench_moe_model", prompts=4,
         prompt_len=128, new=32, at=16, engine=MIGRATE_ENGINE, moved=moved,
         failed=failed, launches_on_b_after_the_drain=launches,
         differences=diffs, **clean)
    require(moved == 4 and failed == 0, f"moved {moved}, failed {failed}")
    require(launches["gmm"] > 0, "B launched no gmm after the import")
    _require_streams("moe_migrate_serve", diffs)
    return launches


def phase_hibernate_serve() -> None:
    """Hibernate and thaw on the bench model: 5 sessions of 128-token
    prompts and 380 new tokens on A (the last hibernation must find its
    session still decoding); after 16 tokens each is hibernated into a
    ``KvSpillStore`` under a temporary directory; four thaw on B from the
    store, and the fifth, its ``blocks.bin`` cut in half, thaws degraded
    (re-prefilled from the manifest's tokens)."""
    import os
    import tempfile

    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.serving.storage import KvSpillStore

    cfg, model = _serve_model("bench_model")
    prompts = _prompts(cfg, 5, 128)
    new, warm = 380, [(8, 128), (1, 256)]
    ledger = BlockLedger()
    a, b = _paged_engine(cfg, model, ledger), _paged_engine(cfg, model, ledger)
    with tempfile.TemporaryDirectory() as root:
        store = KvSpillStore(root)
        write_ms, thaw_ms = [], []
        write = store.write

        def timed_write(*args, **kw):
            t0 = time.perf_counter()
            entry = write(*args, **kw)
            write_ms.append((time.perf_counter() - t0) * 1e3)
            return entry

        store.write = timed_write
        try:
            for eng in (a, b):
                eng.warmup(warm)
                eng.attach_spill_store(store)
            plain, _ = _serve_all(a, prompts, new)
            reqs = [a.submit(p, max_new_tokens=new, session_id=f"s{i}")
                    for i, p in enumerate(prompts)]
            _wait_tokens(reqs, 16, "hibernate_serve")
            hibernated = [a.hibernate_sequence(r, r.session_id)
                          for r in reqs]
            blocks = os.path.join(store._entry_dir("s4"), "blocks.bin")
            os.truncate(blocks, os.path.getsize(blocks) // 2)
            for r in reqs[:4]:
                t0 = time.perf_counter()
                b.thaw_sequence(r.session_id, req=r)
                thaw_ms.append((time.perf_counter() - t0) * 1e3)
            torn = reqs[4]
            prior = len(torn.tokens)
            t0 = time.perf_counter()
            _, info = b.thaw_sequence("s4", req=torn)
            _wait_tokens([torn], prior + 1, "degraded thaw")
            reprefill_ms = (time.perf_counter() - t0) * 1e3
            thawed = [r.wait(600) for r in reqs]
            st_a, st_b = a.stats(), b.stats()
            clean = _require_clean("hibernate_serve", ledger, a, b)
        finally:
            a.stop()
            b.stop()
    diffs = _first_difference(cfg, model, prompts, plain, thawed)
    keys = ("kv_spills_total", "kv_thaws_total", "kv_thaws_degraded_total",
            "kv_spill_verify_failures_total", "kv_sessions_hibernated")
    emit("hibernate_serve", model="bench_model", sessions=5, prompt_len=128,
         new=new, at=16, engine=MIGRATE_ENGINE, hibernated=hibernated,
         spill_write_ms=write_ms, thaw_ms=thaw_ms,
         degraded_reprefill_ms=reprefill_ms, degraded=info["degraded"],
         stats_a={k: st_a[k] for k in keys},
         stats_b={k: st_b[k] for k in keys}, differences=diffs, **clean)
    require(all(hibernated), f"hibernated {hibernated}")
    require(info["degraded"] and st_b["kv_thaws_degraded_total"] == 1,
            "the torn spill did not thaw degraded")
    require(st_b["kv_thaws_total"] == 5 and st_a["kv_spills_total"] == 5,
            "spill and thaw counts")
    _require_streams("hibernate_serve", diffs)


HOST_TIER = dict(rounds=8, shared=512, tail=16, new=32, churn_new=64)
HOST_ENGINE = dict(num_slots=8, decode_chunk=4, block_size=16,
                   prefix_cache=True, num_blocks=96, host_blocks=256,
                   host_watermark=0.5)


def phase_host_tier_serve() -> None:
    """The host KV tier on the bench model: a pool of 96 blocks (1,536
    tokens), a host tier of 256 (256 MiB), watermark 0.5. Each of 8 rounds
    serves a prompt of a shared 512-token prefix and its own 16-token tail
    (32 new) beside an unrelated 512-token prompt (64 new): the shared
    prompt retires with the free list under the watermark and spills, and
    the next round's unrelated prompt reuses its blocks, so the next shared
    prompt restores the prefix from host RAM. Streams are held against
    the same prompts on a prefix-off engine."""
    import numpy as np

    from kubeflow_tpu_torch.analysis.runtime import BlockLedger

    cfg, model = _serve_model("bench_model")
    rng = np.random.default_rng(SEED + 8)
    v = cfg.vocab_size
    n = HOST_TIER["rounds"]
    shared = rng.integers(1, v, size=HOST_TIER["shared"]).tolist()
    prompts = [shared + rng.integers(1, v, size=HOST_TIER["tail"]).tolist()
               for _ in range(n)]
    churn = rng.integers(1, v, size=(n, HOST_TIER["shared"])).tolist()
    ledger = BlockLedger()
    eng = _paged_engine(cfg, model, ledger, **HOST_ENGINE)
    base = _paged_engine(cfg, model)
    rounds = []
    try:
        eng.warmup([(1, 1023)])
        base.warmup([(8, 1023)])
        plain, _ = _serve_all(base, prompts, HOST_TIER["new"])
        streams = []
        for i in range(n):
            restores0 = eng.stats()["kv_host_restores_total"]
            c = eng.submit(churn[i], max_new_tokens=HOST_TIER["churn_new"])
            s = eng.submit(prompts[i], max_new_tokens=HOST_TIER["new"])
            streams.append(s.wait(600))
            c.wait(600)
            st = eng.stats()
            rounds.append({"ttft_ms": s.ttft_s * 1e3, "restored":
                           st["kv_host_restores_total"] - restores0})
        clean = _require_clean("host_tier_serve", ledger, eng, base)
    finally:
        eng.stop()
        base.stop()
    st = eng.stats()
    keys = ("kv_blocks_host_tier", "kv_host_bytes", "kv_host_spills_total",
            "kv_host_restores_total", "kv_host_evictions_total",
            "kv_spills_total", "kv_thaws_total", "prefix_hits",
            "prefix_block_hits_total")
    restored = [r["ttft_ms"] for r in rounds if r["restored"]]
    diffs = _first_difference(cfg, model, prompts, plain, streams)
    emit("host_tier_serve", model="bench_model", **HOST_TIER,
         engine=HOST_ENGINE, rounds_detail=rounds,
         ttft_ms_cold=rounds[0]["ttft_ms"],
         ttft_ms_restored_median=(statistics.median(restored)
                                  if restored else None),
         stats={k: st[k] for k in keys}, differences=diffs, **clean)
    require(st["kv_host_restores_total"] > 0, "no host-tier restore")
    _require_streams("host_tier_serve", diffs)


def phase_disagg_serve() -> None:
    """Prefill/decode disaggregation on the bench model: 8 x 128-token
    prompts, 64 new, through a ``DisaggregatedPool`` of one prefill and one
    decode engine in process, and through ``build_engine`` with
    ``tier_lens`` [256] (the ladder), each against a mixed engine."""
    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.serving.continuous import (
        DisaggregatedPool,
        build_engine,
    )

    cfg, model = _serve_model("bench_model")
    prompts = _prompts(cfg, 8, 128)
    warm = [(8, 128), (1, 128)]
    mixed = _paged_engine(cfg, model)
    pool = DisaggregatedPool(cfg, model, prefill_replicas=1,
                             decode_replicas=1, **MIGRATE_ENGINE)
    ledger = BlockLedger()
    for eng in pool.pools:
        eng.attach_block_ledger(ledger)
    tiered = build_engine(cfg, model, {**MIGRATE_ENGINE, "tier_lens": [256],
                                       "warmup_groups": warm})
    try:
        mixed.warmup(warm)
        pool.warmup(warm)
        want, mixed_s = _serve_all(mixed, prompts, 64)
        got, pool_s = _serve_all(pool, prompts, 64)
        ladder, ladder_s = _serve_all(tiered, prompts, 64)
        # the worker records a handoff after the prefill engine released
        # it, which may land after the decode engine finished the stream
        deadline = time.perf_counter() + 600
        while len(pool.migration_latencies_ms) < len(prompts):
            require(time.perf_counter() < deadline, "handoffs unrecorded")
            time.sleep(0.001)
        st = pool.stats()
        clean = _require_clean("disagg_serve", ledger, *pool.pools)
        require(mixed.stats()["graph_captures_total"] == 0
                and tiered.stats()["graph_captures_total"] == 0,
                "captures after warmup")
        handoff = list(pool.migration_latencies_ms)
    finally:
        mixed.stop()
        pool.stop()
        tiered.stop()
    tokens = len(prompts) * 64
    diffs = {"disagg": _first_difference(cfg, model, prompts, want, got),
             "tier_ladder": _first_difference(cfg, model, prompts, want,
                                              ladder)}
    emit("disagg_serve", model="bench_model", prompts=8, prompt_len=128,
         new=64, engine=MIGRATE_ENGINE,
         tokens_per_sec={"mixed": tokens / mixed_s,
                         "disaggregated": tokens / pool_s,
                         "tier_ladder": tokens / ladder_s},
         handoff_ms_median=statistics.median(handoff), handoff_ms=handoff,
         kv_migrations_total=st["kv_migrations_total"],
         kv_migrate_bytes_total=st["kv_migrate_bytes_total"],
         differences=diffs, **clean)
    require(st["kv_migrations_total"] == len(prompts),
            f"{st['kv_migrations_total']} handoffs")
    for name, d in diffs.items():
        _require_streams(f"disagg_serve {name}", d)


#: the fine-tune job (phase ``finetune``): llama_1b at full width and
#: depth from seed 0, a LoRA of rank 8 on wq/wv, 8 x 2048 a step, 4 steps
#: checkpointed every 2, then a second incarnation to step 6
FINETUNE = dict(lora_rank=8, batch=8, seq=2048, steps=4, resume_to=6,
                save_every=2)
#: remat "nothing" runs every flash forward again in the backward pass
FINETUNE_PER_LAYER = {"flash_fwd": 2, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _train_main(env: dict, status: str) -> tuple:
    """``train_main`` of the pod entry in this process, configured by
    ``env`` (restored after), its stdout kept out of this script's:
    (trainer, metric rows, the launches of the run, seconds)."""
    import contextlib
    import io
    import os

    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.train import llm

    env = {**env, "KFT_STATUS_DIR": status}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for c in _counters():
            for key in c:
                c[key] = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = llm.train_main(bootstrap.initialize())
        seconds = time.perf_counter() - t0
        launches = {k: v for c in _counters() for k, v in c.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    path = os.path.join(status, "metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    os.remove(path)
    return trainer, rows, launches, seconds


def _metric(rows: list, name: str) -> list:
    return [r for r in rows if r["name"] == name]


def _base_unchanged(base_model, trainer) -> bool:
    import torch

    from kubeflow_tpu_torch.models import llama

    got = trainer.model.state_dict()
    return all(torch.equal(got[k], v)
               for k, v in base_model.state_dict().items()
               if not llama.is_lora_path(k))


def phase_finetune(work: str, card: str) -> dict:
    """The fine-tune job end to end on llama_1b (1.19B, 21 layers, full
    width, random weights from SEED): ``save_pretrained`` writes the base,
    the pod entry ``train_main`` fine-tunes a rank-8 LoRA on it
    (``KFT_INIT_FROM``, 8 x 2048, 4 steps, checkpoints every 2) and
    publishes the adapter; a second ``train_main`` to step 6 resumes at
    step 4. Each run launches K1-K3 (counted per run); the base stays bit
    for bit the snapshot's; checkpoints hold the adapters only."""
    import gc
    import os

    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama.llama_1b()
    model = llama.Llama(cfg, device="cuda")
    model.init_weights(SEED)
    torch.cuda.synchronize()
    base = os.path.join(work, "base")
    t0 = time.perf_counter()
    llama.save_pretrained(base, cfg, model)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap_cfg, snap = llama.load_pretrained(base)
    load_s = time.perf_counter() - t0
    require(snap_cfg == cfg, f"snapshot config {snap_cfg} != {cfg}")
    require(all(torch.equal(snap[k], v.cpu())
                for k, v in model.state_dict().items()),
            "the snapshot does not read back bit for bit")
    del snap
    ft = FINETUNE
    env = {"KFT_INIT_FROM": f"file://{base}",
           "KFT_LORA_RANK": str(ft["lora_rank"]),
           "KFT_STEPS": str(ft["steps"]), "KFT_BATCH": str(ft["batch"]),
           "KFT_SEQ_LEN": str(ft["seq"]),
           "KFT_CKPT_DIR": os.path.join(work, "ckpt"),
           "KFT_SAVE_EVERY": str(ft["save_every"]), "KFT_LOG_EVERY": "1",
           "KFT_PUBLISH_TO": os.path.join(work, "adapter")}
    status = os.path.join(work, "status")
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for steps in (ft["steps"], ft["resume_to"]):
        trainer, rows, launches, seconds = _train_main(
            {**env, "KFT_STEPS": str(steps)}, status)
        done = runs[-1]["steps"] if runs else 0
        per_step = {k: FINETUNE_PER_LAYER.get(k, 0) * cfg.num_layers
                    * (steps - done) for k in launches}
        losses = [r["value"] for r in _metric(rows, "loss")]
        runs.append({
            "steps": steps, "seconds": seconds,
            "resume_step": _metric(rows, "resume_step")[0]["value"],
            "loss_steps": [r["step"] for r in _metric(rows, "loss")],
            "losses": losses,
            "tokens_per_sec": [r["value"] for r in _metric(
                rows, "tokens_per_sec_per_chip")],
            "mfu_reported": _metric(rows, "mfu")[0]["value"],
            "published": _metric(rows, "published")[0]["value"],
            "launches": launches, "launches_expected": per_step,
            "base_unchanged": _base_unchanged(model, trainer),
            "checkpoints": trainer.ckpt.all_steps(),
        })
        if steps != ft["resume_to"]:
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    last = trainer
    peak = torch.cuda.max_memory_allocated()
    ckpt_dir = env["KFT_CKPT_DIR"]
    ckpt_bytes = {s: _dir_bytes(os.path.join(ckpt_dir, str(s)))
                  for s in runs[-1]["checkpoints"]}
    adapter_bytes = _dir_bytes(env["KFT_PUBLISH_TO"])
    base_bytes = _dir_bytes(base)
    # the save, restore and publish of this state, timed alone
    timing = CheckpointManager(os.path.join(work, "ckpt_timing"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timing.save(ft["resume_to"], last._to_ckpt(), force=True)
    ckpt_save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    timing.restore(map_location="cuda")
    torch.cuda.synchronize()
    ckpt_restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    llama.save_adapter(os.path.join(work, "adapter_timing"), last.cfg.model,
                       last.model)
    publish_s = time.perf_counter() - t0
    # steady steps: every run's steps after its first
    steady = [t for r in runs for t in r["tokens_per_sec"][1:]]
    tps = statistics.median(steady)
    flops_tok = llama.flops_per_token(cfg, ft["seq"])
    emit("finetune", model="llama_1b", params=llama.num_params(cfg),
         lora_rank=ft["lora_rank"], lora_params=sum(
             p.numel() for n, p in last.model.named_parameters()
             if llama.is_lora_path(n)),
         global_batch=ft["batch"], seq_len=ft["seq"], runs=runs,
         tokens_per_sec=tps, tokens_per_sec_steps=steady,
         mfu=tps * flops_tok / PEAK_FLOPS,
         mfu_convention="6N + attention per token (the reference's "
         "flops_per_token), frozen-base weight gradients included",
         peak_mem_bytes=peak, snapshot_write_ms=save_s * 1e3,
         snapshot_read_ms=load_s * 1e3, checkpoint_save_ms=ckpt_save_s * 1e3,
         checkpoint_restore_ms=ckpt_restore_s * 1e3,
         publish_ms=publish_s * 1e3, base_bytes=base_bytes,
         checkpoint_bytes=ckpt_bytes, adapter_bytes=adapter_bytes, card=card)
    first, second = runs
    require(first["resume_step"] == 0 and second["resume_step"] ==
            ft["steps"], f"resume steps {first['resume_step']}, "
            f"{second['resume_step']}")
    require(first["loss_steps"] == list(range(1, ft["steps"] + 1))
            and second["loss_steps"] == list(
                range(ft["steps"] + 1, ft["resume_to"] + 1)),
            "the second run did not train only the steps after the resume")
    for r in runs:
        require(all(map(math.isfinite, r["losses"])),
                f"fine-tune losses not finite: {r['losses']}")
        require(r["launches"] == r["launches_expected"] and all(
            r["launches"][k] > 0 for k in FINETUNE_PER_LAYER),
            f"fine-tune launches {r['launches']} != "
            f"{r['launches_expected']}")
        require(r["base_unchanged"], "the frozen base changed")
        require(r["published"] == 1.0, "the adapter was not published")
    require(max(ckpt_bytes.values()) < base_bytes / 100,
            f"checkpoints {ckpt_bytes} are not adapter-only")
    require(adapter_bytes < base_bytes / 100,
            f"the published adapter is {adapter_bytes} bytes")
    del last, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"base": base, "adapter": env["KFT_PUBLISH_TO"]}


#: Adafactor at full fine-tune: llama_1b, 8 x 2048 in two microbatches
ADAFACTOR = dict(batch=8, seq=2048, accum=2, steps=3)


def _adafactor_parity() -> dict:
    """The first Adafactor step (accum 2) of llama_1b at full width and 2
    layers on the card against the same step on the CPU (the kernels'
    plain versions), both bf16, at 2 x 256 tokens. Held: the loss within
    1e-2; every gradient within 5e-2 (max error over max value, as
    ``parity_on_card``); the card's update within 5e-2 (|d_card - d| /
    |d|, norms over the parameter) of the CPU optimizer's update from the
    card's own gradients; and of the CPU's whole step, in every leaf
    Adafactor factors (its update is proportional to the gradient). In a
    leaf it does not factor (the norm scales) the update is lr x scale x
    sign(gradient), so there an element may differ only where the
    gradient is a near tie at zero: |g| within 5e-2 of the leaf's largest,
    the gradient tolerance."""
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.train.data import SyntheticLm
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=llama.llama_1b(num_layers=2),
                      optimizer="adafactor", accum_steps=2, global_batch=2,
                      seq_len=256, steps=1, warmup_steps=0)
    gpu, cpu = Trainer(cfg), Trainer(cfg, device="cpu")
    gpu.init_state(SEED)
    before = {k: v.detach().cpu().clone()
              for k, v in gpu.model.state_dict().items()}
    tree = convert.tree_from_state_dict(before, cfg.model)
    cpu.load_params(tree)
    tokens = SyntheticLm(cfg.global_batch, cfg.seq_len,
                         cfg.model.vocab_size).local_batch(0)["tokens"]

    def grads(t):
        return {n: p.grad.detach().float().cpu().clone()
                for n, p in t.model.named_parameters()}

    def deltas(t):
        return {k: v.detach().cpu() - before[k]
                for k, v in t.model.state_dict().items()}

    names = {id(p): n for n, p in gpu.model.named_parameters()}
    factored = {names[id(p)]: dims is not None
                for parts, dims, _ in gpu.opt.groups for p in parts}
    loss_g = float(gpu.loss_and_grads(tokens))
    g_card = grads(gpu)
    gpu.opt.step()
    d_card = deltas(gpu)
    # the CPU's optimizer alone, on the card's gradients
    for n, p in cpu.model.named_parameters():
        p.grad = g_card[n].clone()
    cpu.opt.step()
    d_same = deltas(cpu)
    cpu.model.zero_grad(set_to_none=True)
    # the whole step on the CPU
    cpu.load_params(tree)
    t0 = time.perf_counter()
    loss_c = float(cpu.loss_and_grads(tokens))
    g_cpu = grads(cpu)
    cpu.opt.step()
    cpu_s = time.perf_counter() - t0
    d_cpu = deltas(cpu)

    def norm_rel(x, ref):
        return float((x - ref).norm() / ref.norm())

    grad_rel = {n: rel_err(g_card[n], g_cpu[n]) for n in g_cpu}
    opt_rel = {n: norm_rel(d_card[n], d_same[n]) for n in d_same}
    step_rel = {n: norm_rel(d_card[n], d_cpu[n]) for n in d_cpu}
    flips, flips_off_tie = {}, {}
    for n, is_factored in factored.items():
        if is_factored:
            continue
        differ = d_card[n].sign() != d_cpu[n].sign()
        tie = g_cpu[n].abs() <= 5e-2 * g_cpu[n].abs().max()
        flips[n] = int(differ.sum())
        flips_off_tie[n] = int((differ & ~tie).sum())

    def worst(errs, keys=None):
        keys = list(errs) if keys is None else keys
        if not keys:
            return {"name": None, "rel": 0.0}
        k = max(keys, key=errs.get)
        return {"name": k, "rel": errs[k]}

    return {"loss_card": loss_g, "loss_cpu": loss_c,
            "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
            "worst_grad": worst(grad_rel),
            "worst_update_same_grads": worst(opt_rel),
            "worst_update_factored": worst(
                step_rel, [n for n, f in factored.items() if f]),
            "worst_update_unfactored": worst(
                step_rel, [n for n, f in factored.items() if not f]),
            "unfactored_sign_flips": flips,
            "unfactored_flips_off_tie": flips_off_tie,
            "cpu_step_s": cpu_s}


def phase_adafactor_step(base: str, card: str) -> None:
    """A full fine-tune of llama_1b from the base snapshot with optax's
    Adafactor and gradient accumulation (2 microbatches of 4 x 2048): the
    first step, then two more with host syncs made errors (each batch on
    the card before); the first step held against the CPU
    (``_adafactor_parity``)."""
    import gc

    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.data import SyntheticLm
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    af = ADAFACTOR
    cfg = TrainConfig(model=llama.llama_1b(), init_from=base,
                      optimizer="adafactor", accum_steps=af["accum"],
                      global_batch=af["batch"], seq_len=af["seq"],
                      steps=af["steps"], warmup_steps=0)
    trainer = Trainer(cfg)
    trainer.init_state()
    data = SyntheticLm(cfg.global_batch, cfg.seq_len, cfg.model.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.step(data.local_batch(0)["tokens"])[0]]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    batches = [torch.as_tensor(data.local_batch(i)["tokens"], device="cuda")
               for i in range(1, af["steps"])]
    for c in _counters():
        for key in c:
            c[key] = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        for b in batches:
            losses.append(trainer.step(b)[0])
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = {k: v for c in _counters() for k, v in c.items()}
    step_s = start.elapsed_time(end) / 1e3 / len(batches)
    losses = [float(x) for x in losses]
    tps = cfg.global_batch * cfg.seq_len / step_s
    peak = torch.cuda.max_memory_allocated()
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    parity = _adafactor_parity()
    # every microbatch of the checked steps runs each layer's kernels
    per_step = {k: FINETUNE_PER_LAYER.get(k, 0) * cfg.model.num_layers
                * af["accum"] * (af["steps"] - 1) for k in launches}
    emit("adafactor_step", model="llama_1b", optimizer="adafactor",
         accum_steps=af["accum"], global_batch=af["batch"],
         seq_len=af["seq"], steps=af["steps"], trained="all parameters",
         sync_debug_mode="error", losses=losses, first_step_ms=first_s * 1e3,
         step_ms=step_s * 1e3, tokens_per_sec=tps,
         mfu=tps * llama.flops_per_token(cfg.model, af["seq"]) / PEAK_FLOPS,
         peak_mem_bytes=peak, launches=launches,
         launches_expected=per_step, parity=parity, card=card)
    require(all(map(math.isfinite, losses)), f"losses {losses}")
    require(launches == per_step, f"launches {launches} != {per_step}")
    require(parity["loss_rel"] <= 1e-2
            and parity["worst_grad"]["rel"] <= 5e-2
            and parity["worst_update_same_grads"]["rel"] <= 5e-2
            and parity["worst_update_factored"]["rel"] <= 5e-2
            and not any(parity["unfactored_flips_off_tie"].values()),
            f"Adafactor step card vs cpu: {parity}")


#: the published fine-tune served: the base snapshot plus the adapter,
#: merged at load, 8 prompts x 128 tokens, 64 new, greedy, paged pool
FINETUNE_SERVE = dict(prompts=8, prompt_len=128, new=64, rounds=2)


def phase_finetune_serve(base: str, adapter: str, card: str) -> None:
    """``resolve_model_source`` of ``storage_path`` (the base) and
    ``adapter_path`` (the published adapter, merged), then ``build_engine``
    twice on it: with ``quant_weights`` and ``quant_kv`` (every projection
    and the head int8, inside the captured programs) and without. Every
    first difference of the two engines' greedy streams must sit where the
    plain model's top-2 margin is small; 0 captures after warmup and 0
    leaked blocks in both."""
    import gc

    import torch

    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.serving.continuous import (
        build_engine, resolve_model_source)

    fs = FINETUNE_SERVE
    common = {"storage_path": base, "adapter_path": adapter,
              "max_seq_len": 512, "num_slots": 8, "decode_chunk": 16,
              "pipeline_depth": 3, "block_size": 16, "prefix_cache": False,
              "warmup_groups": []}
    t0 = time.perf_counter()
    cfg, params = resolve_model_source(common)
    resolve_s = time.perf_counter() - t0
    prompts = _prompts(cfg, fs["prompts"], fs["prompt_len"])
    runs, plain_model = {}, None
    for name, extra in (("int8", {"quant_weights": True, "quant_kv": True}),
                        ("plain", {})):
        ledger = BlockLedger()
        t0 = time.perf_counter()
        eng = build_engine(cfg, params, {**common, **extra})
        build_s = time.perf_counter() - t0
        eng.attach_block_ledger(ledger)
        t0 = time.perf_counter()
        eng.warmup([(fs["prompts"], fs["prompt_len"]),
                    (1, fs["prompt_len"])])
        warmup_s = time.perf_counter() - t0
        try:
            rounds = [_serve_all(eng, prompts, fs["new"])
                      for _ in range(fs["rounds"])]
            clean = _require_clean(f"finetune_serve {name}", ledger, eng)
            st = eng.stats()
        finally:
            eng.stop()
        weights = {}
        for p in eng.model.parameters():
            key = str(p.dtype).removeprefix("torch.")
            weights[key] = weights.get(key, 0) + p.numel() * p.element_size()
        runs[name] = {
            "tokens": rounds[0][0], "build_s": build_s, "warmup_s": warmup_s,
            "tokens_per_sec": statistics.median(
                len(prompts) * fs["new"] / s for _, s in rounds),
            "seconds": [s for _, s in rounds], "weight_bytes": weights,
            "quant_weights": eng.cfg.quant_weights,
            "quant_kv": eng.cfg.quant_kv,
            "graph_captures_warmup": st["graph_captures_warmup"], **clean}
        require(all(t == rounds[0][0] for t, _ in rounds),
                f"finetune_serve {name}: rounds differ")
        if name == "plain":
            plain_model = eng.model
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    diffs = _first_difference(cfg, plain_model, prompts,
                              runs["plain"]["tokens"], runs["int8"]["tokens"])
    for r in runs.values():
        r.pop("tokens")
    emit("finetune_serve", model="llama_1b", merged_adapter=adapter,
         prompts=fs["prompts"], prompt_len=fs["prompt_len"], new=fs["new"],
         resolve_s=resolve_s, runs=runs,
         int8_vs_plain_differences=diffs,
         int8_weight_bytes=sum(runs["int8"]["weight_bytes"].values()),
         plain_weight_bytes=sum(runs["plain"]["weight_bytes"].values()),
         card=card)
    require(runs["int8"]["quant_weights"] and runs["int8"]["quant_kv"],
            "the quantized engine does not run int8")
    _require_streams("finetune_serve int8 vs plain", diffs)
    del plain_model, params
    gc.collect()
    torch.cuda.empty_cache()


#: the HTTP phase (``http_serve``): the port's ModelServer + TextGenerator
#: over the bench model, paged (blocks of 16) with chunked admission (64 a
#: dispatch), every request traced, two QoS classes. The prefix cache is
#: off and every prompt plus its completion stays under the first attend
#: rung (128), so a request runs the same program shapes whatever shares
#: the pool with it: the server's greedy text must equal the engine's own
HTTP_ENGINE = {"block_size": 16, "prefill_budget": 64, "num_slots": 8,
               "decode_chunk": 4, "prefix_cache": False,
               "max_new_tokens": 32, "tracing": {"sample": 1.0},
               "qos": {"bulk": {"priority": "low"},
                       "gold": {"priority": "high"}}}
#: request mix: 16 blocking completions and 8 streams of 48-character
#: prompts, 32 new tokens each; the preemption scenario's 8 low-class
#: requests (16-character prompts, 96 new) fill every slot before one
#: high-class stream of 16 tokens arrives; 4 completions on the MoE model
HTTP = dict(completions=16, streams=8, prompt_chars=48, new=32,
            lows=8, low_chars=16, low_new=96, high_new=16, moe=4)
STREAM_PHASES = ["replica.door", "engine.queue", "engine.prefill",
                 "engine.decode"]


def _http_prompts(n: int, chars: int, seed: int) -> list[str]:
    import numpy as np

    letters = list("abcdefghijklmnopqrstuvwxyz ,.")
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(letters, size=chars)) for _ in range(n)]


def _http_post(url: str, payload: dict, headers=None) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=600) as r:
        require(r.status == 200, f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def _http_stream(url: str, payload: dict) -> dict:
    """One SSE completion: the joined text of choice 0 and the host-clock
    times of the send and of every data event."""
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps({**payload, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    sent = time.perf_counter()
    text, times, done = "", [], False
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                done = True
                break
            event = json.loads(line[len("data: "):])
            require("error" not in event, f"stream failed: {event}")
            times.append(time.perf_counter())
            text += "".join(c["text"] for c in event["choices"])
    require(done and times, "a stream ended without data or [DONE]")
    return {"text": text, "sent": sent, "times": times}


def _pct(values, q: float) -> float:
    """The ``q`` quantile (nearest rank) of ``values``."""
    v = sorted(values)
    return v[min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))]


def _in_threads(fn, items) -> list:
    """``fn`` over ``items`` from one client thread each, in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(items)) as pool:
        return list(pool.map(fn, items))


def http_serve(cfg, model, moe_cfg, moe_model, device=None,
               sizes=HTTP, kernels: bool = True) -> dict:
    """The port's serving plane end to end over HTTP (``phase_http_serve``
    on the card; ``device="cpu"`` with tiny models rehearses it,
    ``tests/test_torch_text_server.py``). Every
    greedy completion is held to ``tokenizer.decode`` of the engine's own
    ``generate`` of the same ids; returns the readings. ``kernels``: the
    MoE requests must launch ``gmm`` (only a card launches kernels)."""
    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.serving import storage
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.serving.text import TextGenerator

    extra = {} if device is None else {"device": device}
    storage.register_mem("chip-smoke-http", (cfg, model))
    storage.register_mem("chip-smoke-http-moe", (moe_cfg, moe_model))
    srv = ModelServer()
    t0 = time.perf_counter()
    srv.register(TextGenerator("bench", {
        **HTTP_ENGINE, **extra, "params_ref": "mem://chip-smoke-http"}))
    load_s = time.perf_counter() - t0
    tg = srv.models()["bench"]
    eng, tok = tg.engine, tg.tokenizer
    ledger = BlockLedger()
    eng.attach_block_ledger(ledger)
    srv.start()
    base = srv.url + "/openai/v1/completions"
    out: dict = {"load_s": load_s}
    try:
        alone: dict = {}

        def direct(prompt: str, new: int) -> str:
            """The engine's own greedy text for ``prompt``, run alone."""
            if (prompt, new) not in alone:
                alone[prompt, new] = tok.decode(
                    eng.generate(tok.encode(prompt), new, timeout=600))
            return alone[prompt, new]

        new = sizes["new"]
        prompts = _http_prompts(sizes["completions"], sizes["prompt_chars"],
                                SEED)
        ids = [tok.encode(p) for p in prompts]

        clocks: dict = {}  # trace id -> (client send, client receive)

        def traced_post(item):
            # the client names each request's trace (X-KFT-Trace), so its
            # row in /traces can be set beside the client's clock
            tid, p = item
            sent = time.perf_counter()
            body = _http_post(base, {"model": "bench", "prompt": p,
                                     "max_tokens": new},
                              headers={"X-KFT-Trace": f"{tid}:1:1"})
            clocks[tid] = (sent, time.perf_counter())
            return body

        def http_round():
            k = len(clocks)
            t = time.perf_counter()
            bodies = _in_threads(traced_post, [
                (f"c{k + i:05d}", p) for i, p in enumerate(prompts)])
            s = time.perf_counter() - t
            toks = sum(b["usage"]["completion_tokens"] for b in bodies)
            return [b["choices"][0]["text"] for b in bodies], toks / s

        def direct_round():
            t = time.perf_counter()
            reqs = [eng.submit(i, new) for i in ids]
            streams = [r.wait(600) for r in reqs]
            s = time.perf_counter() - t
            return ([tok.decode(x) for x in streams],
                    sum(map(len, streams)) / s)

        rounds = {"direct": [], "http": []}
        texts = {}
        for name in ("direct", "http", "http", "direct"):
            got, tps = (http_round if name == "http" else direct_round)()
            rounds[name].append(tps)
            texts.setdefault(name, got)
        want = [direct(p, new) for p in prompts]
        for name, got in texts.items():
            require(got == want, f"http_serve: {name} completions differ "
                    "from the engine's own greedy text")
        out["tokens_per_sec"] = rounds
        out["http_breakdown_ms"] = _http_breakdown(
            _http_get(srv.url + "/traces"), clocks)

        # 8 streams at once: TTFT, the gaps between events, and each
        # stream's time per output token after its first event
        streams = _in_threads(lambda p: _http_stream(base, {
            "model": "bench", "prompt": p, "max_tokens": new}),
            prompts[:sizes["streams"]])
        for p, s in zip(prompts, streams):
            require(s["text"] == direct(p, new),
                    "http_serve: a stream differs from the engine's text")
        ttft = [(s["times"][0] - s["sent"]) * 1e3 for s in streams]
        gaps = [(b - a) * 1e3 for s in streams
                for a, b in zip(s["times"], s["times"][1:])]
        tpot = [(s["times"][-1] - s["times"][0]) * 1e3 / (new - 1)
                for s in streams]
        out["stream"] = {
            "ttft_ms_p50": _pct(ttft, 0.5), "ttft_ms_p99": _pct(ttft, 0.99),
            "event_gap_ms_p50": _pct(gaps, 0.5),
            "event_gap_ms_p99": _pct(gaps, 0.99),
            "tpot_ms_p50": _pct(tpot, 0.5), "tpot_ms_p99": _pct(tpot, 0.99),
            "events_per_stream": [len(s["times"]) for s in streams]}

        # the other routes, each held to the engine's own text
        p0 = prompts[0]
        chat = [{"role": "user", "content": p0[:24]}]
        body = _http_post(srv.url + "/openai/v1/chat/completions", {
            "model": "bench", "messages": chat, "max_tokens": new})
        require(body["choices"][0]["message"]["content"]
                == direct(tg._chat_prompt(chat), new), "chat differs")
        body = _http_post(base, {"model": "bench", "prompt": p0,
                                 "max_tokens": new, "n": 2})
        require([c["text"] for c in body["choices"]] == [want[0]] * 2,
                "n: 2 differs")
        stop = want[1][2]
        body = _http_post(base, {"model": "bench", "prompt": prompts[1],
                                 "max_tokens": new, "stop": stop})
        require(body["choices"][0]["text"] == want[1].split(stop)[0]
                and body["choices"][0]["finish_reason"] == "stop",
                "stop differs")
        body = _http_post(srv.url + "/v1/models/bench:predict",
                          {"instances": [p0]})
        require(body["predictions"] == [want[0]], "V1 predict differs")
        body = _http_post(srv.url + "/v2/models/bench/infer", {
            "inputs": [{"name": "text", "shape": [1], "datatype": "BYTES",
                        "data": [prompts[2]]}]})
        require(body["outputs"][0]["data"] == [want[2]], "V2 infer differs")

        # preemption: the low class fills every slot, a high stream comes
        lows = _http_prompts(sizes["lows"], sizes["low_chars"], SEED + 1)
        high = _http_prompts(1, sizes["low_chars"], SEED + 2)[0]
        pre = tg.traffic.preemptors[0]
        preempted_at: list = []

        def watch():
            deadline = time.perf_counter() + 600
            while not preempted_at and time.perf_counter() < deadline:
                if pre.preemptions_total:
                    preempted_at.append(time.perf_counter())
                time.sleep(0.0002)

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=sizes["lows"] + 2) as pool:
            low_futs = [pool.submit(_http_post, base, {
                "model": "bench", "prompt": p, "user": "bulk",
                "max_tokens": sizes["low_new"]}) for p in lows]
            deadline = time.perf_counter() + 600
            while eng.stats()["slots_live"] < eng.num_slots:
                require(time.perf_counter() < deadline,
                        "the low class never filled the pool")
                require(not any(f.done() for f in low_futs),
                        "a low request ended before the pool was full")
                time.sleep(0.0005)
            watcher = pool.submit(watch)
            high_s = _http_stream(base, {"model": "bench", "prompt": high,
                                         "user": "gold",
                                         "max_tokens": sizes["high_new"]})
            low_texts = [f.result()["choices"][0]["text"] for f in low_futs]
            watcher.result()
        require(bool(preempted_at), "no preemption happened")
        require(high_s["text"] == direct(high, sizes["high_new"]),
                "the high request's text differs")
        require(low_texts == [direct(p, sizes["low_new"]) for p in lows],
                "a preempted request's text differs from its uninterrupted "
                "text")
        metrics = _http_get(srv.url + "/metrics")

        def gauge(name):
            m = re.search(rf'^{name}\{{model="bench"\}} (\S+)$', metrics,
                          re.M)
            require(m is not None, f"/metrics lacks {name}")
            return float(m.group(1))

        out["preempt"] = {
            "preemptions": gauge("kft_traffic_qos_preemptions_total"),
            "resumes": gauge("kft_traffic_qos_preempt_resumes_total"),
            "preempt_to_high_first_token_ms":
                (high_s["times"][0] - preempted_at[0]) * 1e3,
            "high_ttft_ms": (high_s["times"][0] - high_s["sent"]) * 1e3}
        require(out["preempt"]["preemptions"] >= 1
                and out["preempt"]["resumes"] >= 1,
                f"preemption counters {out['preempt']}")
        for prefix in ("kft_engine_", "kft_traffic_", "kft_trace_"):
            require(re.search(rf"^# TYPE {prefix}", metrics, re.M)
                    is not None, f"/metrics has no {prefix}* family")

        # /traces: a streamed request's phases, and the preempted victims
        rows = [json.loads(ln) for ln in
                _http_get(srv.url + "/traces").splitlines()]
        rows = [r for r in rows if r["root"]["name"] == "request"]
        streamed = [[p["name"] for p in r["phases"]] for r in rows
                    if r["phases"]
                    and (r["phases"][0].get("attrs") or {}).get("stream")]
        require(bool(streamed) and all(
            names[:4] == STREAM_PHASES for names in streamed),
            f"streamed phases {streamed[:2]}")
        out["preempt"]["victims_traced"] = sum(
            1 for r in rows if "engine.preempted"
            in [p["name"] for p in r["phases"]])
        require(out["preempt"]["victims_traced"] >= 1,
                "no trace shows engine.preempted")
        deadline = time.perf_counter() + 60
        while eng.stats()["kv_blocks_free"] != eng.stats()["kv_blocks_total"]:
            require(time.perf_counter() < deadline, "blocks never came back")
            time.sleep(0.01)
        out["clean"] = _require_clean("http_serve", ledger, eng)

        # the MoE bench model behind the same server: gmm must launch
        # under the HTTP requests
        srv.register(TextGenerator("moe", {
            **HTTP_ENGINE, **extra, "params_ref": "mem://chip-smoke-http-moe"}))
        moe_eng = srv.models()["moe"].engine
        moe_prompts = _http_prompts(sizes["moe"], sizes["prompt_chars"],
                                    SEED + 3)
        for c in _counters():
            for key in c:
                c[key] = 0
        moe_bodies = _in_threads(lambda p: _http_post(base, {
            "model": "moe", "prompt": p, "max_tokens": 16}), moe_prompts)
        launches = {k: v for c in _counters() for k, v in c.items()}
        require(all(b["usage"]["completion_tokens"] == 16
                    for b in moe_bodies), "short MoE completions")
        require(not kernels or launches["gmm"] > 0,
                "the MoE requests launched no gmm")
        require(moe_eng.stats()["graph_captures_total"] == 0,
                "MoE captures after warmup")
        out["moe"] = {"launches": launches,
                      "gmm_under_http": _gmm_under_http(base, moe_prompts)
                      if kernels else None}
    finally:
        srv.stop()
    return out


def _http_breakdown(traces: str, clocks: dict) -> dict:
    """Where an HTTP completion's time goes, median and max over the
    requests in ``clocks`` (trace id -> client send and receive times on
    this process's clock): ``accept`` from the client's send to the door
    (connection, request parse), each phase of its trace, and ``respond``
    from the last token's delivery to the client's receipt of the body."""
    parts: dict = {}
    for row in map(json.loads, filter(None, traces.splitlines())):
        if row["trace_id"] not in clocks:
            continue
        sent, got = clocks[row["trace_id"]]
        start = row["root"]["start_s"]
        phases = {}
        ended = start
        for p in row["phases"]:
            # the decode phase stays open until the response is written;
            # its last_token_s marks the last token's delivery
            end = (p.get("attrs") or {}).get(
                "last_token_s", p["start_s"] + p["duration_s"])
            phases[p["name"]] = phases.get(p["name"], 0.0) + end - p["start_s"]
            ended = max(ended, end)
        for name, sec in [("accept", start - sent), *phases.items(),
                          ("respond", got - ended), ("total", got - sent)]:
            parts.setdefault(name, []).append(sec * 1e3)
    require(len(parts.get("total", ())) == len(clocks),
            "an HTTP completion left no trace")
    return {k: {"p50": _pct(v, 0.5), "max": max(v)} for k, v in parts.items()}


def _http_get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def _gmm_under_http(base: str, prompts) -> dict:
    """gmm's device time a launch under the MoE HTTP requests, from the
    profiler's CUDA activity (the launches are CUDA-graph replays, out of
    reach of events); "not measured" when it reports no device time."""
    import torch

    from kubeflow_tpu_torch.train.profile import _device_us

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _in_threads(lambda p: _http_post(base, {
            "model": "moe", "prompt": p, "max_tokens": 16}), prompts)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "gmm_kernel" in e.key]
    calls = sum(e.count for e in rows)
    dev_us = sum(_device_us(e) for e in rows)
    if not calls or not dev_us:
        return {"ms": "not measured", "calls": calls}
    return {"ms": dev_us / calls / 1e3, "calls": calls}


def phase_http_serve(line: str) -> dict:
    """The serving plane over HTTP (``http_serve``) on the 271M bench model
    at full width and depth, then the MoE bench model behind the same
    server; every number printed beside the card's name and power
    limit."""
    cfg, model = _serve_model("bench_model")
    moe_cfg, moe_model = _serve_model("bench_moe_model")
    r = http_serve(cfg, model, moe_cfg, moe_model)
    emit("http_serve", card=line, model="bench_model",
         moe_model="bench_moe_model", engine=HTTP_ENGINE, requests=HTTP,
         accept_ms={k: r["http_breakdown_ms"]["accept"][k]
                    for k in ("p50", "max")},
         accept_ms_pr10=ACCEPT_MS_PR10, **r)
    return r


#: the InferenceService phase (``isvc_serve``): HTTP_ENGINE's knobs without
#: the QoS classes (no preemption here), with prefix-affinity routing at the
#: Router (blocks of 16 tokens)
ISVC_ENGINE = {**{k: v for k, v in HTTP_ENGINE.items() if k != "qos"},
               "affinity_block": 16}
#: request mix: 16 completions (48 characters, 32 new) through the Router,
#: 4 prompts sharing a 64-character prefix, 32 requests across a 50% canary
#: (a revision of one replica and min_replicas 0), 4 after its promote, one
#: request from zero replicas, 8 token prompts of mixed length through
#: ``LlamaGenerator`` (16 new), 4 through the MoE ``llama-continuous``
ISVC = dict(completions=16, prompt_chars=48, new=32, affinity=4,
            prefix_chars=64, canary=32, canary_pct=50, zero_new=16,
            llm_lengths=(5, 17, 33, 64, 100, 128, 200, 300), llm_new=16,
            moe=4, moe_len=40, moe_new=16)
#: PR 10's accept readings (client send to the replica's door), ms, p50 and
#: max, NVIDIA H100 80GB HBM3 at 700 W: the listen backlog of 5 (ROADMAP C5)
ACCEPT_MS_PR10 = {"p50": "368.2-409.0", "max": "1373.7-1431.4"}


def _isvc_wait(cluster, name: str, cond, what: str, timeout: float = 600):
    """The InferenceService ``name`` once ``cond(isvc)`` holds."""
    deadline = time.perf_counter() + timeout
    while True:
        isvc = cluster.store.try_get("InferenceService", name)
        if isvc is not None and cond(isvc):
            return isvc
        require(isvc is None or str(isvc.status.phase.value) != "Failed",
                f"isvc_serve: {name} failed: {isvc and isvc.status.message}")
        require(time.perf_counter() < deadline,
                f"isvc_serve: {name} never {what}: "
                f"{isvc and isvc.status}")
        time.sleep(0.1)  # a store read copies the object: poll gently


def _post_through_activation(url: str, payload: dict) -> tuple[dict, int]:
    """(body, 503s seen): a client of a scaled-to-zero service. The Router's
    activator answers 503 with Retry-After when no replica is ready within
    its wait; the client sleeps as told and sends again."""
    import urllib.error

    sheds = 0
    while True:
        try:
            return _http_post(url, payload), sheds
        except urllib.error.HTTPError as e:
            require(e.code == 503 and sheds < 20,
                    f"isvc_serve: {url}: HTTP {e.code}")
            sheds += 1
            time.sleep(float(e.headers.get("Retry-After") or 1))


def _router_requests(url: str) -> dict:
    """Requests per backend from the Router's /metrics."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r'^kft_router_backend_requests\{backend="([^"]+)"\} (\d+)$',
        _http_get(url + "/metrics"), re.M)}


def isvc_serve(cfg, model, moe_cfg, moe_model, device=None, sizes=ISVC,
               kernels: bool = True) -> dict:
    """InferenceServices applied to the port's own control plane
    (``phase_isvc_serve`` on the card; ``device="cpu"`` with tiny models
    rehearses it). Every greedy text through a Router is held to the
    serving engine's own ``generate`` of the same ids; returns the
    readings. ``kernels``: the MoE service must launch ``gmm``."""
    import gc

    import numpy as np
    import torch

    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.api import from_dict
    from kubeflow_tpu_torch.controlplane import Cluster
    from kubeflow_tpu_torch.serving import storage
    from kubeflow_tpu_torch.serving.controller import (
        InferenceServiceController,
    )

    extra = {} if device is None else {"device": device}
    cuda = device is None
    if cuda:
        # cuBLAS keeps a workspace for every (handle, stream) pair it saw,
        # allocated through the caching allocator and never freed with the
        # stream (each engine's stream and request thread leaves one):
        # device memory is read with them cleared, here and at the end
        torch._C._cuda_clearCublasWorkspaces()
        gc.collect()
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    started = time.perf_counter()
    steps: dict = {}

    def step(name):
        steps[name] = time.perf_counter() - started - sum(steps.values())
    keys = {"bench": "chip-smoke-isvc", "moe": "chip-smoke-isvc-moe"}
    storage.register_mem(keys["bench"], (cfg, model))
    storage.register_mem(keys["moe"], (moe_cfg, moe_model))
    cluster = Cluster()
    cluster.enable_serving()
    cluster.start()
    ctl = next(x for x in cluster.controllers
               if isinstance(x, InferenceServiceController))
    out: dict = {}
    #: every replica engine seen, by service, and one ledger a service
    engines: dict = {}
    ledgers: dict = {}
    routers: dict = {}

    def apply(name, fmt, config, spec=None, **pred):
        obj = from_dict({"kind": "InferenceService",
                         "metadata": {"name": name},
                         "spec": {"predictor": {
                             "model_format": {"name": fmt},
                             "config": {**config, **extra}, **pred},
                             **(spec or {})}})
        cluster.store.create(obj)

    def replicas(name, revision="stable"):
        dep = ctl._deployments[f"default/{name}"]
        return list(getattr(dep, revision).predictors)

    def adopt(name, revision="stable"):
        """Audit every new replica engine of ``name`` (before traffic)."""
        ledger = ledgers.setdefault(name, BlockLedger())
        for srv in replicas(name, revision):
            eng = srv.models()[name].engine
            if all(eng is not e for e in engines.setdefault(name, [])):
                eng.attach_block_ledger(ledger)
                engines[name].append(eng)
        routers[name] = ctl._deployments[f"default/{name}"].router

    def teardown(name):
        out.setdefault("clean", {})[name] = _require_clean(
            f"isvc_serve {name}", ledgers[name], *engines[name])
        url = cluster.store.get("InferenceService", name).status.url
        cluster.store.delete("InferenceService", name)
        router = routers.pop(name)
        deadline = time.perf_counter() + 120
        while f"default/{name}" in ctl._deployments or router.backends():
            require(time.perf_counter() < deadline,
                    f"isvc_serve: {name} never torn down (Router backends "
                    f"{router.backends()})")
            time.sleep(0.02)
        try:
            _http_get(url + "/metrics")
            require(False, f"isvc_serve: {name}'s Router still answers")
        except OSError:
            pass
        engines.pop(name)
        ledgers.pop(name)

    try:
        # 1. text-llm, 2 replicas behind the Router
        t0 = time.perf_counter()
        apply("text-llm", "text-llm", {**ISVC_ENGINE,
                                       "params_ref": f"mem://{keys['bench']}"},
              min_replicas=2, max_replicas=2)
        isvc = _isvc_wait(cluster, "text-llm", lambda o: str(
            o.status.phase.value) == "Ready" and o.status.active_replicas == 2,
            "Ready with 2 replicas")
        out["text_llm_ready_s"] = time.perf_counter() - t0
        step("text_llm_ready")
        adopt("text-llm")
        router_url = isvc.status.url
        reps = replicas("text-llm")
        tg = reps[0].models()["text-llm"]
        eng, tok = tg.engine, tg.tokenizer
        warm = [json.loads(ln) for ln in _http_get(
            reps[0].url + "/traces").splitlines()]
        warm = [r for r in warm if r["root"]["name"] == "warmup"]
        require(len(warm) == 1, "no warmup trace on a replica")
        out["warmup_s"] = warm[0]["duration_s"]
        by_family: dict = {}
        for sp in warm[0]["spans"]:  # one span a program shape captured
            fam = (sp.get("attrs") or {}).get("family", sp["name"])
            n, sec = by_family.get(fam, (0, 0.0))
            by_family[fam] = (n + 1, sec + sp["duration_s"])
        out["warmup_captures"] = {f: {"programs": n, "s": sec}
                                  for f, (n, sec) in by_family.items()}
        alone: dict = {}

        def direct(prompt: str, new: int) -> str:
            if (prompt, new) not in alone:
                alone[prompt, new] = tok.decode(
                    eng.generate(tok.encode(prompt), new, timeout=600))
            return alone[prompt, new]

        def directs(qs, new: int) -> list[str]:
            """``direct`` of each prompt, submitted together: under the
            first attend rung with the prefix cache off, a request runs the
            same programs whatever shares the pool."""
            reqs = {q: eng.submit(tok.encode(q), new) for q in qs
                    if (q, new) not in alone}
            for q, r in reqs.items():
                alone[q, new] = tok.decode(r.wait(600))
            return [alone[q, new] for q in qs]

        new = sizes["new"]
        prompts = _http_prompts(sizes["completions"], sizes["prompt_chars"],
                                SEED + 10)
        ids = [tok.encode(q) for q in prompts]
        clocks: dict = {}

        def completion(url, q, tid=None):
            sent = time.perf_counter()
            body = _http_post(url + "/openai/v1/completions", {
                "model": "text-llm", "prompt": q, "max_tokens": new},
                headers={"X-KFT-Trace": f"{tid}:1:1"} if tid else None)
            if tid:
                clocks[tid] = (sent, time.perf_counter())
            return body

        def http_round(url, traced):
            k = len(clocks)
            t = time.perf_counter()
            bodies = _in_threads(lambda item: completion(url, *item), [
                (q, f"i{k + i:05d}" if traced else None)
                for i, q in enumerate(prompts)])
            sec = time.perf_counter() - t
            toks = sum(b["usage"]["completion_tokens"] for b in bodies)
            return [b["choices"][0]["text"] for b in bodies], toks / sec

        def direct_round():
            t = time.perf_counter()
            streams = [r.wait(600) for r in [eng.submit(i, new)
                                              for i in ids]]
            sec = time.perf_counter() - t
            return ([tok.decode(x) for x in streams],
                    sum(map(len, streams)) / sec)

        rounds: dict = {"direct": [], "replica": [], "router": []}
        for name in ("direct", "replica", "router", "router", "replica",
                     "direct"):
            got, tps = (direct_round() if name == "direct" else http_round(
                router_url if name == "router" else reps[0].url,
                traced=name == "router"))
            rounds[name].append(tps)
            require(got == directs(prompts, new),
                    f"isvc_serve: {name} completions differ from the "
                    "engine's own greedy text")
        out["tokens_per_sec"] = rounds
        rows = "\n".join(_http_get(r.url + "/traces") for r in reps)
        out["replica_breakdown_ms"] = _http_breakdown(rows, clocks)
        out["router_breakdown_ms"] = _http_breakdown(
            _http_get(router_url + "/traces"), clocks)
        out["accept_ms_pr10"] = ACCEPT_MS_PR10
        out["requests_per_backend"] = _router_requests(router_url)
        require(len(out["requests_per_backend"]) == 2 and all(
            out["requests_per_backend"].values()),
            f"isvc_serve: both replicas must serve: "
            f"{out['requests_per_backend']}")

        # affinity: prompts sharing a prefix land on one replica
        prefix = _http_prompts(1, sizes["prefix_chars"], SEED + 11)[0]
        tails = _http_prompts(sizes["affinity"], 8, SEED + 12)
        before = _router_requests(router_url)
        for tail in tails:
            body = completion(router_url, prefix + tail)
            require(body["choices"][0]["text"] == direct(prefix + tail, new),
                    "isvc_serve: an affinity request's text differs")
        delta = {b: n - before.get(b, 0)
                 for b, n in _router_requests(router_url).items()}
        out["affinity_per_backend"] = delta
        require(sorted(delta.values()) == [0, sizes["affinity"]],
                f"isvc_serve: shared-prefix requests split {delta}")
        step("completions_and_affinity")

        # 2. canary: a second revision (decode_chunk 2: the same tokens),
        # one replica that may scale to zero once it is promoted
        t0 = time.perf_counter()

        def rollout(o):
            merged = o.spec.model_dump(mode="json")
            merged["predictor"]["config"]["decode_chunk"] = 2
            merged["predictor"]["min_replicas"] = 0
            merged["predictor"]["max_replicas"] = 1
            merged["canary_traffic_percent"] = sizes["canary_pct"]
            o.spec = type(o.spec).model_validate(merged)
        cluster.store.update_with_retry("InferenceService", "text-llm",
                                        "default", rollout)
        isvc = _isvc_wait(cluster, "text-llm", lambda o: (
            o.status.canary_revision is not None
            and str(o.status.phase.value) == "Ready"
            and o.status.active_replicas == 3), "canary Ready")
        out["canary_ready_s"] = time.perf_counter() - t0
        adopt("text-llm", "canary")
        canary_urls = {r.url for r in replicas("text-llm", "canary")}
        before = _router_requests(router_url)
        cq = _http_prompts(sizes["canary"], sizes["prompt_chars"], SEED + 13)
        bodies = _in_threads(lambda q: completion(router_url, q), cq)
        require([b["choices"][0]["text"] for b in bodies]
                == directs(cq, new),
                "isvc_serve: a text differs across the canary split")
        delta = {b: n - before.get(b, 0)
                 for b, n in _router_requests(router_url).items()}
        share = sum(n for b, n in delta.items()
                    if b in canary_urls) / sizes["canary"]
        out["canary"] = {"share": share, "per_backend": delta}
        require(0.3 <= share <= 0.7, f"isvc_serve: canary share {share}")

        # promote: the canary becomes the stable revision
        def promote(o):
            o.spec.canary_traffic_percent = None
        cluster.store.update_with_retry("InferenceService", "text-llm",
                                        "default", promote)
        isvc = _isvc_wait(cluster, "text-llm", lambda o: (
            o.status.canary_revision is None
            and o.status.stable_revision == 2
            and o.status.active_replicas <= 1), "promoted")
        texts = [_post_through_activation(
            router_url + "/openai/v1/completions",
            {"model": "text-llm", "prompt": q, "max_tokens": new})[0][
                "choices"][0]["text"] for q in prompts[:4]]
        require(texts == directs(prompts[:4], new),
                "isvc_serve: a text differs after the promote")
        step("canary_and_promote")

        # 3. scale from zero: the promoted revision idles to no replica;
        # one request then waits for a load, a warmup and its tokens
        _isvc_wait(cluster, "text-llm",
                   lambda o: o.status.active_replicas == 0,
                   "scaled to zero", timeout=120)
        zq = _http_prompts(1, sizes["prompt_chars"], SEED + 14)[0]
        t0 = time.perf_counter()
        body, sheds = _post_through_activation(
            router_url + "/openai/v1/completions",
            {"model": "text-llm", "prompt": zq,
             "max_tokens": sizes["zero_new"]})
        out["scale_from_zero_s"] = time.perf_counter() - t0
        out["scale_from_zero_503s"] = sheds
        out["requests_per_backend_end"] = _router_requests(router_url)
        adopt("text-llm")
        ztg = replicas("text-llm")[0].models()["text-llm"]
        require(body["choices"][0]["text"] == ztg.tokenizer.decode(
            ztg.engine.generate(ztg.tokenizer.encode(zq),
                                sizes["zero_new"], timeout=600)),
                "isvc_serve: the text from zero differs")
        del ztg, tg, eng, reps, isvc
        teardown("text-llm")
        step("scale_from_zero_and_teardown")

        # 4. llm: LlamaGenerator, one padded prefill and a decode loop
        rng = np.random.default_rng(SEED + 15)
        tprompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                    for n in sizes["llm_lengths"]]
        t0 = time.perf_counter()
        apply("llm", "llm", {"params_ref": f"mem://{keys['bench']}",
                             "max_new_tokens": sizes["llm_new"]})
        lurl = _isvc_wait(cluster, "llm", lambda o: str(
            o.status.phase.value) == "Ready", "Ready").status.url
        out["llm_ready_s"] = time.perf_counter() - t0
        lpath = lurl + "/v1/models/llm:predict"
        _http_post(lpath, {"instances": tprompts})  # the first pays set-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = _http_post(lpath, {"instances": tprompts})["predictions"]
            times.append(time.perf_counter() - t0)
        want = []
        with torch.no_grad():
            for q in tprompts:  # the plain forward's greedy decode
                seq = list(q)
                for _ in range(sizes["llm_new"]):
                    logits = model(torch.tensor([seq], device=model.embedder
                                                .embedding.device))
                    seq.append(int(logits[0, -1].argmax()))
                want.append(seq[len(q):])
        diffs = _first_difference(cfg, model, tprompts, got, want) \
            if cuda else [d for d in ({"prompt": i} for i, (a, b) in
                                      enumerate(zip(got, want)) if a != b)]
        if cuda:
            _require_streams("isvc_serve llm", diffs)
        else:
            require(not diffs, f"isvc_serve llm: tokens differ {diffs}")
        ms = min(times) * 1e3
        out["llm"] = {"ms_per_request": ms,
                      "ms_per_token": ms / sizes["llm_new"],
                      "request_s": times, "instances": len(tprompts),
                      "prompt_lengths": list(sizes["llm_lengths"]),
                      "differences": diffs}
        cluster.store.delete("InferenceService", "llm")
        step("llm")

        # 5. llama-continuous on the MoE bench model: gmm on this path
        apply("moe", "llama-continuous", {
            **{k: v for k, v in ISVC_ENGINE.items()
               if k not in ("tracing", "affinity_block")},
            "params_ref": f"mem://{keys['moe']}",
            "max_new_tokens": sizes["moe_new"]})
        murl = _isvc_wait(cluster, "moe", lambda o: str(
            o.status.phase.value) == "Ready", "Ready").status.url
        adopt("moe")
        meng = engines["moe"][0]
        mq = [rng.integers(1, moe_cfg.vocab_size,
                           size=sizes["moe_len"]).tolist()
              for _ in range(sizes["moe"])]
        for c in _counters():
            for key in c:
                c[key] = 0
        mgot = _in_threads(lambda q: _http_post(
            murl + "/v1/models/moe:predict", {"instances": [q]})[
                "predictions"][0], mq)
        launches = {k: v for c in _counters() for k, v in c.items()}
        require(not kernels or launches["gmm"] > 0,
                "isvc_serve: the MoE service launched no gmm")
        require(mgot == [meng.generate(q, sizes["moe_new"], timeout=600)
                         for q in mq],
                "isvc_serve: an MoE text differs from the engine's own")
        out["moe"] = {"launches": launches}
        del meng
        teardown("moe")
        step("moe")
        out["step_s"] = steps
    except BaseException:
        emit("isvc_serve_partial", **out)  # what was read before the miss
        raise
    finally:
        for name in list(engines):
            try:
                cluster.store.delete("InferenceService", name)
            except Exception:  # noqa: BLE001 — already gone
                pass
        engines.clear()
        ledgers.clear()
        routers.clear()
        cluster.stop()
        for key in keys.values():
            storage._MEM_REGISTRY.pop(key, None)
    if cuda:
        gc.collect()
        out["memory_after_delete_mib"] = (
            torch.cuda.memory_allocated() - mem0) / 2**20
        deadline = time.perf_counter() + 60
        while True:  # a drained replica stops on its own thread
            torch._C._cuda_clearCublasWorkspaces()
            gc.collect()
            grown = torch.cuda.memory_allocated() - mem0
            if grown < 64 << 20 or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
        out["memory_after_delete_cublas_cleared_mib"] = grown / 2**20
        if grown >= 64 << 20:
            emit("isvc_serve_partial", **out)
        require(grown < 64 << 20,
                f"isvc_serve: {grown / 2**20:.1f} MiB still allocated")
    return out


def phase_isvc_serve(line: str) -> dict:
    """InferenceServices on the port's control plane (``isvc_serve``): the
    271M bench model at full width and depth (text-llm behind a Router,
    a canary, scale from zero, ``LlamaGenerator``) and the MoE bench model
    (``llama-continuous``); every number beside the card's name and power
    limit."""
    cfg, model = _serve_model("bench_model")
    moe_cfg, moe_model = _serve_model("bench_moe_model")
    r = isvc_serve(cfg, model, moe_cfg, moe_model)
    emit("isvc_serve", card=line, model="bench_model",
         moe_model="bench_moe_model", engine=ISVC_ENGINE, requests=ISVC,
         **r)
    return r


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    # outside a checkout of the repo this fails before anything is printed
    import kubeflow_tpu_torch  # noqa: F401

    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = phase_env()
    phase_build()
    max_abs = phase_kernels_check()
    times = {**phase_kernels_time(), **phase_grouped_time()}
    phase_moe_no_sync()
    launches = train_slice("slice", "bench_model", FLASH_PER_LAYER)
    parity_on_card("parity_on_card")
    moe_launches = train_slice("moe_slice", "bench_moe_model", MOE_PER_LAYER)
    parity_on_card("moe_parity_on_card", moe_experts=4, moe_top_k=2,
                   moe_dispatch="ragged")
    phase_step_no_sync()
    phase_serve_gmm_time()
    phase_serve()
    phase_serve_variants()
    phase_moe_serve()
    t0 = time.perf_counter()
    phase_spec_serve()
    phase_moe_spec_serve()
    phase_prefix_serve()
    t1 = time.perf_counter()
    phase_migrate_serve()
    phase_moe_migrate_serve()
    phase_hibernate_serve()
    phase_host_tier_serve()
    phase_disagg_serve()
    t2 = time.perf_counter()
    phase_http_serve(line)
    t_isvc = time.perf_counter()
    phase_isvc_serve(line)
    t_http = time.perf_counter()
    work = tempfile.mkdtemp(prefix="kft-finetune-")
    try:
        ft = phase_finetune(work, line)
        t3 = time.perf_counter()
        phase_adafactor_step(ft["base"], line)
        t4 = time.perf_counter()
        phase_finetune_serve(ft["base"], ft["adapter"], line)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    now = time.perf_counter()
    emit("phase_seconds", total=now - started,
         speculation_and_prefix=t1 - t0, migration_and_tiers=t2 - t1,
         http_serve=t_isvc - t2, isvc_serve=t_http - t_isvc,
         finetune=t3 - t_http, adafactor_step=t4 - t3, finetune_serve=now - t4)
    # each kernel's launches from the run of the path that carries it
    launches.update(gmm=moe_launches["gmm"], tgmm=moe_launches["tgmm"])
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
