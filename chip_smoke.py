#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kubeflow_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

First runs the port's lint, device-free (``lint``: the analyzer's
self-test and its ratchet over this checkout, each in a subprocess). Then
builds the hand-written Hopper kernels (flash attention K1-K3, grouped GEMM
K4a/K4b) from ``kubeflow_tpu_torch/ops/csrc`` into ``build/kernels/``,
checks in their SASS that every kernel runs on wgmma and TMA and that no
kernel spills, holds each kernel against its plain f32 version (outputs in
NaN-poisoned memory, each kernel launched twice for bitwise equality; the
ring's block shape with the lse cotangent folded into delta among them),
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
checked and timed at the serving shapes; ``serve`` and ``moe_serve`` hold
the engine's ``stats()`` to the metrics contract with
``audit_stats_pair``); then speculation and prefix reuse
(``spec_serve``, ``moe_spec_serve``, ``prefix_serve``) and moving and
storing sequences (``migrate_serve``, ``moe_migrate_serve``,
``hibernate_serve`` with a ``LockAudit`` over the locks its threads share,
``host_tier_serve``, ``disagg_serve``), a snapshot with bf16 parameters
(``bf16_snapshot_serve``: the bench model saved by the port in bf16, its
``config.json`` saying so, served bitwise as the same weights cast at
load, each engine's peak memory beside the f32 engine's), and the
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
against the same model unquantized; ``corpus_train`` runs the pod entry on
that base fed a packed ~4M-token corpus through the native loader (every
batch held to ``PackedLmCorpus``, K1-K3 counted), and ``hpo_sweep`` runs
an HPO experiment on that base: a ``bayesianoptimization`` sweep of the
LoRA's learning rate on ``LocalPlatform``, submitted with the CLI, its
trials pod processes on the card, the best trial run once more in this
process with its K1-K3 counted. Then the platform's
other workloads: ``bert_serve`` (BERT-base behind ``BertClassifierModel``
and ``kft-bert`` InferenceServices from ``mem://`` and a snapshot, a 2-layer
cut held against the CPU), ``resnet_train`` (ResNet-50 at 224 x 224, batch
128, bf16, channels_last; one tiny step held against the CPU),
``jaxjob_pods`` (MNIST and ResNet-50 JaxJobs as real pod processes on the
card through the port's ``LocalKubelet``, on a GPU host built from the
machine's cards, each pod's log naming the card it was given; a job asking
more cards than the host has stays Pending with the scheduler's reason and
is deleted) and ``darts_search`` (the DARTS
supernet at the bench model's width on K1-K3; one small step pair held
against the CPU), then ``nas_experiment`` (a ``darts`` experiment whose
suggestion service trains the same supernet in this process and whose
trials train the suggested shapes in pods). The parallel layouts and
multi-GPU serving run in a second process on the same card (``--track``),
started after ``moe_serve`` and joined at the end: each of them is two or
more processes over gloo that leave the card idle most of the time, so
the kernel, training and serving readings before it are taken with the
card to themselves, and what is timed after it is read with both tracks
running. Its lines follow the main sequence's. Once it has started, the
main sequence runs Llama-2 7B (6.74B parameters, bf16, built on the card
in bf16 with no f32 copy): ``llama7b_job`` writes its base snapshot
(13.48 GB), reads it back bit for bit and runs the pod entry
``train_main`` on it as ``finetune`` does on llama_1b (a rank-8 LoRA at
8 x 2048, f32 adapters over the bf16 base, adapter-only checkpoints, a
resume at step 4, the adapter published; 64/32/32 K1/K2/K3 launches a
step). The track's last phases serve what it wrote: ``tp7b_serve`` the
base's first 8 layers at full width behind a two-rank ``{"model": 2}``
gang, and ``llama7b_serve`` the base with the published adapter merged,
through ``LlamaGenerator`` and the engine's slot and paged pools
(streams teacher-forced, paged equal to slot, the decode roofline's
share). In that track:
``mesh_train`` (the bench model on ``{"fsdp": 2}`` and ``{"model": 2}``, two
ranks sharing the card over gloo, 3 steps each against the same steps
unsharded; K1-K3 counted on every rank, 4 query heads under ``model: 2``),
then sequence and pipeline parallelism: ``seq_train`` (the bench model on
``{"seq": 2}`` with ring attention on K1-K3, the non-causal K1 counted)
and ``pipeline_train`` (the bench model on ``{"pipeline": 2}`` under
GPipe, 1F1B and interleaved 1F1B), each two ranks sharing the card over
gloo against the same steps unsharded, ``mesh_more_train`` (the layouts
the port laid out last, 2 steps each against their own unsharded steps:
a rank-8 LoRA on ``{"model": 2}`` from a base snapshot, its
adapters-only checkpoint reloaded on one rank, and the int8 bench model
laid out on ``{"model": 2}`` and teacher-forced on the unsharded int8
engine's streams; the MoE bench model's capacity dispatch on
``{"expert": 2}``; Adafactor on ``{"fsdp": 2}`` and ``{"model": 2}``;
GPipe and 1F1B on ``{"pipeline": 2, "fsdp": 2}``, four ranks; the
two-rank layouts in one spawn, the four-rank ones in another), then
multi-GPU serving: ``wire_migrate``, ``tp_serve``, ``moe_tp_serve``,
``moe_ep_serve``, ``tp_resize`` (below), ``tp7b_serve`` and
``llama7b_serve``. The main
sequence ends with the rest of the parallel phases (``MAIN_TAIL_PHASES``,
beside the track's gangs): ``nccl_one_rank`` (a one-rank NCCL group
through ``bootstrap``, then FSDP2 over it on a one-rank ``fsdp`` mesh),
``nccl_graph_capture`` (below), ``moe_mesh_train`` (the MoE bench model on
``{"expert": 2}``, routing pinned to the unsharded run's, K4a/K4b and the
count matrix's host copies counted), ``ring_attention_check`` (ring and
Ulysses attention over a two-rank ring at the bench attention shape
against ``flash_attention`` and the plain attention on the whole
sequence) and ``dist_pods`` (``examples/02`` as one worker of two cards,
whose pod runs two local ranks, and a two-worker ``examples/01``, as pod
processes on the card, every rank's ``loss=`` lines equal) and ``dryrun``
(``parallel.dryrun`` at four ranks over gloo: a training step on each
layout leg, every rank's loss equal, and the ``{"model": 2}`` and
``{"expert": 2, "model": 2}`` serving legs' tokens against one engine's).
Multi-GPU serving (``tp_gmm_time``, K4a at the experts' shapes under
``{"model": 2}``, K 1024 -> N 1408 and K 1408 -> N 1024, and
``ep_gmm_time``, the same over an expert-parallel rank's window of the
sorted rows, rows of no group on both sides, checked and timed, run in
the main sequence after ``serve_gmm_time``): ``nccl_graph_capture``
(a one-rank NCCL group: a CUDA graph holding the tensor-parallel
all-reduce and all-gather, and the serving engine with its collectives
forced on, every program captured), ``tp_serve`` and ``moe_tp_serve`` (the
bench models behind a two-rank serving gang at ``{"model": 2}`` through
``serve_main`` and ``ModelServer``, ranks sharing the card over gloo, every
program output of rank 1 held bitwise against rank 0's, greedy streams
against the unsharded engine's), ``moe_ep_serve`` (the MoE bench model
behind a four-rank gang at ``{"expert": 2, "model": 2}``, held as
``moe_tp_serve`` is, every rank's K4a counted, no count-matrix host
copy), ``wire_migrate`` (``DisaggregatedPool(
wire=True)``, ``migrate_sequence`` between two engines, and a TP=2 gang's
export imported by an unsharded engine) and ``tp_resize`` (a live TP=2 gang
shrunk to 1 and grown back to 2 with a stream open, each resize the
autoscaler's decision posted to rank 0's resize route). Every served greedy
stream is also fed back through the plain model (teacher forcing): its
tokens must be the model's top or within the near-tie bound of it (an MoE
model's also under one near-tie routing flip). ``isvc_serve`` and
``tp_resize`` boot their engines through the program-artifact cache
(``aot``, a fresh root under ``build/``): the text-llm wake from zero, a
second boot of the MoE service and the grow-back (both ranks) must find
every program record and kernel library there, and a third MoE engine
meets one torn record and a torn tgmm library, which it must count and
republish; ``aot_boots`` prints the cold and warm boots by part. Each
phase prints one JSON
line; the line before the last is the card's name and power limit from
nvidia-smi, the last line is ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero before that line. Needs a CUDA card; imports
nothing of jax or kubeflow_tpu.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types
from typing import Optional

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
#: Llama-2 7B's in ``llama7b_job``: 8 x 2048, h = kv = 32
LLAMA2_7B_ATTN = dict(b=8, s=2048, h=32, kv=32, d=128)
#: a ring block of the bench shape on a two-rank ``seq`` axis: 512 queries
#: against 512 keys, causal on the diagonal, non-causal for an earlier block
RING_BLOCK = dict(BENCH, s=BENCH["s"] // 2)
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


def lint_run(root: str) -> dict:
    """The port's lint on the checkout at ``root``, device-free, each step
    in a subprocess: ``python -m kubeflow_tpu_torch.analysis --self-test``
    (every rule's true-positive and near-miss fixtures), then the ratchet
    (``--json``: the whole port's findings against its ``baseline.json``).
    Returns each step's exit code, seconds and counts."""
    out = {}
    for step, argv in (("self_test", ["--self-test"]),
                       ("ratchet", ["--json"])):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "kubeflow_tpu_torch.analysis", *argv],
            cwd=root, capture_output=True, text=True, timeout=300)
        row = {"rc": p.returncode, "seconds": time.perf_counter() - t0}
        if step == "self_test":
            m = re.search(r"self-test: (\d+)/(\d+) fixtures green", p.stdout)
            row["fixtures_green"] = (f"{m.group(1)}/{m.group(2)}" if m
                                     else None)
        elif p.returncode in (0, 1):
            rep = json.loads(p.stdout)
            row.update(findings=rep["total"], by_rule=rep["by_rule"],
                       baselined=rep["baseline_total"],
                       new=[f"{f['path']}:{f['line']}: {f['rule']}"
                            for f in rep["new"]],
                       lint_s=rep["elapsed_s"])
        if p.returncode != 0:
            row["output"] = (p.stdout + p.stderr)[-4000:]
        out[step] = row
    return out


def phase_lint(line: str) -> dict:
    """``lint_run`` on this checkout; both steps must exit 0 (every fixture
    green, no finding above the baseline)."""
    import os

    r = lint_run(os.path.dirname(os.path.abspath(__file__)))
    emit("lint", card=line, **r)
    for step, row in r.items():
        require(row["rc"] == 0, f"lint {step}: exit {row['rc']}: "
                f"{row.get('output', '')}")
    return r


def _cuobjdump(*args: str) -> str:
    from pathlib import Path

    from kubeflow_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), *args], check=True, capture_output=True,
                          text=True).stdout


def phase_build() -> float:
    """Builds every kernel library (returns the seconds that took), then
    reads what was compiled: the SASS
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
    return seconds


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


def check_kernels_case(b, s, h, kv, d, causal, gen, fold_lse: bool = False
                       ) -> dict[str, float]:
    """Each kernel against its plain version on the same bf16 inputs, its
    outputs written into NaN-poisoned memory; then each kernel again on the
    same inputs, which must give the same bits (one owner per output
    element, no atomics). ``fold_lse``: K2's and K3's delta less a random
    lse cotangent, as ring attention's lse merge hands them."""
    import torch

    from kubeflow_tpu_torch.ops import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    q, k, v, do = _inputs(b, s, h, kv, d, gen)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal=causal)
    delta = (do.float() * o_p).sum(-1).transpose(1, 2).contiguous()
    if fold_lse:
        delta = delta - torch.randn(delta.shape, generator=gen,
                                    device="cuda")

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


def _offsets(sizes, lead: int = 0):
    """The groups' offsets, the first group starting at row ``lead``."""
    import torch

    return torch.tensor(list(itertools.accumulate(sizes, initial=lead)),
                        dtype=torch.int32, device="cuda")


def check_grouped_case(b, k, n, sizes, trans_w, gen, lead: int = 0) -> dict:
    """gmm and tgmm against their plain versions on bf16 inputs; rows of no
    group (the ``lead`` rows before the first group, the tail after the
    last) and empty groups' blocks must come back exactly 0, and a second
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
    offs = _offsets(sizes, lead)
    end = lead + sum(sizes)
    x[end:], g[end:] = float("nan"), float("nan")
    x[:lead], g[:lead] = float("nan"), float("nan")
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
        "tail_rows": b - end, "lead_rows": lead,
        "tail_rows_zero": bool((out[end:] == 0).all()
                               and (out[:lead] == 0).all()),
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
        # Llama-2 7B's, whole (llama7b_job: 8 x 2048, 32 heads)
        ("llama2_7b_causal", dict(LLAMA2_7B_ATTN), True),
        # seq_train's ring blocks: the diagonal (causal) and an earlier
        # block (non-causal), the lse cotangent folded into delta
        ("ring_block_causal", dict(RING_BLOCK), True, True),
        ("ring_block_noncausal", dict(RING_BLOCK), False, True),
    ]
    results, bench_abs = {}, {}
    for name, shape, causal, *fold in cases:
        r = check_kernels_case(**shape, causal=causal, gen=gen,
                               fold_lse=bool(fold))
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
    line's), at the fine-tune path's llama_1b and Llama-2 7B shapes, and
    K1 at the ring's block shape."""
    out = _kernels_time("kernels_time", BENCH, plain_reps=5)
    _kernels_time("kernels_time_llama_1b", LLAMA_1B_ATTN, plain_reps=2)
    _kernels_time("kernels_time_llama2_7b", LLAMA2_7B_ATTN, plain_reps=2)
    _ring_block_time()
    return out


def _ring_block_time() -> None:
    """K1 at the ring's block shape, causal and non-causal, each beside its
    bound, its plain version and SDPA on the same inputs (not on the main
    path: ``seq_train`` launches these)."""
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    q, k, v, _ = _inputs(**RING_BLOCK, gen=gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = {}
    for causal in (True, False):
        bnd = bounds(**RING_BLOCK, causal=causal)["flash_fwd"]
        ms = time_ms(lambda: fa.flash_fwd(q, k, v, causal=causal), 30)
        out["causal" if causal else "noncausal"] = {
            "ms": ms, "bound_ms": bnd["bound_ms"],
            "bound_by": bnd["bound_by"], "bound_share": bnd["bound_ms"] / ms,
            "plain_ms": time_ms(
                lambda: fa.flash_fwd_plain(q, k, v, causal=causal), 5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), 30)}
    emit("kernels_time_ring_block", shape=RING_BLOCK, flash_fwd=out)


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
    # one backward call of SDPA (dQ, dK and dV at once) on a kept graph:
    # the library's counterpart of K2 + K3 together
    y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    bwd_call_ms = time_ms(lambda: torch.autograd.grad(
        y, (qg, kg, vg), dot, retain_graph=True), 30)
    del y
    # no single call computes dK/dV (K2) or dQ (K3) alone: SDPA's backward,
    # its forward and backward less its forward, is the yardstick of the two
    emit(phase, shape=shape, kernels=out, work=detail,
         sdpa_fwd_bwd_ms=fwd_bwd_ms,
         kernels_fwd_bwd_ms=sum(r["ms"] for r in out.values()),
         sdpa_bwd_ms=fwd_bwd_ms - out["flash_fwd"]["library_ms"],
         sdpa_bwd_call_ms=bwd_call_ms,
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


def _serve_gmm_reading(sizes, gen, k: int = GMM_BENCH["k"],
                       n: int = GMM_BENCH["n"], lead: int = 0,
                       tail: int = 0) -> dict:
    """gmm at a serving shape (``sizes`` rows over 8 experts; by default
    the gate/up product, K 1024 -> N 2816): against its plain version and
    ``torch._grouped_mm`` on the same inputs. The kernel is shorter than
    its host launch, so ``ms`` and ``library_ms`` come from launches
    captured in a CUDA graph, as the serving engine runs them
    (``eager_ms``: one launch between events, the host's launch included).
    Its bound counts what this routing needs: x's rows of a group, the
    whole output (rows of no group written 0) and the weights of the
    experts that have rows. ``lead`` / ``tail``: rows of no group before
    the first group and after the last (an expert-parallel rank's window
    of the sorted rows); the library, which has no such rows, takes the
    window's rows alone."""
    import torch

    from kubeflow_tpu_torch.ops import grouped_matmul as gm

    rows, e = sum(sizes), len(sizes)
    b = lead + rows + tail
    x = torch.randn(b, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(e, k, n, generator=gen, device="cuda").to(torch.bfloat16)
    offs = _offsets(sizes, lead)
    live = sum(1 for size in sizes if size)
    bnd = roofline(2 * (rows * k + b * n + live * k * n) + 4 * (e + 1),
                   2 * rows * k * n)
    out = {"ms": graph_time_ms(lambda: gm.gmm(x, w, offs)),
           "plain_ms": time_ms(lambda: gm.gmm_plain(x, w, offs), 20),
           "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
           "library_ms": None}
    ends = (offs[1:] - lead).contiguous()
    xw = x[lead:lead + rows]
    try:
        err = rel_err(torch._grouped_mm(xw, w, offs=ends),
                      gm.gmm_plain(x, w, offs)[lead:lead + rows])
        note = f"torch._grouped_mm, rel err {err}"
        if err <= REL_TOL:
            out["library_ms"] = graph_time_ms(
                lambda: torch._grouped_mm(xw, w, offs=ends))
    except (AttributeError, RuntimeError, TypeError) as exc:
        note = f"{type(exc).__name__}: {exc}"
    return {**out, "rows": b, "k": k, "n": n, "sizes": sizes,
            "lead": lead, "tail": tail,
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
    attached to a paged engine before warmup. ``stats_audit`` is
    ``audit_stats_pair`` of the engine's ``stats()`` after warmup and
    after the last round (empty: the metrics contract holds)."""
    from kubeflow_tpu_torch.analysis.runtime import audit_stats_pair
    from kubeflow_tpu_torch.serving.continuous import ContinuousEngine

    eng = ContinuousEngine(cfg, model, **engine_kw)
    if ledger is not None:
        eng.attach_block_ledger(ledger)
    seconds, dispatches, streams = [], [], []
    try:
        t0 = time.perf_counter()
        eng.warmup(warmup)
        warmup_s = time.perf_counter() - t0
        # the metrics contract's runtime half: this snapshot against the
        # one after the last round (neither inside a timed window)
        stats0 = eng.stats()
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
    stats_audit = audit_stats_pair(stats0, stats)
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
            "launches": launches, "stats": stats, "stats_audit": stats_audit}


def phase_serve() -> None:
    """bench.py's serving row on the port: the 271M bench model at full
    width and depth, random weights, 8 x 128-token prompts, 64 new tokens
    each after a 16-token priming round, every program a CUDA graph. The
    engine's ``stats()`` must keep the metrics contract across the run
    (``audit_stats_pair``)."""
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
         first_tokens=r["tokens"][0][:8], stats_audit=r["stats_audit"])
    require(st["graph_captures_total"] == 0,
            f"{st['graph_captures_total']} captures after warmup")
    require(r["stats_audit"] == [],
            f"serve: the metrics contract {r['stats_audit']}")
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
        seq = torch.tensor([p + ta[:at]],
                           device=model.embedder.embedding.device)
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


#: C11: every token of a served greedy stream, fed back through the plain
#: model (teacher forcing), must be the model's top token or sit within
#: this gap of it, relative to the top logit: the near-tie bound. A path
#: that emits wrong tokens fails it (``_stream_gaps``' control)
STREAM_GAP_TOL = 2e-2
#: an MoE stream's positions over STREAM_GAP_TOL must each be reproduced
#: by the plain forward with one token's routing flipped at one layer where
#: its k-th and (k+1)-th expert probabilities sit within ROUTE_TIE of each
#: other, relative (``_routing_explained``). A served path's attention runs
#: in other numerics than the plain forward (the decode path's f32 attend
#: over a bf16 cache, not K1), so its router probabilities move by more
#: than one GEMM shape's rounding: on the card one position took a flip at
#: a margin between 2e-2 and 5e-2, and tokens drawn from the seed stay over
#: the limit under every such flip
ROUTE_TIE = 5e-2


def _forced_logits(model, prompts, streams):
    """Logits [rows, len(stream), vocab] whose ``[r, i]`` scores
    ``streams[r][i]`` (every prompt of one length, every stream of one
    length): one plain forward over each prompt and its stream, through a
    KV cache for an int8-KV model (its KV rounding lives in its cache)."""
    import torch

    from kubeflow_tpu_torch.models.llama import KvCache

    plen, new = len(prompts[0]), len(streams[0])
    dev = model.embedder.embedding.device
    tokens = torch.tensor([p + s for p, s in zip(prompts, streams)],
                          device=dev)
    with torch.no_grad():
        if model.cfg.quant_kv:
            cache = KvCache.zeros(model.cfg, len(prompts), plen + new,
                                  device=dev, kv_heads=model.kv_heads)
            pos = torch.arange(plen + new, device=dev)[None]
            logits = model(tokens, pos, cache=cache)
        else:
            logits = model(tokens)
    return logits[:, plen - 1:plen + new - 1].float()


def _forced_distance(plain, other, prompts, streams) -> dict:
    """``streams`` fed through ``plain`` and ``other``
    (``_forced_logits``): the largest relative L2 distance of ``other``'s
    logits from ``plain``'s over every position, and at how many
    positions the greedy token agrees."""
    t0 = time.perf_counter()
    want = _forced_logits(plain, prompts, streams)
    got = _forced_logits(other, prompts, streams)
    return {"rel_l2_max": float((got - want).norm(dim=-1).div(
                want.norm(dim=-1)).max()),
            "positions": want.shape[0] * want.shape[1],
            "argmax_agree": int((got.argmax(-1) == want.argmax(-1)).sum()),
            "seconds": time.perf_counter() - t0}


def _rel_gaps(logits, toks):
    """Per position, how far the logit of ``toks`` ([rows, n]) sits below
    the top of ``logits`` ([rows, n, vocab]), relative to the top."""
    top = logits.max(-1).values
    chosen = logits.gather(-1, toks.to(logits.device)[..., None])[..., 0]
    return ((top - chosen) / top.abs()).cpu()


def _flipped_forward(model, seq, plen: int, flips: list) -> tuple:
    """The plain forward of ``seq`` ([1, S]: a prompt of ``plen`` tokens
    and its stream) once for each entry of ``flips``, in one batch, each
    MoE layer routing as it does but at the entry's (layer, token) pairs,
    where a token's k-th expert is swapped for its (k+1)-th: (logits
    [rows, S - plen, vocab] f32 scoring the stream, router probabilities
    [layers, rows, S, experts])."""
    import torch

    layers = _moe_layers(model)
    k = model.cfg.moe_top_k
    masks = torch.zeros(len(layers), len(flips), seq.shape[1],
                        dtype=torch.bool)
    for row, pairs in enumerate(flips):
        for layer, tok in pairs:
            masks[layer, row, tok] = True
    probs = []
    for layer, mask in zip(layers, masks.to(seq.device)):
        def flipped(self, x, _route=type(layer).route, _mask=mask):
            p, gates, idx = _route(self, x)
            probs.append(p)
            if _mask.any():
                idx = idx.clone()
                idx[..., k - 1] = torch.where(
                    _mask, p.topk(k + 1, dim=-1).indices[..., k],
                    idx[..., k - 1])
                gates = p.gather(-1, idx)
                if self.cfg.moe_normalize_topk:
                    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
            return p, gates, idx

        layer.route = types.MethodType(flipped, layer)
    try:
        with torch.no_grad():
            logits = model(seq.expand(len(flips), -1))[:, plen - 1:-1]
    finally:
        for layer in layers:
            layer.__dict__.pop("route", None)
    return logits.float(), torch.stack(probs)


def _routing_explained(model, prompt, stream, scored):
    """An MoE model fed ``prompt`` and its served ``stream``: for each token
    row of ``scored`` ([n] tokens scored at the stream's positions), its
    gaps [rows, n] each the smallest under the plain forward and under
    every single near-tie routing flip (``_flipped_forward``; margin under
    ROUTE_TIE, prompt tokens included) that reaches its position: what a
    served path whose other numerics rounded that routing the other way
    computed."""
    import torch

    k, plen = model.cfg.moe_top_k, len(prompt)
    seq = torch.tensor([prompt + stream],
                       device=model.embedder.embedding.device)
    rows = torch.stack([torch.as_tensor(t) for t in scored])
    logits, probs = _flipped_forward(model, seq, plen, [[]])
    best = _rel_gaps(logits.expand(len(rows), -1, -1), rows)
    width = seq.shape[1] - 1  # the last token's routing scores nothing
    top = probs[:, 0, :width].topk(k + 1, dim=-1).values
    margin = ((top[..., k - 1] - top[..., k]) / top[..., k - 1]).flatten()
    ties = [(i // width, i % width)
            for i in (margin < ROUTE_TIE).nonzero().flatten().tolist()]
    for at in range(0, len(ties), 128):
        chunk = ties[at:at + 128]
        tried, _ = _flipped_forward(model, seq, plen, [[c] for c in chunk])
        # position i is scored by token plen + i - 1: a flip at token t
        # moves the positions from t - plen + 1 on
        first = torch.tensor([t - plen + 1 for _, t in chunk])[:, None]
        still = torch.arange(len(stream))[None] < first
        for r in range(len(rows)):
            g = _rel_gaps(tried, rows[r].expand(len(chunk), -1))
            best[r] = torch.minimum(best[r], g.masked_fill(
                still, float("inf")).min(0).values)
    return best


def _stream_gaps(model, prompts, streams, forced=None) -> dict:
    """Served greedy ``streams`` of ``model`` held by teacher forcing: the
    model fed each prompt and its own stream (``forced``: its plain
    forward, ``_forced_logits``, by default); at
    every position the gap between the top logit and the stream token's,
    relative to the top. A greedy engine emits the top token, so a gap
    can only be the rounding of another program shape (a near tie). For
    an MoE model, where a router near tie rounded the other way moves the
    logits by far more, each position is held at its smallest gap under
    one near-tie routing flip (``_routing_explained``).
    ``control_over_tol``: the share of tokens drawn uniformly from SEED,
    scored at the same positions the same way, that sit over the limit:
    what a path emitting wrong tokens would show."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    groups: dict = {}
    for p, st in zip(prompts, streams):
        groups.setdefault((len(p), len(st)), []).append((p, st))
    moe = bool(_moe_layers(model))
    gaps, control, over, explained, plain_max = [], [], [], 0, 0.0
    for rows in groups.values():
        ps, sts = [r[0] for r in rows], [r[1] for r in rows]
        logits = (forced or _forced_logits)(model, ps, sts)
        drawn = torch.from_numpy(rng.integers(0, logits.shape[-1],
                                              (len(sts), len(sts[0]))))
        g = _rel_gaps(logits, torch.tensor(sts))
        c = _rel_gaps(logits, drawn)
        plain_max = max(plain_max, float(g.max()))
        for r in range(len(sts)) if moe else ():
            before = int((g[r] > STREAM_GAP_TOL).sum())
            g[r], c[r] = _routing_explained(model, ps[r], sts[r],
                                            [sts[r], drawn[r]])
            explained += before - int((g[r] > STREAM_GAP_TOL).sum())
        gaps.append(g)
        control.append(c)
        for r, i in (g > STREAM_GAP_TOL).nonzero().tolist():
            over.append({"row": r, "position": i, "gap": float(g[r, i])})
    gaps = torch.cat([g.flatten() for g in gaps])
    control = torch.cat([c.flatten() for c in control])
    return {"positions": int(gaps.numel()), "gap_max": float(gaps.max()),
            "off_top": int((gaps > 0).sum()), "gap_max_unflipped": plain_max,
            "routing_explained": explained,
            "over_tol": over,
            "control_over_tol": float((control > STREAM_GAP_TOL).float()
                                      .mean()),
            "seconds": time.perf_counter() - t0}


def _gaps(model, prompts, runs: dict, forced=None) -> dict:
    """``_stream_gaps`` of each run's streams (run name -> streams); runs
    whose streams are equal share one teacher-forced pass."""
    done: dict = {}
    out = {}
    for run, streams in runs.items():
        key = json.dumps(streams)
        if key not in done:
            done[key] = _stream_gaps(model, prompts, streams, forced)
        out[run] = done[key]
    return out


def _decode_logits(model, prompts, streams):
    """``_forced_logits`` through the model's decode path instead of its
    plain forward (``_teacher_forced``: the prompts through a KV cache,
    then one token a forward), the path every serving engine runs."""
    return _teacher_forced(model, prompts, streams)[0]


def _require_gaps(name: str, gaps: dict) -> None:
    """No position of any run (``_gaps``) over ``STREAM_GAP_TOL``, and the
    control over it at nine positions in ten or more (the limit, and for
    an MoE model the routing flips, tell a wrong path from rounding)."""
    for run, g in gaps.items():
        require(not g["over_tol"], f"{name} {run}: stream tokens sit below "
                f"the plain model's top by more than {STREAM_GAP_TOL}: {g}")
        require(g["control_over_tol"] >= 0.9,
                f"{name} {run}: the gap limit does not tell drawn tokens "
                f"from the model's: {g}")


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
    gaps = _gaps(model, prompts, {k: r["tokens"] for k, r in runs.items()})
    emit("serve_variants", prompts=4, new=32, engine=kw,
         tokens_per_sec={k: r["tokens_per_sec"] for k, r in runs.items()},
         captures_after_warmup={k: r["stats"]["graph_captures_total"]
                                for k, r in runs.items()},
         paged_equal_to_slot_pool=paged_equal,
         slot_vs_chunked_differences=diffs, teacher_forced=gaps,
         blocks_leaked=runs["paged"]["leaked"],
         ledger_errors=runs["paged"]["ledger_errors"],
         kv_blocks_free=runs["paged"]["stats"]["kv_blocks_free"],
         kv_blocks_total=runs["paged"]["stats"]["kv_blocks_total"])
    require(paged_equal, "paged and slot pool streams differ")
    require(all(d["margin_rel"] < 2e-2 for d in diffs),
            f"whole-prompt vs chunked admission differ where the top-2 "
            f"margin is not small: {diffs}")
    _require_gaps("serve_variants", gaps)
    require(runs["paged"]["leaked"] == 0
            and not runs["paged"]["ledger_errors"],
            "the paged pool leaked blocks")
    require(all(r["stats"]["graph_captures_total"] == 0
                for r in runs.values()), "captures after warmup")


def phase_moe_serve() -> dict:
    """The MoE bench model (8 experts, top-2, dropless, on K4a ``gmm``)
    serving 4 prompts x 128 tokens, 32 new tokens each, in the slot pool;
    the gmm launches of the timed round are counted, and the engine's
    ``stats()`` must keep the metrics contract (``audit_stats_pair``)."""
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
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         stats_audit=r["stats_audit"])
    require(r["launches"]["gmm"] > 0, "MoE serving launched no gmm")
    require(st["graph_captures_total"] == 0, "captures after warmup")
    require(r["stats_audit"] == [],
            f"moe_serve: the metrics contract {r['stats_audit']}")
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
    gaps = _gaps(model, prompts, {n: r["tokens"] for n, r in runs.items()})
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
         differences_from_off=diffs, teacher_forced=gaps)
    for name, r in runs.items():
        require(r["stats"]["graph_captures_total"] == 0,
                f"{name}: captures after warmup")
    for name, d in diffs.items():
        require(all(map(_near_tie, d)),
                f"{name} differs from plain decode where no margin is "
                f"small: {d}")
    _require_gaps(phase, gaps)
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
    gaps = _gaps(model, prompts, {n: r["tokens"] for n, r in runs.items()})
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
         differences=diffs, teacher_forced=gaps)
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
    _require_gaps("prefix_serve", gaps)


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
    gaps = {**_gaps(model, prompts, {"plain": plain, "drain": migrated}),
            **_gaps(model, prompts[:1], {"held": [held]}),
            **_gaps(model, long_prompt, {"plain_long": plain_long,
                                         "mid_prefill": mid})}
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
        pinned_copy=copy, differences=diffs, teacher_forced=gaps, **clean)
    emit("migrate_serve", model="bench_model", engine=MIGRATE_ENGINE,
         **MIGRATE, **out)
    require(moved == MIGRATE["prompts"] and failed == 0,
            f"moved {moved}, failed {failed}")
    require(held_still, "a held import decoded before its resume")
    for name, d in diffs.items():
        _require_streams(f"migrate_serve {name}", d)
    _require_gaps("migrate_serve", gaps)


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
    gaps = _gaps(model, prompts, {"plain": plain, "migrated": migrated})
    emit("moe_migrate_serve", model="bench_moe_model", prompts=4,
         prompt_len=128, new=32, at=16, engine=MIGRATE_ENGINE, moved=moved,
         failed=failed, launches_on_b_after_the_drain=launches,
         differences=diffs, teacher_forced=gaps, **clean)
    require(moved == 4 and failed == 0, f"moved {moved}, failed {failed}")
    require(launches["gmm"] > 0, "B launched no gmm after the import")
    _require_streams("moe_migrate_serve", diffs)
    _require_gaps("moe_migrate_serve", gaps)
    return launches


def audit_hibernate_locks(a, b, store, ledger) -> tuple:
    """(a ``LockAudit``, the names it instruments) over the locks that
    ``hibernate_serve``'s threads share (the caller's, and engines A's and
    B's schedulers): each engine's gate and tier lock, the spill store's
    and the ledger's. Instrument before warmup (which takes the gates)."""
    from kubeflow_tpu_torch.analysis.runtime import LockAudit

    audit = LockAudit()
    sites = [(a, "_gate", "A._gate"), (a, "_tier_mu", "A._tier_mu"),
             (b, "_gate", "B._gate"), (b, "_tier_mu", "B._tier_mu"),
             (store, "_mu", "KvSpillStore._mu"),
             (ledger, "_mu", "BlockLedger._mu")]
    for obj, attr, name in sites:
        audit.instrument(obj, attr, name)
    return audit, [name for _, _, name in sites]


def require_lock_audit(phase: str, audit, names: list) -> dict:
    """No lock pair taken in both orders, and every instrumented lock
    taken at least once (a lock never taken would audit nothing)."""
    rep = audit.report()
    require(audit.inversions() == [], f"{phase}: lock inversions {rep}")
    missing = sorted(set(names) - set(rep["locks"]))
    require(not missing, f"{phase}: instrumented locks never taken: "
            f"{missing}")
    return rep


def phase_hibernate_serve() -> None:
    """Hibernate and thaw on the bench model: 5 sessions of 128-token
    prompts and 380 new tokens on A (the last hibernation must find its
    session still decoding); after 16 tokens each is hibernated into a
    ``KvSpillStore`` under a temporary directory; four thaw on B from the
    store, and the fifth, its ``blocks.bin`` cut in half, thaws degraded
    (re-prefilled from the manifest's tokens). A ``LockAudit`` records the
    real acquisition order of the locks the threads share: no pair may be
    taken in both orders."""
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
        audit, audited = audit_hibernate_locks(a, b, store, ledger)
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
    locks = require_lock_audit("hibernate_serve", audit, audited)
    diffs = _first_difference(cfg, model, prompts, plain, thawed)
    gaps = _gaps(model, prompts, {"plain": plain, "thawed": thawed})
    keys = ("kv_spills_total", "kv_thaws_total", "kv_thaws_degraded_total",
            "kv_spill_verify_failures_total", "kv_sessions_hibernated")
    emit("hibernate_serve", model="bench_model", sessions=5, prompt_len=128,
         new=new, at=16, engine=MIGRATE_ENGINE, hibernated=hibernated,
         spill_write_ms=write_ms, thaw_ms=thaw_ms,
         degraded_reprefill_ms=reprefill_ms, degraded=info["degraded"],
         stats_a={k: st_a[k] for k in keys},
         stats_b={k: st_b[k] for k in keys}, differences=diffs,
         teacher_forced=gaps, lock_audit=locks, **clean)
    require(all(hibernated), f"hibernated {hibernated}")
    require(info["degraded"] and st_b["kv_thaws_degraded_total"] == 1,
            "the torn spill did not thaw degraded")
    require(st_b["kv_thaws_total"] == 5 and st_a["kv_spills_total"] == 5,
            "spill and thaw counts")
    _require_streams("hibernate_serve", diffs)
    _require_gaps("hibernate_serve", gaps)


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
    gaps = _gaps(model, prompts, {"plain": plain, "host_tier": streams})
    emit("host_tier_serve", model="bench_model", **HOST_TIER,
         engine=HOST_ENGINE, rounds_detail=rounds,
         ttft_ms_cold=rounds[0]["ttft_ms"],
         ttft_ms_restored_median=(statistics.median(restored)
                                  if restored else None),
         stats={k: st[k] for k in keys}, differences=diffs,
         teacher_forced=gaps, **clean)
    require(st["kv_host_restores_total"] > 0, "no host-tier restore")
    _require_streams("host_tier_serve", diffs)
    _require_gaps("host_tier_serve", gaps)


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
    gaps = _gaps(model, prompts, {"mixed": want, "disagg": got,
                                  "tier_ladder": ladder})
    emit("disagg_serve", model="bench_model", prompts=8, prompt_len=128,
         new=64, engine=MIGRATE_ENGINE,
         tokens_per_sec={"mixed": tokens / mixed_s,
                         "disaggregated": tokens / pool_s,
                         "tier_ladder": tokens / ladder_s},
         handoff_ms_median=statistics.median(handoff), handoff_ms=handoff,
         kv_migrations_total=st["kv_migrations_total"],
         kv_migrate_bytes_total=st["kv_migrate_bytes_total"],
         differences=diffs, teacher_forced=gaps, **clean)
    require(st["kv_migrations_total"] == len(prompts),
            f"{st['kv_migrations_total']} handoffs")
    for name, d in diffs.items():
        _require_streams(f"disagg_serve {name}", d)
    _require_gaps("disagg_serve", gaps)


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


def _rss_bytes() -> int:
    """This process's resident host memory now (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for row in f:
            if row.startswith("VmRSS:"):
                return int(row.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def _sync(cuda: bool) -> None:
    import torch

    if cuda:
        torch.cuda.synchronize()


def _peak_reset(cuda: bool) -> None:
    """Frees what the caching allocator holds and starts a peak reading
    (the card only)."""
    import torch

    _free_card(cuda)
    if cuda:
        torch.cuda.reset_peak_memory_stats()


def _peak(cuda: bool) -> Optional[int]:
    import torch

    return torch.cuda.max_memory_allocated() if cuda else None


def _base_unchanged(base: dict, trainer) -> bool:
    """Whether the trainer's frozen base is bit for bit ``base`` (a state
    dict on any device), compared a leaf at a time on the trainer's
    device."""
    import torch

    from kubeflow_tpu_torch.models import llama

    got = trainer.model.state_dict()
    return all(torch.equal(got[k], v.to(got[k].device))
               for k, v in base.items() if not llama.is_lora_path(k))


def _float_dtypes(sd: dict) -> list:
    return sorted({str(v.dtype).removeprefix("torch.") for v in sd.values()
                   if v.is_floating_point()})


def finetune_job(phase: str, name: str, cfg, base: str, work: str,
                 card: str, sizes: dict = FINETUNE,
                 ready: Optional[str] = None, device=None) -> dict:
    """The fine-tune job end to end on ``cfg``, the preset ``name``
    (random weights from SEED,
    built on the card in its ``param_dtype``): ``save_pretrained`` writes
    the base into ``base``, read back bit for bit (then ``ready`` is
    created, when given), the pod entry ``train_main`` fine-tunes a LoRA
    on it (``KFT_INIT_FROM``, ``sizes``' batch, length, steps and
    checkpoint interval) and publishes the adapter; a second
    ``train_main`` to ``resume_to`` resumes at ``steps``. Each run
    launches K1-K3 (counted per run); the base stays bit for bit the
    snapshot's; the adapters, their checkpoints and the published adapter
    are f32 and hold the adapters only. Returns the base and adapter
    paths and the phase's line. ``device="cpu"`` rehearses it with a tiny
    ``cfg`` (no kernel, no memory reading)."""
    import gc
    import os

    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    cuda = device is None
    dev = device or "cuda"
    _peak_reset(cuda)
    free_at_start = torch.cuda.mem_get_info()[0] if cuda else None
    t0 = time.perf_counter()
    model = llama.Llama(cfg, device=dev)
    model.init_weights(SEED)
    _sync(cuda)
    build_s = time.perf_counter() - t0
    build_peak = _peak(cuda)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    t0 = time.perf_counter()
    llama.save_pretrained(base, cfg, model)
    save_s = time.perf_counter() - t0
    rss_before = _rss_bytes()
    t0 = time.perf_counter()
    snap_cfg, snap = llama.load_pretrained(base)
    load_s = time.perf_counter() - t0
    # what the loaded state dict holds on the host: the file's bytes once
    load_rss = _rss_bytes() - rss_before
    require(snap_cfg == cfg, f"snapshot config {snap_cfg} != {cfg}")
    require(all(torch.equal(snap[k], v.cpu())
                for k, v in model.state_dict().items()),
            "the snapshot does not read back bit for bit")
    del model
    _free_card(cuda)
    if ready is not None:
        with open(ready, "w") as f:
            f.write(base)
    ft = sizes
    env = {"KFT_INIT_FROM": f"file://{base}",
           "KFT_LORA_RANK": str(ft["lora_rank"]),
           "KFT_STEPS": str(ft["steps"]), "KFT_BATCH": str(ft["batch"]),
           "KFT_SEQ_LEN": str(ft["seq"]),
           "KFT_CKPT_DIR": os.path.join(work, f"{phase}-ckpt"),
           "KFT_SAVE_EVERY": str(ft["save_every"]), "KFT_LOG_EVERY": "1",
           "KFT_PUBLISH_TO": os.path.join(work, f"{phase}-adapter"),
           **({} if cuda else {"KFT_POD_DEVICE": dev})}
    status = os.path.join(work, f"{phase}-status")
    _peak_reset(cuda)
    runs = []
    for steps in (ft["steps"], ft["resume_to"]):
        trainer, rows, launches, seconds = _train_main(
            {**env, "KFT_STEPS": str(steps)}, status)
        done = runs[-1]["steps"] if runs else 0
        per_step = {k: FINETUNE_PER_LAYER.get(k, 0) * cfg.num_layers
                    * (steps - done) for k in launches}
        losses = [r["value"] for r in _metric(rows, "loss")]
        tokens = ft["batch"] * ft["seq"]
        tps = [r["value"] for r in _metric(rows, "tokens_per_sec_per_chip")]
        runs.append({
            "steps": steps, "seconds": seconds,
            "resume_step": _metric(rows, "resume_step")[0]["value"],
            "loss_steps": [r["step"] for r in _metric(rows, "loss")],
            "losses": losses, "tokens_per_sec": tps,
            "step_s": [tokens / x for x in tps],
            "mfu_reported": _metric(rows, "mfu")[0]["value"],
            "published": _metric(rows, "published")[0]["value"],
            "launches": launches, "launches_expected": per_step,
            "base_unchanged": _base_unchanged(snap, trainer),
            "adapter_dtypes": _float_dtypes(llama.split_lora(
                trainer.model.state_dict())[1]),
            "checkpoints": trainer.ckpt.all_steps(),
        })
        if steps != ft["resume_to"]:
            del trainer
            _free_card(cuda)
    last = trainer
    peak = _peak(cuda)
    ckpt_dir = env["KFT_CKPT_DIR"]
    ckpt_bytes = {s: _dir_bytes(os.path.join(ckpt_dir, str(s)))
                  for s in runs[-1]["checkpoints"]}
    adapter_bytes = _dir_bytes(env["KFT_PUBLISH_TO"])
    base_bytes = _dir_bytes(base)
    # the save, restore and publish of this state, timed alone
    timing = CheckpointManager(os.path.join(work, f"{phase}-ckpt-timing"))
    _sync(cuda)
    t0 = time.perf_counter()
    timing.save(ft["resume_to"], last._to_ckpt(), force=True)
    ckpt_save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = timing.restore(map_location=dev)
    _sync(cuda)
    ckpt_restore_s = time.perf_counter() - t0
    ckpt_keys = sorted(restored)
    ckpt_adapters = restored.get("adapters", {})
    # AdamW's moments of the adapters: nu f32, mu in the trainer's mu_dtype
    moments = {k: _float_dtypes(dict(enumerate(
        restored.get("opt_state", {}).get(k, [])))) for k in ("mu", "nu")}
    mu_dtype = str(last.cfg.mu_dtype or torch.float32).removeprefix("torch.")
    t0 = time.perf_counter()
    llama.save_adapter(os.path.join(work, f"{phase}-adapter-timing"),
                       last.cfg.model, last.model)
    publish_s = time.perf_counter() - t0
    _, published = llama.load_adapter(env["KFT_PUBLISH_TO"])
    # steady steps: every run's steps after its first
    steady = [t for r in runs for t in r["tokens_per_sec"][1:]]
    tps = statistics.median(steady)
    flops_tok = llama.flops_per_token(cfg, ft["seq"])
    line = dict(
        model=name, params=llama.num_params(cfg),
        param_dtype=str(cfg.param_dtype).removeprefix("torch."),
        param_bytes=param_bytes, lora_rank=ft["lora_rank"],
        lora_params=sum(p.numel() for n, p in last.model.named_parameters()
                        if llama.is_lora_path(n)),
        global_batch=ft["batch"], seq_len=ft["seq"], runs=runs,
        tokens_per_sec=tps, tokens_per_sec_steps=steady,
        step_s=ft["batch"] * ft["seq"] / tps,
        flops_per_step=flops_tok * ft["batch"] * ft["seq"],
        mfu=tps * flops_tok / PEAK_FLOPS,
        mfu_convention="6N + attention per token (the reference's "
        "flops_per_token), frozen-base weight gradients included",
        free_bytes_at_start=free_at_start, build_s=build_s,
        build_peak_bytes=build_peak, peak_mem_bytes=peak,
        snapshot_write_ms=save_s * 1e3, snapshot_read_ms=load_s * 1e3,
        snapshot_read_rss_bytes=load_rss,
        checkpoint_save_ms=ckpt_save_s * 1e3,
        checkpoint_restore_ms=ckpt_restore_s * 1e3,
        publish_ms=publish_s * 1e3, base_bytes=base_bytes,
        checkpoint_bytes=ckpt_bytes, checkpoint_keys=ckpt_keys,
        checkpoint_adapter_dtypes=_float_dtypes(ckpt_adapters),
        checkpoint_moment_dtypes=moments,
        published_dtypes=_float_dtypes(published),
        adapter_bytes=adapter_bytes, card=card)
    emit(phase, **line)
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
        require(not cuda or (r["launches"] == r["launches_expected"] and all(
            r["launches"][k] > 0 for k in FINETUNE_PER_LAYER)),
            f"fine-tune launches {r['launches']} != "
            f"{r['launches_expected']}")
        require(r["base_unchanged"], "the frozen base changed")
        require(r["published"] == 1.0, "the adapter was not published")
        require(r["adapter_dtypes"] == ["float32"],
                f"the adapters are {r['adapter_dtypes']}, not f32")
    require(max(ckpt_bytes.values()) < base_bytes / 100
            and "params" not in restored and ckpt_adapters
            and all(llama.is_lora_path(k) for k in ckpt_adapters),
            f"checkpoints {ckpt_bytes} ({ckpt_keys}) are not adapter-only")
    require(line["checkpoint_adapter_dtypes"] == ["float32"]
            and line["published_dtypes"] == ["float32"],
            f"checkpointed adapters {line['checkpoint_adapter_dtypes']}, "
            f"published {line['published_dtypes']}: not f32")
    require(moments == {"mu": [mu_dtype], "nu": ["float32"]},
            f"the checkpointed moments are {moments}, not mu {mu_dtype} "
            "and nu f32")
    require(adapter_bytes < base_bytes / 100,
            f"the published adapter is {adapter_bytes} bytes")
    del last, snap, restored
    _free_card(cuda)
    return {"base": base, "adapter": env["KFT_PUBLISH_TO"], "line": line}


def phase_finetune(work: str, card: str) -> dict:
    """The fine-tune job on llama_1b (1.19B, 21 layers, full width, f32
    parameters, ``finetune_job``)."""
    import os

    from kubeflow_tpu_torch.models import llama

    return finetune_job("finetune", "llama_1b", llama.llama_1b(),
                        os.path.join(work, "base"), work, card)


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
                for parts, dims, *_ in gpu.opt.groups for p in parts}
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
#: the int8 serving model's logits against the plain model's on the plain
#: streams (``_forced_distance``): int8 weights move them by a relative L2
#: distance of 0.036 in the reference's tiny config and 0.062 / 0.044 at
#: llama_1b's depth and dtype with its width cut to 256 / 512 (the port's
#: forward through an int8 KV cache: 0.044, 0.065, 0.050), on the CPU
#: (``python -m tests._torch_measure int8``); a wrong path moves them by O(1)
INT8_TEACHER_TOL = 0.1


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
    runs, models = {}, {}
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
        models[name] = eng.model
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    plain_model = models["plain"]
    diffs = _first_difference(cfg, plain_model, prompts,
                              runs["plain"]["tokens"], runs["int8"]["tokens"])
    # each engine's streams held by its own model, and the int8 model's
    # logits held to the plain model's on the plain streams
    gaps = {**_gaps(plain_model, prompts, {"plain": runs["plain"]["tokens"]}),
            **_gaps(models["int8"], prompts, {"int8": runs["int8"]["tokens"]})}
    int8 = _forced_distance(plain_model, models["int8"], prompts,
                            runs["plain"]["tokens"])
    for r in runs.values():
        r.pop("tokens")
    emit("finetune_serve", model="llama_1b", merged_adapter=adapter,
         prompts=fs["prompts"], prompt_len=fs["prompt_len"], new=fs["new"],
         resolve_s=resolve_s, runs=runs,
         int8_vs_plain_differences=diffs, teacher_forced=gaps,
         int8_vs_plain_teacher_forced=int8,
         int8_teacher_tol=INT8_TEACHER_TOL,
         int8_weight_bytes=sum(runs["int8"]["weight_bytes"].values()),
         plain_weight_bytes=sum(runs["plain"]["weight_bytes"].values()),
         card=card)
    require(runs["int8"]["quant_weights"] and runs["int8"]["quant_kv"],
            "the quantized engine does not run int8")
    _require_streams("finetune_serve int8 vs plain", diffs)
    _require_gaps("finetune_serve", gaps)
    require(int8["rel_l2_max"] <= INT8_TEACHER_TOL,
            f"finetune_serve: the int8 model's logits sit "
            f"{int8['rel_l2_max']} from the plain model's (limit "
            f"{INT8_TEACHER_TOL}): {int8}")
    del plain_model, models, params
    gc.collect()
    torch.cuda.empty_cache()


# -- Llama-2 7B: the reference's headline model through the port --------------

#: ``llama7b_serve``: FINETUNE_SERVE's 8 prompts x 128 tokens, 64 new,
#: greedy, one round, in engines of 256 positions (8 slots at the
#: config's 4,096 would hold 16 GB of KV, and warmup captures every
#: attend rung up to it); the engines' knobs are ``serve``'s, the paged
#: one's blocks 16 (``GANG_ENGINE``)
LLAMA7B_SERVE = dict(FINETUNE_SERVE, rounds=1, max_seq_len=256)
#: ``tp7b_serve``: the same prompts behind a gang of two ranks, on the
#: first ``layers`` of the 7B's 32 at full width (at 32 the phase took
#: 121-149 s, and the script ~1,180 s of its 1,200 on a slow host);
#: ``wait``: the seconds the background track may wait for
#: ``llama7b_job``'s files in the main sequence
TP7B = dict(prompts=8, prompt_len=128, new=64, rounds=1, max_seq_len=256,
            layers=8, timeout=900, wait=1200)
#: the files ``llama7b_job`` creates once its base snapshot reads back and
#: once its adapter is published, each holding the path
LLAMA7B_READY = "ready"
LLAMA7B_ADAPTER = "adapter"


def _wait_for(path: str, wait: float) -> tuple[str, float]:
    """The contents of file ``path`` once it exists, and the seconds it
    took; fails after ``wait`` seconds."""
    import os

    t0 = time.perf_counter()
    while not os.path.exists(path):
        require(time.perf_counter() - t0 < wait,
                f"no {path} after {wait} s")
        time.sleep(1.0)
    with open(path) as f:
        return f.read(), time.perf_counter() - t0


def phase_llama7b_job(snap_dir: str, card: str) -> dict:
    """``finetune_job`` on Llama-2 7B (6.74B parameters in bf16, 32
    layers, h 4096, 32 heads, ffn 11,008): the base written into
    ``snap_dir/base``, a rank-8 LoRA at 8 x 2048, with ``llama_1b``'s
    settings (flash attention, remat "nothing"). ``snap_dir/ready`` is
    created once the base reads back and ``snap_dir/adapter`` once the
    adapter is published: the other track serves them."""
    import os

    import torch

    from kubeflow_tpu_torch.models import llama

    cfg = llama.llama2_7b(attention_impl="flash", remat_policy="nothing",
                          param_dtype=torch.bfloat16)
    job = finetune_job("llama7b_job", "llama2_7b", cfg,
                       os.path.join(snap_dir, "base"), snap_dir, card,
                       ready=os.path.join(snap_dir, LLAMA7B_READY))
    with open(os.path.join(snap_dir, LLAMA7B_ADAPTER), "w") as f:
        f.write(job["adapter"])
    return job


def phase_llama7b_serve(snap_dir: str, card: str,
                        wait: float = TP7B["wait"]) -> dict:
    """``llama7b_serve`` of the base and adapter ``llama7b_job`` wrote into
    ``snap_dir`` (waits for its files)."""
    import os

    base, _ = _wait_for(os.path.join(snap_dir, LLAMA7B_READY), wait)
    adapter, _ = _wait_for(os.path.join(snap_dir, LLAMA7B_ADAPTER), wait)
    return llama7b_serve(base, adapter, line=card)


def llama7b_serve(base: str, adapter: str, device=None,
                  sizes=LLAMA7B_SERVE, line: str = "") -> dict:
    """A published fine-tune of the 7B served: ``resolve_model_source`` of
    the base and the adapter (merged at load: f32 adapters into bf16
    kernels), then ``LlamaGenerator`` (the eager ``KvCache`` decode path,
    the prompts in one batch, on its own copy of the weights, alone on the
    card) and ``ContinuousEngine``'s slot pool and paged pool (blocks of
    16) on one model. Held: every greedy stream teacher-forced through the
    plain model within the near-tie bound (``_require_gaps``), the paged
    tokens equal to the slot pool's, 0 captures after warmup, 0 leaked
    blocks. Printed: each path's tokens/s, the engines' ms a decode
    dispatch and a step, peak memory, KV pool bytes, and the decode
    roofline (the weights' bytes over the HBM rate, a step) as a share of
    each engine's ms a step."""
    import torch

    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import storage
    from kubeflow_tpu_torch.serving.continuous import resolve_model_source
    from kubeflow_tpu_torch.serving.runtimes import LlamaGenerator

    cuda = device is None
    dev = device or "cuda"
    _peak_reset(cuda)
    t0 = time.perf_counter()
    cfg, params = resolve_model_source({
        "storage_path": base, "adapter_path": adapter,
        "max_seq_len": sizes["max_seq_len"]})
    resolve_s = time.perf_counter() - t0
    require(cfg.lora_rank == 0, "the adapter was not merged")
    n, plen, new = sizes["prompts"], sizes["prompt_len"], sizes["new"]
    prompts = _prompts(cfg, n, plen)
    key = "llama7b-serve"
    gen = LlamaGenerator("llama7b", {
        "params_ref": storage.register_mem(key, (cfg, params)),
        "max_new_tokens": new, "device": device})
    try:
        t0 = time.perf_counter()
        gen.load()
        gen_load_s = time.perf_counter() - t0
        gen_s = []
        for _ in range(sizes["rounds"]):
            t0 = time.perf_counter()
            gen_tokens = gen.predict_batch(prompts)
            gen_s.append(time.perf_counter() - t0)
        gen_peak = _peak(cuda)
    finally:
        gen.stop()
        storage._MEM_REGISTRY.pop(key, None)
    del gen
    _peak_reset(cuda)
    model = llama.Llama(cfg, device=dev)
    model.load_state_dict(params, strict=True)
    del params
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    warm = [(n, plen), (1, plen)]
    ledger = BlockLedger()
    engines = {}
    for name, kw in (("slot", SERVE_ENGINE), ("paged", GANG_ENGINE)):
        engines[name] = _serve(
            cfg, model, prompts, new, warm, rounds=sizes["rounds"],
            counters=True, ledger=ledger if name == "paged" else None,
            device=model.embedder.embedding.device, **kw)
    engine_peak = _peak(cuda)
    streams = {"generator": gen_tokens,
               **{k: e["tokens"] for k, e in engines.items()}}
    gaps = _gaps(model, prompts, streams, forced=_decode_logits)
    plain_gaps = _gaps(model, prompts, streams)
    roofline_ms = weight_bytes / PEAK_BYTES * 1e3
    runs = {"generator": {"load_s": gen_load_s, "seconds": gen_s,
                          "tokens_per_sec": statistics.median(
                              n * new / x for x in gen_s),
                          "peak_mem_bytes": gen_peak}}
    for name, e in engines.items():
        step_ms = e["ms_per_dispatch"] / SERVE_ENGINE["decode_chunk"]
        runs[name] = {
            "tokens_per_sec": e["tokens_per_sec"],
            "tokens_per_sec_rounds": e["tokens_per_sec_rounds"],
            "ms_per_dispatch": e["ms_per_dispatch"],
            "ms_per_decode_step": step_ms,
            "decode_roofline_share": roofline_ms / step_ms,
            "decode_dispatches": e["decode_dispatches"],
            "warmup_s": e["warmup_s"],
            "kv_pool_bytes": e["stats"]["kv_pool_bytes"],
            "captures_after_warmup": e["stats"]["graph_captures_total"],
            "graph_captures_warmup": e["stats"]["graph_captures_warmup"],
            "stats_audit": e["stats_audit"], "launches": e["launches"]}
    out = dict(card=line, model="llama2_7b", merged_adapter=adapter,
               prompts=n, prompt_len=plen, new=new,
               max_seq_len=cfg.max_seq_len, resolve_s=resolve_s,
               weight_bytes=weight_bytes, decode_roofline_ms=roofline_ms,
               runs=runs, engines_peak_mem_bytes=engine_peak,
               paged_equal_to_slot=(engines["paged"]["tokens"]
                                    == engines["slot"]["tokens"]),
               blocks_leaked=ledger.leaked_total,
               ledger_errors=list(ledger.conservation_errors),
               teacher_forced=gaps, teacher_forced_plain_forward=plain_gaps)
    emit("llama7b_serve", **out)
    require(out["paged_equal_to_slot"],
            "llama7b_serve: the paged pool's tokens differ from the slot "
            "pool's")
    require(all(runs[k]["captures_after_warmup"] == 0 for k in engines),
            "llama7b_serve: captures after warmup")
    require(ledger.leaked_total == 0 and not ledger.conservation_errors,
            f"llama7b_serve: leaked blocks {ledger.conservation_errors}")
    _require_gaps("llama7b_serve", gaps)
    del model
    _free_card(cuda)
    return out


def tp7b_serve(snap_dir: str, device=None, sizes=TP7B,
               line: str = "") -> dict:
    """The 7B base ``llama7b_job`` wrote (waits for its ``ready`` file in
    ``snap_dir``), cut to its first ``sizes["layers"]`` layers at full
    width and written as a snapshot of its own, behind a gang of two ranks
    at ``{"model": 2}`` through ``serve_main``, each rank loading that
    snapshot (``storage_path``) and laying out its 16 heads and half the
    weights (``place_params``), held as
    ``tp_serve`` is (``_gang_row``: follower outputs bitwise rank 0's,
    streams and the teacher-forced decode path against one unsharded
    engine's on the same weights, a pool a rank half the unsharded one).
    The unsharded model is on the card before and after the spawn only;
    its teacher-forced logits reach the ranks in a file."""
    import dataclasses
    import os

    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.parallel import dryrun
    from kubeflow_tpu_torch.utils.net import free_port

    cuda = device is None
    dev = device or "cuda"
    base, waited_s = _wait_for(os.path.join(snap_dir, LLAMA7B_READY),
                               sizes["wait"])
    cfg, sd = llama.load_pretrained(base)
    cut = sizes["layers"]
    cfg = dataclasses.replace(cfg, num_layers=cut,
                              max_seq_len=sizes["max_seq_len"])
    # copies, so that the whole snapshot's read buffer is freed
    sd = {k: v.clone() for k, v in sd.items()
          if not k.startswith("layers.") or int(k.split(".")[1]) < cut}
    base = os.path.join(snap_dir, f"base-{cut}-layers")
    llama.save_pretrained(base, cfg, sd)

    def unsharded():
        m = llama.Llama(cfg, device=dev)
        m.load_state_dict(sd, strict=True)
        return m

    m = unsharded()
    prompts = _prompts(cfg, sizes["prompts"], sizes["prompt_len"])
    truth = _truth(cfg, m, prompts, sizes["new"],
                   [(sizes["prompts"], sizes["prompt_len"]),
                    (1, sizes["prompt_len"])], GANG_ENGINE, counters=True)
    tmp = tempfile.mkdtemp(prefix="kft-tp7b-")
    try:
        reference = os.path.join(tmp, "reference.pt")
        torch.save(_teacher_forced_reference(m, prompts, truth["tokens"]),
                   reference)
        del m
        _free_card(cuda)
        snapshot = {"path": base, "max_seq_len": sizes["max_seq_len"],
                    "reference": reference}
        ports = [free_port() for _ in range(3)]
        t0 = time.perf_counter()
        ranks = dryrun.spawn(2, _case_rank, ports, "llama2_7b", sizes,
                             device, None, {"model": 2}, snapshot,
                             backend="gloo", timeout=sizes["timeout"])
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    m = unsharded()
    row = _gang_row("tp7b_serve", line, "llama2_7b", cfg, m, prompts, truth,
                    ranks, sizes, {"model": 2}, device)
    row.update(snapshot_wait_s=waited_s, spawn_seconds=spawn_s,
               case_seconds=[r["case_seconds"] for r in ranks],
               weight_bytes_per_rank=[r["weight_bytes"] for r in ranks],
               unsharded_weight_bytes=sum(
                   p.numel() * p.element_size() for p in m.parameters()))
    emit("tp7b_serve", **row)
    # half of every projection, the embedding and the head; the norms whole
    require(all(abs(w / row["unsharded_weight_bytes"] - 0.5) < 1e-2
                for w in row["weight_bytes_per_rank"]),
            f"tp7b_serve: ranks hold {row['weight_bytes_per_rank']} bytes of "
            f"the model's {row['unsharded_weight_bytes']}")
    del m, sd
    _free_card(cuda)
    return row


#: the HTTP phase (``http_serve``): the port's ModelServer + TextGenerator
#: over the bench model, paged (blocks of 16) with chunked admission (64 a
#: dispatch), every request traced, two QoS classes. The prefix cache is
#: off and every prompt plus its completion stays under the first attend
#: rung (128), so a request runs the same program shapes whatever shares
#: the pool with it: the server's greedy text must equal the engine's own
#: ``bf16_snapshot_serve``: bench.py's serving prompts through three
#: engines of the 271M bench model's weights
BF16_SNAPSHOT = dict(prompts=8, prompt_len=128, new=64)


def bf16_snapshot_serve(model="bench_model", device=None,
                        sizes=BF16_SNAPSHOT, line: str = "") -> dict:
    """A bf16 snapshot the port wrote, served: ``model`` (random weights
    from SEED) served in f32, then its weights cast to bf16 in place (what
    a runtime's ``weights_dtype="bfloat16"`` does once at load) and served,
    then saved by ``llama.save_pretrained`` (``config.json`` must say
    ``param_dtype: "bfloat16"``, the dtype the leaves have), loaded back
    through ``continuous.resolve_model_source`` as a ``storage_path`` (the
    leaves bf16 but the norms' scales, f32 as in the reference) and served
    by a fresh engine. The snapshot's streams must equal the cast
    weights' bitwise; each engine's peak device memory
    (``torch.cuda.max_memory_allocated``, reset before it) is printed
    beside the others. ``device="cpu"`` with a tiny config rehearses it."""
    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import continuous

    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    cfg = _config(model)
    m = llama.Llama(cfg, device=dev)
    m.init_weights(SEED)
    prompts = _prompts(cfg, sizes["prompts"], sizes["prompt_len"])
    warm = [(sizes["prompts"], sizes["prompt_len"])]

    def served(c, params) -> dict:
        _free_card(cuda)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        r = _serve(c, params, prompts, sizes["new"], warm, device=dev,
                   **SERVE_ENGINE)
        r["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
        return {k: r[k] for k in ("tokens", "tokens_per_sec",
                                  "ms_per_dispatch", "peak_bytes")}

    f32 = served(cfg, m)
    m.to(torch.bfloat16)
    cast = served(cfg, m)
    work = tempfile.mkdtemp(prefix="kft-bf16-")
    try:
        t0 = time.perf_counter()
        llama.save_pretrained(work, cfg, m)
        save_s = time.perf_counter() - t0
        with open(os.path.join(work, "config.json")) as f:
            declared = json.load(f)["param_dtype"]
        snap_bytes = _dir_bytes(work)
        del m
        t0 = time.perf_counter()
        scfg, sd = continuous.resolve_model_source({"storage_path": work})
        load_s = time.perf_counter() - t0
        dtypes = sorted({str(v.dtype) for v in sd.values()})
        snap = served(scfg, sd)
        del sd
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _free_card(cuda)
    row = dict(card=line, model=model if isinstance(model, str) else
               "custom", **sizes, engine=SERVE_ENGINE,
               param_dtype_written=declared,
               param_dtype_loaded=str(scfg.param_dtype),
               leaf_dtypes_loaded=dtypes, snapshot_bytes=snap_bytes,
               save_s=save_s, load_s=load_s,
               equal_to_cast=snap["tokens"] == cast["tokens"],
               # bf16 weights are other weights: streams equal to f32's
               streams_equal_to_f32=sum(
                   a == b for a, b in zip(cast["tokens"], f32["tokens"])),
               **{f"{name}_{k}": v for name, r in (
                   ("f32", f32), ("cast", cast), ("snapshot", snap))
                  for k, v in r.items() if k != "tokens"})
    emit("bf16_snapshot_serve", **row)
    require(declared == "bfloat16",
            f"bf16_snapshot_serve: config.json says {declared!r}")
    require(scfg.param_dtype == torch.bfloat16,
            f"bf16_snapshot_serve: loaded as {scfg.param_dtype}")
    require(row["equal_to_cast"],
            "bf16_snapshot_serve: the snapshot's streams differ from the "
            "same weights cast to bf16 at load")
    return row


def phase_bf16_snapshot_serve(line: str) -> dict:
    return bf16_snapshot_serve("bench_model", line=line)


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


def fresh_aot_root(tag: str) -> str:
    """A fresh program-artifact cache root under the checkout's gitignored
    ``build/`` (the caller removes it)."""
    import os

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"aot-{tag}-", dir=base)


def boot_report(eng) -> dict:
    """An engine boot's warmup through its program cache: seconds by part
    (kernel libraries, eager pre-runs, captures, record checks), the
    programs and libraries that hit or missed, and the cache's counters."""
    rep = eng.warmup_report
    outcomes = rep["outcomes"]
    return {"warmup_s": rep["wall_s"], **rep["split"],
            "programs": {o: sum(1 for k, v in outcomes.items()
                                if v == o and not k.startswith("kernels:"))
                         for o in ("hit", "miss")},
            "libraries": {k[len("kernels:"):]: v for k, v in outcomes.items()
                          if k.startswith("kernels:")},
            "aot": {k[len("aot_cache_"):]: v
                    for k, v in eng.stats().items()
                    if k.startswith("aot_cache_")}}


def require_warm(name: str, rep: dict, kernels: bool) -> None:
    """A warm boot: every program and library a hit, no miss, no torn
    entry (``kernels``: the libraries went through the cache, gmm's
    among them)."""
    aot = rep["aot"]
    require(aot["misses_total"] == 0 and aot["hits_total"] > 0
            and aot["load_failures_total"] == 0 and rep["programs"]["miss"]
            == 0 and rep["programs"]["hit"] > 0, f"{name}: not warm: {rep}")
    require(not kernels or (rep["libraries"].get("gmm") == "hit" and set(
        rep["libraries"].values()) == {"hit"}),
        f"{name}: the kernel libraries were not all hits: {rep}")


def tear_entries(root: str, kernel: Optional[str]) -> dict:
    """Tear (truncate to half) the first program record in ``root`` and
    kernel library ``kernel``'s entry (None: no library); returns what was
    torn."""
    import os

    torn = {}
    for name in sorted(os.listdir(root)):
        man = os.path.join(root, name, "artifact.json")
        if name.startswith(".") or not os.path.exists(man):
            continue
        with open(man) as f:
            meta = json.load(f)["meta"]
        what = ("library" if meta["family"] == "kernels" else "record")
        if what in torn or (what == "library" and (
                kernel is None
                or not meta["library"].startswith(f"lib{kernel}-"))):
            continue
        path = os.path.join(root, name, "program.bin")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        torn[what] = meta.get("library", meta["family"])
    require(len(torn) == 1 + (kernel is not None),
            f"no record or no {kernel} library in {root}: {torn}")
    return torn


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
    readings. ``kernels``: the MoE service must launch ``gmm``.

    Both services carry an ``aot`` block (a fresh root each under
    ``build/``): the text-llm wake from zero must boot warm (no miss,
    every program and library a hit; the controller's ``_wake_was_warm``
    true), the MoE service booted a second time on its root too (gmm's
    library a hit, answers bitwise the first boot's), and a third MoE
    engine on that root, one record and tgmm's library torn, counts both
    as load failures, republishes them and answers the same."""
    import gc
    import os

    import numpy as np
    import torch

    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.api import from_dict
    from kubeflow_tpu_torch.controlplane import Cluster
    from kubeflow_tpu_torch.serving import continuous, storage
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
    aot_base = fresh_aot_root("isvc")
    aot = {name: {"root": os.path.join(aot_base, name)}
           for name in ("text-llm", "moe")}
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
                                       "params_ref": f"mem://{keys['bench']}",
                                       "aot": aot["text-llm"]},
              min_replicas=2, max_replicas=2)
        isvc = _isvc_wait(cluster, "text-llm", lambda o: str(
            o.status.phase.value) == "Ready" and o.status.active_replicas == 2,
            "Ready with 2 replicas")
        out["text_llm_ready_s"] = time.perf_counter() - t0
        step("text_llm_ready")
        adopt("text-llm")
        out["text_llm_boots"] = [boot_report(e) for e in engines["text-llm"]]
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
        # the canary's config (decode_chunk 2) boots cold: it publishes
        # the records the wake from zero must meet
        out["cold_boot"] = {"text-llm": boot_report(
            replicas("text-llm", "canary")[0].models()["text-llm"].engine)}
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
        out["warm_boot"] = {"text-llm": boot_report(ztg.engine)}
        require_warm("isvc_serve wake from zero",
                     out["warm_boot"]["text-llm"], kernels)
        out["wake_was_warm"] = InferenceServiceController._wake_was_warm(
            replicas("text-llm"))
        require(out["wake_was_warm"] is True,
                "isvc_serve: the controller did not see the wake as warm")
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
        gaps = _gaps(model, tprompts, {"llm": got})
        if cuda:
            _require_streams("isvc_serve llm", diffs)
        else:
            require(not diffs, f"isvc_serve llm: tokens differ {diffs}")
        _require_gaps("isvc_serve llm", gaps)
        ms = min(times) * 1e3
        out["llm"] = {"ms_per_request": ms,
                      "ms_per_token": ms / sizes["llm_new"],
                      "request_s": times, "instances": len(tprompts),
                      "prompt_lengths": list(sizes["llm_lengths"]),
                      "differences": diffs, "teacher_forced": gaps}
        cluster.store.delete("InferenceService", "llm")
        step("llm")

        # 5. llama-continuous on the MoE bench model: gmm on this path
        moe_config = {
            **{k: v for k, v in ISVC_ENGINE.items()
               if k not in ("tracing", "affinity_block")},
            "params_ref": f"mem://{keys['moe']}",
            "max_new_tokens": sizes["moe_new"], "aot": aot["moe"]}
        apply("moe", "llama-continuous", moe_config)
        murl = _isvc_wait(cluster, "moe", lambda o: str(
            o.status.phase.value) == "Ready", "Ready").status.url
        adopt("moe")
        meng = engines["moe"][0]
        out["cold_boot"]["moe"] = boot_report(meng)
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

        # 6. the MoE service again on its root: a warm boot
        t0 = time.perf_counter()
        apply("moe", "llama-continuous", moe_config)
        murl = _isvc_wait(cluster, "moe", lambda o: str(
            o.status.phase.value) == "Ready", "Ready").status.url
        out["moe_warm_ready_s"] = time.perf_counter() - t0
        adopt("moe")
        out["warm_boot"]["moe"] = boot_report(engines["moe"][0])
        require_warm("isvc_serve moe second boot", out["warm_boot"]["moe"],
                     kernels)
        again = _in_threads(lambda q: _http_post(
            murl + "/v1/models/moe:predict", {"instances": [q]})[
                "predictions"][0], mq)
        require(again == mgot, "isvc_serve: the MoE warm boot's answers "
                "differ from the first boot's")
        teardown("moe")
        step("moe_warm_boot")

        # 7. one record and tgmm's library torn on that root: the next
        # engine counts both, republishes both and answers the same
        out["torn"] = tear_entries(aot["moe"]["root"],
                                   "tgmm" if kernels else None)
        n_torn = len(out["torn"])
        teng = continuous.build_engine(
            moe_cfg, moe_model, {**moe_config, **extra}, device=device)
        try:
            rep = boot_report(teng)
            tgot = [r.wait(600) for r in [teng.submit(q, sizes["moe_new"])
                                          for q in mq]]
            rep["captures_after_warmup"] = teng.stats()[
                "graph_captures_total"]
        finally:
            teng.stop()
        out["torn_boot"] = rep
        aot_n = rep["aot"]
        require(aot_n["load_failures_total"] == n_torn
                and aot_n["misses_total"] == n_torn
                and aot_n["published_total"] == n_torn
                and rep["programs"]["miss"] == 1
                and rep["captures_after_warmup"] == 0
                and (not kernels or rep["libraries"] == {
                    n: "miss" if n == "tgmm" else "hit"
                    for n in rep["libraries"]}),
                f"isvc_serve: the torn entries were not degraded and "
                f"republished: {rep}")
        require(tgot == mgot, "isvc_serve: the MoE answers after the torn "
                "entries differ from the first boot's")
        del teng
        step("moe_torn_boot")
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
        shutil.rmtree(aot_base, ignore_errors=True)
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


# -- the platform's other workloads (port slice 12) ----------------------------

#: ``scripts/serving_bench.py``'s BERT protocol: 8 x 128 token rows, one
#: warm call, 10 timed; then the same rows through a kft-bert service (10
#: timed requests), a ragged batch against each row alone, and a 2-layer cut
#: of the config on the card (bf16) against the CPU (f32)
BERT = dict(batch=8, seq=128, reps=10, requests=10, cut_layers=2,
            ragged=(128, 100, 64, 33, 17, 5, 90, 1))
#: ResNet-50 training: 3 warm steps, 10 timed with no per-step sync, at a
#: learning rate of 0.01 (on these random labels the job's default 0.1 took
#: the loss from 8 to 31 in 13 steps); then one tiny() f32 step on the card
#: against the CPU
RESNET = dict(batch=128, image=224, warm=3, timed=10, lr=0.01,
              parity_batch=4, parity_image=32)
#: the JaxJob pods: examples/01's MNIST job and a one-worker ResNet-50 job
PODS = dict(mnist_steps=4, mnist_batch=16, resnet="resnet-50",
            resnet_steps=4, resnet_batch=32, timeout=600)
#: the DARTS supernet at the bench model's width: 8 x 1024 tokens (a
#: stream of 8 x 1025 rows: inputs and next-token targets), 10 step pairs;
#: then one pair at tiny width on the card against the CPU
DARTS = dict(batch=8, seq=1024, steps=10, max_layers=4,
             ffn_widths=(1408, 2816), small_layers=3, small_widths=(64, 128))
#: the corpus-fed fine-tune: ~4M ids in 2,000 documents of 64-4,096 tokens,
#: the pod entry on llama_1b's base snapshot, a rank-8 LoRA at 8 x 2048
CORPUS = dict(docs=2000, min_len=64, max_len=4096, batch=8, seq=2048,
              steps=4, lora_rank=8)


def _free_card(cuda: bool) -> None:
    import gc

    import torch

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def bert_serve(cfg, device=None, sizes=BERT) -> dict:
    """BERT behind ``BertClassifierModel`` and a ``kft-bert``
    InferenceService (``phase_bert_serve`` on the card with ``bert_base()``;
    ``device="cpu"`` with ``bert.tiny()`` rehearses it). Returns the
    readings."""
    import dataclasses

    import numpy as np
    import torch

    from kubeflow_tpu_torch.api import from_dict
    from kubeflow_tpu_torch.controlplane import Cluster
    from kubeflow_tpu_torch.models import bert
    from kubeflow_tpu_torch.serving import storage
    from kubeflow_tpu_torch.serving.runtimes import BertClassifierModel

    cuda = device is None
    dev = device or "cuda"
    _free_card(cuda)
    model = bert.BertClassifier(cfg, device=dev)
    model.init_weights(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == bert.num_params(cfg),
            f"BERT has {n_params} params, the layout {bert.num_params(cfg)}")
    key = storage.register_mem("chip-smoke-bert", (cfg, model))
    b, s = sizes["batch"], sizes["seq"]
    buckets = {"buckets": [b], "seq_buckets": [s]}
    direct = BertClassifierModel("bert", {"params_ref": key, "device": dev,
                                          **buckets})
    direct.start()
    rows = np.random.default_rng(SEED).integers(
        1, cfg.vocab_size, size=(b, s)).tolist()
    direct.predict_batch(rows)  # first use: cuBLAS handles, allocator
    t0 = time.perf_counter()
    for _ in range(sizes["reps"]):
        probs = np.asarray(direct.predict_batch(rows))
    dt = (time.perf_counter() - t0) / sizes["reps"]
    require(probs.shape == (b, cfg.num_classes)
            and np.isfinite(probs).all()
            and np.allclose(probs.sum(-1), 1.0, atol=1e-3),
            f"bert probabilities {probs}")
    ragged = [r[:n] for r, n in zip(rows, sizes["ragged"])]
    together = np.asarray(direct.predict_batch(ragged))
    alone = np.asarray([direct.predict_batch([r])[0] for r in ragged])
    pad_err = float(np.abs(together - alone).max())
    require(pad_err <= 1e-2,
            f"a padded batch scores {pad_err} from each row alone")
    out = {"params": n_params, "batch": b, "seq": s,
           "direct": {"ms_per_batch": dt * 1e3,
                      "sequences_per_sec": b / dt,
                      "padded_vs_alone_max_abs": pad_err}}
    # the same rows through kft-bert services: from mem://, then a snapshot
    snap = tempfile.mkdtemp(prefix="kft-bert-")
    cluster = Cluster()
    cluster.enable_serving()
    cluster.start()
    try:
        t0 = time.perf_counter()
        bert.save_pretrained(snap, cfg, model)
        save_s = time.perf_counter() - t0
        for name, source in (("bert-mem", {"config": {"params_ref": key}}),
                             ("bert-file", {"storage_uri":
                                            f"file://{snap}"})):
            t0 = time.perf_counter()
            cluster.store.create(from_dict({
                "kind": "InferenceService", "metadata": {"name": name},
                "spec": {"predictor": {
                    "model_format": {"name": "bert"},
                    "config": {**source.get("config", {}), "device": dev,
                               **buckets},
                    **{k: v for k, v in source.items() if k != "config"}}}}))
            isvc = _isvc_wait(cluster, name,
                              lambda i: str(i.status.phase.value) == "Ready",
                              "Ready", timeout=300)
            ready_s = time.perf_counter() - t0
            url = f"{isvc.status.url}/v1/models/{name}:predict"
            ms = []
            for _ in range(sizes["requests"]):
                t0 = time.perf_counter()
                got = np.asarray(_http_post(url, {"instances": rows})[
                    "predictions"])
                ms.append((time.perf_counter() - t0) * 1e3)
            err = float(np.abs(got - probs).max())
            require(err <= 1e-3,
                    f"{name}: served probabilities {err} from the direct")
            out[name] = {"ready_s": ready_s, "request_ms_p50": _pct(ms, 0.5),
                         "request_ms": ms, "vs_direct_max_abs": err}
        out["snapshot_write_s"] = save_s
        out["snapshot_bytes"] = _dir_bytes(snap)
    finally:
        cluster.stop()
        shutil.rmtree(snap, ignore_errors=True)
    direct.stop()
    del model, direct
    _free_card(cuda)
    # a 2-layer cut: the card's bf16 forward against the CPU's f32 forward
    cut = dataclasses.replace(cfg, num_layers=sizes["cut_layers"])
    small = bert.BertClassifier(cut, device=dev)
    small.init_weights(SEED)
    plain = bert.BertClassifier(dataclasses.replace(cut, dtype=torch.float32),
                                device="cpu")
    plain.load_state_dict({k: v.cpu() for k, v in
                           small.state_dict().items()})
    ids = torch.tensor([r + [0] * (s - len(r)) for r in ragged])
    mask = torch.tensor([[j < len(r) for j in range(s)] for r in ragged])
    with torch.inference_mode():
        p_card = small(ids.to(dev), mask.to(dev)).float().softmax(-1).cpu()
        p_cpu = plain(ids, mask).softmax(-1)
    cut_err = float((p_card - p_cpu).abs().max())
    out["cut"] = {"layers": cut.num_layers, "dtype": str(cut.dtype),
                  "vs_cpu_f32_max_abs": cut_err}
    require(cut_err <= 2e-2, f"bert card vs CPU: {cut_err}")
    del small, plain
    _free_card(cuda)
    return out


def phase_bert_serve(line: str) -> dict:
    """BERT-base at full width and depth (``bert_base()``: 12 layers, 768
    wide, bf16 activations, f32 params), random weights from SEED."""
    from kubeflow_tpu_torch.models import bert

    r = bert_serve(bert.bert_base())
    emit("bert_serve", card=line, model="bert_base", **r)
    return r


def conv_flops(model, image: int) -> int:
    """The forward FLOPs of one image through ``model``'s convolutions and
    head, from their shapes (2 x MACs; norms, activations and pools are
    not counted): each ``Conv``'s output ``[1, cout, ho, wo]`` x ``cin k k``,
    the head's ``in x out``."""
    import torch

    from kubeflow_tpu_torch.models.resnet import Conv

    total = [0]

    def conv(mod, inp, out):
        w = mod.weight
        total[0] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]

    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, Conv)]
    try:
        dev = next(model.parameters()).device
        with torch.no_grad():
            model(torch.zeros(1, image, image, 3, device=dev))
    finally:
        for h in hooks:
            h.remove()
    head = model.head
    return total[0] + 2 * head.in_features * head.out_features


def resnet_train(cfg, tiny_cfg, device=None, sizes=RESNET) -> dict:
    """ResNet training steps through the port's model and SGD with momentum
    (``phase_resnet_train`` on the card with ``resnet50()``; ``device=
    "cpu"`` with small configs rehearses it), then one ``tiny_cfg`` f32
    step on ``device`` against the same step on the CPU."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models import resnet

    cuda = device is None
    dev = device or "cuda"
    _free_card(cuda)
    model = resnet.ResNet(cfg, device=dev)
    model.init_weights(SEED)
    fwd = conv_flops(model, sizes["image"])
    opt = torch.optim.SGD(model.parameters(), lr=sizes["lr"], momentum=0.9)
    rng = np.random.default_rng(SEED)
    b, hw = sizes["batch"], sizes["image"]
    x = torch.from_numpy(rng.standard_normal((b, hw, hw, 3),
                                             dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, cfg.num_classes, b)).to(dev)

    def step():
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    losses = [step() for _ in range(sizes["warm"])]
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(sizes["timed"])]
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    require(all(map(math.isfinite, losses)), f"resnet losses {losses}")
    ips = sizes["timed"] * b / dt
    out = {"params": sum(p.numel() for p in model.parameters()),
           "batch": b, "image": hw, "dtype": str(cfg.dtype),
           "memory_format": "channels_last", "losses": losses,
           "step_ms": dt / sizes["timed"] * 1e3, "images_per_sec": ips,
           "forward_flops_per_image": fwd,
           "mfu": ips * 3 * fwd / PEAK_FLOPS,
           "mfu_convention": "3 x the forward FLOPs of the convolutions "
           "and the head (2 x MACs), from the layer shapes",
           "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                              if cuda else 0),
           "mem_at_start_bytes": mem0}
    del model, opt, x, y
    _free_card(cuda)
    # one tiny() f32 step on the device against the CPU
    pb, pi = sizes["parity_batch"], sizes["parity_image"]
    xs = rng.standard_normal((pb, pi, pi, 3), dtype=np.float32)
    ys = rng.integers(0, tiny_cfg.num_classes, pb)
    sides = {}
    for side, d in (("device", dev), ("cpu", "cpu")):
        m = resnet.ResNet(tiny_cfg, device=d)
        if side == "device":
            m.init_weights(SEED)
            init = {k: v.detach().cpu().clone()
                    for k, v in m.state_dict().items()}
        else:
            m.load_state_dict(init)
        o = torch.optim.SGD(m.parameters(), lr=sizes["lr"], momentum=0.9)
        loss = F.cross_entropy(m(torch.from_numpy(xs).to(d)),
                               torch.from_numpy(ys).to(d))
        loss.backward()
        o.step()
        sides[side] = (float(loss.detach()),
                       {k: v.detach().cpu() for k, v in
                        m.state_dict().items()})
    loss_err = abs(sides["device"][0] - sides["cpu"][0])
    worst = max((rel_err(v, sides["cpu"][1][k]), k)
                for k, v in sides["device"][1].items())
    out["parity"] = {"config": "tiny", "loss_device": sides["device"][0],
                     "loss_cpu": sides["cpu"][0], "loss_abs_err": loss_err,
                     "worst_param_rel": worst[0], "worst_param": worst[1]}
    require(loss_err <= 1e-3, f"resnet step loss {out['parity']}")
    require(worst[0] <= 1e-3, f"resnet param {worst[1]} differs {worst[0]}")
    return out


def phase_resnet_train(line: str) -> dict:
    """ResNet-50 (25.6M params, bottleneck, GroupNorm) at 224 x 224, batch
    128, bf16, channels_last, SGD with momentum."""
    from kubeflow_tpu_torch.models import resnet

    r = resnet_train(resnet.resnet50(), resnet.tiny())
    emit("resnet_train", card=line, model="resnet50", **r)
    return r


def machine_card_ids(slots: int) -> list:
    """The card ids of a GPU host built from this machine's cards: each
    card's id ``slots`` times (time-slicing: ``slots`` pods may share a
    card). One card is assumed where CUDA is not available (the CPU
    rehearsal)."""
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return [c for c in range(cards) for _ in range(slots)]


def _own_cards_named(pod, log: str) -> bool:
    """Whether a pod's log names the cards the scheduler gave it."""
    ids = ",".join(map(str, pod.spec.device_ids))
    return bool(ids) and f"the pod's cards {ids}" in log


def _rank_streams(lines: list, k: int) -> list:
    """The ``k`` local ranks' streams of a pod's log lines, where every
    rank prints the same sequence: the i-th occurrence of a line is rank
    i's (the log interleaves them)."""
    streams: list = [[] for _ in range(k)]
    seen: dict = {}
    for x in lines:
        n = seen[x] = seen.get(x, 0) + 1
        require(n <= k, f"a line printed more than {k} times: {x}")
        streams[n - 1].append(x)
    return streams


def run_jaxjobs(jobs: dict, overrides: dict, timeout: float, ids: list,
                pending_cards: int = 0) -> dict:
    """JaxJobs on the port's ``Cluster`` with the port's ``LocalKubelet``,
    run as real pod processes (``python -m kubeflow_tpu_torch.runtime.
    pod_main``) on one GPU host exposing card ids ``ids``: ``jobs`` maps a
    name to (manifest, entry module, env, workers, cards per worker), the
    kubelet's env ``overrides`` on top. Every job must succeed within
    ``timeout`` seconds. With ``pending_cards``, a job of one worker
    asking that many cards (more than the host has) is submitted first;
    it must stay Pending with the scheduler's reason while the others run,
    and is deleted. Returns, per job: (the job, seconds to succeed, per pod
    (pod, log, metric rows)); ``"pending"``: that job's evidence."""
    import os

    from kubeflow_tpu_torch.api.common import (
        JobConditionType, get_condition, has_condition)
    from kubeflow_tpu_torch.api.yaml_io import from_dict
    from kubeflow_tpu_torch.controlplane import Cluster
    from kubeflow_tpu_torch.runtime.launcher import LocalKubelet

    root = tempfile.mkdtemp(prefix="kft-pods-")
    cluster = Cluster()
    cluster.add_gpu_host("host-0", len(ids), device_ids=ids)
    kubelet = LocalKubelet(cluster.store, root, env_overrides=overrides)
    saved = os.environ.pop("KFT_POD_DEVICE", None)
    out: dict = {}
    try:
        with cluster:
            kubelet.start()
            if pending_cards:
                cluster.store.create(from_dict({
                    "kind": "JaxJob", "metadata": {"name": "too-big"},
                    "spec": {"replica_specs": {"worker": {"template": {
                        "entrypoint": "kubeflow_tpu_torch.models.mnist:"
                                      "train_main",
                        "resources": {"gpu": pending_cards}}}}}}))
            t0 = time.perf_counter()
            for name, (job, module, env, replicas, gpu) in jobs.items():
                job.metadata.name = name
                worker = job.spec.replica_specs["worker"]
                worker.replicas = replicas
                worker.template.entrypoint = f"{module}:train_main"
                worker.template.env = {**worker.template.env, **env}
                worker.template.resources.gpu = gpu
                cluster.store.create(job)
            done = {}
            while len(done) < len(jobs):
                for name in jobs:
                    job = cluster.store.get("JaxJob", name)
                    failed = get_condition(job.status.conditions,
                                           JobConditionType.FAILED)
                    require(failed is None or not failed.status,
                            f"{name} failed: {failed and failed.message}")
                    if name not in done and has_condition(
                            job.status.conditions,
                            JobConditionType.SUCCEEDED):
                        done[name] = (job, time.perf_counter() - t0)
                require(time.perf_counter() - t0 < timeout,
                        f"jobs not done: {set(jobs) - set(done)}")
                time.sleep(0.2)
            for name, (job, seconds) in done.items():
                pods = []
                for r in range(jobs[name][3]):
                    pod = f"{name}-worker-{r}"
                    with open(kubelet.pod_log_path("default", pod)) as f:
                        log = f.read()
                    with open(os.path.join(root, "status", "default", pod,
                                           "metrics.jsonl")) as f:
                        rows = [json.loads(x) for x in f]
                    pods.append((cluster.store.get("Pod", pod), log, rows))
                out[name] = (job, seconds, pods)
            if pending_cards:
                pg = cluster.store.get("PodGroup", "too-big")
                (pod,) = cluster.store.list("Pod",
                                            labels={"job-name": "too-big"})
                out["pending"] = {
                    "cards": pending_cards, "host_cards": len(ids),
                    "phase": str(pg.status.phase.value),
                    "reason": pg.status.message,
                    "bound": pod.spec.node_name}
                require(out["pending"]["phase"] == "Pending"
                        and pg.status.message == "insufficient capacity"
                        and pod.spec.node_name is None,
                        f"a job asking {pending_cards} cards: {out['pending']}")
                cluster.store.delete("JaxJob", "too-big")
                deadline = time.monotonic() + 30
                while cluster.store.list("Pod",
                                         labels={"job-name": "too-big"}):
                    require(time.monotonic() < deadline,
                            "the pending job's pod outlived its job")
                    time.sleep(0.1)
                out["pending"]["deleted"] = True
    finally:
        kubelet.stop()
        if saved is not None:
            os.environ["KFT_POD_DEVICE"] = saved
        shutil.rmtree(root, ignore_errors=True)
    return out


def _metric_lists(rows: list) -> dict:
    metrics: dict = {}
    for r in rows:
        metrics.setdefault(r["name"], []).append(r["value"])
    return metrics


def _example_jobs(sizes: dict, resnet_env: dict) -> dict:
    """``examples/01``'s MNIST job and ``examples/02``'s ResNet job, with
    the port's entry modules: (manifest, module, env) each."""
    import os

    from kubeflow_tpu_torch.api.yaml_io import load_yaml_file

    examples = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples")
    (mnist,) = load_yaml_file(os.path.join(examples,
                                           "01-jaxjob-mnist.yaml"))
    (resnet,) = load_yaml_file(os.path.join(examples,
                                            "02-jaxjob-resnet-ddp.yaml"))
    return {"mnist-smoke": (mnist, "kubeflow_tpu_torch.models.mnist", {
        "KFT_STEPS": str(sizes["mnist_steps"]),
        "KFT_BATCH": str(sizes["mnist_batch"])}),
        "resnet": (resnet, "kubeflow_tpu_torch.models.resnet", resnet_env)}


def jaxjob_pods(device=None, sizes=PODS) -> dict:
    """JaxJobs on the port's ``Cluster`` with the port's ``LocalKubelet``:
    ``examples/01``'s MNIST job and a one-worker ResNet job, each worker
    asking one card, run as real pod processes (``python -m
    kubeflow_tpu_torch.runtime.pod_main``) on a GPU host built from the
    machine's cards (each card's id twice) on the card (``device=None``:
    no ``KFT_POD_DEVICE``; ``"cpu"`` rehearses it); a job asking more
    cards than the host has stays Pending with the scheduler's reason and
    is deleted. Both must succeed with finite metrics, their logs naming
    the device and the card they were given."""
    jobs = {name: (*job, 1, 1) for name, job in _example_jobs(sizes, {
        "KFT_RESNET": sizes["resnet"],
        "KFT_STEPS": str(sizes["resnet_steps"]),
        "KFT_BATCH": str(sizes["resnet_batch"])}).items()}
    ids = machine_card_ids(2)
    ran = run_jaxjobs(jobs, {} if device is None else {
        "KFT_POD_DEVICE": device}, sizes["timeout"], ids,
        pending_cards=len(ids) + 1)
    out: dict = {"host_card_ids": ids, "pending": ran.pop("pending")}
    for name, (job, seconds, [(p, log, rows)]) in ran.items():
        metrics = _metric_lists(rows)
        where = f"on {device or 'cuda'}"
        out[name] = {
            "succeeded_s": seconds,
            "gang_startup_s": job.status.gang_startup_seconds,
            "pod_wall_s": p.status.finish_time - p.status.start_time,
            "metrics": metrics,
            "card_ids": p.spec.device_ids,
            "log_names_device": where in log}
        require(where in log, f"jaxjob_pods: {name} log: {log}")
        require(_own_cards_named(p, log),
                f"jaxjob_pods: {name} log names no card of "
                f"{p.spec.device_ids}: {log}")
        require(metrics.get("loss") and all(
            math.isfinite(v) for vs in metrics.values()
            for v in vs), f"jaxjob_pods: {name} metrics {metrics}")
        require(job.status.gang_startup_seconds is not None,
                f"jaxjob_pods: {name} passed no barrier")
    require("accuracy" in out["mnist-smoke"]["metrics"],
            "jaxjob_pods: mnist emitted no accuracy")
    return out


def phase_jaxjob_pods(line: str) -> dict:
    r = jaxjob_pods()
    emit("jaxjob_pods", card=line, sizes=PODS, **r)
    return r


def _token_stream(vocab: int, batch: int, seq: int, seed: int = SEED):
    """Endless numpy-seeded token rows [batch, seq + 1]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)


class _PairMarks:
    """``darts_search``'s ``on_step``: a CUDA event after each step pair
    (a host clock reading on the CPU); ``ms()`` is the mean ms a pair
    between the first mark and the last."""

    def __init__(self, cuda: bool):
        self.cuda, self.marks = cuda, []

    def __call__(self, i, loss) -> None:
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> float:
        m = self.marks
        if self.cuda:
            import torch

            torch.cuda.synchronize()
            return m[0].elapsed_time(m[-1]) / (len(m) - 1)
        return (m[-1] - m[0]) / (len(m) - 1) * 1e3


def _darts_launches(layers: int, steps: int, keys) -> dict:
    """The kernel launches of ``steps`` DARTS step pairs of a supernet
    ``layers`` deep, for every counter key in ``keys``. No remat: K1 once
    a layer in each step's forward; the alpha step's backward skips the
    first layer's attention (its input is the frozen embedding: nothing
    there needs a gradient), so K2 and K3 run 2L - 1 times a pair."""
    per_pair = {"flash_fwd": 2 * layers, "flash_bwd_dkv": 2 * layers - 1,
                "flash_bwd_dq": 2 * layers - 1}
    return {k: per_pair.get(k, 0) * steps for k in keys}


def darts_run(base, small, device=None, sizes=DARTS,
              kernels: bool = True) -> dict:
    """``hpo/nas.py`` ``darts_search`` at ``base``'s width (``phase_darts_
    search``: the bench model's, flash, bf16), timed by CUDA events between
    step pairs, its K1-K3 launches counted (``kernels``: they must be the
    supernet's, below); then the first step pair of a ``small`` supernet on
    the device against the same pair on the CPU."""
    import dataclasses

    import numpy as np
    import torch

    from kubeflow_tpu_torch.hpo import nas

    cuda = device is None
    dev = device or "cuda"
    _free_card(cuda)
    space = nas.ArchSpace(max_layers=sizes["max_layers"],
                          ffn_widths=tuple(sizes["ffn_widths"]))
    on_step = _PairMarks(cuda)
    for c in _counters():
        for key in c:
            c[key] = 0
    t0 = time.perf_counter()
    res = nas.darts_search(
        base, space, _token_stream(base.vocab_size, sizes["batch"],
                                   sizes["seq"]),
        steps=sizes["steps"], seed=SEED, device=dev, on_step=on_step)
    wall = time.perf_counter() - t0
    launches = {k: v for c in _counters() for k, v in c.items()}
    pair_ms = on_step.ms()
    expect = _darts_launches(space.max_layers, sizes["steps"], launches)
    out = {"hidden": base.hidden_size, "heads": base.num_heads,
           "head_dim": base.head_dim, "vocab": base.vocab_size,
           "attention_impl": base.attention_impl, "dtype": str(base.dtype),
           "space": dataclasses.asdict(space), "batch": sizes["batch"],
           "seq": sizes["seq"], "step_pairs": sizes["steps"],
           "ms_per_step_pair": pair_ms, "wall_s": wall,
           "alpha_depth": res.alpha_depth.tolist(),
           "alpha_ffn": res.alpha_ffn.tolist(), "ranked_top": res.ranked[:4],
           "final_loss": res.final_loss, "launches": launches,
           "launches_expected": expect}
    require(math.isfinite(res.final_loss), f"darts loss {res.final_loss}")
    if kernels:
        require(launches == expect and all(
            launches[k] > 0 for k in FLASH_PER_LAYER),
            f"darts launches {launches} != {expect}")
    _free_card(cuda)
    # the first step pair of a small supernet: the device against the CPU
    small_space = nas.ArchSpace(max_layers=sizes["small_layers"],
                                ffn_widths=tuple(sizes["small_widths"]))
    init = nas.SupernetLM(nas.supernet_config(small, small_space),
                          small_space, device=dev)
    init.init_weights(SEED)
    state = {k: v.detach().cpu().clone()
             for k, v in init.state_dict().items()}
    pair, grads = {}, {}

    def record(side):
        """The alpha step's gradients (the weight step freezes them)."""
        def hook(model):
            for p in model.arch_parameters():
                p.register_hook(lambda g: grads.setdefault(side, []).append(
                    g.detach().double().cpu()))
        return hook

    for side, d in (("device", dev), ("cpu", "cpu")):
        pair[side] = nas.darts_search(
            small, small_space, _token_stream(small.vocab_size, 4, 128),
            steps=1, device=d, init_state=state, on_init=record(side))
    loss_rel = (abs(pair["device"].final_loss - pair["cpu"].final_loss)
                / abs(pair["cpu"].final_loss))
    g_dev, g_cpu = (torch.cat(grads[k]) for k in ("device", "cpu"))
    grad_rel = float((g_dev - g_cpu).abs().max() / g_cpu.abs().max())
    alphas = {k: np.concatenate([r.alpha_depth, r.alpha_ffn])
              for k, r in pair.items()}
    alpha_err = np.abs(alphas["device"] - alphas["cpu"])
    # Adam's first step is -lr * g / (|g| + eps): +-lr whatever |g|, so an
    # alpha whose gradient is within the card-vs-CPU difference of zero may
    # step either way (as Adafactor's sign(g) leaves in _adafactor_parity);
    # only a gradient under 5e-2 of the largest may be excused
    near_zero = ((g_cpu.abs() <= (g_dev - g_cpu).abs())
                 & (g_cpu.abs() <= 5e-2 * g_cpu.abs().max())).numpy()
    held = float(alpha_err[~near_zero].max(initial=0.0))
    out["parity"] = {"loss_device": pair["device"].final_loss,
                     "loss_cpu": pair["cpu"].final_loss,
                     "loss_rel": loss_rel, "alpha_grad_rel": grad_rel,
                     "alpha_grads_cpu": g_cpu.tolist(),
                     "alpha_grads_device": g_dev.tolist(),
                     "alpha_max_abs_err": float(alpha_err.max()),
                     "alpha_max_abs_err_held": held,
                     "alphas_at_near_zero_gradient": int(near_zero.sum()),
                     "alphas_cpu": alphas["cpu"].tolist()}
    require(loss_rel <= 1e-2, f"darts card vs CPU loss: {out['parity']}")
    # each alpha gradient is a softmax-Jacobian sum over every token: in
    # bf16 it read 2.7e-2 and 3.9e-2 from the CPU's in two runs (NVIDIA
    # H100 80GB HBM3, 700 W)
    require(grad_rel <= 1e-1, f"darts card vs CPU grads: {out['parity']}")
    require(held <= 5e-2, f"darts card vs CPU alphas: {out['parity']}")
    del init
    _free_card(cuda)
    return out


def phase_darts_search(line: str) -> dict:
    """The supernet at ``bench_model()``'s width (hidden 1024, 8 heads,
    head_dim 128, vocab 32k, flash, bf16), 4 layers, FFN 1408 or 2816."""
    import torch

    from kubeflow_tpu_torch.models import llama

    small = llama.tiny(head_dim=64, attention_impl="flash",
                       dtype=torch.bfloat16)
    r = darts_run(llama.bench_model(), small)
    emit("darts_search", card=line, model="bench_model supernet", **r)
    return r


def write_corpus(path: str, vocab: int, sizes=CORPUS) -> dict:
    """``sizes["docs"]`` documents of uniform lengths in [min_len,
    max_len], ids uniform below ``vocab``, from SEED, through
    ``TokenCorpus.write``."""
    import numpy as np

    from kubeflow_tpu_torch.train.native_data import TokenCorpus

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(sizes["min_len"], sizes["max_len"] + 1,
                           sizes["docs"])
    ids = rng.integers(0, vocab, int(lengths.sum())).astype(np.int32)
    t0 = time.perf_counter()
    TokenCorpus.write(path, np.split(ids, np.cumsum(lengths)[:-1]))
    return {"docs": int(len(lengths)), "tokens": int(lengths.sum()),
            "write_s": time.perf_counter() - t0}


def corpus_train(base: str, work: str, device=None, sizes=CORPUS,
                 kernels: bool = True) -> dict:
    """The pod entry ``train/llm.py`` ``train_main`` fed a packed corpus
    (``KFT_CORPUS_DIR``) on the ``base`` snapshot, a LoRA of
    ``lora_rank`` (``phase_corpus_train``: llama_1b, 8 x 2048). The batches
    the trainer consumed must be ``PackedLmCorpus.local_batch(step)``, the
    native library must be the one that ran, and (``kernels``) K1-K3 must
    launch."""
    import os

    import numpy as np

    from kubeflow_tpu_torch import native
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train import native_data, trainer

    cuda = device is None
    _free_card(cuda)
    cfg = llama.load_pretrained_config(base)
    corpus_dir = os.path.join(work, "corpus")
    out = {"corpus": write_corpus(corpus_dir, cfg.vocab_size, sizes)}
    env = {"KFT_CORPUS_DIR": corpus_dir, "KFT_INIT_FROM": f"file://{base}",
           "KFT_LORA_RANK": str(sizes["lora_rank"]),
           "KFT_STEPS": str(sizes["steps"]),
           "KFT_BATCH": str(sizes["batch"]),
           "KFT_SEQ_LEN": str(sizes["seq"]), "KFT_LOG_EVERY": "1",
           **({} if cuda else {"KFT_POD_DEVICE": device})}
    seen = []
    real = trainer.Trainer.loss_and_grads

    def record(self, tokens):
        seen.append(np.array(tokens, copy=True))
        return real(self, tokens)

    trainer.Trainer.loss_and_grads = record
    try:
        t, rows, launches, seconds = _train_main(
            env, os.path.join(work, "corpus-status"))
    finally:
        trainer.Trainer.loss_and_grads = real
    lib = native.load_library()
    require(lib is not None, "corpus_train: the native loader did not build")
    packed = native_data.PackedLmCorpus(
        native_data.TokenCorpus.open(corpus_dir), sizes["batch"],
        sizes["seq"])
    require(len(seen) == sizes["steps"] and all(
        np.array_equal(tok, packed.local_batch(step)["tokens"])
        for step, tok in enumerate(seen)),
        "corpus_train: the trainer's batches are not the packed corpus's")
    losses = [r["value"] for r in _metric(rows, "loss")]
    require(len(losses) == sizes["steps"]
            and all(map(math.isfinite, losses)),
            f"corpus_train losses {losses}")
    expect = {k: FINETUNE_PER_LAYER.get(k, 0) * cfg.num_layers
              * sizes["steps"] for k in launches}
    if kernels:
        require(launches == expect and all(
            launches[k] > 0 for k in FINETUNE_PER_LAYER),
            f"corpus_train launches {launches} != {expect}")
    tps = [r["value"] for r in _metric(rows, "tokens_per_sec_per_chip")]
    steady = statistics.median(tps[1:]) if len(tps) > 1 else tps[0]
    flops_tok = llama.flops_per_token(cfg, sizes["seq"])
    out.update(
        native_library=os.path.basename(lib._name), seconds=seconds,
        batches_per_epoch=packed.batches_per_epoch, losses=losses,
        tokens_per_sec_steps=tps, tokens_per_sec=steady,
        mfu=steady * flops_tok / PEAK_FLOPS, launches=launches,
        launches_expected=expect, batch=sizes["batch"], seq=sizes["seq"],
        lora_rank=sizes["lora_rank"])
    del t
    _free_card(cuda)
    return out


def phase_corpus_train(base: str, work: str, line: str) -> dict:
    """The corpus-fed rank-8 LoRA of llama_1b (the ``finetune`` phase's
    base snapshot) at 8 x 2048 through the pod entry."""
    r = corpus_train(base, work)
    emit("corpus_train", card=line, model="llama_1b", **r)
    return r


# -- HPO sweeps: the Katib tier on LocalPlatform -------------------------------

#: hpo_sweep: a user's learning-rate sweep of the fine-tune (a rank-8 LoRA
#: of the ``finetune`` phase's llama_1b base at 8 x 2048, 4 steps a trial);
#: one card runs one trainer at a time, so one trial at a time
HPO_SWEEP = dict(trials=3, steps=4, lora_rank=8, batch=8, seq=2048,
                 lr_min=1e-5, lr_max=1e-3, timeout=900)
#: nas_experiment: the darts suggester on ``darts_run``'s task, then each
#: suggested (layers, ffn_width) trained at the bench width, 3 steps of
#: 8 x 1024 (``arch_trial_main``)
NAS_EXPERIMENT = dict(trials=2, steps=3, batch=8, seq=1024,
                      base="bench_model", timeout=600)
NAS_TASK = "chip-smoke-darts"


def _sweep_manifest(base: str, sizes: dict) -> str:
    """``examples/04-experiment-bo.yaml``'s shape: a ``bayesianoptimization``
    sweep of ``lr`` (log scale) minimizing the trainer's ``loss``, each
    trial a JaxJob of one worker running the pod entry ``train_main``."""
    return f"""\
apiVersion: kubeflow-tpu.dev/v1
kind: Experiment
metadata:
  name: lr-sweep
spec:
  objective:
    type: minimize
    objectiveMetricName: loss
  algorithm:
    algorithmName: bayesianoptimization
  parameters:
    - name: lr
      parameterType: double
      feasibleSpace:
        min: {sizes["lr_min"]}
        max: {sizes["lr_max"]}
        logScale: true
  parallelTrialCount: 1
  maxTrialCount: {sizes["trials"]}
  trialTemplate:
    jobManifest:
      kind: JaxJob
      metadata:
        name: placeholder
      spec:
        replicaSpecs:
          worker:
            replicas: 1
            template:
              entrypoint: kubeflow_tpu_torch.train.llm:train_main
              resources:
                gpu: 1
              env:
                KFT_INIT_FROM: "file://{base}"
                KFT_LORA_RANK: "{sizes["lora_rank"]}"
                KFT_SEQ_LEN: "{sizes["seq"]}"
                KFT_BATCH: "{sizes["batch"]}"
                KFT_STEPS: "{sizes["steps"]}"
                KFT_LOG_EVERY: "1"
                KFT_LR: "${{trialParameters.lr}}"
"""


class _TimedSuggestions:
    """Times every GetSuggestions call the port's suggestion controller
    makes in this process (the RPC to its algorithm service)."""

    def __enter__(self):
        from kubeflow_tpu_torch.hpo import service

        self.ms: list = []
        self._cls = service.SuggestionClient
        self._real = real = self._cls.get_suggestions
        calls = self.ms

        def timed(client, *a, **kw):
            t0 = time.perf_counter()
            try:
                return real(client, *a, **kw)
            finally:
                calls.append((time.perf_counter() - t0) * 1e3)

        self._cls.get_suggestions = timed
        return self

    def __exit__(self, *exc):
        self._cls.get_suggestions = self._real


def _local_platform(device):
    """The port's ``LocalPlatform`` on one GPU host built from the
    machine's cards (each card's id twice; real pod processes; no
    ``KFT_POD_DEVICE``, so each trial pod takes the card it is given,
    unless ``device`` names one) with its API server and dashboard up:
    (platform, api URL, dashboard URL)."""
    from kubeflow_tpu_torch.runtime.platform import LocalPlatform

    ids = machine_card_ids(2)
    p = LocalPlatform(root_dir=tempfile.mkdtemp(prefix="kft-hpo-"),
                      gpus_per_host=len(ids), device_ids=ids,
                      env_overrides={} if device is None else {
                          "KFT_POD_DEVICE": device})
    p.start()
    return p, p.cluster.serve_api(), p.cluster.serve_dashboard()


def _wait_experiment(p, name: str, timeout: float) -> tuple:
    """(the Experiment once completed, seconds waited); a failed trial
    fails at once, with its job's message."""
    t0 = time.perf_counter()
    while True:
        exp = p.store.try_get("Experiment", name)
        for t in p.store.list("Trial"):
            job = p.store.try_get("JaxJob", t.metadata.name)
            require(t.status.phase != "Failed", f"{name}: {t.metadata.name} "
                    f"failed: {job and job.status.conditions}")
        if exp is not None and exp.status.completed:
            return exp, time.perf_counter() - t0
        require(time.perf_counter() - t0 < timeout,
                f"{name} not done in {timeout} s: {exp and exp.status}")
        time.sleep(0.2)


def _trial_rows(p, exp_name: str, device) -> list[dict]:
    """Per trial of ``exp_name``, in issue order: its assignments and
    observation, s from the Trial's creation to its pod Running, the pod's
    wall s and the s of it before its first metric (the process's start,
    imports, model and first step), its log naming the device, and its
    metric rows."""
    import os

    rows = []
    trials = sorted((t for t in p.store.list("Trial")
                     if t.spec.experiment_name == exp_name),
                    key=lambda t: t.metadata.name)
    for t in trials:
        pod_name = f"{t.metadata.name}-worker-0"
        pod = p.store.get("Pod", pod_name)
        with open(p.kubelet.pod_log_path("default", pod_name)) as f:
            log = f.read()
        with open(os.path.join(p.root_dir, "status", "default", pod_name,
                               "metrics.jsonl")) as f:
            metrics = [json.loads(x) for x in f]
        job = p.store.get("JaxJob", t.metadata.name)
        tps = [r["value"] for r in _metric(metrics,
                                            "tokens_per_sec_per_chip")]
        rows.append({
            "trial": t.metadata.name, "phase": t.status.phase,
            "assignments": {a.name: a.value for a in t.spec.assignments},
            "observation": t.status.observation,
            "created_to_running_s": (pod.status.start_time
                                     - t.metadata.creation_timestamp),
            "pod_wall_s": pod.status.finish_time - pod.status.start_time,
            "pod_start_to_first_metric_s": (
                metrics[0]["ts"] - pod.status.start_time if metrics
                else None),
            "log_names_device": f"on {device or 'cuda'}" in log,
            "losses": [r["value"] for r in _metric(metrics, "loss")],
            "tokens_per_sec": (statistics.median(tps[1:]) if len(tps) > 1
                               else (tps[0] if tps else None)),
            "env": dict(job.spec.replica_specs["worker"].template.env)})
    return rows


def _cli(*argv) -> str:
    """The port's CLI in this process: its standard output."""
    import contextlib
    import io

    from kubeflow_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    require(rc == 0, f"kft {' '.join(argv)}: exit {rc}")
    return out.getvalue()


def hpo_sweep(base: str, work: str, device=None, sizes=HPO_SWEEP,
              kernels: bool = True) -> dict:
    """An HPO sweep on the port's ``LocalPlatform`` (``phase_hpo_sweep``:
    llama_1b's rank-8 LoRA on the card), submitted through the CLI
    (``kft apply -f``) to the API server: a ``bayesianoptimization``
    experiment over ``lr``, its trials pod processes running the pod entry
    ``train_main``. The experiment must succeed with every trial, every
    trial's log naming the device and every loss finite; the optimum must
    be the trial of the lowest final loss; the db must hold each trial's
    per-step curve when the experiment completes (read once, no wait) and
    the dashboard's experiment page list every trial.
    Then the best trial's env runs once more in this process
    (``_train_main``): K1/K2/K3 must launch 2/1/1 a layer and step
    (``kernels``), and its per-step losses must be the pod's within
    ``MESH_LOSS_TOL``; every trial's first loss (before any update, so
    whatever its lr) must agree within it too."""
    import os
    import urllib.request

    from kubeflow_tpu_torch.models import llama

    cuda = device is None
    _free_card(cuda)
    cfg = llama.load_pretrained_config(base)
    manifest = os.path.join(work, "lr-sweep.yaml")
    with open(manifest, "w") as f:
        f.write(_sweep_manifest(base, sizes))
    saved = os.environ.pop("KFT_POD_DEVICE", None)
    p, url, dash = _local_platform(device)
    try:
        with _TimedSuggestions() as rpc:
            t0 = time.perf_counter()
            applied = _cli("--server", url, "apply", "-f", manifest)
            exp, wall = _wait_experiment(p, "lr-sweep", sizes["timeout"])
        # read at completion, with no wait: a trial reports its curve to
        # the db before its phase turns Succeeded, and the experiment
        # completes on those phases
        curves = {}
        for r in p.cluster._db_client.get_observation_log("lr-sweep"):
            if r["step"] >= 0:
                curves.setdefault(r["trial"], []).append(r["value"])
        print(_cli("--server", url, "get", "experiments"), end="")
        print(_cli("--server", url, "describe", "exp", "lr-sweep"), end="")
        trials = _trial_rows(p, "lr-sweep", device)
        with urllib.request.urlopen(
                f"{dash}/api/experiments/default/lr-sweep", timeout=30) as r:
            page = (r.status, json.loads(r.read()))
    finally:
        p.stop()
        if saved is not None:
            os.environ["KFT_POD_DEVICE"] = saved
    require(applied.strip() == "experiment/lr-sweep created",
            f"hpo_sweep: kft apply said {applied!r}")
    require(exp.status.trials_succeeded == sizes["trials"]
            and len(trials) == sizes["trials"]
            and all(t["phase"] == "Succeeded" for t in trials),
            f"hpo_sweep: {exp.status}")
    for t in trials:
        require(t["log_names_device"], f"hpo_sweep: {t['trial']}'s log "
                f"does not name {device or 'cuda'}")
        require(len(t["losses"]) == sizes["steps"]
                and all(map(math.isfinite, t["losses"])),
                f"hpo_sweep: {t['trial']} losses {t['losses']}")
        require(t["observation"] == t["losses"][-1],
                f"hpo_sweep: {t['trial']} observed {t['observation']}")
    best = min(trials, key=lambda t: t["observation"])
    require(exp.status.current_optimal_trial == best["trial"],
            f"hpo_sweep: optimum {exp.status.current_optimal_trial} is not "
            f"the lowest loss {best['trial']}")
    require(all(curves.get(t["trial"]) == t["losses"] for t in trials),
            f"hpo_sweep: the db's curves {curves}")
    require(page[0] == 200 and sorted(page[1]["curves"]) == sorted(
        t["trial"] for t in trials), f"hpo_sweep: dashboard {page}")
    first = [t["losses"][0] for t in trials]
    first_rel = max(abs(x - first[0]) / abs(first[0]) for x in first)
    require(first_rel <= MESH_LOSS_TOL,
            f"hpo_sweep: the trials' first losses differ: {first}")
    # the best trial once more in this process, where its launches count
    env = {**best["env"], **({} if cuda else {"KFT_POD_DEVICE": device})}
    t, rows, launches, seconds = _train_main(
        env, os.path.join(work, "hpo-twin-status"))
    del t
    twin = [r["value"] for r in _metric(rows, "loss")]
    twin_rel = max(abs(a - b) / abs(b) for a, b in zip(twin, best["losses"]))
    expect = {k: FINETUNE_PER_LAYER.get(k, 0) * cfg.num_layers
              * sizes["steps"] for k in launches}
    out = {"experiment_wall_s": wall, "suggestion_rpc_ms": rpc.ms,
           "optimal_trial": exp.status.current_optimal_trial,
           "optimal_lr": best["assignments"]["lr"],
           "trials": [{k: v for k, v in t.items() if k != "env"}
                      for t in trials],
           "first_loss_rel_spread": first_rel,
           "twin": {"losses": twin, "max_rel_err_vs_pod": twin_rel,
                    "launches": launches, "launches_expected": expect,
                    "seconds": seconds}}
    require(twin_rel <= MESH_LOSS_TOL,
            f"hpo_sweep: the in-process twin's losses {twin} are not the "
            f"best trial pod's {best['losses']}")
    if kernels:
        require(launches == expect and all(
            launches[k] > 0 for k in FINETUNE_PER_LAYER),
            f"hpo_sweep: twin launches {launches} != {expect}")
    _free_card(cuda)
    return out


def phase_hpo_sweep(base: str, work: str, line: str) -> dict:
    """``hpo_sweep`` on the ``finetune`` phase's llama_1b base."""
    r = hpo_sweep(base, work)
    emit("hpo_sweep", card=line, model="llama_1b", sizes=HPO_SWEEP, **r)
    return r


def arch_trial_main(ctx) -> None:
    """The pod entry of ``nas_experiment``'s trials: the width of the
    model named by ``KFT_ARCH_BASE`` (default ``bench_model``) at the
    suggested depth ``KFT_LAYERS`` and FFN width ``KFT_FFN_WIDTH``, trained
    ``KFT_STEPS`` steps of ``KFT_BATCH`` x ``KFT_SEQ_LEN`` from SEED on
    the pod's device; emits ``loss`` and ``tokens_per_sec_per_chip``
    every step (``bootstrap.emit_metric``)."""
    import dataclasses
    import os

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

    e = os.environ
    model = dataclasses.replace(
        getattr(llama, e.get("KFT_ARCH_BASE", "bench_model"))(),
        num_layers=int(e["KFT_LAYERS"]),
        intermediate_size=int(e["KFT_FFN_WIDTH"]))
    t = Trainer(TrainConfig(model=model, global_batch=int(e["KFT_BATCH"]),
                            seq_len=int(e["KFT_SEQ_LEN"]),
                            steps=int(e["KFT_STEPS"]), log_every=1),
                device=bootstrap.pod_device(ctx))
    print(f"arch_trial: training {e['KFT_LAYERS']} layers, ffn "
          f"{e['KFT_FFN_WIDTH']} on {t.device}", flush=True)
    t.init_state(SEED)

    def on_metrics(m) -> None:
        bootstrap.emit_metric(ctx, "loss", m.loss, step=m.step)
        bootstrap.emit_metric(ctx, "tokens_per_sec_per_chip",
                              m.tokens_per_sec_per_chip, step=m.step)

    t.train(on_metrics=on_metrics)


def nas_experiment(base, ranked_top: list, device=None, sizes=NAS_EXPERIMENT,
                   darts=DARTS, kernels: bool = True) -> dict:
    """A ``darts`` experiment on the port's ``LocalPlatform``
    (``phase_nas_experiment``: the supernet at the bench width on the card):
    ``settings.task_ref`` names ``darts_run``'s task (``base``'s width,
    ``darts``' sizes, SEED), registered in this process, where the
    suggestion service trains the supernet; each trial trains its
    suggested shape in a pod (``arch_trial_main``). The trials must be
    ``ranked_top``'s first, in order (``phase_darts_search``'s ranking of
    the same task), the K1-K3 launches in this process ``darts_run``'s
    (``kernels``), and both trials must succeed on the device with finite
    losses."""
    import os

    from kubeflow_tpu_torch.hpo import nas
    from kubeflow_tpu_torch.sdk import KatibClient

    cuda = device is None
    dev = device or "cuda"
    _free_card(cuda)
    space = nas.ArchSpace(max_layers=darts["max_layers"],
                          ffn_widths=tuple(darts["ffn_widths"]))
    on_step = _PairMarks(cuda)
    nas.register_task(NAS_TASK, lambda: (
        base, space, _token_stream(base.vocab_size, darts["batch"],
                                   darts["seq"]),
        {"device": dev, "on_step": on_step}))
    exp = {
        "kind": "Experiment", "metadata": {"name": "arch-search"},
        "spec": {
            "objective": {"type": "minimize", "objective_metric_name": "loss"},
            "algorithm": {"algorithm_name": "darts", "settings": {
                "task_ref": NAS_TASK,
                "supernet_steps": str(darts["steps"])}},
            "parameters": [
                {"name": "layers", "parameter_type": "int",
                 "feasible_space": {"min": 1, "max": space.max_layers}},
                {"name": "ffn_width", "parameter_type": "categorical",
                 "feasible_space": {"list": [str(w) for w in
                                             space.ffn_widths]}}],
            "parallel_trial_count": 1, "max_trial_count": sizes["trials"],
            "trial_template": {"job_manifest": {
                "kind": "JaxJob", "metadata": {"name": "placeholder"},
                "spec": {"replica_specs": {"worker": {"replicas": 1,
                         "template": {
                             "entrypoint": "chip_smoke:arch_trial_main",
                             "resources": {"gpu": 1},
                             "env": {
                                 "KFT_ARCH_BASE": sizes["base"],
                                 "KFT_LAYERS": "${trialParameters.layers}",
                                 "KFT_FFN_WIDTH":
                                     "${trialParameters.ffn_width}",
                                 "KFT_STEPS": str(sizes["steps"]),
                                 "KFT_BATCH": str(sizes["batch"]),
                                 "KFT_SEQ_LEN": str(sizes["seq"])}}}}}}}}}
    for c in _counters():
        for key in c:
            c[key] = 0
    saved = os.environ.pop("KFT_POD_DEVICE", None)
    p, url, dash = _local_platform(device)
    try:
        with _TimedSuggestions() as rpc:
            KatibClient(p).create_experiment(exp)
            got, wall = _wait_experiment(p, "arch-search", sizes["timeout"])
        launches = {k: v for c in _counters() for k, v in c.items()}
        trials = _trial_rows(p, "arch-search", device)
    finally:
        p.stop()
        if saved is not None:
            os.environ["KFT_POD_DEVICE"] = saved
    pair_ms = on_step.ms()
    expect = _darts_launches(space.max_layers, darts["steps"], launches)
    want = [{"layers": int(l), "ffn_width": int(w)}
            for l, w in ranked_top[:sizes["trials"]]]
    out = {"experiment_wall_s": wall, "suggestion_rpc_ms": rpc.ms,
           "supernet_ms_per_step_pair": pair_ms,
           "step_pairs": len(on_step.marks),
           "launches": launches, "launches_expected": expect,
           "assignments": [t["assignments"] for t in trials],
           "ranked_top": want,
           "optimal_trial": got.status.current_optimal_trial,
           "trials": [{k: v for k, v in t.items() if k != "env"}
                      for t in trials]}
    require(got.status.trials_succeeded == sizes["trials"]
            and len(trials) == sizes["trials"],
            f"nas_experiment: {got.status}")
    require(out["assignments"] == want,
            f"nas_experiment: suggested {out['assignments']}, "
            f"darts_search ranked {want}")
    for t in trials:
        require(t["log_names_device"], f"nas_experiment: {t['trial']}'s "
                f"log does not name {dev}")
        require(len(t["losses"]) == sizes["steps"]
                and all(map(math.isfinite, t["losses"])),
                f"nas_experiment: {t['trial']} losses {t['losses']}")
    if kernels:
        require(launches == expect and all(
            launches[k] > 0 for k in FLASH_PER_LAYER),
            f"nas_experiment: suggester launches {launches} != {expect}")
    _free_card(cuda)
    return out


def phase_nas_experiment(line: str, ranked_top: list) -> dict:
    """``nas_experiment`` on ``phase_darts_search``'s task: the bench
    model's width, ``DARTS`` sizes."""
    from kubeflow_tpu_torch.models import llama

    r = nas_experiment(llama.bench_model(), ranked_top)
    emit("nas_experiment", card=line, model="bench_model supernet",
         sizes=NAS_EXPERIMENT, **r)
    return r


# -- the distributed runtime and the parallel layouts --------------------------

#: mesh_train / moe_mesh_train: the bench models at full width and depth,
#: the slices' batch; two ranks share the card over gloo
MESH_TRAIN = dict(batch=14, seq=1024, steps=3, ranks=2, timeout=900,
                  dense_layouts=(({"fsdp": 2}, {}), ({"model": 2}, {})),
                  moe_layout=({"expert": 2}, {}))
#: a sharded run vs the same steps unsharded on the card: every step's loss
#: and step 1's global grad norm, relative. At init every loss sits near
#: ln(vocab), so only a tight loss limit and the norm, which a dropped
#: all-reduce or a mis-routed expert moves by O(1), catch a wrong layout
MESH_LOSS_TOL = 1e-4
MESH_NORM_TOL = 1e-3
#: where a layout's update is on trial (mesh_more_train's Adafactor,
#: LoRA and pipeline x fsdp layouts): one more step, its sharded update
#: against the unsharded optimizer's on the same gathered parameters,
#: gradients and state (``_update_after``), per trained parameter
#: ||p - p_unsharded_update|| over ||p_unsharded_update - p_before||, the
#: worst. An update moves an element by ~lr (AdamW) or ~lr rms(p)
#: (Adafactor), far below what the loss sees, and clipping and both
#: updates hide a gradient's scale; a wrong mean or block sum moves this
#: O(0.1-1), f32 rounding ~1e-4. (The parameters after the steps against
#: the unsharded run's are printed, not held: bf16 activations summed in
#: another order move them 0.2-16% on an H100, PR 19)
MESH_UPDATE_TOL = 1e-3
#: dist_pods: examples/02 as one worker of 2 cards (2 local ranks) and
#: examples/01 at 2 workers of one card
DIST_PODS = dict(mnist_steps=4, mnist_batch=16, replicas=2, cards=2,
                 timeout=300)


class _CollectiveBytes:
    """Counts the bytes each rank hands to collectives (an all-reduce's or
    an all-gather's input, a reduce-scatter's or an all-to-all's input):
    the payload this rank moves to the others. Nested calls (one
    collective implemented by another) count once."""

    def __init__(self):
        import torch.distributed as dist

        from kubeflow_tpu_torch.models import moe
        from kubeflow_tpu_torch.parallel import collectives

        self.moved: dict[str, int] = {}
        self._depth = 0
        for mod, name, key, arg, kwarg in (
                (dist, "all_gather_into_tensor", "all_gather", 1,
                 "input_tensor"),
                (dist, "all_gather_single", "all_gather", 1, "input_tensor"),
                (dist, "reduce_scatter_tensor", "reduce_scatter", 1, "input"),
                (dist, "reduce_scatter_single", "reduce_scatter", 1, "input"),
                (dist, "all_reduce", "all_reduce", 0, "tensor"),
                (dist, "all_to_all_single", "all_to_all", 1, "input"),
                (collectives, "_all_reduce", "all_reduce", 0, "x"),
                (moe, "_all_reduce", "all_reduce", 0, "x")):
            if hasattr(mod, name):
                setattr(mod, name, self._wrap(getattr(mod, name), key, arg,
                                              kwarg))

    def _wrap(self, fn, key, arg, kwarg):
        def counted(*a, **kw):
            if self._depth == 0:
                t = a[arg] if len(a) > arg else kw[kwarg]
                self.moved[key] = (self.moved.get(key, 0)
                                   + t.numel() * t.element_size())
            self._depth += 1
            try:
                return fn(*a, **kw)
            finally:
                self._depth -= 1
        return counted


def _heads_seen() -> set:
    """Patch the model's flash-attention entry to record the query heads
    each call gets; returns the set it fills."""
    from kubeflow_tpu_torch.models import llama

    seen: set = set()
    flash = llama.flash_attention

    def recording(q, *a, **kw):
        seen.add(int(q.shape[2]))
        return flash(q, *a, **kw)

    llama.flash_attention = recording
    return seen


def _mesh_config(model, axes: dict, sizes: dict, **train_kw):
    """The trainer config of ``model`` (a ``llama`` preset function's name,
    or a config) on ``axes``; ``train_kw``: more ``TrainConfig`` fields."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.trainer import TrainConfig

    if isinstance(model, str):
        model = getattr(llama, model)()
    return TrainConfig(model=model, mesh_axes=axes,
                       global_batch=sizes["batch"], seq_len=sizes["seq"],
                       steps=sizes["steps"], warmup_steps=2,
                       aux_loss_coef=0.01, **train_kw)


def _pin_step(model, routes: list, rows: slice) -> None:
    """Pin every MoE layer of ``model`` to this step's recorded expert ids
    (``routes[layer]``, global rows) for the rows this rank holds."""
    import torch

    from kubeflow_tpu_torch.models.moe import MoeMlp

    layers = [m for m in model.modules() if isinstance(m, MoeMlp)]
    for layer, ids in zip(layers, routes):
        _pin_routing(layer, torch.as_tensor(ids[rows]).long().to(
            layer.router.device))


def _mesh_rank(rank: int, model_name, axes: dict, sizes: dict,
               routes, device=None, train_kw=None, after=None) -> dict:
    """One rank of a sharded run on the card (``device=None``; ``"cpu"``
    rehearses it): ``sizes["steps"]`` steps of ``model_name`` (a preset's
    name or a config) on ``axes`` through the ``Trainer`` (``train_kw``:
    more ``TrainConfig`` fields; MoE layers pinned to ``routes[step]`` when
    given). Returns its losses, step times, peak memory, kernel launches,
    host copies, the query heads flash attention saw and the bytes it
    handed to collectives per step; ``after(trainer, sizes, device)``, run
    once the counts are read, adds its entries under ``"after"``."""
    import torch

    from kubeflow_tpu_torch.models import moe as moelib
    from kubeflow_tpu_torch.parallel import mesh as meshlib
    from kubeflow_tpu_torch.train.trainer import Trainer

    cuda = device is None
    if cuda:
        torch.cuda.set_device(0)
        # a run after another in the same process reads its own peaks
        torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    heads = _heads_seen()
    t = Trainer(_mesh_config(model_name, axes, sizes, **(train_kw or {})),
                device=device)
    # the peak of the model's layout and init, read before the optimizer's
    # state is allocated: the rank's shards plus one module's full draws,
    # never the unsharded model
    init_peak = []
    fresh = t._fresh_optimizer

    def read_peak():
        init_peak.append(torch.cuda.max_memory_allocated() if cuda else 0)
        fresh()

    t._fresh_optimizer = read_peak
    t.init_state(SEED)
    src = t.data_source()
    local = sizes["batch"] // t.batch_count
    rows = slice(t.batch_index * local, (t.batch_index + 1) * local)
    counted = _CollectiveBytes()
    for counts in (*_counters(), moelib.HOST_COPIES):
        for key in counts:
            counts[key] = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    for step in range(sizes["steps"]):
        if routes is not None:
            _pin_step(t.model, routes[step], rows)
        t0 = time.perf_counter()
        loss, norm = t.step(src.local_batch(step)["tokens"])
        losses.append(float(loss))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(norm))
    steps = sizes["steps"]
    out = {
        "rank": rank, "batch_shard": [t.batch_index, t.batch_count],
        "losses": losses, "grad_norms": norms, "step_ms": step_ms,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
        "init_peak_mem_bytes": init_peak[0],
        "full_param_bytes": sum(4 * math.prod(s)
                                for s in t.layout.full_shapes.values()),
        "launches": {k: v for counts in _counters()
                     for k, v in counts.items()},
        "host_copies_per_step": moelib.HOST_COPIES["moe_ep_counts"] / steps,
        "query_heads_seen": sorted(heads),
        "seq_rank": meshlib.axis_index(t.mesh, "seq"), "steps": steps,
        "stage_layers": t.layout.stage,
        "collective_bytes_per_step": {
            k: v / steps for k, v in counted.moved.items()}}
    out["after"] = None if after is None else after(t, sizes, device)
    return out


def _unsharded_losses(model_name: str, sizes: dict, record_routes: bool,
                      device=None, train_kw=None,
                      params_to=None) -> tuple[list, list, list]:
    """The same steps in this process, unsharded on the card: the losses,
    the global grad norms, and per step each MoE layer's expert ids (when
    ``record_routes``); ``train_kw``: more ``TrainConfig`` fields. With
    ``params_to`` (a path) it saves there the trained parameters after the
    steps, on the CPU, and how far the steps moved each (L2)."""
    import torch

    from kubeflow_tpu_torch.models.moe import MoeMlp
    from kubeflow_tpu_torch.train.trainer import Trainer

    t = Trainer(_mesh_config(model_name, {}, sizes, **(train_kw or {})),
                device=device)
    t.init_state(SEED)
    trained = {k: p for k, p in t.model.named_parameters()
               if p.requires_grad}
    init = ({k: p.detach().cpu().clone() for k, p in trained.items()}
            if params_to else None)
    routes: list = []
    if record_routes:
        layers = [m for m in t.model.modules() if isinstance(m, MoeMlp)]

        def record(i):
            def hook(m, inp, out):
                # the first forward of a step; remat's recompute repeats it
                # (no_grad: the recompute must save what the forward did)
                if routes[-1][i] is None:
                    with torch.no_grad():
                        ids = type(m).route(m, inp[0].detach())[2]
                    routes[-1][i] = ids.to(torch.uint8).cpu().numpy()
            return hook

        for i, layer in enumerate(layers):
            layer.register_forward_hook(record(i))
    src = t.data_source()
    losses, norms = [], []
    for step in range(sizes["steps"]):
        if record_routes:
            routes.append([None] * len(layers))
        loss, norm = t.step(src.local_batch(step)["tokens"])
        losses.append(float(loss))
        norms.append(float(norm))
    if params_to:
        final = {k: p.detach().cpu() for k, p in trained.items()}
        torch.save({"final": final,
                    "moved": {k: float((final[k] - init[k]).norm())
                              for k in final}}, params_to)
        del init, final
    del t, trained
    _free_card(device is None)
    return losses, norms, routes


def _mesh_errors(losses: list, norms: list, want: list,
                 want_norms: list) -> tuple[float, float]:
    """A sharded run's largest relative loss error over its steps, and its
    step-1 grad norm's relative error, against the unsharded run."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    return loss_rel, abs(norms[0] - want_norms[0]) / abs(want_norms[0])


def _checked_layout(layout, ranks: list, baseline, launches_of,
                    seconds: float) -> dict:
    """``mesh_cases``' checks of one layout's rank results; its entry."""
    want, want_norms, _ = baseline
    axes, train_kw = layout
    errs = [_mesh_errors(r["losses"], r["grad_norms"], want, want_norms)
            for r in ranks]
    loss_rel = max(e[0] for e in errs)
    norm_rel = max(e[1] for e in errs)
    require(loss_rel <= MESH_LOSS_TOL,
            f"{axes}: losses {[r['losses'] for r in ranks]} "
            f"vs unsharded {want}")
    require(norm_rel <= MESH_NORM_TOL,
            f"{axes}: step-1 grad norms "
            f"{[r['grad_norms'][0] for r in ranks]} vs unsharded "
            f"{want_norms[0]}")
    shards = any(a in axes for a in ("fsdp", "model", "expert",
                                     "pipeline"))
    for r in ranks:
        require(not shards
                or r["init_peak_mem_bytes"] < r["full_param_bytes"],
                f"{axes} rank {r['rank']}: the init's peak "
                f"{r['init_peak_mem_bytes']} B is not below the "
                f"unsharded parameters' {r['full_param_bytes']} B")
        want_launches = launches_of(layout, r)
        require(r["launches"] == want_launches,
                f"{axes} rank {r['rank']}: launches "
                f"{r['launches']} != {want_launches}")
        upd = (r["after"] or {}).get("update_rel")
        require(upd is None or upd["worst"] <= MESH_UPDATE_TOL,
                f"{axes} rank {r['rank']}: {upd and upd['name']}'s "
                f"sharded update is {upd and upd['worst']} (of its move) "
                f"from the unsharded optimizer's on the same gradients")
    return {"mesh": axes, "train": train_kw, "backend": "gloo",
            "seconds": seconds, "unsharded_losses": want,
            "unsharded_grad_norms": want_norms, "max_loss_rel": loss_rel,
            "step1_norm_rel": norm_rel, "ranks": ranks}


def _mesh_case_ranks(rank: int, runs: list, sizes: dict,
                     device=None) -> list:
    """One rank of several sharded runs in one spawn, in order: each
    ``(model, axes, routes, train_kw, after)`` a ``_mesh_rank``, its
    seconds beside it, the card's cache emptied between them."""
    out = []
    for model, axes, routes, train_kw, after in runs:
        t0 = time.perf_counter()
        r = _mesh_rank(rank, model, axes, sizes, routes, device, train_kw,
                       after)
        out.append({**r, "seconds": time.perf_counter() - t0})
        _free_card(device is None)
    return out


def mesh_cases(cases: list, sizes: dict, device=None) -> list[dict]:
    """Sharded runs on the card (``device=None``; ``"cpu"`` with a tiny
    model rehearses them), every case in one spawn of ``sizes["ranks"]``
    ranks sharing the card over gloo, each against its unsharded run.
    A case is ``(model, layout, baseline, launches_of, after)``: a layout
    is (axes, more ``TrainConfig`` fields), ``baseline``
    ``_unsharded_losses``' result for the same model, sizes and fields
    (its routes pin a MoE's), ``after`` ``_mesh_rank``'s. Every rank's
    losses must be within ``MESH_LOSS_TOL`` of the baseline's, its step-1
    grad norm within ``MESH_NORM_TOL``, its extra step's update within
    ``MESH_UPDATE_TOL`` where ``after`` took one, and its kernel launches
    equal to ``launches_of(layout, rank result)``; under a layout that
    shards the parameters each rank's init peak must stay below the
    unsharded parameters' bytes. Returns each case's
    ``_checked_layout`` entry, in order."""
    from kubeflow_tpu_torch.parallel import dryrun

    runs = [(model, layout[0], baseline[2] or None, layout[1], after)
            for model, layout, baseline, _, after in cases]
    ranks = dryrun.spawn(sizes["ranks"], _mesh_case_ranks, runs, sizes,
                         device, backend="gloo", timeout=sizes["timeout"])
    out = []
    for i, (_, layout, baseline, launches_of, _) in enumerate(cases):
        mine = [r[i] for r in ranks]
        out.append(_checked_layout(layout, mine, baseline, launches_of,
                                   mine[0]["seconds"]))
    return out


def per_layer_launches(per_layer: dict):
    """``mesh_cases``' ``launches_of`` for a path that launches each kernel
    ``per_layer`` times a block a step (every counter's key; 0 where it
    names none)."""
    def launches_of(layout, r: dict) -> dict:
        per = len(r["stage_layers"]) * r["steps"]
        return {k: per_layer.get(k, 0) * per
                for counts in _counters() for k in counts}
    return launches_of


def phase_mesh_train(line: str) -> dict:
    """The 271M bench model on ``{"fsdp": 2}`` and ``{"model": 2}``, two
    ranks sharing the card over gloo; under ``model: 2`` flash attention
    must see 4 of the 8 query heads."""
    baseline = _unsharded_losses("bench_model", MESH_TRAIN, False)
    launches = per_layer_launches(FLASH_PER_LAYER)
    out = {"layouts": mesh_cases(
        [("bench_model", layout, baseline, launches, None)
         for layout in MESH_TRAIN["dense_layouts"]], MESH_TRAIN)}
    emit("mesh_train", card=line, model="bench_model", sizes=MESH_TRAIN,
         loss_tol=MESH_LOSS_TOL, norm_tol=MESH_NORM_TOL, **out)
    for layout in out["layouts"]:
        want = [8 // layout["mesh"].get("model", 1)]
        for r in layout["ranks"]:
            require(r["query_heads_seen"] == want,
                    f"mesh_train {layout['mesh']}: flash attention saw "
                    f"{r['query_heads_seen']} query heads, not {want}")
    return out


def phase_moe_mesh_train(line: str) -> dict:
    """The 1.24B MoE bench model on ``{"expert": 2}``, two ranks sharing
    the card over gloo, routing pinned to the unsharded run's; one host
    copy of the count matrix per MoE layer and step."""
    baseline = _unsharded_losses("bench_moe_model", MESH_TRAIN, True)
    out = {"layouts": mesh_cases(
        [("bench_moe_model", MESH_TRAIN["moe_layout"], baseline,
          per_layer_launches(MOE_PER_LAYER), None)], MESH_TRAIN)}
    emit("moe_mesh_train", card=line, model="bench_moe_model",
         sizes=MESH_TRAIN, loss_tol=MESH_LOSS_TOL, norm_tol=MESH_NORM_TOL,
         **out)
    layers = bench_moe_layers()
    for r in out["layouts"][0]["ranks"]:
        require(r["host_copies_per_step"] == layers,
                f"moe_mesh_train: {r['host_copies_per_step']} host copies "
                f"a step, not {layers}")
    return out


def phase_nccl_one_rank(line: str) -> dict:
    """A one-rank NCCL group through ``bootstrap`` (an all-reduce and the
    barrier on the card), then 3 bench-model steps laid out by
    ``shard_model`` on a one-rank ``fsdp`` mesh (``mesh_axes={"fsdp": 1}``
    in a group of one: FSDP2 over one rank, K1-K3 under it) against the
    unwrapped model's."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.train.trainer import Trainer
    from kubeflow_tpu_torch.utils.net import free_port

    sizes = MESH_TRAIN
    ctx = bootstrap.PodContext(
        num_processes=1, coordinator_address=f"127.0.0.1:{free_port()}",
        dist_backend="nccl")
    bootstrap.initialize(ctx)
    try:
        require(dist.get_backend() == "nccl", "not an NCCL group")
        x = torch.full((1 << 20,), 3.0, device="cuda")
        dist.all_reduce(x)
        require(bool((x == 3.0).all()), "one-rank all_reduce changed x")
        barrier_t = bootstrap.barrier(ctx)
        want, want_norms, _ = _unsharded_losses("bench_model", sizes, False)
        t = Trainer(_mesh_config("bench_model", {"fsdp": 1}, sizes))
        require(t.mesh.mesh_dim_names == ("fsdp",), f"mesh {t.mesh}")
        t.init_state(SEED)
        for counts in _counters():
            for key in counts:
                counts[key] = 0
        src = t.data_source()
        losses, norms, step_ms = [], [], []
        for step in range(sizes["steps"]):
            t0 = time.perf_counter()
            loss, norm = t.step(src.local_batch(step)["tokens"])
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(norm))
        launches = {k: v for c in _counters() for k, v in c.items()}
        layers = llama.bench_model().num_layers
        expect = {k: FLASH_PER_LAYER.get(k, 0) * layers * sizes["steps"]
                  for k in launches}
        rel, norm_rel = _mesh_errors(losses, norms, want, want_norms)
        fsdp = type(t.model.layers[0]).__name__
        emit("nccl_one_rank", card=line, backend=dist.get_backend(),
             barrier_time=barrier_t, mesh={"fsdp": 1}, fsdp_module=fsdp,
             losses=losses, unsharded_losses=want, max_loss_rel=rel,
             grad_norms=norms, unsharded_grad_norms=want_norms,
             step1_norm_rel=norm_rel, step_ms=step_ms, launches=launches,
             loss_tol=MESH_LOSS_TOL, norm_tol=MESH_NORM_TOL)
        require(launches == expect, f"nccl_one_rank: launches {launches}")
        require(rel <= MESH_LOSS_TOL, f"nccl_one_rank: {losses} vs {want}")
        require(norm_rel <= MESH_NORM_TOL,
                f"nccl_one_rank: step-1 grad norm {norms[0]} vs "
                f"{want_norms[0]}")
        require(fsdp.startswith("FSDP"), f"blocks not FSDP2-wrapped: {fsdp}")
        del t
    finally:
        bootstrap.shutdown()
        _free_card(True)
    return {"losses": losses}


#: seq_train / pipeline_train: the bench model at full width and depth on
#: two ranks sharing the card over gloo, the mesh phases' sizes; the 1F1B
#: cases run 7 microbatches of 2 rows, GPipe the default (the degree, 2)
SEQ_LAYOUT = ({"seq": 2}, {})
PIPELINE_LAYOUTS = (
    ({"pipeline": 2}, {"pipeline_schedule": "gpipe"}),
    ({"pipeline": 2}, {"pipeline_schedule": "1f1b", "num_microbatches": 7}),
    ({"pipeline": 2}, {"pipeline_schedule": "1f1b", "num_microbatches": 7,
                       "pipeline_interleave": 2}),
)
#: ring_attention_check: the bench attention shape over a two-rank ring
RING = dict(BENCH, ranks=2, reps=5, timeout=600)


def seq_launches(layout, r: dict) -> dict:
    """A ``seq`` rank's K1-K3 launches: rank i of the ring sees i + 1 of
    the K/V blocks (the diagonal, causal, and i earlier ones, non-causal),
    each K1 twice a step under remat, K2 and K3 once."""
    per = len(r["stage_layers"]) * r["steps"]
    blocks = r["seq_rank"] + 1
    return {"flash_fwd": 2 * blocks * per,
            "flash_fwd_noncausal": 2 * r["seq_rank"] * per,
            "flash_bwd_dkv": blocks * per, "flash_bwd_dq": blocks * per,
            "gmm": 0, "tgmm": 0}


def pipeline_schedule_of(axes: dict, train_kw: dict) -> dict:
    """The schedule's ticks, microbatches and useful fraction (filled
    slots over all slots) of a ``pipeline`` layout, from the host's
    tables."""
    from kubeflow_tpu_torch.parallel import pipeline as pipelib

    p = axes["pipeline"]
    m = train_kw.get("num_microbatches") or p
    if train_kw["pipeline_schedule"] == "gpipe":
        ticks = m + p - 1
        return {"ticks": ticks, "microbatches": m, "chunks": 1,
                "useful_fraction": m / ticks}
    v = train_kw.get("pipeline_interleave", 1)
    sched = pipelib.schedule_1f1b(p, m, v)
    return {"ticks": sched.ticks, "microbatches": m, "chunks": v,
            "useful_fraction": sched.useful_fraction,
            "act_slots": sched.act_slots, "grad_slots": sched.grad_slots}


def pipeline_launches(layout, r: dict) -> dict:
    """A stage's K1-K3 launches: its blocks once a microbatch forward, and
    once more in the microbatch's backward (GPipe's reverse tick or a 1F1B
    backward slot, each from the stashed input, no checkpoint) with K2 and
    K3."""
    axes, train_kw = layout
    sched = pipeline_schedule_of(axes, train_kw)
    per = len(r["stage_layers"]) * sched["microbatches"] * r["steps"]
    return per_layer_launches(FLASH_PER_LAYER)(
        layout, {**r, "steps": sched["microbatches"] * r["steps"]})


def phase_seq_train(line: str, baseline) -> dict:
    """The bench model on ``{"seq": 2}`` with ``attention_impl="ring"``
    (flash blocks), two ranks sharing the card over gloo, against the
    unsharded steps; rank 1 must launch the non-causal K1 (its earlier
    block), rank 0 none (its later block is skipped): ``seq_launches``."""
    import dataclasses

    from kubeflow_tpu_torch.models import llama

    model = dataclasses.replace(llama.bench_model(), attention_impl="ring")
    out = {"layouts": mesh_cases(
        [(model, SEQ_LAYOUT, baseline, seq_launches, None)], MESH_TRAIN)}
    emit("seq_train", card=line, model="bench_model", attention="ring",
         sizes=MESH_TRAIN, loss_tol=MESH_LOSS_TOL, norm_tol=MESH_NORM_TOL,
         **out)
    return out


def phase_pipeline_train(line: str, baseline) -> dict:
    """The bench model on ``{"pipeline": 2}``: GPipe (2 microbatches),
    1F1B (7 of 2 rows) and interleaved 1F1B (2 chunks of 4 layers a rank),
    two ranks sharing the card over gloo, against the unsharded steps."""
    out = {"layouts": mesh_cases(
        [("bench_model", layout, baseline, pipeline_launches, None)
         for layout in PIPELINE_LAYOUTS], MESH_TRAIN)}
    for layout in out["layouts"]:
        layout["schedule"] = pipeline_schedule_of(layout["mesh"],
                                                  layout["train"])
    emit("pipeline_train", card=line, model="bench_model",
         sizes=MESH_TRAIN, loss_tol=MESH_LOSS_TOL, norm_tol=MESH_NORM_TOL,
         **out)
    return out


#: mesh_more_train: the layouts the port laid out last (LoRA and int8
#: under ``model``, the capacity dispatch under ``expert``, Adafactor over
#: shards, FSDP2 inside pipeline stages), each at the bench models' full
#: width and depth on MESH_TRAIN's batch against its own unsharded run, 2
#: steps of MESH_TRAIN's 3 (the script's clock: each layout's later step
#: costs 4-6 s on an H100 at 700 W, two ranks over gloo). The warmup gives
#: the first update a rate of 0, so both losses are read before any real
#: update: where the update is on trial (Adafactor, LoRA, pipeline x fsdp
#: under GPipe) one more step is held against the unsharded optimizer on
#: the same gradients (``MESH_UPDATE_TOL``); LoRA on every
#: projection kind (column- and row-parallel); the int8 check
#: teacher-forces 4 of the unsharded int8 engine's 32-token streams;
#: pipeline x fsdp is four ranks, 7 microbatches of one row a rank (14
#: rows over 2 batch shards)
MORE_TRAIN = dict(
    steps=2,
    lora=dict(lora_rank=8, lora_targets=("wq", "wv", "wo", "w_down")),
    int8=dict(prompts=4, prompt_len=128, new=32),
    lora_layout=({"model": 2}, {}),
    capacity_layout=({"expert": 2}, {}),
    adafactor_layouts=(({"fsdp": 2}, {"optimizer": "adafactor"}),
                       ({"model": 2}, {"optimizer": "adafactor"})),
    pipeline_fsdp_layouts=(
        ({"pipeline": 2, "fsdp": 2}, {"pipeline_schedule": "gpipe",
                                      "num_microbatches": 7}),
        ({"pipeline": 2, "fsdp": 2}, {"pipeline_schedule": "1f1b",
                                      "num_microbatches": 7})),
    pipeline_fsdp_ranks=4)


def _int8_model(model, device=None):
    """(int8 serving config, its state dict, the unsharded int8 model) of
    ``model`` (a preset's name or a config) from SEED's random weights, as
    ``quantize_for_serving`` makes them; the same on every process."""
    from kubeflow_tpu_torch.models import llama

    cfg, m = _gang_model(model, device)
    qcfg, sd = llama.quantize_for_serving(cfg, m.state_dict(), kv=False)
    del m
    q = llama.Llama(qcfg, device=device or "cuda")
    q.load_state_dict(sd)
    return qcfg, sd, q


def _rel_moves(got: dict, want: dict, moved: dict) -> dict:
    """The worst over parameters of ||got - want|| / moved (L2), its name,
    the median and how many."""
    rel = {}
    for k, w in want.items():
        err = float((got[k].float() - w).norm())
        rel[k] = (err / moved[k] if moved[k]
                  else (0.0 if err == 0 else math.inf))
    name = max(rel, key=rel.get)
    return {"worst": rel[name], "name": name,
            "median": sorted(rel.values())[len(rel) // 2],
            "params": len(rel)}


def _full_trained(t, of) -> dict:
    """``of(p)`` of every trained parameter, whole, copied to the CPU,
    every stage's (every rank joins). A copy: ``gather_full`` hands back
    the tensor itself where nothing splits it."""
    names = {id(p): k for k, p in t.model.named_parameters()}
    return t.layout.all_stages({
        names[id(p)]: t.layout.gather_full(names[id(p)], of(p)).to(
            "cpu", copy=True) for p in t.opt.params})


def _unsharded_optimizer(t, params: dict, state: dict):
    """The optimizer ``t`` would build unsharded, over ``params`` (whole
    tensors by name), loaded with ``state`` (``_opt_state_full``)."""
    from kubeflow_tpu_torch.train import optim

    cfg = t.cfg
    sched = dict(learning_rate=cfg.learning_rate,
                 warmup_steps=cfg.warmup_steps,
                 decay_steps=max(cfg.steps, cfg.warmup_steps + 1),
                 grad_clip_norm=cfg.grad_clip_norm)
    order = t._opt_order()
    if cfg.optimizer == "adafactor":
        groups = []
        for (layered, _), names in t._leaves(order).items():
            parts = [params[n] for n in names]
            shape = tuple(parts[0].shape)
            groups.append(((len(parts), *shape) if layered else shape,
                           parts, optim.LeafCut()))
        opt = optim.Adafactor(groups, **sched)
    else:
        opt = optim.AdamW([params[n] for n in order], b1=cfg.b1, b2=cfg.b2,
                          weight_decay=cfg.weight_decay,
                          mu_dtype=cfg.mu_dtype, **sched)
    opt.load_state_dict(state)
    return opt


def _update_after(t, sizes: dict, device, ref: str) -> dict:
    """``_mesh_rank``'s ``after`` of a layout whose update is on trial.
    ``"param_rel"``: the trained parameters after the steps against the
    unsharded run's (``ref``: ``_unsharded_losses``' ``params_to`` file),
    ||p - p_unsharded|| over how far the unsharded steps moved each, a
    reading. ``"update_rel"``: one more step (the next batch, at the
    schedule's full rate) taken as ``Trainer.step`` takes it, its sharded
    update against the unsharded optimizer's on the same gathered
    parameters, synced gradients and state. Every rank joins the gathers;
    rank 0 alone reads both, the unsharded optimizer on its device, and
    the others return nothing."""
    import torch
    import torch.distributed as dist

    lead = dist.get_rank() == 0
    before = _full_trained(t, lambda p: p.detach())
    state = t._opt_state_full()
    if lead:
        # copies: a moment nothing splits is handed back as the tensor
        # itself, which the step below moves
        state = {k: [None if x is None else x.to("cpu", copy=True)
                     for x in v] if isinstance(v, list) else v
                 for k, v in state.items()}
    tokens = t.data_source().local_batch(sizes["steps"])["tokens"]
    t.loss_and_grads(tokens)
    t.layout.sync_grads(t.opt.params)
    grads = _full_trained(t, lambda p: p.grad)
    t.opt.step()
    t.model.zero_grad(set_to_none=True)
    after = _full_trained(t, lambda p: p.detach())
    if not lead:
        return {}
    saved = torch.load(ref)
    out = {"param_rel": _rel_moves(before, saved["final"],
                                   saved["moved"])}
    del saved
    params = {k: v.to(t.device, copy=True).requires_grad_()
              for k, v in before.items()}
    for k, p in params.items():
        p.grad = grads[k].to(t.device)
    del grads
    _unsharded_optimizer(t, params, state).step()
    want = {k: p.detach().cpu() for k, p in params.items()}
    del params, state
    out["update_rel"] = _rel_moves(after, want, {
        k: float((want[k] - before[k]).norm()) for k in want})
    return out


def _lora_after(t, sizes: dict, device, model=None, int8=None,
                ref=None) -> dict:
    """``_mesh_rank``'s ``after`` of the LoRA layout: one more step, its
    update held (``_update_after``, ``ref``), the adapters-only checkpoint
    of that step (rank 0 writes every rank's shards gathered whole) and
    the loss of the next batch; then, on the same ``model`` group, the int8 ``model`` laid out by
    ``place_params`` and teacher-forced on the unsharded int8 engine's
    streams (``int8``: prompts, streams) beside the unsharded int8 model
    (``_teacher_forced_check``)."""
    import torch

    from kubeflow_tpu_torch.serving import sharded

    update = _update_after(t, sizes, device, ref)
    steps = sizes["steps"] + 1
    t._save(steps, force=True)
    t.ckpt.wait_until_finished()
    with torch.no_grad():
        tokens = torch.as_tensor(t.data_source().local_batch(steps)["tokens"],
                                 device=t.device)
        next_loss = float(t.global_mean(t._loss(tokens)))
    qcfg, sd, unsharded = _int8_model(model, device)
    mesh = sharded.build_serving_mesh({"model": 2})
    tp = sharded.place_params(qcfg, sd, mesh, unsharded.embedder.embedding
                              .device)
    del sd
    check = _teacher_forced_check(
        _teacher_forced_reference(unsharded, *int8), tp)
    del tp, unsharded
    _free_card(device is None)
    return {**update, "next_loss": next_loss, "int8_teacher_forced": check,
            "int8_query_heads": qcfg.num_heads // 2}


def _adafactor_after(t, sizes: dict, device, ref: str) -> dict:
    """``_mesh_rank``'s ``after`` of an Adafactor layout: its update held
    (``_update_after``) and how many of the rank's tensors hold factored
    moments (``v_row``)."""
    return {**_update_after(t, sizes, device, ref),
            "factored": sum(v is not None for v in t.opt.v_row),
            "tensors": len(t.opt.v_row)}


def mesh_more_train(device=None, sizes=MESH_TRAIN, more=MORE_TRAIN,
                    dense="bench_model", moe="bench_moe_model",
                    per_layer=FLASH_PER_LAYER) -> dict:
    """Every ``MORE_TRAIN`` layout against its unsharded run on the card
    (``device=None``; ``"cpu"`` with tiny configs rehearses it): LoRA
    under ``model`` from a base snapshot written here, one more step's
    update held to the unsharded optimizer's on the same gradients
    (``_update_after``) and the adapters-only checkpoint of that step
    reloaded on one rank to the same next loss, and in the same spawn the
    int8 model under ``model`` teacher-forced within ``TEACHER_TOL``; the
    capacity dispatch under ``expert`` (routing pinned to the unsharded
    run's); Adafactor under ``fsdp`` and ``model``, its projections
    factored and its update held likewise; FSDP2 inside two pipeline
    stages under GPipe and 1F1B, GPipe's update held likewise. The
    two-rank layouts share one spawn and the four-rank ones another
    (``mesh_cases``). ``per_layer``: each kernel's launches a block a step
    (``per_layer_launches``; none on the CPU)."""
    import dataclasses
    import functools

    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.trainer import Trainer

    out, seconds = {}, {}
    flash = per_layer_launches(per_layer)

    def pipe_launches(layout, r: dict) -> dict:
        # ``pipeline_launches`` with ``per_layer``
        m = pipeline_schedule_of(*layout)["microbatches"]
        return flash(layout, {**r, "steps": m * r["steps"]})

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="kft-mesh-more-")
    try:
        base = os.path.join(work, "base")
        cfg, m = _gang_model(dense, device)
        llama.save_pretrained(base, cfg, m)
        del m
        qcfg, _, q = _int8_model(dense, device)
        i8 = more["int8"]
        prompts = _prompts(qcfg, i8["prompts"], i8["prompt_len"])
        streams = _truth(qcfg, q, prompts, i8["new"],
                         [(i8["prompts"], i8["prompt_len"])],
                         GANG_ENGINE)["tokens"]
        del q
        _free_card(device is None)
        lcfg = dataclasses.replace(_config(dense), **more["lora"])
        ccfg = dataclasses.replace(_config(moe), moe_dispatch="dense")
        ckpt = os.path.join(work, "ckpt")
        axes, kw = more["lora_layout"]
        lora_layout = (axes, {**kw, "init_from": base,
                              "checkpoint_dir": ckpt})
        refs = {k: os.path.join(work, f"{k}.pt")
                for k in ("lora", "adafactor", "adamw")}
        lora_base = _unsharded_losses(lcfg, sizes, False, device,
                                      {"init_from": base}, refs["lora"])
        ada_base = _unsharded_losses(dense, sizes, False, device,
                                     {"optimizer": "adafactor"},
                                     refs["adafactor"])
        cases = [
            (lcfg, lora_layout, lora_base, flash,
             functools.partial(_lora_after, model=dense,
                               int8=(prompts, streams), ref=refs["lora"])),
            (ccfg, more["capacity_layout"], _unsharded_losses(
                ccfg, sizes, True, device), flash, None),
            *((dense, layout, ada_base, flash,
               functools.partial(_adafactor_after, ref=refs["adafactor"]))
              for layout in more["adafactor_layouts"])]
        seconds["baselines"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        two = mesh_cases(cases, sizes, device)
        seconds["two_rank_spawn"] = time.perf_counter() - t1
        out["lora"], out["capacity"] = two[0], two[1]
        out["adafactor"] = two[2:]
        # the adapters-only checkpoint of the extra step, whole, on one
        # rank
        saved_step = sizes["steps"] + 1
        one = Trainer(_mesh_config(lcfg, {}, sizes, init_from=base,
                                   checkpoint_dir=ckpt), device=device)
        one.restore_or_init(SEED)
        with torch.no_grad():
            tokens = torch.as_tensor(one.data_source().local_batch(
                saved_step)["tokens"], device=one.device)
            reloaded = float(one._loss(tokens))
        out["lora"]["reloaded_next_loss"] = reloaded
        out["lora"]["reloaded_step"] = one.opt.count
        del one
        _free_card(device is None)
        heads = _config(dense).num_heads // 2
        for r in out["lora"]["ranks"]:
            after = r["after"]
            require(r["query_heads_seen"] == [heads],
                    f"mesh_more_train lora: flash attention saw "
                    f"{r['query_heads_seen']} query heads, not [{heads}]")
            rel = abs(reloaded - after["next_loss"]) \
                / abs(after["next_loss"])
            require(out["lora"]["reloaded_step"] == saved_step
                    and rel <= MESH_LOSS_TOL,
                    f"mesh_more_train lora: the adapters-only checkpoint "
                    f"reloaded on one rank at step "
                    f"{out['lora']['reloaded_step']} gives loss "
                    f"{reloaded} against the TP run's {after['next_loss']}")
            tf = after["int8_teacher_forced"]
            require(tf["rel_l2_max"] <= TEACHER_TOL,
                    f"mesh_more_train int8: the TP logits are "
                    f"{tf['rel_l2_max']} (relative L2) from the unsharded "
                    f"int8 model's, over {TEACHER_TOL}")
        for r in out["capacity"]["ranks"]:
            require(r["host_copies_per_step"] == 0,
                    f"mesh_more_train capacity: "
                    f"{r['host_copies_per_step']} host copies a step: the "
                    "slots are equal-sized")
        for layout in out["adafactor"]:
            for r in layout["ranks"]:
                require(r["after"]["factored"] > 0,
                        f"mesh_more_train adafactor {layout['mesh']}: no "
                        "factored moment")

        t1 = time.perf_counter()
        pipe_base = _unsharded_losses(dense, sizes, False, device,
                                      params_to=refs["adamw"])
        seconds["baselines"] += time.perf_counter() - t1
        t1 = time.perf_counter()
        # the update check reads the gradients after their hand-off, the
        # same under either schedule: GPipe's layout takes it
        after = functools.partial(_update_after, ref=refs["adamw"])
        out["pipeline_fsdp"] = mesh_cases(
            [(dense, layout, pipe_base, pipe_launches, after if i == 0
              else None)
             for i, layout in enumerate(more["pipeline_fsdp_layouts"])],
            {**sizes, "ranks": more["pipeline_fsdp_ranks"]}, device)
        seconds["four_rank_spawn"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for layout in out["pipeline_fsdp"]:
        layout["schedule"] = pipeline_schedule_of(layout["mesh"],
                                                  layout["train"])
    out["seconds"] = seconds
    return out


def step_peaks(layouts: list) -> list[dict]:
    """Each layout's largest step peak over its ranks (bytes): what one
    rank of it holds on the card at the most during a step."""
    return [{"mesh": x["mesh"], "train": x["train"],
             "peak_mem_bytes": max(r["peak_mem_bytes"] for r in x["ranks"])}
            for x in layouts]


def phase_mesh_more_train(line: str, pipe: dict) -> dict:
    """``mesh_more_train`` on the bench models at ``MORE_TRAIN``'s steps;
    beside pipeline x fsdp's step peaks it prints those of ``pipe``
    (pipeline_train's result, read on the same card)."""
    sizes = {**MESH_TRAIN, "steps": MORE_TRAIN["steps"]}
    out = mesh_more_train(sizes=sizes)
    emit("mesh_more_train", card=line, models=["bench_model",
                                               "bench_moe_model"],
         sizes=sizes, more=MORE_TRAIN, loss_tol=MESH_LOSS_TOL,
         norm_tol=MESH_NORM_TOL, update_tol=MESH_UPDATE_TOL,
         teacher_tol=TEACHER_TOL, **out)
    emit("mesh_more_train_peaks", card=line,
         pipeline_fsdp=step_peaks(out["pipeline_fsdp"]),
         pipeline=step_peaks(pipe["layouts"]))
    return out


def _ring_check_rank(rank: int, sizes: dict, device=None) -> dict:
    """One rank of ``ring_attention_check``: ring attention (flash blocks)
    and Ulysses on this rank's half of the same full-sequence inputs, each
    forward and backward timed, their outputs and q/k/v gradients gathered
    to every rank; rank 0 holds them against ``flash_attention`` and
    against the plain attention (K1's and K2/K3's plain versions) on the
    whole sequence (``device="cpu"`` rehearses it)."""
    import torch

    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel import mesh as meshlib
    from kubeflow_tpu_torch.parallel.collectives import all_gather_rows
    from kubeflow_tpu_torch.parallel.ring_attention import (
        ring_attention,
        ulysses_attention,
    )

    cuda = device is None
    dev = "cuda" if cuda else "cpu"
    if cuda:
        torch.cuda.set_device(0)
    mesh = meshlib.build_mesh({"seq": sizes["ranks"]}, device_type=dev)
    group = mesh.get_group("seq")
    b, s, h, kv, d = (sizes[k] for k in ("b", "s", "h", "kv", "d"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    dt = torch.bfloat16 if cuda else torch.float32
    q, k, v, do = (torch.randn(*shape, generator=gen, device=dev).to(dt)
                   for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d),
                                 (b, s, h, d)))
    cut = meshlib.seq_slice(mesh, s)
    refs = {}
    if rank == 0:
        qf, kf, vf = (t.detach().requires_grad_() for t in (q, k, v))
        o = fa.flash_attention(qf, kf, vf, q_per_kv=h // kv)
        refs["flash_attention"] = [
            t.detach().float()
            for t in (o, *torch.autograd.grad(o, (qf, kf, vf), do))]
        o_p, lse_p = fa.flash_fwd_plain(q, k, v)
        delta = (do.float() * o_p).sum(-1).transpose(1, 2)
        refs["plain"] = [o_p, fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta),
                         *fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta)]
        del o, qf, kf, vf, delta

    def gather(t):  # [b, s/r, ...] -> [b, s, ...]
        return all_gather_rows(t.transpose(0, 1).contiguous(),
                               group).transpose(0, 1)

    out = {"rank": rank, "shape": [b, s // sizes["ranks"], h, d]}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        ql, kl, vl = (t[:, cut].detach().requires_grad_() for t in (q, k, v))

        def call():
            o = fn(ql, kl, vl, q_per_kv=h // kv, mesh=mesh, block_impl="flash")
            return (o, *torch.autograd.grad(o, (ql, kl, vl), do[:, cut]))

        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        results = call()
        launches = dict(fa.LAUNCHES)
        gathered = [gather(t.detach()) for t in results]
        times = []
        for _ in range(sizes["reps"]):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            if cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"launches": launches, "fwd_bwd_ms": times}
        if rank == 0:
            out[name]["rel_err"] = {
                against: {what: rel_err(got, want) for what, got, want in
                          zip(("o", "dq", "dk", "dv"), gathered, ref)}
                for against, ref in refs.items()}
            out[name]["finite"] = all(bool(t.isfinite().all())
                                      for t in gathered)
    return out


def ring_check_launches(name: str, rank: int) -> dict:
    """K1-K3 launches of one forward and backward on ring rank ``rank``:
    the ring's rank i runs its diagonal block (causal) and i earlier ones
    (non-causal), each K1 once, K2 and K3 once; Ulysses one causal
    attention over the gathered heads."""
    blocks = rank + 1 if name == "ring" else 1
    return {"flash_fwd": blocks, "flash_bwd_dkv": blocks,
            "flash_bwd_dq": blocks, "flash_fwd_noncausal": blocks - 1}


def ring_attention_check(device=None, sizes=RING) -> dict:
    """``ring_attention`` and ``ulysses_attention`` over a two-rank ``seq``
    ring sharing the card over gloo at the bench attention shape, against
    ``flash_attention`` and the plain attention on the whole sequence
    (``REL_TOL``): output and the gradients of q, k and v."""
    from kubeflow_tpu_torch.parallel import dryrun

    ranks = dryrun.spawn(sizes["ranks"], _ring_check_rank, sizes, device,
                         backend="gloo", timeout=sizes["timeout"])
    for name in ("ring", "ulysses"):
        errs = ranks[0][name]["rel_err"]
        worst = max(e for by in errs.values() for e in by.values())
        require(worst <= REL_TOL and ranks[0][name]["finite"],
                f"ring_attention_check: {name} vs the whole sequence: {errs}")
        for r in ranks:
            # the CPU rehearsal runs the plain versions: nothing launches
            want = (ring_check_launches(name, r["rank"]) if device is None
                    else dict.fromkeys(r[name]["launches"], 0))
            require(r[name]["launches"] == want,
                    f"ring_attention_check {name} rank {r['rank']}: "
                    f"launches {r[name]['launches']} != {want}")
    return {"ranks": ranks}


def phase_ring_attention_check(line: str) -> dict:
    r = ring_attention_check()
    emit("ring_attention_check", card=line, sizes=RING, rel_tol=REL_TOL,
         **r)
    return r


def dist_pods(device=None, sizes=DIST_PODS) -> dict:
    """``examples/02``'s ResNet job as one worker of two cards (its pod
    runs two local ranks) and ``examples/01`` with two workers of one card
    as JaxJobs of real pod processes on a GPU host built from the
    machine's cards (each card's id four times, so the ResNet pod's two
    ids name card 0 on a one-card machine) on the card (``device=None``;
    ``"cpu"`` rehearses it), the process groups on gloo
    (``KFT_DIST_BACKEND``: the ranks share one card). Both must succeed,
    every rank printing the same ``loss=`` lines and every pod's log
    naming its cards."""
    ex = _example_jobs(sizes, {})
    jobs = {"mnist-smoke": (*ex["mnist-smoke"], sizes["replicas"], 1),
            "resnet": (*ex["resnet"], 1, sizes["cards"])}
    overrides = {"KFT_DIST_BACKEND": "gloo"}
    if device is not None:
        overrides["KFT_POD_DEVICE"] = device
    ids = machine_card_ids(sizes["replicas"] + sizes["cards"])
    ran = run_jaxjobs(jobs, overrides, sizes["timeout"], ids)
    out: dict = {"host_card_ids": ids}
    for name, (job, seconds, pods) in ran.items():
        k = jobs[name][4]
        lines = [s for _, log, _ in pods for s in _rank_streams(
            [x for x in log.splitlines() if x.startswith("loss=")], k)]
        out[name] = {
            "succeeded_s": seconds,
            "gang_startup_s": job.status.gang_startup_seconds,
            "ranks": len(lines),
            "card_ids": [p.spec.device_ids for p, _, _ in pods],
            "loss_lines": lines[0],
            "metrics": [_metric_lists(rows) for _, _, rows in pods]}
        require(len(lines) == jobs[name][3] * k and lines[0]
                and all(x == lines[0] for x in lines),
                f"dist_pods: {name} ranks printed {lines}")
        require(all(_own_cards_named(p, log) for p, log, _ in pods),
                f"dist_pods: {name} logs name no card")
        require(job.status.gang_startup_seconds is not None,
                f"dist_pods: {name} passed no barrier")
    return out


def phase_dist_pods(line: str) -> dict:
    r = dist_pods()
    emit("dist_pods", card=line, sizes=DIST_PODS, **r)
    return r


# -- multi-GPU serving: the tensor-parallel engine and the serving gang -------

#: the expert products of the MoE bench model under ``{"model": 2}``: each
#: rank holds intermediate 2816 / 2 of every expert
TP_GMM = ((1024, 1408), (1408, 1024))
#: a TP prefill's expert rows: 4 prompts x 128 tokens x top-2
TP_PREFILL_SIZES = _split(4 * 128 * 2, 8)
#: the gang phases: two ranks share the card over gloo at {"model": 2}
GANG_ENGINE = dict(SERVE_ENGINE, block_size=16)
#: ``moe_ep_serve``'s gang: four ranks share the card over gloo, each with
#: 4 of the MoE bench model's 8 experts and half of each one's mlp dim
EP_MESH = {"expert": 2, "model": 2}
GANG = dict(
    timeout=900,
    tp_serve=dict(prompts=8, prompt_len=128, new=64, rounds=1),
    moe_tp_serve=dict(prompts=4, prompt_len=128, new=32, rounds=1),
    # the same MoE sizes on four ranks: moe_tp_serve's unsharded streams
    # are its baseline too
    moe_ep_serve=dict(prompts=4, prompt_len=128, new=32, rounds=1),
    wire=dict(prompts=2, prompt_len=128, new=64, at=8),
    resize=dict(prompt_len=128, new=96, shrink_at=16, grow_at=40),
)
WIRE_ENGINE = dict(num_slots=4, decode_chunk=4, block_size=16,
                   prefix_cache=False)
RESIZE_ENGINE = WIRE_ENGINE
NCCL_CAPTURE = dict(prompts=4, prompt_len=128, new=32)
#: the teacher-forced check of a TP gang's decode path: at every position
#: of the unsharded stream, the relative L2 distance of the TP logits from
#: the unsharded model's. Both run in bf16, whose rounding moves the
#: logits by well under 1e-2 of their norm; a dropped all-reduce or a
#: wrong head slice moves them by tens of percent
TEACHER_TOL = 5e-2


def _resize_model(model):
    """``tp_resize``'s model: ``model`` (a preset's name or a config) at
    its width and depth in f32, with dense attention (the flash kernels
    take bf16). A bit-identical stream across degrees is a claim about
    f32 arithmetic: in bf16 a degree's other summation order flips
    near-tie argmaxes."""
    import dataclasses

    import torch

    return dataclasses.replace(_config(model), dtype=torch.float32,
                               attention_impl="dense")


def phase_tp_gmm_time() -> dict:
    """K4a at the shapes the MoE bench model's experts take under
    ``{"model": 2}``: the gate/up product K 1024 -> N 1408 and the down
    product K 1408 -> N 1024, at a decode step's 16 rows and a prefill's
    1024, each checked as ``check_grouped_case`` checks the kernels (from
    NaN-poisoned memory, against the plain version under REL_TOL, a repeat
    bitwise equal) and read by ``_serve_gmm_reading`` (graph-replayed
    time, plain, ``torch._grouped_mm``, bound)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = {}
    for k, n in TP_GMM:
        for name, sizes in (("decode", SERVE_DECODE_SIZES),
                            ("prefill", TP_PREFILL_SIZES)):
            check = check_grouped_case(sum(sizes), k, n, sizes, False, gen)
            rows[f"k{k}_n{n}_{name}"] = {
                **_serve_gmm_reading(sizes, gen, k, n), "check": check}
            require(check["gmm_rel"] <= REL_TOL
                    and check["tgmm_rel"] <= REL_TOL
                    and check["repeat_bitwise_equal"]
                    and check["tail_rows_zero"]
                    and check["empty_blocks_zero"],
                    f"gmm at K {k} N {n} {name}: {check}")
    emit("tp_gmm_time", rows=rows)
    return rows


#: an expert-parallel serving rank's window: 4 of the 8 experts' rows of
#: the expert-sorted token copies, rows of the other experts before and
#: after it (``moe.MoeMlp._ragged`` under ``{"expert": 2, ...}``): rank 0's
#: experts 0-3, rank 1's 4-7, and experts 2-5, a window with rows on both
#: sides
EP_WINDOWS = {"rank0": (0, 4), "rank1": (4, 8), "interior": (2, 6)}


def _window(sizes, first: int, last: int) -> tuple:
    """(lead rows, the window's group sizes, tail rows)."""
    return (sum(sizes[:first]), list(sizes[first:last]),
            sum(sizes[last:]))


def phase_ep_gmm_time() -> dict:
    """K4a at the shapes ``moe_ep_serve`` gives it: the MoE bench model's
    expert products under ``{"expert": 2, "model": 2}`` (``TP_GMM``: each
    rank holds 4 of the 8 experts and half of each one's mlp dim), over
    one rank's window of a decode step's 16 rows (8 slots x top-2,
    ``SERVE_DECODE_SIZES``) and of a 4 x 128 prefill's 1,024
    (``TP_PREFILL_SIZES``). Every window of ``EP_WINDOWS`` is checked as
    ``check_grouped_case`` checks the kernels (rows of no group on both
    sides of it NaN in x and 0 in the output); rank 1's, whose groups
    start past row 0, is read by ``_serve_gmm_reading`` (graph-replayed
    time, plain, ``torch._grouped_mm`` on the window's rows, bound)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows, checks = {}, {}
    for k, n in TP_GMM:
        for name, sizes in (("decode", SERVE_DECODE_SIZES),
                            ("prefill", TP_PREFILL_SIZES)):
            for win, (first, last) in EP_WINDOWS.items():
                lead, part, tail = _window(sizes, first, last)
                check = check_grouped_case(lead + sum(part) + tail, k, n,
                                           part, False, gen, lead=lead)
                checks[f"k{k}_n{n}_{name}_{win}"] = check
                require(check["gmm_rel"] <= REL_TOL
                        and check["tgmm_rel"] <= REL_TOL
                        and check["repeat_bitwise_equal"]
                        and check["tail_rows_zero"]
                        and check["empty_blocks_zero"],
                        f"gmm at K {k} N {n} {name} window {win}: {check}")
            lead, part, tail = _window(sizes, *EP_WINDOWS["rank1"])
            rows[f"k{k}_n{n}_{name}"] = _serve_gmm_reading(
                part, gen, k, n, lead=lead, tail=tail)
    emit("ep_gmm_time", rows=rows, checks=checks)
    return rows


def _config(model):
    """The config of ``model``, a preset's name or a config."""
    from kubeflow_tpu_torch.models import llama

    return getattr(llama, model)() if isinstance(model, str) else model


def _gang_model(model, device=None):
    """(cfg, the model with random weights from SEED on ``device``, the
    card by default): ``model`` is a preset's name or a config."""
    from kubeflow_tpu_torch.models import llama

    cfg = _config(model)
    m = llama.Llama(cfg, device=device or "cuda")
    m.init_weights(SEED)
    return cfg, m


class _GangRecorder:
    """Each program a gang rank runs, in order: its key, a copy of its
    output tensor and the kernel launches it made. Rank 0's engine runs
    through ``GangEngine._dispatch.run``, a follower's through
    ``ContinuousEngine.replay``; both ranks run the same sequence, so entry
    ``i`` of one is entry ``i`` of the other."""

    def __init__(self):
        self.rows: list = []
        self.engines: list = []

    def wrap(self, fn):
        import torch

        def run(key, *args):
            before = [dict(c) for c in _counters()]
            out = fn(key, *args)
            delta = {k: c[k] - b.get(k, 0)
                     for c, b in zip(_counters(), before) for k in c}
            self.rows.append((tuple(key), out.clone()
                              if isinstance(out, torch.Tensor) else None,
                              delta))
            return out
        return run

    def install(self, rank: int, ledger=None):
        """Patch the class ``serve_main`` builds on this rank; returns the
        undo."""
        from kubeflow_tpu_torch.serving import continuous, gang

        rec = self
        if rank == 0:
            base = gang.GangEngine

            class Recording(base):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    if ledger is not None:
                        self.attach_block_ledger(ledger)
                    self._dispatch.run = rec.wrap(self._dispatch.run)
                    rec.engines.append(self)

            gang.GangEngine = Recording
            return lambda: setattr(gang, "GangEngine", base)
        base = continuous.ContinuousEngine

        class Following(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.replay = rec.wrap(self.replay)
                rec.engines.append(self)

        continuous.ContinuousEngine = Following
        return lambda: setattr(continuous, "ContinuousEngine", base)

    def digests(self) -> list:
        import hashlib

        return [(list(k), None if t is None else hashlib.sha256(
            t.cpu().numpy().tobytes()).hexdigest())
            for k, t, _ in self.rows]


def _http_json(url: str, payload: Optional[dict] = None,
               timeout: float = 600) -> dict:
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode() or "{}")


def _drive_gang(rec, url: str, prompts, sizes: dict, out: dict) -> None:
    """Rank 0's client: wait for the gang's frontend, one priming request
    of one prompt (a process's first requests pay a one-time cost), then
    ``rounds`` timed rounds of ``prompts`` through ``/v1/models/m:predict``
    (one request, every prompt an instance, so they share the pool);
    kernel launch counts set to 0 just before the first timed round and
    read just after it. Then SIGTERM to this process, which ends
    ``serve_main``."""
    import os
    import signal
    import traceback
    import urllib.error

    try:
        deadline = time.monotonic() + 900
        while True:
            try:
                _http_json(url + "/v2/health/ready", timeout=5)
                break
            except (OSError, urllib.error.URLError, ValueError):
                require(time.monotonic() < deadline,
                        "the gang's frontend never answered")
                time.sleep(0.2)
        eng = rec.engines[-1]
        predict = url + "/v1/models/m:predict"
        _http_json(predict, {"instances": prompts[:1]})
        seconds, steps, streams = [], [], []
        for r in range(sizes["rounds"]):
            if r == 0:
                for c in _counters():
                    for key in c:
                        c[key] = 0
                lo = len(rec.rows)
            s0 = eng.stats()["decode_steps"]
            t0 = time.perf_counter()
            streams.append(_http_json(predict,
                                      {"instances": prompts})["predictions"])
            seconds.append(time.perf_counter() - t0)
            steps.append(eng.stats()["decode_steps"] - s0)
            if r == 0:
                hi = len(rec.rows)
                out["launches"] = {k: v for c in _counters()
                                   for k, v in c.items()}
        tps = [len(prompts) * sizes["new"] / s for s in seconds]
        out.update(
            tokens=streams[0], seconds=seconds, decode_steps=steps,
            window=[lo, hi], tokens_per_sec=statistics.median(tps),
            tokens_per_sec_rounds=tps,
            ms_per_dispatch=statistics.median(
                s / max(n, 1) * 1e3 for s, n in zip(seconds, steps)),
            stats=eng.stats(), graphs=eng.graphs, backend=eng.backend)
    except Exception:  # noqa: BLE001 — handed to the phase, which fails
        out["error"] = traceback.format_exc()
    finally:
        os.kill(os.getpid(), signal.SIGTERM)


def _moe_layers(model) -> list:
    from kubeflow_tpu_torch.models.moe import MoeMlp

    return [m for m in model.modules() if isinstance(m, MoeMlp)]


def _teacher_forced(model, prompts, streams, pins=None) -> tuple:
    """(logits [rows, len(stream), vocab] f32, expert ids of each forward)
    of ``model``'s decode path fed ``prompts`` and ``streams`` (a batch of
    rows, every prompt of one length, every stream of one length): the
    prompts in one forward through a KV cache of this rank's heads (the
    prefill), then every column of the streams but the last, one a forward
    (the decode steps); ``[r, i]`` scores ``streams[r][i]``. With ``pins``
    (the ids another model's forwards chose) every MoE layer routes to
    them (``_pin_routing``). Every rank of a TP model calls this
    together."""
    import types

    import torch

    from kubeflow_tpu_torch.models.llama import KvCache

    cfg = model.cfg
    dev = model.embedder.embedding.device
    layers = _moe_layers(model)
    ids: list = []
    for layer in layers if pins is None else []:
        route = type(layer).route

        def recorded(self, x, _route=route):
            probs, gates, idx = _route(self, x)
            ids[-1].append(idx)
            return probs, gates, idx

        layer.route = types.MethodType(recorded, layer)
    plen, new = len(prompts[0]), len(streams[0])
    cache = KvCache.zeros(cfg, len(prompts), plen + new, device=dev,
                          kv_heads=model.kv_heads)
    cols = torch.tensor(streams, device=dev)
    steps = [torch.tensor(prompts, device=dev)] + [
        cols[:, i:i + 1] for i in range(new - 1)]
    rows, at = [], 0
    try:
        with torch.no_grad():
            for j, toks in enumerate(steps):
                ids.append([])
                for layer, idx in zip(layers, [] if pins is None
                                      else pins[j]):
                    _pin_routing(layer, idx)
                s = toks.shape[1]
                pos = torch.arange(at, at + s, device=dev)[None]
                rows.append(model(toks, pos, cache=cache)[:, -1].float())
                at += s
    finally:
        for layer in layers:
            layer.__dict__.pop("route", None)
    return torch.stack(rows, dim=1), ids


def _teacher_forced_reference(unsharded, prompts, streams) -> list:
    """The unsharded side of ``_teacher_forced_check``: ``streams`` fed
    through ``unsharded``'s decode path (``_teacher_forced``, the streams
    of one length batched): per group, (prompts, streams, logits, the
    expert ids of each forward)."""
    groups: dict = {}
    for p, st in zip(prompts, streams):
        groups.setdefault((len(p), len(st)), []).append((p, st))
    out = []
    for rows in groups.values():
        ps, sts = [r[0] for r in rows], [r[1] for r in rows]
        want, ids = _teacher_forced(unsharded, ps, sts)
        out.append((ps, sts, want, ids))
    return out


def _teacher_forced_check(reference: list, tp_model) -> dict:
    """The unsharded streams fed through the TP model's decode path (its
    MoE layers routed as the unsharded one chose) against the unsharded
    model's logits (``_teacher_forced_reference``): the largest relative
    L2 distance of the TP logits from the unsharded ones over every
    position, and at how many positions the greedy token agrees. Every
    rank calls it with the same inputs."""
    moe = bool(_moe_layers(tp_model))
    rel, agree, n = 0.0, 0, 0
    for ps, sts, want, ids in reference:
        got, _ = _teacher_forced(tp_model, ps, sts,
                                 pins=ids if moe else None)
        want = want.to(got.device)
        rel = max(rel, float((got - want).norm(dim=-1).div(
            want.norm(dim=-1)).max()))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
        n += want.shape[0] * want.shape[1]
    return {"rel_l2_max": rel, "positions": n, "argmax_agree": agree,
            "routing_pinned": moe}


def _gang_serve_case(rank: int, ports: list, model, sizes: dict,
                     device=None, streams=None, mesh=None,
                     snapshot: Optional[dict] = None) -> dict:
    """One gang of ``prod(mesh)`` ranks (``{"model": 2}`` by default)
    through ``serve_main`` (rank 0's ``ModelServer`` over a
    ``GangEngine``, the others following), serving ``sizes["prompts"]``
    prompts over HTTP (``_drive_gang``); then ``streams`` (the unsharded
    engine's) fed through the gang's laid-out model and the unsharded one
    (``_teacher_forced_check``). ``host_copies``: the MoE count matrix's
    copies to the host in this process (serving must make none).

    Each rank builds ``model`` unsharded from SEED and serves it from
    ``mem://``, or with ``snapshot`` (``path``: a ``save_pretrained``
    directory every rank loads through ``storage_path``; ``max_seq_len``;
    ``reference``: a file of ``_teacher_forced_reference`` on the
    unsharded model) holds no unsharded model: a 7B's does not fit on the
    card twice beside its shards."""
    import os
    import threading

    import torch

    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.models import moe as moelib
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.serving import gang, storage

    mesh = mesh or {"model": 2}
    key = f"gang-serve-{rank}"
    if snapshot is None:
        cfg, m = _gang_model(model, device)
        source = {"params_ref": storage.register_mem(
            key, (cfg, m.state_dict()))}
    else:
        cfg, m = llama.load_pretrained_config(snapshot["path"]), None
        source = {"storage_path": snapshot["path"],
                  "max_seq_len": snapshot["max_seq_len"]}
    conf = {**source, "model_name": "m", "mesh_axes": mesh,
            "gang_port": ports[0], "serve_port": ports[1],
            "gang_token": "chip-smoke", "max_new_tokens": sizes["new"],
            "warmup_groups": [[sizes["prompts"], sizes["prompt_len"]],
                              [1, sizes["prompt_len"]]], **GANG_ENGINE}
    os.environ[gang.ENV_SERVE_CONFIG] = json.dumps(conf)
    ctx = bootstrap.PodContext(
        num_processes=math.prod(mesh.values()), process_id=rank,
        coordinator_address=f"127.0.0.1:{ports[2]}", device=device or "cuda")
    rec, ledger, out = _GangRecorder(), BlockLedger(), {}
    undo = rec.install(rank, ledger)
    prompts = _prompts(cfg, sizes["prompts"], sizes["prompt_len"])
    try:
        if rank == 0:
            t = threading.Thread(target=_drive_gang, args=(
                rec, f"http://127.0.0.1:{ports[1]}", prompts, sizes, out))
            t.start()
            try:
                gang.serve_main(ctx)
            finally:
                t.join()
            require("error" not in out, f"gang client: {out.get('error')}")
            eng = rec.engines[-1]
            out.update(pool_heads=int(eng._pool.k.shape[3]),
                       kv_pool_bytes=eng.kv_pool_bytes,
                       leaked=ledger.leaked_total,
                       ledger_errors=list(ledger.conservation_errors))
        else:
            gang.serve_main(ctx)
            eng = rec.engines[-1]
            out.update(pool_heads=int(eng._pool.k.shape[3]),
                       kv_pool_bytes=eng.kv_pool_bytes)
        tp_model = rec.engines[-1].model
        reference = (_teacher_forced_reference(m, prompts, streams)
                     if m is not None else torch.load(
                         snapshot["reference"],
                         map_location=tp_model.embedder.embedding.device))
        out["teacher_forced"] = _teacher_forced_check(reference, tp_model)
        out["host_copies"] = moelib.HOST_COPIES["moe_ep_counts"]
        out["w_gate"] = [list(x.w_gate.shape)
                         for x in _moe_layers(tp_model)][:1]
        out["digests"] = rec.digests()
        out["row_launches"] = [d for _, _, d in rec.rows]
        out["weight_bytes"] = sum(p.numel() * p.element_size()
                                  for p in tp_model.parameters())
    finally:
        undo()
        storage._MEM_REGISTRY.pop(key, None)
        del m
        _free_card(device is None)
    return out


def _gang_leader(port: int, cfg, params, kw: dict, ledger=None):
    from kubeflow_tpu_torch.serving.gang import GangChannel, GangEngine

    ch = GangChannel.listen(port, 1, token="chip-smoke", timeout=300)
    eng = GangEngine(cfg, params, channel=ch, mesh_axes={"model": 2}, **kw)
    if ledger is not None:
        eng.attach_block_ledger(ledger)
    return eng


def _gang_follow(port: int, cfg, params, kw: dict) -> dict:
    """Rank 1 follows to the leader's stop. With a ``program_cache`` in
    ``kw``, ``"aot"`` holds its counters at each engine a resize hands
    over and at the end."""
    from kubeflow_tpu_torch.serving import continuous
    from kubeflow_tpu_torch.serving.gang import GangChannel, follow

    ch = GangChannel.connect("127.0.0.1", port, rank=1, token="chip-smoke",
                             timeout=300)
    eng = continuous.ContinuousEngine(cfg, params, mesh_axes={"model": 2},
                                      **kw)
    cache = kw.get("program_cache")
    aot: list = []

    def on_engine(_new):
        if cache is not None:
            aot.append(cache.stats())

    try:
        follow(eng, ch, on_engine=on_engine)
    finally:
        ch.close()
    on_engine(None)
    return {"aot": aot} if cache is not None else {}


def _gang_wire_case(rank: int, port: int, model, sizes: dict,
                    device=None) -> dict:
    """A live sequence of the TP=2 gang exported (every head gathered to
    rank 0) after ``at`` tokens and moved over the kv_migrate wire into an
    unsharded engine on rank 0's card, where it finishes; the other prompt
    finishes in the gang."""
    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.serving import continuous
    from kubeflow_tpu_torch.serving.gang import (
        KvMigrationServer,
        migrate_sequence,
        register_migration_handle,
    )

    cfg, m = _gang_model(model, device)
    sd = m.state_dict()
    kw = dict(WIRE_ENGINE, device=device)
    warm = [(sizes["prompts"], sizes["prompt_len"]), (1, sizes["prompt_len"])]
    if rank:
        out = _gang_follow(port, cfg, sd, kw)
        del m, sd
        _free_card(device is None)
        return out
    ledger = BlockLedger()
    src = _gang_leader(port, cfg, sd, kw, ledger)
    dst = continuous.ContinuousEngine(cfg, m, **kw)
    dst.attach_block_ledger(ledger)
    srv = KvMigrationServer(dst, token="chip-smoke")
    try:
        src.warmup(warm)
        dst.warmup(warm)
        prompts = _prompts(cfg, sizes["prompts"], sizes["prompt_len"])
        reqs = [src.submit(p, max_new_tokens=sizes["new"]) for p in prompts]
        _wait_tokens(reqs[:1], sizes["at"], "wire_migrate")
        t0 = time.perf_counter()
        snap = src.export_sequence(reqs[0])
        t1 = time.perf_counter()
        ok = migrate_sequence(snap, "127.0.0.1", srv.port,
                              token="chip-smoke",
                              mid=register_migration_handle(reqs[0]))
        t2 = time.perf_counter()
        src.release_sequence(reqs[0])
        streams = [r.wait(600) for r in reqs]
        return {"ok": ok, "streams": streams,
                "snapshot_heads": int(snap["blocks"][0][0].shape[3]),
                "snapshot_blocks": len(snap["blocks"]),
                "export_ms": (t1 - t0) * 1e3, "wire_ms": (t2 - t1) * 1e3,
                "imports": srv.imports_total,
                "clean": _require_clean("wire_migrate", ledger, src, dst)}
    finally:
        srv.close()
        dst.stop()
        src.stop()
        del m, sd
        _free_card(device is None)


def _gang_resize_case(rank: int, port: int, model, sizes: dict,
                      device=None, aot_root=None) -> dict:
    """A live TP=2 gang serves a stream undisturbed, then the same stream
    again, during which it shrinks to 1 (rank 1 parked, the group
    re-formed) after ``shrink_at`` tokens and grows back to 2 after
    ``grow_at``; the stream is read on its handle throughout. Each resize
    is the autoscaler's decision posted to rank 0's resize route
    (``gang.post_resize`` to ``gang.resize_route`` on a ``ModelServer``,
    the gang token checked), as the controller's actuator posts it. Each
    rank's engines share a program cache on ``aot_root`` (the gang's
    ``aot``): the grow-back meets the degree-2 records of the first boot;
    rank 0's ``grow["aot"]`` is its counters' change over the grow."""
    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.serving import gang, programs
    from kubeflow_tpu_torch.serving.resize import GangResizer
    from kubeflow_tpu_torch.serving.server import ModelServer

    cfg, m = _gang_model(model, device)
    sd = m.state_dict()
    kw = dict(RESIZE_ENGINE, device=device,
              program_cache=programs.build_program_cache(
                  {"aot": {"root": aot_root}} if aot_root else None))
    warm = [(1, sizes["prompt_len"])]
    if rank:
        out = _gang_follow(port, cfg, sd, kw)
        del m, sd
        _free_card(device is None)
        return out
    ledger = BlockLedger()
    eng = _gang_leader(port, cfg, sd, kw, ledger)
    del m
    eng.warmup(warm)
    resizer = GangResizer(eng, reshard_token="chip-smoke",
                          warmup_groups=warm)
    server = ModelServer()
    server.add_control_route(gang.RESIZE_ROUTE, gang.resize_route(
        resizer, resizer.channel, "chip-smoke"))
    server.start()
    try:
        prompt = _prompts(cfg, 1, sizes["prompt_len"])[0]
        # the same stream with no resize: what the resized one must equal
        undisturbed = eng.submit(prompt,
                                 max_new_tokens=sizes["new"]).wait(600)
        req = eng.submit(prompt, max_new_tokens=sizes["new"])
        _wait_tokens([req], sizes["shrink_at"], "tp_resize")
        t0 = time.perf_counter()
        answer = gang.post_resize(server.url, 1, "chip-smoke")
        route_s = time.perf_counter() - t0
        one = resizer.engine
        require(answer == {"from": 2, "degree": 1, "resized": True},
                f"tp_resize: the route answered {answer}")
        shrink = {"at": len(req.tokens), "tp_degree": one.tp_degree,
                  "graphs": one.graphs, "timings": resizer.last_timings,
                  "route": answer, "route_s": route_s}
        _wait_tokens([req], sizes["grow_at"], "tp_resize")
        cache = kw["program_cache"]
        before = cache.stats() if cache is not None else {}
        t0 = time.perf_counter()
        answer = gang.post_resize(server.url, 2, "chip-smoke")
        route_s = time.perf_counter() - t0
        two = resizer.engine
        require(answer == {"from": 1, "degree": 2, "resized": True},
                f"tp_resize: the route answered {answer}")
        grow = {"at": len(req.tokens), "tp_degree": two.tp_degree,
                "graphs": two.graphs, "backend": two.backend,
                "timings": resizer.last_timings, "route": answer,
                "route_s": route_s}
        if cache is not None:
            grow["aot"] = {k: v - before[k]
                           for k, v in cache.stats().items()}
        tokens = req.wait(600)
        return {"tokens": tokens, "undisturbed": undisturbed,
                "shrink": shrink, "grow": grow,
                "resizes": resizer.resizes_total,
                "clean": _require_clean("tp_resize", ledger, two)}
    finally:
        server.stop()
        resizer.engine.stop()
        del sd
        _free_card(device is None)


def _collective_ms(vocab: int, reps: int = 50, device=None) -> dict:
    """ms of one collective of the group at a TP decode step's sizes, as the
    model issues them (``collectives.reduce_from_group``,
    ``gather_last_dim``): the all-reduce of a row-parallel product's [8,
    1024] bf16 and the all-gather of the head's [8, vocab / 2] bf16
    logits, each the mean of ``reps`` after a first one and a barrier
    (every rank calls this together)."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.collectives import (
        gather_last_dim,
        reduce_from_group,
    )

    dev = device or "cuda"
    group = dist.group.WORLD
    x = torch.ones(8, 1024, dtype=torch.bfloat16, device=dev)
    logits = torch.ones(8, vocab // 2, dtype=torch.bfloat16, device=dev)

    def timed(fn) -> float:
        fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        dist.barrier(group=group)  # both ranks start the clock together
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    return {"backend": dist.get_backend(),
            "all_reduce_ms": timed(lambda: reduce_from_group(x, group)),
            "all_gather_ms": timed(lambda: gather_last_dim(logits, group))}


def _gang_rank(rank: int, ports: list, dense, moe, sizes: dict,
               device=None, streams=None, aot_root=None) -> dict:
    """Every gang case on one of the two ranks, in order (a spawn each is
    a process start and a model build more): ``tp_serve`` and
    ``moe_tp_serve`` through ``serve_main`` (``streams``: the unsharded
    engine's, for the teacher-forced check), then the wire export and the
    resize."""
    import torch

    if device is None:
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"collectives": _collective_ms(_config(dense).vocab_size,
                                         device=device)}
    t0 = time.perf_counter()
    out["tp_serve"] = _gang_serve_case(rank, ports[0:3], dense,
                                       sizes["tp_serve"], device,
                                       streams["tp_serve"])
    t1 = time.perf_counter()
    out["moe_tp_serve"] = _gang_serve_case(rank, ports[3:6], moe,
                                           sizes["moe_tp_serve"], device,
                                           streams["moe_tp_serve"])
    t2 = time.perf_counter()
    out["wire"] = _gang_wire_case(rank, ports[6], dense, sizes["wire"],
                                  device)
    t3 = time.perf_counter()
    out["resize"] = _gang_resize_case(rank, ports[7], _resize_model(dense),
                                      sizes["resize"], device, aot_root)
    out["seconds"] = {"tp_serve": t1 - t0, "moe_tp_serve": t2 - t1,
                      "wire": t3 - t2, "resize": time.perf_counter() - t3}
    return out


def _case_rank(rank: int, ports: list, model, sizes: dict, device=None,
               streams=None, mesh=None, snapshot=None) -> dict:
    """One rank of a gang spawned for one serving case (``moe_ep_serve``
    at ``EP_MESH``, ``tp7b_serve``): ``_gang_serve_case``."""
    import torch

    if device is None:
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = _gang_serve_case(rank, ports, model, sizes, device, streams,
                           mesh=mesh, snapshot=snapshot)
    out["case_seconds"] = time.perf_counter() - t0
    return out


def _gang_row(name: str, line: str, model, cfg_n, m_n, prompts, truth,
              ranks: list, sizes: dict, mesh: dict, device) -> dict:
    """Hold one serving gang's ranks (``_gang_serve_case`` results, rank 0
    first) against the unsharded engine on the same device, emit its line
    and return it: each rank's decode path teacher-forced within
    TEACHER_TOL, rank 0's streams first apart from the unsharded ones only
    at a near tie, every follower's program outputs bitwise rank 0's, a
    pool of ``num_kv_heads / model`` heads a rank, 0 captures after
    warmup, 0 leaked blocks, no count-matrix host copy, and on the card
    every rank's K4a launched (an MoE model)."""
    a, rest = ranks[0], ranks[1:]
    tp = mesh.get("model", 1)
    tf = [x["teacher_forced"] for x in ranks]
    require(all(x["rel_l2_max"] <= TEACHER_TOL for x in tf),
            f"{name}: the gang's decode-path logits are "
            f"{[x['rel_l2_max'] for x in tf]} (relative L2) from the "
            f"unsharded model's, over {TEACHER_TOL}")
    diffs = _diffs(name, cfg_n, m_n, prompts, truth["tokens"], a["tokens"])
    lo, hi = a["window"]
    launches = {"rank0": a["launches"], **{
        f"rank{i + 1}": _sum_launches(b["row_launches"][lo:hi])
        for i, b in enumerate(rest)}}
    st = a["stats"]
    row = dict(card=line,
               model=model if isinstance(model, str) else "custom",
               mesh=mesh, backend=a["backend"], graphs=a["graphs"],
               engine=GANG_ENGINE, **sizes,
               tokens_per_sec=a["tokens_per_sec"],
               tokens_per_sec_rounds=a["tokens_per_sec_rounds"],
               ms_per_dispatch=a["ms_per_dispatch"],
               decode_steps=a["decode_steps"], seconds=a["seconds"],
               unsharded_tokens_per_sec=truth["tokens_per_sec"],
               unsharded_ms_per_dispatch=truth["ms_per_dispatch"],
               kv_pool_bytes_per_rank=[x["kv_pool_bytes"] for x in ranks],
               unsharded_kv_pool_bytes=truth["stats"]["kv_pool_bytes"],
               pool_heads=[x["pool_heads"] for x in ranks],
               captures_after_warmup=st["graph_captures_total"],
               blocks_leaked=a["leaked"], ledger_errors=a["ledger_errors"],
               differences_from_unsharded=diffs, teacher_forced=tf,
               follower_outputs_equal=all(
                   b["digests"] == a["digests"] for b in rest),
               programs_run=len(a["digests"]), launches=launches,
               unsharded_launches=truth["launches"],
               host_copies=[x["host_copies"] for x in ranks],
               w_gate_per_rank=a["w_gate"])
    require(row["follower_outputs_equal"],
            f"{name}: a follower's program outputs differ from rank 0's")
    require(tp * a["kv_pool_bytes"] == truth["stats"]["kv_pool_bytes"]
            and a["pool_heads"] == cfg_n.num_kv_heads // tp,
            f"{name}: the pool of a rank is not 1/{tp} of the unsharded one")
    require(st["graph_captures_total"] == 0, f"{name}: captures")
    require(a["leaked"] == 0 and not a["ledger_errors"],
            f"{name}: leaked blocks")
    require(st["tp_degree"] == tp, f"{name}: tp_degree {st['tp_degree']}")
    require(not any(row["host_copies"]),
            f"{name}: count-matrix host copies {row['host_copies']}")
    if cfg_n.moe_experts and device is None:
        require(all(x.get("gmm", 0) > 0 for x in launches.values()),
                f"{name}: gmm launches {launches}")
    return row


def _truth(cfg, model, prompts, new: int, warm, engine_kw: dict,
           counters: bool = False) -> dict:
    """One engine's streams on the device ``model`` lives on, the
    unsharded baseline of a gang case."""
    return _serve(cfg, model, prompts, new, warm, counters=counters,
                  device=model.embedder.embedding.device, **engine_kw)


def _diffs(name: str, cfg, model, prompts, want, got) -> list:
    """``got``'s first differences from ``want``, each required to sit at
    a near tie (``_near_tie``): a tensor-parallel rank sums partial
    products over the group, a rounding the unsharded product does not
    make."""
    diffs = _first_difference(cfg, model, prompts, want, got)
    _require_streams(name, diffs)
    return diffs


def gang_serving(dense, moe, device=None, sizes=GANG,
                 line: str = "") -> dict:
    """The gang phases (``tp_serve``, ``moe_tp_serve``, the gang half of
    ``wire_migrate``, ``tp_resize``): two ranks share the card over gloo
    (``device=None``; ``"cpu"`` with tiny configs rehearses them), then
    ``moe_ep_serve``, four ranks at ``EP_MESH`` held against
    ``moe_tp_serve``'s unsharded baseline, each
    case held against the unsharded engine on the same device: the serving
    cases' streams, and their decode path teacher-forced on those streams
    (``TEACHER_TOL``); the resized stream bitwise against the same stream
    undisturbed, in f32 (``_resize_model``)."""
    from kubeflow_tpu_torch.parallel import dryrun
    from kubeflow_tpu_torch.utils.net import free_port

    dev = device or "cuda"
    baselines = {}
    for name, model in (("tp_serve", dense), ("moe_tp_serve", moe)):
        cfg, m = _gang_model(model, dev)
        s = sizes[name]
        prompts = _prompts(cfg, s["prompts"], s["prompt_len"])
        baselines[name] = (cfg, m, prompts, _truth(
            cfg, m, prompts, s["new"], [(s["prompts"], s["prompt_len"]),
                                        (1, s["prompt_len"])],
            GANG_ENGINE, counters=True))
    cfg, m = baselines["tp_serve"][:2]
    w = sizes["wire"]
    wire_prompts = _prompts(cfg, w["prompts"], w["prompt_len"])
    wire_truth = _truth(cfg, m, wire_prompts, w["new"],
                        [(w["prompts"], w["prompt_len"]),
                         (1, w["prompt_len"])], WIRE_ENGINE)
    r = sizes["resize"]
    rcfg, rm = _gang_model(_resize_model(dense), dev)
    resize_prompt = _prompts(rcfg, 1, r["prompt_len"])
    resize_truth = _truth(rcfg, rm, resize_prompt, r["new"],
                          [(1, r["prompt_len"])], RESIZE_ENGINE)
    _free_card(device is None)
    ports = [free_port() for _ in range(8)]
    streams = {n: b[3]["tokens"] for n, b in baselines.items()}
    resize_root = fresh_aot_root("tp-resize")
    t0 = time.perf_counter()
    try:
        ranks = dryrun.spawn(2, _gang_rank, ports, dense, moe, sizes, device,
                             streams, resize_root, backend="gloo",
                             timeout=sizes["timeout"])
    finally:
        shutil.rmtree(resize_root, ignore_errors=True)
    spawn_s = time.perf_counter() - t0
    lead, follower = ranks
    out = {"spawn_seconds": spawn_s, "case_seconds": lead["seconds"]}
    collectives = [r["collectives"] for r in ranks]
    for name in ("tp_serve", "moe_tp_serve"):
        cfg_n, m_n, prompts, truth = baselines[name]
        model = dense if name == "tp_serve" else moe
        row = _gang_row(name, line, model, cfg_n, m_n, prompts, truth,
                        [lead[name], follower[name]], sizes[name],
                        {"model": 2}, device)
        row["collective_ms_per_rank"] = collectives
        emit(name, **row)
        out[name] = row
    # four ranks: the MoE's experts over ``expert``, its mlp over ``model``
    cfg_n, m_n, prompts, truth = baselines["moe_tp_serve"]
    ep_ports = [free_port() for _ in range(3)]
    t0 = time.perf_counter()
    ep = dryrun.spawn(4, _case_rank, ep_ports, moe, sizes["moe_ep_serve"],
                      device, streams["moe_tp_serve"], EP_MESH,
                      backend="gloo", timeout=sizes["timeout"])
    out["ep_spawn_seconds"] = time.perf_counter() - t0
    row = _gang_row("moe_ep_serve", line, moe, cfg_n, m_n, prompts, truth,
                    ep, sizes["moe_ep_serve"], EP_MESH, device)
    tp_row = out["moe_tp_serve"]
    row["moe_tp_serve"] = {k: tp_row[k] for k in (
        "tokens_per_sec", "ms_per_dispatch", "kv_pool_bytes_per_rank")}
    row["case_seconds"] = [x["case_seconds"] for x in ep]
    emit("moe_ep_serve", **row)
    out["moe_ep_serve"] = row
    wr = lead["wire"]
    wire_diffs = _diffs("wire_migrate", cfg, m, wire_prompts,
                        wire_truth["tokens"], wr["streams"])
    require(wr["ok"] is True and wr["imports"] == 1,
            f"wire_migrate: the TP=2 export was not imported: {wr['ok']}")
    require(wr["snapshot_heads"] == cfg.num_kv_heads,
            f"wire_migrate: a TP=2 snapshot of {wr['snapshot_heads']} heads")
    out["wire"] = {**{k: v for k, v in wr.items() if k != "streams"},
                   "differences_from_unsharded": wire_diffs}
    rs = lead["resize"]
    require(rs["tokens"] == rs["undisturbed"],
            "tp_resize: the resized stream differs from the same stream "
            f"undisturbed: {rs['tokens']} vs {rs['undisturbed']}")
    resize_diffs = _diffs("tp_resize", rcfg, rm, resize_prompt,
                          resize_truth["tokens"], [rs["tokens"]])
    require(rs["shrink"]["tp_degree"] == 1 and rs["grow"]["tp_degree"] == 2
            and rs["resizes"] == 2, f"tp_resize: {rs}")
    require(0 < rs["shrink"]["at"] < rs["grow"]["at"] < sizes["resize"][
        "new"], f"tp_resize: the stream was not live across both resizes "
        f"{rs['shrink']['at']}, {rs['grow']['at']}")
    # the grow-back meets the first boot's degree-2 records on both ranks
    # (rank 1: from the grow's hand-over to its end)
    f0, f1 = follower["resize"]["aot"][-2:]
    grow_aot = {"rank0": rs["grow"]["aot"],
                "rank1": {k: f1[k] - f0[k] for k in f1}}
    require(all(a["aot_cache_hits_total"] > 0
                and a["aot_cache_misses_total"] == 0
                and a["aot_cache_load_failures_total"] == 0
                for a in grow_aot.values()),
            f"tp_resize: the grow-back did not boot warm: {grow_aot}")
    rs["grow"]["aot"] = grow_aot
    row = dict(card=line, engine=RESIZE_ENGINE, **sizes["resize"],
               dtype="float32", equal_to_undisturbed=True,
               shrink=rs["shrink"], grow=rs["grow"], clean=rs["clean"],
               differences_from_unsharded=resize_diffs,
               seconds=lead["seconds"]["resize"])
    emit("tp_resize", **row)
    out["tp_resize"] = row
    del m, rm, baselines
    _free_card(device is None)
    return out


def _sum_launches(rows: list) -> dict:
    out: dict = {}
    for delta in rows:
        for k, v in delta.items():
            out[k] = out.get(k, 0) + v
    return out


def wire_local(model, device=None, sizes=GANG["wire"]) -> dict:
    """The kv_migrate wire in one process: ``DisaggregatedPool(wire=True)``
    (every prefill-to-decode handoff over loopback TCP) and
    ``migrate_sequence`` of a live sequence between two engines, each
    against one engine's streams."""
    from kubeflow_tpu_torch.analysis.runtime import BlockLedger
    from kubeflow_tpu_torch.serving import continuous
    from kubeflow_tpu_torch.serving.gang import (
        KvMigrationServer,
        migrate_sequence,
        register_migration_handle,
    )

    cfg, m = _gang_model(model, device or "cuda")
    kw = dict(WIRE_ENGINE, device=device)
    prompts = _prompts(cfg, 4, sizes["prompt_len"])
    warm = [(4, sizes["prompt_len"]), (1, sizes["prompt_len"])]
    truth = _truth(cfg, m, prompts, sizes["new"], warm, WIRE_ENGINE)
    pool = continuous.DisaggregatedPool(
        cfg, m, wire=True, **dict(kw, prefill_budget=64))
    try:
        pool.warmup(warm)
        streams, seconds = _serve_all(pool, prompts, sizes["new"])
        pst = pool.stats()
    finally:
        pool.stop()
    disagg_diffs = _diffs("wire_migrate", cfg, m, prompts, truth["tokens"],
                          streams)
    ledger = BlockLedger()
    src = continuous.ContinuousEngine(cfg, m, **kw)
    dst = continuous.ContinuousEngine(cfg, m, **kw)
    for e in (src, dst):
        e.attach_block_ledger(ledger)
    srv = KvMigrationServer(dst, token="chip-smoke")
    try:
        src.warmup(warm)
        dst.warmup(warm)
        reqs = [src.submit(p, max_new_tokens=sizes["new"]) for p in prompts]
        _wait_tokens(reqs, sizes["at"], "wire_migrate")
        # both freeze first (copy), then move (cutover); the destination
        # resolves each request's handle from the migration id
        snaps = [src.export_sequence(req) for req in reqs[:2]]
        for req, snap in zip(reqs, snaps):
            require(snap is not None
                    and migrate_sequence(
                        snap, "127.0.0.1", srv.port, token="chip-smoke",
                        mid=register_migration_handle(req)) is True,
                    "wire_migrate: a transfer failed")
            src.release_sequence(req)
        streams = [r.wait(600) for r in reqs]
        clean = _require_clean("wire_migrate", ledger, src, dst)
    finally:
        srv.close()
        src.stop()
        dst.stop()
    mig_diffs = _diffs("wire_migrate", cfg, m, prompts, truth["tokens"],
                       streams)
    require(pst["kv_migrations_total"] == len(prompts),
            f"wire_migrate: {pst['kv_migrations_total']} handoffs")
    del m
    _free_card(device is None)
    return {"disagg": {"seconds": seconds,
                       "kv_migrations_total": pst["kv_migrations_total"],
                       "kv_migrate_bytes_total":
                           pst["kv_migrate_bytes_total"],
                       "differences": disagg_diffs},
            "migrate_sequence": {"moved": 2, "clean": clean,
                                 "imports": srv.imports_total,
                                 "differences": mig_diffs}}


def nccl_graph_capture(model, sizes=NCCL_CAPTURE) -> dict:
    """The NCCL capture path a multi-GPU host runs, on the one card: a
    one-rank NCCL group through ``bootstrap``; a CUDA graph holding the
    tensor-parallel all-reduce and all-gather (``collectives.
    reduce_from_group``/``gather_last_dim``) captured, replayed on new
    inputs and held against the eager result; then the serving engine on
    the model with its tensor-parallel code path forced on (every module
    given the one-rank group), every program, its collectives included,
    captured in warmup and replayed, its greedy streams against the same
    engine without collectives."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.collectives import (
        gather_last_dim,
        reduce_from_group,
    )
    from kubeflow_tpu_torch.parallel.sharding import AxisGroup
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.utils.net import free_port

    ctx = bootstrap.PodContext(
        num_processes=1, coordinator_address=f"127.0.0.1:{free_port()}",
        dist_backend="nccl")
    bootstrap.initialize(ctx)
    try:
        require(dist.get_backend() == "nccl", "not an NCCL group")
        group = dist.group.WORLD
        gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
        a = torch.randn(64, 1024, generator=gen, device="cuda")
        w = torch.randn(1024, 2048, generator=gen, device="cuda")
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            eager = gather_last_dim(reduce_from_group(a @ w, group), group)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                static = gather_last_dim(reduce_from_group(a @ w, group),
                                         group)
        torch.cuda.current_stream().wait_stream(stream)
        a.copy_(torch.randn(64, 1024, generator=gen, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        want = gather_last_dim(reduce_from_group(a @ w, group), group)
        direct = {"max_abs_err": abs_err(static, want),
                  "first_replay_changed": not torch.equal(static, eager)}
        require(direct["max_abs_err"] == 0.0,
                f"nccl_graph_capture: replay differs {direct}")
        cfg, m = _gang_model(model)
        prompts = _prompts(cfg, sizes["prompts"], sizes["prompt_len"])
        warm = [(sizes["prompts"], sizes["prompt_len"]),
                (1, sizes["prompt_len"])]
        plain = _truth(cfg, m, prompts, sizes["new"], warm, SERVE_ENGINE)
        forced = AxisGroup(group, 1, 0)
        mods = [mod for mod in m.modules() if hasattr(mod, "tp")]
        for mod in mods:
            mod.tp = forced
        try:
            tp = _truth(cfg, m, prompts, sizes["new"], warm, SERVE_ENGINE)
        finally:
            for mod in mods:
                del mod.tp
        st = tp["stats"]
        row = {"backend": dist.get_backend(), "direct": direct,
               "modules_on_the_group": len(mods),
               "graphs_captured_in_warmup": st["graph_captures_warmup"],
               "captures_after_warmup": st["graph_captures_total"],
               "cuda_graphs": st["cuda_graphs"],
               "streams_equal": tp["tokens"] == plain["tokens"],
               "tokens_per_sec": tp["tokens_per_sec"],
               "plain_tokens_per_sec": plain["tokens_per_sec"]}
        require(st["cuda_graphs"] == 1 and st["graph_captures_total"] == 0,
                f"nccl_graph_capture: {row}")
        require(row["streams_equal"],
                "nccl_graph_capture: the captured collectives changed the "
                "streams")
    finally:
        bootstrap.shutdown()
        _free_card(True)
    return row


def phase_nccl_graph_capture(line: str) -> None:
    emit("nccl_graph_capture", card=line, **nccl_graph_capture(
        "bench_model"))


#: the dry run's legs for four ranks, in order (leg 5 needs eight)
DRYRUN_LEGS = ("mesh", "gpipe", "1f1b", "expert", "tp_serve", "moe_serve")


def phase_dryrun(line: str) -> dict:
    """``python -m kubeflow_tpu_torch.parallel.dryrun 4 --backend gloo``
    on the card: the dry run's legs for four ranks (``DRYRUN_LEGS``), the
    ranks sharing the card over gloo, the tiny in bf16 at head dim 64; each
    training leg's loss (equal on every rank, finite) and each serving
    leg's tokens (equal to one unsharded engine's) printed."""
    from kubeflow_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    out = dryrun.dryrun_multichip(4, device="cuda", backend="gloo",
                                  timeout=600)
    legs = {name: {k: v for k, v in leg.items() if k != "ranks"}
            for name, leg in out["legs"].items()}
    row = dict(card=line, n=4, backend=out["backend"], legs=legs,
               seconds=time.perf_counter() - t0)
    emit("dryrun", **row)
    require(tuple(legs) == DRYRUN_LEGS, f"dryrun: legs {list(legs)}")
    return row


def phase_gang(line: str) -> dict:
    """``wire_migrate`` (in one process, then the TP=2 export) and the
    gang phases (``tp_serve``, ``moe_tp_serve``, ``moe_ep_serve``,
    ``tp_resize``) on the bench models at full width and depth."""
    t2 = time.perf_counter()
    local = wire_local("bench_model")
    t3 = time.perf_counter()
    gangs = gang_serving("bench_model", "bench_moe_model", line=line)
    emit("wire_migrate", card=line, **local, tp2_export=gangs["wire"])
    t4 = time.perf_counter()
    return {"wire_local": t3 - t2, "gang": t4 - t3,
            "gang_cases": {**gangs["case_seconds"],
                           "moe_ep_serve": gangs["ep_spawn_seconds"]},
            "tp_resize_grow": gangs["tp_resize"]["grow"]}


# -- the background track: a second process on the same card -----------------

#: the phases ``background_track`` runs, in order, in a second process
#: beside the main sequence: the parallel layouts and multi-GPU serving.
#: Each is two or more processes over gloo sharing the card, which stays
#: idle most of their time. The track starts once the kernel, training and
#: serving readings are taken (those are read with the card to themselves);
#: what either track times after that is read with the other one running
BACKGROUND_PHASES = (
    "mesh_train", "seq_train", "pipeline_train", "mesh_more_train",
    "wire_local", "gang", "tp7b_serve", "llama7b_serve")
#: the parallel phases the main sequence runs after ``nas_experiment``,
#: so that the two tracks end together (``mesh_more_train`` made the
#: background track the longer one)
MAIN_TAIL_PHASES = ("nccl_one_rank", "nccl_graph_capture",
                    "moe_mesh_train", "ring_attention_check", "dist_pods",
                    "dryrun")


def background_track(line: str, snap_dir: str) -> dict:
    """``BACKGROUND_PHASES`` in order (``tp7b_serve`` and ``llama7b_serve``
    on the 7B snapshot and adapter the main sequence writes into
    ``snap_dir``); returns each one's
    seconds (the gang's cases too) and the grow-back's cache outcome for
    ``aot_boots``."""
    seconds, t = {}, time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        seconds[name], t = now - t, now

    mesh = phase_mesh_train(line)
    lap("mesh_train")
    first = mesh["layouts"][0]
    baseline = (first["unsharded_losses"], first["unsharded_grad_norms"], [])
    phase_seq_train(line, baseline)
    lap("seq_train")
    pipe = phase_pipeline_train(line, baseline)
    lap("pipeline_train")
    more = phase_mesh_more_train(line, pipe)
    lap("mesh_more_train")
    seconds.update({f"mesh_more_train_{k}": v
                    for k, v in more["seconds"].items()})
    gang = phase_gang(line)
    grow = gang.pop("tp_resize_grow")
    seconds.update(gang)
    t = time.perf_counter()
    tp7b_serve(snap_dir, line=line)
    lap("tp7b_serve")
    phase_llama7b_serve(snap_dir, line)
    lap("llama7b_serve")
    return {"seconds": seconds, "tp_resize_grow": grow}


def main_tail(line: str) -> dict:
    """``MAIN_TAIL_PHASES`` in order; each one's seconds."""
    seconds = {}
    for name in MAIN_TAIL_PHASES:
        t0 = time.perf_counter()
        globals()[f"phase_{name}"](line)
        seconds[name] = time.perf_counter() - t0
    return seconds


def run_track(result_path: str, snap_dir: str) -> int:
    """``python3 chip_smoke.py --track RESULT SNAPSHOT_DIR``:
    ``background_track`` in this process; its phase lines go to stdout,
    its result as JSON to RESULT. SIGTERM unwinds it, so that every phase
    stops the processes it started."""
    import torch

    def _stop(*_):
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, _stop)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = background_track(card_line(), snap_dir)
    with open(result_path, "w") as f:
        json.dump(out, f)
    return 0


class BackgroundTrack:
    """``run_track`` in a child process of its own session, its stdout and
    stderr in files until ``join`` prints them after the main sequence's
    lines; ``snap_dir`` is where the main sequence writes the 7B
    snapshot."""

    #: seconds the track may take from its start
    TIMEOUT = 1200

    def __init__(self, snap_dir: str):
        here = os.path.abspath(__file__)
        self.dir = tempfile.mkdtemp(prefix="kft-track-")
        self.result = os.path.join(self.dir, "result.json")
        self.out = open(os.path.join(self.dir, "stdout"), "w+")
        self.err = open(os.path.join(self.dir, "stderr"), "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, here, "--track", self.result, snap_dir],
            cwd=os.path.dirname(here), stdout=self.out, stderr=self.err,
            start_new_session=True)

    def _forward(self) -> str:
        """Prints the track's lines; returns the end of its stderr."""
        self.out.seek(0)
        sys.stdout.write(self.out.read())
        sys.stdout.flush()
        self.err.seek(0)
        err = self.err.read()
        sys.stderr.write(err)
        sys.stderr.flush()
        return err[-4000:]

    def check(self) -> None:
        """Fails at once when the track has failed, instead of after the
        rest of the main sequence."""
        rc = self.proc.poll()
        if rc not in (None, 0):
            tail = self._forward()
            raise RuntimeError(f"background track exited {rc}:\n{tail}")

    def join(self) -> dict:
        """Waits for the track; its result, with ``wall`` (s from its start
        to its end) and ``waited`` (s the main sequence waited for it)."""
        t = time.perf_counter()
        left = self.TIMEOUT - (t - self.t0)
        try:
            rc = self.proc.wait(max(left, 1.0))
        except subprocess.TimeoutExpired:
            self._forward()
            raise RuntimeError(f"background track not done in "
                               f"{self.TIMEOUT} s") from None
        done = time.perf_counter()
        tail = self._forward()
        require(rc == 0, f"background track exited {rc}:\n{tail}")
        with open(self.result) as f:
            out = json.load(f)
        out.update(wall=done - self.t0, waited=done - t)
        return out

    def stop(self) -> None:
        """Ends the track (SIGTERM, SIGKILL after 60 s) and whatever is
        left of its session, and removes its files."""
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait()
        self.out.close()
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


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
    t_lint = time.perf_counter()
    phase_lint(line)
    lint_s = time.perf_counter() - t_lint
    nvcc_s = phase_build()
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
    t_tp = time.perf_counter()
    phase_tp_gmm_time()
    t_ep = time.perf_counter()
    phase_ep_gmm_time()
    tp_gmm_s, ep_gmm_s = t_ep - t_tp, time.perf_counter() - t_ep
    phase_serve()
    phase_serve_variants()
    phase_moe_serve()
    # the layouts and multi-GPU serving from here on in a second process;
    # the 7B's snapshot goes to a directory both tracks see
    t_split = time.perf_counter()
    snap7b = tempfile.mkdtemp(prefix="kft-7b-")
    track = BackgroundTrack(snap7b)
    try:
        phase_llama7b_job(snap7b, line)
        t0 = time.perf_counter()
        track.check()
        phase_spec_serve()
        phase_moe_spec_serve()
        phase_prefix_serve()
        t1 = time.perf_counter()
        track.check()
        phase_migrate_serve()
        phase_moe_migrate_serve()
        phase_hibernate_serve()
        phase_host_tier_serve()
        phase_disagg_serve()
        t_bf16 = time.perf_counter()
        phase_bf16_snapshot_serve(line)
        t2 = time.perf_counter()
        track.check()
        phase_http_serve(line)
        t_isvc = time.perf_counter()
        track.check()
        isvc = phase_isvc_serve(line)
        t_http = time.perf_counter()
        track.check()
        work = tempfile.mkdtemp(prefix="kft-finetune-")
        try:
            ft = phase_finetune(work, line)
            t3 = time.perf_counter()
            phase_adafactor_step(ft["base"], line)
            t4 = time.perf_counter()
            track.check()
            phase_finetune_serve(ft["base"], ft["adapter"], line)
            t5 = time.perf_counter()
            phase_corpus_train(ft["base"], work, line)
            t_hpo = time.perf_counter()
            track.check()
            phase_hpo_sweep(ft["base"], work, line)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        t6 = time.perf_counter()
        track.check()
        phase_bert_serve(line)
        t7 = time.perf_counter()
        phase_resnet_train(line)
        t8 = time.perf_counter()
        phase_jaxjob_pods(line)
        t9 = time.perf_counter()
        track.check()
        darts = phase_darts_search(line)
        t_nas = time.perf_counter()
        phase_nas_experiment(line, darts["ranked_top"])
        t10 = time.perf_counter()
        track.check()
        tail = main_tail(line)
        t11 = time.perf_counter()
        bg = track.join()
    finally:
        track.stop()
        shutil.rmtree(snap7b, ignore_errors=True)
    grow = bg["tp_resize_grow"]
    now = time.perf_counter()
    # the program-artifact cache's boots in one line: cold (an empty root)
    # against warm (the same config again), with what nvcc took when
    # build/kernels/ was empty
    emit("aot_boots", card=line, nvcc_build_s=nvcc_s,
         cold=isvc["cold_boot"], warm=isvc["warm_boot"],
         torn=isvc["torn"], torn_boot=isvc["torn_boot"],
         moe_warm_ready_s=isvc["moe_warm_ready_s"],
         isvc_steps_s={k: isvc["step_s"][k]
                       for k in ("moe_warm_boot", "moe_torn_boot")},
         tp_resize_grow={"aot": grow["aot"],
                         "reshard_s": grow["timings"]["reshard_s"]})
    # the background track's phases ran beside the main sequence's from
    # ``before_split`` on: ``main_track`` and ``background_track`` are the
    # two tracks' walls from there, ``waited`` what the main sequence
    # waited for the other at its end
    gang_s = bg["seconds"]
    emit("phase_seconds", total=now - started, lint=lint_s,
         before_split=t_split - started, main_track=t11 - t_split,
         background_track=bg["wall"], waited=bg["waited"],
         llama7b_job=t0 - t_split,
         speculation_and_prefix=t1 - t0, migration_and_tiers=t_bf16 - t1,
         bf16_snapshot_serve=t2 - t_bf16, ep_gmm_time=ep_gmm_s,
         http_serve=t_isvc - t2, isvc_serve=t_http - t_isvc,
         finetune=t3 - t_http, adafactor_step=t4 - t3,
         finetune_serve=t5 - t4, corpus_train=t_hpo - t5,
         hpo_sweep=t6 - t_hpo, bert_serve=t7 - t6, resnet_train=t8 - t7,
         jaxjob_pods=t9 - t8, darts_search=t_nas - t9,
         nas_experiment=t10 - t_nas, tp_gmm_time=tp_gmm_s,
         multi_gpu_serving=(tail["nccl_graph_capture"] + gang_s["wire_local"]
                            + gang_s["gang"]), **tail, **gang_s)
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
    if sys.argv[1:2] == ["--track"]:
        sys.exit(run_track(sys.argv[2], sys.argv[3]))
    sys.exit(run())
