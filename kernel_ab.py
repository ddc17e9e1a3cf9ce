#!/usr/bin/env python3
"""A/B timing of edited flash-attention kernel sources on one CUDA card.

    python3 kernel_ab.py flash_bwd_dq variant.cu [variant.cu ...]
        [--rounds 3] [--reps 200]

Builds each variant source of one flash kernel (K1 ``flash_fwd``, K2
``flash_bwd_dkv`` or K3 ``flash_bwd_dq``) with the build's own flags and
headers, then times the kernel at ``chip_smoke.BENCH`` (b=14, s=1024,
h=kv=8, d=128, causal) through its Python wrapper with the checkout's own
library (A) and with each variant's (B) loaded in turn, in the order A, B,
B, A for ``--rounds`` rounds. A reading is ``chip_smoke.time_ms``: the median
device time of ``--reps`` launches, each between CUDA events. Prints the
card's name and power limit, then one JSON line: per variant its ptxas
report, its largest difference from A's output relative to A's largest
value, and A's and B's readings. Variant libraries go to
``build/kernels/ab/``. Needs a CUDA card; imports nothing of jax or
kubeflow_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as smoke

FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def build_variants(kernel: str, sources: list[Path]) -> dict[str, tuple]:
    """source -> (ctypes library, ptxas report lines), one nvcc per source,
    all started together."""
    from kubeflow_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        lib = out_dir / f"lib{kernel}-variant{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(src)]
        procs.append((src, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for src, lib, proc in procs:
        log, _ = proc.communicate()
        smoke.require(proc.returncode == 0, f"{src} does not build:\n{log}")
        built[str(src)] = (ctypes.CDLL(str(lib)), [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "C75" in ln])
    return built


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("kernel", choices=FLASH_KERNELS)
    parser.add_argument("variants", nargs="+", type=Path)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args(argv)

    import torch

    smoke.require(torch.cuda.is_available(), "no CUDA device is visible")
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa

    own = _build.load(args.kernel)
    variants = build_variants(args.kernel, args.variants)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 1)
    q, k, v, do = smoke._inputs(**smoke.BENCH, gen=gen)
    o, lse = fa.flash_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    call = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v)[0],
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta)[0],
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
    }[args.kernel]

    def use(lib) -> None:
        _build._loaded[args.kernel] = lib

    ref = call().float()
    result = {}
    for name, (lib, ptxas) in variants.items():
        use(lib)
        readings = {"rel_diff": smoke.rel_err(call(), ref), "A": [], "B": []}
        for _ in range(args.rounds):
            for side in "ABBA":
                use(own if side == "A" else lib)
                readings[side].append(smoke.time_ms(call, args.reps))
        use(own)
        result[name] = {"ptxas": ptxas, **readings,
                        "A_median": statistics.median(readings["A"]),
                        "B_median": statistics.median(readings["B"])}
    print(smoke.card_line())
    print(json.dumps({"kernel": args.kernel, "shape": smoke.BENCH,
                      "reps": args.reps, "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
