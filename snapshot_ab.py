#!/usr/bin/env python3
"""A/B timing of the snapshot loader (``kubeflow_tpu_torch/models/_msgpack.py``
``load``) on a Llama-2 7B bf16 snapshot.

    python3 snapshot_ab.py OTHER_TREE

Builds ``llama2_7b(param_dtype=bfloat16)`` on the card from seed 0, writes
it with ``save_pretrained`` (13.48 GB, timed) into a temporary directory,
then reads it back with OTHER_TREE's ``_msgpack.load`` (A) and this
checkout's (B), each in a fresh process and in the order A, B, B, A. Each
read is followed by ``convert.state_dict_from_jax``, as ``load_pretrained``
does. Prints the card's name and power limit, then one JSON line a read:
the seconds of the load and of the conversion, and the process's peak
resident memory (``ru_maxrss``; a child starts from its parent's peak, so
only readings above the parent's are the load's own). The page cache holds
the file after the write: every read is warm. Needs a CUDA card; imports
nothing of jax or kubeflow_tpu.
"""

from __future__ import annotations

import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def read_once(tree: str, path: str) -> dict:
    """One timed read of the snapshot at ``path`` with ``tree``'s loader."""
    sys.path.insert(0, HERE)
    from kubeflow_tpu_torch.models import convert, llama

    spec = importlib.util.spec_from_file_location("_msgpack_under_test", (
        os.path.join(tree, "kubeflow_tpu_torch", "models", "_msgpack.py")))
    codec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(codec)
    cfg = llama.load_pretrained_config(path)
    t0 = time.perf_counter()
    tree_ = codec.load(os.path.join(path, "weights.msgpack"))
    t1 = time.perf_counter()
    sd = convert.state_dict_from_jax(tree_, cfg)
    t2 = time.perf_counter()
    return {"tree": tree, "load_s": t1 - t0, "state_dict_s": t2 - t1,
            "peak_rss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024, "leaves": len(sd)}


def main(other: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("snapshot_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kubeflow_tpu_torch.models import llama

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    work = tempfile.mkdtemp(prefix="kft-snapshot-ab-")
    try:
        path = os.path.join(work, "base")
        cfg = llama.llama2_7b(param_dtype=torch.bfloat16)
        model = llama.Llama(cfg, device="cuda")
        model.init_weights(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llama.save_pretrained(path, cfg, model)
        print(json.dumps({"save_s": time.perf_counter() - t0,
                          "bytes": os.path.getsize(os.path.join(
                              path, "weights.msgpack")),
                          "parent_peak_rss_bytes": resource.getrusage(
                              resource.RUSAGE_SELF).ru_maxrss * 1024}),
              flush=True)
        del model
        torch.cuda.empty_cache()
        for tree in (other, HERE, HERE, other):
            subprocess.run([sys.executable, __file__, "--read",
                            os.path.abspath(tree), path], check=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--read"]:
        print(json.dumps(read_once(sys.argv[2], sys.argv[3])), flush=True)
        sys.exit(0)
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
