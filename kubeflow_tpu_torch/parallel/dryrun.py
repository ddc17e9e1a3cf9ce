"""One tiny sharded training step over ``n`` processes: the port's
counterpart of ``__graft_entry__.dryrun_multichip``.

    python -m kubeflow_tpu_torch.parallel.dryrun 2 --backend gloo
    python -m kubeflow_tpu_torch.parallel.dryrun 4 --device cpu

``n`` ranks are factored into ``model``, ``seq`` (from four ranks on),
``fsdp`` and ``data`` axes (``axes_for``), ``n`` processes are spawned into
one process group, and each runs one step of the tiny Llama with ring
attention through the ``Trainer`` on that mesh; with an even ``n`` of four
or more, a second step runs the 4-layer tiny through GPipe on
``{"pipeline": 2, "data": n / 2}``, as the reference's dry run does. The
ranks run on the card (nccl, one card per rank; ``--backend gloo`` lets
ranks share one) unless ``--device cpu`` asks for the CPU (gloo); with no
card and no ``--device cpu`` this raises. Every rank must report the same
finite loss on each mesh.

``spawn`` is the harness: each process joins a fresh rendezvous
(``utils.net.free_port``, the ``spawn`` start method) and returns a
picklable value; a rank that does not finish within ``timeout`` seconds
fails the run instead of hanging it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional


def axes_for(n: int) -> dict[str, int]:
    """Factor n devices into model/seq/fsdp/data axes: the reference's
    ``_axes_for`` for the tiny model (``model`` up to its 2 KV heads, a
    ``seq`` axis from 4 devices on)."""
    axes: dict[str, int] = {}
    remaining = n
    if remaining % 2 == 0:
        axes["model"] = 2
        remaining //= 2
    if n >= 4 and remaining % 2 == 0:
        axes["seq"] = 2
        remaining //= 2
    if remaining % 2 == 0:
        axes["fsdp"] = 2
        remaining //= 2
    if remaining > 1:
        axes["data"] = remaining
    if not axes:
        axes = {"data": n}
    return axes


def _child(rank: int, world: int, port: int, backend: str, out_dir: str,
           fn: Callable, args: tuple) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        try:
            result = ("ok", fn(rank, *args))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — forwarded: spawn() raises it
        result = ("error", traceback.format_exc())
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)


def spawn(n: int, fn: Callable, *args, backend: str = "gloo",
          timeout: float = 120.0) -> list:
    """``fn(rank, *args)`` in ``n`` new processes joined into one process
    group; returns their results in rank order. Raises with the first
    failing rank's traceback, or when a rank is not done in ``timeout``
    seconds (every process is killed first). ``fn`` must be importable by
    a fresh interpreter (a module-level function)."""
    import multiprocessing as mp

    from ..utils.net import free_port

    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="kft-spawn-") as out_dir:
        procs = [ctx.Process(target=_child, args=(r, n, port, backend,
                                                  out_dir, fn, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(n):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                why = (f"did not finish within {timeout} s" if r in hung
                       else f"exited {procs[r].exitcode} without a result")
                raise RuntimeError(f"rank {r} of {n} {why}")
            with open(path, "rb") as f:
                # analysis: ok unsafe-pickle — our own ranks' results, private temp dir
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} of {n} failed:\n{value}")
            results.append(value)
    return results


def _layouts(n: int) -> list[tuple[dict, dict]]:
    """(mesh, model fields) of each step the dry run takes on n ranks."""
    out = [(axes_for(n), {"attention_impl": "ring"})]
    if n >= 4 and n % 2 == 0:
        out.append(({"pipeline": 2, "data": n // 2}, {"num_layers": 4}))
    return out


def _one_step(rank: int, layouts: list, device: str) -> list[dict]:
    from ..models import llama
    from ..train.trainer import TrainConfig, Trainer

    if device == "cuda":
        import torch

        # one card per rank, or ranks sharing the cards there are
        torch.cuda.set_device(rank % torch.cuda.device_count())
    out = []
    for axes, model_kw in layouts:
        cfg = TrainConfig(model=llama.tiny(**model_kw), mesh_axes=axes,
                          global_batch=8, seq_len=32, steps=1,
                          warmup_steps=1)
        t = Trainer(cfg, device=device)
        t.init_state(0)
        loss, norm = t.step(t.data_source().local_batch(0)["tokens"])
        out.append({"rank": rank, "loss": float(loss),
                    "grad_norm": float(norm),
                    "batch_shard": [t.batch_index, t.batch_count]})
    return out


def dryrun_multichip(n: int, device: Optional[str] = None,
                     backend: Optional[str] = None,
                     timeout: float = 300.0) -> dict:
    """One tiny sharded step on ``n`` ranks (and one through the pipeline,
    ``_layouts``); returns each mesh and its ranks' losses (all equal and
    finite, or this raises). ``device=None`` means the card
    (``device.resolve_device``)."""
    from ..device import resolve_device

    device = resolve_device(device).type
    layouts = _layouts(n)
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    ranks = spawn(n, _one_step, layouts, device, backend=backend,
                  timeout=timeout)
    steps = []
    for i, (axes, _) in enumerate(layouts):
        mine = [r[i] for r in ranks]
        losses = [r["loss"] for r in mine]
        if not all(map(math.isfinite, losses)) or len(set(losses)) != 1:
            raise RuntimeError(f"{axes}: ranks disagree or diverged: "
                               f"{losses}")
        steps.append({"mesh": axes, "loss": losses[0],
                      "grad_norm": mine[0]["grad_norm"], "ranks": mine})
    return {**steps[0], "backend": backend, "device": device,
            "pipeline": steps[1] if len(steps) > 1 else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="number of ranks")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--backend", default=None, help="gloo or nccl")
    ap.add_argument("--timeout", type=float, default=300.0)
    a = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(a.n, a.device, a.backend, a.timeout)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
