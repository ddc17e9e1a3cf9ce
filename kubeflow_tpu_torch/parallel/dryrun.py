"""The sharded dry run over ``n`` processes: the port's counterpart of
``__graft_entry__.dryrun_multichip``, its seven legs.

    python -m kubeflow_tpu_torch.parallel.dryrun 8 --device cpu
    python -m kubeflow_tpu_torch.parallel.dryrun 4 --backend gloo

``n`` processes are spawned into one process group, and each takes one
training step of a tiny Llama through the ``Trainer`` on each training leg
(``_layouts``, the reference's conditions on ``n``):

1. ``mesh``: ring attention on ``axes_for(n)`` (``model``, ``seq`` from
   four ranks on, ``fsdp``, ``data``);
2. ``gpipe``: the 4-layer tiny through GPipe on ``{"pipeline": 2,
   "data": n / 2}`` (n >= 4, even);
3. ``1f1b``: the same mesh through 1F1B, 4 microbatches;
4. ``expert``: a ragged (dropless) MoE, 2 experts, top-1, on ``{"expert":
   2, "data": n / 2}``;
5. ``expert_1f1b``: the 4-layer MoE (2 experts, top-1) with its balancing
   loss (``aux_loss_coef`` 0.01) through 1F1B, 2 microbatches, on
   ``{"pipeline": 2, "expert": 2, "data": n / 4}`` (n >= 8);

then the serving legs, each a gang of its own ``prod(axes)`` ranks (a
spawn of that many processes: an engine runs only in a gang of its
degree): rank 0's ``GangEngine`` decides, the others ``follow``, and the
greedy tokens of one prompt must equal one unsharded engine's on the same
weights (built from one seed on every rank); on the card, in bf16, a
first difference is taken only where the unsharded model's top-2 logits
sit within ``NEAR_TIE`` of each other (a sharded sum rounds otherwise):

6. ``tp_serve``: the tiny on ``{"model": 2}``: warmup, then 4 tokens;
7. ``moe_serve``: the tiny MoE (4 experts, top-2, ragged) on
   ``{"expert": 2, "model": 2}`` (n >= 4), 4 tokens.

The ranks run on the card (nccl, one card per rank; ``--backend gloo``
lets ranks share one) unless ``--device cpu`` asks for the CPU (gloo); with
no card and no ``--device cpu`` this raises. On the card the tiny runs in
bf16 at head dim 64, the shapes its kernels take. Every rank must report
the same finite loss on each training leg.

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


#: the tiny MoE of the expert training legs (the reference's)
MOE_TRAIN = dict(moe_experts=2, moe_top_k=1)
#: the serving legs: (name, mesh, model fields, warm up first)
SERVE_LEGS = (
    ("tp_serve", {"model": 2}, {}, True),
    ("moe_serve", {"expert": 2, "model": 2},
     dict(moe_experts=4, moe_top_k=2, moe_dispatch="ragged"), False),
)
#: the serving legs' prompt, new tokens and engine knobs (the reference's)
SERVE_PROMPT, SERVE_NEW = [1, 2, 3], 4
SERVE_ENGINE = dict(num_slots=2, decode_chunk=2)
#: a serving leg's stream may first differ from the unsharded engine's on
#: the card only where the unsharded model's top-2 logits are this close,
#: relative to the top one: the card checks' near-tie bound (bf16 sums
#: over the gang's ranks round otherwise than the unsharded products)
NEAR_TIE = 2e-2


def _layouts(n: int) -> list[tuple[str, dict, dict, dict]]:
    """(name, mesh, model fields, trainer fields) of each training leg
    the dry run takes on n ranks."""
    out = [("mesh", axes_for(n), {"attention_impl": "ring"}, {})]
    if n >= 4 and n % 2 == 0:
        pipe = {"pipeline": 2, "data": n // 2}
        out += [
            ("gpipe", pipe, {"num_layers": 4}, {}),
            ("1f1b", pipe, {"num_layers": 4},
             {"num_microbatches": 4, "pipeline_schedule": "1f1b"}),
            ("expert", {"expert": 2, "data": n // 2},
             dict(MOE_TRAIN, moe_dispatch="ragged"), {}),
        ]
    if n >= 8 and n % 4 == 0:
        out.append(("expert_1f1b", {"pipeline": 2, "expert": 2,
                                    "data": n // 4},
                    dict(MOE_TRAIN, num_layers=4),
                    {"num_microbatches": 2, "pipeline_schedule": "1f1b",
                     "aux_loss_coef": 0.01}))
    return out


def _serve_legs(n: int) -> list[tuple[str, dict, dict, bool]]:
    """The serving legs whose gang fits in n ranks."""
    return [leg for leg in SERVE_LEGS if math.prod(leg[1].values()) <= n]


def tiny_for(device: str, **kw):
    """The dry run's tiny config on ``device``: on the card in bf16 at
    head dim 64 (the flash and grouped-GEMM kernels take bf16, and flash
    head dims of 64 or 128), on the CPU the reference's ``tiny``."""
    import torch

    from ..models import llama

    if device == "cuda":
        kw = {"dtype": torch.bfloat16, "head_dim": 64, **kw}
    return llama.tiny(**kw)


def global_batch(axes: dict, train_kw: dict) -> int:
    """A training leg's global batch: the reference's 8 rows, or the
    least multiple of 8 that its microbatches times its batch shards
    divide (each rank holds whole rows of every microbatch, where the
    reference's SPMD program may split one row's microbatch over
    devices)."""
    from .mesh import BATCH_AXES

    need = math.prod(s for a, s in axes.items() if a in BATCH_AXES)
    if axes.get("pipeline", 1) > 1:
        need *= train_kw.get("num_microbatches") or axes["pipeline"]
    return math.lcm(8, need)


def train_config(device: str, axes: dict, model_kw: dict, train_kw: dict):
    """The ``TrainConfig`` of one training leg."""
    from ..train.trainer import TrainConfig

    return TrainConfig(model=tiny_for(device, **model_kw), mesh_axes=axes,
                       global_batch=global_batch(axes, train_kw),
                       seq_len=32, steps=1, warmup_steps=1, **train_kw)


def _on_card(rank: int, device: str) -> None:
    if device == "cuda":
        import torch

        # one card per rank, or ranks sharing the cards there are
        torch.cuda.set_device(rank % torch.cuda.device_count())


def _one_step(rank: int, layouts: list, device: str) -> list[dict]:
    from ..train.trainer import Trainer

    _on_card(rank, device)
    out = []
    for _, axes, model_kw, train_kw in layouts:
        t = Trainer(train_config(device, axes, model_kw, train_kw),
                    device=device)
        t.init_state(0)
        loss, norm = t.step(t.data_source().local_batch(0)["tokens"])
        out.append({"rank": rank, "loss": float(loss),
                    "grad_norm": float(norm),
                    "batch_shard": [t.batch_index, t.batch_count]})
    return out


def serve_weights(cfg, seed: int = 0) -> dict:
    """The serving legs' weights: the tiny drawn from ``seed`` on the CPU,
    the same state dict in every process."""
    from ..models import llama

    model = llama.Llama(cfg, device="cpu")
    model.init_weights(seed)
    return model.state_dict()


def _serve(rank: int, axes: dict, model_kw: dict, warm: bool,
           device: str) -> dict:
    """One serving leg's gang member: rank 0 decides and returns its
    tokens, the others follow to its stop."""
    import torch.distributed as dist

    from ..serving import continuous, gang
    from ..utils.net import free_port

    _on_card(rank, device)
    cfg = tiny_for(device, **model_kw)
    kw = dict(SERVE_ENGINE, mesh_axes=axes, device=device, eos_id=None)
    port = [free_port() if rank == 0 else None]
    dist.broadcast_object_list(port, src=0)
    token = "dryrun"
    if rank:
        ch = gang.GangChannel.connect("127.0.0.1", port[0], rank=rank,
                                      token=token, timeout=120)
        try:
            gang.follow(continuous.ContinuousEngine(
                cfg, serve_weights(cfg), **kw), ch)
        finally:
            ch.close()
        return {"rank": rank}
    ch = gang.GangChannel.listen(port[0], dist.get_world_size() - 1,
                                 token=token, timeout=120)
    eng = gang.GangEngine(cfg, serve_weights(cfg), channel=ch, **kw)
    try:
        if warm:
            eng.warmup()
        tokens = eng.generate(SERVE_PROMPT, max_new_tokens=SERVE_NEW)
        return {"rank": 0, "tokens": tokens,
                "tp_degree": eng.tp_degree}
    finally:
        eng.stop()


def unsharded_tokens(model_kw: dict, device: str) -> list[int]:
    """One unsharded engine's greedy tokens of the serving legs' prompt on
    the same weights, in this process."""
    from ..serving import continuous

    cfg = tiny_for(device, **model_kw)
    eng = continuous.ContinuousEngine(cfg, serve_weights(cfg),
                                      device=device, eos_id=None,
                                      **SERVE_ENGINE)
    try:
        return eng.generate(SERVE_PROMPT, max_new_tokens=SERVE_NEW)
    finally:
        eng.stop()


def first_difference(model_kw: dict, device: str, got: list,
                     want: list) -> Optional[dict]:
    """Where ``got`` first differs from the unsharded stream ``want``: its
    position, the two tokens and the unsharded model's top-2 logit margin
    there relative to the top logit (None when they are equal)."""
    import torch

    from ..models import llama

    at = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
              None)
    if at is None:
        return None
    cfg = tiny_for(device, **model_kw)
    model = llama.Llama(cfg, device=device)
    model.load_state_dict(serve_weights(cfg))
    seq = torch.tensor([SERVE_PROMPT + want[:at]], device=device)
    with torch.no_grad():
        top = model(seq)[0, -1].float().topk(2).values
    return {"position": at, "tokens": [got[at], want[at]],
            "margin_rel": float((top[0] - top[1]) / top[0].abs())}


def dryrun_multichip(n: int, device: Optional[str] = None,
                     backend: Optional[str] = None,
                     timeout: float = 300.0) -> dict:
    """The dry run's legs on ``n`` ranks (``_layouts``, ``_serve_legs``);
    returns ``{"n", "device", "backend", "legs": {name: entry}}``, one
    entry a leg in the reference's order: a training leg's mesh, loss and
    ranks (every rank's loss equal and finite, or this raises), a serving
    leg's mesh and tokens (equal to one unsharded engine's, on the card
    or first apart at a near tie, ``NEAR_TIE``; or this raises).
    ``device=None`` means the card (``device.resolve_device``)."""
    from ..device import resolve_device

    device = resolve_device(device).type
    layouts = _layouts(n)
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    ranks = spawn(n, _one_step, layouts, device, backend=backend,
                  timeout=timeout)
    legs: dict = {}
    for i, (name, axes, model_kw, train_kw) in enumerate(layouts):
        mine = [r[i] for r in ranks]
        losses = [r["loss"] for r in mine]
        if not all(map(math.isfinite, losses)) or len(set(losses)) != 1:
            raise RuntimeError(f"{name} {axes}: ranks disagree or diverged: "
                               f"{losses}")
        legs[name] = {"leg": len(legs) + 1, "mesh": axes, "model": model_kw,
                      "train": train_kw, "loss": losses[0],
                      "grad_norm": mine[0]["grad_norm"], "ranks": mine}
    for name, axes, model_kw, warm in _serve_legs(n):
        lead = spawn(math.prod(axes.values()), _serve, axes, model_kw, warm,
                     device, backend=backend, timeout=timeout)[0]
        want = unsharded_tokens(model_kw, device)
        diff = first_difference(model_kw, device, lead["tokens"], want)
        if diff is not None and (device != "cuda"
                                 or diff["margin_rel"] >= NEAR_TIE):
            raise RuntimeError(f"{name} {axes}: the gang's tokens "
                               f"{lead['tokens']} differ from one engine's "
                               f"{want}: {diff}")
        legs[name] = {"leg": len(legs) + 1, "mesh": axes, "model": model_kw,
                      "tokens": lead["tokens"], "unsharded_tokens": want,
                      "first_difference": diff,
                      "tp_degree": lead["tp_degree"]}
    return {"n": n, "device": device, "backend": backend, "legs": legs}


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
