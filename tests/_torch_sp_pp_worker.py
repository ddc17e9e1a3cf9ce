"""What each rank runs for ``tests/test_torch_ring_attention.py`` and
``tests/test_torch_pipeline.py``: sequence and pipeline parallelism.

A module of its own (no jax, no test collection) so that the processes
``parallel.dryrun.spawn`` starts import only torch and the port. ``run_ring``
and ``run_pipeline`` execute every case of their file on one rank and return
its results; the test files hold them against the reference.
"""

from __future__ import annotations

import numpy as np

#: ring_attention / ulysses_attention cases: name -> mesh
RING_MESHES = {"seq4": {"seq": 4}, "data_seq": {"data": 2, "seq": 2},
               "seq_model": {"seq": 2, "model": 2}}
#: the attention operands: b, s, h, kv, d (the reference test's shapes)
ATTN = dict(b=2, s=64, h=8, kv=4, d=16)

#: the pipeline executors against a sequential stack: (schedule, stages,
#: microbatches, chunks a stage)
EXEC_CASES = [("gpipe", 2, 2, 1), ("gpipe", 2, 4, 1), ("gpipe", 4, 4, 1),
              ("gpipe", 4, 8, 1), ("1f1b", 2, 2, 1), ("1f1b", 2, 4, 1),
              ("1f1b", 4, 4, 1), ("1f1b", 4, 8, 1), ("1f1b", 2, 4, 2)]
EXEC = dict(layers=8, width=16, batch=8, out=4)

STEPS, BATCH, SEQ = 3, 8, 32
MOE = dict(moe_experts=4, moe_top_k=2, moe_dispatch="ragged")
#: the MoE cases' router weights, scaled up from the init (the test's
#: ``_sharp_router``)
ROUTER_SCALE = 50.0
#: the trainer's loss-curve cases: name -> (mesh, num_slices, TrainConfig
#: fields, model fields)
PIPE = {"pipeline": 2, "data": 2}
PIPE_FSDP = {"pipeline": 2, "fsdp": 2}
TRAIN_CASES = {
    "gpipe": (PIPE, 1, {}, {}),
    "1f1b": (PIPE, 1, {"pipeline_schedule": "1f1b",
                       "num_microbatches": 4}, {}),
    "1f1b_interleave": (PIPE, 1, {"pipeline_schedule": "1f1b",
                                  "num_microbatches": 4,
                                  "pipeline_interleave": 2}, {}),
    "accum_1f1b": (PIPE, 1, {"pipeline_schedule": "1f1b",
                             "num_microbatches": 2, "accum_steps": 2}, {}),
    "tied_1f1b": (PIPE, 1, {"pipeline_schedule": "1f1b",
                            "num_microbatches": 4},
                  {"tie_embeddings": True}),
    # the balancing loss is not linear in the rows: a microbatch must hold
    # the reference's rows of the global batch, spread over the data ranks
    "moe_gpipe": (PIPE, 1, {"num_microbatches": 4}, MOE),
    "moe_1f1b": (PIPE, 1, {"pipeline_schedule": "1f1b",
                           "num_microbatches": 4}, MOE),
    "seq_fsdp": ({"seq": 2, "fsdp": 2}, 1, {}, {"attention_impl": "ring"}),
    # FSDP2 inside each stage: the stage gathered whole for a step, its
    # gradients averaged over fsdp once, after the last microbatch
    "gpipe_fsdp": (PIPE_FSDP, 1, {}, {}),
    "1f1b_fsdp": (PIPE_FSDP, 1, {"pipeline_schedule": "1f1b",
                                 "num_microbatches": 4},
                  {"tie_embeddings": True}),
    "pipeline_seq_dcn": ({"pipeline": 2, "seq": 2}, 2,
                         {"pipeline_schedule": "1f1b"},
                         {"attention_impl": "ring"}),
}
#: the cases whose params after the steps are held to the reference's too:
#: the gradient shards FSDP2 takes from the gathered stage
PARAM_CASES = ("gpipe_fsdp", "1f1b_fsdp")


def _setup():
    import torch

    torch.set_num_threads(1)
    return torch


def attention_operands(seed: int = 0) -> dict:
    """q, k, v and the output cotangent as numpy f32."""
    rng = np.random.default_rng(seed)
    b, s, h, kv, d = (ATTN[k] for k in ("b", "s", "h", "kv", "d"))
    return {n: rng.standard_normal(shape).astype(np.float32) for n, shape in
            (("q", (b, s, h, d)), ("k", (b, s, kv, d)), ("v", (b, s, kv, d)),
             ("g", (b, s, h, d)))}


def _attention(mesh, fn, block_impl: str) -> dict:
    """This rank's output block and its q/k/v gradients of
    sum(out * g)."""
    torch = _setup()
    from kubeflow_tpu_torch.parallel import mesh as meshlib

    ops = attention_operands()
    cut = meshlib.seq_slice(mesh, ATTN["s"])
    q, k, v = (torch.tensor(ops[n][:, cut]).requires_grad_()
               for n in "qkv")
    out = fn(q, k, v, q_per_kv=ATTN["h"] // ATTN["kv"], mesh=mesh,
             block_impl=block_impl)
    (out * torch.tensor(ops["g"][:, cut])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy(),
            "cut": [cut.start, cut.stop]}


def _ring_model_logits(init: dict, mesh_axes: dict) -> dict:
    """The tiny model with ``attention_impl="ring"`` laid out on
    ``mesh_axes``: this rank's logits (its rows and sequence block)."""
    torch = _setup()
    from kubeflow_tpu_torch.parallel import mesh as meshlib
    from kubeflow_tpu_torch.train.trainer import Trainer

    t = Trainer(train_config(mesh_axes, attention_impl="ring"), device="cpu")
    t.load_params(init)
    tokens = torch.as_tensor(t.data_source().local_batch(0)["tokens"])
    inputs = tokens[:, :-1][:, meshlib.seq_slice(t.mesh, SEQ)]
    with torch.no_grad():
        logits = t.model(inputs).numpy()
    return {"logits": logits, "shard": [t.batch_index, t.batch_count],
            "seq": [meshlib.axis_index(t.mesh, "seq"),
                    meshlib.axis_size(t.mesh, "seq")]}


def permute_operands(world: int, seed: int = 1) -> dict:
    """Every rank's buffer and cotangent of one ``ring_permute``."""
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((world, 3, 5)).astype(np.float32)
            for n in ("x", "g")}


def _permutes(rank: int) -> dict:
    """``ring_permute`` on a ring (+1, -1) and on an open chain (+1): this
    rank's output and the gradient of sum(out * g) for its buffer."""
    torch = _setup()
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.collectives import ring_permute

    ops = permute_operands(dist.get_world_size())
    out = {}
    for shift, wrap in ((1, True), (-1, True), (1, False)):
        x = torch.tensor(ops["x"][rank]).requires_grad_()
        y = ring_permute(x, dist.group.WORLD, shift, wrap)
        (y * torch.tensor(ops["g"][rank])).sum().backward()
        out[(shift, wrap)] = (y.detach().numpy(), x.grad.numpy())
    return out


def run_ring(rank: int, init: dict) -> dict:
    _setup()
    from kubeflow_tpu_torch.parallel import mesh as meshlib
    from kubeflow_tpu_torch.parallel.ring_attention import (
        ring_attention,
        ulysses_attention,
    )

    out: dict = {"permute": _permutes(rank)}
    for name, axes in RING_MESHES.items():
        mesh = meshlib.build_mesh(axes, device_type="cpu")
        for impl in ("einsum", "flash"):
            out[(name, "ring", impl)] = _attention(mesh, ring_attention, impl)
        out[(name, "ulysses", "flash")] = _attention(mesh, ulysses_attention,
                                                     "flash")
    # kv = 4 heads over a seq axis of 4 divide, 4 over 8 would not: the
    # refusal needs more ranks than heads, so take h = kv = 2 on seq 4
    mesh = meshlib.build_mesh({"seq": 4}, device_type="cpu")
    torch = _setup()
    q = torch.zeros(1, 4, 2, 8)
    try:
        ulysses_attention(q, q, q, mesh=mesh)
        out["ulysses_refusal"] = None
    except ValueError as e:
        out["ulysses_refusal"] = str(e)
    for name, axes in (("seq4", {"seq": 4}),
                       ("seq_model", {"seq": 2, "model": 2})):
        out[("model", name)] = _ring_model_logits(init, axes)
    return out


# -- pipeline ----------------------------------------------------------------


def exec_problem(seed: int = 0) -> dict:
    """The reference test's problem: tanh(h @ w) blocks and a squared-error
    head, as numpy f32."""
    rng = np.random.default_rng(seed)
    L, w, b, o = (EXEC[k] for k in ("layers", "width", "batch", "out"))
    return {"ws": (rng.standard_normal((L, w, w)) * 0.1).astype(np.float32),
            "head": (rng.standard_normal((w, o)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((b, w)).astype(np.float32),
            "tgt": rng.standard_normal((b, o)).astype(np.float32)}


def _toy_modules(prob: dict, layers):
    torch = _setup()
    from torch import nn

    class Lin(nn.Module):
        def __init__(self, w):
            super().__init__()
            self.w = nn.Parameter(torch.tensor(w))

    return [Lin(prob["ws"][i]) for i in layers], Lin(prob["head"])


def toy_block(blk, h):
    import torch

    return torch.tanh(h @ blk.w)


def _executor(schedule: str, p: int, m: int, v: int) -> dict:
    """This rank's stage of the problem through ``gpipe`` (its loss after
    the head, backward) or ``one_f_one_b``: the loss, its stage's layer
    gradients by global index, the head's and the input's gradients."""
    torch = _setup()
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import mesh as meshlib
    from kubeflow_tpu_torch.parallel import pipeline as pipelib

    prob = exec_problem()
    mesh = meshlib.build_mesh({"pipeline": p,
                               "data": dist.get_world_size() // p},
                              device_type="cpu")
    d = meshlib.axis_index(mesh, "pipeline")
    per = EXEC["layers"] // p
    stage = [int(i) for i in pipelib.interleave_permutation(
        EXEC["layers"], p, v)[d * per:(d + 1) * per]]
    blocks, head = _toy_modules(prob, stage)
    x = torch.tensor(prob["x"]).requires_grad_()
    tgt = torch.tensor(prob["tgt"])

    def loss_fn(y, t):
        return ((y @ head.w - t) ** 2).mean()

    if schedule == "gpipe":
        y = pipelib.gpipe(toy_block, blocks, x, mesh=mesh,
                          num_microbatches=m, remat=d % 2 == 0)
        loss = loss_fn(y, tgt)
        loss.backward()
        dx = x.grad
    else:
        loss, dx = pipelib.one_f_one_b(
            toy_block, loss_fn, blocks, x, tgt, mesh=mesh,
            num_microbatches=m, remat=True, interleave=v)
    return {"loss": float(loss), "stage": stage, "last": d == p - 1,
            "first": d == 0,
            "layer_grads": {i: b.w.grad.numpy() for i, b in
                            zip(stage, blocks)},
            "head_grad": (None if head.w.grad is None
                          else head.w.grad.numpy()),
            "dx": dx.detach().numpy()}


def train_config(mesh: dict, steps: int = STEPS, num_slices: int = 1,
                 train_kw=None, **model_kw):
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.trainer import TrainConfig

    model_kw = {"attention_impl": "dense", "num_layers": 4, "remat": True,
                **model_kw}
    return TrainConfig(
        model=llama.tiny(**model_kw), mesh_axes=mesh, num_slices=num_slices,
        global_batch=BATCH, seq_len=SEQ, steps=steps, warmup_steps=2,
        log_every=1, mu_dtype=None, aux_loss_coef=0.01, **(train_kw or {}))


def _loss_curve(name: str, inits: dict) -> dict:
    from kubeflow_tpu_torch.train.trainer import Trainer

    mesh, slices, train_kw, model_kw = TRAIN_CASES[name]
    t = Trainer(train_config(mesh, num_slices=slices, train_kw=train_kw,
                             **model_kw), device="cpu")
    t.load_params(inits[init_key(model_kw)])
    src = t.data_source()
    losses, norms = [], []
    for step in range(STEPS):
        loss, norm = t.step(src.local_batch(step)["tokens"])
        losses.append(float(loss))
        norms.append(float(norm))
    out = {"losses": losses, "norms": norms, "stage": t.layout.stage}
    if name in PARAM_CASES:
        out["params"] = {k: v.numpy()
                         for k, v in t.full_state_dict().items()}
    return out


def init_key(model_kw: dict) -> str:
    """Which reference init a case's model starts from."""
    if model_kw.get("moe_experts"):
        return "moe"
    return "tied" if model_kw.get("tie_embeddings") else "dense"


def _checkpoint(ckpt_dir: str, init: dict, mesh: dict = PIPE) -> dict:
    """Train 2 steps on ``mesh`` (1F1B, 2 chunks a stage) with
    checkpoints, restore onto ``{"fsdp": 2, "model": 2}``, then one more
    step on each."""
    import dataclasses

    from kubeflow_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(
        train_config(mesh, steps=2, train_kw={
            "pipeline_schedule": "1f1b", "num_microbatches": 2,
            "pipeline_interleave": 2}),
        checkpoint_dir=ckpt_dir)
    a = Trainer(cfg, device="cpu")
    a.load_params(init)
    a.train()
    saved = a.full_state_dict()
    b = Trainer(dataclasses.replace(cfg, mesh_axes={"fsdp": 2, "model": 2}),
                device="cpu")
    b.restore_or_init()
    restored = b.full_state_dict()
    same = (list(saved) == list(restored)
            and all(np.array_equal(saved[k].numpy(), restored[k].numpy())
                    for k in saved))
    opt_a, opt_b = a._opt_state_full(), b._opt_state_full()
    same_opt = all(
        len(opt_a[w]) == len(opt_b[w]) and all(
            np.array_equal(x.numpy(), y.numpy())
            for x, y in zip(opt_a[w], opt_b[w])) for w in ("mu", "nu"))
    la = float(a.step(a.data_source().local_batch(2)["tokens"])[0])
    lb = float(b.step(b.data_source().local_batch(2)["tokens"])[0])
    return {"params_equal": same, "opt_equal": same_opt,
            "count": [a.opt.count, b.opt.count], "next_loss": [la, lb],
            "stage": a.layout.stage, "keys": list(saved)}


def run_pipeline(rank: int, inits: dict, ckpt_dir: str) -> dict:
    _setup()
    out: dict = {"exec": {c: _executor(*c) for c in EXEC_CASES}}
    for name in TRAIN_CASES:
        out[name] = _loss_curve(name, inits)
    out["checkpoint"] = _checkpoint(ckpt_dir, inits["dense"])
    out["checkpoint_fsdp"] = _checkpoint(f"{ckpt_dir}-fsdp", inits["dense"],
                                         PIPE_FSDP)
    return out
