"""What each rank runs for ``tests/test_torch_distributed.py``.

A module of its own (no jax, no test collection) so that the processes
``parallel.dryrun.spawn`` starts import only torch and the port. ``run``
executes every case on one rank and returns its results; the test file
holds them against the reference and against one unsharded process.
"""

from __future__ import annotations

import numpy as np

#: the dense loss-curve cases: name -> mesh
DENSE_MESHES = {"fsdp_model": {"fsdp": 2, "model": 2},
                "data_fsdp": {"data": 2, "fsdp": 2}}
#: the expert-parallel cases: name -> mesh
MOE_MESHES = {"expert_data": {"expert": 2, "data": 2},
              "expert_model": {"expert": 2, "model": 2}}
STEPS, BATCH, SEQ = 5, 4, 32
MOE = dict(moe_experts=4, moe_top_k=2, moe_dispatch="ragged")
#: the capacity dispatch, its capacity low enough that tokens drop
CAPACITY = dict(moe_experts=4, moe_top_k=2, moe_dispatch="dense",
                moe_capacity_factor=0.5)
CAPACITY_MESH = {"expert": 2, "data": 2}
#: the LoRA and Adafactor cases' mesh; Adafactor's width factors every
#: projection (optax's min_dim_size_to_factor is 128), wq/wk/wv and
#: w_down with their second factored dim after the first, not split
LORA_MESH = ADAFACTOR_MESH = {"fsdp": 2, "model": 2}
LORA = dict(lora_rank=4, lora_targets=("wq", "wv", "wo", "w_down"))
WIDE = dict(hidden_size=256, intermediate_size=512, head_dim=128)


def _setup():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    return torch


def train_config(mesh: dict, steps: int = STEPS, train_kw=None,
                 **model_kw):
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(
        model=llama.tiny(attention_impl="flash", **model_kw), mesh_axes=mesh,
        global_batch=BATCH, seq_len=SEQ, steps=steps, warmup_steps=2,
        log_every=1, mu_dtype=None, aux_loss_coef=0.01, **(train_kw or {}))


def _loss_curve(mesh: dict, init: dict, train_kw=None,
                **model_kw) -> dict:
    """5 steps on ``mesh`` from the reference's initial params: losses and
    global grad norms (Adafactor: also the params after them, whole)."""
    from kubeflow_tpu_torch.train.trainer import Trainer

    t = Trainer(train_config(mesh, train_kw=train_kw, **model_kw),
                device="cpu")
    t.load_params(init)
    src = t.data_source()
    losses, norms = [], []
    for step in range(STEPS):
        loss, norm = t.step(src.local_batch(step)["tokens"])
        losses.append(float(loss))
        norms.append(float(norm))
    out = {"losses": losses, "norms": norms,
           "shard": [t.batch_index, t.batch_count]}
    if t.cfg.optimizer == "adafactor":
        out["factored"] = sum(v is not None for v in t.opt.v_row)
        out["params"] = {k: v.numpy()
                         for k, v in t.full_state_dict().items()}
    return out


def _lora(mesh: dict, snapshot: str, ckpt_dir: str) -> dict:
    """LoRA from the ``snapshot`` base on ``mesh``: 5 steps' losses and
    norms, the first step's synced adapter gradients, whole, and the loss
    of the next batch after the last step's adapters-only checkpoint."""
    torch = _setup()
    from kubeflow_tpu_torch.train.trainer import Trainer

    t = Trainer(train_config(mesh, train_kw={"init_from": snapshot,
                                             "checkpoint_dir": ckpt_dir},
                             **LORA), device="cpu")
    t.init_state(0)
    src = t.data_source()
    losses, norms, grads = [], [], {}
    for step in range(STEPS):
        # Trainer.step, its synced gradients read in between
        loss = t.loss_and_grads(src.local_batch(step)["tokens"])
        t.layout.sync_grads(t.opt.params)
        if step == 0:
            names = {id(p): k for k, p in t.model.named_parameters()}
            grads = {names[id(p)]: t.layout.gather_full(
                names[id(p)], p.grad).numpy() for p in t.opt.params}
        losses.append(float(t.global_mean(loss)))
        norms.append(float(t.opt.step()))
        t.model.zero_grad(set_to_none=True)
    t._save(STEPS, force=True)
    t.ckpt.wait_until_finished()
    with torch.no_grad():
        tokens = torch.as_tensor(src.local_batch(STEPS)["tokens"])
        next_loss = float(t.global_mean(t._loss(tokens)))
    return {"losses": losses, "norms": norms, "grads": grads,
            "next_loss": next_loss}


def _moe(mesh: dict, init: dict, model_kw=MOE) -> dict:
    """The MoE tiny on ``mesh``: this rank's logits of the global tokens,
    and the loss and full synced gradients of one step's batch."""
    torch = _setup()
    from kubeflow_tpu_torch.models import moe as moelib
    from kubeflow_tpu_torch.train.trainer import Trainer

    t = Trainer(train_config(mesh, **model_kw), device="cpu")
    t.load_params(init)
    tokens = torch.as_tensor(t.data_source().local_batch(0)["tokens"])
    with torch.no_grad():
        logits = t.model(tokens[:, :-1]).numpy()
    moelib.HOST_COPIES["moe_ep_counts"] = 0
    loss = t.loss_and_grads(tokens)
    copies = moelib.HOST_COPIES["moe_ep_counts"]
    t.layout.sync_grads(t.opt.params)
    grads = {k: t.layout.gather_full(k, p.grad).numpy()
             for k, p in t.model.named_parameters()}
    return {"logits": logits, "loss": float(t.global_mean(loss)),
            "grads": grads, "shard": [t.batch_index, t.batch_count],
            "host_copies": copies}


def _checkpoint(ckpt_dir: str, optimizer: str = "adamw") -> dict:
    """Train 2 steps on one mesh with checkpoints, restore onto another,
    then one more step on each (Adafactor at a width that factors)."""
    import dataclasses

    from kubeflow_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(
        train_config(DENSE_MESHES["fsdp_model"], steps=2,
                     train_kw={"optimizer": optimizer},
                     **(WIDE if optimizer == "adafactor" else {})),
        checkpoint_dir=ckpt_dir)
    a = Trainer(cfg, device="cpu")
    a.train()
    saved = a.full_state_dict()
    b = Trainer(dataclasses.replace(cfg, mesh_axes={"data": 2, "model": 2}),
                device="cpu")
    b.restore_or_init()
    restored = b.full_state_dict()
    same = all(np.array_equal(saved[k].numpy(), restored[k].numpy())
               for k in saved)
    opt_a, opt_b = a._opt_state_full(), b._opt_state_full()
    moments = [w for w in ("mu", "nu", "v_row", "v_col", "v") if w in opt_a]
    same_opt = all(
        len(opt_a[w]) == len(opt_b[w]) and all(
            (x is None and y is None) or np.array_equal(x.numpy(), y.numpy())
            for x, y in zip(opt_a[w], opt_b[w])) for w in moments)
    batch = a.data_source().local_batch(2)["tokens"]
    la = float(a.step(batch)[0])
    lb = float(b.step(b.data_source().local_batch(2)["tokens"])[0])
    return {"params_equal": same, "opt_equal": same_opt,
            "count": [a.opt.count, b.opt.count], "next_loss": [la, lb],
            "steps_on_disk": sorted(a.ckpt.all_steps()), "moments": moments,
            "factored": sum(v is not None for v in opt_a.get("v_row", []))}


def _batches() -> dict:
    """This rank's rows of step 3's global batch on three meshes."""
    from kubeflow_tpu_torch.parallel import mesh as meshlib
    from kubeflow_tpu_torch.train.data import SyntheticLm

    out = {}
    for name, axes in (("fsdp_model", {"fsdp": 2, "model": 2}),
                       ("data", {"data": 4}),
                       ("expert_data", MOE_MESHES["expert_data"])):
        mesh = meshlib.build_mesh(axes, device_type="cpu")
        index, count = meshlib.batch_sharding(mesh)
        rows = SyntheticLm(8, SEQ, 256, process_index=index,
                           process_count=count).local_batch(3)["tokens"]
        out[name] = (index, count, meshlib.local_batch_size(mesh, 8), rows)
    return out


def ragged_operands(world: int, seed: int = 0) -> dict:
    """Every rank's operands of one ``ragged_all_to_all``: chunks laid out
    with gaps and out of order on both sides."""
    rng = np.random.default_rng(seed)
    rows_in, rows_out, width = 16, 20, 3
    sizes = rng.integers(0, 4, size=(world, world))      # [src, dst]
    in_offs = np.zeros((world, world), np.int64)
    out_offs = np.zeros((world, world), np.int64)
    for i in range(world):
        pos = 0
        for d in rng.permutation(world):
            pos += int(rng.integers(0, 2))
            in_offs[i, d] = pos
            pos += sizes[i, d]
    for d in range(world):
        pos = 0
        for i in rng.permutation(world):
            pos += int(rng.integers(0, 2))
            out_offs[i, d] = pos
            pos += sizes[i, d]
    return {
        "operand": rng.standard_normal((world, rows_in, width)).astype(
            np.float32),
        "output": rng.standard_normal((world, rows_out, width)).astype(
            np.float32),
        "cotangent": rng.standard_normal((world, rows_out, width)).astype(
            np.float32),
        "input_offsets": in_offs, "send_sizes": sizes,
        "output_offsets": out_offs, "recv_sizes": sizes.T.copy(),
    }


def _ragged(rank: int, world: int) -> dict:
    """This rank's ``ragged_all_to_all`` output and the gradients of
    sum(out * cotangent) for its operand and output."""
    torch = _setup()
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.collectives import ragged_all_to_all

    ops = ragged_operands(world)
    x = torch.tensor(ops["operand"][rank], requires_grad=True)
    buf = torch.tensor(ops["output"][rank], requires_grad=True)
    out = ragged_all_to_all(
        x, buf, ops["input_offsets"][rank], ops["send_sizes"][rank],
        ops["output_offsets"][rank], ops["recv_sizes"][rank],
        group=dist.group.WORLD)
    (out * torch.tensor(ops["cotangent"][rank])).sum().backward()
    return {"out": out.detach().numpy(), "d_operand": x.grad.numpy(),
            "d_output": buf.grad.numpy()}


def run(rank: int, inits: dict, ckpt_dir: str, snapshot: str) -> dict:
    _setup()
    import os

    import torch.distributed as dist

    out = {"ragged": _ragged(rank, dist.get_world_size()),
           "batches": _batches()}
    for name, mesh in DENSE_MESHES.items():
        out[name] = _loss_curve(mesh, inits["dense"])
    for name, mesh in MOE_MESHES.items():
        out[name] = _moe(mesh, inits["moe"])
    out["capacity"] = _moe(CAPACITY_MESH, inits["moe"], CAPACITY)
    out["lora_ckpt"] = os.path.join(ckpt_dir, "lora")
    out["lora"] = _lora(LORA_MESH, snapshot, out["lora_ckpt"])
    out["adafactor"] = _loss_curve(ADAFACTOR_MESH, inits["wide"],
                                   {"optimizer": "adafactor"}, **WIDE)
    out["checkpoint"] = _checkpoint(os.path.join(ckpt_dir, "adamw"))
    out["checkpoint_adafactor"] = _checkpoint(
        os.path.join(ckpt_dir, "adafactor"), "adafactor")
    return out
