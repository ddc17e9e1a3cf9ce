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


def _setup():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    return torch


def train_config(mesh: dict, steps: int = STEPS, **model_kw):
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(
        model=llama.tiny(attention_impl="flash", **model_kw), mesh_axes=mesh,
        global_batch=BATCH, seq_len=SEQ, steps=steps, warmup_steps=2,
        log_every=1, mu_dtype=None, aux_loss_coef=0.01)


def _loss_curve(mesh: dict, init: dict) -> dict:
    """5 steps on ``mesh`` from the reference's initial params: losses and
    global grad norms."""
    from kubeflow_tpu_torch.train.trainer import Trainer

    t = Trainer(train_config(mesh), device="cpu")
    t.load_params(init)
    src = t.data_source()
    losses, norms = [], []
    for step in range(STEPS):
        loss, norm = t.step(src.local_batch(step)["tokens"])
        losses.append(float(loss))
        norms.append(float(norm))
    return {"losses": losses, "norms": norms,
            "shard": [t.batch_index, t.batch_count]}


def _moe(mesh: dict, init: dict) -> dict:
    """The MoE tiny on ``mesh``: this rank's logits of the global tokens,
    and the loss and full synced gradients of one step's batch."""
    torch = _setup()
    from kubeflow_tpu_torch.models import moe as moelib
    from kubeflow_tpu_torch.train.trainer import Trainer

    t = Trainer(train_config(mesh, **MOE), device="cpu")
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


def _checkpoint(ckpt_dir: str) -> dict:
    """Train 2 steps on one mesh with checkpoints, restore onto another,
    then one more step on each."""
    import dataclasses

    from kubeflow_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(train_config(DENSE_MESHES["fsdp_model"],
                                           steps=2),
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
    same_opt = all(np.array_equal(x.numpy(), y.numpy())
                   for what in ("mu", "nu")
                   for x, y in zip(opt_a[what], opt_b[what]))
    batch = a.data_source().local_batch(2)["tokens"]
    la = float(a.step(batch)[0])
    lb = float(b.step(b.data_source().local_batch(2)["tokens"])[0])
    return {"params_equal": same, "opt_equal": same_opt,
            "count": [a.opt.count, b.opt.count], "next_loss": [la, lb],
            "steps_on_disk": sorted(a.ckpt.all_steps())}


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


def run(rank: int, dense_init: dict, moe_init: dict, ckpt_dir: str) -> dict:
    _setup()
    import torch.distributed as dist

    out = {"ragged": _ragged(rank, dist.get_world_size()),
           "batches": _batches()}
    for name, mesh in DENSE_MESHES.items():
        out[name] = _loss_curve(mesh, dense_init)
    for name, mesh in MOE_MESHES.items():
        out[name] = _moe(mesh, moe_init)
    out["checkpoint"] = _checkpoint(ckpt_dir)
    return out
