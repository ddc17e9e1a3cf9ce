"""The port's dry run (``kubeflow_tpu_torch/parallel/dryrun.py``) at eight
ranks on the CPU: ``dryrun_multichip(8, device="cpu")`` once, every one of
the reference's seven legs (``__graft_entry__.dryrun_multichip``):

- the training legs (ring attention on ``axes_for(8)``, GPipe and 1F1B on
  ``{"pipeline": 2, "data": 4}``, the ragged MoE on ``{"expert": 2,
  "data": 4}``, the MoE's balancing loss through 1F1B on ``{"pipeline":
  2, "expert": 2, "data": 2}``): every rank's loss equal and finite; the
  last one's loss against the reference ``Trainer``'s on the same weights
  (the port's init carried over by ``models/convert.py``) and the same
  mesh of eight virtual devices, at rtol 1e-4;
- the serving legs (``{"model": 2}`` after a warmup, the MoE on
  ``{"expert": 2, "model": 2}``): the gang's greedy tokens equal to one
  unsharded engine's on the same weights.

torch and the port are imported inside the tests (the spawned ranks import
only them).
"""

import math

import jax
import numpy as np
import pytest

from kubeflow_tpu.models import llama as ref_llama
from kubeflow_tpu.train import data as ref_data
from kubeflow_tpu.train import trainer as ref_train

N = 8
LEGS = ["mesh", "gpipe", "1f1b", "expert", "expert_1f1b", "tp_serve",
        "moe_serve"]


@pytest.fixture(scope="module")
def run():
    import torch

    from kubeflow_tpu_torch.parallel import dryrun

    torch.set_num_threads(1)
    return dryrun.dryrun_multichip(N, device="cpu", timeout=240)


def test_every_leg_runs_in_the_reference_order(run):
    assert list(run["legs"]) == LEGS
    assert [leg["leg"] for leg in run["legs"].values()] == list(
        range(1, len(LEGS) + 1))
    assert run["backend"] == "gloo" and run["device"] == "cpu"


@pytest.mark.parametrize("name", LEGS[:5])
def test_training_leg_losses_are_equal_and_finite(run, name):
    leg = run["legs"][name]
    assert math.prod(leg["mesh"].values()) == N
    assert len(leg["ranks"]) == N
    losses = {r["loss"] for r in leg["ranks"]}
    assert losses == {leg["loss"]} and math.isfinite(leg["loss"])


@pytest.mark.parametrize("name", LEGS[5:])
def test_serving_leg_tokens_equal_one_engine(run, name):
    leg = run["legs"][name]
    assert leg["tokens"] == leg["unsharded_tokens"]
    assert leg["first_difference"] is None
    assert len(leg["tokens"]) == 4
    assert leg["tp_degree"] == leg["mesh"]["model"]


def test_expert_pipeline_leg_matches_reference(run):
    """Leg 5 (the MoE's balancing loss through 1F1B over ``pipeline`` x
    ``expert`` x ``data``) against the reference on the same weights."""
    from kubeflow_tpu_torch.models import convert
    from kubeflow_tpu_torch.parallel import dryrun
    from kubeflow_tpu_torch.train.trainer import Trainer

    leg = run["legs"]["expert_1f1b"]
    plain = Trainer(dryrun.train_config("cpu", {}, leg["model"], {}),
                    device="cpu")
    plain.init_state(0)
    init = convert.tree_from_state_dict(plain.full_state_dict(),
                                        plain.cfg.model)
    cfg = ref_train.TrainConfig(
        model=ref_llama.tiny(**leg["model"]), mesh_axes=leg["mesh"],
        global_batch=dryrun.global_batch(leg["mesh"], leg["train"]),
        seq_len=32, steps=1, log_every=1, **leg["train"])
    t = ref_train.Trainer(cfg, devices=jax.devices()[:N])
    state = t.init_state(0)
    shardings = jax.tree.map(lambda a: a.sharding,
                             t.abstract_state()["params"])
    state = {**state, "params": jax.device_put(
        jax.tree.map(np.asarray, init), shardings)}
    source = ref_data.SyntheticLm(cfg.global_batch, cfg.seq_len,
                                  cfg.model.vocab_size)
    batch = next(iter(ref_data.device_batches(source, t.batch_sharding, 1)))
    _, out = t.compiled_step()(state, batch)
    np.testing.assert_allclose(leg["loss"], float(out["loss"]), rtol=1e-4)
