"""The port's ResNet and MNIST models (``kubeflow_tpu_torch/models/
{resnet,mnist}.py``) against the reference's, on the same converted weights
and numpy inputs (CPU, f32).

- ResNet ``tiny()`` with basic blocks and a bottleneck tiny config, at image
  sizes 32 and 33, and with bf16 parameters (``param_dtype``: the
  convolutions and head bf16, the GroupNorms f32 in both packages):
  logits within 1e-4 relative. The two sizes take both of
  flax's "SAME" splits (a 7x7/2 stem pads (2, 3) on 32 and (3, 3) on 33; a
  3x3/2 pads (0, 1) on 16, none extra on 17).
- Two steps of SGD with momentum 0.9 (the second uses the trace): losses
  and params against optax's within 1e-5 relative; the same for the MNIST
  ``MLP``.
- Each ``train_main`` runs in-process on the CPU (``KFT_POD_DEVICE=cpu``)
  and emits finite metrics; a context of two processes with no coordinator
  is refused (``tests/test_torch_launcher.py`` runs two).

torch and the port are imported inside the tests.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import linen as nn

from kubeflow_tpu.models import mnist as ref_mnist
from kubeflow_tpu.models import resnet as ref_resnet

CASES = {f"{kind}-{size}": (kind == "bottleneck", size)
         for kind in ("basic", "bottleneck") for size in (32, 33)}
CASES["bottleneck-32-bf16-params"] = (True, 32, "bfloat16")


def _port():
    import torch

    from kubeflow_tpu_torch.models import convert, mnist, resnet
    from kubeflow_tpu_torch.runtime import bootstrap

    torch.set_num_threads(1)
    return torch, convert, mnist, resnet, bootstrap


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _numpy(params):
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def _resnet_pair(bottleneck: bool, size: int, param_dtype="float32"):
    torch, convert, _, resnet, _ = _port()
    rcfg = ref_resnet.tiny(bottleneck=bottleneck, num_classes=10,
                           param_dtype=getattr(jnp, param_dtype))
    x = np.random.default_rng(1).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    model = ref_resnet.ResNet(rcfg)
    params = _numpy(model.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    cfg = resnet.tiny(bottleneck=bottleneck, num_classes=10,
                      param_dtype=getattr(torch, param_dtype))
    port = resnet.ResNet(cfg, device="cpu")
    sd = convert.resnet_from_reference(params, cfg)
    # each leaf in the reference's dtype: the GroupNorms f32 in both
    want = {"/".join(k.key for k in path): np.asarray(v).dtype.name
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    got = {k: str(v.dtype).removeprefix("torch.") for k, v in sd.items()}
    assert sorted(got.values()) == sorted(want.values())
    assert {got[k] for k in got if "norm" in k} == {"float32"}
    port.load_state_dict(sd)
    assert {k: v.dtype for k, v in port.state_dict().items()} == {
        k: v.dtype for k, v in sd.items()}
    return model, params, port, x


def test_same_padding_splits():
    _, _, _, resnet, _ = _port()
    assert resnet.same_pads(32, 7, 2) == (2, 3)
    assert resnet.same_pads(33, 7, 2) == (3, 3)
    assert resnet.same_pads(16, 3, 2) == (0, 1)
    assert resnet.same_pads(17, 3, 2) == (1, 1)
    assert resnet.same_pads(16, 1, 2) == (0, 0)


@pytest.mark.parametrize("case", list(CASES))
def test_resnet_logits_match_reference(case):
    torch, *_ = _port()
    model, params, port, x = _resnet_pair(*CASES[case])
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, want) <= 1e-4


def _optax_steps(apply, params, x, y, lr, steps):
    tx = optax.sgd(lr, momentum=0.9)
    opt = tx.init(params)
    losses = []
    for _ in range(steps):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                apply(p, x), y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, _numpy(params)


def _torch_steps(model, x, y, lr, steps):
    torch, *_ = _port()
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    losses = []
    for _ in range(steps):
        loss = torch.nn.functional.cross_entropy(
            model(torch.from_numpy(x)), torch.from_numpy(y).long())
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
    return losses


def test_resnet_sgd_momentum_steps_match_optax():
    _, convert, *_ = _port()
    model, params, port, x = _resnet_pair(False, 32)
    y = np.array([3, 7], np.int32)
    want_l, want_p = _optax_steps(model.apply, params, jnp.asarray(x),
                                  jnp.asarray(y), 0.1, 2)
    got_l = _torch_steps(port, x, y, 0.1, 2)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    want = convert.resnet_from_reference(want_p, port.cfg)
    for key, p in port.state_dict().items():
        assert _rel(p, want[key].numpy()) <= 1e-5, key


def test_mlp_matches_reference_and_steps_like_optax():
    torch, convert, mnist, *_ = _port()
    x = np.random.default_rng(2).standard_normal((16, 64)).astype(np.float32)
    y = np.random.default_rng(3).integers(0, 10, 16).astype(np.int32)
    model = ref_mnist.MLP()
    params = _numpy(model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = mnist.MLP(device="cpu")
    port.load_state_dict(convert.mnist_from_reference(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert _rel(got, np.asarray(model.apply(params, jnp.asarray(x)))) <= 1e-5
    want_l, want_p = _optax_steps(model.apply, params, jnp.asarray(x),
                                  jnp.asarray(y), 0.05, 2)
    got_l = _torch_steps(port, x, y, 0.05, 2)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    want = convert.mnist_from_reference(want_p)
    for key, p in port.state_dict().items():
        assert _rel(p, want[key].numpy()) <= 1e-5, key


def _metrics(status_dir):
    with open(os.path.join(status_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("model", ["mnist", "resnet"])
def test_train_main_in_process_on_cpu(model, tmp_path, monkeypatch,
                                      capsys):
    _, _, mnist, resnet, bootstrap = _port()
    for k, v in {"KFT_POD_DEVICE": "cpu", "KFT_STEPS": "2",
                 "KFT_BATCH": "4", "KFT_RESNET": "tiny",
                 "KFT_STATUS_DIR": str(tmp_path)}.items():
        monkeypatch.setenv(k, v)
    ctx = bootstrap.PodContext.from_env()
    mod = {"mnist": mnist, "resnet": resnet}[model]
    trained = mod.train_main(ctx)
    assert next(trained.parameters()).device.type == "cpu"
    rows = _metrics(str(tmp_path))
    names = [r["name"] for r in rows]
    want = ["loss", "accuracy"] if model == "mnist" else ["loss", "loss"]
    assert names == want
    assert all(np.isfinite(r["value"]) for r in rows)
    assert "on cpu" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="coordinator address"):
        mod.train_main(bootstrap.PodContext(num_processes=2), device="cpu")
