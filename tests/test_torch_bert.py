"""The port's BERT (``kubeflow_tpu_torch/models/bert.py``) and its
``kft-bert`` runtime against the reference's, on ``tiny()`` (CPU, f32).

- The classifier's logits (atol 1e-5) and the gradients of a summed-logit
  loss (1e-4 of each leaf's largest) equal the reference's on the same
  converted weights and numpy ids, with a ragged padding mask (one row all
  padding), in both layer layouts (``layer_{i}`` and scan-stacked).
- A row with no key left attends uniformly and stays finite (the mask
  fills with ``finfo(float32).min``, as the reference's).
- A snapshot the reference's ``save_pretrained`` writes loads in the port
  and gives the same probabilities (atol 1e-5), and the port's snapshot
  loads in the reference.
- A ``kft-bert`` InferenceService on the port's ``Cluster`` answers V1
  ``:predict`` (``tests/test_models.py::TestBertServing``'s checks), with the
  reference's probabilities.

torch and the port are imported inside the tests.
"""

import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import bert as ref

LAYOUTS = {"unrolled": False, "scan": True}


def _port():
    import torch

    from kubeflow_tpu_torch.models import bert, convert

    torch.set_num_threads(1)
    return torch, bert, convert


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), bool)
    mask[1, 9:] = False
    mask[2, 3:] = False
    mask[3, :] = False  # a padding row: no key at all
    return ids, mask


def _ref_params(cfg, seed=1):
    params = ref.BertClassifier(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def _port_model(cfg_kw, params):
    torch, bert, convert = _port()
    cfg = bert.tiny(**cfg_kw)
    model = bert.BertClassifier(cfg, device="cpu")
    model.load_state_dict(convert.bert_from_reference(params, cfg))
    return model


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_logits_and_grads_match_reference(layout):
    torch, bert, convert = _port()
    scan = LAYOUTS[layout]
    rcfg = ref.tiny(scan_layers=scan)
    params = _ref_params(rcfg)
    ids, mask = _inputs()
    model = ref.BertClassifier(rcfg)

    def summed(p):
        return model.apply(p, jnp.asarray(ids), jnp.asarray(mask)).sum()

    want = np.asarray(model.apply(params, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    want_g = jax.tree.map(np.asarray, jax.grad(summed)(params))
    port = _port_model({"scan_layers": scan}, params)
    logits = port(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=1e-5)
    logits.sum().backward()
    grads = convert.bert_from_reference(want_g, port.cfg)
    got_g = dict(port.named_parameters())
    assert set(grads) == set(got_g)
    for key, g in grads.items():
        assert _rel(got_g[key].grad.numpy(), g.numpy()) <= 1e-4, key


def test_padding_row_attends_uniformly():
    torch, _, _ = _port()
    port = _port_model({}, _ref_params(ref.tiny()))
    ids, mask = _inputs()
    layer = port.encoder.layers[0].attention
    x = torch.randn(4, 16, port.cfg.hidden_size,
                    generator=torch.Generator().manual_seed(0))
    probs = layer.attention_probs(x, torch.from_numpy(mask))
    assert torch.isfinite(probs).all()
    torch.testing.assert_close(probs[3], torch.full_like(probs[3], 1 / 16),
                               rtol=0, atol=1e-7)
    assert (probs[2][..., 3:] == 0).all()  # masked keys get nothing
    logits = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert torch.isfinite(logits).all()


def test_snapshots_cross_between_packages(tmp_path):
    """The reference's snapshot (scan-stacked, as bert_base writes) loads
    in the port; the port's loads in the reference; same probabilities."""
    torch, bert, _ = _port()
    from kubeflow_tpu_torch.serving.runtimes import BertClassifierModel

    rcfg = ref.tiny(scan_layers=True)
    params = _ref_params(rcfg, seed=3)
    ref.save_pretrained(str(tmp_path / "ref"), rcfg, params)
    ids, mask = _inputs()
    model = ref.BertClassifier(rcfg)
    want = np.asarray(jax.nn.softmax(model.apply(
        params, jnp.asarray(ids), jnp.asarray(mask)), axis=-1))
    cfg, sd = bert.load_pretrained(str(tmp_path / "ref"))
    assert cfg == bert.tiny(scan_layers=True)
    served = BertClassifierModel("b", {
        "storage_path": str(tmp_path / "ref"), "device": "cpu",
        "buckets": (4,), "seq_buckets": (16,)})
    served.start()
    rows = [list(map(int, r[m])) for r, m in zip(ids, mask)][:3]
    got = np.asarray(served.predict_batch(rows))
    np.testing.assert_allclose(got, want[:3], atol=1e-5)
    bert.save_pretrained(str(tmp_path / "port"), cfg, sd)
    rcfg2, params2 = ref.load_pretrained(str(tmp_path / "port"))
    assert rcfg2 == rcfg
    back = np.asarray(jax.nn.softmax(ref.BertClassifier(rcfg2).apply(
        params2, jnp.asarray(ids), jnp.asarray(mask)), axis=-1))
    np.testing.assert_allclose(back, want, atol=1e-6)


def test_kft_bert_isvc_on_port_cluster():
    """Baseline config 3 on the port: bert modelFormat -> kft-bert runtime
    -> ragged token batches -> class probabilities, the reference's."""
    from kubeflow_tpu_torch.api.common import ObjectMeta
    from kubeflow_tpu_torch.api.inference import (
        ComponentSpec, InferenceService, InferenceServicePhase,
        InferenceServiceSpec, ModelFormat)
    from kubeflow_tpu_torch.controlplane.cluster import Cluster
    from kubeflow_tpu_torch.serving.storage import register_mem

    torch, bert, convert = _port()
    rcfg = ref.tiny()
    params = _ref_params(rcfg)
    cfg = bert.tiny()
    key = register_mem("torch-bert-tiny",
                       (cfg, convert.bert_from_reference(params, cfg)))
    cluster = Cluster()
    cluster.add_gpu_hosts("s0", 1, 4)
    cluster.enable_serving()
    instances = [[5, 9, 2], [7, 1, 3, 4, 8, 11, 2]]
    with cluster:
        cluster.store.create(InferenceService(
            metadata=ObjectMeta(name="bert"),
            spec=InferenceServiceSpec(predictor=ComponentSpec(
                model_format=ModelFormat(name="bert"),
                config={"params_ref": key, "device": "cpu"}))))
        deadline = time.time() + 60
        isvc = None
        while time.time() < deadline:
            isvc = cluster.store.try_get("InferenceService", "bert")
            if isvc and isvc.status.phase == InferenceServicePhase.READY:
                break
            time.sleep(0.1)
        assert isvc.status.phase == InferenceServicePhase.READY, isvc.status

        def predict(rows):
            req = urllib.request.Request(
                f"{isvc.status.url}/v1/models/bert:predict",
                data=json.dumps({"instances": rows}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())["predictions"]

        preds = predict(instances)
        solo = predict(instances[:1])[0]
    assert len(preds) == 2
    for p in preds:
        assert len(p) == cfg.num_classes
        assert abs(sum(p) - 1.0) < 1e-3
    np.testing.assert_allclose(preds[0], solo, atol=1e-4)
    model = ref.BertClassifier(rcfg)
    for row, p in zip(instances, preds):
        want = jax.nn.softmax(model.apply(params, jnp.asarray([row])))[0]
        np.testing.assert_allclose(p, np.asarray(want), atol=1e-5)
