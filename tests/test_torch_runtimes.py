"""The port's serving runtimes (``kubeflow_tpu_torch/serving/runtimes.py``)
against the reference's, on the same ``tiny()`` weights (f32, the port's with
``"device": "cpu"``).

- ``LlamaGenerator``: equal greedy tokens on the same batches: mixed prompt
  lengths, an overlong prompt (left-truncated, not raised), an empty prompt
  (an empty continuation, its neighbours unchanged), ``weights_dtype``
  bfloat16; a bad ``seq_buckets`` is refused with the reference's message;
  temperature draws differ across requests.
- ``TorchFunctionModel`` pads a batch to the buckets exactly as
  ``JaxFunctionModel`` does, with outputs within 1e-6.
- ``mesh_axes`` is refused naming its ROADMAP item; a
  ``BertClassifierModel`` with no weights is refused as the reference's is
  (its parity is ``tests/test_torch_bert.py``).

torch and both packages are imported inside the tests.
"""

import numpy as np
import pytest

from tests.test_torch_text_server import register_both, tiny_weights

#: batches both generators decode; each row's tokens are compared
BATCHES = {
    "mixed": [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 20],
    "single": [[17, 3, 99, 4]],
    "overlong": [list(range(1, 160)), [5, 6, 7]],
    "empty": [[], [5, 6, 7]],
}


@pytest.fixture(scope="module")
def refs():
    return register_both(tiny_weights(), "torch-runtimes")


def _gens(refs, **config):
    """(reference LlamaGenerator, port LlamaGenerator), both started."""
    from kubeflow_tpu.serving.runtimes import LlamaGenerator as Ref
    from kubeflow_tpu_torch.serving.runtimes import LlamaGenerator as Port

    ref = Ref("gen", {"params_ref": refs[0], **config})
    port = Port("gen", {"params_ref": refs[1], "device": "cpu", **config})
    ref.start()
    port.start()
    return ref, port


@pytest.fixture(scope="module")
def gens(refs):
    return _gens(refs, max_new_tokens=5)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_llama_generator_greedy_tokens_equal(gens, batch):
    ref, port = gens
    assert port.seq_buckets == ref.seq_buckets
    want = ref.predict_batch(BATCHES[batch])
    got = port.predict_batch(BATCHES[batch])
    assert got == want
    assert [len(r) for r in got] == [0 if not p else 5
                                     for p in BATCHES[batch]]


def test_llama_generator_truncates_and_isolates(gens):
    """The overlong prompt behaves exactly like its tail; an empty prompt
    leaves its neighbour's tokens as they are alone; an all-empty batch
    returns without a dispatch."""
    _, port = gens
    cap = port.seq_buckets[-1]
    long_prompt = list(range(1, cap + 40))
    out = port.predict_batch([long_prompt, [5, 6, 7]])
    assert out[0] == port.predict_batch([long_prompt[-cap:]])[0]
    assert out[1] == port.predict_batch([[5, 6, 7]])[0]
    assert port.predict_batch([[], []]) == [[], []]


def test_llama_generator_weights_dtype_bfloat16(refs):
    import torch

    ref, port = _gens(refs, max_new_tokens=3, weights_dtype="bfloat16")
    leaves = [p.dtype for p in port.model.parameters()]
    assert set(leaves) == {torch.bfloat16}
    batch = [[1, 2, 3], [4, 5]]
    assert port.predict_batch(batch) == ref.predict_batch(batch)


def test_llama_generator_bad_buckets_refused(refs):
    from kubeflow_tpu.serving.runtimes import LlamaGenerator as Ref
    from kubeflow_tpu_torch.serving.runtimes import LlamaGenerator as Port

    errs = []
    for cls, key, extra in ((Ref, refs[0], {}),
                            (Port, refs[1], {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            cls("gen", {"params_ref": key, "seq_buckets": (100000,),
                        **extra}).start()
        errs.append(str(err.value))
    assert errs[1] == errs[0]
    assert "no usable seq bucket" in errs[1]


def test_llama_generator_temperature_differs_across_requests(refs):
    _, port = _gens(refs, max_new_tokens=6, temperature=1.5)
    outs = {tuple(port.predict_batch([[1, 2, 3]])[0]) for _ in range(6)}
    assert len(outs) > 1  # a fixed seed made every continuation identical
    assert all(len(o) == 6 for o in outs)


def test_llama_generator_refusals(refs):
    from kubeflow_tpu_torch.serving.runtimes import (
        BertClassifierModel,
        LlamaGenerator,
    )

    # a tensor-parallel generator runs inside a group of that many ranks
    # (tests/test_torch_sharded.py); outside one it says so
    with pytest.raises(ValueError, match="needs a gang of 2 ranks"):
        LlamaGenerator("gen", {"params_ref": refs[1], "device": "cpu",
                               "mesh_axes": {"model": 2}}).start()
    with pytest.raises(RuntimeError, match="need params_ref or storage_uri"):
        BertClassifierModel("bert", {"device": "cpu"}).start()


def test_function_model_pads_to_buckets_as_reference():
    import jax.numpy as jnp
    import torch

    from kubeflow_tpu.serving.runtimes import JaxFunctionModel
    from kubeflow_tpu.serving.storage import register_mem as ref_register
    from kubeflow_tpu_torch.serving.runtimes import TorchFunctionModel
    from kubeflow_tpu_torch.serving.storage import register_mem

    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 2)).astype(np.float32)
    seen = {"ref": [], "port": []}

    def jfn(params, x):
        seen["ref"].append(tuple(x.shape))
        return jnp.tanh(x @ params)

    def tfn(params, x):
        seen["port"].append(tuple(x.shape))
        assert not torch.is_grad_enabled()
        return torch.tanh(x @ params)

    ref = JaxFunctionModel("f", {"fn_ref": ref_register(
        "torch-fn", (jfn, jnp.asarray(w))), "buckets": (2, 4)})
    port = TorchFunctionModel("f", {"fn_ref": register_mem(
        "torch-fn", (tfn, torch.from_numpy(w))), "buckets": (2, 4),
        "device": "cpu"})
    ref.start()
    port.start()
    for n in (1, 3, 4, 7):
        x = rng.standard_normal((n, 3)).astype(np.float32).tolist()
        want, got = ref.predict_batch(x), port.predict_batch(x)
        assert np.asarray(got).shape == (n, 2)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # jit traces the reference's fn once per shape; the port's runs per call
    assert seen["port"] == [(2, 3), (4, 3), (4, 3), (4, 3), (4, 3)]
    assert sorted(set(seen["port"])) == sorted(set(seen["ref"]))
