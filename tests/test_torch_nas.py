"""The port's one-shot NAS (``kubeflow_tpu_torch/hpo/nas.py``) against the
reference's ``kubeflow_tpu/hpo/nas.py`` (CPU, f32).

- ``darts_search`` on a tiny base config, started from the reference's
  initial supernet (``convert.supernet_from_reference``) and fed the same
  numpy token stream, 5 step pairs: the alphas within 1e-4, the final loss
  within 1e-5 relative, and the ranking equal.
- ``OneShotNas.suggest`` returns the reference's suggestions for the same
  task and requests, the suggester-exhausted contract included (fewer than
  asked at the end of the space, none past it).

torch and the port are imported inside the tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.hpo import algorithms as ref_alg
from kubeflow_tpu.hpo import nas as ref
from kubeflow_tpu.models import llama as ref_llama

BASE = dict(vocab_size=32, hidden_size=32, num_heads=2, num_kv_heads=2,
            head_dim=16, max_seq_len=16, num_layers=1, intermediate_size=32,
            remat=False)
SPACE = dict(max_layers=3, ffn_widths=(16, 32))
STEPS = 5


def _port():
    import torch

    from kubeflow_tpu_torch.hpo import nas
    from kubeflow_tpu_torch.models import convert, llama

    torch.set_num_threads(1)
    return torch, nas, convert, llama


def _stream(seed=2):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.integers(0, BASE["vocab_size"], (8, 17)).astype(np.int32)


def _ref_base():
    return ref_llama.LlamaConfig(dtype=jnp.float32, scan_layers=False,
                                 **BASE)


def _port_task(seed: int = 0) -> tuple:
    """The port's (base, space, stream, darts_search keywords): the
    reference supernet's initial weights for ``seed``, on the CPU."""
    torch, nas, convert, llama = _port()
    space = nas.ArchSpace(**SPACE)
    base = llama.LlamaConfig(dtype=torch.float32, **BASE)
    rcfg = dataclasses.replace(
        _ref_base(), num_layers=SPACE["max_layers"],
        intermediate_size=SPACE["ffn_widths"][-1])
    first = next(_stream())
    params = ref.SupernetLM(rcfg, ref.ArchSpace(**SPACE)).init(
        jax.random.PRNGKey(seed), jnp.asarray(first))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    init = convert.supernet_from_reference(
        params, nas.supernet_config(base, space), space)
    return base, space, _stream(), {"device": "cpu", "init_state": init}


def test_darts_search_matches_reference():
    _, nas, _, _ = _port()
    want = ref.darts_search(_ref_base(), ref.ArchSpace(**SPACE), _stream(),
                            steps=STEPS, seed=0)
    base, space, stream, kw = _port_task()
    got = nas.darts_search(base, space, stream, steps=STEPS, **kw)
    np.testing.assert_allclose(got.alpha_depth, want.alpha_depth, atol=1e-4)
    np.testing.assert_allclose(got.alpha_ffn, want.alpha_ffn, atol=1e-4)
    assert abs(got.final_loss - want.final_loss) <= 1e-5 * want.final_loss
    assert got.ranked == want.ranked
    # the alphas moved: the search is not trivially equal at init
    assert np.abs(want.alpha_depth).max() > 1e-2


def test_one_shot_suggester_matches_reference():
    _, nas, _, _ = _port()
    ref.register_task("torch-nas-task",
                      lambda: (_ref_base(), ref.ArchSpace(**SPACE),
                               _stream()))
    nas.register_task("torch-nas-task", _port_task)
    total = SPACE["max_layers"] * len(SPACE["ffn_widths"])
    settings = {"task_ref": "torch-nas-task", "supernet_steps": str(STEPS)}
    for count, issued in ((4, 0), (4, total - 2), (2, total)):
        req = ref_alg.SuggestRequest(
            parameters=[], objective_type=None, count=count, seed=0,
            issued=issued, settings=settings)
        want = ref.OneShotNas().suggest(req)
        got = nas.OneShotNas().suggest(req)
        assert got == want
        assert len(got) == min(count, max(total - issued, 0))
    with pytest.raises(ValueError, match="task_ref"):
        nas.OneShotNas().suggest(ref_alg.SuggestRequest(
            parameters=[], objective_type=None, settings={}))
