"""The port's one-shot NAS (``kubeflow_tpu_torch/hpo/nas.py``) against the
reference's ``kubeflow_tpu/hpo/nas.py`` (CPU, f32).

- ``darts_search`` on a tiny base config, started from the reference's
  initial supernet (``convert.supernet_from_reference``) and fed the same
  numpy token stream, 5 step pairs: the alphas within 1e-4, the final loss
  within 1e-5 relative, and the ranking equal.
- ``OneShotNas.suggest`` returns the reference's suggestions for the same
  task and requests, the suggester-exhausted contract included (fewer than
  asked at the end of the space, none past it).
- A ``darts`` experiment through the port's HPO controllers (fake kubelet,
  an in-process metric writer) issues the reference's ranking as its
  trials.

torch and the port are imported inside the tests.
"""

import dataclasses
import json
import threading
import time

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


def test_darts_experiment_reaches_the_port_supernet(tmp_path):
    """A ``darts`` experiment through the port's controllers: the
    Suggestion's assignments are the reference ``OneShotNas``'s ranking on
    the same task (the tiny task of ``tests/test_torch_nas.py``, started
    from the reference's initial supernet)."""
    from kubeflow_tpu_torch.api.experiment import Experiment
    from kubeflow_tpu_torch.controlplane import Cluster
    from kubeflow_tpu_torch.controlplane.fake_kubelet import FakeKubelet

    _, nas, _, _ = _port()
    # the reference's ranking under the key of the suggester test above
    # (its supernet run is cached per key, steps and seed); the port's task
    # under a key of its own, so that the controllers' call runs the search
    ref.register_task("torch-nas-task",
                      lambda: (_ref_base(), ref.ArchSpace(**SPACE),
                               _stream()))
    want = ref.OneShotNas().suggest(ref_alg.SuggestRequest(
        parameters=[], objective_type=None, count=2, settings={
            "task_ref": "torch-nas-task", "supernet_steps": str(STEPS)}))
    key = "torch-nas-task-controllers"
    nas.register_task(key, _port_task)
    settings = {"task_ref": key, "supernet_steps": str(STEPS)}

    cluster = Cluster()
    cluster.add_gpu_hosts("slice-0", 1, 4)
    cluster.enable_hpo(metrics_root=str(tmp_path))
    kubelet = FakeKubelet(cluster.store)
    stop = threading.Event()

    def metric_writer():
        while not stop.is_set():
            for pod in cluster.store.list("Pod"):
                env = pod.spec.container.env
                d = tmp_path / "status" / pod.metadata.namespace / pod.metadata.name
                if "KFT_LAYERS" not in env or (d / "metrics.jsonl").exists():
                    continue
                d.mkdir(parents=True, exist_ok=True)
                loss = 1.0 / int(env["KFT_LAYERS"]) + int(env["KFT_FFN_WIDTH"])
                (d / "metrics.jsonl").write_text(
                    json.dumps({"name": "loss", "value": loss}) + "\n")
            stop.wait(0.01)

    exp = Experiment.model_validate({
        "metadata": {"name": "arch-search"},
        "spec": {
            "objective": {"type": "minimize", "objective_metric_name": "loss"},
            "algorithm": {"algorithm_name": "darts", "settings": settings},
            "parameters": [
                {"name": "layers", "parameter_type": "int",
                 "feasible_space": {"min": 1, "max": SPACE["max_layers"]}},
                {"name": "ffn_width", "parameter_type": "categorical",
                 "feasible_space": {"list": [str(w) for w in
                                             SPACE["ffn_widths"]]}}],
            "parallel_trial_count": 1, "max_trial_count": 2,
            "trial_template": {"job_manifest": {
                "kind": "JaxJob", "metadata": {"name": "placeholder"},
                "spec": {"replica_specs": {"worker": {"replicas": 1,
                         "template": {"entrypoint": "none:main", "env": {
                             "KFT_LAYERS": "${trialParameters.layers}",
                             "KFT_FFN_WIDTH":
                                 "${trialParameters.ffn_width}"}}}}}}}}})
    writer = threading.Thread(target=metric_writer, daemon=True)
    with cluster:
        kubelet.start()
        writer.start()
        try:
            cluster.store.create(exp)
            deadline = time.time() + 60
            while time.time() < deadline:
                got = cluster.store.try_get("Experiment", "arch-search")
                if got is not None and got.status.completed:
                    break
                time.sleep(0.05)
            assert got is not None and got.status.completed, got
            trials = sorted(cluster.store.list("Trial"),
                            key=lambda t: t.metadata.name)
        finally:
            stop.set()
            kubelet.stop()
    assert len(want) == 2
    assert [{a.name: a.value for a in t.spec.assignments}
            for t in trials] == want
    assert got.status.trials_succeeded == 2
    best = min(want, key=lambda a: 1.0 / a["layers"] + a["ffn_width"])
    assert {a.name: a.value for a in
            got.status.current_optimal_assignments} == best
