"""The port's serving gang (``kubeflow_tpu_torch/serving/gang.py``) on the
CPU: the control stream, a two-rank gang over gloo, the kv_migrate wire,
and the op table of the gang's protocol.

- ``GangChannel`` in process (threads, no ranks): a framed round trip of a
  large numpy payload, a follower socket dropped by the chaos seam and the
  stream replayed exactly once, and a wrong token refused at the
  handshake;
- one spawn (``parallel.dryrun.spawn``) of two ranks at ``{"model": 2}``
  (``tests/_torch_gang_worker.py``): the chunked schedule (paged, budget
  16) and the speculative one (``spec_k`` 4 on repetitive prompts), each
  with rank 0's greedy tokens equal to the reference engine's and every
  program output of the follower bitwise equal to rank 0's; then a live
  sequence exported from the TP=2 gang (a snapshot of every head) moved
  over the kv_migrate wire into an unsharded engine, where it finishes
  with the reference engine's tokens;
- ``DisaggregatedPool(wire=True)``: the prefill-to-decode handoff over
  the wire, tokens equal to the reference engine's;
- the reference's ``op-table`` lint rule (``kubeflow_tpu.analysis``) over
  the port's ``serving/gang.py`` and ``serving/resize.py``: every
  published op has a replay arm and every arm a publisher, and a removed
  arm is found.
- an InferenceService with ``mesh_axes`` placed as a gang of two
  ``serve_main`` pod processes on the CPU, answering through its Router
  with the reference engine's tokens; the autoscaler's TP-resize
  actuator takes the live gang 2 -> 1 -> 2 through rank 0's resize route
  (``GangResized`` emitted, the degree recorded on the handle, the tokens
  still the reference engine's), and refuses a target of 3.

Every stream is held against the reference engine on the same weights (the
reference's init, converted by ``models/convert.py``).

torch and the port are imported inside the tests.
"""

import os
import shutil
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref_llama
from kubeflow_tpu.serving.continuous import ContinuousEngine as RefEngine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gang_worker as worker  # noqa: E402

NEW = 12
WARM = [(1, 32), (2, 32)]
#: name -> engine kwargs of each schedule the follower replays
CASES = {
    "chunked": {"num_slots": 2, "decode_chunk": 4, "prefill_budget": 16,
                "block_size": 8, "prefix_cache": False},
    "spec": {"num_slots": 2, "decode_chunk": 1, "spec_k": 4,
             "spec_ngram": 3, "prefix_cache": False},
}
WIRE = {"prompt": list(range(3, 23)), "new": 24, "warm": [(1, 32)],
        "cut": 2}
WIRE_KW = {"num_slots": 2, "decode_chunk": 1, "block_size": 8,
           "prefix_cache": False}
SPAWN_TIMEOUT_S = 240


def _port():
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import continuous

    torch.set_num_threads(1)
    return torch, llama, convert, continuous


def _prompts():
    rng = np.random.default_rng(1)
    return [([11, 22, 33, 44, 55] * 6)[:30],
            rng.integers(1, 256, size=17).tolist(),
            ([7, 8, 9] * 5)[:14], rng.integers(1, 256, size=5).tolist()]


@pytest.fixture(scope="module")
def weights():
    _, llama, convert, _ = _port()
    cfg = ref_llama.tiny()
    params = ref_llama.Llama(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    return cfg, params, convert.state_dict_from_jax(params, llama.tiny())


@pytest.fixture(scope="module")
def ranks(weights):
    from kubeflow_tpu_torch.parallel import dryrun
    from kubeflow_tpu_torch.utils.net import free_port

    ports = [free_port() for _ in range(len(CASES) + 1)]
    return dryrun.spawn(2, worker.run_gang, ports, CASES, weights[2],
                        _prompts(), NEW, WARM, WIRE,
                        timeout=SPAWN_TIMEOUT_S)


def _reference_tokens(weights, kw, prompts, new, warm):
    eng = RefEngine(weights[0], weights[1], **kw)
    try:
        eng.warmup(warm)
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        return [r.wait(worker.WAIT_S) for r in reqs]
    finally:
        eng.stop()


# -- the control stream ------------------------------------------------------


def _channel_pair(port, sent, **kw):
    """A follower thread reading to ``("stop",)``; returns (thread, its
    messages)."""
    from kubeflow_tpu_torch.serving.gang import GangChannel

    out: list = []

    def follower():
        ch = GangChannel.connect("127.0.0.1", port, rank=1, **kw)
        while True:
            m = ch.next()
            if m == ("stop",):
                break
            out.append(m)
        ch.close()

    t = threading.Thread(target=follower)
    t.start()
    return t, out


def test_gang_channel_roundtrip():
    from kubeflow_tpu_torch.serving.gang import GangChannel
    from kubeflow_tpu_torch.utils.net import allocate_port

    port = allocate_port()
    t, got = _channel_pair(port, None, token="t")
    ch = GangChannel.listen(port, 1, token="t")
    big = np.arange(100_000, dtype=np.int32)
    ch.publish(("run", ("decode", 128, False), {"positions": big}))
    ch.publish(("stop",))
    t.join(timeout=30)
    ch.close()
    (op, key, host), = got
    assert (op, key) == ("run", ("decode", 128, False))
    assert np.array_equal(host["positions"], big)


def test_dispatch_stream_survives_follower_socket_drop():
    from kubeflow_tpu_torch.chaos import FaultPlan
    from kubeflow_tpu_torch.serving.gang import GangChannel
    from kubeflow_tpu_torch.utils.net import allocate_port

    port = allocate_port()
    plan = FaultPlan(seed=0).socket_drop(role="follower", after_calls=20)
    chan = dict(hb_interval=0.05, dead_peer_timeout=0.5,
                reattach_timeout=5.0, reconnect_timeout=5.0)
    t, got = _channel_pair(port, None, token="t",
                           sock_wrap=plan.socket_wrapper("follower"), **chan)
    leader = GangChannel.listen(port, 1, token="t", **chan)
    sent = []
    for step in range(12):
        msg = ("run", ("decode", step), np.arange(200, dtype=np.int32) + step)
        leader.publish(msg)
        sent.append(msg)
        time.sleep(0.01)
    leader.publish(("stop",))
    t.join(timeout=20)
    leader.close()
    assert not t.is_alive(), "follower hung after the socket drop"
    assert len(got) == len(sent)
    for g, s in zip(got, sent):
        assert g[:2] == s[:2] and np.array_equal(g[2], s[2])


def test_wrong_token_is_refused_at_the_handshake():
    from kubeflow_tpu_torch.serving.gang import GangChannel
    from kubeflow_tpu_torch.utils.net import allocate_port

    port = allocate_port()

    def intruder():
        try:
            GangChannel.connect("127.0.0.1", port, rank=1, token="wrong",
                                timeout=2).close()
        except OSError:
            pass

    t = threading.Thread(target=intruder)
    t.start()
    with pytest.raises(TimeoutError, match="0/1 followers"):
        GangChannel.listen(port, 1, token="right", timeout=1.5)
    t.join(timeout=10)


# -- the two-rank gang -------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_follower_replays_schedule_bit_identically(weights, ranks, case):
    import torch

    lead, follow = ranks[0][case], ranks[1][case]
    assert lead["tokens"] == _reference_tokens(
        weights, CASES[case], _prompts(), NEW, WARM)
    assert lead["outs"] and len(lead["outs"]) == len(follow["outs"])
    for (k0, t0), (k1, t1) in zip(lead["outs"], follow["outs"]):
        assert k0 == k1
        assert torch.equal(t0, t1)
    st = lead["stats"]
    assert st["graph_captures_total"] == 0
    if case == "chunked":
        assert st["prefill_chunks_dispatched"] > len(_prompts())
    else:
        assert st["spec_tokens_accepted_total"] > 0


def test_tp2_export_imports_at_tp1_over_the_wire(weights, ranks):
    w = ranks[0]["wire"]
    assert w["ok"] is True and w["imports"] == 1
    # the snapshot holds every head, whatever the degree
    assert w["snapshot_heads"] == weights[0].num_kv_heads
    (truth,) = _reference_tokens(weights, WIRE_KW, [WIRE["prompt"]],
                                 WIRE["new"], WIRE["warm"])
    assert w["tail"] == truth
    assert w["head"] == truth[:len(w["head"])] and len(w["head"]) >= 2
    assert w["dst_stats"]["kv_migrations_total"] == 1
    assert w["src_stats"]["kv_blocks_free"] == w["src_stats"][
        "kv_blocks_total"]


def test_disaggregated_pool_over_the_wire(weights):
    _, llama, _, continuous = _port()
    kw = {"num_slots": 2, "decode_chunk": 4, "block_size": 8,
          "prefill_budget": 8, "prefix_cache": False}
    pool = continuous.DisaggregatedPool(
        llama.tiny(), weights[2], wire=True, device="cpu", **kw)
    got = worker._serve(pool, _prompts(), NEW, WARM)
    assert got["tokens"] == _reference_tokens(weights, kw, _prompts(), NEW,
                                              WARM)
    assert got["stats"]["kv_migrations_total"] == len(_prompts())
    assert got["stats"]["kv_migrate_bytes_total"] > 0
    with pytest.raises(RuntimeError, match="wire=True"):
        pool.rebalance(1)


# -- the protocol's op table -------------------------------------------------


def _lint_port_protocol(root, edit=None):
    """The op-table rule over copies of the port's gang and resize modules
    laid out where the rule scopes the gang protocol."""
    from kubeflow_tpu.analysis.astlint import run_lint

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "kubeflow_tpu_torch", "serving")
    dst = root / "kubeflow_tpu" / "serving"
    dst.mkdir(parents=True)
    paths = []
    for name in ("gang.py", "resize.py"):
        shutil.copy(os.path.join(src, name), dst / name)
        paths.append(str(dst / name))
    if edit is not None:
        text = (dst / "gang.py").read_text()
        (dst / "gang.py").write_text(edit(text))
    return run_lint(str(root), paths=paths, rules=["op-table"]).findings


def test_op_table_is_complete(tmp_path):
    assert _lint_port_protocol(tmp_path) == []


def test_op_table_finds_a_removed_replay_arm(tmp_path):
    arm = '            elif op == "noise":'
    found = _lint_port_protocol(
        tmp_path, lambda t: t.replace(arm, '            elif op == "zap":'))
    msgs = sorted(f.message for f in found)
    assert len(msgs) == 2
    assert "`noise` is published but has no follower replay arm" in msgs[1]
    assert "dead replay arm: gang op `zap`" in msgs[0]


# -- a gang InferenceService on pod processes ---------------------------------


def test_mesh_axes_inference_service_serves_as_a_gang_of_pods(weights,
                                                              tmp_path):
    """An InferenceService whose predictor has ``mesh_axes={"model": 2}``
    is placed as a one-host gang: a JaxJob of two ``serve_main`` pods
    (real processes, gloo on the CPU, ``KFT_POD_DEVICE=cpu`` from the
    config's device), each bound to a card of its own, rank 0's frontend
    behind the Router; its greedy tokens equal the reference engine's.
    The autoscaler's resize decisions then reach the live gang through
    its actuator: 2 -> 1 -> 2, the tokens the reference engine's at each
    degree, ``GangResized`` emitted, and the degree recorded on the
    handle; a target above the gang's two members raises, the degree
    kept."""
    import json
    import urllib.request

    from kubeflow_tpu_torch.api import from_dict
    from kubeflow_tpu_torch.controlplane.cluster import Cluster
    from kubeflow_tpu_torch.controlplane.controller import events_for
    from kubeflow_tpu_torch.runtime.launcher import LocalKubelet
    from kubeflow_tpu_torch.serving.autoscale import Decision
    from kubeflow_tpu_torch.serving.controller import (
        InferenceServiceController,
    )

    llama = _port()[1]
    snap = str(tmp_path / "snapshot")
    llama.save_pretrained(snap, llama.tiny(), weights[2])
    kw = {"num_slots": 2, "decode_chunk": 4, "block_size": 8,
          "prefix_cache": False}
    prompt = _prompts()[1]
    (want,) = _reference_tokens(weights, kw, [prompt], 6, [(1, 32)])
    isvc = {"kind": "InferenceService", "metadata": {"name": "tp"},
            "spec": {"predictor": {
                "model_format": {"name": "llama-continuous"},
                "min_replicas": 1, "max_replicas": 1,
                "config": {"storage_path": snap, "device": "cpu",
                           "mesh_axes": {"model": 2}, "max_new_tokens": 6,
                           "warmup_groups": [[1, 32]], **kw}}}}
    cluster = Cluster()
    cluster.add_gpu_hosts("s0", 1, 4)
    kubelet = LocalKubelet(cluster.store, str(tmp_path / "pods"))
    with cluster:
        cluster.enable_serving()
        kubelet.start()
        try:
            cluster.store.create(from_dict(isvc))
            deadline = time.time() + worker.WAIT_S
            obj = None
            while time.time() < deadline:
                obj = cluster.store.get("InferenceService", "tp")
                if str(obj.status.phase.value) in ("Ready", "Failed"):
                    break
                time.sleep(0.1)
            assert str(obj.status.phase.value) == "Ready", obj.status
            (job,) = cluster.store.list("JaxJob")
            assert next(iter(job.spec.replica_specs.values())).replicas == 2
            pods = cluster.store.list("Pod")
            assert sorted(i for p in pods for i in p.spec.device_ids) == \
                [0, 1]

            def predict():
                req = urllib.request.Request(
                    obj.status.url + "/v1/models/tp:predict",
                    data=json.dumps({"instances": [prompt]}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=worker.WAIT_S) as r:
                    return json.loads(r.read())["predictions"][0]

            assert predict() == want
            ctl = next(x for x in cluster.controllers
                       if isinstance(x, InferenceServiceController))
            dep = ctl._deployments["default/tp"]
            (handle,) = dep.stable.predictors
            resize = ctl._autoscale_actuators(obj, dep)["resize"]
            for degree, action in ((1, "resize_down"), (2, "resize_up")):
                resize(Decision(action, degree=degree))
                assert handle.tp_degree == degree
                assert handle.gang.mesh_axes == {"model": degree}
                assert predict() == want, degree
            resized = [e.message for e in events_for(
                cluster.store, "InferenceService", "tp")
                if e.reason == "GangResized"]
            assert len(resized) == 2 and "TP degree 1" in resized[0]
            with pytest.raises(RuntimeError, match="failed on a replica") \
                    as err:
                resize(Decision("resize_up", degree=3))
            assert "above the gang's 2 live members" in str(
                err.value.__cause__)
            assert handle.tp_degree == 2 and predict() == want
        finally:
            cluster.store.delete("InferenceService", "tp")
            kubelet.stop()
