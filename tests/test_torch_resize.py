"""The port's elastic TP resize (``kubeflow_tpu_torch/serving/resize.py``)
on the CPU.

- one spawn (``parallel.dryrun.spawn``) of a two-rank gang at ``{"model":
  2}`` (``tests/_torch_gang_worker.py``): a resize killed mid-export, and
  one killed mid-commit after the group was re-formed, resume the old
  degree in place (the stream's tokens unchanged, zero leaked blocks);
  then, with a stream open, the live gang shrinks to 1
  (the group re-formed, rank 1 parked) and grows back to 2, and the
  stream's greedy tokens equal the reference engine's on the same weights
  (the reference's init converted by ``models/convert.py``), with zero
  leaked blocks and the phases timed; every rank's engines share one
  program-artifact cache (``aot``), and the grow back to 2 meets the
  degree-2 records the first boot published: hits and no miss on both
  ranks;
- the controller's elastic knobs, as the reference's tests drive them: a
  bad ``elastic`` family is one Failed status, the degraded deadline
  re-places a gang at its surviving shape, ``min_degree`` floors it;
- the autoscaler's TP-resize actuator posts its decision to the serving
  gangs and raises when nothing resized, when a gang refused, and when a
  resize aborted; rank 0's resize route checks the gang token and
  refuses what it cannot take (the live actuator is
  ``tests/test_torch_gang.py``'s);
- ``ElasticGangSupervisor``'s shrink-to-survive and grow-back decisions,
  the plan's helpers.

torch and the port are imported inside the tests.
"""

import os
import sys
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

PROMPT = list(range(5, 25))
NEW = 40
WARM = [(1, 32)]
KW = {"num_slots": 2, "decode_chunk": 1, "block_size": 8,
      "prefix_cache": False}
SPAWN_TIMEOUT_S = 240


def _port():
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import continuous

    torch.set_num_threads(1)
    return torch, llama, convert, continuous


@pytest.fixture(scope="module")
def weights():
    """(reference cfg, its numpy params, the port's state dict)."""
    _, llama, convert, _ = _port()
    cfg = ref_llama.tiny()
    params = ref_llama.Llama(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    return cfg, params, convert.state_dict_from_jax(params, llama.tiny())


@pytest.fixture(scope="module")
def truth(weights):
    """The reference engine's greedy stream of ``PROMPT``."""
    eng = RefEngine(weights[0], weights[1], **KW)
    try:
        eng.warmup(WARM)
        return eng.submit(PROMPT, max_new_tokens=NEW).wait(worker.WAIT_S)
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    from kubeflow_tpu_torch.parallel import dryrun
    from kubeflow_tpu_torch.utils.net import free_port

    root = str(tmp_path_factory.mktemp("aot"))
    return dryrun.spawn(2, worker.run_resize, free_port(), weights[2],
                        PROMPT, NEW, WARM, root, timeout=SPAWN_TIMEOUT_S)


def test_shrink_and_grow_back_keep_the_stream_bit_identical(ranks, truth):
    r = ranks[0]
    assert r["tokens"] == truth and len(truth) == NEW
    assert r["shrunk"]["tp_degree"] == 1 and r["grown"]["tp_degree"] == 2
    # both resizes cut the stream mid-flight
    assert 0 < r["shrunk"]["at"] < r["grown"]["at"] < NEW
    assert r["resizes"] == 2
    assert r["free"][0] == r["free"][1]
    st = r["stats"]
    assert st["tp_degree"] == 2 and st["graph_captures_total"] == 0
    for phase in ("drain_s", "reshard_s", "resume_s", "total_s"):
        assert r["shrunk"]["timings"][phase] >= 0
        assert r["grown"]["timings"][phase] >= 0


def test_grow_back_meets_the_first_boots_records(ranks):
    """The rebuild at degree 2 carries the live engine's program cache
    (the follower's over its parked stretch): every program it warms was
    recorded at the first boot's degree 2, so both ranks count hits and
    no miss (rank 1 from the grow's hand-over to its end)."""
    before, after = ranks[0]["aot"]
    follower = ranks[1]["aot"]
    for a, b in ((before, after), (follower[-2], follower[-1])):
        assert b["aot_cache_hits_total"] > a["aot_cache_hits_total"], (a, b)
        assert b["aot_cache_misses_total"] == a["aot_cache_misses_total"]
        assert b["aot_cache_load_failures_total"] == 0


@pytest.mark.parametrize("phase", ["export", "commit"])
def test_abort_mid_export_resumes_in_place_with_zero_leaks(ranks, truth,
                                                           phase):
    """Killed mid-export (before anything is published) and mid-commit
    (after the group was re-formed at degree 1 and the new engine built:
    the abort forms the degree-2 group again and re-points the old engine
    at it), the old degree serves on: the stream's tokens unchanged, every
    block free once it is done."""
    a = ranks[0][f"abort_{phase}"]
    assert a["phase"] == phase and a["failures"] == 1
    assert a["tokens"] == truth and a["tp_degree"] == 2
    assert a["free"][0] == a["free"][1]


def test_plan_helpers():
    from kubeflow_tpu_torch.serving.resize import (
        degree_of,
        flatten_params,
        resize_block_budget,
        unflatten_params,
    )

    torch = _port()[0]
    assert degree_of(None) == 1 and degree_of({"model": 4}) == 4
    assert resize_block_budget(64, 2, 1) == 32
    assert resize_block_budget(64, 2, 1, reserved=40) == 40
    assert resize_block_budget(32, 1, 2) == 64
    sd = {"b": torch.ones(2, dtype=torch.bfloat16), "a": torch.zeros(3)}
    leaves = flatten_params(sd)
    assert [k for k, _ in leaves] == ["a", "b"]
    back = unflatten_params(leaves)
    assert back.keys() == sd.keys() and back["b"].dtype == torch.bfloat16


# -- the supervisor's decisions ------------------------------------------------


class _Channel:
    def __init__(self, live, lost=None):
        self.live, self.lost, self.forgot = list(live), dict(lost or {}), []

    def lost_since(self):
        return dict(self.lost)

    def follower_ranks(self):
        return list(self.live)

    def take_fresh_joins(self):
        return []

    def touch_lost(self, ranks):
        pass

    def forget_rank(self, rank):
        self.forgot.append(rank)
        self.lost.pop(rank, None)


class _Resizer:
    def __init__(self, degree):
        self.d, self.calls = degree, []

    def degree(self):
        return self.d

    def resize(self, axes):
        self.calls.append(axes)
        self.d = axes["model"]


def test_supervisor_shrinks_past_the_deadline_and_grows_back():
    from kubeflow_tpu_torch.serving.resize import ElasticGangSupervisor

    ch = _Channel(live=[], lost={1: time.monotonic() - 10})
    rs = _Resizer(2)
    sup = ElasticGangSupervisor(rs, ch, degree_per_member=1, max_degree=2,
                                resize_deadline_s=1.0, poll_s=3600)
    try:
        sup._tick()
        assert rs.calls == [{"model": 1}] and ch.forgot == [1]
        ch.live = [1]  # the member returned
        sup._tick()
        assert rs.calls[-1] == {"model": 2}
        sup._tick()
        assert len(rs.calls) == 2  # at max_degree: nothing to do
        floor = ElasticGangSupervisor(
            _Resizer(2), _Channel([], {1: time.monotonic() - 10}),
            degree_per_member=1, max_degree=2, min_degree=2,
            resize_deadline_s=1.0, poll_s=3600)
        floor._tick()
        assert floor.resizer.calls == []
        floor.stop()
    finally:
        sup.stop()


# -- the controller ------------------------------------------------------------


def _wait_phase(cluster, name, phase, timeout=20):
    deadline = time.time() + timeout
    isvc = None
    while time.time() < deadline:
        isvc = cluster.store.try_get("InferenceService", name)
        if isvc is not None and isvc.status.phase == phase:
            break
        time.sleep(0.05)
    return isvc


def test_bad_elastic_fails_isvc_at_conf_freeze():
    from kubeflow_tpu_torch.api.common import ObjectMeta
    from kubeflow_tpu_torch.api.inference import (
        ComponentSpec,
        InferenceService,
        InferenceServicePhase,
        InferenceServiceSpec,
        ModelFormat,
    )
    from kubeflow_tpu_torch.controlplane.cluster import Cluster

    bad = {
        "bad-min": {"params_ref": "mem://never", "block_size": 16,
                    "elastic": {"min_degree": 0}},
        "bad-key": {"params_ref": "mem://never", "block_size": 16,
                    "elastic": {"min_degre": 2}},
        "bad-ddl": {"params_ref": "mem://never", "block_size": 16,
                    "elastic": {"degraded_deadline_s": -1}},
        "bad-pool": {"params_ref": "mem://never",
                     "elastic": {"min_degree": 1}},
    }
    with Cluster() as cluster:
        cluster.add_gpu_hosts("slice-0", 1, 4)
        cluster.enable_serving()
        for name, cfg in bad.items():
            cluster.store.create(InferenceService(
                metadata=ObjectMeta(name=name),
                spec=InferenceServiceSpec(predictor=ComponentSpec(
                    model_format=ModelFormat(name="llama-continuous"),
                    config=cfg))))
        for name in bad:
            isvc = _wait_phase(cluster, name, InferenceServicePhase.FAILED)
            assert isvc.status.phase == InferenceServicePhase.FAILED, name
            assert "elastic" in (isvc.status.message or ""), name


def _controller_stub(store, events):
    from kubeflow_tpu_torch.serving.controller import (
        InferenceServiceController,
    )

    class _Ctl:
        emit_event = staticmethod(
            lambda obj, reason, msg, type_="Normal":
            events.append((reason, msg)))
        _wire = staticmethod(lambda *_a, **_k: None)
        _escalate_shrink = InferenceServiceController._escalate_shrink

    _Ctl.store = store
    return _Ctl()


def test_degraded_deadline_re_places_the_gang_at_its_surviving_shape():
    from kubeflow_tpu_torch.api.common import ObjectMeta
    from kubeflow_tpu_torch.api.inference import GangSpec, InferenceService
    from kubeflow_tpu_torch.api.jaxjob import KIND_JAXJOB
    from kubeflow_tpu_torch.controlplane.store import Store
    from kubeflow_tpu_torch.serving.controller import (
        InferenceServiceController,
        _Deployment,
        _Revision,
    )

    store = Store()
    isvc = InferenceService(metadata=ObjectMeta(name="el"))
    events: list = []

    class _DeadGang:
        gang = GangSpec(hosts=2, mesh_axes={"model": 8}, chips_per_host=4)
        ready = False
        stopped = False

        def stop(self):
            type(self).stopped = True

    cfg = {"elastic": {"min_degree": 2, "degraded_deadline_s": 0.5},
           "block_size": 16}
    dep = _Deployment()
    dep.stable = _Revision(1, "fp", isvc.spec, None, cfg)
    dep.stable.predictors = [_DeadGang()]
    ctl = _controller_stub(store, events)
    track = InferenceServiceController._track_degraded
    track(ctl, isvc, dep, True)
    assert dep.degraded_since is not None and not events
    dep.degraded_since -= 1.0
    track(ctl, isvc, dep, True)
    reasons = [r for r, _ in events]
    assert reasons[0] == "DegradedTimeout" and "GangResized" in reasons
    assert _DeadGang.stopped
    repl = dep.stable.predictors[0]
    assert repl.gang.hosts == 1 and repl.gang.mesh_axes == {"model": 4}
    # one pod for each rank of the surviving shape, each on its own card
    job = store.get(KIND_JAXJOB, repl.job_name, "default")
    spec = next(iter(job.spec.replica_specs.values()))
    assert spec.replicas == 4
    assert spec.template.entrypoint == \
        "kubeflow_tpu_torch.serving.gang:serve_main"
    n = len(events)
    track(ctl, isvc, dep, True)
    assert len(events) == n
    track(ctl, isvc, dep, False)
    assert dep.degraded_since is None and not dep.degraded_escalated
    repl.stop()


def test_min_degree_floors_the_shrink():
    from kubeflow_tpu_torch.api.common import ObjectMeta
    from kubeflow_tpu_torch.api.inference import GangSpec, InferenceService
    from kubeflow_tpu_torch.serving.controller import (
        InferenceServiceController,
        _Deployment,
        _Revision,
    )

    isvc = InferenceService(metadata=ObjectMeta(name="el2"))
    events: list = []

    class _DeadGang:
        gang = GangSpec(hosts=2, mesh_axes={"model": 8})
        ready = False

        def stop(self):
            raise AssertionError("must not re-place below min_degree")

    dep = _Deployment()
    dep.stable = _Revision(1, "fp", isvc.spec, None, {})
    dep.stable.predictors = [_DeadGang()]
    InferenceServiceController._escalate_shrink(
        _controller_stub(None, events), isvc, dep, {"min_degree": 8})
    assert [r for r, _ in events] == ["ResizeSkipped"]


def test_tp_resize_actuator_refuses_naming_its_item():
    """(Named when the actuator was refused.) The autoscaler's TP-degree
    actuator posts the decision to every serving gang of the stable
    revision and skips in-process replicas (one card, degree 1). It
    raises, so the loop's retry budget sees a decision the fleet cannot
    act on: when nothing resized, when a gang refused a target above its
    live members, and when a resize aborted with the old degree resumed;
    a resize emits ``GangResized``."""
    from kubeflow_tpu_torch.api.common import ObjectMeta
    from kubeflow_tpu_torch.api.inference import InferenceService
    from kubeflow_tpu_torch.serving.controller import (
        InferenceServiceController,
        _Deployment,
        _Revision,
    )

    isvc = InferenceService(metadata=ObjectMeta(name="act"))
    act = InferenceServiceController._resize_replicas_to_degree

    class _InProcess:  # a ModelServer replica: no resize_to_degree
        pass

    class _Gang:
        def __init__(self, answer):
            self.answer = answer

        def resize_to_degree(self, degree):
            if isinstance(self.answer, Exception):
                raise self.answer
            return self.answer

    def run(*preds, degree=2):
        events: list = []
        dep = _Deployment()
        dep.stable = _Revision(1, "fp", isvc.spec, None, {})
        dep.stable.predictors = list(preds)
        act(_controller_stub(None, events), isvc, dep, degree)
        return events

    for preds in ((), (_InProcess(),), (_InProcess(), _Gang(False))):
        with pytest.raises(RuntimeError, match="no replica engine accepted"):
            run(*preds)
    above = RuntimeError("gang resize to TP degree 3 refused (409): target "
                         "TP degree 3 is above the gang's 2 live members")
    aborted = RuntimeError("gang resize to TP degree 1 refused (409): "
                           "resize to 1 aborted, degree 2 resumed in place")
    for err in (above, aborted):
        with pytest.raises(RuntimeError, match="failed on a replica") as e:
            run(_Gang(True), _Gang(err))
        assert e.value.__cause__ is err
    events = run(_InProcess(), _Gang(True), _Gang(True), degree=1)
    assert events == [("GangResized", "2 serving gang(s) resized to TP "
                       "degree 1 by the autoscaler")]


def test_resize_route_guards_and_refusals():
    """Rank 0's resize route (``gang.resize_route``): the gang token
    guards it; a degree below 1, an engine without the paged pool, a
    target above the live members and an aborted resize are refused; a
    resize answers both degrees and caps the supervisor's grow-back."""
    from kubeflow_tpu_torch.serving import gang
    from kubeflow_tpu_torch.serving.resize import ResizeAborted

    class _Channel:
        def follower_ranks(self):
            return [1]

    class _Resizer:
        def __init__(self, fail=False):
            self.d, self.fail = 2, fail

        def degree(self):
            return self.d

        def resize_to_degree(self, d):
            if self.fail:
                raise ResizeAborted("export")
            self.d = d

    class _Supervisor:
        max_degree = 2

    good = {gang.TOKEN_HEADER: "tok"}
    sup = _Supervisor()
    route = gang.resize_route(_Resizer(), _Channel(), "tok", sup)
    assert route({"degree": 1}, {gang.TOKEN_HEADER: "nope"})[0] == 403
    assert route({"degree": 1}, {})[0] == 403
    assert route({"degree": 0}, good)[0] == 400
    assert route({}, good)[0] == 400
    code, body = route({"degree": 3}, good)
    assert code == 409 and "above the gang's 2 live members" in body["error"]
    assert route({"degree": 1}, good) == (
        200, {"from": 2, "degree": 1, "resized": True})
    assert sup.max_degree == 1
    assert route({"degree": 1}, good) == (
        200, {"from": 1, "degree": 1, "resized": False})
    code, body = gang.resize_route(_Resizer(fail=True), _Channel(), "tok")(
        {"degree": 1}, good)
    assert code == 409 and "degree 2 resumed in place" in body["error"]
    code, body = gang.resize_route(None, _Channel(), "tok")(
        {"degree": 1}, good)
    assert code == 409 and "paged pool" in body["error"]

def test_tp_resize_actuator_skips_a_gang_with_an_expert_axis():
    """A serving gang on ``{"expert": 2, "model": 2}`` is not TP-resizable
    (``_GangPredictor.tp_resizable``): the actuator skips it as it skips
    an in-process replica, so with nothing else to resize it raises."""
    import math
    import types

    from kubeflow_tpu_torch.api.common import ObjectMeta
    from kubeflow_tpu_torch.api.inference import GangSpec, InferenceService
    from kubeflow_tpu_torch.serving.controller import (
        InferenceServiceController,
        _Deployment,
        _GangPredictor,
        _Revision,
    )

    def resizable(axes) -> bool:
        handle = types.SimpleNamespace(
            gang=GangSpec(hosts=1, chips_per_host=math.prod(axes.values()),
                          mesh_axes=axes))
        return _GangPredictor.tp_resizable.fget(handle)

    assert resizable({"model": 2})
    assert not resizable({"expert": 2, "model": 2})

    class _ExpertGang:
        tp_resizable = False

        def resize_to_degree(self, degree):
            raise AssertionError("an expert gang must not be posted to")

    isvc = InferenceService(metadata=ObjectMeta(name="ep"))
    dep = _Deployment()
    dep.stable = _Revision(1, "fp", isvc.spec, None, {})
    dep.stable.predictors = [_ExpertGang()]
    with pytest.raises(RuntimeError, match="no replica engine accepted"):
        InferenceServiceController._resize_replicas_to_degree(
            _controller_stub(None, []), isvc, dep, 2)
