"""The port's copies of ``api/`` and ``controlplane/`` against the
reference's, in one process.

The reference counts TPU chips (``resources.tpu``), the port NVIDIA cards
(``resources.gpu``): each package's side is written in its own words and
the reference's results are mapped into the port's before they are
compared (``tests/_torch_resources.py``).

- Every ``examples/*.yaml`` manifest and the manifests ``tests/test_api.py``
  builds load to equal ``model_dump()`` in both packages; defaulting and the
  YAML round trip agree too.
- The same bad manifests raise the same error types with equal messages.
- A durable store (snapshot + WAL) written by either package replays to the
  same objects and resourceVersion in both, and each replays the other's
  with the resource key mapped.
- The gang scheduler binds the same pods to the same nodes.
- The port's own: a spec asking for ``tpu`` is refused naming ``gpu``; a
  bound pod gets distinct card ids of its node, freed when it ends; a gang
  short of cards pends; the ids survive the store's replay.

Both packages are imported inside the tests.
"""

import glob
import importlib
import os
import time

import pytest

from tests._torch_resources import (
    add_hosts,
    as_port,
    as_ref,
    in_vocab,
    text_as_port,
    translate_store,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("kubeflow_tpu", "kubeflow_tpu_torch")

#: ``tests/test_api.py``'s manifests, as dicts
JAXJOB_CAMEL = """
apiVersion: kubeflow-tpu.dev/v1
kind: JaxJob
metadata:
  name: mnist-smoke
spec:
  runPolicy:
    backoffLimit: 2
  replicaSpecs:
    worker:
      replicas: 2
      template:
        entrypoint: kubeflow_tpu.models.mnist:train_main
        resources:
          tpu: 0
"""
USER_DATA = """
kind: JaxJob
metadata:
  name: envy
  labels:
    myTeam: alpha
spec:
  replicaSpecs:
    worker:
      replicas: 2
      template:
        env:
          MY_FLAG: "1"
          someCamelVar: "x"
  mesh:
    data: 2
"""
MANIFESTS = {
    "jaxjob": {"kind": "JaxJob", "metadata": {"name": "llama-ft"},
               "spec": {"replica_specs": {"worker": {
                   "replicas": 4, "template": {"resources": {"tpu": 4}}}},
                   "mesh": {"data": 2, "model": 8}}},
    "experiment": {"kind": "Experiment", "metadata": {"name": "sweep"},
                   "spec": {"parameters": [{
                       "name": "lr", "parameter_type": "double",
                       "feasible_space": {"min": 1e-4, "max": 1e-1}}]}},
    "isvc": {"kind": "InferenceService", "metadata": {"name": "svc"},
             "spec": {"predictor": {
                 "model_format": {"name": "text-llm"}, "min_replicas": 2,
                 "max_replicas": 3, "config": {"block_size": 16}},
                 "canary_traffic_percent": 20}},
    "runtime": {"kind": "ServingRuntime", "metadata": {"name": "rt"},
                "spec": {"supported_model_formats": [
                    {"name": "jax", "priority": 9, "auto_select": True}],
                    "server_class": "x:Y"}},
    "graph": {"kind": "InferenceGraph", "metadata": {"name": "g"},
              "spec": {"nodes": {"root": {"router_type": "Sequence", "steps": [
                  {"service_name": "a"}, {"service_name": "b"}]}}}},
    "profile": {"kind": "Profile", "metadata": {"name": "team"},
                "spec": {"qos": {"rate": 5, "priority": "high"}}},
}

#: manifests each package must refuse, with the same error
BAD = {
    "unknown-kind": {"kind": "PyTorchJob", "metadata": {"name": "x"}},
    "no-kind": {"metadata": {"name": "x"}},
    "extra-field": {"kind": "InferenceService", "metadata": {"name": "x"},
                    "spec": {"predictor": {"bogus": 1}}},
    "bad-canary": {"kind": "InferenceService", "metadata": {"name": "x"},
                   "spec": {"predictor": {"model_format": {"name": "echo"}},
                            "canary_traffic_percent": 150}},
    "bad-gang-mesh": {"kind": "InferenceService", "metadata": {"name": "x"},
                      "spec": {"predictor": {"gang": {
                          "hosts": 2, "mesh_axes": {"model": 3}}}}},
    "bad-logger": {"kind": "InferenceService", "metadata": {"name": "x"},
                   "spec": {"predictor": {"logger": {"url": "http://x",
                                                     "mode": "some"}}}},
    "bad-name": {"kind": "JaxJob", "metadata": {"name": "Bad_Name"},
                 "spec": {"replica_specs": {"worker": {"replicas": 1}}}},
}


def _api(pkg):
    # the control plane's object kinds join the api's kind registry when
    # it is imported (an unknown kind's error lists the registry)
    importlib.import_module(f"{pkg}.controlplane.objects")
    return importlib.import_module(f"{pkg}.api")


def _stable(d):
    """A dump without the per-process identity (uid, timestamps)."""
    if isinstance(d, dict):
        return {k: _stable(v) for k, v in d.items()
                if k not in ("uid", "creation_timestamp")}
    if isinstance(d, list):
        return [_stable(v) for v in d]
    return d


EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*.yaml")))


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_example_manifest_loads_equal(path):
    dumps = [[o.model_dump() for o in _api(p).load_yaml_file(path)]
             for p in PKGS]
    assert dumps[0] and dumps[1] == as_port(dumps[0])
    texts = [_api(p).dump_yaml(_api(p).load_yaml_file(path)) for p in PKGS]
    assert texts[1] == text_as_port(texts[0])


@pytest.mark.parametrize("name", ["camel", "user-data"] + list(MANIFESTS))
def test_test_api_manifest_dumps_equal(name):
    out = []
    for p in PKGS:
        api = _api(p)
        if name in ("camel", "user-data"):
            text = JAXJOB_CAMEL if name == "camel" else USER_DATA
            (obj,) = api.load_yaml(text if p == PKGS[0]
                                   else text_as_port(text))
        else:
            obj = api.from_dict(in_vocab(p, MANIFESTS[name]))
        if obj.kind == "JaxJob":
            api.default_jaxjob(obj)
            api.validate_jaxjob(obj)
            assert api.load_yaml(api.dump_yaml(obj))[0].spec == obj.spec
        out.append((obj.model_dump(), api.to_dict(obj), api.dump_yaml(obj)))
    assert out[1][:2] == as_port(out[0][:2])
    assert out[1][2] == text_as_port(out[0][2])


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return type(e).__name__, str(e)
    raise AssertionError("no error raised")


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_manifest_errors_equal(name):
    errs = []
    for p in PKGS:
        api = _api(p)

        def load(api=api):
            obj = api.from_dict(BAD[name])
            if obj.kind == "JaxJob":
                api.validate_jaxjob(api.default_jaxjob(obj))
        errs.append(_error(load))
    assert errs[1] == errs[0]


def test_validation_errors_equal():
    """test_api.py's validators: zero workers, a mesh that does not match
    the chips, an experiment with no trial template; an InferenceService
    with no predictor source or an unknown storage scheme."""
    errs = []
    for p in PKGS:
        api = _api(p)

        def job(replicas, tpu, mesh, api=api, p=p):
            return api.default_jaxjob(api.from_dict(in_vocab(p, {
                "kind": "JaxJob", "metadata": {"name": "j"},
                "spec": {"replica_specs": {"worker": {
                    "replicas": replicas,
                    "template": {"resources": {"tpu": tpu}}}},
                    **({"mesh": mesh} if mesh else {})}})))
        exp = api.from_dict(MANIFESTS["experiment"])
        errs.append([
            _error(lambda: api.validate_jaxjob(job(0, 0, None))),
            _error(lambda: api.validate_jaxjob(job(2, 4, {"data": 3}))),
            _error(lambda: api.validate_experiment(exp)),
            _error(lambda: api.validate_inference_service(api.from_dict({
                "kind": "InferenceService", "metadata": {"name": "x"},
                "spec": {"predictor": {}}}))),
            _error(lambda: api.validate_inference_service(api.from_dict({
                "kind": "InferenceService", "metadata": {"name": "x"},
                "spec": {"predictor": {"handler": "a:B",
                                       "storage_uri": "ftp://x"}}}))),
        ])
    # the mesh's refusal counts the port's devices as cards
    want = [(t, m.replace(" chips)", " cards)")) for t, m in errs[0]]
    assert errs[1] == want
    assert all("Error" in e[0] for e in errs[1])


def _durable_image(pkg, data_dir, write):
    """Open a durable store at ``data_dir`` (optionally writing the
    scenario first), close, reopen: (objects, last rv) after replay."""
    store_mod = importlib.import_module(f"{pkg}.controlplane.store")
    api = _api(pkg)
    if write:
        s = store_mod.Store.open(data_dir, fsync_every=4, snapshot_every=8)
        for name in ("jaxjob", "isvc", "runtime", "graph"):
            s.create(api.from_dict(in_vocab(pkg, MANIFESTS[name])))
        for i in range(10):  # past snapshot_every: snapshot + log replay
            s.create(api.from_dict({"kind": "ServingRuntime",
                                    "metadata": {"name": f"rt-{i}"},
                                    "spec": {"server_class": "x:Y"}}))
        s.delete("ServingRuntime", "rt-3")
        s.update_with_retry(
            "InferenceService", "svc", "default",
            lambda o: o.metadata.labels.update({"touched": "yes"}))
        s.close()
    s = store_mod.Store.open(data_dir)
    try:
        objs = sorted(
            (o.kind, o.key, o.metadata.resource_version,
             _stable(api.to_dict(o)))
            for kind in ("JaxJob", "InferenceService", "ServingRuntime",
                         "InferenceGraph")
            for o in s.list(kind))
        return objs, s._last_rv
    finally:
        s.close()


def test_store_and_wal_round_trip_equal(tmp_path):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    want = _durable_image("kubeflow_tpu", ref_dir, write=True)
    got = _durable_image("kubeflow_tpu_torch", port_dir, write=True)
    assert got == as_port(want)
    assert len(got[0]) == 13
    # the log formats are one: each package replays the other's directory,
    # its resources in the replaying package's words
    ref_as_port = translate_store(ref_dir, str(tmp_path / "r2p"), as_port)
    port_as_ref = translate_store(port_dir, str(tmp_path / "p2r"), as_ref)
    assert _durable_image("kubeflow_tpu_torch", ref_as_port,
                          write=False) == got
    assert _durable_image("kubeflow_tpu", port_as_ref, write=False) == want


def _placements(pkg):
    """Two gangs on two 2-host slices, with a job that cannot fit: the
    scheduler's node for every pod, and each group's phase."""
    cp = importlib.import_module(f"{pkg}.controlplane")
    objects = importlib.import_module(f"{pkg}.controlplane.objects")
    api = _api(pkg)
    c = cp.Cluster()
    add_hosts(pkg, c, "sa", 2, 4)
    add_hosts(pkg, c, "sb", 2, 4)
    jobs = {"packed": (2, 4), "half": (2, 2), "big": (4, 4)}
    with c:
        for name, (replicas, tpu) in jobs.items():
            c.store.create(api.from_dict(in_vocab(pkg, {
                "kind": "JaxJob", "metadata": {"name": name},
                "spec": {"replica_specs": {"worker": {
                    "replicas": replicas, "template": {"resources": {
                        "cpu": 1, "memory_gb": 1, "tpu": tpu}}}}}})))
            # one gang at a time: placement depends on what is bound
            deadline = time.time() + 10
            while time.time() < deadline:
                pods = c.store.list(objects.KIND_POD,
                                    labels={objects.LABEL_JOB_NAME: name})
                if len(pods) == replicas and (
                        name == "big" or all(p.spec.node_name for p in pods)):
                    break
                time.sleep(0.02)
        time.sleep(0.3)  # let "big" try and stay pending
        return sorted(
            (p.metadata.name, p.spec.node_name)
            for p in c.store.list(objects.KIND_POD)), sorted(
            (g.metadata.name, str(g.status.phase))
            for g in c.store.list(objects.KIND_PODGROUP))


def test_gang_scheduler_placements_equal():
    want = _placements("kubeflow_tpu")
    got = _placements("kubeflow_tpu_torch")
    assert got == want
    pods = dict(got[0])
    # a gang lands on one slice or NVLink domain; "big" needs 16 cards
    assert {pods["packed-worker-0"][:2], pods["packed-worker-1"][:2]} \
        in ({"sa"}, {"sb"})
    assert pods["big-worker-0"] is None


# -- the port's cards -------------------------------------------------------


def test_a_spec_asking_for_tpu_is_refused_naming_gpu(tmp_path):
    """The port has no TPU to give: ``tpu`` (or a topology) in a spec, or a
    quota capping ``tpu``, is refused where it is parsed, naming ``gpu``,
    over the API server too; it is never read as cards."""
    import json
    import urllib.error
    import urllib.request

    api = _api("kubeflow_tpu_torch")
    cp = importlib.import_module("kubeflow_tpu_torch.controlplane")
    job = {"kind": "JaxJob", "metadata": {"name": "t"},
           "spec": {"replica_specs": {"worker": {
               "replicas": 1, "template": {"resources": {"tpu": 4}}}}}}
    topo = {"kind": "JaxJob", "metadata": {"name": "t"},
            "spec": {"replica_specs": {"worker": {"template": {"resources": {
                "tpu_topology": {"shape": "2x2"}}}}}}}
    quota = {"kind": "Profile", "metadata": {"name": "team"},
             "spec": {"resource_quota": {"tpu": 4}}}
    for manifest in (job, topo, quota):
        with pytest.raises(ValueError, match="gpu"):
            api.from_dict(manifest)
    with pytest.raises(ValueError, match="resources.gpu"):
        api.load_yaml(JAXJOB_CAMEL)
    c = cp.Cluster()
    add_hosts("kubeflow_tpu_torch", c, "d0", 1, 4)
    with c:
        url = c.serve_api()
        req = urllib.request.Request(
            url + "/apis/jaxjobs", data=json.dumps(job).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 400
        assert "resources.gpu" in json.loads(err.value.read())["error"]
        assert c.store.list("JaxJob") == []


def _card_cluster(data_dir=None):
    """A port cluster of one host of 4 cards, ids ``[0, 1, 2, 3]``, with a
    fake kubelet: a pod named ``*-done-*`` succeeds at once, others run
    until deleted."""
    cp = importlib.import_module("kubeflow_tpu_torch.controlplane")
    fk = importlib.import_module("kubeflow_tpu_torch.controlplane.fake_kubelet")
    c = cp.Cluster(data_dir=data_dir)
    c.add_gpu_host("h0", 4)
    kubelet = fk.FakeKubelet(c.store, lambda pod: fk.PodScript(
        hang="-done-" not in pod.metadata.name))
    return c, kubelet


def _gpu_job(name, replicas, gpu):
    return _api("kubeflow_tpu_torch").from_dict({
        "kind": "JaxJob", "metadata": {"name": name},
        "spec": {"replica_specs": {"worker": {
            "replicas": replicas, "template": {"resources": {
                "cpu": 1, "memory_gb": 1, "gpu": gpu}}}}}})


def _wait_for(fn, what, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _pod_ids(c, job):
    pods = c.store.list("Pod", labels={"job-name": job})
    if pods and all(p.spec.node_name for p in pods):
        return sorted(p.spec.device_ids for p in pods)
    return None


def test_bound_pods_own_distinct_cards_freed_when_they_end():
    """The scheduler hands each pod as many free ids of its node as it
    asks cards: distinct across live pods, none for a pod asking none; a
    pod's ids are free again once it ended or its job was deleted; a gang
    short of cards pends whole with the scheduler's reason."""
    c, kubelet = _card_cluster()
    with c:
        kubelet.start()
        try:
            c.store.create(_gpu_job("a", 1, 2))
            c.store.create(_gpu_job("b", 1, 1))
            c.store.create(_gpu_job("cpu", 1, 0))
            a = _wait_for(lambda: _pod_ids(c, "a"), "a bound")
            b = _wait_for(lambda: _pod_ids(c, "b"), "b bound")
            assert _wait_for(lambda: _pod_ids(c, "cpu") is not None
                             and _pod_ids(c, "cpu"), "cpu bound") == [[]]
            assert len(a[0]) == 2 and len(b[0]) == 1
            assert not set(a[0]) & set(b[0])
            # the last card runs a pod that ends at once
            c.store.create(_gpu_job("d-done", 1, 1))
            d = _wait_for(lambda: _pod_ids(c, "d-done"), "d-done bound")
            assert set(d[0]) == {0, 1, 2, 3} - set(a[0]) - set(b[0])
            _wait_for(lambda: c.store.get("Pod", "d-done-worker-0").terminal,
                      "d-done finished")
            # a gang of three one-card pods needs d's card and a's two
            c.store.create(_gpu_job("g", 3, 1))
            _wait_for(lambda: (x := c.store.try_get("PodGroup", "g"))
                      and x.status.message == "insufficient capacity",
                      "g pending")
            c.store.delete("JaxJob", "a")
            g = _wait_for(lambda: _pod_ids(c, "g"), "g bound")
            assert sorted(i for ids in g + b for i in ids) == [0, 1, 2, 3]
            # no card is left: a gang of two pends whole, with the reason
            c.store.create(_gpu_job("short", 2, 1))
            pg = _wait_for(lambda: (x := c.store.try_get("PodGroup", "short"))
                           and x.status.message == "insufficient capacity"
                           and x, "short pending")
            assert str(pg.status.phase.value) == "Pending"
            assert all(not p.spec.node_name for p in c.store.list(
                "Pod", labels={"job-name": "short"}))
            # deleting a live job frees its cards: the pending gang binds
            c.store.delete("JaxJob", "g")
            short = _wait_for(lambda: _pod_ids(c, "short"), "short bound")
            assert not {i for ids in short for i in ids} & set(b[0])
        finally:
            kubelet.stop()


def test_card_ids_survive_the_store_replay(tmp_path):
    """The ids are part of the binding: a durable store replays them, and
    the replayed scheduler counts them as held."""
    store_mod = importlib.import_module("kubeflow_tpu_torch.controlplane.store")
    sched = importlib.import_module("kubeflow_tpu_torch.controlplane.scheduler")
    data = str(tmp_path / "store")
    c, kubelet = _card_cluster(data)
    with c:
        kubelet.start()
        try:
            c.store.create(_gpu_job("live", 1, 3))
            held = _wait_for(lambda: _pod_ids(c, "live"), "live bound")
        finally:
            kubelet.stop()
    c.store.close()
    s = store_mod.Store.open(data)
    try:
        pod = s.get("Pod", "live-worker-0")
        assert [sorted(pod.spec.device_ids)] == held
        free = sched.GangScheduler(s)._free_ids_by_node()
        assert free == {"h0": sorted(set(range(4)) - set(held[0]))}
    finally:
        s.close()
