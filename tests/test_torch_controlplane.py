"""The port's copies of ``api/`` and ``controlplane/`` against the
reference's, in one process.

- Every ``examples/*.yaml`` manifest and the manifests ``tests/test_api.py``
  builds load to equal ``model_dump()`` in both packages; defaulting and the
  YAML round trip agree too.
- The same bad manifests raise the same error types with equal messages.
- A durable store (snapshot + WAL) written by either package replays to the
  same objects and resourceVersion in both.
- The gang scheduler binds the same pods to the same nodes.

Both packages are imported inside the tests.
"""

import glob
import importlib
import os
import time

import pytest

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
    assert dumps[0] and dumps[1] == dumps[0]
    texts = [_api(p).dump_yaml(_api(p).load_yaml_file(path)) for p in PKGS]
    assert texts[1] == texts[0]


@pytest.mark.parametrize("name", ["camel", "user-data"] + list(MANIFESTS))
def test_test_api_manifest_dumps_equal(name):
    out = []
    for p in PKGS:
        api = _api(p)
        if name in ("camel", "user-data"):
            (obj,) = api.load_yaml(JAXJOB_CAMEL if name == "camel"
                                   else USER_DATA)
        else:
            obj = api.from_dict(MANIFESTS[name])
        if obj.kind == "JaxJob":
            api.default_jaxjob(obj)
            api.validate_jaxjob(obj)
            assert api.load_yaml(api.dump_yaml(obj))[0].spec == obj.spec
        out.append((obj.model_dump(), api.to_dict(obj), api.dump_yaml(obj)))
    assert out[1] == out[0]


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

        def job(replicas, tpu, mesh, api=api):
            return api.default_jaxjob(api.from_dict({
                "kind": "JaxJob", "metadata": {"name": "j"},
                "spec": {"replica_specs": {"worker": {
                    "replicas": replicas,
                    "template": {"resources": {"tpu": tpu}}}},
                    **({"mesh": mesh} if mesh else {})}}))
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
    assert errs[1] == errs[0]
    assert all("Error" in e[0] for e in errs[1])


def _durable_image(pkg, data_dir, write):
    """Open a durable store at ``data_dir`` (optionally writing the
    scenario first), close, reopen: (objects, last rv) after replay."""
    store_mod = importlib.import_module(f"{pkg}.controlplane.store")
    api = _api(pkg)
    if write:
        s = store_mod.Store.open(data_dir, fsync_every=4, snapshot_every=8)
        for name in ("jaxjob", "isvc", "runtime", "graph"):
            s.create(api.from_dict(MANIFESTS[name]))
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
    assert got == want
    assert len(got[0]) == 13
    # the log formats are one: each package replays the other's directory
    assert _durable_image("kubeflow_tpu_torch", ref_dir, write=False) == want
    assert _durable_image("kubeflow_tpu", port_dir, write=False) == got


def _placements(pkg):
    """Two gangs on two 2-host slices, with a job that cannot fit: the
    scheduler's node for every pod, and each group's phase."""
    cp = importlib.import_module(f"{pkg}.controlplane")
    objects = importlib.import_module(f"{pkg}.controlplane.objects")
    api = _api(pkg)
    c = cp.Cluster()
    c.add_tpu_slice("sa", num_hosts=2, chips_per_host=4)
    c.add_tpu_slice("sb", num_hosts=2, chips_per_host=4)
    jobs = {"packed": (2, 4), "half": (2, 2), "big": (4, 4)}
    with c:
        for name, (replicas, tpu) in jobs.items():
            c.store.create(api.from_dict({
                "kind": "JaxJob", "metadata": {"name": name},
                "spec": {"replica_specs": {"worker": {
                    "replicas": replicas, "template": {"resources": {
                        "cpu": 1, "memory_gb": 1, "tpu": tpu}}}}}}))
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
    # a gang lands on one slice (ICI before DCN); "big" needs 16 chips
    assert {pods["packed-worker-0"][:2], pods["packed-worker-1"][:2]} \
        in ({"sa"}, {"sb"})
    assert pods["big-worker-0"] is None
