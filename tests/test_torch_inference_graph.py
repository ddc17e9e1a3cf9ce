"""InferenceGraphs on the port's control plane against the reference's: the
same Sequence, Switch, Ensemble and Splitter graphs over ``echo`` services
(and a doubling service, so a step's effect shows) give equal responses and
equal status codes in both packages. Both packages are imported inside the
tests.
"""

import importlib
import json
import time
import urllib.error
import urllib.request

import pytest

from tests._torch_resources import add_hosts

PKGS = ("kubeflow_tpu", "kubeflow_tpu_torch")


def __getattr__(name):
    """``RefDouble`` / ``PortDouble``: doubles every instance, on each
    package's ``Model``; built at the controller's first lookup."""
    if name not in ("RefDouble", "PortDouble"):
        raise AttributeError(name)
    pkg = PKGS[name == "PortDouble"]
    base = importlib.import_module(f"{pkg}.serving.model").Model

    def predict_batch(self, instances):
        return [x * 2 for x in instances]

    cls = type(name, (base,), {"predict_batch": predict_batch,
                               "__module__": __name__})
    globals()[name] = cls
    return cls


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait(cluster, kind, name, phase="Ready", timeout=30):
    deadline = time.time() + timeout
    obj = None
    while time.time() < deadline:
        obj = cluster.store.try_get(kind, name)
        if obj is not None and str(obj.status.phase.value) == phase:
            return obj
        time.sleep(0.05)
    raise AssertionError(f"{kind} {name} never {phase}")


@pytest.fixture(scope="module")
def clusters():
    """[(package, started Cluster with services "echo" and "dbl")]."""
    out = []
    try:
        for pkg in PKGS:
            cp = importlib.import_module(f"{pkg}.controlplane")
            api = importlib.import_module(f"{pkg}.api")
            c = cp.Cluster()
            add_hosts(pkg, c, "slice-0", 1, 4)
            c.enable_serving()
            c.start()
            out.append((pkg, c))
            double = "PortDouble" if pkg == PKGS[1] else "RefDouble"
            for name, pred in (
                    ("echo", {"model_format": {"name": "echo"}}),
                    ("dbl", {"handler":
                             f"tests.test_torch_inference_graph:{double}"})):
                c.store.create(api.from_dict({
                    "kind": "InferenceService", "metadata": {"name": name},
                    "spec": {"predictor": pred}}))
            for name in ("echo", "dbl"):
                _wait(c, "InferenceService", name)
        yield out
    finally:
        for _, c in out:
            c.stop()


#: graph nodes and the requests sent through each graph
GRAPHS = {
    "sequence": ({"root": {"router_type": "Sequence", "steps": [
        {"service_name": "echo"}, {"service_name": "dbl"},
        {"service_name": "echo"}]}},
        [{"instances": [1, 2, 3]}]),
    "nested": ({"root": {"router_type": "Sequence", "steps": [
        {"node_name": "twice"},
        {"service_name": "echo", "data": "$request"}]},
        "twice": {"router_type": "Sequence", "steps": [
            {"service_name": "dbl"}, {"service_name": "dbl"}]}},
        [{"instances": [5]}]),
    "switch": ({"root": {"router_type": "Switch", "steps": [
        {"service_name": "echo", "condition": "op == echo"},
        {"service_name": "dbl", "condition": "op == dbl"}]}},
        [{"op": "echo", "instances": [10]}, {"op": "dbl", "instances": [10]},
         {"op": "nope", "instances": [10]}]),
    "ensemble": ({"root": {"router_type": "Ensemble", "steps": [
        {"service_name": "echo"}, {"service_name": "dbl"}]}},
        [{"instances": [3, 4]}]),
    "splitter": ({"root": {"router_type": "Splitter", "steps": [
        {"service_name": "echo", "weight": 0},
        {"service_name": "dbl", "weight": 100}]}},
        [{"instances": [3]}] * 3),
    "unknown-router": ({"root": {"router_type": "Mystery", "steps": [
        {"service_name": "echo"}]}},
        [{"instances": [1]}]),
}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_graph_responses_equal(clusters, graph):
    nodes, requests = GRAPHS[graph]
    out = []
    for pkg, c in clusters:
        api = importlib.import_module(f"{pkg}.api")
        c.store.create(api.from_dict({
            "kind": "InferenceGraph", "metadata": {"name": graph},
            "spec": {"nodes": nodes}}))
        g = _wait(c, "InferenceGraph", graph)
        out.append([_post(g.status.url, body) for body in requests])
    assert out[1] == out[0]
    assert out[1][0][0] == (500 if graph == "unknown-router" else 200)


def test_missing_root_fails_equal(clusters):
    msgs = []
    for pkg, c in clusters:
        api = importlib.import_module(f"{pkg}.api")
        c.store.create(api.from_dict({
            "kind": "InferenceGraph", "metadata": {"name": "broken"},
            "spec": {"nodes": {"notroot": {"steps": [
                {"service_name": "echo"}]}}}}))
        msgs.append(_wait(c, "InferenceGraph", "broken",
                          "Failed").status.message)
    assert msgs[1] == msgs[0] and "root" in msgs[1]
