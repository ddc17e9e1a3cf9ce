"""InferenceServices on the port's control plane against the reference's.

One reference ``Cluster`` and one port ``Cluster`` (``enable_serving``) run
side by side for the module; the same manifests, as dicts through each
package's ``api``, go to both, and both read the same ``tiny()`` weights from
their own ``mem://`` registries (the port's replicas with ``"device":
"cpu"``).

- ``text-llm``, ``llama-continuous``, ``llm`` and ``echo`` services serve
  exactly equal greedy texts through each package's Router (f32, greedy).
- An unknown format, bad engine knobs and a bad ``qos`` each end in one
  Failed status whose message equals the reference's.
- Scale to zero and activation, canary split / promote / rollback (as
  ``tests/test_serving.py::TestCanaryRollout``), delete tears down: the same
  observable behaviour in both.
- What the port refuses: a ServingRuntime naming a ``kubeflow_tpu.`` class
  (the message names the port's class). A bad ``aot`` block (A12) is one
  Failed status with the reference's message, and a good one serves
  through the program-artifact cache. A ``gang`` predictor
  and an in-process one with ``mesh_axes`` (ROADMAP A7) are placed as a
  JaxJob of ``serving.gang:serve_main`` pods, one for each rank.
- A burst of 32 connections opened at once is answered within 0.9 s each by
  a port ``ModelServer`` and a port ``Router`` (the listen backlog).

torch and both packages are imported inside the tests. The reference's
engines run without warmup (each shape compiles at first use).
"""

import importlib
import json
import math
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests._torch_resources import add_hosts
from tests.test_torch_text_server import BASE, register_both, tiny_weights

PKGS = ("kubeflow_tpu", "kubeflow_tpu_torch")
WAIT_S = 60

#: serving configs by format (the port's replicas add "device": "cpu")
CONFIGS = {
    "text-llm": {**BASE, "max_new_tokens": 6},
    "llama-continuous": {"num_slots": 4, "decode_chunk": 2,
                         "max_new_tokens": 5, "prefix_cache": False},
    "llm": {"max_new_tokens": 5},
    "echo": {},
}


def __getattr__(name):
    """``RefTag`` / ``PortTag``: a model that answers with its config's
    ``tag``, each on its package's ``Model``; ``PortSlowEcho``: an echo
    whose load sleeps ``load_s``. Built at first lookup (the controller's
    ``resolve_class``), so importing this module loads neither package."""
    if name not in ("RefTag", "PortTag", "PortSlowEcho"):
        raise AttributeError(name)
    pkg = PKGS[name != "RefTag"]
    base = importlib.import_module(f"{pkg}.serving.model").Model

    def predict_batch(self, instances):
        return [self.config["tag"]] * len(instances)

    def load(self):  # a cold start longer than the idle window
        time.sleep(self.config["load_s"])
        self.ready = True

    body = ({"load": load, "predict_batch": lambda self, x: x}
            if name == "PortSlowEcho" else {"predict_batch": predict_batch})
    cls = type(name, (base,), {**body, "__module__": __name__})
    globals()[name] = cls
    return cls


def _post(url, payload, timeout=WAIT_S):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture(scope="module")
def clusters():
    """[(package, started Cluster, its mem:// weights key)] for both."""
    import torch

    torch.set_num_threads(1)
    keys = register_both(tiny_weights(), "torch-isvc")
    out = []
    try:
        for pkg, key in zip(PKGS, keys):
            cp = importlib.import_module(f"{pkg}.controlplane")
            c = cp.Cluster()
            add_hosts(pkg, c, "slice-0", 1, 4)
            c.enable_serving()
            c.start()
            out.append((pkg, c, key))
        yield out
    finally:
        for _, c, _ in out:
            c.stop()


def _apply(pkg, cluster, manifest):
    api = importlib.import_module(f"{pkg}.api")
    return cluster.store.create(api.from_dict(manifest))


def _isvc(pkg, key, name, fmt, **pred):
    """An InferenceService manifest serving ``fmt`` over the weights."""
    config = dict(CONFIGS.get(fmt, {}))
    if fmt != "echo":
        config["params_ref"] = key
    if pkg == "kubeflow_tpu_torch":
        config["device"] = "cpu"
    elif fmt in ("text-llm", "llama-continuous"):
        config["warmup_groups"] = []
    config.update(pred.pop("config", {}))
    return {"kind": "InferenceService", "metadata": {"name": name},
            "spec": {"predictor": {"model_format": {"name": fmt},
                                   "min_replicas": 1, "max_replicas": 2,
                                   "config": config, **pred}}}


def _wait(cluster, name, phase="Ready", timeout=WAIT_S, cond=None):
    deadline = time.time() + timeout
    obj = None
    while time.time() < deadline:
        obj = cluster.store.try_get("InferenceService", name)
        if obj is not None and str(obj.status.phase.value) == phase and (
                cond is None or cond(obj)):
            return obj
        time.sleep(0.05)
    raise AssertionError(
        f"{name} never {phase}: {obj.status if obj else None}")


def _both(clusters, name, fmt, **pred):
    """Apply the service to both clusters, then wait for both Ready."""
    for pkg, c, key in clusters:
        _apply(pkg, c, _isvc(pkg, key, name, fmt, **pred))
    return [_wait(c, name) for _, c, _ in clusters]


REQUESTS = {
    "text-llm": ("/openai/v1/completions",
                 [{"prompt": p, "max_tokens": 6}
                  for p in ("hello world", "the port serves",
                            "a prompt longer than one chunk of 16")]),
    "llama-continuous": ("/v1/models/{name}:predict",
                         [{"instances": [[1, 2, 3], [4, 5, 6, 7, 8]]},
                          {"instances": [[9] * 20]}]),
    "llm": ("/v1/models/{name}:predict",
            [{"instances": [[1, 2, 3], [4, 5, 6, 7, 8], []]},
             {"instances": [[17, 3, 99, 4]]}]),
    "echo": ("/v1/models/{name}:predict", [{"instances": [1, [2, 3]]}]),
}


def _answers(isvc, name, fmt):
    path, bodies = REQUESTS[fmt]
    out = []
    for body in bodies:
        code, got = _post(isvc.status.url + path.format(name=name),
                          {"model": name, **body})
        assert code == 200, got
        out.append([c["text"] for c in got["choices"]]
                   if fmt == "text-llm" else got["predictions"])
    return out


@pytest.mark.parametrize("fmt", list(REQUESTS))
def test_greedy_texts_equal_through_router(clusters, fmt):
    name = f"svc-{fmt}"
    ref, port = _both(clusters, name, fmt)
    assert port.status.url != ref.status.url
    want, got = _answers(ref, name, fmt), _answers(port, name, fmt)
    assert got == want
    if fmt == "text-llm":
        assert all(t for texts in got for t in texts)
    # the port's replica is the port's class, on the CPU as configured
    server = _replicas(clusters[1][1], name)[0]
    model = server.models()[name]
    assert type(model).__module__.startswith("kubeflow_tpu_torch.")
    engine = getattr(model, "engine", None)
    if engine is not None:
        assert engine.stats()["graph_captures_total"] == 0
    for _, c, _ in clusters:
        c.store.try_delete("InferenceService", name)


def _replicas(cluster, name):
    ctl = next(c for c in cluster.controllers
               if type(c).__name__ == "InferenceServiceController")
    dep = ctl._deployments[f"default/{name}"]
    return [s for rev in dep.revisions for s in rev.predictors]


#: (format, predictor config) whose reconcile must end Failed
BAD = {
    "unknown-format": ("mystery", {}),
    "prefill-budget": ("llama-continuous", {"prefill_budget": -1}),
    "role": ("llama-continuous", {"role": "x", "block_size": 16}),
    "qos": ("text-llm", {"qos": {"gold": {"rate": -3}}}),
}


@pytest.mark.parametrize("case", list(BAD))
def test_bad_manifest_fails_with_reference_message(clusters, case):
    fmt, config = BAD[case]
    name = f"bad-{case}"
    for pkg, c, key in clusters:
        _apply(pkg, c, _isvc(pkg, key, name, fmt, config=config))
    msgs = [_wait(c, name, "Failed").status.message for _, c, _ in clusters]
    assert msgs[1] == msgs[0]
    assert msgs[1]


def test_scale_to_zero_then_activation(clusters):
    """A request wakes the min_replicas 0 service; after the idle window
    it scales back to zero; the next request activates a replica again."""
    for pkg, c, key in clusters:
        _apply(pkg, c, _isvc(pkg, key, "zero", "echo", min_replicas=0))
    out = []
    for _, c, _ in clusters:
        url = _wait(c, "zero").status.url + "/v1/models/zero:predict"
        seen = [_post(url, {"instances": [6]})]
        _wait(c, "zero", cond=lambda o: o.status.active_replicas == 1)
        _wait(c, "zero", timeout=30,
              cond=lambda o: o.status.active_replicas == 0)
        seen.append(_post(url, {"instances": [7]}))
        _wait(c, "zero", cond=lambda o: o.status.active_replicas == 1)
        out.append(seen)
    assert out[1] == out[0] == [(200, {"predictions": [6]}),
                                (200, {"predictions": [7]})]


def test_slow_cold_start_is_not_scaled_away(clusters):
    """A replica whose load outlasts the idle window serves the request
    that woke it and stays up past the response: the request waiting at
    the activator is demand, so the idle clock starts when it is routed,
    not when it arrived."""
    from kubeflow_tpu_torch.serving.controller import SCALE_IDLE_SECONDS

    pkg, c, _ = clusters[1]
    load_s = SCALE_IDLE_SECONDS + 0.5
    _apply(pkg, c, {"kind": "InferenceService", "metadata": {"name": "slow"},
                    "spec": {"predictor": {
                        "handler": "tests.test_torch_controller:PortSlowEcho",
                        "config": {"load_s": load_s}, "min_replicas": 0,
                        "max_replicas": 1}}})
    url = _wait(c, "slow").status.url
    t0 = time.time()
    assert _post(url + "/v1/models/slow:predict", {"instances": [3]}) == \
        (200, {"predictions": [3]})
    assert time.time() - t0 >= load_s
    deadline = time.time() + 1.0
    while time.time() < deadline:
        isvc = c.store.get("InferenceService", "slow")
        assert isvc.status.active_replicas == 1, "scaled away at once"
        time.sleep(0.05)
    _wait(c, "slow", timeout=30, cond=lambda o: o.status.active_replicas == 0)


def _tag_spec(pkg, tag):
    return {"predictor": {
        "handler": f"tests.test_torch_controller:"
                   f"{'PortTag' if pkg == PKGS[1] else 'RefTag'}",
        "config": {"tag": tag}, "min_replicas": 1, "max_replicas": 2}}


def _counts(url, name, n):
    got = {}
    for _ in range(n):
        code, out = _post(f"{url}/v1/models/{name}:predict",
                          {"instances": [0]})
        assert code == 200
        tag = out["predictions"][0]
        got[tag] = got.get(tag, 0) + 1
    return got


def _update(pkg, cluster, name, mut):
    api = importlib.import_module(f"{pkg}.api")

    def apply(o):
        merged = o.spec.model_dump(mode="json")
        mut(merged, o)
        o.spec = api.InferenceServiceSpec.model_validate(merged)
    cluster.store.update_with_retry("InferenceService", name, "default",
                                    apply)


def _events(pkg, cluster, name):
    ctl = importlib.import_module(f"{pkg}.controlplane.controller")
    return [e.reason for e in ctl.events_for(
        cluster.store, "InferenceService", name)]


def _canary(pkg, cluster, name, pct, finish):
    """Roll v2 out at ``pct``%, count the split, then ``finish``
    ("promote" or "rollback"): what each stage served, and the events."""
    _apply(pkg, cluster, {"kind": "InferenceService",
                          "metadata": {"name": name},
                          "spec": _tag_spec(pkg, "v1")})
    isvc = _wait(cluster, name)
    seen = [_counts(isvc.status.url, name, 10)]

    def rollout(merged, _):
        merged.update(_tag_spec(pkg, "v2"))
        merged["canary_traffic_percent"] = pct
    _update(pkg, cluster, name, rollout)
    isvc = _wait(cluster, name,
                 cond=lambda o: o.status.canary_revision is not None)
    seen.append((isvc.status.canary_revision, isvc.status.canary_traffic,
                 _counts(isvc.status.url, name, 50)))
    if finish == "promote":
        def done(merged, _):
            merged["canary_traffic_percent"] = None
        want_rev = 2
    else:
        def done(merged, o):
            merged.clear()
            merged.update(o.status.stable_spec)
            merged["canary_traffic_percent"] = None
        want_rev = 1
    _update(pkg, cluster, name, done)
    isvc = _wait(cluster, name, cond=lambda o: (
        o.status.canary_revision is None
        and o.status.stable_revision == want_rev
        and o.status.active_replicas == 1))
    seen.append(_counts(isvc.status.url, name, 10))
    return seen, [e for e in _events(pkg, cluster, name)
                  if e.startswith("Canary")]


@pytest.mark.parametrize("finish,pct", [("promote", 20), ("rollback", 50)])
def test_canary_split_and_finish(clusters, finish, pct):
    name = f"roll-{finish}"
    ref, port = (_canary(pkg, c, name, pct, finish) for pkg, c, _ in clusters)
    assert port == ref
    seen, events = port
    assert seen[0] == {"v1": 10}
    assert seen[1][:2] == (2, pct)
    assert seen[1][2]["v2"] == pct // 2  # 50 requests, weighted WRR
    assert seen[2] == ({"v2": 10} if finish == "promote" else {"v1": 10})
    assert events == ["CanaryDeployed", "CanaryPromoted" if finish ==
                      "promote" else "CanaryRolledBack"]


def test_delete_tears_down(clusters):
    urls = [isvc.status.url for isvc in _both(clusters, "gone", "echo")]
    for (_, c, _), url in zip(clusters, urls):
        c.store.try_delete("InferenceService", "gone")
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                _post(f"{url}/v1/models/gone:predict", {"instances": [1]},
                      timeout=2)
            except OSError:
                break
            time.sleep(0.1)
        else:
            raise AssertionError("router still serving after delete")


def test_reference_class_path_refused(clusters):
    pkg, c, key = clusters[1]
    _apply(pkg, c, {"kind": "ServingRuntime", "metadata": {"name": "ref-rt"},
                    "spec": {"supported_model_formats": [{"name": "refecho"}],
                             "server_class":
                                 "kubeflow_tpu.serving.runtimes:EchoModel"}})
    _apply(pkg, c, _isvc(pkg, key, "refcls", "echo",
                         model_format=None, runtime="ref-rt"))
    msg = _wait(c, "refcls", "Failed").status.message
    assert "kubeflow_tpu_torch.serving.runtimes:EchoModel" in msg
    assert msg.startswith("ValueError")


UNPORTED = {
    "gang": ({"gang": {"hosts": 2, "mesh_axes": {"model": 8},
                       "chips_per_host": 4}}, "A7"),
    "mesh_axes": ({"config": {"mesh_axes": {"model": 2}}}, "A7"),
    "aot": ({"config": {"aot": {"root": "/nonexistent"}}}, "A12"),
}
#: the reference's ``test_bad_aot_knobs_are_one_failed_status`` cases
BAD_AOT = {
    "bad-aot-type": {"aot": ["/cache"]},
    "bad-aot-root": {"aot": {"root": ""}},
    "bad-aot-fsync": {"aot": {"root": "/cache", "fsync": 1}},
    "bad-aot-key": {"aot": {"root": "/cache", "roots": "/x"}},
}


def _aot_cases(clusters, tmp_path):
    """Each bad ``aot`` block is ONE Failed status naming the knob, with
    the reference's message; a good one reaches Ready and its replica's
    engine warmed through the cache (one record a program published)."""
    for name, config in BAD_AOT.items():
        for pkg, c, key in clusters:
            _apply(pkg, c, _isvc(pkg, key, name, "llama-continuous",
                                 config=config))
    for name in BAD_AOT:
        msgs = [_wait(c, name, "Failed").status.message
                for _, c, _ in clusters]
        assert msgs[1] == msgs[0] and "aot" in msgs[1], (name, msgs)
    pkg, c, key = clusters[1]
    root = str(tmp_path / "aot")
    _apply(pkg, c, _isvc(pkg, key, "good-aot", "llama-continuous", config={
        "aot": {"root": root, "fsync": False}, "warmup_groups": [[1, 32]]}))
    try:
        _wait(c, "good-aot")
        engine = _replicas(c, "good-aot")[0].models()["good-aot"].engine
        st = engine.stats()
        assert engine.program_cache.root == root
        assert st["aot_cache_published_total"] == \
            st["graph_captures_warmup"] > 0
    finally:
        c.store.delete("InferenceService", "good-aot")


@pytest.mark.parametrize("knob", list(UNPORTED))
def test_unported_knobs_fail(clusters, knob, tmp_path):
    """Every knob here is ported now. ``aot`` (A12): a bad block is one
    Failed status with the reference's message, a good one serves
    (``_aot_cases``). ``gang`` and ``mesh_axes`` (A7): the revision places
    a JaxJob of the port's ``serve_main``, a pod for each rank (``hosts x
    chips_per_host``; ``mesh_axes`` over N cards is a one-host gang of N),
    each on the config's device."""
    if UNPORTED[knob][1] == "A12":
        _aot_cases(clusters, tmp_path)
        return
    pkg, c, key = clusters[1]
    pred, item = UNPORTED[knob]
    name = f"unported-{knob.replace('_', '-')}"
    _apply(pkg, c, _isvc(pkg, key, name, "llama-continuous", **pred))
    pods = {"gang": 8, "mesh_axes": 2}[knob]
    deadline = time.time() + WAIT_S
    jobs = []
    while time.time() < deadline and not jobs:
        jobs = [j for j in c.store.list("JaxJob")
                if j.metadata.name.startswith(f"{name}-gang-")]
        time.sleep(0.05)
    try:
        assert jobs, f"{name}: no gang JaxJob placed"
        spec = next(iter(jobs[0].spec.replica_specs.values()))
        assert spec.replicas == pods
        assert spec.template.entrypoint == \
            "kubeflow_tpu_torch.serving.gang:serve_main"
        assert spec.template.env["KFT_POD_DEVICE"] == "cpu"
        # a card a rank: the gang's mesh covers one pod of one card each
        assert spec.template.resources.gpu == 1
        conf = json.loads(spec.template.env["KFT_SERVE_CONFIG"])
        assert math.prod(conf["mesh_axes"].values()) == pods
        isvc = c.store.get("InferenceService", name)
        assert str(isvc.status.phase.value) != "Failed", isvc.status
    finally:
        c.store.delete("InferenceService", name)


def _burst(url: str, n: int = 32) -> list[float]:
    """Open ``n`` connections at once (released together by a barrier),
    each sending one V1 predict; seconds from each send to its full
    response."""
    host, port = url.split("//")[1].split(":")
    body = json.dumps({"instances": [1]}).encode()
    req = (f"POST /v1/models/e:predict HTTP/1.1\r\nHost: {host}\r\n"
           f"Content-Type: application/json\r\nContent-Length: {len(body)}"
           f"\r\nConnection: close\r\n\r\n").encode() + body
    barrier = threading.Barrier(n)
    took: list = [None] * n

    def one(i):
        barrier.wait()
        t0 = time.perf_counter()
        with socket.create_connection((host, int(port)), timeout=10) as s:
            s.sendall(req)
            data = b""
            while chunk := s.recv(65536):
                data += chunk
        assert data.startswith(b"HTTP/1.") and b" 200 " in data[:16], data
        took[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return took


@pytest.mark.parametrize("front", ["model_server", "router"])
def test_burst_of_connections_answered(front):
    from kubeflow_tpu_torch.serving.controller import Router
    from kubeflow_tpu_torch.serving.runtimes import EchoModel
    from kubeflow_tpu_torch.serving.server import ModelServer

    srv = ModelServer()
    srv.register(EchoModel("e"))
    srv.start()
    router = None
    try:
        url = srv.url
        if front == "router":
            router = Router(activate=lambda: None)
            router.set_backends([srv.url])
            url = router.url
        # one request first: a process's first urlopen calls pay one-time
        # costs (the Router forwards with urllib), which are not the door's
        assert _post(f"{url}/v1/models/e:predict", {"instances": [1]})[0] \
            == 200
        took = _burst(url)
    finally:
        if router is not None:
            router.stop()
        srv.stop()
    assert all(t is not None for t in took), took
    # a SYN dropped past a full backlog is retried a second later
    assert max(took) < 0.9, sorted(took)
