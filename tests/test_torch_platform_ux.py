"""The port's platform-UX tier (``kubeflow_tpu_torch/ux/``) against the
reference's ``kubeflow_tpu/ux/``, on the CPU, with the fake kubelet.

- A Profile's quota holds a gang over it pending with the same message
  while a gang inside it binds, a PodDefault injects the same env and
  annotations, and the Profile counts the same usage, in both packages.
- A Notebook reconciles to a Running pod behind a stable URL, stops when
  culled for idleness and goes when deleted, as the reference's does.
- The port's dashboard serves the reference dashboard's pages, byte for
  byte, over the same store (one durable log, replayed by each package)
  and observation db.

(The Notebook pod that runs ``notebook_server`` and answers ``/execute``
is ``tests/test_torch_sdk_cli.py``'s.) The port counts NVIDIA cards
(``gpu``) where the reference counts TPU chips (``tpu``): each side is
written in its own words, and the reference's results are mapped into the
port's before they are compared (``tests/_torch_resources.py``). Both
packages are imported inside the tests.
"""

import importlib
import time
import urllib.error
import urllib.request

from tests._torch_resources import (
    add_hosts,
    as_port,
    as_ref,
    in_vocab,
    text_as_port,
    translate_store,
)

PKGS = ("kubeflow_tpu", "kubeflow_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _wait(fn, what: str, timeout: float = 15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _job(pkg: str, name: str, replicas: int, tpu: int, env=None):
    return _mod(pkg, "api").from_dict(in_vocab(pkg, {
        "kind": "JaxJob", "metadata": {"name": name, "namespace": "team-a"},
        "spec": {"replica_specs": {"worker": {"replicas": replicas,
                 "template": {"env": env or {}, "resources": {
                     "cpu": 1, "memory_gb": 1, "tpu": tpu}}}}}}))


def _ux_cluster(pkg: str):
    c = _mod(pkg, "controlplane.cluster").Cluster()
    add_hosts(pkg, c, "s0", 4, 4)
    c.enable_platform_ux()
    fk = _mod(pkg, "controlplane.fake_kubelet")
    return c, fk.FakeKubelet(c.store, lambda pod: fk.PodScript(hang=True))


def _quota_and_defaults(pkg: str) -> dict:
    api = _mod(pkg, "api")
    objects = _mod(pkg, "controlplane.objects")
    c, kubelet = _ux_cluster(pkg)
    with c:
        kubelet.start()
        try:
            c.store.create(api.from_dict(in_vocab(pkg, {
                "kind": "Profile", "metadata": {"name": "team-a"},
                "spec": {"owner": "a@corp", "resource_quota": {"tpu": 4}}})))
            c.store.create(api.from_dict({
                "kind": "PodDefault",
                "metadata": {"name": "tracking", "namespace": "team-a"},
                "spec": {"selector": {objects.LABEL_JOB_NAME: "small"},
                         "env": {"KFT_TRACKING": "on", "KFT_STEPS": "999"},
                         "annotations": {"team": "a"}}}))
            # 2 workers x 4 chips = 8 > the quota's 4: the whole gang pends
            c.store.create(_job(pkg, "big", 2, 4))
            c.store.create(_job(pkg, "small", 1, 4, {"KFT_STEPS": "3"}))
            pg = _wait(lambda: (g := c.store.try_get(
                objects.KIND_PODGROUP, "big", "team-a"))
                and g.status.message.startswith("profile quota") and g,
                "the quota's refusal")

            def pods(job):
                return c.store.list(objects.KIND_POD, "team-a",
                                    labels={objects.LABEL_JOB_NAME: job})
            small = _wait(lambda: (p := pods("small"))
                          and all(x.spec.node_name for x in p) and p,
                          "the gang inside the quota bound")
            prof = _wait(lambda: (p := c.store.try_get("Profile", "team-a"))
                         and p.status.usage.get(
                             "tpu" if pkg == PKGS[0] else "gpu") == 4.0 and p,
                         "the profile's usage")
            env = dict(small[0].spec.container.env)
            # the coordinator's port is allocated at bind time
            addr = env.pop("JAX_COORDINATOR_ADDRESS")
            return {
                "big": (pg.status.phase, pg.status.message,
                        [p.spec.node_name for p in pods("big")]),
                "small": (env, addr.rsplit(":", 1)[0],
                          dict(small[0].metadata.annotations)),
                "profile": (prof.status.phase, dict(prof.status.usage)),
            }
        finally:
            kubelet.stop()


def test_profile_quota_and_pod_defaults_match_reference():
    got = {pkg: _quota_and_defaults(pkg) for pkg in PKGS}
    want = as_port(got["kubeflow_tpu"])
    assert got["kubeflow_tpu_torch"] == want
    assert want["big"][2] == [None, None]
    assert want["small"][0]["KFT_TRACKING"] == "on"
    assert want["small"][0]["KFT_STEPS"] == "3"  # the pod's own value wins
    assert want["small"][2]["team"] == "a"


def _notebook_lifecycle(pkg: str) -> list:
    api = _mod(pkg, "api")
    c, kubelet = _ux_cluster(pkg)
    seen = []
    with c:
        kubelet.start()
        try:
            c.store.create(api.from_dict({
                "kind": "Notebook", "metadata": {"name": "wb"},
                "spec": {"template": {
                    "entrypoint": f"{pkg}.ux.notebook_server:main",
                    "resources": {"cpu": 1}}, "idle_cull_seconds": 0.5}}))
            nb = _wait(lambda: (n := c.store.try_get("Notebook", "wb"))
                       and n.status.phase == "Running" and n, "running")
            seen.append((nb.status.phase, nb.status.url,
                         c.store.try_get("Service", "wb-notebook-0")
                         is not None))
            nb = _wait(lambda: (n := c.store.try_get("Notebook", "wb"))
                       and n.status.phase == "Stopped" and n, "culled")
            seen.append((nb.status.phase,
                         dict(nb.metadata.annotations),
                         c.store.try_get("Pod", "wb-notebook-0")))
            c.store.try_delete("Notebook", "wb")
            _wait(lambda: c.store.try_get("Service", "wb-notebook-0") is None,
                  "the service deleted")
            seen.append(c.store.try_get("Pod", "wb-notebook-0"))
        finally:
            kubelet.stop()
    return seen


def test_notebook_lifecycle_matches_reference():
    got = {pkg: _notebook_lifecycle(pkg) for pkg in PKGS}
    want = as_port(got["kubeflow_tpu"])
    assert got["kubeflow_tpu_torch"] == want
    assert want[0] == ("Running", "http://wb-notebook-0.default.svc", True)
    assert want[1][1]["kft-stopped"] == "idle-culled" and want[2] is None


def _get(url: str) -> tuple:
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_dashboard_pages_match_reference(tmp_path):
    from kubeflow_tpu.ux.dashboard import Dashboard as RefDashboard
    from kubeflow_tpu_torch.controlplane.cluster import Cluster
    from kubeflow_tpu_torch.controlplane.fake_kubelet import (
        FakeKubelet, PodScript)
    from kubeflow_tpu_torch.hpo.db import DbManagerClient, DbManagerServer
    from kubeflow_tpu_torch.ux.dashboard import Dashboard

    logs = tmp_path / "logs"
    logs.mkdir()
    (logs / "dash-worker-0.log").write_text("score=0.5\n")
    data_dir = str(tmp_path / "store")
    c = Cluster(data_dir=data_dir)
    c.add_gpu_hosts("s0", 1, 4)
    c.enable_platform_ux()
    kubelet = FakeKubelet(c.store, lambda pod: PodScript(run_seconds=0.05))
    with c:
        kubelet.start()
        try:
            c.store.create(_job("kubeflow_tpu_torch", "dash", 1, 0))
            c.store.create(_mod("kubeflow_tpu_torch", "api").from_dict({
                "kind": "Profile", "metadata": {"name": "team-b"},
                "spec": {"owner": "b@corp"}}))
            _wait(lambda: (j := c.store.try_get("JaxJob", "dash", "team-a"))
                  and j.status.conditions
                  and j.status.conditions[-1].type == "Succeeded", "job done")
        finally:
            kubelet.stop()
    # the cluster is stopped; each package replays its log into a store
    # of its own, which no longer moves under the pages (the reference a
    # copy in its words: chips for cards)
    server = DbManagerServer(str(tmp_path / "obs.sqlite")).start()
    db = DbManagerClient(server.address)
    db.report_observation("exp1", "exp1-t1", {"lr": 0.1}, 0.5, step=10)
    db.report_observation("exp1", "exp1-t1", {"lr": 0.1}, 0.8)
    db.report_observation("exp1", "exp1-t2", {"lr": 0.01}, 0.3)
    paths = ["/", "/api/overview", "/api/jaxjobs", "/api/profiles",
             "/api/pods", "/api/events", "/api/nodes", "/api/experiments",
             "/api/jaxjobs/team-a/dash", "/api/jaxjobs/team-a/nope",
             "/api/experiments/default/exp1/curves",
             "/api/pods/team-a/dash-worker-0/logs", "/api/mystery", "/x"]
    pages = {}
    try:
        ref_dir = translate_store(data_dir, str(tmp_path / "ref"), as_ref)
        for name, cls, pkg, d in (
                ("ref", RefDashboard, "kubeflow_tpu", ref_dir),
                ("port", Dashboard, "kubeflow_tpu_torch", data_dir)):
            store = _mod(pkg, "controlplane.store").Store.open(d)
            dash = cls(store, db=db,
                       log_path_for=lambda ns, pod: str(logs / f"{pod}.log"))
            try:
                pages[name] = [_get(dash.url + p) for p in paths]
            finally:
                dash.stop()
                store.close()
    finally:
        db.close()
        server.stop()
    assert pages["port"] == [(code, ctype, text_as_port(body.decode()).encode())
                             for code, ctype, body in pages["ref"]]
    codes = [p[0] for p in pages["ref"]]
    assert codes == [200] * 9 + [404, 200, 200, 404, 404]
    assert b"team-a/dash" in pages["ref"][0][2]
    assert pages["ref"][11][2] == b"score=0.5\n"
