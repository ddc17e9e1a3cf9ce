"""The port's analyzer (``kubeflow_tpu_torch/analysis/``) against the
reference's ``kubeflow_tpu/analysis/``, on the CPU.

- (a) The port's self-test is green, and every reference fixture has a
  port fixture of the same name, rule and expectation.
- (b) The torch matchers: each host-sync and program-construction
  spelling fires on its true positive and stays quiet on its near miss.
- (c) The ratchet: the whole port lints with no finding above its
  ``baseline.json`` (one lint, shared by the module); the CLI's exit codes.
- (d) A seeded drift in copies of the port's real ``serving/gang.py`` and
  ``serving/resize.py``: ``op-table`` names the deleted ``follow()`` arm.
- (e) ``import kubeflow_tpu_torch.analysis`` loads no torch, jax, numpy
  or reference module.
- (f) ``LockAudit`` and ``audit_stats_pair`` give the reference's reports
  on the same scripted acquisition orders and stats pairs, and a port
  engine's ``stats()`` keeps the metrics contract across real traffic.

The analyzers are stdlib only; torch is imported inside the one test that
builds an engine.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("kubeflow_tpu", "kubeflow_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.analysis.{name}")


def _lint_tree(tmp_path, files: dict, rules=None):
    """``run_lint`` of the port over ``files`` ({relpath: code}) written
    under ``tmp_path``."""
    astlint = _mod("kubeflow_tpu_torch", "astlint")
    paths = []
    for rel, code in files.items():
        target = tmp_path / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(textwrap.dedent(code))
        paths.append(str(target))
    return astlint.run_lint(str(tmp_path), paths=paths, rules=rules)


@pytest.fixture(scope="module")
def port_lint():
    """One lint of the whole port, shared by the ratchet tests."""
    astlint = _mod("kubeflow_tpu_torch", "astlint")
    return astlint.run_lint(REPO_ROOT)


# -- (a) self-test parity ---------------------------------------------------


def test_self_test_matches_reference_fixtures():
    out = {}
    for pkg in PKGS:
        lines = []
        rc = _mod(pkg, "selftest").run_selftest(out=lines.append)
        assert rc == 0, "\n".join(lines)
        out[pkg] = lines
    ref = {f.name: f for f in _mod("kubeflow_tpu", "selftest").FIXTURES}
    port = {f.name: f for f in _mod("kubeflow_tpu_torch", "selftest").FIXTURES}
    ran = [ln.split()[-1] for ln in out["kubeflow_tpu"]
           if ln.startswith("  ok ")]
    assert sorted(ran) == sorted(ref)
    for name, fx in ref.items():
        assert name in port, f"no port fixture {name}"
        assert port[name].rule == fx.rule
        assert (port[name].expect == 0) == (fx.expect == 0), name
    # the port's extra fixtures come in true-positive/near-miss pairs
    extra = sorted(set(port) - set(ref))
    stems = {n.rsplit("/", 1)[0] for n in extra}
    assert extra and sorted(extra) == sorted(
        f"{s}/{k}" for s in stems for k in ("near-miss", "true-positive"))
    assert out["kubeflow_tpu_torch"][-1] == (
        f"self-test: {len(port)}/{len(port)} fixtures green")


def test_self_test_catches_a_broken_matcher(monkeypatch):
    """A matcher that stops firing turns the self-test red."""
    callgraph = _mod("kubeflow_tpu_torch", "callgraph")
    selftest = _mod("kubeflow_tpu_torch", "selftest")
    monkeypatch.setattr(callgraph, "_CONSTRUCT_DOTTED", frozenset())
    lines = []
    assert selftest.run_selftest(rules=["jit-in-loop"],
                                 out=lines.append) == 1
    assert any(ln.startswith("  FAIL jit-in-loop-graph/true-positive")
               for ln in lines), lines


# -- (b) the torch matchers -------------------------------------------------

#: (spelling, label in the finding) of every host-sync matcher
HOST_SYNC_TP = [
    ("x.item()", "`.item()`"),
    ("x.tolist()", "`.tolist()`"),
    ("x.cpu()", "`.cpu()`"),
    ("x.numpy()", "`.numpy()`"),
    ("x.numpy(force=True)", "`.numpy()`"),
    ('x.to("cpu")', '`.to("cpu")`'),
    ('x.to(device="cpu")', '`.to("cpu")`'),
    ('x.to(torch.device("cpu"))', '`.to("cpu")`'),
    ("torch.cuda.synchronize()", "`torch.cuda.synchronize`"),
    ("torch.cuda.synchronize(self.device)", "`torch.cuda.synchronize`"),
    ("self.done.synchronize()", "`Event.synchronize`/`Stream.synchronize`"),
    ("torch.cuda.current_stream().synchronize()",
     "`Event.synchronize`/`Stream.synchronize`"),
    ("np.asarray(x)", "numpy materialization"),
    ("int(x.max())", "scalarized reduction"),
]

#: spellings that must not count as host syncs
HOST_SYNC_NM = [
    'x.to("cuda")',
    "x.to(self.device, non_blocking=True)",
    "x.cuda()",
    "x.cpu",
    "self.done.record(self.stream)",
    "self.done.query()",
    "self.done.wait(self.stream)",
    "np.asarray([1, 2, 3])",
    "x.item(0)",
]


def _engine_loop(expr: str) -> str:
    return f"""
import numpy as np
import torch

class FooEngine:
    def _loop(self, x):
        return {expr}
"""


@pytest.mark.parametrize("expr,label", HOST_SYNC_TP,
                         ids=[e for e, _ in HOST_SYNC_TP])
def test_host_sync_true_positive(tmp_path, expr, label):
    rep = _lint_tree(tmp_path, {"kubeflow_tpu_torch/serving/_e.py":
                                _engine_loop(expr)},
                     rules=["host-sync-in-dispatch"])
    assert len(rep.findings) == 1, rep.findings
    assert label in rep.findings[0].message


@pytest.mark.parametrize("expr", HOST_SYNC_NM)
def test_host_sync_near_miss(tmp_path, expr):
    rep = _lint_tree(tmp_path, {"kubeflow_tpu_torch/serving/_e.py":
                                _engine_loop(expr)},
                     rules=["host-sync-in-dispatch"])
    assert rep.findings == []


def test_host_sync_pragma_silences_the_effect(tmp_path):
    """A declared fetch is no sync for the rule, nor for a lock held
    around a call that reaches it."""
    code = """
    class FooEngine:
        def _loop(self):
            # analysis: ok host-sync-in-dispatch — the one intended fetch
            return self.toks.cpu()

        def thaw(self):
            with self._gate:
                return self._loop()
    """
    rep = _lint_tree(tmp_path, {"kubeflow_tpu_torch/serving/_e.py": code})
    assert rep.findings == []
    undeclared = code.replace(
        "# analysis: ok host-sync-in-dispatch — the one intended fetch\n", "")
    rep = _lint_tree(tmp_path, {"kubeflow_tpu_torch/serving/_e.py":
                                undeclared})
    assert sorted(f.rule for f in rep.findings) == [
        "host-sync-in-dispatch", "lock-blocking-call"]


#: every program-construction spelling, in a loop body
CONSTRUCT_TP = [
    "torch.cuda.CUDAGraph()",
    "torch.cuda.graph(self.g)",
    "self.g.capture_begin()",
    "torch.compile(self.fn)",
    "torch.cuda.make_graphed_callables(self.fn, (k,))",
    "make_decode_program(self.cfg, k)",
]


@pytest.mark.parametrize("expr", CONSTRUCT_TP)
def test_capture_in_a_loop_true_positive(tmp_path, expr):
    code = f"""
import torch

class FooEngine:
    def _admit(self, keys):
        for k in keys:
            {expr}
"""
    rep = _lint_tree(tmp_path, {"kubeflow_tpu_torch/serving/_g.py": code},
                     rules=["jit-in-loop"])
    assert len(rep.findings) == 1, rep.findings
    assert "recompile treadmill" in rep.findings[0].message


#: near misses: a replay, a cache-guarded capture, and captures of the
#: warmup phase (``warmup``, its ``_warmup*`` helpers, ``__init__``)
CONSTRUCT_NM = {
    "replay": """
        def _admit(self, keys):
            for k in keys:
                self.graphs[k].replay()
    """,
    "guarded": """
        def _admit(self, keys):
            for k in keys:
                self._get(k)

        def _get(self, k):
            if k not in self.graphs:
                self.graphs[k] = torch.cuda.CUDAGraph()
            return self.graphs[k]
    """,
    "warmup": """
        def warmup(self, keys):
            for k in keys:
                with torch.cuda.graph(self.g):
                    self.run(k)
    """,
    "warmup-helper": """
        def warmup(self, keys):
            self._warmup_ladder(keys)

        def _warmup_ladder(self, keys):
            for k in keys:
                self._capture(k)

        def _capture(self, k):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                self.run(k)
    """,
    "init": """
        def __init__(self, keys):
            for k in keys:
                self.progs = make_decode_program(self.cfg, k)
    """,
}


@pytest.mark.parametrize("name", sorted(CONSTRUCT_NM))
def test_capture_near_miss(tmp_path, name):
    body = textwrap.indent(textwrap.dedent(CONSTRUCT_NM[name]), "    ")
    code = f"import torch\n\nclass FooEngine:\n{body}"
    rep = _lint_tree(tmp_path, {"kubeflow_tpu_torch/serving/_g.py": code},
                     rules=["jit-in-loop"])
    assert rep.findings == []


def test_loop_call_reaching_an_unguarded_capture(tmp_path):
    """The transitive half: a serving loop calling a helper that captures
    unconditionally is the treadmill; the same call in warmup is not."""
    code = """
    import torch

    class FooEngine:
        def _admit(self, keys):
            for k in keys:
                self._capture(k)

        def warmup(self, keys):
            for k in keys:
                self._capture(k)

        def _capture(self, k):
            with torch.cuda.graph(self.g):
                self.run(k)
    """
    rep = _lint_tree(tmp_path, {"kubeflow_tpu_torch/serving/_g.py": code},
                     rules=["jit-in-loop"])
    assert [f.scope for f in rep.findings] == ["FooEngine._admit"]
    assert "unguarded" in rep.findings[0].message


def test_lock_order_counts_a_device_sync_under_a_lock(tmp_path):
    code = """
    import torch

    class Pool:
        def drain(self):
            with self._lock:
                torch.cuda.synchronize()
    """
    rep = _lint_tree(tmp_path, {"kubeflow_tpu_torch/serving/_l.py": code},
                     rules=["lock-order"])
    assert len(rep.findings) == 1
    assert "`torch.cuda.synchronize`" in rep.findings[0].message


# -- (c) the ratchet --------------------------------------------------------


def test_port_has_no_findings_above_its_baseline(port_lint):
    astlint = _mod("kubeflow_tpu_torch", "astlint")
    baseline = astlint.load_baseline(astlint.baseline_path(REPO_ROOT))
    new = astlint.compare_to_baseline(port_lint, baseline)
    assert new == [], "\n".join(f"  {f}" for f in new)


def test_lint_covers_the_port_only(port_lint):
    """LINT_DIRS is the port's package: its files are parsed, the
    reference's are not, and the baseline lives in the port."""
    astlint = _mod("kubeflow_tpu_torch", "astlint")
    files = astlint.discover(REPO_ROOT)
    rel = {os.path.relpath(p, REPO_ROOT).replace(os.sep, "/") for p in files}
    assert "kubeflow_tpu_torch/serving/continuous.py" in rel
    assert all(p.startswith("kubeflow_tpu_torch/") for p in rel)
    assert astlint.baseline_path(REPO_ROOT) == os.path.join(
        REPO_ROOT, "kubeflow_tpu_torch", "analysis", "baseline.json")
    assert all(f.path.startswith("kubeflow_tpu_torch/")
               for f in port_lint.findings)


def test_cli_exit_codes(tmp_path, capsys):
    main = _mod("kubeflow_tpu_torch", "__main__").main
    assert main(["--rule", "metrics", "--rule", "protocol"]) == 0
    assert "0 NEW" in capsys.readouterr().out
    bad = tmp_path / "kubeflow_tpu_torch" / "serving" / "_x.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("class FooEngine:\n    def _loop(self):\n"
                   "        return self.toks.cpu()\n")
    assert main(["--root", str(tmp_path), "--json"]) == 1
    rep = json.loads(capsys.readouterr().out)
    assert rep["by_rule"] == {"host-sync-in-dispatch": 1}
    frozen = str(tmp_path / "baseline.json")
    assert main(["--root", str(tmp_path), "--baseline", frozen,
                 "--update-baseline"]) == 0
    capsys.readouterr()
    assert main(["--root", str(tmp_path), "--baseline", frozen]) == 0
    assert "1 baselined, 0 NEW" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        main(["--self-test", "--json"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        main(["--update-baseline", "--rule", "locks"])
    assert e.value.code == 2


# -- (d) seeded drift on the port's real protocol files ---------------------


def _protocol_copy(tmp_path, drop_params_arm: bool) -> list:
    serving = tmp_path / "kubeflow_tpu_torch" / "serving"
    serving.mkdir(parents=True)
    src = os.path.join(REPO_ROOT, "kubeflow_tpu_torch", "serving")
    shutil.copy(os.path.join(src, "resize.py"), serving / "resize.py")
    with open(os.path.join(src, "gang.py")) as f:
        gang = f.read()
    if drop_params_arm:
        arm = ('            elif op == "params":\n'
               '                # a resize gathers the weights whole: join the '
               'gather\n'
               '                from .resize import full_params\n\n'
               '                full_params(engine)\n')
        assert gang.count(arm) == 1
        gang = gang.replace(arm, "")
    (serving / "gang.py").write_text(gang)
    return [str(serving / "gang.py"), str(serving / "resize.py")]


@pytest.mark.parametrize("drop", [False, True], ids=["intact", "drifted"])
def test_op_table_catches_a_deleted_follow_arm(tmp_path, drop):
    astlint = _mod("kubeflow_tpu_torch", "astlint")
    paths = _protocol_copy(tmp_path, drop)
    rep = astlint.run_lint(str(tmp_path), paths=paths, rules=["op-table"])
    if not drop:
        assert rep.findings == []
        return
    assert len(rep.findings) == 1, rep.findings
    f = rep.findings[0]
    assert "`params`" in f.message and "no follower replay arm" in f.message
    assert f.path == "kubeflow_tpu_torch/serving/resize.py"


# -- (e) a clean import -----------------------------------------------------


def test_analysis_imports_no_framework():
    code = (
        "import sys\n"
        "import kubeflow_tpu_torch.analysis, "
        "kubeflow_tpu_torch.analysis.runtime, "
        "kubeflow_tpu_torch.analysis.selftest, "
        "kubeflow_tpu_torch.analysis.__main__\n"
        "from kubeflow_tpu_torch.analysis import astlint\n"
        "astlint.rule_names()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'numpy', 'kubeflow_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- (f) the runtime auditors against the reference's -----------------------


def _scripted_orders(pkg: str) -> tuple:
    """The same acquisition script through ``pkg``'s LockAudit: A then B
    on one thread, B then A on another (run one after the other, so the
    inversion is recorded without a deadlock), an RLock taken twice, a
    release out of LIFO order, and ``audit_many`` over two objects."""
    runtime = _mod(pkg, "runtime")
    audit = runtime.LockAudit()
    a = audit.wrap(threading.Lock(), "A")
    b = audit.wrap(threading.Lock(), "B")
    r = audit.wrap(threading.RLock(), "R")

    class Holder:
        def __init__(self):
            self._lock = threading.Lock()
            self._mu = threading.Lock()

    h = Holder()
    runtime.audit_many(audit, [(h, "_lock"), (h, "_mu")])

    def one():
        with a:
            with b:
                with r:
                    with r:
                        pass

    def two():
        with b:
            with a:
                pass
        a.acquire()
        h._lock.acquire()
        a.release()
        with h._mu:
            pass
        h._lock.release()

    for fn in (one, two):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert not a.locked() and not b.locked()
    return audit.report(), audit.inversions(), audit.edges()


def test_lock_audit_matches_reference():
    ref, port = (_scripted_orders(pkg) for pkg in PKGS)
    assert port == ref
    report, inversions, _ = port
    assert inversions == [("A", "B")]
    assert report["locks"] == ["A", "B", "Holder._lock", "Holder._mu", "R"]
    assert "Holder._lock -> Holder._mu" in report["edges"]


STATS_PAIRS = {
    "clean": ({"a_total": 1, "g": 2.5, "name": "x"},
              {"a_total": 4, "g": 0.5, "name": "y"}),
    "counter_down": ({"a_total": 5}, {"a_total": 3}),
    "counter_vanished": ({"a_total": 5}, {}),
    "bad_name": ({"bad-name": 1, "kv.blocks": 2}, {"bad-name": 1}),
    "non_numeric_counter": ({"a_total": "5"}, {"a_total": 5}),
    "counter_turns_bool": ({"a_total": 1}, {"a_total": True}),
    "bool_is_not_a_metric": ({"bad-flag": True}, {"bad-flag": False}),
}


@pytest.mark.parametrize("case", sorted(STATS_PAIRS))
def test_audit_stats_pair_matches_reference(case):
    before, after = STATS_PAIRS[case]
    ref, port = (_mod(pkg, "runtime").audit_stats_pair(before, after)
                 for pkg in PKGS)
    assert port == ref
    assert (port == []) == (case in ("clean", "bool_is_not_a_metric"))


def test_engine_stats_keep_the_metrics_contract():
    """A port engine's ``stats()`` after warmup and after a round of
    traffic: both packages' ``audit_stats_pair`` find nothing."""
    import torch

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.continuous import ContinuousEngine

    torch.set_num_threads(1)
    cfg = llama.tiny()
    model = llama.Llama(cfg, device="cpu")
    model.init_weights(0)
    eng = ContinuousEngine(cfg, model, num_slots=2, decode_chunk=4,
                           block_size=16, device="cpu")
    try:
        eng.warmup([(2, 16)])
        s0 = eng.stats()
        reqs = [eng.submit([1 + i, 2, 3, 4], max_new_tokens=8)
                for i in range(2)]
        assert all(len(r.wait(120)) == 8 for r in reqs)
        s1 = eng.stats()
    finally:
        eng.stop()
    assert s1["tokens_emitted"] > s0["tokens_emitted"]
    for pkg in PKGS:
        assert _mod(pkg, "runtime").audit_stats_pair(s0, s1) == []
