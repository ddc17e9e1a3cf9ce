"""The port's program-artifact cache (``kubeflow_tpu_torch/serving/
programs.py``) against the reference's (``kubeflow_tpu/serving/
programs.py``), on the CPU.

- The store: the reference's ``TestArtifactStore`` cases, each run on the
  reference's ``ProgramArtifactCache`` and on the port's with the same keys
  and bytes; every ``load`` and ``stats()`` along the way must agree.
- The keys: the fingerprint ignores weight values and sees architecture,
  the key base sees program-shaping knobs and torch's version, and a state
  dict converted from the reference fingerprints as a port-initialised one.
- ``validate_aot`` raises the reference's message for each bad spec.
- A tiny CPU engine (slot pool, chunked + paged, speculative): a cold boot
  on an empty root publishes one record a program, a warm boot on it hits
  the whole ladder with no miss, and the greedy tokens equal the cold
  boot's, the cache-off engine's and the reference engine's (cache off:
  the reference's XLA:CPU loader refuses an artifact compiled for another
  machine type, so its warm boot compiles again). A torn record and a
  mismatched one each count a load
  failure, are republished and change no token; once warmup has armed the
  engine, serving touches the cache no more.
- The kernel libraries through the cache (``ops/_build.py``) with a stub
  compiler in place of ``nvcc`` and no ``dlopen``: a publish, a second
  process with an empty build directory that takes every library from the
  cache without a compile (only ``nvcc --version``, for the key), and a
  torn entry rebuilt.
- The controller's warm-wake derivation (``_wake_was_warm``) on real port
  engines: a warm boot is warm, a cold one and a cache-off one are not.

torch and the port are imported inside the tests.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref_llama

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120
NEW = 6
PROMPTS = ([1, 2, 3], [4, 5, 6, 7, 8], list(range(9, 49)))
WARM = [(1, 32), (2, 32), (1, 64), (2, 64)]
#: the reference's ``TestEngineParity`` variants, and the slot pool
VARIANTS = {
    "slot_pool": dict(decode_chunk=2, block_size=0),
    "chunked_paged": dict(decode_chunk=2, block_size=16, prefill_budget=16),
    "spec": dict(decode_chunk=1, block_size=16, spec_k=2),
}


def _port():
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.serving import continuous, programs

    torch.set_num_threads(1)
    return torch, llama, convert, continuous, programs


def _ref_programs():
    from kubeflow_tpu.serving import programs

    return programs


@pytest.fixture(scope="module")
def weights():
    """(reference cfg, its numpy params, the port's state dict)."""
    _, llama, convert, _, _ = _port()
    cfg = ref_llama.tiny()
    params = ref_llama.Llama(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, nn.meta.unbox(params))
    return cfg, params, convert.state_dict_from_jax(params, llama.tiny())


def _engine(weights, cache=None, **kw):
    _, llama, _, continuous, _ = _port()
    return continuous.ContinuousEngine(
        llama.tiny(), weights[2], num_slots=2, prefix_cache=False,
        device="cpu", program_cache=cache, **kw)


def _boot(weights, cache, **kw):
    """Warm, serve ``PROMPTS``, stop: (tokens, stats, warmup_report)."""
    eng = _engine(weights, cache, **kw)
    try:
        eng.warmup(WARM)
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        tokens = [r.wait(WAIT_S) for r in reqs]
        return tokens, eng.stats(), eng.warmup_report
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def reference_tokens(weights):
    """The reference engine's greedy tokens, cache off, by variant."""
    from kubeflow_tpu.serving.continuous import ContinuousEngine

    out = {}
    for name, kw in VARIANTS.items():
        eng = ContinuousEngine(weights[0], weights[1], num_slots=2,
                               prefix_cache=False, **kw)
        try:
            eng.warmup(WARM)
            reqs = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
            out[name] = [r.wait(WAIT_S) for r in reqs]
        finally:
            eng.stop()
    return out


# -- the store ------------------------------------------------------------


def _payload(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _roundtrip(c, root, plan):
    key = c.entry_key("base", "decode", "sig")
    seen = [c.load(key)]
    payload = _payload(4096)
    assert c.publish(key, payload, meta={"family": "decode"})
    assert c.verify(key)
    seen.append(c.load(key))
    assert seen == [None, payload]
    st = c.stats()
    assert st["aot_cache_published_total"] == 1
    assert st["aot_cache_entries"] == 1
    assert st["aot_cache_bytes"] == 4096
    assert st["aot_cache_bytes_written_total"] == 4096
    assert st["aot_cache_bytes_read_total"] == 4096
    assert st["aot_cache_load_failures_total"] == 0
    return seen


def _duplicate(c, root, plan):
    key = c.entry_key("base", "decode", "sig")
    assert c.publish(key, b"x" * 64)
    assert c.publish(key, b"x" * 64)  # first writer already won
    assert c.stats()["aot_cache_published_total"] == 1
    assert c.stats()["aot_cache_entries"] == 1
    return []


def _torn(c, root, plan):
    key = c.entry_key("base", "decode", "sig")
    payload = _payload(1024)
    assert c.publish(key, payload)
    with open(os.path.join(root, key, "program.bin"), "r+b") as f:
        f.truncate(1024 - 7)
    seen = [c.load(key)]
    assert seen == [None]
    assert c.stats()["aot_cache_load_failures_total"] == 1
    assert not c.verify(key)  # the offending entry was removed
    assert c.publish(key, payload)  # and can be replaced
    seen.append(c.load(key))
    assert seen[-1] == payload
    return seen


def _corrupt_payload(c, root, plan):
    key = c.entry_key("base", "decode", "sig")
    assert c.publish(key, b"a" * 256)
    with open(os.path.join(root, key, "program.bin"), "r+b") as f:
        f.seek(100)
        f.write(b"Z")
    seen = [c.load(key)]
    assert seen == [None]
    assert c.stats()["aot_cache_load_failures_total"] == 1
    return seen


def _corrupt_manifest(c, root, plan):
    key = c.entry_key("base", "decode", "sig")
    assert c.publish(key, b"y" * 128)
    with open(os.path.join(root, key, "artifact.json"), "w") as f:
        f.write("{not json")
    seen = [c.load(key)]
    assert seen == [None]
    assert not c.verify(key)
    return seen


def _stale_staging(c, root, plan):
    key = c.entry_key("base", "decode", "sig")
    stale = os.path.join(root, f".staging-{key}-999-deadbeef")
    fresh = os.path.join(root, f".staging-{key}-998-cafecafe")
    os.mkdir(stale)
    os.mkdir(fresh)
    old = time.time() - 7200.0
    os.utime(stale, (old, old))
    assert c.publish(key, b"z" * 32)
    assert not os.path.exists(stale)
    assert os.path.exists(fresh)
    assert c.entries() == [key]  # dot-dirs never listed as entries
    return [c.entries()]


def _chaos_torn(c, root, plan):
    key = c.entry_key("base", "decode", "sig")
    assert c.publish(key, _payload(512))
    assert os.path.exists(os.path.join(root, key, "artifact.json"))
    seen = [c.load(key)]
    assert seen == [None]  # detected, counted, removed
    assert c.stats()["aot_cache_load_failures_total"] == 1
    return seen


#: the reference's ``TestArtifactStore`` cases: (scenario, chaos plan?)
STORE_CASES = {
    "publish_verify_load_roundtrip": (_roundtrip, False),
    "duplicate_publish_is_idempotent": (_duplicate, False),
    "torn_payload_detected_counted_removed": (_torn, False),
    "corrupt_payload_bytes_detected": (_corrupt_payload, False),
    "corrupt_manifest_detected": (_corrupt_manifest, False),
    "stale_staging_swept_fresh_kept": (_stale_staging, False),
    "chaos_torn_seam_fires_on_publish": (_chaos_torn, True),
}


def _store_run(pkg: str, case: str, root: str):
    scenario, chaos = STORE_CASES[case]
    if pkg == "kubeflow_tpu":
        from kubeflow_tpu.chaos import FaultPlan
        programs = _ref_programs()
    else:
        from kubeflow_tpu_torch.chaos import FaultPlan
        programs = _port()[4]
    os.makedirs(root)
    plan = FaultPlan(seed=7).spill_torn(64) if chaos else None
    c = programs.ProgramArtifactCache(root, chaos=plan)
    seen = scenario(c, root, plan)
    return seen, c.stats()


@pytest.mark.parametrize("pkg", ["kubeflow_tpu", "kubeflow_tpu_torch"])
@pytest.mark.parametrize("case", list(STORE_CASES))
def test_store_case_matches_the_reference(tmp_path, case, pkg):
    """Each case holds on ``pkg``'s cache, and what it loaded and its
    ``stats()`` equal the other package's on the same keys and bytes."""
    other = ({"kubeflow_tpu", "kubeflow_tpu_torch"} - {pkg}).pop()
    got = _store_run(pkg, case, str(tmp_path / "a"))
    want = _store_run(other, case, str(tmp_path / "b"))
    assert got == want


# -- the keys --------------------------------------------------------------


def test_fingerprint_ignores_weight_values(weights):
    torch, llama, _, _, programs = _port()
    sd = weights[2]
    doubled = {k: v * 2 for k, v in sd.items()}
    assert programs.model_fingerprint(llama.tiny(), sd) == \
        programs.model_fingerprint(llama.tiny(), doubled)


def test_fingerprint_sees_architecture(weights):
    torch, llama, _, _, programs = _port()
    cfg2 = llama.tiny(num_heads=8, num_kv_heads=8)
    sd2 = llama.Llama(cfg2, device="cpu").state_dict()
    assert programs.model_fingerprint(llama.tiny(), weights[2]) != \
        programs.model_fingerprint(cfg2, sd2)


def test_converted_state_dict_fingerprints_as_a_port_init(weights):
    """A state dict converted from the reference's params, a port
    initialised ``Llama`` and its state dict share one ladder."""
    torch, llama, _, _, programs = _port()
    torch.manual_seed(0)
    model = llama.Llama(llama.tiny(), device="cpu")
    fp = programs.model_fingerprint(llama.tiny(), weights[2])
    assert fp == programs.model_fingerprint(llama.tiny(), model)
    assert fp == programs.model_fingerprint(llama.tiny(), model.state_dict())


def test_key_base_varies_with_program_shaping_knobs(weights):
    torch, llama, _, _, programs = _port()
    a = programs.cache_key_base(llama.tiny(), weights[2], chunk=1)
    b = programs.cache_key_base(llama.tiny(), weights[2], chunk=2)
    c = programs.cache_key_base(llama.tiny(), weights[2], {"model": 2},
                                chunk=1)
    assert len({a, b, c}) == 3
    assert torch.__version__ in a  # a torch upgrade invalidates cleanly
    assert "|1|" in a and "|model2|" in c and "|cpu|" in a


def test_entry_key_matches_the_reference():
    k = _port()[4].ProgramArtifactCache.entry_key
    ref = _ref_programs().ProgramArtifactCache.entry_key
    assert k("b", "decode", "s1") != k("b", "prefill", "s1")
    assert k("b", "decode", "s1") != k("b", "decode", "s2")
    assert k("b", "decode", "s1") == ref("b", "decode", "s1")


# -- conf-freeze ------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    ["/tmp/x"], {"root": ""}, {"root": str, "fsync": True},
    {"root": "/tmp/x", "fsync": "yes"}, {"root": "/tmp/x", "rot": "/tmp/y"},
    {"root": 3, "fsync": 1, "extra": 0},
], ids=["mapping", "root", "root_type", "fsync", "unknown", "all_three"])
def test_validate_aot_raises_the_reference_message(spec):
    programs = _port()[4]
    with pytest.raises(ValueError) as want:
        _ref_programs().validate_aot(spec)
    with pytest.raises(ValueError) as got:
        programs.validate_aot(spec)
    assert str(got.value) == str(want.value)


def test_build_program_cache_seam(tmp_path):
    programs = _port()[4]
    programs.validate_aot({"root": str(tmp_path)})
    programs.validate_aot({"root": str(tmp_path), "fsync": False})
    assert programs.build_program_cache(None) is None
    assert programs.build_program_cache({}) is None
    c = programs.build_program_cache({"aot": {"root": str(tmp_path),
                                              "fsync": False}})
    assert isinstance(c, programs.ProgramArtifactCache)
    assert c.fsync is False
    with pytest.raises(ValueError):
        programs.build_program_cache({"aot": {"root": 3}})


# -- the engine --------------------------------------------------------------


def _aot(st: dict) -> dict:
    return {k: v for k, v in st.items() if k.startswith("aot_cache_")}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_warm_boot_hits_the_ladder_and_keeps_the_tokens(
        weights, reference_tokens, tmp_path, variant):
    """Cache off, cold (publishes every program), warm (hits every
    program, no miss): one set of greedy tokens, the reference engine's;
    no capture after warmup, no leaked block."""
    _, _, _, _, programs = _port()
    kw = VARIANTS[variant]
    off, st_off, rep_off = _boot(weights, None, **kw)
    assert _aot(st_off) == programs.EMPTY_STATS
    assert set(rep_off["outcomes"].values()) == {"compile"}
    cold, st_cold, rep_cold = _boot(
        weights, programs.ProgramArtifactCache(str(tmp_path), fsync=False),
        **kw)
    ladder = st_cold["graph_captures_warmup"]
    assert ladder > 0
    assert st_cold["aot_cache_misses_total"] == ladder
    assert st_cold["aot_cache_published_total"] == ladder
    assert st_cold["aot_cache_hits_total"] == 0
    assert set(rep_cold["outcomes"].values()) == {"miss"}
    warm, st_warm, rep_warm = _boot(
        weights, programs.ProgramArtifactCache(str(tmp_path), fsync=False),
        **kw)
    assert st_warm["graph_captures_warmup"] == ladder
    assert st_warm["aot_cache_hits_total"] == ladder
    assert st_warm["aot_cache_misses_total"] == 0
    assert st_warm["aot_cache_load_failures_total"] == 0
    assert st_warm["aot_cache_published_total"] == 0
    assert set(rep_warm["outcomes"].values()) == {"hit"}
    for st in (st_off, st_cold, st_warm):
        assert st["graph_captures_total"] == 0
        assert st["kv_blocks_leaked_total"] == 0
    assert off == cold == warm == reference_tokens[variant]


def _record_dirs(root: str) -> list[str]:
    """Entry dirs of program records, in a fixed order."""
    out = []
    for name in sorted(os.listdir(root)):
        man = os.path.join(root, name, "artifact.json")
        if os.path.exists(man):
            with open(man) as f:
                if json.load(f)["meta"]["family"] != "kernels":
                    out.append(os.path.join(root, name))
    return out


def test_torn_and_mismatched_records_degrade_and_republish(
        weights, reference_tokens, tmp_path):
    """One record torn on disk and one that verifies but does not match
    this boot's capture (its launches differ): each counts a load
    failure and a miss and is republished from the capture; every other
    program hits, and the tokens do not move."""
    _, _, _, _, programs = _port()
    kw = VARIANTS["chunked_paged"]
    root = str(tmp_path)
    want, st, _ = _boot(
        weights, programs.ProgramArtifactCache(root, fsync=False), **kw)
    ladder = st["graph_captures_warmup"]
    torn, wrong = _record_dirs(root)[:2]
    with open(os.path.join(torn, "program.bin"), "r+b") as f:
        f.truncate(os.path.getsize(f.name) - 5)
    seeder = programs.ProgramArtifactCache(root, fsync=False)
    key = os.path.basename(wrong)
    rec = json.loads(seeder.load(key))
    rec["launches"] = [{**c, "gmm": c.get("gmm", 0) + 1}
                       for c in rec["launches"]]
    seeder.invalidate(key)
    seeder.publish(key, json.dumps(rec, sort_keys=True).encode(),
                   meta={"family": "forged"})
    got, st, rep = _boot(
        weights, programs.ProgramArtifactCache(root, fsync=False), **kw)
    assert st["aot_cache_load_failures_total"] == 2
    assert st["aot_cache_misses_total"] == 2
    assert st["aot_cache_published_total"] == 2
    assert st["aot_cache_hits_total"] == ladder - 2
    assert sorted(rep["outcomes"].values()).count("miss") == 2
    # republished from the capture: the next boot hits everything
    _, st, _ = _boot(
        weights, programs.ProgramArtifactCache(root, fsync=False), **kw)
    assert st["aot_cache_hits_total"] == ladder
    assert st["aot_cache_misses_total"] == 0
    assert got == want == reference_tokens["chunked_paged"]


def test_chaos_torn_publish_degrades_at_the_next_boot(weights, tmp_path):
    """The seeded ``spill_torn`` seam tears one record as it is published;
    the next boot detects it, counts it, republishes it and hits the
    rest."""
    _, _, _, _, programs = _port()
    from kubeflow_tpu_torch.chaos import FaultPlan

    kw = VARIANTS["chunked_paged"]
    root = str(tmp_path)
    plan = FaultPlan(seed=3).spill_torn()
    want, st, _ = _boot(weights, programs.ProgramArtifactCache(
        root, fsync=False, chaos=plan), **kw)
    ladder = st["aot_cache_published_total"]
    got, st, _ = _boot(
        weights, programs.ProgramArtifactCache(root, fsync=False), **kw)
    assert st["aot_cache_load_failures_total"] == 1
    assert st["aot_cache_misses_total"] == 1
    assert st["aot_cache_published_total"] == 1
    assert st["aot_cache_hits_total"] == ladder - 1
    assert got == want


def test_no_cache_io_once_armed(weights, tmp_path, monkeypatch):
    """After warmup the cache is never read or written: serving the
    warmed shapes, and a shape warmup never ran (a counted capture),
    with ``load`` and ``publish`` made to raise."""
    _, _, _, _, programs = _port()
    cache = programs.ProgramArtifactCache(str(tmp_path), fsync=False)
    eng = _engine(weights, cache, **VARIANTS["slot_pool"])
    try:
        eng.warmup([(1, 32)])
        before = _aot(eng.stats())

        def boom(*a, **k):
            raise AssertionError("program-cache I/O after warmup")

        monkeypatch.setattr(cache, "load", boom)
        monkeypatch.setattr(cache, "publish", boom)
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        assert all(len(r.wait(WAIT_S)) == NEW for r in reqs)
        st = eng.stats()
        assert st["graph_captures_total"] > 0  # unwarmed shapes captured
        monkeypatch.undo()
        assert _aot(eng.stats()) == before
    finally:
        eng.stop()


def test_warmup_trace_carries_outcomes_and_meta(weights, tmp_path):
    """The ``engine.warmup`` trace: one ``warmup.miss`` span a program on
    a cold root, ``warmup.hit`` on a warm one, ``aot_hits`` /
    ``aot_misses`` in its meta."""
    _, _, _, _, programs = _port()
    rows = []
    for _ in range(2):
        eng = _engine(weights, programs.ProgramArtifactCache(
            str(tmp_path), fsync=False), **VARIANTS["chunked_paged"])
        try:
            eng.warmup([(1, 32)])
            rows.append(eng._warmup_trace.to_dict())
        finally:
            eng.stop()
    for row, name in zip(rows, ("warmup.miss", "warmup.hit")):
        assert row["spans"] and all(s["name"] == name for s in row["spans"])
        assert all(s["attrs"]["family"] for s in row["spans"])
    assert rows[0]["meta"]["aot_misses"] == len(rows[0]["spans"])
    assert rows[1]["meta"] == {"aot_hits": len(rows[1]["spans"]),
                               "aot_misses": 0}


def test_controller_wake_warm_derivation(weights, tmp_path):
    """``_wake_was_warm`` on real port engines: a warm boot is warm; a
    cold boot, a cache-off engine, or one cold replica beside a warm one
    keep the wake on the cold budget."""
    _, _, _, _, programs = _port()
    from kubeflow_tpu_torch.serving.controller import (
        InferenceServiceController,
    )

    class _Srv:
        def __init__(self, *engines):
            self._e = {f"m{i}": e for i, e in enumerate(engines)}

        def engines(self):
            return self._e

    def boot(cache):
        eng = _engine(weights, cache, **VARIANTS["chunked_paged"])
        eng.warmup([(1, 32)])
        return eng

    root = str(tmp_path)
    engines = [boot(programs.ProgramArtifactCache(root, fsync=False))
               for _ in range(2)]
    cold, warm = engines
    nocache = boot(None)
    try:
        fn = InferenceServiceController._wake_was_warm
        assert fn([_Srv(warm)]) is True
        assert fn([_Srv(cold)]) is False
        assert fn([_Srv(nocache)]) is False
        assert fn([_Srv(warm), _Srv(cold)]) is False
    finally:
        for eng in (cold, warm, nocache):
            eng.stop()


# -- the kernel libraries ------------------------------------------------------

STUB = """\
#!{python}
import sys
if sys.argv[1:] == ["--version"]:
    print("Cuda compilation tools, release 12.9, V12.9.86")
    sys.exit(0)
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
out = sys.argv[sys.argv.index("-o") + 1]
src = sys.argv[-1]
with open(out, "wb") as f:
    f.write(b"stub library of " + src.encode() * 64)
"""

#: one process of the library test: ``_build`` pointed at a build dir,
#: ``ctypes.CDLL`` recording instead of loading; prints what happened
CHILD = """\
import ctypes, json, sys
from pathlib import Path
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.serving.programs import ProgramArtifactCache
_build.BUILD_DIR = Path(sys.argv[1])
opened = []
ctypes.CDLL = lambda path: opened.append(path) or path
cache = ProgramArtifactCache(sys.argv[2], fsync=False)
outcomes = _build.load_through(cache)
print(json.dumps({"outcomes": outcomes, "opened": opened,
                  "stats": cache.stats()}))
"""


def _library_process(build_dir, root, env) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(build_dir),
                          str(root)], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=env, check=True)
    return json.loads(out.stdout.splitlines()[-1])


def test_kernel_libraries_go_through_the_cache(tmp_path):
    """A first process builds every library with the (stub) compiler and
    publishes it; a second one with an empty build dir takes each from
    the cache (bytes checked before the load) and compiles nothing; a
    torn entry is counted, deleted, rebuilt and republished."""
    toolkit = tmp_path / "cuda"
    (toolkit / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = toolkit / "bin" / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    env = {**os.environ, "PATH": f"{toolkit / 'bin'}{os.pathsep}"
           f"{os.environ['PATH']}", "PYTHONPATH": ROOT}
    root = tmp_path / "aot"

    first = _library_process(tmp_path / "build1", root, env)
    kernels = sorted(first["outcomes"])
    runs = log.read_text().splitlines()
    assert len(runs) == len(kernels)  # one compile a library, no more
    assert set(first["outcomes"].values()) == {"miss"}
    assert first["stats"]["aot_cache_published_total"] == len(kernels)
    assert len(first["opened"]) == len(kernels)

    second = _library_process(tmp_path / "build2", root, env)
    assert log.read_text().splitlines() == runs  # no compile
    assert set(second["outcomes"].values()) == {"hit"}
    assert second["stats"]["aot_cache_hits_total"] == len(kernels)
    assert second["stats"]["aot_cache_misses_total"] == 0
    for a, b in zip(sorted(first["opened"]), sorted(second["opened"])):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()

    # tear the gmm library's entry: the next empty build dir rebuilds it
    torn = [d for d in root.iterdir() if not d.name.startswith(".")
            and "libgmm-" in (d / "artifact.json").read_text()]
    assert len(torn) == 1
    payload = torn[0] / "program.bin"
    with open(payload, "r+b") as f:
        f.truncate(payload.stat().st_size // 2)
    third = _library_process(tmp_path / "build3", root, env)
    assert third["outcomes"]["gmm"] == "miss"
    assert {n: o for n, o in third["outcomes"].items() if n != "gmm"} == \
        {n: "hit" for n in kernels if n != "gmm"}
    assert third["stats"]["aot_cache_load_failures_total"] == 1
    assert third["stats"]["aot_cache_published_total"] == 1
    rebuilt = log.read_text().splitlines()[len(runs):]
    assert len(rebuilt) == 1 and rebuilt[0].endswith("gmm.cu")


def test_kernel_library_key_names_release_and_target(tmp_path, monkeypatch):
    """A library's cache signature: its hashed file name, the compiler's
    release as ``nvcc --version`` prints it, and the target."""
    from kubeflow_tpu_torch.ops import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable,
                                log=str(tmp_path / "log")))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_release", {})
    sig = _build.library_sig("gmm")
    assert sig == "|".join(("gmm", _build.library_path("gmm").name,
                            "12.9.86", "sm_90a"))
