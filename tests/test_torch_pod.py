"""The port's pod entry (``train/llm.py``, ``runtime/bootstrap.py``), the
model-source half of ``serving/storage.py`` and the int8 serving of a
published fine-tune, against the reference on tiny() (CPU, f32).

torch and the port are imported inside the tests (``_port``): imported at
collection they would sit in every test worker's heap and slow the other
files' tests.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu.models import llama as ref
from kubeflow_tpu.runtime import bootstrap as ref_boot
from kubeflow_tpu.serving import continuous as ref_cont
from kubeflow_tpu.serving import storage as ref_storage
from kubeflow_tpu.train import llm as ref_llm

WAIT_S = 120
WARM = [(1, 32), (2, 32), (1, 64), (2, 64)]
ENV_KEYS = ("KFT_INIT_FROM", "KFT_MODEL_PRESET", "KFT_LORA_RANK",
            "KFT_STEPS", "KFT_BATCH", "KFT_SEQ_LEN", "KFT_LR", "KFT_WARMUP",
            "KFT_CKPT_DIR", "KFT_SAVE_EVERY", "KFT_LOG_EVERY",
            "KFT_PUBLISH_TO", "KFT_PBT_ROOT", "KFT_RESUME_FROM",
            "KFT_CORPUS_DIR", "KFT_MODEL_CACHE", "KFT_HF_HOME")


def _port():
    import torch

    from kubeflow_tpu_torch.models import convert, llama
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.serving import continuous, storage
    from kubeflow_tpu_torch.train import llm

    torch.set_num_threads(1)
    return types.SimpleNamespace(torch=torch, llama=llama, convert=convert,
                                 bootstrap=bootstrap, continuous=continuous,
                                 storage=storage, llm=llm)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


def _init(rcfg, seed=0):
    params = ref.Llama(rcfg).init(jax.random.PRNGKey(seed),
                                  jnp.ones((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, nn.meta.unbox(params))


def _base_snapshot(path):
    ref.save_pretrained(path, ref.tiny(), _init(ref.tiny()))
    return path


def _env(monkeypatch, **kv):
    for k, v in kv.items():
        monkeypatch.setenv(k, str(v))


# -- the pod entry ---------------------------------------------------------------


def _common_fields(pt, rcfg, pcfg):
    for f in dataclasses.fields(pcfg):
        if not hasattr(rcfg, f.name):
            continue
        a, b = getattr(pcfg, f.name), getattr(rcfg, f.name)
        if f.name == "model":
            for mf in dataclasses.fields(a):
                x, y = getattr(a, mf.name), getattr(b, mf.name)
                if isinstance(x, pt.torch.dtype):
                    assert str(x).removeprefix("torch.") == \
                        jnp.dtype(y).name, mf.name
                else:
                    assert x == y, mf.name
        elif f.name not in ("mu_dtype",):
            assert a == b, f.name


@pytest.mark.parametrize("case", ["preset", "init_from_lora"])
def test_config_from_env_matches_reference(tmp_path, monkeypatch, case):
    pt = _port()
    _env(monkeypatch, KFT_STEPS=7, KFT_BATCH=4, KFT_SEQ_LEN=32, KFT_LR=1e-3,
         KFT_WARMUP=2, KFT_CKPT_DIR=tmp_path / "ckpt", KFT_SAVE_EVERY=3,
         KFT_LOG_EVERY=1)
    if case == "preset":
        _env(monkeypatch, KFT_MODEL_PRESET="llama2-7b")
    else:
        snap = _base_snapshot(str(tmp_path / "base"))
        _env(monkeypatch, KFT_INIT_FROM=f"file://{snap}", KFT_LORA_RANK=4)
    want = ref_llm.config_from_env(ref_boot.PodContext())
    got = pt.llm.config_from_env(pt.bootstrap.PodContext())
    _common_fields(pt, want, got)
    assert got.model.lora_rank == (4 if case != "preset" else 0)


def _metrics(status_dir):
    with open(os.path.join(status_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_main_fine_tunes_resumes_and_publishes(tmp_path, monkeypatch,
                                                     capsys):
    pt = _port()
    snap = _base_snapshot(str(tmp_path / "base"))
    status = str(tmp_path / "status")
    _env(monkeypatch, KFT_INIT_FROM=f"file://{snap}", KFT_LORA_RANK=4,
         KFT_STEPS=3, KFT_BATCH=4, KFT_SEQ_LEN=16, KFT_WARMUP=1,
         KFT_CKPT_DIR=tmp_path / "ckpt", KFT_SAVE_EVERY=2, KFT_LOG_EVERY=1,
         KFT_PUBLISH_TO=tmp_path / "adapter", KFT_STATUS_DIR=status)
    ctx = pt.bootstrap.initialize()
    first = pt.llm.train_main(ctx, device="cpu")
    names = [m["name"] for m in _metrics(status)]
    assert names[0] == "resume_step" and _metrics(status)[0]["value"] == 0
    for name in ("loss", "tokens_per_sec_per_chip", "final_loss", "mfu",
                 "published"):
        assert name in names, name
    assert "published=1.0" in capsys.readouterr().out
    assert first.ckpt.all_steps() == [1, 2, 3]
    # the published adapter is adapter-only and the reference loads it
    assert sorted(os.listdir(tmp_path / "adapter")) == [
        "adapter.msgpack", "config.json"]
    rcfg, radapters = ref.load_adapter(str(tmp_path / "adapter"))
    assert rcfg.lora_rank == 4
    _, mine = pt.llama.split_lora(first.model)
    want = pt.convert.state_dict_from_jax(radapters, first.cfg.model,
                                          partial=True)
    assert want.keys() == mine.keys()
    for k in mine:
        assert pt.torch.equal(mine[k], want[k])
    # a second incarnation resumes at step 3 and trains steps 4-5 only
    _env(monkeypatch, KFT_STEPS=5)
    os.remove(os.path.join(status, "metrics.jsonl"))
    second = pt.llm.train_main(ctx, device="cpu")
    rows = _metrics(status)
    assert rows[0] == {**rows[0], "name": "resume_step", "value": 3}
    assert [r["step"] for r in rows if r["name"] == "loss"] == [4, 5]
    assert second.opt.count == 5


def test_pbt_fork_copies_the_parent(tmp_path, monkeypatch):
    pt = _port()
    root = tmp_path / "pbt"
    (root / "parent" / "3").mkdir(parents=True)
    (root / "parent" / "3" / "state.pt").write_bytes(b"x")
    _env(monkeypatch, KFT_PBT_ROOT=root, KFT_RESUME_FROM="parent",
         KFT_STEPS=4)
    ctx = pt.bootstrap.PodContext(job_name="child")
    cfg = pt.llm.config_from_env(ctx)
    assert cfg.checkpoint_dir == str(root / "child")
    assert (root / "child" / "3" / "state.pt").exists()
    assert (root / "child" / "pbt_base_step").read_text() == "3"
    assert cfg.steps == 4 + 3
    rcfg = ref_llm.config_from_env(ref_boot.PodContext(job_name="child"))
    assert rcfg.steps == cfg.steps and rcfg.checkpoint_dir == \
        cfg.checkpoint_dir


def test_pbt_fork_refuses_a_missing_parent(tmp_path, monkeypatch):
    pt = _port()
    _env(monkeypatch, KFT_PBT_ROOT=tmp_path, KFT_RESUME_FROM="ghost")
    with pytest.raises(RuntimeError, match="refusing to start from scratch"):
        pt.llm.config_from_env(pt.bootstrap.PodContext(job_name="child"))


def test_pod_context_from_env_equals_the_reference():
    pt = _port()
    env = {"JAX_COORDINATOR_ADDRESS": "job-0.ns.svc:1234",
           "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2",
           "KFT_JOB_NAME": "ft", "KFT_JOB_NAMESPACE": "team",
           "KFT_REPLICA_TYPE": "worker", "KFT_REPLICA_INDEX": "2",
           "KFT_MESH": json.dumps({"data": 4}), "KFT_STATUS_DIR": "/s"}
    got = pt.bootstrap.PodContext.from_env(env)
    want = ref_boot.PodContext.from_env(env)
    # the port's fields more: the pod's device (unset = the card), the
    # process group's backend (unset = by the device), the pod's card ids
    # and the local rank of a process of a several-card pod
    assert got.device is None and got.dist_backend is None
    assert dataclasses.asdict(got) == {**dataclasses.asdict(want),
                                       "device": None, "dist_backend": None,
                                       "cards": [], "local_rank": None}
    assert pt.bootstrap.PodContext.from_env(
        {**env, "KFT_POD_DEVICE": "cpu"}).device == "cpu"
    cpu = pt.bootstrap.PodContext.from_env({**env, "KFT_POD_DEVICE": "cpu"})
    assert pt.bootstrap.dist_backend(cpu) == "gloo"
    assert pt.bootstrap.dist_backend(pt.bootstrap.PodContext.from_env(
        {**env, "KFT_DIST_BACKEND": "nccl"})) == "nccl"
    assert got.is_coordinator == want.is_coordinator is False
    for addr in ("job-0.ns.svc:1234", "10.0.0.3:80",
                 "a.b.svc.cluster.local:9"):
        assert pt.bootstrap.resolve_coordinator(addr) == \
            ref_boot.resolve_coordinator(addr)


def test_unported_pod_paths_name_their_roadmap_items(tmp_path, monkeypatch):
    pt = _port()
    # a job of several processes joins a process group: it needs its
    # coordinator (ROADMAP A5 is ported)
    with pytest.raises(RuntimeError, match="coordinator address"):
        pt.bootstrap.initialize(pt.bootstrap.PodContext(num_processes=2))
    # the seq and pipeline axes are ported (ROADMAP A9, A10): a mesh of
    # several ranks needs the job's process group
    for axes in ({"seq": 2}, {"pipeline": 2}):
        with pytest.raises(RuntimeError, match="initialised process group"):
            pt.llm.train_main(pt.bootstrap.PodContext(mesh_axes=axes),
                              device="cpu")


def test_emit_metric_writes_both_channels(tmp_path, capsys):
    pt = _port()
    ctx = pt.bootstrap.PodContext(status_dir=str(tmp_path))
    pt.bootstrap.emit_metric(ctx, "loss", 1.5, step=3)
    assert capsys.readouterr().out == "loss=1.5\n"
    (row,) = _metrics(str(tmp_path))
    assert row["name"] == "loss" and row["value"] == 1.5 and row["step"] == 3


# -- storage -----------------------------------------------------------------------


def _hub(root, repo="org/name", commit="abc123def", ref_name="main"):
    repo_dir = root / ("models--" + repo.replace("/", "--"))
    snap = repo_dir / "snapshots" / commit
    snap.mkdir(parents=True)
    (snap / "config.json").write_text("{}")
    (repo_dir / "refs").mkdir()
    (repo_dir / "refs" / ref_name).write_text(commit)
    return snap


@pytest.mark.parametrize("uri", ["hf://org/name", "hf://org/name@main",
                                 "hf://org/name@abc1", "hf://org/name@zzz"])
def test_resolve_hf_matches_the_reference(tmp_path, uri):
    pt = _port()
    _hub(tmp_path)
    try:
        want = ref_storage.resolve_hf(uri, hf_root=str(tmp_path))
    except ref_storage.StorageError:
        with pytest.raises(pt.storage.StorageError):
            pt.storage.resolve_hf(uri, hf_root=str(tmp_path))
        return
    assert pt.storage.resolve_hf(uri, hf_root=str(tmp_path)) == want


def test_download_and_the_manifest_cache(tmp_path):
    pt = _port()
    src = tmp_path / "model"
    src.mkdir()
    (src / "weights.bin").write_bytes(b"w" * 100)
    uri = f"file://{src}"
    assert pt.storage.download(uri) == str(src)
    cache = str(tmp_path / "cache")
    staged = pt.storage.download(uri, cache_dir=cache)
    entry = os.path.dirname(staged)
    assert pt.storage.verify_manifest(entry)
    with open(os.path.join(entry, "manifest.json")) as f:
        manifest = json.load(f)
    want = ref_storage.build_manifest(uri, staged)
    assert [(r["path"], r["size"], r["sha256"]) for r in manifest["files"]] \
        == [(r["path"], r["size"], r["sha256"]) for r in want["files"]]
    with open(os.path.join(staged, "weights.bin"), "wb") as f:
        f.write(b"corrupt")
    pt.storage._verified_entries.clear()
    assert pt.storage.download(uri, cache_dir=cache) == staged
    with open(os.path.join(staged, "weights.bin"), "rb") as f:
        assert f.read() == b"w" * 100  # re-staged
    key = pt.storage.register_mem("m", ("cfg", {}))
    assert pt.storage.download(key) == key
    assert pt.storage.fetch_mem("m") == ("cfg", {})
    for bad in ("http://x/y", "gs://bucket/m", "ftp://z"):
        with pytest.raises(pt.storage.StorageError):
            pt.storage.download(bad)


# -- int8 serving of a published fine-tune ------------------------------------------


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """A reference base snapshot and a reference adapter (nonzero B) on
    it."""
    root = tmp_path_factory.mktemp("published")
    base = _base_snapshot(str(root / "base"))
    acfg = ref.tiny(lora_rank=4)
    params = _init(acfg, seed=1)
    rng = np.random.default_rng(2)
    for mod in params["layers"]["block"]["attn"].values():
        if "lora_b" in mod:
            mod["lora_b"] = rng.normal(0, 0.05, mod["lora_b"].shape).astype(
                np.float32)
    ref.save_adapter(str(root / "adapter"), acfg, params)
    return base, str(root / "adapter")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, size=n).tolist() for n in (3, 17, 40, 9)]


def _serve(engine, new=8):
    try:
        reqs = [engine.submit(p, max_new_tokens=new) for p in _prompts()]
        return [r.wait(WAIT_S) for r in reqs], engine.stats()
    finally:
        engine.stop()


@pytest.mark.parametrize("pool", [{}, {"block_size": 8}],
                         ids=["slot_pool", "paged"])
def test_quantized_engine_of_a_published_adapter_matches_reference(
        published, pool):
    pt = _port()
    base, adapter = published
    config = {"storage_path": base, "adapter_path": adapter,
              "max_seq_len": 96, "quant_weights": True, "quant_kv": True,
              "num_slots": 2, "decode_chunk": 4, "prefix_cache": False,
              "warmup_groups": WARM, **pool}
    rcfg, rparams = ref_cont.resolve_model_source(config)
    want, _ = _serve(ref_cont.build_engine(rcfg, rparams, config))
    cfg, sd = pt.continuous.resolve_model_source(config)
    assert cfg.max_seq_len == 96 and cfg.lora_rank == 0
    eng = pt.continuous.build_engine(cfg, sd, config, device="cpu")
    assert eng.cfg.quant_weights and eng.cfg.quant_kv
    assert eng.model.layers[0].attn.wq.dtype == pt.torch.int8
    got, stats = _serve(eng)
    assert got == want
    assert stats["graph_captures_total"] == 0
    if pool:
        assert stats["kv_blocks_free"] == stats["kv_blocks_total"]


def test_model_source_needs_a_source():
    pt = _port()
    with pytest.raises(RuntimeError, match="params_ref or storage_path"):
        pt.continuous.resolve_model_source({}, name="m")
    cfg = pt.llama.tiny()
    model = pt.llama.Llama(cfg, device="cpu")
    key = pt.storage.register_mem("pod-test", (cfg, model))
    got_cfg, got = pt.continuous.resolve_model_source(
        {"params_ref": key, "max_seq_len": 32})
    assert got is model and got_cfg.max_seq_len == 32
