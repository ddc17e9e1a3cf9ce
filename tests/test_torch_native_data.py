"""The port's corpus input pipeline (``kubeflow_tpu_torch/train/
native_data.py`` over its own g++-built ``native/`` library) against the
reference's ``kubeflow_tpu/train/native_data.py``.

- ``shuffle_indices``, ``pack_sequences``, ``gather_batch`` equal the
  reference's exactly, on the native library and on the NumPy fallback;
  ``PackedLmCorpus.local_batch`` equals the reference's for every step of
  two epochs, and the port's library has its own file name.
- 3 steps of the port's ``Trainer`` on a packed corpus against the
  reference trainer's on the same corpus: losses within 1e-4 relative.
- ``train/llm.py``: ``source_from_env`` reads ``KFT_CORPUS_DIR`` and
  ``KFT_EOS_ID``, refuses an out-of-vocab corpus with the reference's
  message, and ``train_main`` trains on exactly the packed batches.

torch and the port are imported inside the tests.
"""

import os
import shutil

import jax
import numpy as np
import pytest
from flax import linen as nn

from kubeflow_tpu import native as ref_native
from kubeflow_tpu.models import llama as ref_llama
from kubeflow_tpu.train import data as ref_data
from kubeflow_tpu.train import llm as ref_llm
from kubeflow_tpu.train import native_data as ref
from kubeflow_tpu.train import trainer as ref_train

EOS = 99
STEPS, BATCH, SEQ = 3, 4, 32
ENV_KEYS = ("KFT_CORPUS_DIR", "KFT_EOS_ID", "KFT_STEPS", "KFT_BATCH",
            "KFT_SEQ_LEN", "KFT_LOG_EVERY", "KFT_MODEL_PRESET",
            "KFT_INIT_FROM", "KFT_LORA_RANK", "KFT_CKPT_DIR",
            "KFT_PUBLISH_TO", "KFT_PBT_ROOT", "KFT_POD_DEVICE")


def _port():
    import torch

    from kubeflow_tpu_torch import native
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.train import llm, native_data, trainer

    torch.set_num_threads(1)
    return torch, native, native_data, llama, trainer, llm, bootstrap


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


def _docs(n=40, vocab=90, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(k)).astype(np.int32)
            for k in rng.integers(3, 60, size=n)]


def test_native_library_is_the_ports_own():
    _, native, *_ = _port()
    if shutil.which("g++"):
        assert native.load_library() is not None
        assert ref_native.load_library() is not None
    assert native.LIB_NAME != "libkft_data.so"


@pytest.mark.parametrize("fallback", [False, True],
                         ids=["native", "fallback"])
def test_kernels_equal_reference(fallback, tmp_path):
    _, _, nd, *_ = _port()
    for n, seed in ((1, 0), (2, 1), (100, 7), (1000, 12345)):
        np.testing.assert_array_equal(
            nd.shuffle_indices(n, seed, force_fallback=fallback),
            ref.shuffle_indices(n, seed))
    c = ref.TokenCorpus.write(str(tmp_path / "c"), _docs(7))
    order = ref.shuffle_indices(c.n_docs, 42)
    for row0, n_seqs, seq_len in ((0, 4, 7), (2, 3, 7), (0, 64, 5),
                                  (10, 8, 3)):
        got, rows = nd.pack_sequences(c.tokens, c.offsets, order, EOS,
                                      seq_len, row0, n_seqs,
                                      force_fallback=fallback)
        want, want_rows = ref.pack_sequences(c.tokens, c.offsets, order,
                                             EOS, seq_len, row0, n_seqs)
        np.testing.assert_array_equal(got, want)
        assert rows == want_rows
    data = np.random.default_rng(1).integers(0, 1000, (50, 9)).astype(
        np.int32)
    idx = np.array([3, 0, 49, 3, 17], np.uint64)
    np.testing.assert_array_equal(
        nd.gather_batch(data, idx, force_fallback=fallback),
        ref.gather_batch(data, idx))


def test_packed_corpus_batches_equal_reference(tmp_path):
    _, _, nd, *_ = _port()
    ref.TokenCorpus.write(str(tmp_path / "c"), _docs())
    port = nd.PackedLmCorpus(nd.TokenCorpus.open(str(tmp_path / "c")),
                             BATCH, SEQ, eos=EOS, seed=5)
    want = ref.PackedLmCorpus(ref.TokenCorpus.open(str(tmp_path / "c")),
                              BATCH, SEQ, eos=EOS, seed=5,
                              process_index=0, process_count=1)
    assert port.batches_per_epoch == want.batches_per_epoch >= 2
    assert (port.proc, port.nproc) == (0, 1)
    for step in range(2 * port.batches_per_epoch + 1):
        np.testing.assert_array_equal(port.local_batch(step)["tokens"],
                                      want.local_batch(step)["tokens"])


def test_trainer_on_packed_corpus_matches_reference(tmp_path):
    torch, _, nd, llama, trainer, *_ = _port()
    ref.TokenCorpus.write(str(tmp_path / "c"), _docs(vocab=256))
    cfg = ref_train.TrainConfig(
        model=ref_llama.tiny(), global_batch=BATCH, seq_len=SEQ,
        steps=STEPS, warmup_steps=2, log_every=1, mu_dtype=None)
    t = ref_train.Trainer(cfg, devices=jax.devices()[:1])
    state = t.init_state(0)
    init = jax.tree.map(np.array, nn.meta.unbox(state["params"]))
    step_fn = t.compiled_step()
    source = ref.PackedLmCorpus(ref.TokenCorpus.open(str(tmp_path / "c")),
                                BATCH, SEQ, process_index=0,
                                process_count=1)
    want = []
    for batch in ref_data.device_batches(source, t.batch_sharding, STEPS):
        state, out = step_fn(state, batch)
        want.append(float(out["loss"]))
    pcfg = trainer.TrainConfig(
        model=llama.tiny(), global_batch=BATCH, seq_len=SEQ, steps=STEPS,
        warmup_steps=2, log_every=1, mu_dtype=None)
    port = trainer.Trainer(pcfg, device="cpu")
    port.load_params(init)
    corpus = nd.PackedLmCorpus(nd.TokenCorpus.open(str(tmp_path / "c")),
                               BATCH, SEQ)
    got = [float(port.step(corpus.local_batch(s)["tokens"])[0])
           for s in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_source_from_env_reads_the_corpus(tmp_path, monkeypatch):
    torch, _, nd, llama, trainer, llm, bootstrap = _port()
    ref.TokenCorpus.write(str(tmp_path / "c"), _docs(vocab=256))
    for k, v in {"KFT_CORPUS_DIR": tmp_path / "c", "KFT_EOS_ID": 7,
                 "KFT_STEPS": 2, "KFT_BATCH": BATCH, "KFT_SEQ_LEN": SEQ,
                 "KFT_LOG_EVERY": 1,
                 "KFT_STATUS_DIR": tmp_path / "s"}.items():
        monkeypatch.setenv(k, str(v))
    ctx = bootstrap.PodContext.from_env()
    src = llm.source_from_env(llm.config_from_env(ctx))
    assert isinstance(src, nd.PackedLmCorpus)
    assert (src.eos, src.global_batch, src.seq_len) == (7, BATCH, SEQ)
    seen = []
    real = trainer.Trainer.loss_and_grads

    def record(self, tokens):
        seen.append(np.asarray(tokens).copy())
        return real(self, tokens)

    monkeypatch.setattr(trainer.Trainer, "loss_and_grads", record)
    t = llm.train_main(ctx, device="cpu")
    assert t.opt.count == 2 and len(seen) == 2
    for step, tokens in enumerate(seen):
        np.testing.assert_array_equal(tokens, src.local_batch(step)["tokens"])
    # an id past the vocab: refused, with the reference's message
    ref.TokenCorpus.write(str(tmp_path / "big"),
                          [np.array([1, 2, 300], np.int32)])
    monkeypatch.setenv("KFT_CORPUS_DIR", str(tmp_path / "big"))
    with pytest.raises(ValueError) as got:
        llm.source_from_env(llm.config_from_env(ctx))
    with pytest.raises(ValueError) as want:
        ref_llm.source_from_env(ref_llm.config_from_env(
            ref_llm.bootstrap.PodContext()))
    assert str(got.value) == str(want.value)
    assert "vocab_size 256" in str(got.value)
