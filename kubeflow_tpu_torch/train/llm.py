"""The LLM training pod entry: the packaged fine-tune/pretrain main.

The port's copy of ``kubeflow_tpu/train/llm.py``: the ``Trainer`` on one
card behind a job, configured by the same env knobs (the CRD-env contract
the controller injects), emitting the same metrics.

Env knobs (all optional):
  KFT_MODEL_PRESET  llama preset name (default "tiny")
  KFT_INIT_FROM     pretrained snapshot to fine-tune from: hf://org/name@rev
                    or file:///path (resolved through the storage
                    initializer).  The snapshot's config.json defines the
                    architecture; weights load before step 0; a newer
                    checkpoint in KFT_CKPT_DIR still wins (resume > init)
  KFT_LORA_RANK     > 0: LoRA adapters on the snapshot, the base frozen
  KFT_STEPS, KFT_BATCH, KFT_SEQ_LEN, KFT_LR, KFT_WARMUP, KFT_CKPT_DIR,
  KFT_SAVE_EVERY, KFT_LOG_EVERY
  KFT_PUBLISH_TO    publish the trained model there: the adapters alone
                    (save_adapter) under LoRA, else a full save_pretrained
  KFT_PBT_ROOT      population-based-training checkpoint root: this job
                    checkpoints under <root>/<job_name>, and when
                    KFT_RESUME_FROM names a sibling trial, its checkpoint
                    is forked before training (the exploit step)
  KFT_RESUME_FROM   parent trial name to fork from ("" = fresh)
  KFT_CORPUS_DIR    a tokenized corpus (``native_data.TokenCorpus``):
                    shuffled, EOS-packed rows of seq_len + 1 through the
                    native loader instead of the synthetic stream
  KFT_EOS_ID        the separator the packing puts between documents (0)

Run a job's process as ``python -m kubeflow_tpu_torch.train.llm``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Optional

from ..models import llama as llamalib
from ..runtime import bootstrap
from . import trainer as trainlib

PBT_BASE_STEP_FILE = "pbt_base_step"


def _latest_step_on_disk(ckpt_dir: str) -> int:
    """Largest step directory (int-named subdirs), without a manager."""
    try:
        steps = [int(n) for n in os.listdir(ckpt_dir) if n.isdigit()]
    except OSError:
        return 0
    return max(steps, default=0)


def _pbt_checkpoint_dir(ctx: bootstrap.PodContext) -> Optional[str]:
    """PBT checkpoint-fork contract: own dir under KFT_PBT_ROOT; exploit =
    copy the parent trial's checkpoints before the first save/restore. The
    fork's baseline step is recorded once (``pbt_base_step``) so a restart
    mid-trial keeps the original training horizon."""
    root = os.environ.get("KFT_PBT_ROOT")
    if not root:
        return None
    own = os.path.join(root, ctx.job_name)
    parent = os.environ.get("KFT_RESUME_FROM", "").strip()
    if ctx.is_coordinator and not os.path.isdir(own):
        if parent:
            parent_dir = os.path.join(root, parent)
            if not os.path.isdir(parent_dir):
                # a fork of nothing must fail, not silently train from
                # scratch while ranked against continued lineages
                raise RuntimeError(
                    f"PBT fork parent {parent!r} has no checkpoint dir "
                    f"under {root}; refusing to start from scratch")
            shutil.copytree(parent_dir, own)
        else:
            os.makedirs(own, exist_ok=True)
        # our baseline is the parent's latest step, not its own baseline
        with open(os.path.join(own, PBT_BASE_STEP_FILE), "w") as f:
            f.write(str(_latest_step_on_disk(own)))
    return own


def _pbt_base_step(ckpt_dir: str) -> int:
    try:
        with open(os.path.join(ckpt_dir, PBT_BASE_STEP_FILE)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return 0


def config_from_env(ctx: bootstrap.PodContext) -> trainlib.TrainConfig:
    e = os.environ
    if any(n > 1 for n in ctx.mesh_axes.values()):
        raise NotImplementedError(
            f"mesh {ctx.mesh_axes}: a sharded job is not ported yet "
            "(ROADMAP A5)")
    init_from = e.get("KFT_INIT_FROM") or None
    if init_from:
        # the snapshot defines the architecture: KFT_MODEL_PRESET is
        # ignored so the job never fine-tunes a mismatched shape
        from ..serving.storage import download

        init_from = download(init_from)
        model = llamalib.load_pretrained_config(init_from)
    else:
        model = llamalib.PRESETS[e.get("KFT_MODEL_PRESET", "tiny")]()
    lora_rank = int(e.get("KFT_LORA_RANK", "0"))
    if lora_rank > 0:
        model = dataclasses.replace(model, lora_rank=lora_rank)
    ckpt_dir = _pbt_checkpoint_dir(ctx) or e.get("KFT_CKPT_DIR") or None
    steps = int(e.get("KFT_STEPS", "10"))
    if e.get("KFT_PBT_ROOT") and ckpt_dir:
        # PBT: KFT_STEPS means this many more steps past the fork baseline
        steps += _pbt_base_step(ckpt_dir)
    return trainlib.TrainConfig(
        model=model,
        init_from=init_from,
        global_batch=int(e.get("KFT_BATCH", "8")),
        seq_len=int(e.get("KFT_SEQ_LEN", "64")),
        steps=steps,
        learning_rate=float(e.get("KFT_LR", "3e-4")),
        warmup_steps=int(e.get("KFT_WARMUP", "5")),
        checkpoint_dir=ckpt_dir,
        save_interval_steps=int(e.get("KFT_SAVE_EVERY", "100")),
        log_every=int(e.get("KFT_LOG_EVERY", "5")),
    )


def source_from_env(cfg: trainlib.TrainConfig):
    """KFT_CORPUS_DIR -> PackedLmCorpus over the native loader; else None
    (the trainer defaults to the hermetic synthetic stream)."""
    corpus_dir = os.environ.get("KFT_CORPUS_DIR")
    if not corpus_dir:
        return None
    from .native_data import PackedLmCorpus, TokenCorpus

    corpus = TokenCorpus.open(corpus_dir)
    if corpus.n_tokens and int(corpus.tokens.max()) >= cfg.model.vocab_size:
        # fail fast: out-of-range ids would be silently clamped by the
        # embedding gather and the job would "succeed" on garbage
        raise ValueError(
            f"corpus {corpus_dir} has token id {int(corpus.tokens.max())} "
            f">= model vocab_size {cfg.model.vocab_size}; pick a larger "
            "KFT_MODEL_PRESET or retokenize")
    return PackedLmCorpus(
        corpus,
        cfg.global_batch,
        cfg.seq_len,
        eos=int(os.environ.get("KFT_EOS_ID", "0")),
    )


def train_main(ctx: bootstrap.PodContext, *, device=None) -> trainlib.Trainer:
    """The job's process: train, emit the metrics from the coordinator,
    publish. ``device``: the pod's (``KFT_POD_DEVICE``, else the card) by
    default. Returns the trainer."""
    cfg = config_from_env(ctx)
    source = source_from_env(cfg)
    t = trainlib.Trainer(cfg, device=bootstrap.pod_device(ctx, device))
    if ctx.is_coordinator and t.ckpt is not None:
        # observable resume marker: > 0 when a restart picked up a
        # checkpoint
        bootstrap.emit_metric(ctx, "resume_step", t.ckpt.latest_step() or 0)

    def on_metrics(m: trainlib.StepMetrics) -> None:
        if ctx.is_coordinator:
            bootstrap.emit_metric(ctx, "loss", m.loss, step=m.step)
            bootstrap.emit_metric(
                ctx, "tokens_per_sec_per_chip", m.tokens_per_sec_per_chip,
                step=m.step)

    final = t.train(source=source, on_metrics=on_metrics)
    if ctx.is_coordinator and final is not None:
        bootstrap.emit_metric(ctx, "final_loss", final.loss)
        bootstrap.emit_metric(ctx, "mfu", final.mfu)
    publish_to = os.environ.get("KFT_PUBLISH_TO")
    if publish_to and t.final_state is not None and ctx.is_coordinator:
        # adapter-only under LoRA (MB-scale), a full snapshot otherwise
        params = t.final_state["params"]
        if cfg.model.lora_rank > 0:
            llamalib.save_adapter(publish_to, cfg.model, params)
        else:
            llamalib.save_pretrained(publish_to, cfg.model, params)
        bootstrap.emit_metric(ctx, "published", 1.0)
    return t


def main() -> None:
    train_main(bootstrap.initialize())


if __name__ == "__main__":
    main()
