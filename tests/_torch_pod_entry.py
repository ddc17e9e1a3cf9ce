"""Pod entries for ``tests/test_torch_launcher.py``'s several-card pods.

Each runs inside ``python -m kubeflow_tpu_torch.runtime.pod_main`` as one
local rank of a pod, after the job's rendezvous and the gang barrier.
"""

import os
import time


def train_main(ctx) -> None:
    """``train/llm.py``'s trainer on the job's mesh (``KFT_MESH``), from
    ``KFT_INIT_FROM``; every rank prints each step's global loss as
    ``loss=<repr> process=<global rank>`` (``llm.train_main`` prints the
    coordinator's only)."""
    from kubeflow_tpu_torch.runtime import bootstrap
    from kubeflow_tpu_torch.train import llm, trainer

    cfg = llm.config_from_env(ctx)
    t = trainer.Trainer(cfg, device=bootstrap.pod_device(ctx))
    source = llm.source_from_env(cfg, t.batch_index, t.batch_count)
    t.train(source=source, on_metrics=lambda m: print(
        f"loss={m.loss!r} process={ctx.process_id}", flush=True))


def fail_on_local_1(ctx) -> None:
    """Local rank 1 fails at once; every other rank waits to be ended."""
    if os.environ.get("KFT_LOCAL_RANK") == "1":
        raise RuntimeError("local rank 1 fails on purpose")
    time.sleep(120)
