"""Checkpoint/resume: the port's ``CheckpointManager``.

The reference's contract (``kubeflow_tpu/train/checkpoint.py``) over
``torch.save`` in one process: step-numbered directories under
``directory``, saved on orbax's default decision (the first checkpoint,
then every ``save_interval_steps`` steps, or when ``force``d), the newest
``max_to_keep`` kept. A step directory appears only
complete: the state is written into a hidden staging directory, flushed and
synced, then renamed to its step number, so a directory named by a step
always holds a whole checkpoint and a torn write is never the latest.

The state is a tree of dicts, lists and tensors (any device); tensors are
written from the CPU and restored onto ``map_location``. Saves are
synchronous: ``wait_until_finished`` has nothing to wait for. Orbax's layout
is not read (the reference's checkpoints restore only in the reference).
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"
STAGING_PREFIX = ".staging-"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, *, save_interval_steps: int = 100,
                 max_to_keep: int = 3):
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1")
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self.directory = os.path.abspath(directory)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):
            if name.startswith(STAGING_PREFIX):  # a dead writer's leftovers
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def should_save(self, step: int) -> bool:
        """Orbax's default decision: past the latest step, and either the
        first checkpoint or a multiple of ``save_interval_steps``."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return latest is None or step % self.save_interval_steps == 0

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Save ``state`` as ``step``; returns True if a save was made
        (``should_save``, or ``force``; never over an existing step)."""
        if step in self.all_steps() or not (force or self.should_save(step)):
            return False
        staging = os.path.join(
            self.directory, f"{STAGING_PREFIX}{step}-{uuid.uuid4().hex[:8]}")
        os.makedirs(staging)
        path = os.path.join(staging, STATE_FILE)
        with open(path, "wb") as f:
            torch.save({"step": int(step), "state": _to_cpu(state)}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(staging)
        os.rename(staging, os.path.join(self.directory, str(step)))
        _fsync_dir(self.directory)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)
        return True

    def restore(self, step: Optional[int] = None, *,
                map_location: Any = "cpu") -> Any:
        """The state saved as ``step`` (default the latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = os.path.join(self.directory, str(step), STATE_FILE)
        saved = torch.load(path, map_location=map_location,
                           weights_only=True)
        return saved["state"]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        """Completed steps, ascending (staging directories are not
        steps)."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.isfile(
            os.path.join(self.directory, n, STATE_FILE)))

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        self.wait_until_finished()
