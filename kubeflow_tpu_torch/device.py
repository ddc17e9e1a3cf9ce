"""Where the port's tensors are created."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    There is no silent CPU path: with no card and no explicit
    ``device="cpu"`` this raises.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run on the "
                "CPU")
        return torch.device("cuda")
    return torch.device(device)
