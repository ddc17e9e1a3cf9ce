"""Mesh construction and parallel layouts over ``torch.distributed``."""

from .mesh import (
    AXIS_ORDER,
    BATCH_AXES,
    MeshPlan,
    MeshPlanError,
    batch_sharding,
    build_mesh,
    local_batch_size,
    plan_mesh,
)

__all__ = [k for k in dir() if not k.startswith("_")]
