"""ASHA early stopping (Asynchronous Successive Halving).

The biggest practical Katib win for expensive TPU trials [upstream: Katib
early-stopping services, pkg/earlystopping/; ASHA per Li et al. 2018]:
instead of running every trial to completion, trials are compared at
exponentially-spaced resource milestones ("rungs", ``min_resource *
reduction_factor^k`` steps) and only the top ``1/reduction_factor`` at each
rung continue.  Asynchronous: a trial is judged against whatever peer
results exist at its rung right now — no synchronized brackets, no waiting,
which is what makes it fit a parallel-trial control loop.

Wiring: trials stream per-step metrics through ``bootstrap.emit_metric``
(the ``step`` extra); the TrialController records the objective at each
rung milestone into ``Trial.status.rung_values`` and consults this policy.
A stopped trial becomes phase ``EarlyStopped`` with its last observation —
it counts toward the experiment budget but not the optimum.

The port's copy of ``kubeflow_tpu/hpo/early_stopping.py``, device-free
like it, with the same names; it imports nothing of the reference
package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..api.experiment import EarlyStoppingSpec, ObjectiveType


@dataclasses.dataclass(frozen=True)
class Asha:
    min_resource: int = 2
    reduction_factor: int = 3
    #: rungs below this index never stop a trial (grace period)
    start_rung: int = 0

    @classmethod
    def from_spec(cls, spec: EarlyStoppingSpec) -> "Asha":
        s = spec.settings
        return cls(
            min_resource=int(s.get("min_resource", "2")),
            reduction_factor=int(s.get("reduction_factor", "3")),
            start_rung=int(s.get("start_rung", "0")),
        )

    def rung_for(self, step: int) -> Optional[int]:
        """Highest rung index whose milestone is <= step (None below rung 0)."""
        if step < self.min_resource:
            return None
        rung, milestone = 0, self.min_resource
        while milestone * self.reduction_factor <= step:
            milestone *= self.reduction_factor
            rung += 1
        return rung

    def milestone(self, rung: int) -> int:
        return self.min_resource * self.reduction_factor ** rung

    def should_stop(
        self,
        objective_type: ObjectiveType,
        rung: int,
        value: float,
        peer_values: Sequence[float],
    ) -> bool:
        """Asynchronous promotion rule: continue only if ``value`` is in the
        top ``1/reduction_factor`` of all values recorded at this rung
        (including itself).  With fewer than ``reduction_factor`` records
        the trial always continues — ASHA promotes optimistically early."""
        if rung < self.start_rung:
            return False
        values = [*peer_values, value]
        if len(values) < self.reduction_factor:
            return False
        reverse = objective_type == ObjectiveType.MAXIMIZE
        ranked = sorted(values, reverse=reverse)
        k = max(1, len(values) // self.reduction_factor)
        threshold = ranked[k - 1]
        return value < threshold if reverse else value > threshold
