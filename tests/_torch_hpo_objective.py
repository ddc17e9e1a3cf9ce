"""Trial entrypoint for the port's HPO tests: the analytic objective of
``tests/hpo_objective.py``, emitted through the port's metric channel.

score = 1 - (lr - 0.03)^2 * 100, maximized at lr=0.03: no model, so a
trial costs only the pod's start. Imports only the port (a pod of the
port's ``LocalKubelet`` runs it).
"""

import os

from kubeflow_tpu_torch.runtime import bootstrap


def objective_main(ctx) -> None:
    lr = float(os.environ.get("KFT_LR", "0.1"))
    score = 1.0 - (lr - 0.03) ** 2 * 100.0
    bootstrap.emit_metric(ctx, "score", score)
