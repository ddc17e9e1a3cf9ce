"""``python -m kubeflow_tpu_torch`` — the kft CLI entry point.

The port's copy of ``kubeflow_tpu/__main__.py``.
"""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
