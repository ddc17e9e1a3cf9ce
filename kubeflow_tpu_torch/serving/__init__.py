"""Serving: the continuous-batching engine (``continuous.py``) over the
paged KV block economy (``paged.py``); the port of
``kubeflow_tpu/serving``'s engine core."""
