"""Host-side helpers: copies of ``kubeflow_tpu/utils``'s device-free modules."""
