"""PyTorch + CUDA port of kubeflow_tpu for NVIDIA Hopper (H100).

The JAX package ``kubeflow_tpu`` is the reference; this package imports
nothing of it (nor jax, flax or optax). Entry points that create tensors run
on the CUDA card unless the caller passes ``device="cpu"``; CUDA tensors go
through the hand-written kernels of ``ops/``.
"""
