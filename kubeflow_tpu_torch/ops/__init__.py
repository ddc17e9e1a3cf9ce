"""Ops of the port: hand-written Hopper kernels beside their plain versions."""
