"""PyTorch/CUDA port of ``repro`` (Load Balancing in Federated Learning).

Mirrors the JAX package module for module and runs on an NVIDIA GPU by
default; every TPU kernel of ``repro.kernels`` on a ported path has a
hand-written Hopper kernel here (``repro_torch.kernels``). This package
imports torch and numpy only, never jax or ``repro``.
"""
