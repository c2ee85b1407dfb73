"""PyTorch + CUDA port of bnv_fusion_tpu for one NVIDIA H100.

The JAX package ``bnv_fusion_tpu`` stays the reference; this package holds
the same modules under the same names, in PyTorch, with the TPU kernels
rewritten as hand-written CUDA kernels for Hopper (``kernels/``, sources in
``csrc/``).  It imports torch, numpy and scipy, never jax.
"""
