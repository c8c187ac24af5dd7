"""nequip_tpu_torch: the PyTorch + CUDA port of nequip_tpu.

Mirrors the JAX package's module layout.  Imports torch, numpy and scipy;
never jax or nequip_tpu.  Hand-written CUDA kernels (``csrc/``) are built
with nvcc at first CUDA use (``ops/kernels/build.py``).
"""
