"""nequip_tpu_torch: the PyTorch + CUDA port of nequip_tpu.

Mirrors the JAX package's module layout.  Imports torch, numpy and scipy;
never jax or nequip_tpu.  Hand-written CUDA kernels (``csrc/``) are built
with nvcc at first CUDA use (``ops/kernels/build.py``).  Importing the
package registers the ``nequip_torch`` ops (K1, K2's inference variant and
K3, ``ops/kernels/tp_scatter.py``), which a loaded exported program calls.
"""

__version__ = "0.1.0"

from .ops.kernels import tp_scatter as _tp_scatter  # noqa: E402,F401  (registers the nequip_torch ops)
