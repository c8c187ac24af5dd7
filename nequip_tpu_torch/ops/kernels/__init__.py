"""Hand-written CUDA kernels of the convolution and their plain twins.

Importing the package registers every kernel's launch count in
``tp_scatter.KERNELS`` (``tp_scatter.reset_launch_counts`` zeroes them all),
the device neighbour list's (``ops/device_nl.py``) among them.
"""

from . import tp_scatter  # noqa: F401  (first: the others register into its KERNELS)
from . import microbench, row_gather  # noqa: F401, E402
from .. import device_nl  # noqa: F401, E402
