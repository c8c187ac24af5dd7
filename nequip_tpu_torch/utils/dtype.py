"""Model-dtype context.

Port of ``nequip_tpu/utils/dtype.py``: modules capture the ``model_dtype``
that is current while they are built, and create their parameters in
``param_dtype`` of it: the model dtype itself for float32 and float64, and
float32 for a bfloat16 model, whose modules cast their weights to bfloat16
where they use them (as a JAX bfloat16 model keeps a float32 parameter
tree).  The geometry and the energy sum run in ``GLOBAL_DTYPE`` (float64),
as in upstream NequIP.  ``model_tolerance`` is the compiled-against-eager
self-check's tolerance per model dtype.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Union

import torch

GLOBAL_DTYPE = torch.float64

_DTYPE_MAP = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}

_default_dtype: contextvars.ContextVar = contextvars.ContextVar(
    "nequip_tpu_torch_default_dtype", default=torch.float32
)


def dtype_from_name(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, str):
        if name not in _DTYPE_MAP:
            raise ValueError(f"unsupported model_dtype {name!r}; options: {list(_DTYPE_MAP)}")
        return _DTYPE_MAP[name]
    return name


def dtype_to_name(dtype: torch.dtype) -> str:
    for k, v in _DTYPE_MAP.items():
        if v == dtype:
            return k
    return str(dtype)


def get_default_dtype() -> torch.dtype:
    return _default_dtype.get()


def param_dtype(dtype=None) -> torch.dtype:
    """The dtype a module of ``model_dtype`` ``dtype`` (default: the current
    one) holds its parameters in: float32 for bfloat16, else ``dtype``."""
    dtype = get_default_dtype() if dtype is None else dtype_from_name(dtype)
    return torch.float32 if dtype == torch.bfloat16 else dtype


@contextlib.contextmanager
def default_dtype(dtype):
    token = _default_dtype.set(dtype_from_name(dtype))
    try:
        yield
    finally:
        _default_dtype.reset(token)


# compiled-against-eager self-check tolerances (max abs error), as the
# reference's NEQUIP_FLOAT{64,32}_MODEL_TOL; bfloat16 has none, as in JAX
# (a bfloat16 model compiles with the self-check off: scripts/compile.py)
_MODEL_TOLS = {
    torch.float64: float(os.environ.get("NEQUIP_FLOAT64_MODEL_TOL", 1e-12)),
    torch.float32: float(os.environ.get("NEQUIP_FLOAT32_MODEL_TOL", 5e-5)),
}


def model_tolerance(dtype) -> float:
    dtype = dtype_from_name(dtype)
    if dtype not in _MODEL_TOLS:
        raise KeyError(f"no compiled-against-eager tolerance for {dtype_to_name(dtype)} (as in the JAX package): "
                       "compile such a model with --no-check")
    return _MODEL_TOLS[dtype]
