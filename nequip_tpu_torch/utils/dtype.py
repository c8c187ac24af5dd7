"""Model-dtype context.

Port of ``nequip_tpu/utils/dtype.py``: modules capture the ``model_dtype``
that is current while they are built, and create their parameters in it.
The geometry and the energy sum run in ``GLOBAL_DTYPE`` (float64), as in
upstream NequIP.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Union

import torch

GLOBAL_DTYPE = torch.float64

_DTYPE_MAP = {
    "float32": torch.float32,
    "float64": torch.float64,
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


@contextlib.contextmanager
def default_dtype(dtype):
    token = _default_dtype.set(dtype_from_name(dtype))
    try:
        yield
    finally:
        _default_dtype.reset(token)
