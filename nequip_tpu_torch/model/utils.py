"""The ``@model_builder`` contract.

Port of ``nequip_tpu/model/utils.py``: every model builder requires
``seed``, ``model_dtype`` and ``type_names``; its modules are built under
``model_dtype`` (``utils.dtype.default_dtype``); nested builders inherit
those settings and return the bare model; the outermost one draws the
weights from ``seed`` (``init_weights``: a seeded ``torch.Generator``,
whose draws differ from the JAX package's) and records ``model_config``:
``seed``, ``model_dtype``, ``type_names``, every config-valued keyword it
was given and its ``_target_``, so that ``utils.config.instantiate``
rebuilds the same model, weights included.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Optional

import torch

from ..nn.graph_model import GraphModel
from ..utils.dtype import default_dtype

_BUILDER_CONTEXT: contextvars.ContextVar = contextvars.ContextVar("nequip_tpu_torch_model_builder_ctx", default=None)


@torch.no_grad()
def init_weights(model: torch.nn.Module, seed: int) -> None:
    """Draw every weight of the model from a generator seeded with ``seed``."""
    generator = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


def model_builder(func):
    """Decorator for model builder functions."""

    @functools.wraps(func)
    def wrapper(*args, seed: Optional[int] = None, model_dtype: Optional[str] = None, type_names=None, **kwargs):
        parent = _BUILDER_CONTEXT.get()
        if parent is not None:
            # nested builder: inherit the contract arguments of the outer one
            seed = parent["seed"] if seed is None else seed
            model_dtype = parent["model_dtype"] if model_dtype is None else model_dtype
            type_names = parent["type_names"] if type_names is None else type_names
        for name, value in (("seed", seed), ("model_dtype", model_dtype), ("type_names", type_names)):
            if value is None:
                raise ValueError(f"{func.__name__} requires `{name}`")

        token = _BUILDER_CONTEXT.set({"seed": seed, "model_dtype": model_dtype, "type_names": type_names})
        try:
            with default_dtype(model_dtype):
                model = func(*args, type_names=type_names, **kwargs)
        finally:
            _BUILDER_CONTEXT.reset(token)

        if parent is not None:
            return model
        if not isinstance(model, GraphModel):
            raise TypeError(f"{func.__name__} must return a GraphModel")
        init_weights(model, seed)
        model.model_config = {
            "seed": seed,
            "model_dtype": model_dtype,
            "type_names": list(type_names),
            **{k: v for k, v in kwargs.items() if _is_config_value(v)},
            "_target_": f"{func.__module__}.{func.__name__}",
        }
        return model

    return wrapper


def _is_config_value(v) -> bool:
    if isinstance(v, (int, float, str, bool, type(None))):
        return True
    if isinstance(v, (list, tuple)):
        return all(_is_config_value(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _is_config_value(x) for k, x in v.items())
    return False
