"""Model-modifier registry.

Port of ``nequip_tpu/nn/model_modifier_utils.py``: named modifiers,
registered with a decorator and applied by name from a config or a command
line (``model/modify_utils.py``).  The names are the JAX package's, so a
JAX config or package applies unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict

_MODIFIER_REGISTRY: Dict[str, Callable] = {}


def model_modifier(persistent: bool = False, private: bool = False):
    """Register a function as a named model modifier.

    ``persistent`` modifiers change the model's numerics or architecture and
    are baked into packages; non-persistent ones are accelerations applied
    per run.  ``private`` marks one that is not meant for users (the JAX
    registry's flag, recorded only).
    """

    def deco(fn: Callable) -> Callable:
        fn._modifier_persistent = persistent
        fn._modifier_private = private
        _MODIFIER_REGISTRY[fn.__name__] = fn
        return fn

    return deco


def get_all_modifiers() -> Dict[str, Callable]:
    return dict(_MODIFIER_REGISTRY)


def is_persistent_modifier(name: str) -> bool:
    return bool(getattr(_MODIFIER_REGISTRY[name], "_modifier_persistent", False))
