"""Apply named model modifiers from a config or the command line.

Port of ``nequip_tpu/model/modify_utils.py``: modifiers are registered with
``@model_modifier`` (``nn/model_modifier_utils.py``) under the JAX
package's names and applied by name.  A modifier takes an ``nn.Module``
(a ``GraphModel``) and returns it, changed in place or rebuilt.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..nn.atomwise import PerTypeScaleShift
from ..nn.interaction_block import InteractionBlock
from ..nn.model_modifier_utils import get_all_modifiers, is_persistent_modifier, model_modifier


def modify(model, modifiers: List[Dict], persistent_only: bool = False):
    """``modifiers``: a list of ``{"modifier": name, **kwargs}``, applied in order."""
    registry = get_all_modifiers()
    for spec in modifiers:
        spec = dict(spec)
        name = spec.pop("modifier")
        if name not in registry:
            raise KeyError(f"unknown modifier {name!r}; available: {sorted(registry)}")
        if persistent_only and not is_persistent_modifier(name):
            continue
        model = registry[name](model, **spec)
    return model


def _set_tp_impl(model, tp_impl: str):
    for m in model.modules():
        if isinstance(m, InteractionBlock):
            m.set_tp_impl(tp_impl)
    return model


@model_modifier(persistent=False)
def enable_TPUFusedTPScatter(model):
    """Every conv runs the fused CUDA kernels (``tp_impl="fused"``: K1, K2,
    K3); the weights are unchanged.  The JAX package's name is kept, so its
    configs apply unchanged."""
    return _set_tp_impl(model, "fused")


@model_modifier(persistent=False)
def disable_TPUFusedTPScatter(model):
    """Every conv runs the plain PyTorch path (``tp_impl="torch"``)."""
    return _set_tp_impl(model, "torch")


@model_modifier(persistent=False)
def modify_model_dtype(model, model_dtype: str):
    """Rebuild the model from its ``model_config`` under another
    ``model_dtype`` (float32 or float64), every weight carried over and cast
    to the dtype the new build gives it (tensors held in the global float64
    stay float64).  Implementation switches made by other modifiers are not
    in the config: apply this one first."""
    from ..utils.config import instantiate
    from .jax_params import load_jax_params

    cfg = dict(getattr(model, "model_config", None) or {})
    if not cfg.get("_target_"):
        raise ValueError("modify_model_dtype needs a model built by a @model_builder (its model_config)")
    cfg["model_dtype"] = model_dtype
    new_model = instantiate(cfg, _recursive_=False)
    device = next(iter(model.parameters())).device
    load_jax_params(new_model, {k: t.detach().cpu().numpy() for k, t in model.jax_named_tensors()})
    return new_model.to(device)


@model_modifier(persistent=False)
def enable_bf16_fast_mode(model):
    """The JAX package's bfloat16 fast mode is not ported: the CUDA kernels
    are instantiated for float32 and float64 only
    (``ops/kernels/build.py``)."""
    raise NotImplementedError(
        "enable_bf16_fast_mode: the port's CUDA kernels are built for float32 and float64 only "
        "(ops/kernels/build.py); bfloat16 is a later slice of the port (ROADMAP.md)"
    )


@model_modifier(persistent=True)
def modify_PerTypeScaleShift(model, scales=None, shifts=None, scales_trainable: bool = False,
                             shifts_trainable: bool = False):
    """Replace per-type energy scales and shifts (fine-tuning), as the JAX
    ``modify_PerTypeScaleShift``: new values are a float for every type or a
    dict over some of the model's type names; other types keep their values
    (zero where the model had none).  A kind given new values becomes one
    value per type, a parameter when ``*_trainable`` (fine-tuning trains
    it), else a fixed buffer."""
    found = [m for m in model.modules() if isinstance(m, PerTypeScaleShift)]
    if not found:
        raise ValueError("model has no PerTypeScaleShift module")
    for mod in found:
        for kind, new_vals, trainable in (("scales", scales, scales_trainable), ("shifts", shifts, shifts_trainable)):
            if new_vals is None:
                continue
            if isinstance(new_vals, (int, float)):
                new_vals = {t: float(new_vals) for t in mod.type_names}
            unknown = sorted(set(new_vals) - set(mod.type_names))
            if unknown:
                raise ValueError(f"unknown type names in {kind}: {unknown}")
            cur = getattr(mod, kind)
            vals = np.zeros(mod.num_types) if cur is None else np.broadcast_to(
                cur.detach().cpu().numpy().reshape(-1), (mod.num_types,)).copy()
            for t, v in new_vals.items():
                vals[mod.type_names.index(t)] = float(v)
            setattr(mod, f"{kind}_trainable", bool(trainable))
            mod.set_values(kind, vals, device=next(iter(model.parameters())).device)
            # a rebuild from the config (a package) has the new values and leaves too
            if getattr(model, "model_config", None):
                model.model_config[f"per_type_energy_{kind}"] = dict(zip(mod.type_names, map(float, vals)))
                model.model_config[f"per_type_energy_{kind}_trainable"] = bool(trainable)
    return model
