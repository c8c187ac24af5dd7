"""Import and export reference (PyTorch + e3nn) NequIP weights.

Port of ``nequip_tpu/model/e3nn_import.py``.  Workflow:

1. On a machine with the reference installed, export the eager model's
   state dict to an ``.npz``::

       np.savez("weights.npz", **{k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})

2. Build the SAME architecture here (same config) and call
   :func:`import_e3nn_npz`, which writes the weights into the model.

The import is a pure re-layout (no numerical conversion):

* e3nn ``o3.Linear`` keeps one flat vector of per-instruction ``(mul_in,
  mul_out)`` blocks in input-major instruction order, with
  ``path_normalization="element"`` alphas applied at run time;
  ``ops/linear.py`` keeps the same blocks as ``w{i}_{j}``, so the import
  splits the vector;
* the ``uvu`` conv TP takes its weights from the radial MLP in instruction
  order in both, so radial-MLP and readout weights transfer transposed
  (torch ``nn.Linear`` stores ``(out, in)``, ``ops/mlp.py`` ``(in, out)``);
* the self-connection's flat per-path ``(mul1, mul2, mul_out)`` blocks are
  in the same triple-loop order: a direct copy;
* ``PerTypeScaleShift``'s per-type vectors become ``[num_types, 1]``.

Leaves that no reference key maps to (a frozen Bessel frequency buffer)
keep the model's values.  :func:`export_to_e3nn_npz` is the inverse, keyed
by the reference state-dict names, and equals the JAX package's export of
the same parameters.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from .jax_params import flatten_tree, jax_params_tree, load_jax_params

log = logging.getLogger("nequip_tpu_torch")

_PREFIXES = ("model.func.", "func.", "model.", "")


def _normalize_keys(src: Dict[str, np.ndarray], known_roots) -> Dict[str, np.ndarray]:
    """Strip the wrapper prefix (GraphModel/ForceStressOutput nesting)."""
    for pref in _PREFIXES:
        if any(k.startswith(pref + root + ".") or k == pref + root for k in src for root in known_roots):
            return {(k[len(pref):] if k.startswith(pref) else k): v for k, v in src.items()}
    return dict(src)


def _split_linear(flat: np.ndarray, linear) -> Dict[str, np.ndarray]:
    """e3nn flat Linear weight -> per-instruction ``(mul_in, mul_out)`` blocks."""
    out = {}
    off = 0
    for i, j in linear.instructions:
        mi, mo = linear.irreps_in[i].mul, linear.irreps_out[j].mul
        out[f"w{i}_{j}"] = flat[off: off + mi * mo].reshape(mi, mo)
        off += mi * mo
    if off != flat.size:
        raise ValueError(f"linear weight numel mismatch: consumed {off}, got {flat.size} "
                         "(architecture mismatch between the npz and this model?)")
    return out


def _join_linear(params: Dict[str, np.ndarray], linear) -> np.ndarray:
    return np.concatenate([np.asarray(params[f"w{i}_{j}"]).reshape(-1) for i, j in linear.instructions])


def _mlp_keys(prefix: str, mlp):
    """torch Sequential linear positions: index 2k (activations between)."""
    step = 2 if mlp.nonlinearity is not None else 1
    return [f"{prefix}.mlp.{step * k}.weight" for k in range(mlp.num_layers)]


def _take(src: dict, key: str) -> np.ndarray:
    if key not in src:
        near = [k for k in src if key.rsplit(".", 2)[0] in k][:8]
        raise KeyError(f"reference weights missing {key!r}; nearby keys: {near} "
                       "(was the npz exported from the same architecture/config?)")
    return np.asarray(src.pop(key))


def _modules(model):
    """(name, module) of the model's top-level sequence (GraphModel ->
    ForceStressOutput -> SequentialGraphNetwork)."""
    return list(model.model.func.named_children())


def _is_trainable(module, name: str) -> bool:
    return isinstance(getattr(module, name, None), torch.nn.Parameter)


def import_e3nn_npz(src, model):
    """Write reference e3nn weights into ``model`` (a port ``GraphModel`` of
    the same architecture) and return it.

    ``src``: path to an ``.npz`` (see the module docstring) or a dict of
    arrays keyed by the reference state-dict names.  A missing key raises
    ``KeyError``, a flat Linear of the wrong size or a shape that differs
    from the model's ``ValueError``."""
    from ..nn.atomwise import PerTypeScaleShift
    from ..nn.convnetlayer import ConvNetLayer
    from ..nn.embedding import BesselEdgeLengthEncoding, NodeTypeEmbed
    from ..nn.scalar_mlp import ScalarMLP

    if isinstance(src, dict):
        src = dict(src)
    else:
        with np.load(src) as z:
            src = {k: z[k] for k in z.files}
    modules = _modules(model)
    src = _normalize_keys(src, [name for name, _ in modules])

    flat = flatten_tree(jax_params_tree(model))
    for name, mod in modules:
        if isinstance(mod, NodeTypeEmbed):
            flat[f"{name}.type_embed"] = _take(src, f"{name}.embed_module.weight")
            for spec in mod.categorical_specs:
                flat[f"{name}.embed_{spec['field']}"] = _take(src, f"{name}.{spec['field']}_embed_module.weight")
        elif isinstance(mod, BesselEdgeLengthEncoding):
            if _is_trainable(mod, "bessel_weights"):
                flat[f"{name}.bessel_weights"] = _take(src, f"{name}.bessel_weights")
        elif isinstance(mod, ConvNetLayer):
            conv, p = mod.conv, f"{name}.conv"
            for lin in ("linear_1", "linear_2"):
                for leaf, w in _split_linear(_take(src, f"{p}.{lin}.weight"), getattr(conv, lin)).items():
                    flat[f"{p}.{lin}.{leaf}"] = w
            for k, key in enumerate(_mlp_keys(f"{p}.edge_mlp", conv.edge_mlp)):
                flat[f"{p}.edge_mlp.w{k}"] = _take(src, key).T
            if conv.sc_tp is not None:
                flat[f"{p}.sc"] = _take(src, f"{p}.sc.weight").reshape(-1)
        elif isinstance(mod, ScalarMLP):
            for k, key in enumerate(_mlp_keys(f"{name}.mlp", mod.mlp)):
                flat[f"{name}.w{k}"] = _take(src, key).T
        elif isinstance(mod, PerTypeScaleShift):
            for kind in ("scales", "shifts"):
                if getattr(mod, kind) is not None:
                    flat[f"{name}.{kind}"] = _take(src, f"{name}.{kind}").reshape(-1, 1)
        # modules without parameters (spharm, edge_norm, reduce, ...) skip
    if src:
        log.warning(f"unconsumed reference weights (buffers / unsupported modules): "
                    f"{sorted(src)[:10]}{'...' if len(src) > 10 else ''}")
    return load_jax_params(model, flat)


def export_to_e3nn_npz(model, path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_e3nn_npz`: the model's weights keyed by the
    reference state-dict names (written to ``path`` if given)."""
    from ..nn.atomwise import PerTypeScaleShift
    from ..nn.convnetlayer import ConvNetLayer
    from ..nn.embedding import BesselEdgeLengthEncoding, NodeTypeEmbed
    from ..nn.scalar_mlp import ScalarMLP

    tree = jax_params_tree(model)
    out: Dict[str, np.ndarray] = {}
    for name, mod in _modules(model):
        p = tree.get(name, {})
        if isinstance(mod, NodeTypeEmbed):
            out[f"{name}.embed_module.weight"] = p["type_embed"]
            for spec in mod.categorical_specs:
                out[f"{name}.{spec['field']}_embed_module.weight"] = p[f"embed_{spec['field']}"]
        elif isinstance(mod, BesselEdgeLengthEncoding) and _is_trainable(mod, "bessel_weights"):
            out[f"{name}.bessel_weights"] = p["bessel_weights"]
        elif isinstance(mod, ConvNetLayer):
            conv, cp = mod.conv, p["conv"]
            out[f"{name}.conv.linear_1.weight"] = _join_linear(cp["linear_1"], conv.linear_1)
            out[f"{name}.conv.linear_2.weight"] = _join_linear(cp["linear_2"], conv.linear_2)
            for k, key in enumerate(_mlp_keys(f"{name}.conv.edge_mlp", conv.edge_mlp)):
                out[key] = cp["edge_mlp"][f"w{k}"].T
            if conv.sc_tp is not None:
                out[f"{name}.conv.sc.weight"] = cp["sc"].reshape(-1)
        elif isinstance(mod, ScalarMLP):
            for k, key in enumerate(_mlp_keys(f"{name}.mlp", mod.mlp)):
                out[key] = p[f"w{k}"].T
        elif isinstance(mod, PerTypeScaleShift):
            for kind in ("scales", "shifts"):
                if getattr(mod, kind) is not None:
                    out[f"{name}.{kind}"] = p[kind].reshape(-1)
    if path is not None:
        np.savez(path, **out)
    return out
