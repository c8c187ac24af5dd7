"""Load the JAX package's parameter tree into a port model.

The tree is what ``GraphModel.init_params()`` returns in the JAX package and
what ``nequip-package`` pickles (``params.pkl``): nested dicts of arrays
keyed like ``layer1_convnet.conv.edge_mlp.w1`` (a flat dict keyed by those
dotted paths, as stored in an ``.npz``, is taken as well).  Every leaf is written by
dotted path into the port model's parameter or persistent buffer of the
same path and shape; a missing or extra key, or a shape mismatch, raises.
``jax_params_tree`` is its inverse, the model's tree for a package's
``params.pkl``.  ``jax_named_grads`` goes the other way for gradients: the port's parameter
gradients keyed by the JAX dotted paths, to hold against a JAX gradient
tree flattened the same way.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..nn.module import GraphModule


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@torch.no_grad()
def load_jax_params(model: GraphModule, tree: Mapping) -> GraphModule:
    flat = flatten_tree(tree)
    targets = dict(model.jax_named_tensors())
    missing = sorted(set(targets) - set(flat))
    extra = sorted(set(flat) - set(targets))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, unexpected {extra}")
    for name, t in targets.items():
        value = flat[name]
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {value.shape} != {tuple(t.shape)}")
        if value.dtype.name == "bfloat16":  # ml_dtypes' bf16 (a JAX tree cast to bf16): widened exactly
            value = value.astype(np.float32)
        t.copy_(torch.as_tensor(np.array(value), dtype=t.dtype))
    return model


def jax_params_tree(model: GraphModule) -> Dict:
    """The inverse of ``load_jax_params``: the model's parameters and
    persistent buffers as the JAX package's nested parameter tree of host
    numpy arrays (what ``nequip-package`` pickles as ``params.pkl``)."""
    tree: Dict = {}
    for name, t in model.jax_named_tensors():
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


def jax_named_grads(model: GraphModule) -> Dict[str, np.ndarray]:
    """The gradients of the model's trainable parameters by JAX dotted path
    (parameters without a gradient are left out)."""
    return {
        name: t.grad.detach().cpu().numpy()
        for name, t in model.jax_named_tensors()
        if isinstance(t, torch.nn.Parameter) and t.grad is not None
    }
