"""Config system: ``_target_`` instantiation and ``${...}`` interpolation.

Port of ``nequip_tpu/utils/config.py`` (PyYAML and the standard library
only), the port's own copy:

* ``instantiate(cfg, **overrides)`` builds objects from dicts with a
  ``_target_`` dotted path, recursively unless ``_recursive_=False``; it
  imports only the targets it builds, so a dict handed on un-instantiated
  (the optimizer's ``optax.adam``) is never imported;
* ``retarget(cfg)`` moves a JAX-package config's ``nequip_tpu.``
  targets (and ``tp_impl`` names) to the port;
* ``resolve(cfg, root)`` does OmegaConf-style ``${path.to.key}`` and
  ``${resolver:arg1,arg2}`` interpolation; an interpolation whose resolver
  is not registered yet (``training_data_stats`` before the statistics are
  computed) is kept verbatim for a later pass;
* the built-in resolvers ``int_div``, ``int_mul``, ``concat_lists``,
  ``list_to_identity_dict``, ``list_to_constant_dict``,
  ``big_dataset_stats`` (``data/dataset_stats/<dataset>.yaml``),
  ``type_names_from_package`` and ``cutoff_radius_from_package`` (the JSON
  metadata of a package archive).
"""

from __future__ import annotations

import importlib
import os
import re
from typing import Any, Callable, Dict

import yaml

_RESOLVERS: Dict[str, Callable] = {}


def register_resolver(name: str, fn: Callable, replace: bool = False) -> None:
    if not replace and name in _RESOLVERS:
        raise KeyError(f"resolver {name!r} already registered")
    _RESOLVERS[name] = fn


def unregister_resolver(name: str) -> None:
    _RESOLVERS.pop(name, None)


def _big_dataset_stats(dataset: str, r_max, name: str):
    """Precomputed foundation-model dataset statistics from
    ``nequip_tpu_torch/data/dataset_stats/<dataset>.yaml``."""
    stats_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data",
        "dataset_stats",
    )
    path = os.path.join(stats_dir, f"{dataset}.yaml")
    if not os.path.exists(path):
        available = [f[:-5] for f in os.listdir(stats_dir) if f.endswith(".yaml")]
        raise KeyError(
            f"no precomputed stats for dataset {dataset!r}; available: {available}"
        )
    with open(path) as f:
        table = yaml.safe_load(f)
    name = str(name)
    # cutoff-independent entries (isolated_atom_energies, forces_rms, ...)
    # live under `meta`; per-cutoff entries under `r<cutoff>` keys
    if name in table.get("meta", {}):
        return table["meta"][name]
    key = f"r{float(r_max)}"
    if key not in table:
        raise KeyError(f"{dataset}: no stats at cutoff {key}; have {list(table)}")
    return table[key][name]


def _package_metadata(package_path: str) -> dict:
    import json
    import zipfile

    with zipfile.ZipFile(package_path) as zf:
        return json.loads(zf.read("package_metadata.json"))


def _type_names_from_package(package_path: str):
    """Type names recorded in a package archive's metadata."""
    return str(_package_metadata(package_path)["type_names"]).split()


def _cutoff_radius_from_package(package_path: str) -> float:
    """r_max recorded in a package archive's metadata."""
    return float(_package_metadata(package_path)["r_max"])


def _builtin_resolvers():
    register_resolver("int_div", lambda a, b: int(a) // int(b), replace=True)
    register_resolver("int_mul", lambda a, b: int(a) * int(b), replace=True)
    register_resolver(
        "concat_lists", lambda *ls: [x for sub in ls for x in sub], replace=True
    )
    register_resolver(
        "list_to_identity_dict", lambda lst: {str(x): str(x) for x in lst}, replace=True
    )
    register_resolver(
        "list_to_constant_dict",
        lambda lst, const: {str(x): const for x in lst},
        replace=True,
    )
    register_resolver("big_dataset_stats", _big_dataset_stats, replace=True)
    register_resolver(
        "type_names_from_package", _type_names_from_package, replace=True
    )
    register_resolver(
        "cutoff_radius_from_package", _cutoff_radius_from_package, replace=True
    )


_builtin_resolvers()

_INTERP_RE = re.compile(r"^\$\{([^{}]+)\}$")
_INTERP_PART_RE = re.compile(r"\$\{([^{}]+)\}")


def _outer_expr(s: str):
    """If ``s`` is exactly one (possibly nested) ``${...}``, return the inner
    expression, else None."""
    if not (s.startswith("${") and s.endswith("}")):
        return None
    depth = 0
    for i, ch in enumerate(s):
        if s.startswith("${", i):
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return s[2:-1] if i == len(s) - 1 else None
    return None


def _lookup(root: Any, path: str) -> Any:
    cur = root
    for part in path.split("."):
        if isinstance(cur, dict):
            cur = cur[part]
        elif isinstance(cur, (list, tuple)):
            cur = cur[int(part)]
        else:
            cur = getattr(cur, part)
    return cur


class _Unresolved(Exception):
    """Raised when a resolver is not (yet) registered — the interpolation is
    kept verbatim so it can be resolved in a later pass (e.g.
    ``training_data_stats`` after statistics are computed)."""


def _resolve_expr(expr: str, root: Any) -> Any:
    expr = expr.strip()
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        name = name.strip()
        if name in _RESOLVERS:
            args = []
            for raw in _split_args(argstr):
                raw = raw.strip()
                inner = _outer_expr(raw)
                if inner is not None:
                    args.append(_resolve_expr(inner, root))
                else:
                    args.append(yaml.safe_load(raw))
            return _RESOLVERS[name](*args)
        raise _Unresolved(expr)
    return _lookup(root, expr)


def _split_args(s: str):
    """Split on top-level commas (respecting brackets)."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "[{(":
            depth += 1
        elif ch in ")}]":
            depth -= 1
        if ch == "," and depth <= 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def resolve(cfg: Any, root: Any = None) -> Any:
    """Recursively resolve ``${...}`` interpolations against ``root``."""
    if root is None:
        root = cfg

    def _rec(node):
        if isinstance(node, dict):
            return {k: _rec(v) for k, v in node.items()}
        if isinstance(node, list):
            return [_rec(v) for v in node]
        if isinstance(node, str):
            expr = _outer_expr(node)
            if expr is not None:
                try:
                    return _rec(_resolve_expr(expr, root))
                except _Unresolved:
                    return node
            if _INTERP_PART_RE.search(node):
                try:
                    return _INTERP_PART_RE.sub(
                        lambda mm: str(_rec(_resolve_expr(mm.group(1), root))), node
                    )
                except _Unresolved:
                    return node
        return node

    return _rec(cfg)


def locate(path: str) -> Any:
    """Import a dotted path ('pkg.module.attr')."""
    module_path, _, attr = path.rpartition(".")
    if not module_path:
        raise ImportError(f"cannot locate {path!r}")
    try:
        mod = importlib.import_module(module_path)
        return getattr(mod, attr)
    except (ImportError, AttributeError):
        # maybe the attr is nested (pkg.module.Class.method)
        parent = locate(module_path)
        return getattr(parent, attr)


def instantiate(cfg: Any, *args, _recursive_: bool = True, **overrides) -> Any:
    """Hydra-style instantiation of ``{"_target_": "...", ...}`` trees."""
    if isinstance(cfg, dict) and "_target_" in cfg:
        cfg = dict(cfg)
        target = locate(cfg.pop("_target_"))
        partial = cfg.pop("_partial_", False)
        kwargs = {
            k: instantiate(v) if _recursive_ else v
            for k, v in cfg.items()
        }
        kwargs.update(overrides)
        if partial:
            import functools

            return functools.partial(target, *args, **kwargs)
        return target(*args, **kwargs)
    if isinstance(cfg, dict):
        if overrides or args:
            raise ValueError("overrides require a _target_ config")
        return {k: instantiate(v) if _recursive_ else v for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [instantiate(v) if _recursive_ else v for v in cfg]
    return cfg


# the JAX package's tp_impl names and the port's
_JAX_TP_IMPLS = {"xla": "torch", "pallas_fused": "fused", "pallas": "fused_tp"}


def retarget(node: Any) -> Any:
    """A config written for the JAX package (a YAML file, or the
    ``model_config`` of its package archive) for the port: ``_target_``
    strings under ``nequip_tpu.`` move to ``nequip_tpu_torch.``, and the
    JAX ``tp_impl`` names to the port's (``xla`` -> ``torch``,
    ``pallas_fused`` -> ``fused``, ``pallas`` -> ``fused_tp``)."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "_target_" and isinstance(v, str) and v.startswith("nequip_tpu."):
                v = "nequip_tpu_torch." + v[len("nequip_tpu."):]
            elif k == "tp_impl" and v in _JAX_TP_IMPLS:
                v = _JAX_TP_IMPLS[v]
            else:
                v = retarget(v)
            out[k] = v
        return out
    if isinstance(node, list):
        return [retarget(v) for v in node]
    return node


_PORT_TP_IMPLS = {v: k for k, v in _JAX_TP_IMPLS.items()}


def unretarget(node: Any) -> Any:
    """The inverse of ``retarget``: a port config as the JAX package writes
    it (``nequip_tpu_torch.`` targets under ``nequip_tpu.``, the port's
    ``tp_impl`` names the JAX ones), for files that both packages read."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "_target_" and isinstance(v, str) and v.startswith("nequip_tpu_torch."):
                v = "nequip_tpu." + v[len("nequip_tpu_torch."):]
            elif k == "tp_impl" and v in _PORT_TP_IMPLS:
                v = _PORT_TP_IMPLS[v]
            else:
                v = unretarget(v)
            out[k] = v
        return out
    if isinstance(node, list):
        return [unretarget(v) for v in node]
    return node


def load_config(path: str, resolve_interpolations: bool = False) -> dict:
    with open(path) as f:
        cfg = yaml.safe_load(f)
    if resolve_interpolations:
        cfg = resolve(cfg)
    return cfg
