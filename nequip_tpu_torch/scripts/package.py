"""``nequip-torch-package``: self-contained model archives.

Port of ``nequip_tpu/scripts/package.py``, with the JAX package's archive
layout, so that the two packages exchange weights unchanged:

    package_metadata.json   format version, the port's version, the code
                            versions and the model's metadata
    model_config.json       the builder recipe (``model.model_config``)
    params.pkl              the JAX parameter tree (``jax_params_tree``)
    example_data.pkl        a padded training batch (numpy)
    example_outputs.pkl     the model's energy and forces on it
    code_snapshot.zip       the ``nequip_tpu_torch`` source tree (its CUDA
                            sources included, the build directory not)

Subcommands: build / info / list / diff / update / modify / extract-code.
``ModelFromPackage`` (``model/saved_models.py``) reads the archive, and one
that the JAX ``nequip-package`` wrote.  ``build`` and ``update`` run the
model on ``--device``, the card by default.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import os
import pickle
import zipfile

import numpy as np

from ..model.saved_models import PACKAGE_FORMAT_VERSION

log = logging.getLogger("nequip_tpu_torch")

_SNAPSHOT_SUFFIXES = (".py", ".yaml", ".yml", ".cu", ".cuh", ".cpp", ".h", ".md")


def code_snapshot_bytes() -> bytes:
    """Zip the installed ``nequip_tpu_torch`` source tree."""
    import nequip_tpu_torch

    root = os.path.dirname(os.path.abspath(nequip_tpu_torch.__file__))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "_build"))
            for fn in sorted(filenames):
                if fn.endswith(_SNAPSHOT_SUFFIXES):
                    full = os.path.join(dirpath, fn)
                    zf.write(full, os.path.join("nequip_tpu_torch", os.path.relpath(full, root)))
    return buf.getvalue()


def _read(path: str, name: str):
    with zipfile.ZipFile(path) as zf:
        if name not in zf.namelist():
            return None
        data = zf.read(name)
    return json.loads(data) if name.endswith(".json") else pickle.loads(data)


def _example_outputs(model, example: dict, device) -> dict:
    """Energy and forces of the model on the example batch (numpy)."""
    from ..data import _keys, to_tensors
    from ..ops.kernels.tp_scatter import relayout_edge_stream

    batch = to_tensors(example, device)
    if model.uses_fused_kernels:
        batch = relayout_edge_stream(batch)
    out = model.to(device).requires_grad_(False)(batch)
    return {k: out[k].detach().cpu().numpy() for k in (_keys.TOTAL_ENERGY_KEY, _keys.FORCE_KEY) if k in out}


def _write(path: str, meta: dict, cfg: dict, model, example=None, outputs=None, snapshot: bool = True) -> None:
    from ..model.jax_params import jax_params_tree

    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("package_metadata.json", json.dumps(meta, indent=2))
        zf.writestr("model_config.json", json.dumps(cfg))
        zf.writestr("params.pkl", pickle.dumps(jax_params_tree(model)))
        if example is not None:
            zf.writestr("example_data.pkl", pickle.dumps(example))
        if outputs is not None:
            zf.writestr("example_outputs.pkl", pickle.dumps(outputs))
        if snapshot:
            zf.writestr("code_snapshot.zip", code_snapshot_bytes())


def package_model(model, output_path: str, example: dict, device="cuda", snapshot: bool = True) -> None:
    """Write ``model`` (built by a ``@model_builder``: its ``model_config``
    rebuilds it) as a package, with ``example`` (a padded numpy batch) and
    the model's energy and forces on it."""
    from .. import __version__
    from ..utils.versions import get_current_code_versions

    cfg = getattr(model, "model_config", None)
    if not cfg or "_target_" not in cfg:
        raise ValueError("the model has no model_config to rebuild it from; cannot package")
    meta = {
        "package_format_version": PACKAGE_FORMAT_VERSION,
        "nequip_tpu_torch_version": __version__,
        "code_versions": get_current_code_versions(),
        **{k: str(v) for k, v in model.metadata.items()},
    }
    _write(output_path, meta, cfg, model, example, _example_outputs(model, example, device), snapshot=snapshot)


def build(args) -> None:
    from ..model.saved_models import data_dict_from_checkpoint, load_saved_model
    from ..utils.device import resolve_device

    model = load_saved_model(args.ckpt_path)
    package_model(model, args.output_path, data_dict_from_checkpoint(args.ckpt_path), resolve_device(args.device),
                  snapshot=not args.no_code_snapshot)
    log.info(f"wrote package {args.output_path}")


def info(args) -> None:
    print(json.dumps({"metadata": _read(args.package_path, "package_metadata.json"),
                      "model_config": _read(args.package_path, "model_config.json")}, indent=2))


def list_contents(args) -> None:
    with zipfile.ZipFile(args.package_path) as zf:
        for zi in zf.infolist():
            print(f"{zi.file_size:>12}  {zi.filename}")


def diff(args) -> None:
    """Print where two packages' metadata, configs and parameters differ."""
    from ..model.jax_params import flatten_tree

    for name in ("package_metadata.json", "model_config.json"):
        a, b = _read(args.package_a, name), _read(args.package_b, name)
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                print(f"{name[:-5]}.{k}: {a.get(k)!r} != {b.get(k)!r}")
    pa, pb = (flatten_tree(_read(p, "params.pkl")) for p in (args.package_a, args.package_b))
    if set(pa) != set(pb):
        print(f"params: names differ: {sorted(set(pa) ^ set(pb))}")
        return
    worst = max((float(np.abs(pa[k] - pb[k]).max()) if pa[k].shape == pb[k].shape else float("inf") for k in pa),
                default=0.0)
    print(f"params: max abs diff {worst:.3e}")


def update(args) -> None:
    """Re-emit an archive under the current code, after checking that the
    rebuilt model predicts the stored example outputs (rtol 1e-6, atol 1e-8,
    the JAX package's check)."""
    from .. import __version__
    from ..model.saved_models import ModelFromPackage
    from ..utils.device import resolve_device
    from ..utils.versions import get_current_code_versions

    device = resolve_device(args.device)
    meta = _read(args.package_path, "package_metadata.json")
    example = _read(args.package_path, "example_data.pkl")
    old = _read(args.package_path, "example_outputs.pkl")
    model = ModelFromPackage(args.package_path)
    new = None
    if example is not None:
        new = _example_outputs(model, example, device)
        for k, v in (old or {}).items():
            np.testing.assert_allclose(new[k], v, rtol=1e-6, atol=1e-8,
                                       err_msg=f"package update changed predictions for {k!r}")
        log.info("predictions verified unchanged")
    old_version = meta.get("nequip_tpu_torch_version", meta.get("nequip_tpu_version"))
    meta.update(package_format_version=PACKAGE_FORMAT_VERSION, nequip_tpu_torch_version=__version__,
                code_versions=get_current_code_versions())
    meta.setdefault("updated_from", []).append(old_version)
    _write(args.output_path, meta, model.model_config, model, example, new)
    log.info(f"updated package -> {args.output_path}")


def extract_code(args) -> None:
    """Extract the interned source tree: if the installed code can no longer
    build an old package's config, load it with ``PYTHONPATH=<out_dir>``."""
    snapshot = _read_bytes(args.package_path, "code_snapshot.zip")
    if snapshot is None:
        raise FileNotFoundError("the archive has no code snapshot (built with --no-code-snapshot or format 1)")
    os.makedirs(args.output_dir, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(snapshot)) as zf:
        zf.extractall(args.output_dir)
    log.info(f"extracted the code snapshot to {args.output_dir}; load the package with PYTHONPATH={args.output_dir}")


def _read_bytes(path: str, name: str):
    with zipfile.ZipFile(path) as zf:
        return zf.read(name) if name in zf.namelist() else None


def modify_cmd(args) -> None:
    """Apply modifiers to a package's model and write a new archive (its
    config as the persistent modifiers leave it)."""
    import yaml

    from ..model.modify_utils import modify
    from ..model.saved_models import ModelFromPackage

    model = ModelFromPackage(args.package_path)
    specs = []
    for m in args.modifiers:
        name, _, kv = m.partition(":")
        specs.append({"modifier": name, **(yaml.safe_load(kv) if kv else {})})
    model = modify(model, specs)
    meta = _read(args.package_path, "package_metadata.json")
    meta["modifiers"] = args.modifiers
    _write(args.output_path, meta, model.model_config, model, snapshot=False)
    log.info(f"wrote modified package {args.output_path}")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    parser = argparse.ArgumentParser(description="Package a NequIP model of the PyTorch + CUDA port")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("build")
    p.add_argument("ckpt_path")
    p.add_argument("output_path")
    p.add_argument("--no-code-snapshot", action="store_true", help="do not intern the source tree")
    p.add_argument("--device", default="cuda", help="torch device of the example run (default: cuda)")
    p.set_defaults(func=build)

    p = sub.add_parser("extract-code")
    p.add_argument("package_path")
    p.add_argument("output_dir")
    p.set_defaults(func=extract_code)

    for name, func in (("info", info), ("list", list_contents)):
        p = sub.add_parser(name)
        p.add_argument("package_path")
        p.set_defaults(func=func)

    p = sub.add_parser("diff")
    p.add_argument("package_a")
    p.add_argument("package_b")
    p.set_defaults(func=diff)

    p = sub.add_parser("update")
    p.add_argument("package_path")
    p.add_argument("output_path")
    p.add_argument("--device", default="cuda", help="torch device of the self-check (default: cuda)")
    p.set_defaults(func=update)

    p = sub.add_parser("modify")
    p.add_argument("package_path")
    p.add_argument("output_path")
    p.add_argument("--modifiers", nargs="+", required=True, help="name or name:{yaml kwargs}")
    p.set_defaults(func=modify_cmd)

    args = parser.parse_args(argv)
    from ._workflow_utils import set_workflow_state

    set_workflow_state("package")
    try:
        args.func(args)
    finally:
        set_workflow_state(None)


if __name__ == "__main__":
    main()
