"""Loading models from checkpoints and package archives.

Port of ``nequip_tpu/model/saved_models.py``:

* ``ModelFromCheckpoint``: a checkpoint of ``nequip-torch-train``
  (``train/checkpoint.py``): the model is rebuilt from the training module's
  model config and takes the evaluation weights (EMA, or schedule-free's)
  when the checkpoint has them;
* ``ModelFromPackage``: a ``nequip-torch-package`` archive, or one that the
  JAX package's ``nequip-package`` wrote: its ``model_config.json`` is
  retargeted to the port (``utils.config.retarget``) and its ``params.pkl``
  (the JAX parameter tree) loaded with ``load_jax_params``; the format
  version is checked against ``SUPPORTED_PACKAGE_FORMATS``, and a config the
  installed code can no longer build raises with the archive's code
  snapshot as the way out;
* ``load_saved_model`` dispatches on the file (and resolves ``nequip.net:``
  ids through the local cache, fetching on a miss, ``utils/model_cache.py``).

Models come back on the CPU with trainable weights; the calculator and the
compiler move and freeze them.
"""

from __future__ import annotations

import json
import pickle
import zipfile

from ..utils.config import instantiate, retarget
from ..utils.versions import check_version_compatibility
from .jax_params import load_jax_params

# == package format version log (the JAX package's, which the port shares) ==
#  1: metadata + model_config.json + params.pkl (+example/outputs)
#  2: + code_snapshot.zip (the source tree that built the model)
PACKAGE_FORMAT_VERSION = 2
# formats this code can still load (bump and extend deliberately)
SUPPORTED_PACKAGE_FORMATS = (1, 2)


def _training_config(payload: dict, path: str) -> dict:
    saved = payload["config"].get("config", payload["config"])
    if "training_module" not in saved or "model" not in saved["training_module"]:
        raise KeyError(f"checkpoint {path} has no training_module model config")
    return saved


def ModelFromCheckpoint(ckpt_path: str, use_ema: bool = True):
    """The model of a ``nequip-torch-train`` checkpoint, with its evaluation
    weights (EMA, or schedule-free's ``x``) when it has them and ``use_ema``
    (what evaluation ran)."""
    from ..train.checkpoint import load_checkpoint

    payload = load_checkpoint(ckpt_path)
    model = instantiate(_training_config(payload, ckpt_path)["training_module"]["model"], _recursive_=False)
    state = payload["state"]
    evaluation = next((state[k] for k in ("ema_params", "eval_params") if k in state), None)
    return load_jax_params(model, evaluation if use_ema and evaluation is not None else state["params"])


def is_package(path: str) -> bool:
    """A package archive (a checkpoint is a zip archive too: ``torch.save``)."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        return "package_metadata.json" in zf.namelist()


def ModelFromPackage(package_path: str):
    """The model of a package archive of either package."""
    with zipfile.ZipFile(package_path) as zf:
        meta = json.loads(zf.read("package_metadata.json"))
        model_cfg = json.loads(zf.read("model_config.json"))
        # the archive's own parameter tree: nested dicts of numpy arrays
        params_tree = pickle.loads(zf.read("params.pkl"))
        has_snapshot = "code_snapshot.zip" in zf.namelist()
    fmt = int(meta.get("package_format_version", 1))
    if fmt not in SUPPORTED_PACKAGE_FORMATS:
        raise RuntimeError(
            f"package {package_path!r} has format version {fmt}; this code supports {SUPPORTED_PACKAGE_FORMATS}. "
            + ("Recover with `nequip-torch-package extract-code` + PYTHONPATH." if has_snapshot
               else "Re-export it with the version that wrote it.")
        )
    check_version_compatibility(meta.get("code_versions"))
    version = meta.get("nequip_tpu_torch_version", meta.get("nequip_tpu_version"))
    try:
        model = instantiate(retarget(model_cfg), _recursive_=False)
    except TypeError as e:
        hint = (
            f"run `nequip-torch-package extract-code {package_path} <dir>` and load with PYTHONPATH=<dir> (the "
            f"archive interns the source tree that built this model, version {version})"
            if has_snapshot else f"install the version that wrote it ({version})"
        )
        raise RuntimeError(f"cannot rebuild the packaged model with the installed code (builder config schema "
                           f"drift: {e}); {hint}") from e
    return load_jax_params(model, params_tree)


def load_saved_model(path: str, use_ema: bool = True):
    """A checkpoint or a package archive (or a ``nequip.net:`` id, from the
    local cache or fetched into it), by what the file is."""
    if str(path).startswith("nequip.net:"):
        from ..utils.model_cache import resolve_model_id

        path = resolve_model_id(str(path))
    if is_package(path):
        return ModelFromPackage(path)
    return ModelFromCheckpoint(path, use_ema=use_ema)


def data_dict_from_checkpoint(ckpt_path: str) -> dict:
    """One padded training batch (numpy arrays) of the checkpoint's data
    config: the example a package stores and a compile sizes its rungs by."""
    from ..train.checkpoint import load_checkpoint

    saved = _training_config(load_checkpoint(ckpt_path), ckpt_path)
    if "data" not in saved:
        raise KeyError(f"checkpoint {ckpt_path} has no data config")
    datamodule = instantiate(saved["data"], _recursive_=False, device=None)
    datamodule.setup("fit")
    return next(iter(datamodule.train_dataloader()))
