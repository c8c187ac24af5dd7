"""``nequip-torch-train``: config-driven training on the port.

Port of ``nequip_tpu/scripts/train.py``: the same four-section config
(``run``, ``data``, ``trainer``, ``training_module``, and optionally
``global_options``), dataset statistics wired into the model through the
``${training_data_stats:<name>}`` resolver, the sequential run loop
(train, val, test, predict) and resume from a checkpoint, in which the
checkpoint's resolved ``training_module`` config wins.  After a ``train``
stage, ``val``, ``test`` and ``predict`` read ``<ckpt_dir>/best.ckpt``
(the best-checkpoint hand-off); without one they run the trained weights,
and a run with neither raises.  The data module and the training module
run on ``device``, the card by default (raising without one); nothing
falls back to the CPU.

Usage:
    nequip-torch-train -cn config.yaml [-cp /path/to/config/dir] [--device cuda|cpu]
    nequip-torch-train -cn config.yaml ++trainer.max_epochs=5 ++ckpt_path=ckpt/last.ckpt
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import yaml

from ..train.checkpoint import load_checkpoint
from ..utils.config import instantiate, load_config, register_resolver, resolve, unregister_resolver
from ..utils.global_state import set_global_state
from ._workflow_utils import set_workflow_state

log = logging.getLogger("nequip_tpu_torch")

_REQUIRED_SECTIONS = ("run", "data", "trainer", "training_module")
_ALLOWED_RUNS = ("train", "val", "test", "predict")
_SAVED_SECTIONS = ("run", "data", "trainer", "training_module", "global_options")
_STATS_RESOLVER = "training_data_stats"


def build_from_config(config: dict, ckpt_path: Optional[str] = None, device="cuda"):
    """``(datamodule, training_module, trainer, runs)`` from a config."""
    missing = [s for s in _REQUIRED_SECTIONS if s not in config]
    if missing:
        raise KeyError(f"config is missing required sections {missing}")
    runs = [config["run"]] if isinstance(config["run"], str) else list(config["run"])
    if not all(r in _ALLOWED_RUNS for r in runs):
        raise ValueError(f"run must be a list from {_ALLOWED_RUNS}, got {runs}")

    set_global_state(**config.get("global_options", {}))
    # a statistics resolver left from an earlier config must not resolve this one
    unregister_resolver(_STATS_RESOLVER)
    config = resolve(config)
    datamodule = instantiate(config["data"], _recursive_=False, device=device)
    if _STATS_RESOLVER in str(config["training_module"]) and ckpt_path is None:
        stats = datamodule.get_statistics("train")
        log.info(f"training data statistics: {stats}")
        register_resolver(_STATS_RESOLVER, lambda name: stats[str(name).strip()], replace=True)
        try:
            config["training_module"] = resolve(config["training_module"], config)
        finally:
            unregister_resolver(_STATS_RESOLVER)

    training_module = instantiate(config["training_module"], _recursive_=False, device=device)
    trainer = instantiate(config["trainer"], _recursive_=False)
    trainer.info_dict = {"config": {k: v for k, v in config.items() if k in _SAVED_SECTIONS}}
    return datamodule, training_module, trainer, runs


def run_config(config: dict, ckpt_path: Optional[str] = None, device="cuda"):
    """Build from ``config`` and run its stages; returns the trainer."""
    set_workflow_state("train")
    try:
        run_index = 0
        if ckpt_path is not None:
            payload = load_checkpoint(ckpt_path)
            saved = payload["config"].get("config", {})
            if "training_module" in saved:
                config = {**config, "training_module": saved["training_module"]}
            run_index = int(payload["meta"].get("run_index", 0))
        datamodule, training_module, trainer, runs = build_from_config(config, ckpt_path, device)

        trained = False
        for i, stage in enumerate(runs):
            if i < run_index:
                continue
            trainer.run_index = i
            if stage == "train":
                trainer.fit(training_module, datamodule, ckpt_path=ckpt_path)
                ckpt_path, trained = None, True
                continue
            best = os.path.join(trainer.ckpt_dir, "best.ckpt")
            if not os.path.exists(best) and not trained:
                raise FileNotFoundError(f"run stage {stage!r}: no {best} and no training stage before it")
            eval_ckpt = "best" if os.path.exists(best) else None
            getattr(trainer, {"val": "validate"}.get(stage, stage))(training_module, datamodule, ckpt_path=eval_ckpt)
        return trainer
    finally:
        set_workflow_state(None)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train a NequIP model with the PyTorch + CUDA port")
    parser.add_argument("-cn", "--config-name", required=True)
    parser.add_argument("-cp", "--config-path", default=".")
    parser.add_argument("--device", default="cuda", help="torch device of the run (default: cuda)")
    parser.add_argument("overrides", nargs="*",
                        help="overrides such as ++trainer.max_epochs=5, and ++ckpt_path=<checkpoint> to resume")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s")

    name = args.config_name
    if not name.endswith((".yaml", ".yml")):
        name += ".yaml"
    config = load_config(os.path.join(args.config_path, name))
    ckpt_path = None
    for ov in args.overrides:
        key, _, value = ov.lstrip("+").partition("=")
        if key == "ckpt_path":
            ckpt_path = value
            continue
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(value)
    run_config(config, ckpt_path=ckpt_path, device=args.device)


if __name__ == "__main__":
    main()
