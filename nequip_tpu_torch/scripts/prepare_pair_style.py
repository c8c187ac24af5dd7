"""``nequip-torch-prepare-pair-style``: a model as a pair-style file for MD engines.

Port of ``nequip_tpu/scripts/prepare_pair_style.py``: reads a checkpoint or
a package (``model/saved_models.py``) and writes a self-contained
``.nequip_tpu.pair.pkl`` in the JAX package's format, which an MD-engine
plugin loads with ``NequIPPairStyleWrapper.load`` and calls with per-rank
edge vectors (the model's edge-force branch).

Usage:
    nequip-torch-prepare-pair-style best.ckpt model.nequip_tpu.pair.pkl [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Prepare a pair-style file of the PyTorch + CUDA port")
    parser.add_argument("ckpt_path", help="checkpoint (.ckpt) or package (.zip)")
    parser.add_argument("output_path", help="*.nequip_tpu.pair.pkl")
    parser.add_argument("--device", default="cuda", help="torch device the wrapper runs on (default: cuda)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from ..integrations.pair_style import NequIPPairStyleWrapper
    from ..model.saved_models import load_saved_model
    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # before loading: no card, no work
    NequIPPairStyleWrapper(load_saved_model(args.ckpt_path), device=device).save(args.output_path)
    logging.getLogger("nequip_tpu_torch").info(f"wrote {args.output_path}")


if __name__ == "__main__":
    main()
