"""``nequip-torch-compile``: export a trained model for deployment.

Port of ``nequip_tpu/scripts/compile.py``: load a checkpoint or a package,
apply modifiers, choose the target's fields (``ase`` / ``batch``, or
``pair_nequip``: edge vectors in, edge forces out, for an MD engine's pair
style), export one program per capacity rung
(``model/inference_models.py``), then check the artifact against its
contract (``validate_artifact``) and the loaded programs against the eager
model on the example batch, within ``model_tolerance`` of the model dtype.

Usage:
    nequip-torch-compile best.ckpt model.nequip_tpu_torch.zip [--target ase] [--device cuda|cpu]
        [--num-nodes N --num-edges E --num-frames F] [--capacity-ladder K --ladder-factor 1.5]
        [--modifiers NAME ...] [--mode torchexport|eager] [--no-check] [--tf32]

The example batch (a padded training batch of a checkpoint's data config,
or a package's ``example_data.pkl``) sets rung 0's capacities unless
``--num-nodes``/``--num-edges`` do; rung k >= 1 scales them by
``ladder_factor ** k`` (nodes rounded up to 128, edges to 256).  The
programs run on ``--device``, the card by default (raising without one).
"""

from __future__ import annotations

import argparse
import logging
import pickle
import zipfile

import numpy as np

log = logging.getLogger("nequip_tpu_torch")


def example_batch(path: str) -> dict:
    """The padded example batch (numpy) of a checkpoint or a package."""
    from ..model.saved_models import data_dict_from_checkpoint, is_package

    if is_package(path):
        with zipfile.ZipFile(path) as zf:
            if "example_data.pkl" not in zf.namelist():
                raise KeyError(f"package {path} has no example_data.pkl to size the programs by")
            return pickle.loads(zf.read("example_data.pkl"))
    return data_dict_from_checkpoint(path)


def ladder_batches(example: dict, n_nodes: int, n_edges: int, n_frames: int, rungs: int, factor: float):
    """One padded numpy batch per rung, of the example's first frame."""
    from ..data import _keys, pad_batch, round_up
    from ..data.atomic_data_dict import frame_from_batched

    frame = frame_from_batched(example, 0)
    out = []
    for k in range(max(1, rungs)):
        nn, ne = (n_nodes, n_edges) if k == 0 else (
            round_up(int(np.ceil(n_nodes * factor**k)), 128), round_up(int(np.ceil(n_edges * factor**k)), 256))
        same = nn == example[_keys.POSITIONS_KEY].shape[0] and ne == example[_keys.EDGE_INDEX_KEY].shape[1]
        out.append(example if same and k == 0 else pad_batch(frame, nn, ne, n_frames))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Export a NequIP model of the PyTorch + CUDA port")
    parser.add_argument("input_path", help="checkpoint (.ckpt) or package (.zip)")
    parser.add_argument("output_path", help="output artifact (.nequip_tpu_torch.zip)")
    parser.add_argument("--mode", choices=["torchexport", "eager"], default="torchexport")
    parser.add_argument("--target", choices=["ase", "batch", "pair_nequip"], default="ase")
    parser.add_argument("--num-nodes", type=int, default=None, help="node capacity of rung 0")
    parser.add_argument("--num-edges", type=int, default=None, help="edge capacity of rung 0")
    parser.add_argument("--num-frames", type=int, default=2, help="frame capacity")
    parser.add_argument("--capacity-ladder", type=int, default=1, metavar="N",
                        help="export N ascending capacity rungs; the calculator pads each system to the smallest "
                             "rung that fits, so a growing system needs no re-export")
    parser.add_argument("--ladder-factor", type=float, default=1.5, help="capacity growth between rungs")
    parser.add_argument("--modifiers", nargs="*", default=[], help="named model modifiers to apply")
    parser.add_argument("--no-check", action="store_true", help="skip the contract and numeric self-checks")
    parser.add_argument("--tf32", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device the programs run on (default: cuda)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from ..data import _keys, to_tensors
    from ..model.inference_models import (
        load_compiled_model,
        save_compiled_model,
        validate_artifact,
        with_edge_vector_inputs,
    )
    from ..model.modify_utils import modify
    from ..model.saved_models import load_saved_model
    from ..ops.kernels.tp_scatter import relayout_edge_stream
    from ..utils.device import resolve_device
    from ..utils.dtype import model_tolerance
    from ..utils.global_state import set_global_state
    from ._workflow_utils import set_workflow_state

    device = resolve_device(args.device)
    set_workflow_state("compile")
    try:
        set_global_state(allow_tf32=args.tf32)
        model = load_saved_model(args.input_path)
        if args.modifiers:
            model = modify(model, [{"modifier": m} for m in args.modifiers])
        model = model.to(device).requires_grad_(False)

        example = example_batch(args.input_path)
        n_nodes = args.num_nodes or example[_keys.POSITIONS_KEY].shape[0]
        n_edges = args.num_edges or example[_keys.EDGE_INDEX_KEY].shape[1]
        batches = []
        for b in ladder_batches(example, n_nodes, n_edges, args.num_frames, args.capacity_ladder, args.ladder_factor):
            b = to_tensors(b, device)
            if args.target == "pair_nequip":
                b = with_edge_vector_inputs(b)
            batches.append(relayout_edge_stream(b) if model.uses_fused_kernels else b)
        meta = save_compiled_model(args.output_path, model, batches, target=args.target, mode=args.mode)
        log.info(f"wrote {args.output_path}; capacity ladder {meta['capacity_ladder']}")

        if not args.no_check:
            validate_artifact(args.output_path)
            compiled = load_compiled_model(args.output_path, device=device)
            out_c = compiled(batches[0])
            out_e = model(batches[0])
            tol = model_tolerance(meta["model_dtype"])
            worst = max(float((out_c[k] - out_e[k]).abs().max()) for k in compiled.output_fields)
            if not worst <= tol:
                raise RuntimeError(f"compiled-against-eager check failed: max abs err {worst:.3e} > {tol:.0e}")
            log.info(f"self-check passed (max abs err {worst:.3e} <= {tol:.0e})")
    finally:
        set_workflow_state(None)


if __name__ == "__main__":
    main()
