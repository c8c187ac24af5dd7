"""Writer of ``tests/data/torch_port_options_golden.npz``: the model
builder's options, written by the JAX package for the card, which has no JAX.

Three models, each built by the JAX builder in float64 on the CPU, with its
``model_config`` (JSON, ``<name>/config``), its parameter tree
(``<name>/params/<dotted path>``) and its ``energy``, ``forces`` and
``stress`` on the 108-atom jittered fcc Cu frame of
``tests/torch_port_golden.py`` (total charge 1, read by the categorical
embedding):

* ``options``: the norm nonlinearity, a categorical embedding of the total
  charge, ``learnable_shift``, trainable Bessel frequencies, scales and
  shifts, ``remat_conv`` and ``remat_force`` (K1's route in the port);
* ``depth2``: a depth-2 radial MLP at ``tp_impl="pallas_fused"`` (K4's
  route in the port);
* ``preset_m``: ``PresetNequIPGNNModel("M")`` cut to 2 layers and features
  [16, 8, 4].

The JAX side computes at ``tp_impl="xla"`` (its kernels give the same
values); ``chip_smoke.py`` (phase 14a) builds each config in the port at
``tp_impl="fused"``, loads the tree and holds its kernels' outputs against
the stored ones; ``tests/test_torch_port_options_golden.py`` checks that
the file is fresh and runs the same comparison on the CPU.  Regenerate with

    JAX_PLATFORMS=cpu python tests/torch_port_options_golden.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_port_options_golden.npz"
N_ATOMS = 108
BASE = dict(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, avg_num_neighbors=18.0,
            per_type_energy_shifts={"Cu": -3.5}, per_type_energy_scales={"Cu": 0.5}, radial_mlp_width=16)
MODELS = {
    "options": ("NequIPGNNModel", dict(
        BASE, num_layers=2, l_max=2, parity=False, num_features=8, convnet_nonlinearity_type="norm",
        categorical_graph_field_embed=[{"field": "charge", "min": -1, "max": 1, "num_features": 4}],
        learnable_shift=True, bessel_trainable=True, per_type_energy_scales_trainable=True,
        per_type_energy_shifts_trainable=True, remat_conv=True, remat_force=True)),
    "depth2": ("NequIPGNNModel", dict(BASE, num_layers=2, l_max=1, parity=False, num_features=8,
                                      radial_mlp_depth=2, tp_impl="pallas_fused")),
    "preset_m": ("PresetNequIPGNNModel", dict(BASE, preset="M", num_layers=2, num_features=[16, 8, 4],
                                              type_embed_num_features=8)),
}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def make_golden() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _fcc_frame
    from nequip_tpu import model as jax_models
    from nequip_tpu.data import _keys, batched_from_list, compute_neighborlist_, pad_batch, to_device

    frame = _fcc_frame(N_ATOMS, seed=0, jitter=0.1)
    frame[_keys.TOTAL_CHARGE_KEY] = np.array([1])
    nl = compute_neighborlist_(dict(frame), 4.0, backend="kdtree")
    n_edges = nl[_keys.EDGE_INDEX_KEY].shape[1]
    batch = to_device(pad_batch(batched_from_list([nl]), 128, ((n_edges + 255) // 256) * 256, 2))
    golden = dict(pos=frame[_keys.POSITIONS_KEY], cell=frame[_keys.CELL_KEY].reshape(3, 3),
                  pbc=frame[_keys.PBC_KEY].reshape(3), atomic_numbers=frame[_keys.ATOMIC_NUMBERS_KEY],
                  charge=np.array([1]))
    for name, (builder, cfg) in MODELS.items():
        model = getattr(jax_models, builder)(**dict(cfg, tp_impl="xla"))
        params = jax.tree.map(np.asarray, model.init_params())
        out = jax.jit(model)(params, batch)
        golden[f"{name}/config"] = np.array(json.dumps(dict(model.model_config, tp_impl=cfg.get("tp_impl", "xla"))))
        golden.update({f"{name}/params/{k}": v for k, v in _flatten(params).items()})
        golden[f"{name}/energy"] = np.asarray(out[_keys.TOTAL_ENERGY_KEY]).reshape(-1)[0]
        golden[f"{name}/forces"] = np.asarray(out[_keys.FORCE_KEY])[:N_ATOMS]
        golden[f"{name}/stress"] = np.asarray(out[_keys.STRESS_KEY])[0]
    return golden


def main() -> None:
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN, **make_golden())
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    main()
