"""Writer of ``tests/data/torch_port_train_golden.npz``, the port's training
golden file.

The JAX package (the reference) computes, in float64 on the CPU, the rr
force loss of the flagship model (the parameters of
``tests/data/torch_port_golden.npz``: ``init_params()`` at seed 0) on the
108-atom jittered fcc Cu frame of that file, labelled with the truncated
Lennard-Jones potential (``lj_reference``), under ``EnergyForceLoss``
(per-atom energy and forces, coefficients 1:1), and its gradient with
respect to every parameter.  Stored: the frame (``pos``, ``cell``, ``pbc``,
``atomic_numbers``), the labels (``total_energy``, ``forces``), ``loss`` and
``grads/<dotted path>``.

``chip_smoke.py`` (the golden-training phase) runs the same loss through the
port's kernels on the GPU and holds it against these values;
``tests/test_torch_port_train_golden.py`` rewrites the data here and checks
that the file is unchanged.  Regenerate with

    JAX_PLATFORMS=cpu python tests/torch_port_train_golden.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
from torch_port_golden import _flatten

ROOT = Path(__file__).resolve().parents[1]
TRAIN_GOLDEN = ROOT / "tests" / "data" / "torch_port_train_golden.npz"
N_ATOMS = 108
JITTER = 0.1


def make_train_golden() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _fcc_frame, _flagship_model
    from nequip_tpu.data import _keys, batched_from_list, compute_neighborlist_, pad_batch, to_device
    from nequip_tpu.data.dataset import lj_reference
    from nequip_tpu.train import EnergyForceLoss

    model = _flagship_model("float64", tp_impl="xla")
    params = model.init_params()
    frame = _fcc_frame(N_ATOMS, seed=0, jitter=JITTER)
    cell = frame[_keys.CELL_KEY].reshape(3, 3)
    labels = lj_reference(frame[_keys.POSITIONS_KEY], cell, (True, True, True))
    frame.update({k: labels[k] for k in (_keys.TOTAL_ENERGY_KEY, _keys.FORCE_KEY)})
    nl = compute_neighborlist_(dict(frame), 4.0, backend="kdtree")
    n_edges = nl[_keys.EDGE_INDEX_KEY].shape[1]
    batch = to_device(pad_batch(batched_from_list([nl]), 128, ((n_edges + 255) // 256) * 256, 2))
    loss_mgr = EnergyForceLoss(type_names=["Cu"])

    def loss_fn(p):
        return loss_mgr.values(loss_mgr.batch_state(model(p, batch), batch), loss_mgr.coeff_vector())[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    golden = {f"grads/{k}": v for k, v in _flatten(grads).items()}
    golden.update(
        pos=frame[_keys.POSITIONS_KEY],
        cell=cell,
        pbc=frame[_keys.PBC_KEY].reshape(3),
        atomic_numbers=frame[_keys.ATOMIC_NUMBERS_KEY],
        total_energy=labels[_keys.TOTAL_ENERGY_KEY].reshape(()),
        forces=labels[_keys.FORCE_KEY],
        loss=np.asarray(loss),
    )
    return golden


def main() -> None:
    TRAIN_GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(TRAIN_GOLDEN, **make_train_golden())
    print(f"wrote {TRAIN_GOLDEN}")


if __name__ == "__main__":
    main()
