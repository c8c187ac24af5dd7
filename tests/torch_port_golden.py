"""Writer of ``tests/data/torch_port_golden.npz``, the port's golden file.

The JAX package (the reference) computes, in float64 on the CPU:

* the flagship model's parameter tree from ``init_params()`` (seed 0),
  stored as ``params/<dotted path>``;
* a 108-atom jittered fcc Cu frame (``pos``, ``cell``, ``pbc``,
  ``atomic_numbers``);
* the model's ``energy``, ``forces`` and ``stress`` on that frame.

``chip_smoke.py`` (phase 3) loads the tree into the port, runs the frame
through the port's kernels on the GPU and holds the result against the
stored outputs; ``tests/test_torch_port_golden.py`` rewrites the data here
and checks that the file is unchanged.  Regenerate with

    JAX_PLATFORMS=cpu python tests/torch_port_golden.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
N_ATOMS = 108
JITTER = 0.1


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
    from __graft_entry__ import _fcc_frame, _flagship_model
    from nequip_tpu.data import _keys, batched_from_list, compute_neighborlist_, pad_batch, to_device

    model = _flagship_model("float64", tp_impl="xla")
    params = jax.tree.map(np.asarray, model.init_params())
    frame = _fcc_frame(N_ATOMS, seed=0, jitter=JITTER)
    nl = compute_neighborlist_(dict(frame), 4.0, backend="kdtree")
    n_edges = nl[_keys.EDGE_INDEX_KEY].shape[1]
    batch = pad_batch(batched_from_list([nl]), 128, ((n_edges + 255) // 256) * 256, 2)
    out = jax.jit(model)(params, to_device(batch))
    golden = {f"params/{k}": v for k, v in _flatten(params).items()}
    golden.update(
        pos=frame[_keys.POSITIONS_KEY],
        cell=frame[_keys.CELL_KEY].reshape(3, 3),
        pbc=frame[_keys.PBC_KEY].reshape(3),
        atomic_numbers=frame[_keys.ATOMIC_NUMBERS_KEY],
        energy=np.asarray(out[_keys.TOTAL_ENERGY_KEY]).reshape(-1)[0],
        forces=np.asarray(out[_keys.FORCE_KEY])[:N_ATOMS],
        stress=np.asarray(out[_keys.STRESS_KEY])[0],
    )
    return golden


def main() -> None:
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN, **make_golden())
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    main()
