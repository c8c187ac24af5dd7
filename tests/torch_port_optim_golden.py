"""Writer of ``tests/data/torch_port_optim_golden.npz``: three training steps
of the JAX package's ConFIG, Muon, schedule-free and Adam variants and of
optax's Lion (a schedule as rate), Adafactor (factored leaves), LAMB (a
dict mask), Polyak SGD and ``reduce_on_plateau`` (both reading the loss),
for the card, which has no JAX.

A small model with every leaf trainable (1 layer, l_max 1, 8 features,
trainable Bessel weights and per-type scales and shifts; its
``model_config`` as JSON in ``config``, its initial parameters under
``init/<dotted path>``) on the 108-atom jittered fcc Cu frame of
``tests/torch_port_golden.py``, labelled with the truncated Lennard-Jones
potential (``lj_reference``), under ``EnergyForceLoss`` with the loss
coefficients the trainer passes (float32).  Each case of ``CASES`` (stored
as JSON in ``cases``: the module class, its arguments, the optimizer and
the LR schedule, in the JAX package's names) takes three steps of its JAX
module's ``make_train_step`` from those parameters; stored are the
parameters after them (``<case>/params/<path>``) and, for EMA-ConFIG and
schedule-free, the evaluation parameters (``<case>/eval/<path>``).
EMA-ConFIG's parameters are also ConFIG's with ``lsqr=True``.

The JAX side runs ``tp_impl="xla"``: each ConFIG step as one jitted
program, the other cases through the model's call jitted once.
``chip_smoke.py`` (phase 15a, ``optim_golden_case``) runs the same steps
through the port's kernels in float64 and holds them against these values;
``tests/test_torch_port_optim_golden.py`` checks that the file is fresh
and runs the same comparison on the CPU.  Regenerate with

    JAX_PLATFORMS=cpu python tests/torch_port_optim_golden.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
from torch_port_golden import _flatten

ROOT = Path(__file__).resolve().parents[1]
OPTIM_GOLDEN = ROOT / "tests" / "data" / "torch_port_optim_golden.npz"
N_ATOMS = 108
STEPS = 3
MODEL = dict(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=1, l_max=1, parity=False,
             num_features=8, radial_mlp_width=16, avg_num_neighbors=18.0, per_type_energy_shifts={"Cu": -3.5},
             per_type_energy_scales={"Cu": 0.5}, bessel_trainable=True, per_type_energy_scales_trainable=True,
             per_type_energy_shifts_trainable=True)
ADAM = {"_target_": "optax.adam", "learning_rate": 0.005}
CASES = {
    "config_pinv": {"module": "ConFIGTrainModule", "kwargs": {"lsqr": False}, "optimizer": ADAM},
    "ema_config_lsqr": {"module": "EMAConFIGTrainModule", "kwargs": {"lsqr": True, "ema_decay": 0.9},
                        "optimizer": ADAM},
    "muon_adam": {"module": "NequIPTrainModule", "kwargs": {},
                  "optimizer": {"_target_": "nequip_tpu.train.muon_adam", "muon_lr": 0.01, "adam_lr": 0.005}},
    "schedule_free": {"module": "ScheduleFreeTrainModule", "kwargs": {"warmup_steps": 2}, "optimizer": ADAM},
    "adam_eps_root": {"module": "NequIPTrainModule", "kwargs": {},
                      "optimizer": {**ADAM, "eps_root": 1e-8}},
    "adam_warmup_cosine": {"module": "NequIPTrainModule", "optimizer": ADAM, "kwargs": {"lr_scheduler": {
        "_target_": "optax.warmup_cosine_decay_schedule", "init_value": 0.1, "peak_value": 1.0, "warmup_steps": 1,
        "decay_steps": 4}}},
    # optax's other optimizers on the port's optax chains
    "lion_warmup_cosine": {"module": "NequIPTrainModule", "kwargs": {}, "optimizer": {
        "_target_": "optax.lion", "learning_rate": {
            "_target_": "optax.warmup_cosine_decay_schedule", "init_value": 0.0005, "peak_value": 0.002,
            "warmup_steps": 1, "decay_steps": 4}}},
    # every 2-D leaf but the readout's (8, 1) and the embedding's (1, 8) is factored
    "adafactor_factored": {"module": "NequIPTrainModule", "kwargs": {}, "optimizer": {
        "_target_": "optax.adafactor", "learning_rate": 0.01, "min_dim_size_to_factor": 8}},
    "lamb_mask": {"module": "NequIPTrainModule", "kwargs": {}, "optimizer": {
        "_target_": "optax.lamb", "learning_rate": 0.005, "weight_decay": 0.1, "mask": {
            "type_embed": True, "bessel_encode": False,
            "layer0_convnet": {"conv": {"linear_1": True, "edge_mlp": False, "linear_2": True}},
            "per_atom_energy_readout": True, "per_type_energy_scale_shift": False}}},
    # f_min near the loss (4.80): a step of (loss - f_min) / ||g||^2 ~ 0.01, set by the loss the module hands over
    "polyak_sgd": {"module": "NequIPTrainModule", "kwargs": {}, "optimizer": {
        "_target_": "optax.polyak_sgd", "max_learning_rate": 1.0, "f_min": 4.75}},
    # the bare plateau scale times a negative constant schedule: SGD at 0.005 times a scale that halves at
    # steps 2 and 3 (rtol 0.5: the loss never halves)
    "reduce_on_plateau": {"module": "NequIPTrainModule", "optimizer": {
        "_target_": "optax.contrib.reduce_on_plateau", "factor": 0.5, "patience": 1, "rtol": 0.5}, "kwargs": {
        "lr_scheduler": {"_target_": "optax.constant_schedule", "value": -0.005}}},
}


class _JittedModel:
    """The JAX model with its call jitted once for every case."""

    def __init__(self, model):
        import jax

        self._model = model
        self._call = jax.jit(model.__call__)

    def __call__(self, params, batch):
        return self._call(params, batch)

    def __getattr__(self, name):
        return getattr(self._model, name)


def make_optim_golden() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _fcc_frame
    from nequip_tpu import train as jax_train
    from nequip_tpu.data import _keys, batched_from_list, compute_neighborlist_, pad_batch, to_device
    from nequip_tpu.data.dataset import lj_reference
    from nequip_tpu.model import NequIPGNNModel

    model = NequIPGNNModel(tp_impl="xla", **MODEL)
    params = model.init_params()
    model.init = lambda rng: params
    jitted = _JittedModel(model)
    frame = _fcc_frame(N_ATOMS, seed=0, jitter=0.1)
    cell = frame[_keys.CELL_KEY].reshape(3, 3)
    labels = lj_reference(frame[_keys.POSITIONS_KEY], cell, (True, True, True))
    frame.update({k: labels[k] for k in (_keys.TOTAL_ENERGY_KEY, _keys.FORCE_KEY)})
    nl = compute_neighborlist_(dict(frame), 4.0, backend="kdtree")
    n_edges = nl[_keys.EDGE_INDEX_KEY].shape[1]
    batch = to_device(pad_batch(batched_from_list([nl]), 128, ((n_edges + 255) // 256) * 256, 2))
    golden = dict(
        pos=frame[_keys.POSITIONS_KEY], cell=cell, pbc=frame[_keys.PBC_KEY].reshape(3),
        atomic_numbers=frame[_keys.ATOMIC_NUMBERS_KEY], total_energy=labels[_keys.TOTAL_ENERGY_KEY].reshape(()),
        forces=labels[_keys.FORCE_KEY], config=np.array(json.dumps(model.model_config)),
        cases=np.array(json.dumps(CASES)),
    )
    golden.update({f"init/{k}": v for k, v in _flatten(params).items()})
    for name, case in CASES.items():
        module = getattr(jax_train, case["module"])(model=model, loss=jax_train.EnergyForceLoss(type_names=["Cu"]),
                                                    optimizer=case["optimizer"], **case["kwargs"])
        state = module.init_state()
        if "ConFIG" in case["module"]:  # k reverse passes: one program compiles faster than their eager composition
            step = jax.jit(module.make_train_step())
        else:  # first order: the shared jitted model's derivatives serve every case
            module.model = jitted
            step = module.make_train_step()
        coeffs = np.asarray(module.loss.coeff_vector(), dtype=np.float32)
        for _ in range(STEPS):
            state, _ = step(state, batch, coeffs, np.float32(1.0))
        golden.update({f"{name}/params/{k}": v for k, v in _flatten(state.params).items()})
        if case["module"] in ("EMAConFIGTrainModule", "ScheduleFreeTrainModule"):
            golden.update({f"{name}/eval/{k}": v for k, v in _flatten(module.evaluation_params(state)).items()})
    return golden


def main() -> None:
    OPTIM_GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(OPTIM_GOLDEN, **make_optim_golden())
    print(f"wrote {OPTIM_GOLDEN}")


if __name__ == "__main__":
    main()
