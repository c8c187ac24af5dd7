"""ConFIG, EMA-ConFIG and schedule-free training of the port against the JAX
package's modules, float64 on the CPU.

* Three steps of each module against the JAX module's ``make_train_step``
  on the 1-layer model of ``tests/unit/train/test_optimizers_and_modules.py``
  (``_tiny_module``) with every leaf trainable (Bessel weights, per-type
  scales and shifts), so that both span the same parameters: ConFIG
  (``pinv``, the ``"value"`` clip, the module's coefficients), EMA-ConFIG
  (least squares, the ``"norm"`` clip, SoftAdapt-style trainer
  coefficients, an epoch LR scale of 0.5) and schedule-free (with a 2-step
  warmup and an epoch scale of 0.5, and without either).  Parameters,
  EMA and evaluation parameters and the logged losses within 1e-8 of their
  max.  The JAX reference runs its model as one jitted program (XLA); the
  port's runs ``tp_impl="fused"``, the kernels' plain twins through the
  autograd Functions the card runs, so ConFIG's k reverse passes go twice
  through their double backward.
* ConFIG's solve against ``jnp.linalg.lstsq`` and ``jnp.linalg.pinv``,
  nearly parallel rows included.
* The second pass over one graph (``retain_graph``) against separate
  forward and backward passes, for K1's and K4's routes: 1e-12 of max.
* The pinned quirks, against plain torch: ConFIG's ``A`` over the trainable
  parameters when the model has frozen leaves; schedule-free's clip and
  per-step schedule on the base updates.
* Resume: 2 epochs and a resume equal 4 straight epochs at rtol 1e-14 for
  EMA-ConFIG (with a per-step schedule), Muon + Adam and schedule-free
  (with an epoch scheduler).  And one ``nequip-torch-train`` run of
  ``lj_config.yaml`` with ``ScheduleFreeTrainModule`` and ``muon_adam``
  against the JAX CLI's trajectory: the metric rows at rel 1e-7 and the
  weights at 1e-6 of max, because Muon's Newton-Schulz runs in float32 on
  both sides (measured: 2.1e-8 and 1.2e-7; schedule-free alone is held at
  1e-8 above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_cli import STATS, _assert_rows_match, _assert_tensors_close, lj_config

from nequip_tpu.data import batched_from_list, pad_batch, to_device
from nequip_tpu.data import compute_neighborlist_ as jax_neighborlist
from nequip_tpu.data.dataset import LJTestDataset as JaxLJ
from nequip_tpu.data.transforms import ChemicalSpeciesToAtomTypeMapper as JaxMapper
from nequip_tpu.model import NequIPGNNModel as JaxModel
from nequip_tpu.scripts import train as jax_train
from nequip_tpu.train import ConFIGTrainModule as JaxConFIG
from nequip_tpu.train import EMAConFIGTrainModule as JaxEMAConFIG
from nequip_tpu.train import EnergyForceLoss as JaxLoss
from nequip_tpu.train import ScheduleFreeTrainModule as JaxScheduleFree
from nequip_tpu.utils import config as jax_config

from nequip_tpu_torch.data import DataLoader
from nequip_tpu_torch.data.dataset import LJTestDataset
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
from nequip_tpu_torch.model import NequIPGNNModel, flatten_tree, load_jax_params
from nequip_tpu_torch.scripts import train as port_train
from nequip_tpu_torch.train import (
    ConFIGTrainModule,
    EMAConFIGTrainModule,
    EnergyForceLoss,
    ScheduleFreeTrainModule,
)
from nequip_tpu_torch.train.checkpoint import load_checkpoint
from nequip_tpu_torch.train.config_module import _min_norm_solve
from nequip_tpu_torch.train.schedules import build_step_schedule

# _tiny_module's model, every leaf trainable
TINY = dict(seed=5, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=1, l_max=1, parity=False,
            num_features=4, radial_mlp_width=8, avg_num_neighbors=18.0, per_type_energy_shifts={"Cu": -0.4})
ALL_TRAINABLE = dict(bessel_trainable=True, per_type_energy_scales_trainable=True,
                     per_type_energy_shifts_trainable=True)
ADAM = {"_target_": "optax.adam", "learning_rate": 0.01}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JittedModel:
    """The JAX model with its call as one jitted program, shared by every
    module here so that XLA compiles it (and its derivatives) once."""

    def __init__(self, model):
        self._model = model
        self._call = jax.jit(model.__call__)

    def __call__(self, params, batch):
        return self._call(params, batch)

    def __getattr__(self, name):
        return getattr(self._model, name)


@pytest.fixture(scope="module")
def jax_setup():
    model = JaxModel(**TINY, **ALL_TRAINABLE)
    params = model.init_params()
    model.init = lambda rng: params  # every module starts from these
    ds = JaxLJ(num_frames=2, seed=3, transforms=[JaxMapper(["Cu"])])
    batch = to_device(pad_batch(batched_from_list([jax_neighborlist(ds[i], 4.0) for i in range(2)]), 128, 2048, 3))
    return model, _JittedModel(model), batch, flatten_tree(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def port_batch():
    ds = LJTestDataset(num_frames=2, seed=3, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]),
                                                         NeighborListTransform(4.0)])
    return next(iter(DataLoader(ds, batch_size=2, device="cpu")))


def _host(tree):
    return flatten_tree(jax.tree.map(np.asarray, tree))


def _port_tensors(model):
    return {k: t.detach().numpy() for k, t in model.jax_named_tensors()}


SOFTADAPT_COEFFS = np.asarray([0.3, 0.7], dtype=np.float32)
MODULE_CASES = {
    "config_pinv_value_clip": (JaxConFIG, ConFIGTrainModule,
                               dict(lsqr=False, gradient_clip_val=1e-3, gradient_clip_algorithm="value"), None, None),
    "ema_config_lsqr_norm_clip": (JaxEMAConFIG, EMAConFIGTrainModule, dict(lsqr=True, gradient_clip_val=0.5),
                                  SOFTADAPT_COEFFS, 0.5),
    "schedule_free_warmup": (JaxScheduleFree, ScheduleFreeTrainModule, dict(warmup_steps=2), None, 0.5),
    "schedule_free": (JaxScheduleFree, ScheduleFreeTrainModule, dict(), None, None),
    # a base optimizer that reads the loss: optax's schedule_free hands its extra arguments on
    "schedule_free_polyak": (JaxScheduleFree, ScheduleFreeTrainModule, dict(
        optimizer={"_target_": "optax.polyak_sgd", "max_learning_rate": 1e3, "scaling": 0.5}), None, 0.5),
}


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_matches_jax(case, jax_setup, port_batch):
    jax_cls, port_cls, kwargs, coeffs, scale = MODULE_CASES[case]
    kwargs = dict(kwargs)
    optimizer = kwargs.pop("optimizer", ADAM)
    model, jitted, batch, init = jax_setup
    jax_module = jax_cls(model=model, loss=JaxLoss(type_names=["Cu"]), optimizer=optimizer, **kwargs)
    state = jax_module.init_state()
    if jax_cls is JaxScheduleFree:  # a first-order step: the shared jitted model's derivatives serve
        jax_module.model = jitted
        step = jax_module.make_train_step()
    else:  # k reverse passes: one program compiles faster than their eager composition
        step = jax.jit(jax_module.make_train_step())
    lr_scale = None if scale is None else jnp.asarray(scale, dtype=jnp.float32)
    jax_logs = []
    for _ in range(3):
        state, logs = step(state, batch, coeffs, lr_scale)
        jax_logs.append({k: float(v) for k, v in logs.items()})

    port_model = load_jax_params(NequIPGNNModel(tp_impl="fused", **TINY, **ALL_TRAINABLE), init)
    module = port_cls(port_model, loss=EnergyForceLoss(type_names=["Cu"]), optimizer=optimizer, device="cpu", **kwargs)
    assert not module.frozen_paths
    if hasattr(module, "ema_model"):
        module.ema_model.load_state_dict(port_model.state_dict())
    if scale is not None:
        module.set_lr_scale(scale)
    for want in jax_logs:
        got = module.training_step(port_batch, coeffs)
        assert set(got) == set(want)
        for k in want:
            assert float(got[k]) == pytest.approx(want[k], rel=1e-8), k

    _assert_tensors_close(_port_tensors(port_model), _host(state.params), 1e-8)
    if state.ema_params is not None:
        _assert_tensors_close(_port_tensors(module.ema_model), _host(state.ema_params), 1e-8)
    if port_cls is ScheduleFreeTrainModule:
        x = _host(jax_module.evaluation_params(state))
        _assert_tensors_close(_port_tensors(module.evaluation_model()), x, 1e-8)
        assert any(np.abs(x[k] - _host(state.params)[k]).max() > 0 for k in x)
        assert module.step_count == int(state.opt_state.step_count) == 4


def _nearly_parallel(k, P, gap, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.standard_normal((k, P))
    A[1] = A[0] + gap * rng.standard_normal(P)
    return A, rng.standard_normal(k)


@pytest.mark.parametrize("gap", [1.0, 1e-6, 0.0])
def test_min_norm_solve_matches_jax(gap):
    A, b = _nearly_parallel(3, 400, gap)
    for lsqr, want in ((True, jnp.linalg.lstsq(A, b)[0]), (False, jnp.linalg.pinv(A) @ b)):
        got = _min_norm_solve(torch.tensor(A), torch.tensor(b), lsqr).numpy()
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max(), (lsqr, gap)


def _component_grads(module, batch, names):
    """Each loss component's gradient from its own forward and backward."""
    params = [p for _, p in module.named_trainable()]
    rows = []
    for name in names:
        out = module.model(module._prepare(batch))
        _, values = module.loss.values(module.loss.batch_state(out, batch))
        grads = torch.autograd.grad(values[name], params)
        rows.append(torch.cat([g.reshape(-1) for g in grads]))
    return torch.stack(rows)


@pytest.mark.parametrize("tp_impl", ["fused", "fused_tp"])
def test_second_pass_matches_separate_passes(tp_impl, port_batch):
    """The kernels' autograd Functions give the same gradients on a second
    reverse pass over one graph (``retain_graph``)."""
    model = NequIPGNNModel(tp_impl=tp_impl, **TINY)
    module = ConFIGTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), device="cpu")
    A_raw, _, _ = module.component_grads(port_batch)
    want = _component_grads(module, port_batch, ["per_atom_energy_mse", "forces_mse"])
    assert A_raw.shape == want.shape and A_raw.shape[0] == 2
    for got_row, want_row in zip(A_raw, want):
        assert float((got_row - want_row).abs().max()) <= 1e-12 * float(want_row.abs().max())


def test_config_spans_the_trainable_parameters(port_batch):
    """With frozen leaves (fixed Bessel weights and per-type shift) ConFIG's
    A spans the trainable parameters; against the same step in plain torch:
    per-component gradients, the normalised minimum-norm solve by
    ``torch.linalg.lstsq`` (gelsd), then ``torch.optim.Adam``."""
    model = NequIPGNNModel(tp_impl="fused", **TINY)
    module = ConFIGTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), optimizer=ADAM, device="cpu")
    assert module.frozen_paths == ["bessel_encode.bessel_weights", "per_type_energy_scale_shift.shifts"]
    frozen_before = {k: t.clone() for k, t in model.jax_named_tensors() if k in module.frozen_paths}
    ref_model = NequIPGNNModel(tp_impl="torch", **TINY)
    ref = ConFIGTrainModule(ref_model, loss=EnergyForceLoss(type_names=["Cu"]), device="cpu")
    adam = torch.optim.Adam([p for _, p in ref.named_trainable()], lr=0.01, foreach=False)
    for _ in range(2):
        module.training_step(port_batch)
        A_raw = _component_grads(ref, port_batch, ["per_atom_energy_mse", "forces_mse"])
        A = A_raw / (A_raw.norm(dim=1, keepdim=True) + 1e-8)
        b = torch.tensor([0.5, 0.5], dtype=torch.float64)
        b = b / (b.norm() + 1e-8)
        x = torch.linalg.lstsq(A, b[:, None], driver="gelsd").solution[:, 0]
        x = x / (x.norm() + 1e-8)
        flat = (A_raw @ x).sum() * x
        params = [p for _, p in ref.named_trainable()]
        for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
            p.grad = g.view_as(p).clone()
        adam.step()
    for (k, p), (_, q) in zip(model.jax_named_tensors(), ref_model.jax_named_tensors()):
        assert float((p - q).detach().abs().max()) <= 1e-10 * float(q.detach().abs().max()), k
    for k, t in model.jax_named_tensors():
        if k in frozen_before:
            assert torch.equal(t, frozen_before[k]), k


def test_schedule_free_clip_and_schedule_act_on_base_updates(port_batch):
    """The port clips the gradient at y and scales the base rate by the
    per-step schedule (inside schedule-free), with or without frozen leaves;
    against the same updates in plain torch."""
    sched = {"_target_": "optax.linear_schedule", "init_value": 1.0, "end_value": 0.2, "transition_steps": 3}
    clip, b1 = 1e-3, 0.9
    model = NequIPGNNModel(tp_impl="fused", **TINY)
    module = ScheduleFreeTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), optimizer=ADAM, device="cpu",
                                     gradient_clip_val=clip, lr_scheduler=sched, warmup_steps=2)
    module.set_lr_scale(0.5)
    ref_model = NequIPGNNModel(tp_impl="torch", **TINY)
    ref = ScheduleFreeTrainModule(ref_model, loss=EnergyForceLoss(type_names=["Cu"]), device="cpu")
    params = [p for _, p in ref.named_trainable()]
    adam = torch.optim.Adam(params, lr=0.01, foreach=False)
    factor = build_step_schedule(sched)
    z = [p.detach().clone() for p in params]
    weight_sum = max_lr = 0.0
    for t in range(3):
        module.training_step(port_batch)
        adam.zero_grad()
        loss, _, _ = ref.compute_loss(port_batch)
        loss.backward()
        norm = float(torch.sqrt(sum((p.grad**2).sum() for p in params)))
        assert norm > 10 * clip, "the clip must bind"
        with torch.no_grad():
            for p in params:
                p.grad.mul_(clip / norm)
            y = [p.detach().clone() for p in params]
            adam.param_groups[0]["lr"] = 0.01 * factor(t)
            adam.step()
            max_lr = max(max_lr, min(1.0, (t + 1) / 2))
            weight_sum += max_lr**2
            ck = max_lr**2 / weight_sum
            for p, yi, zi in zip(params, y, z):
                z_new = zi + (p - yi)
                x = (1 - ck) * (yi - (1 - b1) * zi) / b1 + ck * z_new
                p.copy_(yi + (b1 * x + (1 - b1) * z_new - yi) * 0.5)
                zi.copy_(z_new)
    for (k, p), (_, q) in zip(model.jax_named_tensors(), ref_model.jax_named_tensors()):
        assert float((p - q).detach().abs().max()) <= 1e-10 * float(q.detach().abs().max()), k
    ref.z = z
    ref._eval_stale = True
    for (k, p), (_, q) in zip(module.evaluation_model().jax_named_tensors(),
                              ref.evaluation_model().jax_named_tensors()):
        assert float((p - q).detach().abs().max()) <= 1e-10 * float(q.detach().abs().max()), k


def _without_ema(cfg):
    cfg["training_module"].pop("ema_decay")
    return cfg


RESUME_CASES = {
    "ema_config_step_schedule": {
        "training_module._target_": "nequip_tpu.train.EMAConFIGTrainModule", "training_module.lsqr": True,
        "training_module.lr_scheduler": {"_target_": "optax.warmup_cosine_decay_schedule", "init_value": 0.1,
                                         "peak_value": 1.0, "warmup_steps": 2, "decay_steps": 8}},
    "muon_adam": {"training_module.optimizer": {"_target_": "nequip_tpu.train.muon_adam", "muon_lr": 0.01,
                                                "adam_lr": 0.005}},
    "schedule_free_epoch_scheduler": {
        "training_module._target_": "nequip_tpu.train.ScheduleFreeTrainModule", "training_module.warmup_steps": 2,
        "training_module.lr_scheduler": {"scheduler": {"_target_": "nequip_tpu.train.StepLR", "step_size": 1,
                                                       "gamma": 0.5}, "interval": "epoch", "frequency": 1}},
}


def _assert_state_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_state_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-14, atol=1e-300, err_msg=path)
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-300, err_msg=path)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=1e-14, abs=1e-300), path
    else:
        assert a == b, path


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_equals_straight_run(case, tmp_path):
    """One step an epoch (a partial sampler of 2 frames, batch 2)."""
    overrides = {**RESUME_CASES[case], "data.train_dataloader.num_samples_per_epoch": 2}

    def run(name, epochs, ckpt_path=None):
        cfg = lj_config(tmp_path / name, "port", {**overrides, "trainer.max_epochs": epochs})
        if "ScheduleFree" in cfg["training_module"]["_target_"]:
            _without_ema(cfg)
        return port_train.run_config(cfg, ckpt_path=ckpt_path, device="cpu")

    straight = run("straight", 4)
    run("resume", 2)
    resumed = run("resume", 4, ckpt_path=str(tmp_path / "resume" / "last.ckpt"))
    assert straight.global_step == resumed.global_step == 4
    a, b = (load_checkpoint(tmp_path / d / "last.ckpt") for d in ("straight", "resume"))
    _assert_state_equal(a["state"], b["state"])
    for key in ("lr_scale", "loss_coeffs", "dataloader_state", "lr_scheduler_state"):
        assert b["meta"][key] == a["meta"][key], key
    state = a["state"]
    assert state["update_count"] == 4
    if case == "schedule_free_epoch_scheduler":
        assert state["schedule_free"]["step_count"] == 5 and a["meta"]["lr_scale"] == 0.125
        assert "eval_params" in state and "ema_params" not in state
    if case == "muon_adam":
        assert [sorted(s["state"][0]) for s in state["optimizer"]["optimizers"]] == [
            ["momentum_buffer"], ["exp_avg", "exp_avg_sq", "step"]]


def test_cli_schedule_free_muon_adam_matches_jax(tmp_path, monkeypatch):
    """``nequip-torch-train`` of lj_config.yaml with ScheduleFreeTrainModule
    (a 2-step warmup) over muon_adam against the JAX CLI: the metric rows
    (validation and test run the evaluation parameters, from best.ckpt),
    the final weights and evaluation weights."""
    overrides = {"run": ["train", "val", "test"], "trainer.max_epochs": 2,
                 "training_module._target_": "nequip_tpu.train.ScheduleFreeTrainModule",
                 "training_module.warmup_steps": 2,
                 "training_module.optimizer": {"_target_": "nequip_tpu.train.muon_adam", "muon_lr": 0.01,
                                               "adam_lr": 0.005}}
    jax_config._RESOLVERS.pop(STATS, None)
    dm, module, trainer, _ = jax_train.build_from_config(_without_ema(lj_config(tmp_path / "jax", "jax", overrides)))
    jax_config._RESOLVERS.pop(STATS, None)
    init = _host(module.init_state().params)
    trainer.fit(module, dm)
    jax_final, jax_eval = _host(trainer.state.params), _host(module.evaluation_params(trainer.state))
    trainer.validate(module, dm, ckpt_path="best")
    trainer.test(module, dm, ckpt_path="best")

    build = port_train.build_from_config

    def build_with_jax_weights(config, ckpt_path=None, device="cuda"):
        out = build(config, ckpt_path, device)
        load_jax_params(out[1].model, init)
        return out

    monkeypatch.setattr(port_train, "build_from_config", build_with_jax_weights)
    port = port_train.run_config(_without_ema(lj_config(tmp_path / "port", "port",
                                                        {**overrides, "training_module.model.tp_impl": "fused"})),
                                 device="cpu")
    _assert_rows_match(port.metrics_rows, trainer._metrics_rows, rel=1e-7)
    last = load_checkpoint(tmp_path / "port" / "last.ckpt")["state"]
    hp = load_checkpoint(tmp_path / "port" / "last.ckpt")["config"]["config"]["training_module"]
    assert hp["_target_"] == "nequip_tpu_torch.train.ScheduleFreeTrainModule" and hp["warmup_steps"] == 2
    _assert_tensors_close(last["params"], jax_final, 1e-6)
    _assert_tensors_close(last["eval_params"], jax_eval, 1e-6)


@pytest.mark.parametrize("cls, kwargs", [
    (EMAConFIGTrainModule, dict(lsqr=False, norm_eps=1e-6, gradient_clip_algorithm="value", gradient_clip_val=0.1,
                                ema_decay=0.9)),
    (ScheduleFreeTrainModule, dict(warmup_steps=3, sf_b1=0.8, learning_rate=0.5)),
], ids=["ema_config", "schedule_free"])
def test_hyperparameters_rebuild_the_module(cls, kwargs):
    """A checkpoint's config (``hyperparameters()``) rebuilds the module with
    its own arguments."""
    from nequip_tpu_torch.utils.config import instantiate

    module = cls(NequIPGNNModel(tp_impl="fused", **TINY), device="cpu",
                 loss={"_target_": "nequip_tpu_torch.train.EnergyForceLoss", "type_names": ["Cu"]},
                 optimizer={"_target_": "nequip_tpu_torch.train.muon_adam", "muon_lr": 0.01},
                 lr_scheduler={"_target_": "optax.linear_schedule", "init_value": 1.0, "end_value": 0.5,
                               "transition_steps": 4}, **kwargs)
    hp = module.hyperparameters()
    assert {k: hp[k] for k in kwargs} == kwargs
    rebuilt = instantiate(hp, _recursive_=False, device="cpu")
    assert type(rebuilt) is cls and rebuilt.hyperparameters() == hp
