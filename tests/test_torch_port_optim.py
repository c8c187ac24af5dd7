"""The port's optimizers, per-step schedules, Muon, multi-model modules and
``WandbWatch`` against optax and the JAX package, float64 on the CPU.

* Adam (``eps_root``, Nesterov), AdamW and SGD (momentum, Nesterov) from
  their optax configs, 5 updates on a small parameter tree with the same
  numpy gradients: every parameter within 1e-12 of its max |value|, and
  the displacement within 1e-12 of its max.
* The seven schedules under both spellings on a grid of counts: rel 1e-12
  against optax's arithmetic in float64 (an int64 count).  The JAX step
  counts in int32 (``scale_by_schedule``), where optax's linear,
  polynomial, exponential and warmup-cosine schedules compute in float32
  (int32 / int is float32 in JAX); the port computes in float64, so its
  factor differs from the JAX step's by up to float32's rounding.
* Newton-Schulz, ``muon`` and ``muon_adam`` against ``nequip_tpu.train.muon``:
  1e-5 of max (the iteration runs in float32 on both sides).
* A per-step schedule and the epoch LR scale on a training module: a plain
  SGD step of ``-lr * scale * schedule(count) * g``.
* The multi-model contract (``tests/unit/train/test_lr_scheduler_and_groups.py``)
  and ``WandbWatch`` with the fake ``wandb`` of ``tests/unit/train/test_wandb_watch.py``.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nequip_tpu.train import muon as jax_muon
from nequip_tpu.train import muon_adam as jax_muon_adam
from nequip_tpu.train import zeropower_via_newtonschulz5 as jax_ns
from nequip_tpu.train.callbacks.wandb_watch import WandbWatch as JaxWandbWatch

from nequip_tpu_torch.model import NequIPGNNModel, flatten_tree, jax_params_tree
from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule, muon, muon_adam, zeropower_via_newtonschulz5
from nequip_tpu_torch.train.callbacks import WandbWatch
from nequip_tpu_torch.train.optim import Adam, OptimizerList, build_optimizer, param_groups
from nequip_tpu_torch.train.schedules import SCHEDULES, build_step_schedule

SHAPES = {"w": (6, 4), "v": (3, 7), "b": (4,), "s": ()}
TINY = dict(seed=1, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=1, l_max=1, parity=False,
            num_features=4, radial_mlp_width=8, avg_num_neighbors=18.0, tp_impl="torch")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=0, steps=5):
    rng = np.random.RandomState(seed)
    p0 = {k: rng.standard_normal(s) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s) for k, s in SHAPES.items()} for _ in range(steps)]
    return p0, grads


def _run_optax(tx, p0, grads):
    p = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(p)
    for g in grads:
        u, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, u)
    return {k: np.asarray(v) for k, v in p.items()}


def _run_port(make, p0, grads):
    ps = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = make(list(ps.values()))
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    return {k: p.detach().numpy() for k, p in ps.items()}, opt


def _assert_close(got, want, p0, rel):
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= rel * max(np.abs(want[k]).max(), 1e-300), k
        moved = want[k] - p0[k]
        assert np.abs((got[k] - p0[k]) - moved).max() <= rel * max(np.abs(moved).max(), 1e-300), k


OPTAX_CASES = {
    "adam_eps_root": ({"learning_rate": 0.01, "eps_root": 1e-6}, "adam", Adam),
    "adam_nesterov": ({"learning_rate": 0.01, "nesterov": True, "b1": 0.8}, "adam", Adam),
    "adam": ({"learning_rate": 0.01}, "adam", torch.optim.Adam),
    "adamw": ({"learning_rate": 0.01}, "adamw", torch.optim.AdamW),
    "adamw_nesterov_eps_root": ({"learning_rate": 0.02, "weight_decay": 0.1, "nesterov": True, "eps_root": 1e-7},
                                "adamw", Adam),
    "sgd": ({"learning_rate": 0.01}, "sgd", torch.optim.SGD),
    "sgd_momentum": ({"learning_rate": 0.01, "momentum": 0.9}, "sgd", torch.optim.SGD),
    "sgd_nesterov": ({"learning_rate": 0.01, "momentum": 0.9, "nesterov": True}, "sgd", torch.optim.SGD),
}


@pytest.mark.parametrize("case", sorted(OPTAX_CASES))
def test_optimizer_matches_optax(case):
    kwargs, name, cls = OPTAX_CASES[case]
    p0, grads = _problem()
    want = _run_optax(getattr(optax, name)(**kwargs), p0, grads)
    got, opt = _run_port(lambda ps: build_optimizer(param_groups({"_target_": f"optax.{name}", **kwargs}, ps)),
                         p0, grads)
    assert type(opt) is cls
    _assert_close(got, want, p0, 1e-12)


def test_optimizer_config_errors():
    """What stays refused: optax.lbfgs, a callable mask, an unknown name or
    argument, a schedule where optax takes a number, and ConFIG with an
    optimizer that reads the loss value."""
    from nequip_tpu_torch.train import ConFIGTrainModule

    ps = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="line search"):
        param_groups({"_target_": "optax.lbfgs", "learning_rate": 0.1}, ps)
    with pytest.raises(ValueError, match="callable mask"):
        param_groups({"_target_": "optax.adamw", "learning_rate": 0.1, "mask": {"_target_": "f", "_partial_": True}},
                     ps)
    with pytest.raises(ValueError, match="supported optimizers are .*optax.lion"):
        param_groups({"_target_": "optax.not_an_optimizer", "learning_rate": 0.1}, ps)
    with pytest.raises(ValueError, match="unknown arguments"):
        param_groups({"_target_": "optax.adam", "learning_rate": 0.1, "momentum": 0.9}, ps)
    with pytest.raises(ValueError, match="unknown arguments"):
        param_groups({"_target_": "optax.lion", "learning_rate": 0.1, "momentum": 0.9}, ps)
    with pytest.raises(ValueError, match="sm3 takes learning_rate as a number"):
        param_groups({"_target_": "optax.sm3", "learning_rate": {"_target_": "optax.constant_schedule", "value": 1}},
                     ps)
    for target in ("optax.polyak_sgd", "optax.contrib.reduce_on_plateau"):
        with pytest.raises(ValueError, match="ConFIG.*polyak_sgd"):
            ConFIGTrainModule(NequIPGNNModel(**TINY), loss=EnergyForceLoss(), optimizer={"_target_": target},
                              device="cpu")


SCHEDULE_ARGS = {
    "constant_schedule": {"value": 0.3},
    "linear_schedule": {"init_value": 1.0, "end_value": 0.1, "transition_steps": 7, "transition_begin": 2},
    "polynomial_schedule": {"init_value": 1.0, "end_value": 0.05, "power": 2.5, "transition_steps": 9,
                            "transition_begin": 1},
    "cosine_decay_schedule": {"init_value": 0.7, "decay_steps": 11, "alpha": 0.1, "exponent": 1.5},
    "warmup_cosine_decay_schedule": {"init_value": 0.0, "peak_value": 1.0, "warmup_steps": 3, "decay_steps": 15,
                                     "end_value": 0.01},
    "exponential_decay": {"init_value": 1.0, "transition_steps": 3, "decay_rate": 0.5, "transition_begin": 2,
                          "end_value": 0.1},
    "piecewise_constant_schedule": {"init_value": 1.0, "boundaries_and_scales": {3: 0.5, 8: 0.1}},
    "cosine_onecycle_schedule": {"transition_steps": 30, "peak_value": 0.8, "pct_start": 0.25, "div_factor": 10.0,
                                 "final_div_factor": 100.0},
    "join_schedules": {"schedules": [
        {"_target_": "optax.linear_schedule", "init_value": 0.0, "end_value": 1.0, "transition_steps": 4},
        {"_target_": "optax.exponential_decay", "init_value": 1.0, "transition_steps": 3, "decay_rate": 0.5}],
        "boundaries": [6]},
    "linear_onecycle_schedule": {"transition_steps": 33, "peak_value": 0.5},
    "piecewise_interpolate_schedule": {"interpolate_type": "cosine", "init_value": 1.0,
                                       "boundaries_and_scales": {5: 0.5, 12: 3.0, 30: 0.1}},
    "sgdr_schedule": {"cosine_kwargs": [
        {"init_value": 0.0, "peak_value": 1.0, "warmup_steps": 3, "decay_steps": 10},
        {"init_value": 0.1, "peak_value": 0.5, "warmup_steps": 2, "decay_steps": 15, "end_value": 0.05}]},
    "warmup_constant_schedule": {"init_value": 0.1, "peak_value": 0.9, "warmup_steps": 7},
    "warmup_exponential_decay_schedule": {"init_value": 0.0, "peak_value": 1.0, "warmup_steps": 5,
                                          "transition_steps": 4, "decay_rate": 0.7, "transition_begin": 3,
                                          "end_value": 0.2},
}


def optax_schedule(name: str, kwargs: dict):
    """optax's schedule of a config's arguments (``join_schedules`` builds its
    nested configs)."""
    if name == "join_schedules":
        kwargs = dict(kwargs, schedules=[optax_schedule(c["_target_"].rpartition(".")[2],
                                                        {k: v for k, v in c.items() if k != "_target_"})
                                         for c in kwargs["schedules"]])
    return getattr(optax.schedules, name)(**kwargs)


@pytest.mark.parametrize("spelling", ["optax", "optax.schedules"])
@pytest.mark.parametrize("name", sorted(SCHEDULE_ARGS))
def test_schedule_matches_optax(name, spelling):
    assert sorted(SCHEDULES) == sorted(SCHEDULE_ARGS)
    kwargs = SCHEDULE_ARGS[name]
    want = optax_schedule(name, kwargs)
    got = build_step_schedule({"_target_": f"{spelling}.{name}", **kwargs})
    for count in range(41):
        w = float(np.asarray(want(jnp.asarray(count, dtype=jnp.int64))))
        assert got(count) == pytest.approx(w, rel=1e-12, abs=1e-300), count
    if name == "exponential_decay":
        staircase = getattr(optax.schedules, name)(**kwargs, staircase=True)
        port = build_step_schedule({"_target_": f"{spelling}.{name}", **kwargs, "staircase": True})
        want = [float(staircase(jnp.asarray(c, dtype=jnp.int64))) for c in range(12)]
        assert [port(c) for c in range(12)] == pytest.approx(want, rel=1e-12)


def test_unsupported_schedule_names_the_list():
    with pytest.raises(ValueError, match="warmup_exponential_decay_schedule"):
        build_step_schedule({"_target_": "optax.not_a_schedule"})
    with pytest.raises(ValueError, match="sgdr_schedule"):
        build_step_schedule({"_target_": "torch.optim.lr_scheduler.sgdr_schedule"})


@pytest.mark.parametrize("shape", [(16, 8), (8, 16), (5, 5)])
def test_newton_schulz_matches_jax(shape):
    g = np.random.RandomState(2).standard_normal(shape)
    want = np.asarray(jax_ns(jnp.asarray(g)))
    got = zeropower_via_newtonschulz5(torch.tensor(g))
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError):
        zeropower_via_newtonschulz5(torch.ones(3))


@pytest.mark.parametrize("which", ["muon", "muon_nesterov_off", "muon_adam"])
def test_muon_matches_jax(which):
    p0, grads = _problem(seed=3)
    if which == "muon_adam":
        want = _run_optax(jax_muon_adam(muon_lr=0.05, adam_lr=0.01, momentum=0.9), p0, grads)
        got, opt = _run_port(lambda ps: muon_adam(ps, muon_lr=0.05, adam_lr=0.01, momentum=0.9), p0, grads)
        assert isinstance(opt, OptimizerList)
        kinds = [(type(o).__name__, sum(p.ndim == 2 for g in o.param_groups for p in g["params"]))
                 for o in opt.optimizers]
        assert kinds == [("Muon", 2), ("Adam", 0)]
    else:
        nesterov = which == "muon"
        want = _run_optax(jax_muon(0.05, momentum=0.9, nesterov=nesterov), p0, grads)
        got, _ = _run_port(lambda ps: muon(ps, 0.05, momentum=0.9, nesterov=nesterov), p0, grads)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-5 * np.abs(want[k]).max(), k


def _tiny_batch():
    from nequip_tpu_torch.data import DataLoader
    from nequip_tpu_torch.data.dataset import LJTestDataset
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform

    ds = LJTestDataset(num_frames=2, seed=3, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]),
                                                         NeighborListTransform(4.0)])
    return next(iter(DataLoader(ds, batch_size=2, device="cpu")))


def test_step_schedule_and_epoch_scale_scale_the_update():
    """SGD (the update is -lr * g): with a warmup-cosine schedule and an
    epoch scale of 0.5, update n is -lr * 0.5 * schedule(n) * g."""
    sched = {"_target_": "optax.warmup_cosine_decay_schedule", "init_value": 0.1, "peak_value": 1.0,
             "warmup_steps": 2, "decay_steps": 6}
    module = NequIPTrainModule(NequIPGNNModel(**TINY), loss=EnergyForceLoss(),
                               optimizer={"_target_": "optax.sgd", "learning_rate": 0.01}, lr_scheduler=sched,
                               device="cpu")
    module.set_lr_scale(0.5)
    values = build_step_schedule(sched)
    batch = _tiny_batch()
    for n in range(3):
        before = {k: p.detach().clone() for k, p in module.named_trainable()}
        module.training_step(batch)
        factor = 0.01 * 0.5 * values(n)
        for k, p in module.named_trainable():
            want = before[k] - factor * p.grad
            assert torch.allclose(p.detach(), want, rtol=0, atol=1e-14 * float(want.abs().max())), (n, k)
    assert module.update_count == 3 and module.state_dict()["update_count"] == 3
    with pytest.raises(ValueError, match="per-step schedule"):
        NequIPTrainModule(NequIPGNNModel(**TINY), loss=EnergyForceLoss(), device="cpu",
                          lr_scheduler={"scheduler": {"_target_": "nequip_tpu_torch.train.StepLR", "step_size": 1},
                                        "interval": "step"})


def test_param_groups_take_each_groups_optimizer():
    """Groups merge over the base config, first match wins, and a group may
    name another optimizer: one torch optimizer a kind."""
    module = NequIPTrainModule(NequIPGNNModel(**TINY), loss=EnergyForceLoss(), device="cpu", optimizer={
        "_target_": "optax.adam", "learning_rate": 1e-3, "param_groups": [
            {"paths": ["layer0_convnet"], "_target_": "optax.sgd", "learning_rate": 1e-2, "momentum": 0.9},
            {"paths": ["layer0_convnet", "per_atom_energy_readout"], "learning_rate": 1e-4},
        ]})
    assert isinstance(module.optimizer, OptimizerList)
    kinds = {id(p): (type(o).__name__, g["lr"]) for o in module.optimizer.optimizers for g in o.param_groups
             for p in g["params"]}
    for path, p in module.named_trainable():
        want = (("SGD", 1e-2) if path.startswith("layer0_convnet.") else
                ("Adam", 1e-4) if path.startswith("per_atom_energy_readout.") else ("Adam", 1e-3))
        assert kinds[id(p)] == want, path
    module.set_lr_scale(0.25)
    assert sorted({g["lr"] for g in module.optimizer.param_groups}) == [0.25e-4, 0.25e-3, 0.25e-2]


def test_multi_model_module_contract():
    from nequip_tpu.train import NequIPTrainModule as JaxModule

    def cfg(seed):
        return {"_target_": "nequip_tpu_torch.model.NequIPGNNModel", **TINY, "seed": seed}

    module = NequIPTrainModule(model={"m1": cfg(1), "m2": cfg(2)}, loss=EnergyForceLoss(), device="cpu",
                               optimizer={"_target_": "optax.adam", "learning_rate": 0.01})
    assert set(module.models) == {"m1", "m2"} and module.model is module.models["m1"]
    paths = {k for k, _ in module.named_trainable()}
    assert {k.split(".")[0] for k in paths} == {"m1", "m2"}
    n_params = sum(p.numel() for m in module.models.values() for p in m.parameters())
    assert sum(p.numel() for g in module.optimizer.param_groups for p in g["params"]) == n_params
    sd = module.state_dict()
    assert set(sd["params"]) == {"m1", "m2"}
    # the models keep their own seeds' weights
    w1, w2 = (flatten_tree(sd["params"][k]) for k in ("m1", "m2"))
    assert any(not np.array_equal(w1[k], w2[k]) for k in w1)
    again = NequIPTrainModule(model={"m1": cfg(1), "m2": cfg(3)}, loss=EnergyForceLoss(), device="cpu")
    again.load_state_dict(sd)
    for k, t in again.named_tensors():
        np.testing.assert_array_equal(t.detach().numpy(), flatten_tree(sd["params"])[k])
    batch = _tiny_batch()
    with pytest.raises(RuntimeError, match="sole model"):
        module.training_step(batch)
    out = module.predict_step(batch)
    assert np.isfinite(out["total_energy"].numpy()).all()
    assert module.hyperparameters()["model"] == {"m1": cfg(1), "m2": cfg(2)}
    with pytest.raises(ValueError, match="type_names"):
        NequIPTrainModule(model={"a": cfg(1), "b": {**cfg(2), "type_names": ["Ag"]}}, loss=EnergyForceLoss(),
                          device="cpu")
    # the JAX module's contract, for the record: a mapping builds several models
    assert set(JaxModule(model={"m1": {**cfg(1), "_target_": "nequip_tpu.model.NequIPGNNModel", "tp_impl": "xla"},
                                "m2": {**cfg(2), "_target_": "nequip_tpu.model.NequIPGNNModel", "tp_impl": "xla"}},
                         loss=None).models) == {"m1", "m2"}


def _fake_wandb(monkeypatch):
    logged = []
    fake = types.ModuleType("wandb")

    class FakeHistogram:
        def __init__(self, arr):
            self.size = np.asarray(arr).size

    class FakeRun:
        def log(self, logs, step=None):
            logged.append((step, logs))

    fake.Histogram = FakeHistogram
    fake.init = lambda **kw: FakeRun()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    return logged, FakeHistogram


def test_wandb_watch_matches_jax(monkeypatch):
    logged, histogram = _fake_wandb(monkeypatch)
    module = NequIPTrainModule(NequIPGNNModel(**TINY), loss=EnergyForceLoss(), device="cpu")
    state = types.SimpleNamespace(params=jax.tree.map(np.array, jax_params_tree(module.model)))
    jax_trainer = types.SimpleNamespace(state=state)
    port_cb, jax_cb = WandbWatch(log_every_epochs=1), JaxWandbWatch(log_every_epochs=1)
    port_cb.on_train_start(None, module)
    jax_cb.on_train_start(jax_trainer, None)
    with torch.no_grad():
        for p in module.model.parameters():
            p.add_(0.25)
    state.params = jax.tree.map(np.array, jax_params_tree(module.model))
    for epoch in (0, 1):
        port_cb.on_train_epoch_end(None, module, epoch, {"loss": 1.0})
        jax_cb.on_train_epoch_end(jax_trainer, None, epoch, {"loss": 1.0})
        (ps, port_logs), (js, jax_logs) = logged[-2:]
        assert ps == js == epoch and set(port_logs) == set(jax_logs)
        assert any(k.startswith("updates_norm/") and v > 0 for k, v in port_logs.items()) == (epoch == 0)
        for k, v in jax_logs.items():
            if isinstance(v, histogram):
                assert port_logs[k].size == v.size, k
            else:
                assert port_logs[k] == pytest.approx(v, rel=1e-14, abs=1e-300), k


def test_wandb_watch_is_a_noop_without_wandb(monkeypatch, caplog):
    import builtins

    real_import = builtins.__import__

    def blocked(name, *a, **k):
        if name == "wandb":
            raise ImportError("no wandb")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", blocked)
    monkeypatch.delitem(sys.modules, "wandb", raising=False)
    cb = WandbWatch()
    cb.on_train_start(None, None)
    cb.on_train_epoch_end(None, None, 0, {})
    assert "wandb not installed; WandbWatch is a no-op" in caplog.text
