"""The port's training CLI (``nequip_tpu_torch.scripts.train``) against the
JAX package's ``nequip-train``, in float64 on the CPU.

Both packages run the same file, ``tests/integration/lj_config.yaml``: the
port's copy is read and retargeted here (``nequip_tpu.`` becomes
``nequip_tpu_torch.`` in ``_target_`` strings; ``optax.adam`` stays, the
port maps it to ``torch.optim.Adam``).  The JAX run's initial parameters
are loaded into the model the port's ``build_from_config`` built, and its
EMA copy restarts from them (JAX's EMA starts from the initial
parameters).  The port's model runs ``tp_impl="fused"``: the kernels' plain
twins through the same autograd Functions as on the card.  The JAX run
reads its ``best.ckpt`` for ``val`` and ``test`` as the port's run loop
does after training.

Gradient clipping: the JAX module's global norm also counts the gradients
of its frozen leaves (fixed per-type scales and shifts, fixed Bessel
weights); the port's counts the trainable parameters only.  So the
cross-package run holds a clip that binds on neither side against the
unclipped JAX run, and a binding clip is held against a plain torch step
of ``g * min(1, c / ||g_trainable||)``.  With every leaf trainable
(``bessel_trainable`` and trainable per-type scales and shifts) both norms
run over the same leaves, and a binding clip matches the JAX run.
"""

import copy
import json
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from nequip_tpu.scripts import train as jax_train
from nequip_tpu.train.callbacks import write_xyz as jax_xyz
from nequip_tpu.utils import config as jax_config

from nequip_tpu_torch.data import DataLoader
from nequip_tpu_torch.data.dataset import LJTestDataset
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper, NeighborListTransform
from nequip_tpu_torch.model import flatten_tree, load_jax_params
from nequip_tpu_torch.scripts import train as port_train
from nequip_tpu_torch.train.callbacks import write_xyz as port_xyz
from nequip_tpu_torch.train.checkpoint import load_checkpoint
from nequip_tpu_torch.utils import config as port_config

ROOT = Path(__file__).resolve().parents[1]
LJ_CONFIG = ROOT / "tests" / "integration" / "lj_config.yaml"
STATS = "training_data_stats"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _retarget(node):
    if isinstance(node, dict):
        return {k: "nequip_tpu_torch." + v[len("nequip_tpu."):] if k == "_target_" and v.startswith("nequip_tpu.")
                else _retarget(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_retarget(v) for v in node]
    return node


def lj_config(ckpt_dir, pkg: str, overrides=None) -> dict:
    """lj_config.yaml with dotted-key overrides (targets named in the JAX
    package), retargeted to the port for ``pkg="port"``."""
    cfg = yaml.safe_load(LJ_CONFIG.read_text())
    cfg["trainer"]["ckpt_dir"] = str(ckpt_dir)
    for key, value in (overrides or {}).items():
        node = cfg
        *parents, last = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = copy.deepcopy(value)
    return _retarget(cfg) if pkg == "port" else cfg


def jax_run(ckpt_dir, overrides):
    """The JAX package's build, fit, then val and test from its best.ckpt;
    returns (initial params, metric rows, final params, final EMA params)."""
    # a statistics resolver left registered by an earlier config in this
    # process would resolve this one (the JAX CLI keeps it registered)
    jax_config._RESOLVERS.pop(STATS, None)
    dm, module, trainer, _ = jax_train.build_from_config(lj_config(ckpt_dir, "jax", overrides))
    jax_config._RESOLVERS.pop(STATS, None)
    init = flatten_tree(jax.tree.map(np.asarray, module.init_state().params))
    trainer.fit(module, dm)
    final = [flatten_tree(jax.tree.map(np.asarray, t)) for t in (trainer.state.params, trainer.state.ema_params)]
    trainer.validate(module, dm, ckpt_path="best")
    trainer.test(module, dm, ckpt_path="best")
    return init, trainer._metrics_rows, final[0], final[1]


@pytest.fixture
def jax_weights(monkeypatch):
    """Make the port's build_from_config load the given JAX parameters (and
    restart the EMA copy from them)."""

    def use(params):
        build = port_train.build_from_config

        def build_with_jax_weights(config, ckpt_path=None, device="cuda"):
            dm, module, trainer, runs = build(config, ckpt_path, device)
            load_jax_params(module.model, params)
            module.ema_model.load_state_dict(module.model.state_dict())
            return dm, module, trainer, runs

        monkeypatch.setattr(port_train, "build_from_config", build_with_jax_weights)

    return use


def _callbacks(softadapt_interval: str, softadapt_frequency: int):
    return [
        {"_target_": "nequip_tpu.train.callbacks.LossCoefficientMonitor"},
        {"_target_": "nequip_tpu.train.callbacks.SoftAdapt", "beta": 1.1, "interval": softadapt_interval,
         "frequency": softadapt_frequency},
        {"_target_": "nequip_tpu.train.callbacks.TrainingStatsMonitor"},
    ]


def _epoch_scheduler(target: str, monitor=None, **kwargs):
    return {"scheduler": {"_target_": f"nequip_tpu.train.{target}", **kwargs}, "monitor": monitor,
            "interval": "epoch", "frequency": 1}


# 3 epochs, so the scale set at the end of epoch 1 acts on epoch 2.  With
# interval "epoch" and frequency 1 SoftAdapt never changes the coefficients
# (the JAX package's `step % frequency == 1`); with interval "batch" and
# frequency 2 it changes them from step 3 on.
TRAJECTORY_CASES = {
    "steplr": (
        {"run": ["train", "val", "test"], "trainer.max_epochs": 3, "trainer.callbacks": _callbacks("epoch", 1),
         "training_module.lr_scheduler": _epoch_scheduler("StepLR", step_size=1, gamma=0.5)},
        {},
    ),
    "plateau_unbound_clip": (
        {"run": ["train", "val", "test"], "trainer.max_epochs": 3, "trainer.callbacks": _callbacks("batch", 2),
         "training_module.lr_scheduler": _epoch_scheduler("ReduceLROnPlateau", "val0_epoch/weighted_sum",
                                                          factor=0.5, patience=0, threshold=0.9)},
        {"training_module.gradient_clip_val": 1.0e6},
    ),
    "all_trainable_binding_clip": (
        {"run": ["train", "val", "test"], "trainer.max_epochs": 3, "trainer.callbacks": _callbacks("epoch", 1),
         "training_module.lr_scheduler": _epoch_scheduler("StepLR", step_size=1, gamma=0.5),
         "training_module.gradient_clip_val": 1.0e-4, "training_module.model.bessel_trainable": True,
         "training_module.model.per_type_energy_scales_trainable": True,
         "training_module.model.per_type_energy_shifts_trainable": True},
        {},
    ),
}
PORT_MODEL = {"training_module.model.tp_impl": "fused"}


def _assert_rows_match(got_rows, want_rows, rel):
    assert len(got_rows) == len(want_rows)
    for got, want in zip(got_rows, want_rows):
        assert set(got) == set(want)
        for key in sorted(set(want) - {"epoch_time"}):
            assert got[key] == pytest.approx(want[key], rel=rel, abs=0), key


def _assert_tensors_close(got: dict, want: dict, rel_to_max: float):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        scale = max(float(np.abs(w).max()), 1e-300)
        assert float(np.abs(g - w).max()) <= rel_to_max * scale, k


@pytest.mark.parametrize("case", sorted(TRAJECTORY_CASES))
def test_cli_trajectory_matches_jax(case, tmp_path, jax_weights):
    overrides, port_only = TRAJECTORY_CASES[case]
    init, jax_rows, jax_final, jax_ema = jax_run(tmp_path / "jax", overrides)
    jax_weights(init)
    trainer = port_train.run_config(lj_config(tmp_path / "port", "port", {**overrides, **port_only, **PORT_MODEL}),
                                    device="cpu")
    _assert_rows_match(trainer.metrics_rows, jax_rows, rel=1e-8)
    train_rows = trainer.metrics_rows[:3]
    assert len({r["lr_scale"] for r in train_rows}) > 1, "the LR scale should move"
    assert any(k.startswith("weights/") for k in train_rows[1]) and "ema_weights/rms" in train_rows[1]
    if case == "plateau_unbound_clip":
        assert train_rows[2]["loss_coeffs/forces_mse"] != train_rows[1]["loss_coeffs/forces_mse"]
    last = load_checkpoint(tmp_path / "port" / "last.ckpt")["state"]
    _assert_tensors_close(last["params"], jax_final, 1e-8)
    _assert_tensors_close(last["ema_params"], jax_ema, 1e-8)

    # the run loop: checkpoints and metrics.csv, val and test from best.ckpt
    # (the test row above equals the JAX test from its best.ckpt)
    for name in ("last.ckpt", "best.ckpt", "metrics.csv"):
        assert (tmp_path / "port" / name).exists(), name
    assert trainer.loaded_ckpt_path == str(tmp_path / "port" / "best.ckpt")
    assert any(k.startswith("test0_epoch/") for k in trainer.metrics_rows[-1])
    if case == "steplr":  # a second run from the same config is the same run
        again = port_train.run_config(lj_config(tmp_path / "again", "port", {**overrides, **PORT_MODEL}),
                                      device="cpu")
        _assert_rows_match(again.metrics_rows, trainer.metrics_rows, rel=0)


def test_binding_clip_scales_the_trainable_gradients(tmp_path):
    clip = 1e-5
    built = [port_train.build_from_config(lj_config(tmp_path / name, "port", extra), device="cpu")
             for name, extra in (("clip", {"training_module.gradient_clip_val": clip}), ("plain", {}))]
    (dm, module, _, _), (_, plain, _, _) = built
    batch = next(iter(dm.train_dataloader()))
    module.training_step(batch)

    plain.optimizer.zero_grad(set_to_none=True)
    loss, _, _ = plain.compute_loss(batch)
    loss.backward()
    grads = [p.grad for _, p in plain.named_trainable()]
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    assert norm > 10 * clip, "the clip must bind"
    with torch.no_grad():
        for g in grads:
            g.mul_(min(1.0, clip / norm))
    plain.optimizer.step()

    for (name, p), (_, q) in zip(module.named_trainable(), plain.named_trainable()):
        scale = float(q.grad.abs().max())
        assert float((p.grad - q.grad).abs().max()) <= 1e-12 * scale, name
        assert float((p - q).abs().max()) <= 1e-12 * float(q.abs().max()), name


RESTART_CASES = {"full_epochs": {}, "partial_sampler": {"data.train_dataloader.num_samples_per_epoch": 4}}


@pytest.mark.parametrize("case", sorted(RESTART_CASES))
def test_restart_equivalence(case, tmp_path):
    """4 epochs straight against 2 epochs and a resume to 4: the same state
    at rtol 1e-14 (the JAX package's gate), a resume mid-pass of a partial
    sampler included."""
    overrides = {**RESTART_CASES[case], "trainer.callbacks": _callbacks("batch", 2),
                 "training_module.lr_scheduler": _epoch_scheduler("StepLR", step_size=1, gamma=0.5)}

    def run(name, epochs, ckpt_path=None):
        cfg = lj_config(tmp_path / name, "port", {**overrides, "trainer.max_epochs": epochs})
        return port_train.run_config(cfg, ckpt_path=ckpt_path, device="cpu")

    straight = run("straight", 4)
    run("resume", 2)
    resumed = run("resume", 4, ckpt_path=str(tmp_path / "resume" / "last.ckpt"))
    assert straight.epoch == resumed.epoch == 4 and straight.global_step == resumed.global_step
    a, b = (load_checkpoint(tmp_path / d / "last.ckpt") for d in ("straight", "resume"))
    for key in ("params", "ema_params"):
        for name, t in a["state"][key].items():
            np.testing.assert_allclose(b["state"][key][name].numpy(), t.numpy(), rtol=1e-14, atol=1e-14, err_msg=name)
    assert a["state"]["ema_step"] == b["state"]["ema_step"]
    opt_a, opt_b = a["state"]["optimizer"]["state"], b["state"]["optimizer"]["state"]
    assert sorted(opt_a) == sorted(opt_b)
    for i in opt_a:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(opt_b[i][k].numpy(), opt_a[i][k].numpy(), rtol=1e-14, atol=1e-300)
    for key in ("lr_scale", "loss_coeffs", "loss_manager_state", "dataloader_state", "lr_scheduler_state"):
        assert b["meta"][key] == a["meta"][key], key
    soft_a, soft_b = a["meta"]["callback_states"][1], b["meta"]["callback_states"][1]
    assert soft_b["prev_losses"] == pytest.approx(soft_a["prev_losses"], rel=1e-14)
    assert len(soft_b["cached_coeffs"]) == len(soft_a["cached_coeffs"])
    for cb, ca in zip(soft_b["cached_coeffs"], soft_a["cached_coeffs"]):
        assert cb == pytest.approx(ca, rel=1e-14)
    assert a["meta"]["lr_scale"] == 0.125 and len(set(a["meta"]["loss_coeffs"])) == 2


def test_fr_through_the_config_matches_rr(tmp_path):
    def run(name, extra):
        cfg = lj_config(tmp_path / name, "port", {**PORT_MODEL, **extra})
        return port_train.run_config(cfg, device="cpu")

    rr = run("rr", {})
    fr = run("fr", {"training_module.force_grad_mode": "fr", "training_module.fr_edge_chunks": 2})
    losses = [[r["train_loss_epoch/weighted_sum"] for r in t.metrics_rows] for t in (rr, fr)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-10)
    p_rr, p_fr = (load_checkpoint(tmp_path / d / "last.ckpt")["state"]["params"] for d in ("rr", "fr"))
    for name, t in p_rr.items():
        np.testing.assert_allclose(p_fr[name].numpy(), t.numpy(), rtol=1e-8, atol=1e-10, err_msg=name)


def test_main_parses_overrides_and_resumes(tmp_path):
    cfg = lj_config(tmp_path / "ckpt", "port")
    (tmp_path / "lj_port.yaml").write_text(yaml.safe_dump(cfg))
    argv = ["-cn", "lj_port", "-cp", str(tmp_path), "--device", "cpu", "++trainer.log_every_n_steps=1"]
    port_train.main(argv + ["++trainer.max_epochs=1"])
    assert len((tmp_path / "ckpt" / "metrics.csv").read_text().splitlines()) == 2
    assert load_checkpoint(tmp_path / "ckpt" / "last.ckpt")["meta"]["epoch"] == 1
    port_train.main(argv + ["++trainer.max_epochs=2", f"++ckpt_path={tmp_path / 'ckpt' / 'last.ckpt'}"])
    lines = (tmp_path / "ckpt" / "metrics.csv").read_text().splitlines()
    header = lines[0].split(",")
    assert len(lines) == 2 and lines[1].split(",")[header.index("epoch")] == "1"
    payload = load_checkpoint(tmp_path / "ckpt" / "last.ckpt")
    assert payload["meta"]["epoch"] == 2 and payload["meta"]["global_step"] == 6
    # the checkpoint stores the resolved training module config
    model_cfg = payload["config"]["config"]["training_module"]["model"]
    assert isinstance(model_cfg["avg_num_neighbors"], float)


def test_predict_from_best_feeds_the_xyz_writer(tmp_path):
    writer = {"_target_": "nequip_tpu.train.callbacks.TestTimeXYZFileWriter", "out_file": str(tmp_path / "pred.xyz")}
    cfg = lj_config(tmp_path / "ckpt", "port", {"trainer.max_epochs": 1, "trainer.callbacks": [writer],
                                                "run": ["train", "predict"]})
    trainer = port_train.run_config(cfg, device="cpu")
    assert trainer.loaded_ckpt_path == str(tmp_path / "ckpt" / "best.ckpt")
    # no predict split: the test split (1 frame) is predicted
    assert (tmp_path / "pred.xyz").read_text().count("Properties=") == 1


@pytest.mark.parametrize("path", ["configs/minimal_lj.yaml", "configs/tutorial.yaml",
                                  "tests/integration/lj_config.yaml", "nequip_tpu_torch/configs/minimal_lj.yaml"])
def test_config_resolves_as_jax(path):
    jax_config._RESOLVERS.pop(STATS, None)
    want = jax_config.resolve(jax_config.load_config(str(ROOT / path)))
    got = port_config.resolve(port_config.load_config(str(ROOT / path)))
    assert got == want
    assert "${training_data_stats:num_neighbors_mean}" in str(got)  # kept for the statistics pass


def test_builtin_resolvers_match_jax(tmp_path):
    pkg = tmp_path / "model.nequip.zip"
    with zipfile.ZipFile(pkg, "w") as zf:
        zf.writestr("package_metadata.json", json.dumps({"type_names": "Cu H", "r_max": 5.0}))
    cfg = {
        "types": ["Cu", "H"],
        "div": "${int_div:7,2}",
        "mul": "${int_mul:3,${n}}",
        "n": 4,
        "cat": "${concat_lists:[1, 2],[3]}",
        "ident": "${list_to_identity_dict:${types}}",
        "const": "${list_to_constant_dict:${types},0.5}",
        "nn": "${big_dataset_stats:MPTrj,4.5,num_neighbors_mean}",
        "e0": "${big_dataset_stats:MPTrj,5.0,per_atom_energy_mean}",
        "tn": f"${{type_names_from_package:{pkg}}}",
        "rc": f"${{cutoff_radius_from_package:{pkg}}}",
        "text": "r=${n}",
    }
    got = port_config.resolve(cfg)
    assert got == jax_config.resolve(cfg)
    assert got["tn"] == ["Cu", "H"] and got["rc"] == 5.0 and got["mul"] == 12 and got["text"] == "r=4"


def test_module_seed_and_hyperparameters(tmp_path):
    """A training module's seed draws its weights (the JAX module's does), and
    its hyperparameters() rebuild it: the config a checkpoint stores."""
    cfg = port_config.resolve(lj_config(tmp_path, "port", {"training_module.seed": 7}))
    tm = {**cfg["training_module"], "model": {**cfg["training_module"]["model"], "avg_num_neighbors": 18.0,
                                              "per_type_energy_shifts": -0.4, "per_type_energy_scales": 0.15}}
    module = port_config.instantiate(tm, _recursive_=False, device="cpu")
    model_cfg = {k: v for k, v in tm["model"].items() if k != "_target_"}
    reference = port_config.locate(tm["model"]["_target_"])(**{**model_cfg, "seed": 7})
    hp = module.hyperparameters()
    assert hp["_target_"] == "nequip_tpu_torch.train.training_module.EMATrainModule" and hp["seed"] == 7
    assert hp["ema_decay"] == 0.99 and hp["loss"] == tm["loss"] and hp["optimizer"] == tm["optimizer"]
    rebuilt = port_config.instantiate(hp, _recursive_=False, device="cpu")
    for m in (module, rebuilt):
        for (name, a), (_, b) in zip(m.model.jax_named_tensors(), reference.jax_named_tensors()):
            assert torch.equal(a, b), name


def test_instantiate_leaves_configs_it_does_not_build():
    out = port_config.instantiate(
        {"_target_": "builtins.dict", "optimizer": {"_target_": "optax.adam", "learning_rate": 1e-3}},
        _recursive_=False,
    )
    assert out == {"optimizer": {"_target_": "optax.adam", "learning_rate": 1e-3}}


def test_xyz_writer_matches_jax(tmp_path):
    ds = LJTestDataset(num_frames=2, seed=5, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"]),
                                                         NeighborListTransform(4.0)])
    batch = next(iter(DataLoader(ds, batch_size=2, device="cpu")))
    rng = np.random.RandomState(0)
    n_nodes, n_frames = batch["pos"].shape[0], batch["frame_mask"].shape[0]
    out = dict(batch, total_energy=torch.as_tensor(rng.normal(size=(n_frames, 1))),
               forces=torch.as_tensor(rng.normal(size=(n_nodes, 3))))
    host = lambda d: {k: v.numpy() for k, v in d.items() if isinstance(v, torch.Tensor)}  # noqa: E731
    for mod, name, o, b in ((port_xyz, "port.xyz", out, batch), (jax_xyz, "jax.xyz", host(out), host(batch))):
        writer = mod.TestTimeXYZFileWriter(out_file=str(tmp_path / name))
        writer.on_eval_batch(o, b)
        writer.on_test_epoch_end(None, None, {})
    text = (tmp_path / "port.xyz").read_text()
    assert text == (tmp_path / "jax.xyz").read_text()
    assert text.count("Properties=species:S:1:pos:R:3:forces:R:3") == 2
