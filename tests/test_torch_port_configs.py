"""The port's copies of ``configs/tutorial.yaml`` and ``configs/lj_accuracy.yaml``
(``nequip_tpu_torch/configs/``) through the port's training CLI against
the JAX files through the JAX package's, in float64 on the CPU.

Both configs carry EMA, the ZBL prior, a per-edge-type cutoff,
``EnergyForceStressLoss`` and dataset statistics; the tutorial adds
SoftAdapt, lj_accuracy ``ReduceLROnPlateau``.  Each runs cut down by the
same overrides on both sides: 8 frames (6 train, 1 val, 1 test), 2
epochs, float64 and 4 features.  The port's copy must equal the JAX file
but for its ``_target_`` strings.  The JAX run's initial parameters are
loaded into the model the port built (its EMA copy restarts from them),
the port's model runs ``tp_impl="fused_tp"`` (the trilinear kernels' plain
twins after the configs' depth-2 radial MLP, which K1 does not take), and
the JAX run reads its ``best.ckpt`` for val and test as the port's run
loop does (``ROADMAP.md`` Queue 3).  Every metric row matches at rel 1e-8.

The JAX tutorial run's ``best.ckpt``, packaged by the JAX
``nequip-package``, is a ZBL model: it loads in the port and reproduces
its stored outputs (E rel 1e-10, F 1e-8).  The port's run's ``best.ckpt``
packaged by ``nequip-torch-package`` serves as the checkpoint does.
"""

import copy
import pickle
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from nequip_tpu.scripts import package as jax_package
from nequip_tpu.scripts import train as jax_train
from nequip_tpu.utils import config as jax_config

from nequip_tpu_torch.data import _keys, to_tensors
from nequip_tpu_torch.model import ModelFromCheckpoint, ModelFromPackage, flatten_tree, load_jax_params
from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream
from nequip_tpu_torch.scripts import package as port_package
from nequip_tpu_torch.scripts import train as port_train
from nequip_tpu_torch.utils.config import retarget

ROOT = Path(__file__).resolve().parents[1]
STATS = "training_data_stats"
CUT = {
    "data.split_dataset.dataset.num_frames": 8,
    "data.split_dataset.train": 6,
    "data.split_dataset.val": 1,
    "data.split_dataset.test": 1,
    "trainer.max_epochs": 2,
    "training_module.model.model_dtype": "float64",
    "num_features": 4,
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(path: Path, ckpt_dir: Path, extra=None) -> dict:
    cfg = yaml.safe_load(path.read_text())
    for key, value in {**CUT, "trainer.ckpt_dir": str(ckpt_dir), **(extra or {})}.items():
        node = cfg
        *parents, last = key.split(".")
        for p in parents:
            node = node[p]
        node[last] = copy.deepcopy(value)
    return cfg


def _jax_run(name: str, ckpt_dir: Path):
    """The JAX package's build and fit, then val and test from its best.ckpt;
    returns (initial params, metric rows)."""
    jax_config._RESOLVERS.pop(STATS, None)  # left registered by an earlier JAX build
    dm, module, trainer, _ = jax_train.build_from_config(_config(ROOT / "configs" / f"{name}.yaml", ckpt_dir))
    jax_config._RESOLVERS.pop(STATS, None)
    init = flatten_tree(jax.tree.map(np.asarray, module.init_state().params))
    trainer.fit(module, dm)
    trainer.validate(module, dm, ckpt_path="best")
    trainer.test(module, dm, ckpt_path="best")
    return init, trainer._metrics_rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs of both configs (from the JAX initial weights)."""
    tmp = tmp_path_factory.mktemp("configs")
    out = {}
    build = port_train.build_from_config
    try:
        for name in ("tutorial", "lj_accuracy"):
            init, jax_rows = _jax_run(name, tmp / name / "jax")

            def build_with_jax_weights(config, ckpt_path=None, device="cuda", init=init):
                dm, module, trainer, stages = build(config, ckpt_path, device)
                load_jax_params(module.model, init)
                module.ema_model.load_state_dict(module.model.state_dict())
                return dm, module, trainer, stages

            port_train.build_from_config = build_with_jax_weights
            cfg = _config(ROOT / "nequip_tpu_torch" / "configs" / f"{name}.yaml", tmp / name / "port",
                          {"training_module.model.tp_impl": "fused_tp"})
            trainer = port_train.run_config(cfg, device="cpu")
            out[name] = (jax_rows, trainer)
    finally:
        port_train.build_from_config = build
    return tmp, out


@pytest.mark.parametrize("name", ["tutorial", "lj_accuracy"])
def test_port_config_is_the_jax_config(name):
    port = yaml.safe_load((ROOT / "nequip_tpu_torch" / "configs" / f"{name}.yaml").read_text())
    assert port == retarget(yaml.safe_load((ROOT / "configs" / f"{name}.yaml").read_text()))
    model = port["training_module"]["model"]
    assert model["pair_potential"]["_target_"] == "nequip_tpu_torch.nn.pair_potential.ZBL"
    assert model["per_edge_type_cutoff"] and port["training_module"]["_target_"].endswith("EMATrainModule")


@pytest.mark.parametrize("name", ["tutorial", "lj_accuracy"])
def test_config_trajectory_matches_jax(runs, name):
    _, out = runs
    jax_rows, trainer = out[name]
    rows = trainer.metrics_rows
    assert len(rows) == len(jax_rows) == 4  # 2 epochs, val, test
    for got, want in zip(rows, jax_rows):
        assert set(got) == set(want)
        for key in sorted(set(want) - {"epoch_time"}):
            assert got[key] == pytest.approx(want[key], rel=1e-8, abs=0), key
    assert "train_loss_epoch/stress_mse" in rows[0] and "test0_epoch/stress_mae" in rows[-1]
    if name == "lj_accuracy":
        assert "lr_scale" in rows[0]


def test_jax_package_of_a_zbl_model_loads_in_the_port(runs):
    tmp, _ = runs
    pkg = str(tmp / "tutorial_jax.zip")
    jax_package.main(["build", str(tmp / "tutorial" / "jax" / "best.ckpt"), pkg, "--no-code-snapshot"])
    model = ModelFromPackage(pkg)
    assert model.model_config["pair_potential"]["_target_"] == "nequip_tpu_torch.nn.pair_potential.ZBL"
    with zipfile.ZipFile(pkg) as zf:
        example = pickle.loads(zf.read("example_data.pkl"))
        want = pickle.loads(zf.read("example_outputs.pkl"))
    batch = to_tensors(example, "cpu")
    out = model(relayout_edge_stream(batch) if model.uses_fused_kernels else batch)
    np.testing.assert_allclose(out[_keys.TOTAL_ENERGY_KEY].detach().numpy(), want[_keys.TOTAL_ENERGY_KEY], rtol=1e-10)
    np.testing.assert_allclose(out[_keys.FORCE_KEY].detach().numpy(), want[_keys.FORCE_KEY], rtol=0, atol=1e-8)


def test_port_package_of_the_tutorial_serves_as_its_checkpoint(runs):
    tmp, _ = runs
    ckpt, pkg = str(tmp / "tutorial" / "port" / "best.ckpt"), str(tmp / "tutorial_port.zip")
    port_package.main(["build", ckpt, pkg, "--device", "cpu", "--no-code-snapshot"])
    packaged, checkpointed = ModelFromPackage(pkg), ModelFromCheckpoint(ckpt)
    assert packaged.model_config == checkpointed.model_config
    assert packaged.model_config["pair_potential"]["_target_"] == "nequip_tpu_torch.nn.pair_potential.ZBL"
    with zipfile.ZipFile(pkg) as zf:
        batch = to_tensors(pickle.loads(zf.read("example_data.pkl")), "cpu")
    batch = relayout_edge_stream(batch) if packaged.uses_fused_kernels else batch
    a, b = packaged(batch), checkpointed(batch)
    for k in (_keys.TOTAL_ENERGY_KEY, _keys.FORCE_KEY, _keys.STRESS_KEY):
        assert torch.equal(a[k], b[k]), k
