"""The port stands alone: importing it, running a forward pass, running its
two microbenchmark tools, building its C++ neighbour list, running two
host-mode MD steps, the device neighbour list and one block of MD with it,
one epoch of its training CLI on the CPU (its shipped minimal_lj.yaml,
which names ``optax.adam``), packaging, compiling and serving that run's
checkpoint (``nequip-torch-package``, ``nequip-torch-compile``, the
calculator's loaders), its pair style (``nequip-torch-prepare-pair-style``,
the wrapper, the ``pair_nequip`` target), its data files (extxyz, NPZ and
shard files written, read and trained from through a data module with the
bucket ladder, the named data modules, the transforms) and a model with the
ZBL prior, the model builder's options (a preset with the norm
nonlinearity, a categorical embedding, trainable leaves and remat; a
depth-2 radial MLP on the K4 route; the shipped model suite and its
assertion library), a step of ConFIG (AdamW) and of schedule-free (Muon +
Adam under a per-step cosine schedule), ``WandbWatch`` without
``wandb``, the e3nn import/export, the model repository client, the
logger, the profiling utilities and the parallel package (a one-rank gloo
``ShardedGraphEvaluator.evaluate``) load neither JAX, nor optax or flax, nor the JAX package
(the GPU machine has none of them), and import neither ``h5py`` nor ``lmdb`` until a
dataset that reads them is built."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import json, sys
import numpy as np
import nequip_tpu_torch
from nequip_tpu_torch.integrations import NequIPCalculator
from nequip_tpu_torch.model import NequIPGNNModel

model = NequIPGNNModel(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2,
                       l_max=1, parity=False, num_features=4, radial_mlp_width=8,
                       avg_num_neighbors=12.0, tp_impl="fused")
a = 3.61
pos = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
res = NequIPCalculator.from_model(model, device="cpu").calculate(
    {"pos": pos + 0.05, "cell": np.eye(3) * a, "pbc": np.ones(3, bool), "atomic_numbers": np.full(4, 29)}
)
import contextlib, io
from nequip_tpu_torch.tools import gather_microbench, kernel_microbench
with contextlib.redirect_stdout(io.StringIO()):
    kernel_microbench.main(["--device", "cpu", "--grid", "2", "--rows", "4", "--be", "8", "--reps", "1"])
    gather_microbench.main(["--device", "cpu", "--rows", "64", "--src-rows", "64", "--dim", "8", "--block-e", "16"])
import tempfile
from pathlib import Path
from nequip_tpu_torch.data import _cpp_nl
from nequip_tpu_torch.integrations import MDDriver, VelocityVerlet
with tempfile.TemporaryDirectory() as tmp:
    _cpp_nl.build(Path(tmp))
frame = {"pos": pos + 0.05, "cell": np.eye(3) * a, "pbc": np.ones(3, bool), "atom_types": np.zeros(4, int)}
md = MDDriver(model, frame, VelocityVerlet(dt_fs=1.0), integration="host", device="cpu").run(2)
from nequip_tpu_torch.ops.device_nl import device_neighbor_list
box = np.concatenate([pos + np.array([i, j, k]) * a for i in range(4) for j in range(4) for k in range(4)])
*_, overflow = device_neighbor_list(__import__("torch").as_tensor(box + 0.05), np.eye(3) * 4 * a, 4.5, (3, 3, 3),
                                    16, 64)
md_dev = MDDriver(model, {"pos": box + 0.05, "cell": np.eye(3) * 4 * a, "pbc": np.ones(3, bool),
                          "atom_types": np.zeros(len(box), int)}, VelocityVerlet(dt_fs=1.0), steps_per_block=2,
                  nl_backend="device", device="cpu").run(2)
import nequip_tpu_torch.train.callbacks, nequip_tpu_torch.utils.global_state
from nequip_tpu_torch.scripts.train import main
with tempfile.TemporaryDirectory() as tmp:
    main(["-cn", "minimal_lj", "-cp", "nequip_tpu_torch/configs", "--device", "cpu", "++trainer.max_epochs=1",
          f"++trainer.ckpt_dir={tmp}"])
    cli_ok = all(Path(tmp, f).exists() for f in ("last.ckpt", "best.ckpt", "metrics.csv"))
    from nequip_tpu_torch.scripts import compile as compile_cli, package as package_cli
    package_cli.main(["build", f"{tmp}/best.ckpt", f"{tmp}/pkg.zip", "--device", "cpu", "--no-code-snapshot"])
    compile_cli.main([f"{tmp}/pkg.zip", f"{tmp}/model.nequip_tpu_torch.zip", "--device", "cpu"])
    served = [NequIPCalculator.from_saved_model(f"{tmp}/pkg.zip", device="cpu"),
              NequIPCalculator.from_compiled_model(f"{tmp}/model.nequip_tpu_torch.zip", device="cpu")]
    deployed = [c.calculate({"pos": pos + 0.05, "cell": np.eye(3) * a, "pbc": np.ones(3, bool),
                             "atomic_numbers": np.full(4, 29)}) for c in served]
    deploy_ok = bool(np.allclose(deployed[0]["forces"], deployed[1]["forces"], rtol=0, atol=1e-12))
    from nequip_tpu_torch.integrations import NequIPPairStyleWrapper
    from nequip_tpu_torch.scripts import prepare_pair_style
    prepare_pair_style.main([f"{tmp}/pkg.zip", f"{tmp}/m.pair.pkl", "--device", "cpu"])
    pair = NequIPPairStyleWrapper.load(f"{tmp}/m.pair.pkl", device="cpu").compute(
        pos[[1, 0]] - pos[[0, 1]], np.array([0, 1]), np.array([1, 0]), np.zeros(4, int), 4)
    compile_cli.main([f"{tmp}/pkg.zip", f"{tmp}/pair.nequip_tpu_torch.zip", "--target", "pair_nequip",
                      "--device", "cpu"])
    pair_ok = bool(np.isfinite(pair["edge_forces"]).all()) and pair["edge_forces"].shape == (2, 3)
from nequip_tpu_torch.data import NequIPDataModule, transforms as T
from nequip_tpu_torch.data.datamodule import named
from nequip_tpu_torch.data.dataset import LJTestDataset, NPZDataset, ShardDataset
from nequip_tpu_torch.data.xyz import read_extxyz, write_extxyz
from nequip_tpu_torch.model import ZBLPairPotential
from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule, Trainer
with tempfile.TemporaryDirectory() as tmp:
    frames = [LJTestDataset(num_frames=3, seed=1).get_frame(i) for i in range(3)]
    write_extxyz(f"{tmp}/f.xyz", frames)
    ShardDataset.save_from_iterator(f"{tmp}/f.nqs", iter(frames))
    np.savez(f"{tmp}/f.npz", R=np.stack([f["pos"] for f in frames]), E=np.array([0.1, 0.2, 0.3]),
             z=frames[0]["atomic_numbers"])
    files_ok = len(read_extxyz(f"{tmp}/f.xyz")) == 3 and len(NPZDataset(f"{tmp}/f.npz")) == 3
    tr = [T.ChemicalSpeciesToAtomTypeMapper(["Cu"]), T.NeighborListTransform(4.0), T.AddNaNStressTransform()]
    dm = NequIPDataModule(seed=0, train_dataset=ShardDataset(f"{tmp}/f.nqs", transforms=tr),
                          train_dataloader={"batch_size": 1, "n_buckets": 2}, device="cpu")
    zbl = NequIPGNNModel(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=1,
                         parity=False, num_features=4, radial_mlp_width=8, avg_num_neighbors=12.0, tp_impl="fused",
                         pair_potential={"_target_": "nequip_tpu_torch.nn.pair_potential.ZBL", "units": "metal",
                                         "chemical_species": ["Cu"]})
    fit = Trainer(max_epochs=1, ckpt_dir=tmp, save_last=False, save_best=False)
    fit.fit(NequIPTrainModule(zbl, loss=EnergyForceLoss(), device="cpu"), dm)
    files_ok = files_ok and bool(np.isfinite(fit.metrics_rows[0]["train_loss_epoch/weighted_sum"]))
    files_ok = files_ok and len(ZBLPairPotential(seed=0, model_dtype="float64", r_max=4.0, type_names=["Cu"],
                                                 chemical_species=["Cu"], units="metal").model_config) > 0
import nequip_tpu_torch.utils.unittests
from nequip_tpu_torch.model import PresetNequIPGNNModel
from nequip_tpu_torch.nn import PartialForceOutput
from nequip_tpu_torch.utils.test_utils import assert_permutation_equivariant
from nequip_tpu_torch.data import compute_neighborlist_, from_dict
preset = PresetNequIPGNNModel(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, preset="S",
                              num_features=[4, 2], radial_mlp_width=8, type_embed_num_features=4,
                              avg_num_neighbors=12.0, tp_impl="fused", convnet_nonlinearity_type="norm",
                              categorical_graph_field_embed=[{"field": "charge", "min": 0, "max": 1,
                                                              "num_features": 2}],
                              learnable_shift=True, bessel_trainable=True, remat_conv="save_tp", remat_force=True)
depth2 = NequIPGNNModel(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=1,
                        parity=False, num_features=4, radial_mlp_width=8, radial_mlp_depth=2,
                        avg_num_neighbors=12.0, tp_impl="fused")
small = compute_neighborlist_(from_dict({"pos": pos + 0.05, "cell": np.eye(3) * a, "pbc": np.ones(3, bool),
                                         "atom_types": np.zeros(4, int), "charge": np.array([1])}), 4.0)
assert_permutation_equivariant(preset, small, capacities=(8, 256, 2))
assert_permutation_equivariant(depth2, small, capacities=(8, 256, 2))
options_ok = [m.route for m in depth2.modules() if hasattr(m, "route")] == ["fused_tp", "fused_tp"]
from nequip_tpu_torch.data import DataLoader
from nequip_tpu_torch.train import ConFIGTrainModule, ScheduleFreeTrainModule, callbacks
lj = LJTestDataset(num_frames=1, seed=1, transforms=[T.ChemicalSpeciesToAtomTypeMapper(["Cu"]), T.NeighborListTransform(4.0)])
lj_batch = next(iter(DataLoader(lj, batch_size=1, device="cpu")))
train_modules_ok = True
for cls, kw in ((ConFIGTrainModule, dict(optimizer={"_target_": "optax.adamw", "learning_rate": 1e-3})),
                (ScheduleFreeTrainModule, dict(optimizer={"_target_": "nequip_tpu_torch.train.muon_adam"},
                                               lr_scheduler={"_target_": "optax.schedules.cosine_decay_schedule",
                                                             "init_value": 1.0, "decay_steps": 4}))):
    m = cls(NequIPGNNModel(seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=1, l_max=1,
                           parity=False, num_features=4, radial_mlp_width=8, avg_num_neighbors=12.0, tp_impl="fused"),
            loss=EnergyForceLoss(), device="cpu", **kw)
    logs = m.training_step(lj_batch)
    train_modules_ok = train_modules_ok and bool(np.isfinite(float(logs["train_loss_step/weighted_sum"])))
callbacks.WandbWatch().on_train_start(None, None)
from nequip_tpu_torch import utils
from nequip_tpu_torch.model.e3nn_import import export_to_e3nn_npz, import_e3nn_npz
from nequip_tpu_torch.utils import model_repository
weights = export_to_e3nn_npz(model)
import_e3nn_npz(weights, model)
utilities_ok = (sorted(weights) == sorted(export_to_e3nn_npz(model)) and model_repository.NequIPNetAPIClient(
    "http://127.0.0.1:1").base_url == "http://127.0.0.1:1" and utils.flops_per_step(
    __import__("torch").mm, __import__("torch").ones(4, 4), __import__("torch").ones(4, 4)) == 128
    and set(utils.get_latest_global_state()) == {"allow_tf32", "x64"})
utils.RankedLogger().info("isolation")
import nequip_tpu_torch.parallel
from nequip_tpu_torch.parallel import ShardedGraphEvaluator, init_distributed
from nequip_tpu_torch.parallel.distributed import destroy_distributed
with tempfile.TemporaryDirectory() as tmp:
    init_distributed(backend="gloo", device="cpu", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    sharded = ShardedGraphEvaluator(model, device="cpu").evaluate({"pos": box + 0.05, "cell": np.eye(3) * 4 * a,
                                                                   "pbc": np.ones(3, bool),
                                                                   "atom_types": np.zeros(len(box), int)})
    destroy_distributed()
parallel_ok = bool(np.isfinite(sharded[0]) and np.isfinite(sharded[1]).all() and sharded[1].shape == (len(box), 3))
mods = sorted(sys.modules)
print(json.dumps({
    "finite": bool(np.isfinite(res["forces"]).all() and np.isfinite(res["energy"])
                   and np.isfinite(md["positions"]).all() and np.isfinite(md["forces"]).all()
                   and np.isfinite(md_dev["forces"]).all() and not bool(overflow)),
    "cli": cli_ok,
    "deploy": deploy_ok,
    "pair": pair_ok,
    "jax": [m for m in mods if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")],
    "nequip_tpu": [m for m in mods if m == "nequip_tpu" or m.startswith("nequip_tpu.")],
    "optax_flax": [m for m in mods if m.split(".")[0] in ("optax", "flax")],
    "files": files_ok,
    "lazy": [m for m in mods if m.split(".")[0] in ("h5py", "lmdb")],
    "options": options_ok,
    "train_modules": train_modules_ok,
    "wandb": [m for m in sys.modules if m.split(".")[0] == "wandb"],
    "utilities": utilities_ok,
    "parallel": parallel_ok,
}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"finite": True, "cli": True, "deploy": True, "pair": True, "jax": [], "nequip_tpu": [],
                   "optax_flax": [], "files": True, "lazy": [], "options": True, "train_modules": True,
                   "wandb": [], "utilities": True, "parallel": True}
