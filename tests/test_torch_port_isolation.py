"""The port stands alone: importing it, running a forward pass, running its
two microbenchmark tools, building its C++ neighbour list, running two
host-mode MD steps, the device neighbour list and one block of MD with it,
one epoch of its training CLI on the CPU (its shipped minimal_lj.yaml,
which names ``optax.adam``), packaging, compiling and serving that run's
checkpoint (``nequip-torch-package``, ``nequip-torch-compile``, the
calculator's loaders), and its pair style (``nequip-torch-prepare-pair-style``,
the wrapper, the ``pair_nequip`` target) load neither JAX, nor optax or
flax, nor the JAX package (the GPU machine has none of them)."""

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
                   "optax_flax": []}
