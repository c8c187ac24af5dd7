"""The port stands alone: importing it and running a forward pass loads
neither JAX nor the JAX package (the GPU machine has neither)."""

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
mods = sorted(sys.modules)
print(json.dumps({
    "finite": bool(np.isfinite(res["forces"]).all() and np.isfinite(res["energy"])),
    "jax": [m for m in mods if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")],
    "nequip_tpu": [m for m in mods if m == "nequip_tpu" or m.startswith("nequip_tpu.")],
}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"finite": True, "jax": [], "nequip_tpu": []}
