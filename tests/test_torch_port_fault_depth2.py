"""A depth-2 radial MLP under ``tp_impl="fused"`` (JAX ``pallas_fused``).

K1 computes only the depth-1, bias-free silu radial MLP.  JAX runs any
other MLP in XLA and its TP-scatter kernel after it
(``nequip_tpu/nn/interaction_block.py``, ``use_fully_fused``); the port now
does the same: such a layer takes the K4 route (``route == "fused_tp"``:
the MLP in PyTorch, K4, backward K5 and K3), fixed when the model is built.
Before, ``set_tp_impl`` raised, so a JAX package or config of such a model
neither loaded nor built in the port.

A JAX ``NequIPGNNModel(radial_mlp_depth=2, tp_impl="pallas_fused")`` (2
layers, l_max 1, its Pallas kernels in interpret mode) is written by the
JAX ``nequip-package``; the port loads it through ``ModelFromPackage`` and
reproduces its stored outputs and the JAX model's E, F and stress on a
32-atom fcc frame, serving and training (``TriConv``: the layout's
real-edge count is on the host) alike.  ``nequip-torch-compile`` of the
package gives a program whose graph calls K4, K5 (inference) and K3 as the
registered ops ``nequip_torch::{tri_fwd, tri_bwd, scatter_rows}`` (their
plain CPU kernels here) and no K1, and which reproduces the JAX outputs.
Tolerances: E rel 1e-10, F and stress 1e-8 (float64).
"""

import collections
import io
import pickle
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from nequip_tpu.data import batched_from_list as j_batched
from nequip_tpu.data import compute_neighborlist_ as j_nl
from nequip_tpu.data import from_dict as j_from_dict
from nequip_tpu.data import pad_batch as j_pad
from nequip_tpu.data import to_device
from nequip_tpu.model import NequIPGNNModel as JModel
from nequip_tpu.model import saved_models as jax_saved_models
from nequip_tpu.scripts import package as jax_package

from nequip_tpu_torch.data import to_tensors
from nequip_tpu_torch.model import ModelFromPackage
from nequip_tpu_torch.model.inference_models import load_compiled_model, rung_file
from nequip_tpu_torch.nn.interaction_block import InteractionBlock
from nequip_tpu_torch.ops.kernels.tp_scatter import relayout_edge_stream
from nequip_tpu_torch.scripts import compile as port_compile
from nequip_tpu_torch.scripts import train as port_train
from nequip_tpu_torch.utils.config import retarget

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(seed=2, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=1, parity=False,
           num_features=4, radial_mlp_width=8, radial_mlp_depth=2, avg_num_neighbors=12.0,
           per_type_energy_shifts={"Cu": -3.5})
OUTPUTS = ("total_energy", "forces", "stress")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(2) for j in range(2) for k in range(2)])
    frame = j_nl(j_from_dict({"pos": pos + np.random.RandomState(1).normal(0, 0.08, pos.shape),
                              "cell": np.eye(3) * 2 * a, "pbc": np.ones(3, bool),
                              "atom_types": np.zeros(len(pos), int)}), 4.0, backend="kdtree")
    # the JAX kernels take a node capacity that is a multiple of 128
    batch = j_pad(j_batched([frame]), 128, ((frame["edge_index"].shape[1] + 255) // 256) * 256, 2)
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_package_of_depth2(tmp_path_factory, monkeypatch_module):
    """The JAX model's package, written by the JAX ``nequip-package build``
    (its checkpoint loader stood in for by the built model), and the JAX
    outputs on the example batch."""
    model = JModel(tp_impl="pallas_fused", **CFG)
    params = model.init_params()
    batch = _batch()
    monkeypatch_module.setattr(jax_saved_models, "load_saved_model", lambda path, use_ema=True: (model, params))
    monkeypatch_module.setattr(jax_saved_models, "data_dict_from_checkpoint", lambda path: batch)
    path = str(tmp_path_factory.mktemp("depth2") / "pkg.zip")
    jax_package.main(["build", "unused.ckpt", path, "--no-code-snapshot"])
    out = jax.jit(model)(params, to_device(batch))
    return path, batch, {k: np.asarray(out[k]) for k in OUTPUTS}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("serving", [True, False], ids=["serving", "training"])
def test_jax_depth2_package_loads_and_matches(jax_package_of_depth2, serving):
    path, batch, want = jax_package_of_depth2
    model = ModelFromPackage(path).requires_grad_(not serving)
    blocks = [m for m in model.modules() if isinstance(m, InteractionBlock)]
    assert len(blocks) == 2 and all(b.tp_scatter.impl == "fused" and b.route == "fused_tp" for b in blocks)
    out = model(relayout_edge_stream(to_tensors(batch)))
    assert float(out["total_energy"][0, 0]) == pytest.approx(float(want["total_energy"][0, 0]), rel=1e-10)
    for k in ("forces", "stress"):
        np.testing.assert_allclose(out[k].detach().numpy(), want[k], rtol=0, atol=1e-8, err_msg=k)
    with zipfile.ZipFile(path) as zf:
        stored = pickle.loads(zf.read("example_outputs.pkl"))
    np.testing.assert_allclose(out["forces"].detach().numpy(), stored["forces"], rtol=0, atol=1e-8)


def test_compiled_depth2_package_calls_k4_k5_k3(jax_package_of_depth2, tmp_path):
    """``nequip-torch-compile`` of the JAX package (with its self-check):
    the program calls K4 and K5 (inference) once a layer and K3 where the
    layer's input depends on positions, no K1 or K2, and matches JAX."""
    path, batch, want = jax_package_of_depth2
    art = str(tmp_path / "depth2.nequip_tpu_torch.zip")
    n_edges = batch["edge_index"].shape[1]
    port_compile.main([path, art, "--device", "cpu", "--num-nodes", "128", "--num-edges", str(n_edges)])
    with zipfile.ZipFile(art) as zf:
        program = torch.export.load(io.BytesIO(zf.read(rung_file(0))))
    ours = collections.Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function"
                               and isinstance(n.target, torch._ops.OpOverload) and n.target.namespace == "nequip_torch")
    assert ours == {"nequip_torch.tri_fwd.default": 2, "nequip_torch.tri_bwd.default": 2,
                    "nequip_torch.scatter_rows.default": 1}
    out = load_compiled_model(art, device="cpu")(to_tensors(batch))
    assert float(out["total_energy"][0, 0]) == pytest.approx(float(want["total_energy"][0, 0]), rel=1e-10)
    for k in ("forces", "stress"):
        np.testing.assert_allclose(out[k].numpy(), want[k], rtol=0, atol=1e-8, err_msg=k)


def test_depth1_keeps_k1_and_set_tp_impl_follows_the_rule():
    """The depth-1 silu MLP keeps K1; switching implementation re-decides."""
    from nequip_tpu_torch.model import NequIPGNNModel

    model = NequIPGNNModel(tp_impl="fused", **dict(CFG, radial_mlp_depth=1))
    blocks = [m for m in model.modules() if isinstance(m, InteractionBlock)]
    assert {b.route for b in blocks} == {"fused"}
    for impl in ("torch", "fused_tp", "fused"):
        for b in blocks:
            b.set_tp_impl(impl)
        assert {b.route for b in blocks} == {impl}


def test_tutorial_config_builds_with_pallas_fused():
    """``configs/tutorial.yaml`` (a depth-2 radial MLP) with
    ``++training_module.model.tp_impl=pallas_fused``, retargeted, builds in
    the port and takes the K4 route in every layer."""
    cfg = yaml.safe_load((ROOT / "configs" / "tutorial.yaml").read_text())
    cfg["training_module"]["model"]["tp_impl"] = "pallas_fused"
    cfg["data"]["split_dataset"]["dataset"]["num_frames"] = 4
    cfg["data"]["split_dataset"].update(train=2, val=1, test=1)
    cfg["num_features"] = 4
    _, module, _, _ = port_train.build_from_config(retarget(cfg), device="cpu")
    blocks = [m for m in module.model.modules() if isinstance(m, InteractionBlock)]
    assert blocks and all(b.tp_scatter.impl == "fused" and b.route == "fused_tp" for b in blocks)
