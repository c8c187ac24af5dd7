"""The port's deployment layer against the JAX package's, in float64 on the
CPU: the ``@model_builder`` config, checkpoints, packages (either
package's), the modifiers, the registered ops and ``nequip-torch-compile``.

One module fixture trains ``tests/integration/lj_config.yaml`` for one
epoch with each package's training CLI (the port's run retargeted, with
``tp_impl="fused"``: the kernels' plain twins) and packages the JAX
checkpoint with the JAX ``nequip-package``.  The port's exported programs
hold the registered ops, whose CPU kernels are the plain twins.
Tolerances: E rel 1e-10 and F 1e-8 against a JAX package's stored
outputs; compiled against eager 1e-12; the port's compiled artifact
against the JAX one on the same padded batch 1e-10.
"""

import collections
import copy
import json
import operator
import pickle
import re
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from nequip_tpu.data import to_device as jax_to_device
from nequip_tpu.model import NequIPGNNModel as JaxNequIPGNNModel
from nequip_tpu.model import ModelFromCheckpoint as JaxModelFromCheckpoint
from nequip_tpu.model import modify as jax_modify
from nequip_tpu.model.inference_models import load_compiled_model as jax_load_compiled_model
from nequip_tpu.scripts import compile as jax_compile
from nequip_tpu.scripts import package as jax_package
from nequip_tpu.scripts import train as jax_train
from nequip_tpu.utils import config as jax_config

from nequip_tpu_torch.data import _keys, batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
from nequip_tpu_torch.data.dataset import LJTestDataset
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
from nequip_tpu_torch.integrations import NequIPCalculator
from nequip_tpu_torch.model import (
    ModelFromCheckpoint,
    ModelFromPackage,
    NequIPGNNModel,
    flatten_tree,
    jax_params_tree,
    load_compiled_model,
    load_jax_params,
    load_saved_model,
    modify,
    validate_artifact,
)
from nequip_tpu_torch.model.inference_models import rung_file
from nequip_tpu_torch.ops.kernels import tp_scatter as K
from nequip_tpu_torch.scripts import compile as port_compile
from nequip_tpu_torch.scripts import package as port_package
from nequip_tpu_torch.scripts import train as port_train
from nequip_tpu_torch.train.checkpoint import load_checkpoint
from nequip_tpu_torch.utils import model_cache, model_repository
from nequip_tpu_torch.utils.config import instantiate, resolve, retarget
from nequip_tpu_torch.utils.versions import get_current_code_versions

ROOT = Path(__file__).resolve().parents[1]
LJ_CONFIG = ROOT / "tests" / "integration" / "lj_config.yaml"
STATS = "training_data_stats"
FLAGSHIP = dict(type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2, parity=False, num_features=32,
                avg_num_neighbors=18.0, per_type_energy_shifts={"Cu": -3.5}, per_type_energy_scales={"Cu": 0.5})
SMALL = dict(type_names=["Cu", "H"], r_max=4.0, num_layers=2, l_max=1, num_features=[8, 4], radial_mlp_width=16,
             avg_num_neighbors={"Cu": 12.0, "H": 8.0}, per_type_energy_shifts={"Cu": -3.5, "H": -1.0})
OUTPUTS = (_keys.TOTAL_ENERGY_KEY, _keys.FORCE_KEY, _keys.STRESS_KEY)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One epoch of lj_config.yaml through each package's training CLI, and
    the JAX checkpoint packaged by the JAX nequip-package."""
    tmp = tmp_path_factory.mktemp("deploy")
    cfg = yaml.safe_load(LJ_CONFIG.read_text())
    cfg["trainer"]["max_epochs"] = 1
    jax_cfg = copy.deepcopy(cfg)
    jax_cfg["trainer"]["ckpt_dir"] = str(tmp / "jax")
    # a statistics resolver left registered by an earlier config would resolve this one
    jax_config._RESOLVERS.pop(STATS, None)
    jax_train.run_config(jax_cfg)
    jax_config._RESOLVERS.pop(STATS, None)
    port_cfg = retarget(cfg)
    port_cfg["trainer"]["ckpt_dir"] = str(tmp / "port")
    port_cfg["training_module"]["model"]["tp_impl"] = "fused"
    port_train.run_config(port_cfg, device="cpu")
    jax_pkg = str(tmp / "jax_pkg.zip")
    jax_package.main(["build", str(tmp / "jax" / "last.ckpt"), jax_pkg, "--no-code-snapshot"])
    return {"tmp": tmp, "jax_ckpt": str(tmp / "jax" / "last.ckpt"), "port_ckpt": str(tmp / "port" / "last.ckpt"),
            "jax_pkg": jax_pkg}


@pytest.fixture(scope="module")
def port_pkg(runs):
    pkg = str(runs["tmp"] / "port_pkg.zip")
    port_package.main(["build", runs["port_ckpt"], pkg, "--device", "cpu"])
    return pkg


def _tensors(model):
    return {k: t.detach().clone() for k, t in model.jax_named_tensors()}


def _assert_same_tensors(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def _padded(model, batch):
    """A numpy padded batch as the port's model takes it."""
    b = to_tensors(batch, "cpu")
    return K.relayout_edge_stream(b) if model.uses_fused_kernels else b


def _fcc_frame(reps: int) -> dict:
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(reps) for j in range(reps) for k in range(reps)])
    pos = pos + np.random.RandomState(7).normal(0, 0.03, pos.shape)
    return {_keys.POSITIONS_KEY: pos, _keys.CELL_KEY: np.diag([reps * a] * 3), _keys.PBC_KEY: np.array([True] * 3),
            _keys.ATOMIC_NUMBERS_KEY: np.full(len(pos), 29)}


# --- the model_config repair --------------------------------------------------
@pytest.mark.parametrize("cfg", [SMALL, FLAGSHIP], ids=["small", "flagship"])
def test_model_config_rebuilds_the_model(cfg):
    """The builder records the JAX builder's config (targets mapped), and
    instantiating it rebuilds the same tensors, names, shapes and values."""
    model = NequIPGNNModel(seed=3, model_dtype="float64", tp_impl="fused", **cfg)
    jax_model = JaxNequIPGNNModel(seed=3, model_dtype="float64", tp_impl="pallas_fused", **cfg)
    assert model.model_config["_target_"] == "nequip_tpu_torch.model.nequip_models.NequIPGNNModel"
    assert set(model.model_config) == set(jax_model.model_config)
    assert retarget(jax_model.model_config) == json.loads(json.dumps(model.model_config))
    rebuilt = instantiate(json.loads(json.dumps(model.model_config)), _recursive_=False)
    _assert_same_tensors(_tensors(rebuilt), _tensors(model))
    assert rebuilt.uses_fused_kernels and rebuilt.model_config == model.model_config
    jax_shapes = {k: np.shape(v) for k, v in flatten_tree(jax.tree.map(np.asarray, jax_model.init_params())).items()}
    assert {k: tuple(t.shape) for k, t in model.jax_named_tensors()} == jax_shapes


def test_model_builder_requires_the_contract():
    with pytest.raises(ValueError, match="seed"):
        NequIPGNNModel(model_dtype="float64", **SMALL)


# --- checkpoints and packages -----------------------------------------------
def test_model_from_checkpoint(runs):
    payload = load_checkpoint(runs["port_ckpt"])
    model = ModelFromCheckpoint(runs["port_ckpt"])
    ema = payload["state"]["ema_params"]
    _assert_same_tensors(_tensors(model), {k: ema[k] for k in _tensors(model)})
    raw = ModelFromCheckpoint(runs["port_ckpt"], use_ema=False)
    assert all(torch.equal(t, payload["state"]["params"][k]) for k, t in raw.jax_named_tensors())
    assert model.metadata["type_names"] == "Cu" and float(model.metadata["r_max"]) == 4.0
    assert model.model_config["tp_impl"] == "fused"


def test_jax_package_loads_and_reproduces_its_outputs(runs):
    """A JAX-written archive: targets retargeted, params.pkl loaded, and the
    port's E/F on its example batch against its stored outputs."""
    model = ModelFromPackage(runs["jax_pkg"])
    with zipfile.ZipFile(runs["jax_pkg"]) as zf:
        example = pickle.loads(zf.read("example_data.pkl"))
        want = pickle.loads(zf.read("example_outputs.pkl"))
    out = model(_padded(model, example))
    e, e_ref = out[_keys.TOTAL_ENERGY_KEY].detach().numpy(), want[_keys.TOTAL_ENERGY_KEY]
    np.testing.assert_allclose(e, e_ref, rtol=1e-10, atol=0)
    np.testing.assert_allclose(out[_keys.FORCE_KEY].detach().numpy(), want[_keys.FORCE_KEY], rtol=0, atol=1e-8)


def test_params_pkl_is_the_jax_tree(runs, tmp_path):
    """The port's params.pkl (update of the JAX archive) equals, leaf for
    leaf, the JAX tree of the same model, and jax_params_tree inverts
    load_jax_params."""
    out = str(tmp_path / "updated.zip")
    port_package.main(["update", runs["jax_pkg"], out, "--device", "cpu"])
    with zipfile.ZipFile(runs["jax_pkg"]) as a, zipfile.ZipFile(out) as b:
        want, got = (flatten_tree(pickle.loads(z.read("params.pkl"))) for z in (a, b))
        meta = json.loads(b.read("package_metadata.json"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert meta["updated_from"] and meta["nequip_tpu_torch_version"]
    got = flatten_tree(jax_params_tree(load_jax_params(ModelFromPackage(out), want)))
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_package_roundtrip(runs, port_pkg, tmp_path, capsys):
    """Twin of the JAX test_package_roundtrip: build, info, list, reload,
    the package resolvers, update with its self-check, diff."""
    port_package.main(["info", port_pkg])
    assert json.loads(capsys.readouterr().out)["model_config"]["tp_impl"] == "fused"
    port_package.main(["list", port_pkg])
    listed = capsys.readouterr().out
    for member in ("package_metadata.json", "model_config.json", "params.pkl", "example_data.pkl",
                   "example_outputs.pkl", "code_snapshot.zip"):
        assert member in listed
    m1, m2 = ModelFromCheckpoint(runs["port_ckpt"]), ModelFromPackage(port_pkg)
    _assert_same_tensors(_tensors(m2), _tensors(m1))
    assert m1.metadata == m2.metadata
    assert resolve("${type_names_from_package:" + port_pkg + "}") == ["Cu"]
    assert resolve("${cutoff_radius_from_package:" + port_pkg + "}") == 4.0
    pkg2 = str(tmp_path / "updated.zip")
    port_package.main(["update", port_pkg, pkg2, "--device", "cpu"])
    _assert_same_tensors(_tensors(ModelFromPackage(pkg2)), _tensors(m1))
    port_package.main(["diff", port_pkg, pkg2])
    out = capsys.readouterr().out
    assert "params: max abs diff 0.000e+00" in out and "updated_from" in out


def test_package_modify(port_pkg, tmp_path):
    """modify writes the persistent modifier into the archive: its shift
    replaces the old one (32 atoms x the change)."""
    out = str(tmp_path / "shifted.zip")
    port_package.main(["modify", port_pkg, out, "--modifiers", "modify_PerTypeScaleShift:{shifts: {Cu: 10.0}}"])
    m0, m1 = ModelFromPackage(port_pkg), ModelFromPackage(out)
    with zipfile.ZipFile(port_pkg) as zf:
        batch = pickle.loads(zf.read("example_data.pkl"))
    e0 = m0(_padded(m0, batch))[_keys.TOTAL_ENERGY_KEY].detach().numpy()
    e1 = m1(_padded(m1, batch))[_keys.TOTAL_ENERGY_KEY].detach().numpy()
    old = float(m0.model.func.per_type_energy_scale_shift.shifts.reshape(-1)[0])
    n_atoms = batch[_keys.NUM_NODES_KEY][batch[_keys.FRAME_MASK_KEY]]
    np.testing.assert_allclose((e1 - e0)[: len(n_atoms), 0], n_atoms * (10.0 - old), rtol=1e-9)
    assert json.loads(zipfile.ZipFile(out).read("model_config.json"))["per_type_energy_shifts"] == {"Cu": 10.0}


def test_package_durability(port_pkg, tmp_path):
    """Twin of the JAX test_package_durability: the archive interns the
    source tree (CUDA sources, no build directory), unknown format versions
    are refused, and builder-schema drift names the snapshot."""
    out_dir = tmp_path / "code"
    port_package.main(["extract-code", port_pkg, str(out_dir)])
    src = out_dir / "nequip_tpu_torch" / "model" / "nequip_models.py"
    assert "NequIPGNNModel" in src.read_text()
    assert (out_dir / "nequip_tpu_torch" / "csrc" / "conv_fwd.cu").exists()
    assert not (out_dir / "nequip_tpu_torch" / "_build").exists()

    def mutate(name, fn):
        path = str(tmp_path / name)
        with zipfile.ZipFile(port_pkg) as src_zf, zipfile.ZipFile(path, "w") as dst:
            for zi in src_zf.infolist():
                data = src_zf.read(zi.filename)
                dst.writestr(zi.filename, fn(zi.filename, data))
        return path

    def fmt99(name, data):
        if name != "package_metadata.json":
            return data
        return json.dumps({**json.loads(data), "package_format_version": 99})

    def drift(name, data):
        if name != "model_config.json":
            return data
        return json.dumps({**json.loads(data), "an_argument_from_the_future": 1})

    with pytest.raises(RuntimeError, match="format version 99"):
        ModelFromPackage(mutate("fmt.zip", fmt99))
    with pytest.raises(RuntimeError, match="extract-code"):
        ModelFromPackage(mutate("drift.zip", drift))


def test_model_cache_resolves_cached_ids(port_pkg, tmp_path, monkeypatch):
    monkeypatch.setenv(model_cache.CACHE_ENV, str(tmp_path))
    # a miss fetches from the repository: point it at a closed local port, never the network
    monkeypatch.setenv(model_repository.REPOSITORY_URL_ENV, "http://127.0.0.1:1")
    path = Path(model_cache.model_id_to_path("nequip.net:group/lj:v1"))
    assert path.parent == tmp_path and path.name == "group__lj__v1.zip"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        load_saved_model("nequip.net:group/lj:v1")
    path.write_bytes(Path(port_pkg).read_bytes())
    _assert_same_tensors(_tensors(load_saved_model("nequip.net:group/lj:v1")), _tensors(ModelFromPackage(port_pkg)))
    assert "torch" in get_current_code_versions()


# --- modifiers ---------------------------------------------------------------
def test_modify_per_type_scale_shift_matches_jax(runs):
    """The port's modifier against the JAX one on the same weights (twin of
    test_modify_per_type_scale_shift)."""
    jax_model, params = JaxModelFromCheckpoint(runs["jax_ckpt"])
    model = ModelFromPackage(runs["jax_pkg"])
    ds = LJTestDataset(num_frames=1, seed=99, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"])])
    batch = pad_batch(batched_from_list([compute_neighborlist_(ds[0], 4.0)]), 128, 1024, 2)
    spec = [{"modifier": "modify_PerTypeScaleShift", "shifts": {"Cu": 10.0}, "scales": 2.0}]
    _, jax_params = jax_modify(jax_model, params, copy.deepcopy(spec))
    want = np.asarray(jax.jit(jax_model)(jax_params, jax_to_device(batch))[_keys.TOTAL_ENERGY_KEY])
    got = modify(model, spec)(_padded(model, batch))[_keys.TOTAL_ENERGY_KEY].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    with pytest.raises(ValueError, match="unknown type names"):
        modify(model, [{"modifier": "modify_PerTypeScaleShift", "shifts": {"Zn": 1.0}}])


def test_impl_and_dtype_modifiers(runs):
    """enable/disable_TPUFusedTPScatter switch the conv (uses_fused_kernels
    follows, the outputs stay), modify_model_dtype rebuilds with the weights
    carried, and the bf16 mode (the twin of JAX's
    test_bf16_fast_mode_modifier) keeps float32 parameters, gives forces
    within 2% of max|F|, and goes back to float32 bitwise."""
    model = ModelFromPackage(runs["jax_pkg"]).requires_grad_(False)
    frame = ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(_fcc_frame(2)))
    batch = pad_batch(batched_from_list([compute_neighborlist_(frame, 4.0)]), 64, 1280, 2)
    ref = model(_padded(model, batch))
    assert not model.uses_fused_kernels
    fused = modify(model, [{"modifier": "enable_TPUFusedTPScatter"}])
    assert fused.uses_fused_kernels
    got = fused(_padded(fused, batch))
    for k in OUTPUTS:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-12, atol=1e-12)
    assert not modify(fused, [{"modifier": "disable_TPUFusedTPScatter"}]).uses_fused_kernels
    f32 = modify(model, [{"modifier": "modify_model_dtype", "model_dtype": "float32"}])
    assert f32.metadata["model_dtype"] == "float32"
    back = modify(f32, [{"modifier": "modify_model_dtype", "model_dtype": "float64"}])
    err = float((back(_padded(back, batch))[_keys.FORCE_KEY] - ref[_keys.FORCE_KEY]).detach().abs().max())
    assert err <= 1e-5 * float(ref[_keys.FORCE_KEY].abs().max())  # the weights went through float32
    b16 = modify(f32, [{"modifier": "enable_bf16_fast_mode"}])
    assert b16.metadata["model_dtype"] == "bfloat16"
    assert {p.dtype for p in b16.parameters()} == {torch.float32}
    f_ref = ref[_keys.FORCE_KEY].detach()
    f16 = b16(_padded(b16, batch))[_keys.FORCE_KEY].detach()
    assert f16.dtype == f_ref.dtype
    assert float((f16 - f_ref).abs().max()) < 0.02 * float(f_ref.abs().max())  # JAX's gate
    again = modify(b16, [{"modifier": "modify_model_dtype", "model_dtype": "float32"}])
    want = f32(_padded(f32, batch))
    got = again(_padded(again, batch))
    for k in OUTPUTS:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(KeyError, match="unknown modifier"):
        modify(model, [{"modifier": "no_such_modifier"}])


# --- the registered ops ----------------------------------------------------------
def _conv_problem(seed=0):
    model = NequIPGNNModel(seed=seed, model_dtype="float64", tp_impl="fused", **SMALL)
    block = model.model.func.layer1_convnet.conv
    plan = block.tp_scatter.plan
    frame = compute_neighborlist_(from_dict({**_fcc_frame(2), _keys.ATOM_TYPE_KEY: np.arange(32) % 2}), 4.0)
    batch = K.relayout_edge_stream(to_tensors(pad_batch(batched_from_list([frame]), 48, 1024, 2), "cpu"))
    rng = np.random.RandomState(seed)
    E = batch[_keys.EDGE_INDEX_KEY].shape[1]
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape))  # noqa: E731
    x, sh, emb = t(48, plan.dim_in), t(E, plan.sh_dim), t(E, block.edge_mlp.w0.shape[0])
    tables = list(plan.device_tables(x.device, x.dtype).values())
    layout = K.layout_fields(batch[K.LAYOUT_KEY])
    return block, plan, x, sh, emb, batch, layout, tables


def test_table_tp_matches_the_tensor_product():
    """The registered ops' CPU kernels compute the TP from K1's tables."""
    block, plan, x, sh, emb, *_ = _conv_problem()
    xe = x[torch.randint(0, 48, (sh.shape[0],))]
    w = block.edge_mlp(emb)
    got = K._table_tp(plan.device_tables(x.device, x.dtype), xe, sh, w)
    torch.testing.assert_close(got, plan.tp(xe, sh, w), rtol=0, atol=1e-13)


@pytest.mark.parametrize("op", ["conv_fwd", "conv_bwd", "scatter_rows"])
def test_registered_op_checks(op):
    """torch.library.opcheck: schema, fake shapes, autograd registration and
    the op in a traced program, on the CPU kernels."""
    block, plan, x, sh, emb, batch, layout, tables = _conv_problem()
    w1, w2 = (w.detach() for w in block.edge_mlp.weights())
    a0, a1 = block.edge_mlp.alphas
    edge_src, dst_ptr, src_perm, src_ptr = layout.values()
    g = torch.as_tensor(np.random.RandomState(1).standard_normal((48, plan.mid_dim)))
    args = {
        "conv_fwd": (x.detach().requires_grad_(True), sh, emb, w1, w2, *layout.values(), *tables, a0, a1),
        "conv_bwd": (x, sh, emb, w1, w2, g, edge_src, dst_ptr, *tables, a0, a1),
        "scatter_rows": (sh, src_perm, src_ptr),
    }[op]
    torch.library.opcheck(getattr(torch.ops.nequip_torch, op).default, args)


def test_registered_conv_matches_the_autograd_function():
    """The serving op (frozen weights) and FusedConv (training) give the same
    messages and input gradients; the op raises rather than drop weight
    gradients."""
    block, plan, x, sh, emb, batch, layout, tables = _conv_problem()
    a0, a1 = block.edge_mlp.alphas
    lay = batch[K.LAYOUT_KEY]
    ws = [w.detach() for w in block.edge_mlp.weights()]
    ins = [t.clone().requires_grad_(True) for t in (x, sh, emb)]
    out = K.fused_tp_scatter_mlp(plan, *ins, *ws, a0, a1, lay)
    grads = torch.autograd.grad(out.square().sum(), ins)
    ins2 = [t.clone().requires_grad_(True) for t in (x, sh, emb)]
    out2 = K.FusedConv.apply(*ins2, *[w.clone().requires_grad_(True) for w in ws], plan, a0, a1, lay)
    grads2 = torch.autograd.grad(out2.square().sum(), ins2)
    torch.testing.assert_close(out, out2, rtol=0, atol=1e-12)
    for a, b in zip(grads, grads2):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-11)
    w_grad = [w.clone().requires_grad_(True) for w in ws]
    op_out = torch.ops.nequip_torch.conv_fwd(x, sh, emb, *w_grad, *layout.values(), *tables, a0, a1)
    with pytest.raises(RuntimeError, match="no weight gradients"):
        torch.autograd.grad(op_out.sum(), w_grad)


# --- nequip-torch-compile -------------------------------------------------------
@pytest.fixture(scope="module")
def compiled(runs):
    """The port's artifact of the JAX archive (its weights, the fused
    kernels' ops) and the JAX nequip-compile artifact of the JAX
    checkpoint, at the same example batch's capacities."""
    port_art = str(runs["tmp"] / "port.nequip_tpu_torch.zip")
    port_compile.main([runs["jax_pkg"], port_art, "--device", "cpu", "--modifiers", "enable_TPUFusedTPScatter"])
    jax_art = str(runs["tmp"] / "jax.nequip_tpu.zip")
    jax_compile.main([runs["jax_ckpt"], jax_art, "--target", "ase", "--no-check"])
    return port_art, jax_art


def test_compiled_matches_eager_and_jax(runs, compiled):
    port_art, jax_art = compiled
    md = validate_artifact(port_art)
    assert md["mode"] == "torchexport" and md["platform"] == "cpu" and md["model_dtype"] == "float64"
    program = load_compiled_model(port_art, device="cpu")
    assert program.uses_fused_kernels and program.input_fields[-4:] == list(K.LAYOUT_FIELDS)
    eager = modify(ModelFromPackage(runs["jax_pkg"]), [{"modifier": "enable_TPUFusedTPScatter"}])
    eager.requires_grad_(False)
    with zipfile.ZipFile(runs["jax_pkg"]) as zf:
        example = pickle.loads(zf.read("example_data.pkl"))
    jax_program = jax_load_compiled_model(jax_art)
    assert jax_program.capacities == md["capacities"]
    # a frame other than the one traced, padded to the same rung
    ds = LJTestDataset(num_frames=1, seed=77, transforms=[ChemicalSpeciesToAtomTypeMapper(["Cu"])])
    caps = md["capacities"]
    other = pad_batch(batched_from_list([compute_neighborlist_(ds[0], 4.0)]), caps["n_nodes"], caps["n_edges"],
                      caps["n_frames"])
    for batch in (example, other):
        got = program(_padded(eager, batch))
        want = eager(_padded(eager, batch))
        jax_out = jax_program({k: np.asarray(batch[k]) for k in jax_program.input_fields})
        for k in OUTPUTS:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-12)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(jax_out[k]), rtol=0, atol=1e-10, err_msg=k)


def test_exported_graph_holds_the_registered_ops(compiled):
    """The program calls K1, K2 (inference) and K3 as the registered ops, one
    K1 and K2 a layer and K3 where the layer's input depends on positions;
    every call is an aten or nequip_torch op: no Python call (ctypes), and
    no training kernel."""
    with zipfile.ZipFile(compiled[0]) as zf:
        program = torch.export.load(__import__("io").BytesIO(zf.read(rung_file(0))))
    calls = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert all(t is operator.getitem or (isinstance(t, torch._ops.OpOverload) and t.namespace in ("aten", "nequip_torch"))
               for t in calls), {str(t) for t in calls}
    ours = collections.Counter(str(t) for t in calls if isinstance(t, torch._ops.OpOverload)
                               and t.namespace == "nequip_torch")
    assert ours == {"nequip_torch.conv_fwd.default": 2, "nequip_torch.conv_bwd.default": 2,
                    "nequip_torch.scatter_rows.default": 1}


def test_capacity_ladder(runs, tmp_path):
    """Twin of test_capacity_ladder_export: three rungs, a small frame on
    rung 0, a larger one walks up the ladder, both as the eager calculator;
    a frame beyond the top rung is refused."""
    art = str(tmp_path / "ladder.nequip_tpu_torch.zip")
    port_compile.main([runs["port_ckpt"], art, "--device", "cpu", "--capacity-ladder", "3", "--num-nodes", "64",
                       "--num-edges", "1280"])
    calc = NequIPCalculator.from_compiled_model(art, chemical_symbols=["Cu"], device="cpu")
    ladder = calc.predictor.capacity_ladder
    assert [(c["n_nodes"], c["n_edges"]) for c in ladder] == [(64, 1280), (128, 2048), (256, 3072)]
    eager = NequIPCalculator.from_saved_model(runs["port_ckpt"], chemical_symbols=["Cu"], device="cpu")
    for reps, rung in ((2, 0), (3, 1)):
        frame = _fcc_frame(reps)
        n = len(frame[_keys.POSITIONS_KEY])
        e = compute_neighborlist_(from_dict(frame), 4.0)[_keys.EDGE_INDEX_KEY].shape[1]
        assert calc.predictor.select_capacities(n, e) == ladder[rung]
        got, want = calc.calculate(frame), eager.calculate(frame)
        assert got["forces"].shape == (n, 3) and got["stress"].shape == (3, 3)
        np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-12)
        np.testing.assert_allclose(got["forces"], want["forces"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["stress"], want["stress"], rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="largest capacity rung"):
        calc.calculate(_fcc_frame(4))


def test_entry_points_need_the_card_and_name_what_is_missing(runs, compiled, monkeypatch, tmp_path):
    """The loaders and the CLIs default to cuda and raise without a card
    (monkeypatched away where a test machine has one), the pair-style
    target's compile too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NequIPCalculator.from_compiled_model(compiled[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NequIPCalculator.from_saved_model(runs["port_ckpt"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_compile.main([runs["port_ckpt"], str(tmp_path / "x.zip")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_package.main(["build", runs["port_ckpt"], str(tmp_path / "p.zip")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_compile.main([runs["port_ckpt"], str(tmp_path / "y.zip"), "--target", "pair_nequip"])
    with pytest.raises(ValueError, match="run on 'cpu'"):
        load_compiled_model(compiled[0], device="meta")
