"""The artifact contract is enough from outside the port's package.

``nequip_tpu_torch/tools/standalone_artifact_consumer.py`` imports only the
standard library, numpy and torch, and is written against the README's
contract.  As the JAX package's ``tests/integration/test_standalone_consumer.py``
does for its consumer, a two-rung artifact is exported with the package (a
float32 ``tp_impl="torch"`` model, on the CPU, whose programs call no
registered op) and the consumer runs in a subprocess where importing
``nequip_tpu_torch`` raises: on a frame at each rung its outputs equal
``load_compiled_model``'s on the package's padded batch bitwise.  Also:

* the consumer's padding and numpy edge layout equal ``pad_batch`` and
  ``relayout_edge_stream`` on the same frame (the contract's steps 5-6);
* a fused model's artifact compiled for the CPU names the ops its programs
  call and carries no ops library, and the consumer refuses it by naming
  the library; it refuses another torch version and a newer format;
* ``validate_artifact`` checks the ops library member and its sha256;
* the C++ binding's schema strings (``csrc/torch_ops.cpp``, read as text)
  equal the Python ops' schemas.

The ops library itself builds and runs only on the card (``chip_smoke.py``
phase 11f).
"""

import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from nequip_tpu_torch.data import _keys, batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
from nequip_tpu_torch.model import NequIPGNNModel, load_compiled_model, save_compiled_model, validate_artifact
from nequip_tpu_torch.ops.kernels import tp_scatter as K

ROOT = Path(__file__).resolve().parents[1]
CONSUMER = ROOT / "nequip_tpu_torch" / "tools" / "standalone_artifact_consumer.py"
BINDING = ROOT / "nequip_tpu_torch" / "csrc" / "torch_ops.cpp"
LADDER = ((32, 768), (64, 1536))
MODEL = dict(seed=0, model_dtype="float32", type_names=["Cu", "O"], r_max=4.0, num_layers=2, l_max=1,
             parity=False, num_features=8, avg_num_neighbors=12.0)

# the consumer runs with the port's package import-poisoned: the contract must suffice
_BLOCKER = """
import sys, runpy

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "nequip_tpu_torch" or name.startswith("nequip_tpu_torch."):
            raise ImportError(name + " is blocked: the standalone consumer must not import the package")
        return None

sys.meta_path.insert(0, _Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(n_atoms: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    box = 5.0 * (n_atoms / 16) ** (1 / 3)
    return compute_neighborlist_(from_dict({
        _keys.POSITIONS_KEY: rng.uniform(0, box, (n_atoms, 3)), _keys.CELL_KEY: np.diag([box] * 3),
        _keys.PBC_KEY: np.array([True] * 3), _keys.ATOM_TYPE_KEY: rng.randint(0, 2, n_atoms),
    }), 4.0)


def _real_inputs(frame: dict) -> dict:
    """The real (unpadded) system under the contract's field names."""
    n = frame[_keys.POSITIONS_KEY].shape[0]
    return {
        "pos": np.asarray(frame[_keys.POSITIONS_KEY], np.float64),
        "edge_index": np.asarray(frame[_keys.EDGE_INDEX_KEY], np.int64),
        "edge_cell_shift": np.asarray(frame[_keys.EDGE_CELL_SHIFT_KEY], np.float64),
        "cell": np.asarray(frame[_keys.CELL_KEY], np.float64).reshape(1, 3, 3),
        "atom_types": np.asarray(frame[_keys.ATOM_TYPE_KEY], np.int64).reshape(-1),
        "batch": np.zeros(n, np.int64),
        "num_atoms": np.full(1, n, np.int64),
    }


def _padded(frame: dict, caps: dict) -> dict:
    return to_tensors(pad_batch(batched_from_list([frame]), caps["n_nodes"], caps["n_edges"], caps["n_frames"]),
                      "cpu")


def _export(tmp_path_factory, tp_impl: str) -> str:
    model = NequIPGNNModel(tp_impl=tp_impl, **MODEL)
    frame = _frame(16, 0)
    examples = [to_tensors(pad_batch(batched_from_list([frame]), nn, ne, 2), "cpu") for nn, ne in LADDER]
    if tp_impl != "torch":
        examples = [K.relayout_edge_stream(b) for b in examples]
    path = str(tmp_path_factory.mktemp(tp_impl) / f"{tp_impl}.nequip_tpu_torch.zip")
    save_compiled_model(path, model, examples, target="ase")
    return path


@pytest.fixture(scope="module")
def torch_artifact(tmp_path_factory):
    return _export(tmp_path_factory, "torch")


@pytest.fixture(scope="module")
def fused_artifact(tmp_path_factory):
    return _export(tmp_path_factory, "fused")


def _consume(artifact, inputs, out=None, cwd=None):
    args = [sys.executable, "-c", _BLOCKER, str(CONSUMER), str(artifact), str(inputs)] + ([str(out)] if out else [])
    return subprocess.run(args, capture_output=True, text=True, timeout=300, cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))


def _load_consumer():
    spec = importlib.util.spec_from_file_location("standalone_artifact_consumer", CONSUMER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_atoms,rung", [(16, 0), (40, 1)])
def test_consumer_reproduces_the_package_bitwise(torch_artifact, tmp_path, n_atoms, rung):
    frame = _frame(n_atoms, seed=n_atoms)
    inputs, out = tmp_path / "inputs.npz", tmp_path / "out.npz"
    np.savez(inputs, **_real_inputs(frame))
    p = _consume(torch_artifact, inputs, out, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    assert f"rung {rung} " in p.stdout and "nequip_torch schemas" not in p.stdout

    compiled = load_compiled_model(torch_artifact, device="cpu")
    caps = compiled.select_capacities(n_atoms, frame[_keys.EDGE_INDEX_KEY].shape[1])
    assert caps == compiled.capacity_ladder[rung]
    want = compiled(_padded(frame, caps))
    got = dict(np.load(out))
    assert sorted(got) == sorted(compiled.output_fields)
    counts = {"total_energy": 1, "stress": 1, "virial": 1}
    for name in compiled.output_fields:
        ref = want[name][: counts.get(name, n_atoms)].numpy()
        assert got[name].dtype == ref.dtype and got[name].shape == ref.shape, name
        np.testing.assert_array_equal(got[name], ref, err_msg=name)


def test_consumer_blocks_the_package_import():
    """The import blocker itself works (the guard is real)."""
    p = subprocess.run([sys.executable, "-c", _BLOCKER.replace('runpy.run_path(sys.argv[0], run_name="__main__")',
                                                               "import nequip_tpu_torch")],
                       capture_output=True, text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode != 0 and "blocked" in p.stderr


def test_numpy_layout_equals_relayout_edge_stream(fused_artifact):
    """Steps 5-6 of the contract in numpy against the package's pad_batch and
    relayout_edge_stream on the same frame."""
    c = _load_consumer()
    with zipfile.ZipFile(fused_artifact) as zf:
        md = c.load_metadata(zf)
    frame = _frame(40, seed=40)
    caps = md["capacity_ladder"][1]
    padded = c.pad_inputs(md, caps, _real_inputs(frame))
    want = _padded(frame, caps)
    for field, value in padded.items():
        assert np.array_equal(value, want[field].numpy()), field
    order = c.edge_layout(padded, caps["n_nodes"])
    want_order = K.kernel_order(want)
    want = K.relayout_edge_stream(want, want_order)
    np.testing.assert_array_equal(order, want_order.numpy())
    fields = K.layout_fields(want[K.LAYOUT_KEY])
    for field in md["input_fields"]:
        ref = (fields[field] if field in fields else want[field]).numpy()
        assert padded[field].dtype == ref.dtype or field not in fields, field
        np.testing.assert_array_equal(padded[field], ref, err_msg=field)


def test_fused_cpu_artifact_names_its_ops_and_is_refused(fused_artifact, tmp_path):
    md = validate_artifact(fused_artifact)
    assert md["custom_ops"] == ["nequip_torch::conv_bwd", "nequip_torch::conv_fwd", "nequip_torch::scatter_rows"]
    assert "ops_library" not in md
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, **_real_inputs(_frame(16, 0)))
    p = _consume(fused_artifact, inputs)
    assert p.returncode != 0
    assert "carries no ops library" in p.stderr and "nequip_torch::conv_fwd" in p.stderr


def _rewrite(src, dst, edit_md=None, drop=(), add=()):
    with zipfile.ZipFile(src) as z_in, zipfile.ZipFile(dst, "w") as z_out:
        for name in z_in.namelist():
            data = z_in.read(name)
            if name in drop:
                continue
            if name == "metadata.json" and edit_md is not None:
                md = json.loads(data)
                edit_md(md)
                data = json.dumps(md).encode()
            z_out.writestr(name, data)
        for name, data in add:
            z_out.writestr(name, data)
    return dst


@pytest.mark.parametrize("case,message", [("version", "torch 0.0.1"), ("format", "newer than")])
def test_consumer_refuses_another_torch_or_format(torch_artifact, tmp_path, case, message):
    edit = {"version": lambda md: md.update(torch_version="0.0.1"),
            "format": lambda md: md.update(format_version=99)}[case]
    bad = _rewrite(torch_artifact, tmp_path / "bad.zip", edit)
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, **_real_inputs(_frame(16, 0)))
    p = _consume(bad, inputs)
    assert p.returncode != 0 and message in p.stderr


def test_validate_artifact_checks_the_ops_library(fused_artifact, tmp_path):
    """A library member as save_compiled_model writes it on the card (its
    bytes stand in here), then without the member, with another hash, and a
    cuda artifact calling the ops without one."""
    blob = b"\x7fELF stand-in for the ops library"
    lib = {"member": "libnequip_ops.so", "sha256": hashlib.sha256(blob).hexdigest(), "arch": "sm_90a"}
    good = _rewrite(fused_artifact, tmp_path / "good.zip", lambda md: md.update(ops_library=lib),
                    add=[("libnequip_ops.so", blob)])
    assert validate_artifact(good)["ops_library"] == lib
    cases = {
        "missing": (_rewrite(good, tmp_path / "missing.zip", drop=("libnequip_ops.so",)), "missing its ops library"),
        "hash": (_rewrite(good, tmp_path / "hash.zip",
                          lambda md: md["ops_library"].update(sha256="0" * 64)), "sha256"),
        "cuda": (_rewrite(fused_artifact, tmp_path / "cuda.zip", lambda md: md.update(platform="cuda")),
                 "carries no ops_library"),
    }
    for case, (path, message) in cases.items():
        with pytest.raises(ValueError, match=message):
            validate_artifact(path)


def _binding_schemas() -> dict:
    """The m.def strings of csrc/torch_ops.cpp, its schema macros expanded."""
    src = BINDING.read_text()
    macros = {name: "".join(re.findall(r'"([^"]*)"', body))
              for name, body in re.findall(r"#define (NEQUIP_\w+_SCHEMA)((?:.*\\\n)*.*)", src)}
    block = src[src.index("TORCH_LIBRARY(nequip_torch, m)"):]
    block = block[: block.index("\n}\n")]
    out = {}
    for body in re.findall(r"m\.def\(((?:[^;])*?)\);", block):
        text = "".join(tok[1:-1] if tok.startswith('"') else macros[tok]
                       for tok in re.findall(r'"[^"]*"|NEQUIP_\w+_SCHEMA', body))
        out[text.split("(", 1)[0]] = "nequip_torch::" + text
    return out


def test_binding_schemas_equal_the_python_ops():
    schemas = _binding_schemas()
    assert sorted(schemas) == ["conv_bwd", "conv_fwd", "scatter_rows", "tri_bwd", "tri_fwd"]
    for name, text in schemas.items():
        assert text == str(getattr(torch.ops.nequip_torch, name).default._schema), name
