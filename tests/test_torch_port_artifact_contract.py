"""The port's artifact contract (README, "The port's artifact contract"):
``validate_artifact`` against the cases of the JAX package's
``tests/unit/model/test_artifact_contract.py``, on a two-rung
``torch.export`` artifact of a float32 model with the fused kernels' ops
(their CPU kernels here)."""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

from nequip_tpu_torch.data import _keys, compute_neighborlist_, from_dict, pad_batch, to_tensors
from nequip_tpu_torch.model import NequIPGNNModel, save_compiled_model, validate_artifact
from nequip_tpu_torch.ops.kernels.tp_scatter import LAYOUT_FIELDS, relayout_edge_stream


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    model = NequIPGNNModel(seed=0, model_dtype="float32", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=1,
                           parity=False, num_features=8, avg_num_neighbors=12.0, tp_impl="fused")
    rng = np.random.RandomState(0)
    frame = compute_neighborlist_(from_dict({
        _keys.POSITIONS_KEY: rng.uniform(0, 5.0, (16, 3)),
        _keys.CELL_KEY: np.diag([5.0] * 3),
        _keys.PBC_KEY: np.array([True] * 3),
        _keys.ATOM_TYPE_KEY: np.zeros(16, dtype=int),
    }), 4.0)
    examples = [relayout_edge_stream(to_tensors(pad_batch(frame, nn, ne, 2), "cpu")) for nn, ne in ((32, 768), (64, 1536))]
    path = str(tmp_path_factory.mktemp("artifact") / "m.nequip_tpu_torch.zip")
    save_compiled_model(path, model, examples, target="ase")
    torch.set_num_threads(n)
    return path


def _mutate(src, dst, fn):
    """Copy the zip, applying fn(name, bytes) -> bytes-or-None (drop)."""
    with zipfile.ZipFile(src) as z_in, zipfile.ZipFile(dst, "w") as z_out:
        for zi in z_in.infolist():
            data = fn(zi.filename, z_in.read(zi.filename))
            if data is not None:
                z_out.writestr(zi.filename, data)


def _metadata(edit):
    def fn(name, data):
        if name != "metadata.json":
            return data
        md = json.loads(data)
        edit(md)
        return json.dumps(md)

    return fn


def _lie_about_nodes(md):
    for caps in md["capacity_ladder"]:
        caps["n_nodes"] += 128
    md["capacities"] = md["capacity_ladder"][0]


def test_valid_artifact_passes(artifact):
    md = validate_artifact(artifact)
    assert md["target"] == "ase" and md["mode"] == "torchexport" and md["platform"] == "cpu"
    assert len(md["capacity_ladder"]) == 2
    assert md["capacities"] == md["capacity_ladder"][0]
    assert md["input_fields"][-4:] == list(LAYOUT_FIELDS)
    with zipfile.ZipFile(artifact) as zf:
        assert {"exported.pt2", "exported_1.pt2", "model_config.json", "params.pkl"} <= set(zf.namelist())
        torch.export.load(io.BytesIO(zf.read("exported.pt2")))


# the JAX contract's six violations, each with the message that must name it
VIOLATIONS = {
    "missing_member": (lambda n, b: None if n == "params.pkl" else b, "params.pkl"),
    "future_format_version": (_metadata(lambda md: md.update(format_version=99)), "format_version 99"),
    "metadata_key_types": (_metadata(lambda md: md.update(capacities="lots")), "capacities"),
    "ladder_order": (_metadata(lambda md: md.update(capacity_ladder=md["capacity_ladder"][::-1])),
                     "ascending|capacity_ladder"),
    "missing_rung_file": (lambda n, b: None if n == "exported_1.pt2" else b, "exported_1.pt2"),
    "capacity_shape_mismatch": (_metadata(_lie_about_nodes), "leading dim"),
}


@pytest.mark.parametrize("case", sorted(VIOLATIONS))
def test_violation_rejected(artifact, tmp_path, case):
    fn, message = VIOLATIONS[case]
    bad = str(tmp_path / f"{case}.zip")
    _mutate(artifact, bad, fn)
    with pytest.raises(ValueError, match=message):
        validate_artifact(bad)
