"""Compiled inference artifacts: save, load and validate.

Port of ``nequip_tpu/model/inference_models.py``.  The model, weights
frozen, is traced with its force and stress backward into one program per
capacity rung and saved with ``torch.export``; a JSON sidecar carries the
JAX package's metadata schema, and the eager fallback (model config and
parameter tree) rides along.

Artifact layout (``*.nequip_tpu_torch.zip``):
    metadata.json            format version, target, mode ("torchexport" or
                             "eager"), ordered input/output fields, the
                             capacity ladder, platform ("cuda" or "cpu": the
                             device the program runs on), torch version, and
                             the model's metadata (r_max, type_names,
                             model_dtype, ...)
    exported.pt2             rung 0's ``torch.export.save``d ExportedProgram
    exported_{i}.pt2         rung i's (i >= 1); none in "eager" mode
    model_config.json, params.pkl   the eager fallback (params.pkl is the
                             JAX parameter tree, ``jax_params_tree``)

How the forces get into the program: ``make_fx`` traces the model's
forward on fake tensors, and with it the ``torch.autograd.grad`` of
``ForceStressOutput`` (its backward ops, the registered ops' backward K2
and K3 among them), into one aten graph; ``torch.export`` then exports
that graph.  The weights are frozen, so no training kernel is reached.

What stays out of the program: the neighbour list and the edge stream's
re-layout, which need values of the data on the host (the real-edge count,
a sort).  A model that runs the CUDA kernels takes the layout's four
tensors as inputs (``LAYOUT_FIELDS``: ``src_perm`` padded to the rung's
edge capacity); inside, the kernels read the real-edge count from
``dst_ptr[N]`` on the device.

The ``pair_nequip`` target (an MD engine's pair style) takes edge vectors
instead of positions, shifts and cell, and returns the total and per-atom
energies and the edge forces (``ForceStressOutput``'s edge branch).  Its
example batches carry the vectors (``with_edge_vector_inputs``).  Called on
a batch without the layout, ``CompiledModel`` puts the stream into kernel
order itself and returns the edge forces in the batch's own edge order.
"""

from __future__ import annotations

import io
import json
import pickle
import zipfile
from typing import Dict, List, Optional

import torch

from ..data import _keys
from ..ops.kernels.tp_scatter import (
    LAYOUT_FIELDS,
    LAYOUT_KEY,
    kernel_order,
    layout_fields,
    layout_from_fields,
    relayout_edge_stream,
    to_caller_order,
)
from ..utils.device import resolve_device
from .jax_params import jax_params_tree

FORMAT_VERSION = 1
MODES = ("torchexport", "eager")

# which fields each target's program consumes and produces
# (parity: the JAX package's presets, plus the edge layout's tensors)
_GRAPH_INPUTS = [
    _keys.EDGE_INDEX_KEY, _keys.ATOM_TYPE_KEY, _keys.BATCH_KEY, _keys.NUM_NODES_KEY, _keys.NODE_MASK_KEY,
    _keys.EDGE_MASK_KEY, _keys.FRAME_MASK_KEY, *LAYOUT_FIELDS,
]
_POSITION_INPUTS = [_keys.POSITIONS_KEY, _keys.EDGE_CELL_SHIFT_KEY, _keys.CELL_KEY] + _GRAPH_INPUTS
_ENERGY_OUTPUTS = [
    _keys.TOTAL_ENERGY_KEY, _keys.PER_ATOM_ENERGY_KEY, _keys.FORCE_KEY, _keys.STRESS_KEY, _keys.VIRIAL_KEY,
]
TARGET_INPUT_FIELDS = {
    "ase": _POSITION_INPUTS,
    "batch": _POSITION_INPUTS,
    "pair_nequip": [_keys.EDGE_VECTORS_KEY] + _GRAPH_INPUTS,
}
TARGET_OUTPUT_FIELDS = {
    "ase": _ENERGY_OUTPUTS,
    "batch": _ENERGY_OUTPUTS,
    "pair_nequip": [_keys.TOTAL_ENERGY_KEY, _keys.PER_ATOM_ENERGY_KEY, _keys.EDGE_FORCE_KEY],
}


def rung_file(i: int) -> str:
    return "exported.pt2" if i == 0 else f"exported_{i}.pt2"


def _fields(batch: dict) -> Dict[str, torch.Tensor]:
    """The batch's tensors by field name, the edge layout's among them."""
    out = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
    if LAYOUT_KEY in batch:
        out.update(layout_fields(batch[LAYOUT_KEY]))
    return out


def with_edge_vector_inputs(batch: dict) -> dict:
    """A padded batch (tensors) with its edge vectors, the ``pair_nequip``
    target's input, computed from positions, shifts and cell (before the
    re-layout, which then permutes them with the other edge fields)."""
    from ..nn.graph_utils import with_edge_vectors

    out = dict(batch)
    out[_keys.EDGE_VECTORS_KEY] = with_edge_vectors(batch, with_lengths=False)[_keys.EDGE_VECTORS_KEY]
    return out


def _caps_of(fields: Dict[str, torch.Tensor]) -> Dict[str, int]:
    return {
        "n_nodes": int(fields[_keys.ATOM_TYPE_KEY].shape[0]),
        "n_edges": int(fields[_keys.EDGE_INDEX_KEY].shape[1]),
        "n_frames": int(fields[_keys.NUM_NODES_KEY].shape[0]),
    }


def _flat_program(model, input_fields: List[str], output_fields: List[str]):
    def flat(*tensors):
        data = dict(zip(input_fields, tensors))
        if LAYOUT_FIELDS[0] in data:
            data[LAYOUT_KEY] = layout_from_fields(data)
        out = model(data)
        return tuple(out[k] for k in output_fields)

    return flat


def export_program(model, input_fields: List[str], output_fields: List[str], tensors) -> torch.export.ExportedProgram:
    """The model's outputs as one exported program of ``tensors`` (in
    ``input_fields`` order): ``make_fx`` on fake tensors records the forward
    and the force/stress backward, ``torch.export`` exports that graph."""
    from torch.fx.experimental.proxy_tensor import make_fx

    flat = _flat_program(model, input_fields, output_fields)
    # the weights and the plans' tables are real tensors: they become the program's constants
    graph = make_fx(flat, tracing_mode="fake", _allow_non_fake_inputs=True)(*tensors)
    program = torch.export.export(graph, tuple(tensors))
    program.example_inputs = None  # a padded batch is tens of MiB; the rung's shapes are in the metadata
    return program


def save_compiled_model(out_path: str, model, example_batch, target: str = "ase", mode: str = "torchexport") -> dict:
    """Export the model's ``target`` outputs on padded batches on the
    model's device (one batch, or a list of batches of ascending capacities:
    a capacity ladder, one program per rung).  The weights are frozen in
    place.  A batch of a model that runs the kernels carries its edge
    layout (``relayout_edge_stream``).  Returns the metadata."""
    if target not in TARGET_INPUT_FIELDS:
        raise ValueError(f"unknown target {target!r}; options: {sorted(TARGET_INPUT_FIELDS)}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {MODES}")
    model.requires_grad_(False)
    batches = [_fields(b) for b in (example_batch if isinstance(example_batch, (list, tuple)) else [example_batch])]
    input_fields = [k for k in TARGET_INPUT_FIELDS[target] if k in batches[0]]
    if target == "pair_nequip" and _keys.EDGE_VECTORS_KEY not in input_fields:
        raise ValueError("target 'pair_nequip' takes edge vectors: give batches with_edge_vector_inputs()")
    ladder = [_caps_of(b) for b in batches]
    if ladder != sorted(ladder, key=lambda c: (c["n_nodes"], c["n_edges"])):
        raise ValueError("capacity ladder rungs must be ascending")
    probe = model({k: batches[0][k] for k in input_fields} | _layout_of(batches[0]))
    output_fields = [k for k in TARGET_OUTPUT_FIELDS[target] if k in probe]
    device = batches[0][_keys.POSITIONS_KEY].device

    metadata = {
        "format_version": FORMAT_VERSION,
        "target": target,
        "mode": mode,
        "input_fields": input_fields,
        "output_fields": output_fields,
        "capacities": ladder[0],
        "capacity_ladder": ladder,
        "platform": device.type,
        "torch_version": torch.__version__,
        **{k: str(v) for k, v in model.metadata.items()},
    }
    programs = []
    if mode == "torchexport":
        for b in batches:
            buf = io.BytesIO()
            torch.export.save(export_program(model, input_fields, output_fields, [b[k] for k in input_fields]), buf)
            programs.append(buf.getvalue())
    with zipfile.ZipFile(out_path, "w") as zf:
        zf.writestr("metadata.json", json.dumps(metadata, indent=2))
        for i, blob in enumerate(programs):
            zf.writestr(rung_file(i), blob)
        zf.writestr("model_config.json", json.dumps(getattr(model, "model_config", {}) or {}))
        zf.writestr("params.pkl", pickle.dumps(jax_params_tree(model)))
    return metadata


def _layout_of(fields: Dict[str, torch.Tensor]) -> dict:
    return {LAYOUT_KEY: layout_from_fields(fields)} if LAYOUT_FIELDS[0] in fields else {}


class CompiledModel:
    """A loaded artifact, callable on a padded batch on its device (a dict
    of tensors; with the edge layout where the programs take it).

    ``select_capacities`` returns the smallest rung that fits a system;
    ``__call__`` runs the rung whose capacities the batch was padded to.
    A "torchexport" artifact runs its programs only: one that cannot load,
    build or launch its kernels raises, and never falls back to the eager
    model.  Loading needs the ``nequip_torch`` ops registered (importing
    ``nequip_tpu_torch`` does so)."""

    def __init__(self, path: str, device="cuda"):
        self.path = path
        self.device = resolve_device(device)
        self._rungs = []  # [(caps, program)]
        self._model = None
        with zipfile.ZipFile(path) as zf:
            self.metadata = json.loads(zf.read("metadata.json"))
            if self.metadata["mode"] == "torchexport":
                if self.metadata["platform"] != self.device.type:
                    raise ValueError(f"{path}: the programs run on {self.metadata['platform']!r}, not on "
                                     f"{self.device}; compile the model for this device")
                for i, caps in enumerate(self.capacity_ladder):
                    program = torch.export.load(io.BytesIO(zf.read(rung_file(i))))
                    self._rungs.append((caps, program.module()))
            else:
                from ..utils.config import instantiate
                from .jax_params import load_jax_params

                cfg = json.loads(zf.read("model_config.json"))
                model = instantiate(cfg, _recursive_=False)
                self._model = load_jax_params(model, pickle.loads(zf.read("params.pkl")))
                self._model.to(self.device).requires_grad_(False)

    @property
    def input_fields(self) -> List[str]:
        return self.metadata["input_fields"]

    @property
    def output_fields(self) -> List[str]:
        return self.metadata["output_fields"]

    @property
    def uses_fused_kernels(self) -> bool:
        """Whether the programs take the edge layout (the calculator then
        puts the edge stream into kernel order)."""
        return LAYOUT_FIELDS[0] in self.input_fields

    @property
    def capacity_ladder(self) -> List[Dict[str, int]]:
        return self.metadata.get("capacity_ladder", [self.metadata["capacities"]])

    @property
    def capacities(self) -> Dict[str, int]:
        """The largest capacities the artifact takes (the top rung)."""
        return self.capacity_ladder[-1]

    def select_capacities(self, n_nodes: int, n_edges: int) -> Optional[Dict[str, int]]:
        """The smallest rung that fits (None if even the top one cannot)."""
        for caps in self.capacity_ladder:
            if n_nodes <= caps["n_nodes"] and n_edges <= caps["n_edges"]:
                return caps
        return None

    def __call__(self, data: dict) -> Dict[str, torch.Tensor]:
        order = None
        if self.uses_fused_kernels and LAYOUT_KEY not in data and LAYOUT_FIELDS[0] not in data:
            order = kernel_order(data)
            data = relayout_edge_stream(data, order)
        out = self._run(_fields(data))
        if order is not None and _keys.EDGE_FORCE_KEY in out:
            out[_keys.EDGE_FORCE_KEY] = to_caller_order(out[_keys.EDGE_FORCE_KEY], order)
        return out

    def _run(self, fields: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self._model is not None:
            out = self._model({k: fields[k] for k in self.input_fields} | _layout_of(fields))
            return {k: out[k] for k in self.output_fields}
        caps = _caps_of(fields)
        for rung_caps, program in self._rungs:
            if rung_caps == caps:
                return dict(zip(self.output_fields, program(*(fields[k] for k in self.input_fields))))
        raise ValueError(f"a batch padded to {caps} matches no rung of {self.capacity_ladder}; pad it to a rung "
                         "from select_capacities()")


def load_compiled_model(path: str, device="cuda") -> CompiledModel:
    return CompiledModel(path, device=device)


_REQUIRED_METADATA = {
    "format_version": int,
    "target": str,
    "mode": str,
    "input_fields": list,
    "output_fields": list,
    "capacities": dict,
    "platform": str,
    "r_max": str,
    "type_names": str,
    "model_dtype": str,
}


def _leading_dims(caps: Dict[str, int]) -> Dict[str, tuple]:
    """The shape each input field must have (leading dims) at a rung."""
    n, e, f = caps["n_nodes"], caps["n_edges"], caps["n_frames"]
    dims = {k: (n,) for k in (_keys.POSITIONS_KEY, _keys.ATOM_TYPE_KEY, _keys.BATCH_KEY, _keys.NODE_MASK_KEY)}
    dims.update({k: (e,) for k in (_keys.EDGE_CELL_SHIFT_KEY, _keys.EDGE_MASK_KEY, _keys.EDGE_VECTORS_KEY)})
    dims.update({k: (f,) for k in (_keys.CELL_KEY, _keys.NUM_NODES_KEY, _keys.FRAME_MASK_KEY)})
    dims[_keys.EDGE_INDEX_KEY] = (2, e)
    edge_src, dst_ptr, src_perm, src_ptr = LAYOUT_FIELDS
    dims.update({edge_src: (e,), src_perm: (e,), dst_ptr: (n + 1,), src_ptr: (n + 1,)})
    return dims


def validate_artifact(path: str, device=None) -> dict:
    """The machine-checkable half of the artifact contract (README, "The
    port's artifact contract"): raises ``ValueError`` on any violation and
    returns the metadata.  A "torchexport" artifact's programs are loaded
    (on ``device``, default the artifact's platform) and their inputs held
    against ``input_fields`` and the rungs' capacities."""
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        for member in ("metadata.json", "model_config.json", "params.pkl"):
            if member not in names:
                raise ValueError(f"artifact missing required member {member!r}")
        md = json.loads(zf.read("metadata.json"))
        for key, typ in _REQUIRED_METADATA.items():
            if key not in md:
                raise ValueError(f"metadata missing required key {key!r}")
            if not isinstance(md[key], typ):
                raise ValueError(f"metadata key {key!r} must be {typ.__name__}, got {type(md[key]).__name__}")
        if md["format_version"] > FORMAT_VERSION:
            raise ValueError(f"artifact format_version {md['format_version']} is newer than this reader "
                             f"({FORMAT_VERSION})")
        if md["mode"] not in MODES:
            raise ValueError(f"unknown mode {md['mode']!r}")
        if md["target"] not in TARGET_INPUT_FIELDS:
            raise ValueError(f"unknown target {md['target']!r}")
        for kind, preset in (("input_fields", TARGET_INPUT_FIELDS), ("output_fields", TARGET_OUTPUT_FIELDS)):
            if not set(md[kind]) <= set(preset[md["target"]]):
                raise ValueError(f"{kind} {md[kind]} not a subset of the {md['target']!r} preset")

        ladder = md.get("capacity_ladder", [md["capacities"]])
        for caps in ladder:
            for k in ("n_nodes", "n_edges", "n_frames"):
                if not isinstance(caps.get(k), int) or caps[k] <= 0:
                    raise ValueError(f"capacity rung {caps} has invalid {k!r}")
        keyed = [(c["n_nodes"], c["n_edges"]) for c in ladder]
        if keyed != sorted(keyed):
            raise ValueError(f"capacity_ladder must be ascending, got {ladder}")
        if ladder[0] != md["capacities"]:
            raise ValueError("capacities must equal capacity_ladder[0]")
        float(md["r_max"])  # parseable
        if not md["type_names"].split():
            raise ValueError("type_names must name at least one type")

        if md["mode"] == "torchexport":
            device = resolve_device(md["platform"] if device is None else device)
            for i, caps in enumerate(ladder):
                fname = rung_file(i)
                if fname not in names:
                    raise ValueError(f"torchexport artifact missing rung file {fname!r}")
                program = torch.export.load(io.BytesIO(zf.read(fname)))
                specs = [s for s in program.graph_signature.input_specs if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
                if len(specs) != len(md["input_fields"]):
                    raise ValueError(f"rung {i}: the program takes {len(specs)} inputs, not the "
                                     f"{len(md['input_fields'])} input_fields")
                vals = {n.name: n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"}
                dims = _leading_dims(caps)
                for field, spec in zip(md["input_fields"], specs):
                    shape = tuple(vals[spec.arg.name].shape)
                    want = dims.get(field)
                    if want is not None and shape[: len(want)] != want:
                        raise ValueError(f"rung {i}: {field} leading dims {shape} != {want}")
                    if vals[spec.arg.name].device.type != device.type:
                        raise ValueError(f"rung {i}: {field} lives on {vals[spec.arg.name].device}, not {device}")
    return md
