"""Out-of-package consumer of a ``*.nequip_tpu_torch.zip`` deployment artifact.

It imports only the standard library, numpy and ``torch``, never
``nequip_tpu_torch``, and is written against the README's "The port's
artifact contract" alone: it shows that the contract is enough for an outside
process (an MD engine's pair style, a serving loader) to run an artifact.
The twin of the JAX package's ``tools/standalone_artifact_consumer.py``.
Run it by its path:

    python nequip_tpu_torch/tools/standalone_artifact_consumer.py ARTIFACT.zip INPUTS.npz [OUT.npz]
        [--repeat N] [--deterministic]

``INPUTS.npz`` holds the real (unpadded) system under the contract's field
names: ``pos``, ``edge_index``, ``edge_cell_shift``, ``cell`` ([frames, 3,
3]), ``atom_types``, ``batch``, ``num_atoms`` (``edge_vectors`` in place of
``pos``, ``edge_cell_shift`` and ``cell`` for the ``pair_nequip`` target).
The consumer

1. parses the metadata and checks its format version;
2. refuses a ``torch`` version, or a card of another compute capability,
   than the artifact's (by name);
3. extracts the ops library the artifact carries (``ops_library``: the
   registered ops ``nequip_torch::*`` and the CUDA kernels they launch),
   checks its sha256 and loads it with ``torch.ops.load_library``; an
   artifact whose programs call the ops but that carries no library (one
   compiled for the CPU) is refused, naming the library;
4. selects the smallest capacity rung that fits;
5. pads every input to the rung;
6. puts the edge stream into kernel order and builds the edge layout's four
   tensors in numpy, where the programs take them;
7. runs the rung's program on the artifact's platform;
8. strips the padding (and returns edge forces in the input's edge order).

It prints the rung, the time of each request (padding, layout, program and
read-back, the card synchronised), each output's shape and mean magnitude,
and, with a library loaded, the schemas of the ops it registered; ``OUT.npz``
receives the outputs.  ``--repeat N`` runs the request N times (the outputs
are the last run's); ``--deterministic`` turns on
``torch.use_deterministic_algorithms`` (PyTorch's scatter-adds on the card
sum in any order otherwise).
"""

import argparse
import hashlib
import io
import json
import os
import sys
import tempfile
import time
import zipfile

import numpy as np
import torch

SUPPORTED_FORMAT_VERSION = 1

# the contract's leading dimension of each field
_NODE_FIELDS = {"pos", "atom_types", "batch", "node_mask"}
_EDGE_FIELDS = {"edge_index", "edge_cell_shift", "edge_mask", "edge_vectors"}
_FRAME_FIELDS = {"cell", "num_atoms", "frame_mask"}
_OUT_NODE = {"atomic_energy", "forces"}
_OUT_EDGE = {"edge_forces"}
_OUT_FRAME = {"total_energy", "stress", "virial"}
LAYOUT_PREFIX = "__edge_layout_csr."
_LAYOUT = tuple(LAYOUT_PREFIX + k for k in ("edge_src", "dst_ptr", "src_perm", "src_ptr"))


def rung_file(i: int) -> str:
    return "exported.pt2" if i == 0 else f"exported_{i}.pt2"


def load_metadata(zf: zipfile.ZipFile) -> dict:
    """Contract step 1."""
    md = json.loads(zf.read("metadata.json"))
    if md["format_version"] > SUPPORTED_FORMAT_VERSION:
        raise SystemExit(f"artifact format_version {md['format_version']} is newer than this consumer "
                         f"({SUPPORTED_FORMAT_VERSION})")
    if md["mode"] != "torchexport":
        raise SystemExit("this consumer runs mode=torchexport artifacts only (the eager fallback needs the package)")
    return md


def _capability(arch: str) -> tuple:
    """'sm_90a' -> (9, 0)."""
    digits = arch[len("sm_"):].rstrip("a")
    return int(digits[:-1]), int(digits[-1])


def check_runtime(md: dict) -> None:
    """Contract step 2: the torch version and the card the programs were made for."""
    if md["torch_version"] != torch.__version__:
        raise SystemExit(f"the artifact was exported with torch {md['torch_version']}; this process runs torch "
                         f"{torch.__version__}: run it under torch {md['torch_version']}")
    if md["platform"] == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the artifact's programs run on a CUDA card; this process sees none")
    lib = md.get("ops_library")
    if lib is not None:
        want, have = _capability(lib["arch"]), torch.cuda.get_device_capability()
        if have != want:
            raise SystemExit(f"the artifact's ops library is built for {lib['arch']} (compute capability "
                             f"{want[0]}.{want[1]}); this card has compute capability {have[0]}.{have[1]}")


def load_ops_library(zf: zipfile.ZipFile, md: dict, directory: str):
    """Contract step 3: the ops library, checked and loaded; None where the
    programs call no op."""
    ops = md.get("custom_ops", [])
    lib = md.get("ops_library")
    if lib is None:
        if ops:
            raise SystemExit(f"the artifact's programs call {', '.join(ops)}, but it carries no ops library "
                             "(ops_library): compile the model on the card (platform cuda), whose artifact "
                             "carries the library, or serve it with nequip_tpu_torch")
        return None
    blob = zf.read(lib["member"])
    digest = hashlib.sha256(blob).hexdigest()
    if digest != lib["sha256"]:
        raise SystemExit(f"ops library {lib['member']}: sha256 {digest} != the metadata's {lib['sha256']}")
    path = os.path.join(directory, os.path.basename(lib["member"]))
    with open(path, "wb") as f:
        f.write(blob)
    torch.ops.load_library(path)
    return path


def select_rung(md: dict, n_nodes: int, n_edges: int):
    """Contract step 4: the smallest rung that fits the real system."""
    ladder = md.get("capacity_ladder") or [md["capacities"]]
    for i, caps in enumerate(ladder):
        if n_nodes <= caps["n_nodes"] and n_edges <= caps["n_edges"]:
            return i, caps
    raise SystemExit(f"system ({n_nodes} nodes, {n_edges} edges) exceeds the top ladder rung {ladder[-1]}")


def _counts(real: dict) -> tuple:
    n = real["pos"].shape[0] if "pos" in real else real["atom_types"].shape[0]
    return int(n), int(real["edge_index"].shape[1]), int(real["num_atoms"].shape[0])


def pad_inputs(md: dict, caps: dict, real: dict) -> dict:
    """Contract step 5: real arrays padded to the rung.  Padded nodes belong
    to the last frame slot, padded edges join the last node slot to itself
    with a zero shift, float padding is zero, and the masks mark the real
    entries."""
    n, e, f = caps["n_nodes"], caps["n_edges"], caps["n_frames"]
    n_real, e_real, f_real = _counts(real)

    def pad_rows(a, rows, fill=0):
        a = np.asarray(a)
        out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
        out[: a.shape[0]] = a
        return out

    padded = {}
    for field in md["input_fields"]:
        if field.startswith(LAYOUT_PREFIX):
            continue
        if field == "node_mask":
            padded[field] = np.arange(n) < n_real
        elif field == "edge_mask":
            padded[field] = np.arange(e) < e_real
        elif field == "frame_mask":
            padded[field] = np.arange(f) < f_real
        elif field == "edge_index":
            ei = np.full((2, e), n - 1, dtype=np.int64)
            ei[:, :e_real] = real[field]
            padded[field] = ei
        elif field == "batch":
            padded[field] = pad_rows(np.asarray(real[field], np.int64), n, fill=f - 1 if f > f_real else f_real - 1)
        else:
            rows = n if field in _NODE_FIELDS else e if field in _EDGE_FIELDS else f
            padded[field] = pad_rows(real[field], rows)
    return padded


def edge_layout(padded: dict, n_nodes: int) -> np.ndarray:
    """Contract step 6, in place on ``padded``: the edge fields in kernel
    order (the real edges first, sorted by destination, stably; the masked
    edges after them) and the layout's tensors: ``edge_src`` the source of
    every slot, ``dst_ptr`` the destination CSR row pointers over the real
    edges, ``src_perm`` the real slots sorted stably by source (zero-padded
    to the edge capacity) and ``src_ptr`` its row pointers; all int32.
    Returns the order (the permutation applied to the edges)."""
    ei, mask = padded["edge_index"], padded["edge_mask"]
    e = ei.shape[1]
    order = np.argsort(np.where(mask, ei[0], n_nodes), kind="stable")
    for field in padded:
        if field in _EDGE_FIELDS:
            padded[field] = padded[field][:, order] if field == "edge_index" else padded[field][order]
    ei, n_real = padded["edge_index"], int(mask.sum())
    dst, src = ei[0, :n_real], ei[1, :n_real]

    def ptr(keys):
        return np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=n_nodes))]).astype(np.int32)

    src_perm = np.zeros(e, np.int32)
    src_perm[:n_real] = np.argsort(src, kind="stable")
    padded.update(zip(_LAYOUT, (ei[1].astype(np.int32), ptr(dst), src_perm, ptr(src))))
    return order


def _input_dtypes(program) -> list:
    """The dtype of each user input of an exported program, in order."""
    specs = [s for s in program.graph_signature.input_specs
             if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    vals = {n.name: n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"}
    return [vals[s.arg.name].dtype for s in specs]


def strip_outputs(md: dict, outs, counts: tuple, order) -> dict:
    """Contract step 8: drop padded rows using the real counts; edge outputs
    back in the input's edge order."""
    n_real, e_real, f_real = counts
    result = {}
    for name, arr in zip(md["output_fields"], outs):
        a = arr.detach().cpu().numpy()
        if name in _OUT_NODE:
            a = a[:n_real]
        elif name in _OUT_EDGE:
            a = (a[np.argsort(order)] if order is not None else a)[:e_real]
        elif name in _OUT_FRAME:
            a = a[:f_real]
        result[name] = a
    return result


def request(md: dict, caps: dict, program, dtypes: list, real: dict, device: torch.device) -> dict:
    """Steps 5-8 for one system."""
    padded = pad_inputs(md, caps, real)
    order = edge_layout(padded, caps["n_nodes"]) if _LAYOUT[0] in md["input_fields"] else None
    args = [torch.as_tensor(np.ascontiguousarray(padded[k])).to(device=device, dtype=dt)
            for k, dt in zip(md["input_fields"], dtypes)]
    outs = program(*args)
    return strip_outputs(md, outs, _counts(real), order)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("artifact")
    parser.add_argument("inputs")
    parser.add_argument("out", nargs="?")
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--deterministic", action="store_true")
    args = parser.parse_args(argv)
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False  # the kernels write whole outputs
    real = {k: np.asarray(v) for k, v in np.load(args.inputs).items()}

    with zipfile.ZipFile(args.artifact) as zf, tempfile.TemporaryDirectory() as tmp:
        md = load_metadata(zf)
        check_runtime(md)
        if load_ops_library(zf, md, tmp) is not None:
            schemas = {op: str(getattr(torch.ops.nequip_torch, op.split("::")[1]).default._schema)
                       for op in md["custom_ops"]}
            print("nequip_torch schemas: " + json.dumps(schemas, sort_keys=True))
        n_real, e_real, _ = _counts(real)
        rung, caps = select_rung(md, n_real, e_real)
        program = torch.export.load(io.BytesIO(zf.read(rung_file(rung))))
    dtypes = _input_dtypes(program)
    module = program.module()
    device = torch.device(md["platform"])
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        result = request(md, caps, module, dtypes, real, device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        print(f"request ms {(time.perf_counter() - t0) * 1e3:.3f}")

    print(f"rung {rung} {caps}; outputs:")
    for k, v in result.items():
        print(f"  {k:16s} shape={v.shape} |mean|={np.abs(v).mean():.6e}")
    if args.out:
        np.savez(args.out, **result)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
