"""Canonical field names for AtomicDataDict.

Port of ``nequip_tpu/data/_keys.py``: the same string constants, so that
padded batches, outputs and configs are interchangeable between the JAX
package and this one.  Padding-mask fields (``node_mask``/``edge_mask``/
``frame_mask``) follow the same contract (``docs/design.md`` section 1).
"""

from typing import Final, List

# === core ===
POSITIONS_KEY: Final[str] = "pos"  # (num_atoms, 3)
ATOM_TYPE_KEY: Final[str] = "atom_types"  # (num_atoms,) int
# (2, num_edges): [0] = destination/center nodes, [1] = source/neighbor nodes
EDGE_INDEX_KEY: Final[str] = "edge_index"
EDGE_TRANSPOSE_PERM_KEY: Final[str] = "edge_transpose_perm"
# precomputed fused-kernel edge layouts (ops/kernels/tp_scatter.py) are stored
# under keys with this prefix; they are DERIVED from EDGE_INDEX_KEY and must
# be stripped whenever the edge list is rewritten (stale layouts are
# shape-compatible and would silently permute messages)
EDGE_LAYOUT_KEY_PREFIX: Final[str] = "__edge_layout_"

# === cell related ===
CELL_KEY: Final[str] = "cell"  # (num_frames, 3, 3), rows are cell vectors
EDGE_CELL_SHIFT_KEY: Final[str] = "edge_cell_shift"  # (num_edges, 3)

# === batching ===
BATCH_KEY: Final[str] = "batch"  # (num_atoms,) frame index per atom
NUM_NODES_KEY: Final[str] = "num_atoms"  # (num_frames,) true atom count per frame
DATASET_KEY: Final[str] = "dataset"  # (num_frames, 1)

# === padding masks (TPU-native addition; True = real, False = padding) ===
NODE_MASK_KEY: Final[str] = "node_mask"  # (num_atoms,)
EDGE_MASK_KEY: Final[str] = "edge_mask"  # (num_edges,)
FRAME_MASK_KEY: Final[str] = "frame_mask"  # (num_frames,)

# === usually unused by the model but present in data ===
PBC_KEY: Final[str] = "pbc"  # (num_frames, 3) bool
ATOMIC_NUMBERS_KEY: Final[str] = "atomic_numbers"  # (num_atoms,) int

# === physical edge quantities ===
EDGE_VECTORS_KEY: Final[str] = "edge_vectors"  # (num_edges, 3)
EDGE_LENGTH_KEY: Final[str] = "edge_lengths"  # (num_edges, 1)
NORM_LENGTH_KEY: Final[str] = "normed_edge_lengths"  # (num_edges, 1)
EDGE_TYPE_KEY: Final[str] = "edge_type_flat"  # (2, num_edges)

# === feature keys ===
EDGE_CUTOFF_KEY: Final[str] = "edge_cutoff"  # (num_edges, 1)
EDGE_ATTRS_KEY: Final[str] = "edge_attrs"
EDGE_EMBEDDING_KEY: Final[str] = "edge_embedding"
EDGE_FEATURES_KEY: Final[str] = "edge_features"
NODE_ATTRS_KEY: Final[str] = "node_attrs"
NODE_FEATURES_KEY: Final[str] = "node_features"
FEATURE_NORM_FACTOR_KEY: Final[str] = "feature_norm_factor"

# === physical predictions ===
EDGE_ENERGY_KEY: Final[str] = "edge_energy"
PER_ATOM_ENERGY_KEY: Final[str] = "atomic_energy"  # (num_atoms, 1)
TOTAL_ENERGY_KEY: Final[str] = "total_energy"  # (num_frames, 1)
FORCE_KEY: Final[str] = "forces"  # (num_atoms, 3)
EDGE_FORCE_KEY: Final[str] = "edge_forces"  # (num_edges, 3)
PARTIAL_FORCE_KEY: Final[str] = "partial_forces"
STRESS_KEY: Final[str] = "stress"  # (num_frames, 3, 3)
VIRIAL_KEY: Final[str] = "virial"  # (num_frames, 3, 3)

# misc ase-style property keys
FREE_ENERGY_KEY: Final[str] = "free_energy"
PER_ATOM_STRESS_KEY: Final[str] = "stresses"
TOTAL_MAGMOM_KEY: Final[str] = "magmom"
MAGMOM_KEY: Final[str] = "magmoms"
CHARGE_KEY: Final[str] = "charges"
DIPOLE_KEY: Final[str] = "dipole"
DIELECTRIC_KEY: Final[str] = "dielectric_tensor"
BORN_CHARGE_KEY: Final[str] = "born_effective_charges"
POLARIZATION_KEY: Final[str] = "polarization"
TOTAL_CHARGE_KEY: Final[str] = "charge"
TOTAL_SPIN_KEY: Final[str] = "spin"

# === external-integration keys (spatial decomposition / ghost atoms) ===
NUM_LOCAL_GHOST_NODES_KEY: Final[str] = "num_local_ghost_atoms"  # (2,)

ALLOWED_KEYS: List[str] = [v for k, v in dict(globals()).items() if k.endswith("_KEY")]
assert all("." not in key for key in ALLOWED_KEYS)
