"""Wigner-D matrices and real Clebsch-Gordan (3j) tensors.

Port of ``nequip_tpu/ops/cg.py`` (numpy only).  Everything is derived from
the spherical-harmonic polynomial tables in ``.spherical``:

* ``wigner_D(l, R)`` by exact least squares from SH evaluations,
  ``Y(R v) = D^l(R) Y(v)``;
* ``real_clebsch_gordan(l1, l2, l3)`` as the one-dimensional invariant
  subspace of ``D^{l1} x D^{l2} x D^{l3}`` (deterministic SVD null space,
  unit Frobenius norm, deterministic sign).

Both assert their defining equivariance property when built, so a
convention mismatch fails loudly.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .spherical import spherical_harmonics_np


def _rotation_from_quaternion(q: np.ndarray) -> np.ndarray:
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    """Uniform random SO(3) rotation matrix."""
    return _rotation_from_quaternion(rng.standard_normal(4))


def _sh_block(l: int, vecs: np.ndarray) -> np.ndarray:
    """(n, 2l+1) block of degree-l real SH values at unit vectors."""
    full = spherical_harmonics_np(l, vecs, normalize=True)
    return full[:, l * l : (l + 1) * (l + 1)]


@lru_cache(maxsize=None)
def _sample_vectors(l: int) -> np.ndarray:
    rng = np.random.RandomState(12345 + l)
    n = 4 * (2 * l + 1) + 8
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def wigner_D(l: int, R: np.ndarray) -> np.ndarray:
    """Real Wigner-D matrix of degree l for rotation (or rotoreflection) R.

    Satisfies ``Y_l(R v) = D^l(R) @ Y_l(v)``.  For improper R (det=-1) this is
    the representation matrix of O(3) acting on the *even* tensor basis; the
    parity factor (-1)^l (or the irrep parity p) must be applied by the caller
    for pseudo-tensor irreps.
    """
    if l == 0:
        return np.ones((1, 1))
    V = _sample_vectors(l)
    A = _sh_block(l, V)  # (n, 2l+1)
    B = _sh_block(l, V @ np.asarray(R, dtype=np.float64).T)  # (n, 2l+1)
    Dt, res, _, _ = np.linalg.lstsq(A, B, rcond=None)
    D = Dt.T
    # self-check: exactness of the solve
    err = np.abs(A @ D.T - B).max()
    assert err < 1e-10, f"wigner_D({l}) solve failed: {err}"
    return D


def irrep_D(l: int, p: int, R: np.ndarray) -> np.ndarray:
    """O(3) representation matrix for irrep (l, p) under a (possibly improper) R."""
    R = np.asarray(R, dtype=np.float64)
    det = np.linalg.det(R)
    if det < 0:
        # factor out the inversion: R = (-I) R_proper
        Dp = wigner_D(l, -R)
        return p * Dp
    return wigner_D(l, R)


@lru_cache(maxsize=None)
def real_clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real 3j tensor C of shape (2l1+1, 2l2+1, 2l3+1), unit Frobenius norm.

    Defining property (checked at build):
        C_{m1 m2 m3} is invariant under simultaneous rotation of the three
        indices, i.e. einsum('ia,jb,kc,abc->ijk', D1, D2, D3, C) == C.

    Hence ``z_{m3} = sum_{m1 m2} C_{m1 m2 m3} x_{m1} y_{m2}`` maps l1 x l2
    features to an l3 feature equivariantly.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        raise ValueError(f"no CG path for ({l1}, {l2}, {l3})")
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    dim = d1 * d2 * d3

    rng = np.random.RandomState(54321)
    rows = []
    for _ in range(3):
        R = random_rotation(rng)
        D1, D2, D3 = wigner_D(l1, R), wigner_D(l2, R), wigner_D(l3, R)
        M = np.einsum("ia,jb,kc->ijkabc", D1, D2, D3).reshape(dim, dim)
        rows.append(M - np.eye(dim))
    A = np.concatenate(rows, axis=0)
    _, s, Vt = np.linalg.svd(A)
    null_dim = int(np.sum(s < 1e-8)) + (dim - len(s) if A.shape[0] < dim else 0)
    assert null_dim == 1, f"CG({l1},{l2},{l3}) null space dim {null_dim} != 1"
    C = Vt[-1].reshape(d1, d2, d3)

    # deterministic sign: first element (in flat order) with |c| > 0.5*max is positive
    flat = C.reshape(-1)
    thresh = 0.5 * np.abs(flat).max()
    for v in flat:
        if abs(v) > thresh:
            if v < 0:
                C = -C
            break

    # self-check equivariance with a fresh rotation
    R = random_rotation(np.random.RandomState(99))
    D1, D2, D3 = wigner_D(l1, R), wigner_D(l2, R), wigner_D(l3, R)
    C2 = np.einsum("ia,jb,kc,abc->ijk", D1, D2, D3, C)
    assert np.abs(C2 - C).max() < 1e-10, f"CG({l1},{l2},{l3}) equivariance failed"
    assert abs(np.linalg.norm(C) - 1.0) < 1e-12
    C.setflags(write=False)
    return C


@lru_cache(maxsize=None)
def cg_component_normalized(l1: int, l2: int, l3: int) -> np.ndarray:
    """CG tensor scaled by sqrt(2*l3+1).

    With component-normalized inputs (unit variance per component), the
    contraction then yields unit-variance outputs — this matches e3nn's
    ``irrep_normalization="component"`` convention that the reference's tensor
    products rely on.
    """
    return real_clebsch_gordan(l1, l2, l3) * np.sqrt(2 * l3 + 1)
