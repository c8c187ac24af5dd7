"""Real spherical harmonics from exact Cartesian polynomial tables.

Port of ``nequip_tpu/ops/spherical.py``.  The JAX package derives the tables
with sympy; this module derives the same tables in plain Python, so it runs
where sympy is not installed: polynomials are dicts ``{(a, b, c): Fraction}``
of the monomial ``x^a y^b z^c``, every step is exact rational arithmetic,
and the sphere-average normalisation is applied with one ``math.sqrt`` per
coefficient at the end.

Conventions (identical to the JAX package):

* basis order within each l is m = -l..l;
* the l=1 irrep is exactly ``(y, z, x)``;
* "component" normalisation: ``mean_{unit v}[Y_{l,m}(v)^2] = 1``.

Evaluation is ``monomials(v) @ coeffs``, one matmul per call.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch

Poly = Dict[Tuple[int, int, int], Fraction]


def _double_factorial(n: int) -> int:
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return out


def _monomials(degree: int) -> List[Tuple[int, int, int]]:
    """All (i, j, k) with i+j+k == degree, in the JAX package's order."""
    return [
        (i, j, degree - i - j)
        for i in range(degree, -1, -1)
        for j in range(degree - i, -1, -1)
    ]


def _add(p: Poly, q: Poly, scale: Fraction = Fraction(1)) -> Poly:
    out = dict(p)
    for mon, c in q.items():
        out[mon] = out.get(mon, Fraction(0)) + scale * c
    return {m: c for m, c in out.items() if c != 0}


def _mul(p: Poly, q: Poly) -> Poly:
    out: Poly = {}
    for (a1, b1, c1), k1 in p.items():
        for (a2, b2, c2), k2 in q.items():
            mon = (a1 + a2, b1 + b2, c1 + c2)
            out[mon] = out.get(mon, Fraction(0)) + k1 * k2
    return {m: c for m, c in out.items() if c != 0}


def _scale(p: Poly, s: Fraction) -> Poly:
    return {m: c * s for m, c in p.items() if c * s != 0}


def _sphere_average(p: Poly) -> Fraction:
    """Exact mean of a polynomial over the unit sphere."""
    total = Fraction(0)
    for (a, b, c), coeff in p.items():
        if a % 2 or b % 2 or c % 2:
            continue
        total += coeff * Fraction(
            _double_factorial(a - 1) * _double_factorial(b - 1) * _double_factorial(c - 1),
            _double_factorial(a + b + c + 1),
        )
    return total


@lru_cache(maxsize=None)
def _sh_coeff_tables(lmax: int) -> Tuple[Tuple[Tuple[int, int, int], ...], np.ndarray]:
    """``(monomials, coeffs)`` with ``Y(v) = monomials(v) @ coeffs``.

    ``coeffs`` is ``(n_monomials, (lmax+1)^2)``, block diagonal by degree.
    """
    one: Poly = {(0, 0, 0): Fraction(1)}
    X: Poly = {(1, 0, 0): Fraction(1)}
    Y: Poly = {(0, 1, 0): Fraction(1)}
    Z: Poly = {(0, 0, 1): Fraction(1)}
    R2: Poly = {(2, 0, 0): Fraction(1), (0, 2, 0): Fraction(1), (0, 0, 2): Fraction(1)}

    # sectoral parts: C_m = Re((x+iy)^m), S_m = Im((x+iy)^m)
    C: List[Poly] = [one]
    S: List[Poly] = [{}]
    for m in range(1, lmax + 1):
        C.append(_add(_mul(X, C[m - 1]), _mul(Y, S[m - 1]), Fraction(-1)))
        S.append(_add(_mul(X, S[m - 1]), _mul(Y, C[m - 1])))

    # associated-Legendre-like polynomials in (z, r2):
    #   P[m][m] = (2m-1)!!,  P[m+1][m] = (2m+1) z P[m][m],
    #   (l-m) P[l][m] = (2l-1) z P[l-1][m] - (l-1+m) r2 P[l-2][m]
    P: List[List[Poly]] = [[{} for _ in range(lmax + 1)] for _ in range(lmax + 1)]
    for m in range(lmax + 1):
        P[m][m] = {(0, 0, 0): Fraction(_double_factorial(2 * m - 1))}
        if m + 1 <= lmax:
            P[m + 1][m] = _scale(_mul(Z, P[m][m]), Fraction(2 * m + 1))
        for l in range(m + 2, lmax + 1):
            t1 = _scale(_mul(Z, P[l - 1][m]), Fraction(2 * l - 1))
            t2 = _scale(_mul(R2, P[l - 2][m]), Fraction(-(l - 1 + m)))
            P[l][m] = _scale(_add(t1, t2), Fraction(1, l - m))

    monomials: List[Tuple[int, int, int]] = []
    blocks: List[np.ndarray] = []
    for l in range(lmax + 1):
        mons = _monomials(l)
        monomials.extend(mons)
        mon_index = {mon: i for i, mon in enumerate(mons)}
        block = np.zeros((len(mons), 2 * l + 1), dtype=np.float64)
        for col, m in enumerate(range(-l, l + 1)):
            am = abs(m)
            if m < 0:
                p = _mul(P[l][am], S[am])
            elif m == 0:
                p = P[l][0]
            else:
                p = _mul(P[l][am], C[am])
            norm2 = _sphere_average(_mul(p, p))
            for (a, b, c), coeff in p.items():
                deficit = l - (a + b + c)
                if deficit < 0 or deficit % 2:
                    raise AssertionError((l, m, (a, b, c)))
                # re-homogenise to degree l by multiplying with r2^k
                r2k = one
                for _ in range(deficit // 2):
                    r2k = _mul(r2k, R2)
                for (a2, b2, c2), c2k in r2k.items():
                    exact = coeff * c2k  # rational part; one sqrt per coefficient
                    val = math.copysign(math.sqrt(exact * exact / norm2), exact)
                    block[mon_index[(a + a2, b + b2, c + c2)], col] += val
        blocks.append(block)

    sh = (lmax + 1) ** 2
    coeffs = np.zeros((len(monomials), sh), dtype=np.float64)
    row = col = 0
    for block in blocks:
        coeffs[row : row + block.shape[0], col : col + block.shape[1]] = block
        row += block.shape[0]
        col += block.shape[1]
    coeffs.setflags(write=False)
    return tuple(monomials), coeffs


def sh_dim(lmax: int) -> int:
    return (lmax + 1) ** 2


def spherical_harmonics_np(lmax: int, vecs: np.ndarray, normalize: bool = True) -> np.ndarray:
    """Host/numpy evaluation (used to derive Wigner-D and CG tensors)."""
    vecs = np.asarray(vecs, dtype=np.float64)
    if normalize:
        n = np.linalg.norm(vecs, axis=-1, keepdims=True)
        vecs = vecs / np.where(n == 0, 1.0, n)
    monomials, coeffs = _sh_coeff_tables(lmax)
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    cols = [
        np.broadcast_to((x**i if i else 1.0) * (y**j if j else 1.0) * (z**k if k else 1.0), x.shape)
        for (i, j, k) in monomials
    ]
    return np.stack(cols, axis=-1) @ coeffs


@lru_cache(maxsize=None)
def _sh_coeff_tensor(lmax: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The coefficient table on ``device``, copied there once (a copy from
    the host in every call would also break CUDA graph capture)."""
    return torch.tensor(_sh_coeff_tables(lmax)[1], dtype=dtype, device=device)


def spherical_harmonics(
    lmax: int, vecs: torch.Tensor, normalize: bool = True, eps: float = 1e-30
) -> torch.Tensor:
    """``Y(v)`` with component normalisation; ``vecs`` (..., 3) -> (..., (lmax+1)^2).

    The zero vector maps to finite values with a finite gradient (padded
    edges are masked downstream).
    """
    monomials, _ = _sh_coeff_tables(lmax)
    coeffs = _sh_coeff_tensor(lmax, vecs.dtype, vecs.device)
    if normalize:
        n2 = torch.sum(vecs * vecs, dim=-1, keepdim=True)
        big = n2 > eps
        safe = torch.where(big, n2, torch.ones_like(n2))
        vecs = vecs * torch.where(big, torch.rsqrt(safe), torch.zeros_like(n2))
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    xp, yp, zp = [torch.ones_like(x)], [torch.ones_like(y)], [torch.ones_like(z)]
    for _ in range(lmax):
        xp.append(xp[-1] * x)
        yp.append(yp[-1] * y)
        zp.append(zp[-1] * z)
    mon = torch.stack([xp[i] * yp[j] * zp[k] for (i, j, k) in monomials], dim=-1)
    return mon @ coeffs
