"""Irreducible representation (irrep) bookkeeping for O(3)-equivariant features.

Port of ``nequip_tpu/ops/irreps.py`` (pure Python, no framework imports).

* The memory layout is **ir_mul** (channel-last): a chunk for a
  ``(mul, l, p)`` irrep block is stored as ``(..., 2l+1, mul)`` flattened to
  ``(..., (2l+1)*mul)`` with the m-index major, exactly as in the JAX
  package, so features and weights cross between the two unchanged.
* ``Irreps`` is an immutable tuple; all metadata (slices, dims) is static
  Python.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List, Tuple, Union


@dataclass(frozen=True, order=True)
class Irrep:
    """A single O(3) irrep labeled by rotation order ``l`` and parity ``p``.

    ``p`` is +1 (even, "e") or -1 (odd, "o").
    """

    l: int
    p: int

    def __post_init__(self):
        if self.l < 0:
            raise ValueError(f"l must be >= 0, got {self.l}")
        if self.p not in (1, -1):
            raise ValueError(f"parity must be +1 or -1, got {self.p}")

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    @classmethod
    def parse(cls, s: Union[str, "Irrep", Tuple[int, int]]) -> "Irrep":
        if isinstance(s, Irrep):
            return s
        if isinstance(s, tuple):
            return cls(int(s[0]), int(s[1]))
        m = re.fullmatch(r"(\d+)([eo])", s.strip())
        if m is None:
            raise ValueError(f"cannot parse irrep {s!r}")
        return cls(int(m.group(1)), 1 if m.group(2) == "e" else -1)

    def __mul__(self, other: "Irrep") -> Iterator["Irrep"]:
        """Selection rule: tensor product decomposition l1 x l2 -> |l1-l2| .. l1+l2."""
        other = Irrep.parse(other)
        p = self.p * other.p
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, p)

    def __repr__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"


@dataclass(frozen=True)
class MulIrrep:
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __repr__(self) -> str:
        return f"{self.mul}x{self.ir}"

    def __iter__(self):
        yield self.mul
        yield self.ir


_CHUNK_RE = re.compile(r"(?:(\d+)\s*x\s*)?(\d+)([eo])")


class Irreps(tuple):
    """An ordered direct sum of multiple irreps, e.g. ``32x0e+16x1o``.

    Layout contract (ir_mul): the flat feature dimension is the concatenation
    of chunks; chunk for ``(mul, l, p)`` occupies ``mul*(2l+1)`` entries laid
    out m-major, i.e. reshapeable to ``(2l+1, mul)``.
    """

    def __new__(cls, irreps=None) -> "Irreps":
        if irreps is None:
            return super().__new__(cls, ())
        if isinstance(irreps, Irreps):
            return irreps
        if isinstance(irreps, str):
            out = []
            s = irreps.strip()
            if s:
                for part in s.split("+"):
                    m = _CHUNK_RE.fullmatch(part.strip())
                    if m is None:
                        raise ValueError(f"cannot parse irreps {irreps!r}")
                    mul = int(m.group(1)) if m.group(1) else 1
                    out.append(
                        MulIrrep(mul, Irrep(int(m.group(2)), 1 if m.group(3) == "e" else -1))
                    )
            return super().__new__(cls, out)
        if isinstance(irreps, (Irrep, MulIrrep)):
            irreps = [irreps]
        out = []
        for x in irreps:
            if isinstance(x, MulIrrep):
                out.append(x)
            elif isinstance(x, Irrep):
                out.append(MulIrrep(1, x))
            else:
                mul, ir = x
                out.append(MulIrrep(int(mul), Irrep.parse(ir)))
        return super().__new__(cls, out)

    # --- metadata -----------------------------------------------------
    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        """Total multiplicity (sum over chunks)."""
        return sum(mi.mul for mi in self)

    def slices(self) -> List[slice]:
        out = []
        off = 0
        for mi in self:
            out.append(slice(off, off + mi.dim))
            off += mi.dim
        return out

    def __contains__(self, item) -> bool:
        if isinstance(item, (Irrep, str)):
            try:
                ir = Irrep.parse(item)
            except (ValueError, AttributeError):
                return super().__contains__(item)
            return any(mi.ir == ir for mi in self)
        return super().__contains__(item)

    # --- algebra ------------------------------------------------------
    def __add__(self, other) -> "Irreps":
        return Irreps(tuple.__add__(self, Irreps(other)))

    def __getitem__(self, item):
        res = tuple.__getitem__(self, item)
        if isinstance(item, slice):
            return Irreps(res)
        return res

    def sort(self) -> Tuple["Irreps", List[int], List[int]]:
        """Sort chunks by (l, p).  Returns (sorted_irreps, perm, inv_perm).

        ``perm[old_position] = new_position`` (matches e3nn's ``Irreps.sort``
        convention used at upstream NequIP's ``nn/interaction_block.py``).
        """
        order = sorted(range(len(self)), key=lambda i: (self[i].ir.l, -self[i].ir.p))
        inv = order  # inv[new] = old
        perm = [0] * len(self)
        for new, old in enumerate(order):
            perm[old] = new
        return Irreps([self[i] for i in order]), perm, inv

    def simplify(self) -> "Irreps":
        """Merge adjacent chunks with identical irs, drop zero multiplicities."""
        out: List[MulIrrep] = []
        for mi in self:
            if mi.mul == 0:
                continue
            if out and out[-1].ir == mi.ir:
                out[-1] = MulIrrep(out[-1].mul + mi.mul, mi.ir)
            else:
                out.append(mi)
        return Irreps(out)

    @classmethod
    def spherical_harmonics(cls, lmax: int, p: int = -1) -> "Irreps":
        """``1x0e+1x1o+1x2e+...`` (p=-1 gives alternating parity of true SH)."""
        return cls([(1, Irrep(l, p**l)) for l in range(lmax + 1)])

    def __repr__(self) -> str:
        return "+".join(repr(mi) for mi in self) if len(self) else "Irreps()"


def tp_path_exists(irreps_in1, irreps_in2, ir_out) -> bool:
    """Whether a CG path from irreps_in1 x irreps_in2 into ir_out exists.

    Mirrors ``nequip_tpu/ops/irreps.py`` ``tp_path_exists``.
    """
    irreps_in1 = Irreps(irreps_in1).simplify()
    irreps_in2 = Irreps(irreps_in2).simplify()
    ir_out = Irrep.parse(ir_out)
    for _, ir1 in irreps_in1:
        for _, ir2 in irreps_in2:
            if ir_out in set(ir1 * ir2):
                return True
    return False
