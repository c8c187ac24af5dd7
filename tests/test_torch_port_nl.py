"""The port's neighbour lists against the JAX package's C++ cell list.

Both of the port's backends (``cpp``, its own copy of the cell list, and
``kdtree``) give exactly the edge set, as (dst, src, shift) tuples, of the
JAX ``cpp`` backend on the cases of ``tests/unit/data/test_neighborlist.py``
(open, orthorhombic, triclinic, mixed boundaries, a cell smaller than the
cutoff) and on unwrapped positions; the port's ``cpp`` gives the same
arrays in the same order.  The JAX backend is pinned to ``"cpp"``: its
``"auto"`` falls back to scipy without a word when the build fails.  A
failed build of the port's cell list raises with the compiler's output.
"""

import os
import stat

import numpy as np
import pytest

from nequip_tpu.data import neighbor_list as j_neighbor_list

from nequip_tpu_torch.data import _cpp_nl, compute_neighborlist_, neighbor_list, register_neighborlist_backend
from nequip_tpu_torch.data.neighborlist import DEFAULT_BACKEND

CASES = ["open", "ortho", "triclinic", "mixed", "small_cell", "unwrapped"]


def _case(name):
    """(pos, cutoff, cell, pbc) of the JAX suite's cases (seed 42; the
    unwrapped case: seed 3, atoms sent up to 4 boxes away)."""
    r = np.random.RandomState(42)
    if name == "open":
        return r.uniform(0, 10, (40, 3)), 3.0, None, (False,) * 3
    if name == "ortho":
        return r.uniform(0, 6, (30, 3)), 3.5, np.diag([6.0, 7.0, 8.0]), (True,) * 3
    if name == "triclinic":
        cell = np.array([[6.0, 0, 0], [2.0, 6.0, 0], [1.0, -1.5, 7.0]])
        return r.uniform(0, 1, (25, 3)) @ cell, 3.0, cell, (True,) * 3
    if name == "mixed":
        return r.uniform(0, 5, (20, 3)), 3.0, np.diag([5.0, 5.0, 20.0]), (True, True, False)
    if name == "small_cell":
        return np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]), 4.0, np.diag([2.0, 2.0, 2.0]), (True,) * 3
    r = np.random.RandomState(3)
    cell = np.diag([6.0, 7.0, 8.0])
    pos = r.uniform(0, 6, (24, 3)) + r.randint(-4, 5, (24, 3)).astype(float) @ cell
    return pos, 3.2, cell, (True,) * 3


def _edge_set(edge_index, shifts):
    return {(int(d), int(s)) + tuple(int(x) for x in sh) for d, s, sh in zip(edge_index[0], edge_index[1], shifts)}


@pytest.mark.parametrize("backend", ["cpp", "kdtree"])
@pytest.mark.parametrize("case", CASES)
def test_backend_matches_jax_cpp(case, backend):
    pos, cut, cell, pbc = _case(case)
    want_ei, want_sh = j_neighbor_list(pos, cut, cell=cell, pbc=pbc, backend="cpp")
    ei, sh = neighbor_list(pos, cut, cell=cell, pbc=pbc, backend=backend)
    assert ei.dtype == np.int32 and sh.dtype == np.float64 and sh.shape == (ei.shape[1], 3)
    assert len(want_sh) > 0 and _edge_set(ei, sh) == _edge_set(want_ei, want_sh)
    if backend == "cpp":  # the same code: the same order
        np.testing.assert_array_equal(ei, want_ei)
        np.testing.assert_array_equal(sh, want_sh)
    if cell is not None:  # the contract: |pos[src] - pos[dst] + shift @ cell| <= cutoff
        vec = pos[ei[1]] - pos[ei[0]] + sh @ cell
        assert np.all(np.linalg.norm(vec, axis=1) <= cut + 1e-9)


def test_default_backend_and_registry():
    pos, cut, cell, pbc = _case("triclinic")
    assert DEFAULT_BACKEND == "cpp"
    data = compute_neighborlist_({"pos": pos, "cell": cell, "pbc": np.array(pbc)}, cut)
    ei, sh = neighbor_list(pos, cut, cell=cell, pbc=pbc, backend="cpp")
    np.testing.assert_array_equal(data["edge_index"], ei)
    np.testing.assert_array_equal(data["edge_cell_shift"], sh)

    calls = []

    def reversed_kdtree(pos, r_max, cell, pbc):
        calls.append(r_max)
        ei, sh = neighbor_list(pos, r_max, cell=cell, pbc=pbc, backend="kdtree")
        return ei[:, ::-1].copy(), sh[::-1].copy()

    register_neighborlist_backend("test_reversed", reversed_kdtree)
    got = compute_neighborlist_({"pos": pos, "cell": cell, "pbc": np.array(pbc)}, cut, backend="test_reversed")
    assert calls == [cut]
    assert _edge_set(got["edge_index"], got["edge_cell_shift"]) == _edge_set(ei, sh)
    with pytest.raises(ValueError, match="unknown neighbour-list backend 'auto'"):
        neighbor_list(pos, cut, cell=cell, pbc=pbc, backend="auto")


def test_isolated_atom():
    for backend in ("cpp", "kdtree"):
        ei, sh = neighbor_list(np.zeros((1, 3)), 3.0, backend=backend)
        assert ei.shape == (2, 0) and sh.shape == (0, 3)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No g++ on PATH, then a g++ on PATH that fails: both raise with what
    the compiler said, and leave nothing in the build directory."""
    empty, fake = tmp_path / "empty", tmp_path / "fake"
    empty.mkdir()
    fake.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(RuntimeError, match="compiler 'g\\+\\+' not found"):
        _cpp_nl.build(tmp_path / "build")

    gxx = fake / "g++"  # records its arguments beside itself, then fails
    gxx.write_text(f'#!/bin/sh\necho "$@" > "{gxx}.args"\necho "fatal: out of luck" >&2\nexit 3\n')
    gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(fake))
    with pytest.raises(RuntimeError, match="failed \\(3\\):\nfatal: out of luck"):
        _cpp_nl.build(tmp_path / "build")
    args = (fake / "g++.args").read_text().split()
    assert args[:5] == ["-O3", "-shared", "-fPIC", "-std=c++17", str(_cpp_nl.SOURCE)]
    assert not any(a.startswith("-march") for a in args)
    assert not os.listdir(tmp_path / "build")  # nothing half-built is left


def test_build_is_cached_by_source_hash(tmp_path):
    lib = _cpp_nl.build(tmp_path)
    assert lib.parent == tmp_path and lib.name.startswith("libnequip_nl_") and lib.exists()
    mtime = lib.stat().st_mtime_ns
    assert _cpp_nl.build(tmp_path) == lib and lib.stat().st_mtime_ns == mtime
