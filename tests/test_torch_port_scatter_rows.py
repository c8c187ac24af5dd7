"""K3's bfloat16 launch geometry and its edge-order reference, on the CPU.

bf16 K3 (``csrc/scatter_rows.cu``, ``scatter_rows_bf16_kernel``) packs rows
into warps by a geometry the host computes from D and the values' alignment
alone (``tp_scatter.scatter_rows_geometry``).  A numpy model of the kernel's
map from (thread, pass, vector) to (row, columns) checks that every column of
every row of a block is covered exactly once, by loads the alignment allows.
The card's kernels are bitwise equal to ``scatter_rows_edge_order``, which
is held here against a float32 loop and against the plain twin.  The card
runs the kernel itself (``tests/test_torch_port_cuda.py``).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from nequip_tpu_torch.ops.kernels import build
from nequip_tpu_torch.ops.kernels import tp_scatter as K

BF16 = torch.bfloat16


def _kernel_map(g: K.ScatterGeometry, d: int):
    """(row in the block, column) of every value the kernel's threads load
    and store: thread t is lane t % 32 of warp t // 32; lane = group * lanes
    + sub; a live group (group < 32 // lanes) takes row warp * rows_per_warp
    + group, and in the pass at vector c0 its lane holds vectors c0 + k lanes
    + sub (k < per_lane) below D / vec."""
    nv = d // g.vec
    t = np.arange(K.SCATTER_THREADS)
    lane, warp = t % 32, t // 32
    group, sub = lane // g.lanes, lane % g.lanes
    live = group < g.rows_per_warp
    row = warp * g.rows_per_warp + group
    c0 = np.arange(0, nv, g.lanes * g.per_lane)
    c = c0[:, None, None] + np.arange(g.per_lane)[None, :, None] * g.lanes + sub[None, None, :]
    ok = live[None, None, :] & (c < nv)
    rows = np.broadcast_to(row, c.shape)[ok]
    cols = c[ok][:, None] * g.vec + np.arange(g.vec)[None, :]
    return np.repeat(rows, g.vec), cols.ravel()


@pytest.mark.parametrize("aligned", [True, False])
def test_scatter_rows_geometry_covers_every_column_once(aligned):
    """For D = 1 ... 512 at a 16-byte aligned base and at one that is not:
    16-byte loads exactly where both allow, else 2-byte ones, at most 32
    lanes a row and SCATTER_MAX_PER_LANE vectors a lane, one pass up to 128
    vectors a row, and every (row, column) of a block's rows covered once."""
    assert K.SCATTER_THREADS >= 128 and K.SCATTER_THREADS % 32 == 0
    for d in range(1, 513):
        g = K.scatter_rows_geometry(d, aligned)
        assert g.vec == (8 if aligned and d % 8 == 0 else 1), (d, g)
        assert 1 <= g.lanes <= 32 and 1 <= g.per_lane <= K.SCATTER_MAX_PER_LANE, (d, g)
        nv = d // g.vec
        if nv <= 32 * K.SCATTER_MAX_PER_LANE:
            assert g.lanes * g.per_lane >= nv, (d, g)
        rows, cols = _kernel_map(g, d)
        assert rows.max() < g.rows_per_block and cols.max() < d
        count = np.zeros((g.rows_per_block, d), dtype=np.int64)
        np.add.at(count, (rows, cols), 1)
        assert (count == 1).all(), (d, g)


def test_scatter_rows_geometry_at_the_flagship_widths():
    """The shapes the design names: D = 32 as 8 rows of 4 lanes a warp, 288
    as 3 rows of 9 lanes x 4 vectors, 480 (preset M) as one row of 30 lanes
    x 2, all at 16-byte loads; a base off 16-byte alignment takes 2-byte
    loads, 9 lanes x 4 values for D = 36."""
    assert K.scatter_rows_geometry(32, True) == K.ScatterGeometry(8, 4, 1)
    assert K.scatter_rows_geometry(288, True) == K.ScatterGeometry(8, 9, 4)
    assert K.scatter_rows_geometry(480, True) == K.ScatterGeometry(8, 30, 2)
    assert K.scatter_rows_geometry(288, True).rows_per_block == 12
    assert K.scatter_rows_geometry(288, False).vec == K.scatter_rows_geometry(36, True).vec == 1
    assert K.scatter_rows_geometry(36, False) == K.ScatterGeometry(1, 9, 4)


def test_scatter_rows_source_matches_the_host_geometry():
    """The .cu's block size and per-lane cap are the host's, it instantiates
    every per-lane count up to the cap, and the bf16 C entry point takes the
    geometry (``build._BF16_SIGNATURES``)."""
    src = (build.CSRC / "scatter_rows.cu").read_text()
    assert int(re.search(r"kScatterThreads = (\d+);", src).group(1)) == K.SCATTER_THREADS
    assert int(re.search(r"kScatterMaxK = (\d+);", src).group(1)) == K.SCATTER_MAX_PER_LANE
    for k in range(1, K.SCATTER_MAX_PER_LANE):
        assert f"case {k}:\n      scatter_rows_bf16_kernel<V, {k}>" in src
    assert f"scatter_rows_bf16_kernel<V, {K.SCATTER_MAX_PER_LANE}>" in src
    entry = re.search(r'extern "C" int nequip_scatter_rows_bf16\(([^)]*)\)', src).group(1)
    assert len(entry.split(",")) == len(build._BF16_SIGNATURES["nequip_scatter_rows"])
    assert [a.split()[0] for a in entry.split(",")[6:9]] == ["int"] * 3



@pytest.fixture(scope="module")
def library_geometry(tmp_path_factory):
    """The ops library's copy of the geometry rule (``csrc/scatter_geometry.h``,
    which ``csrc/torch_ops.cpp`` includes), compiled on its own by the host
    compiler, through its C entry."""
    cxx = shutil.which(os.environ.get("CXX", "c++"))
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib = tmp_path_factory.mktemp("geometry") / "libgeometry.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++", str(build.CSRC / "scatter_geometry.h"),
                    "-o", str(lib)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).nequip_scatter_rows_geometry
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)], None

    def geometry(d: int, aligned: bool) -> K.ScatterGeometry:
        out = (ctypes.c_int * 3)()
        fn(d, int(aligned), out)
        return K.ScatterGeometry(*out)

    return geometry


@pytest.mark.parametrize("aligned", [True, False])
def test_ops_library_geometry_matches_the_host_geometry(library_geometry, aligned):
    """The ops library launches bf16 K3 at the package's geometry, at every
    D from 1 to 512 at both alignments, and ``torch_ops.cpp`` takes it from
    the shared header (the library's outputs are then bitwise the package's:
    ``tests/test_torch_port_cuda.py``)."""
    for d in range(1, 513):
        assert library_geometry(d, aligned) == K.scatter_rows_geometry(d, aligned), d
    binding = (build.CSRC / "torch_ops.cpp").read_text()
    assert '#include "scatter_geometry.h"' in binding and "nequip::scatter_rows_geometry(d, " in binding
    assert "kMaxPerLane = 4;" in (build.CSRC / "scatter_geometry.h").read_text() and K.SCATTER_MAX_PER_LANE == 4

def _graph(seed: int, n_rows: int, max_deg: int, n_values: int):
    """A source-sorted CSR over distinct value rows: degrees 0 ... max_deg
    (a quarter of the rows empty), ``perm`` a permutation's prefix."""
    r = np.random.RandomState(seed)
    deg = r.randint(1, max_deg + 1, n_rows) * (r.rand(n_rows) > 0.25)
    ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    perm = r.permutation(n_values)[: ptr[-1]].astype(np.int32)
    return r, torch.as_tensor(perm), torch.as_tensor(ptr)


@pytest.mark.parametrize("d", [1, 24, 36])
def test_scatter_rows_edge_order_is_a_float32_sum_in_edge_order(d):
    """The reference adds each row's values in float32 from +0 in edge order
    and rounds once: bitwise a scalar float32 loop over the segments."""
    r, perm, ptr = _graph(d, 40, 12, 600)
    v = torch.as_tensor(r.standard_normal((600, d)), dtype=torch.float32).to(BF16)
    got = K.scatter_rows_edge_order(v, perm, ptr)
    vals = v.float().numpy()
    want = np.zeros((40, d), dtype=np.float32)
    for n in range(40):
        for j in range(ptr[n], ptr[n + 1]):
            want[n] = (want[n] + vals[perm[j]]).astype(np.float32)
    assert got.dtype == BF16 and torch.equal(got, torch.as_tensor(want).to(BF16))


@pytest.mark.parametrize("d", [8, 96])
def test_scatter_rows_edge_order_matches_plain_in_bf16(d):
    """On a small random graph (empty segments, up to 30 edges a row) the
    edge-order reference and the plain twin (index_add_) differ by the
    order of their float32 sums only: within one bf16 ulp of max|out|."""
    r, perm, ptr = _graph(100 + d, 200, 30, 4000)
    v = torch.as_tensor(r.standard_normal((4000, d)), dtype=torch.float32).to(BF16)
    got, plain = K.scatter_rows_edge_order(v, perm, ptr), K.scatter_rows_plain(v, perm, ptr)
    assert got.dtype == plain.dtype == BF16 and got.shape == plain.shape == (200, d)
    ulp = 2.0 ** (np.floor(np.log2(float(plain.float().abs().max()))) - 7)
    assert float((got.float() - plain.float()).abs().max()) <= ulp
    empty = (ptr[1:] == ptr[:-1]).numpy()
    assert empty.any() and not got[torch.as_tensor(empty)].float().any()
