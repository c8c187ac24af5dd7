"""The port's microbenchmark slice against the JAX tools, on the CPU.

T1-T4 are closures inside ``tools/kernel_microbench.py:main``, so their
outputs are captured by running that tool's ``main`` (interpret mode, on
the CPU) with ``jax.jit`` wrapped to record each jitted function's last
arguments and output, in creation order.  The port's ``run`` (plain
versions on the CPU) must give the same 14 outputs at 1e-5 max|ref| (f32:
the JAX tool is f32 only, and the default precision is f32 on the CPU on
both sides; sums in another order).  T5 (``pallas_row_gather``) runs in
interpret mode and must equal the port's ``row_gather`` bitwise: a gather
is a copy.
"""

import contextlib
import functools
import importlib.util
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.ops import Irreps as JIrreps
from nequip_tpu.ops import TensorProduct as JTP
from nequip_tpu.ops import uvu_instructions as j_uvu
from nequip_tpu_torch.ops.kernels import microbench as MB
from nequip_tpu_torch.ops.kernels.row_gather import row_gather
from nequip_tpu_torch.ops.kernels.tp_scatter import KERNELS, reset_launch_counts
from nequip_tpu_torch.tools import gather_microbench as GM
from nequip_tpu_torch.tools import kernel_microbench as KM

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--grid", "3", "--rows", "8", "--be", "16", "--reps", "1"]
# the JAX tool's jitted functions, in creation order
NAMES = [f"{v} {p}" for v in MB.FWD_VARIANTS for p in ("HIGHEST", "DEFAULT")] + ["cgvjp (bwd core)"] + [
    f"{v} DEFAULT" for v in MB.FWD_T_VARIANTS] + ["cgvjp_t (bwd core)"]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    """(slots, stdout) of the JAX kernel microbench at SMALL: one slot per
    jitted function with its last ``args`` and ``out``."""
    mod = _load_tool("kernel_microbench")
    slots, jit = [], jax.jit

    def recording_jit(fn, *a, **k):
        jitted, slot = jit(fn, *a, **k), {}
        slots.append(slot)

        def call(*args):
            slot["args"], slot["out"] = args, jitted(*args)
            return slot["out"]

        return call

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(mod.jax, "jit", recording_jit)
        mp.setattr(sys, "argv", ["kernel_microbench.py", "--cpu", *SMALL])
        mod.main()
    assert len(slots) == len(NAMES)
    return slots, buf.getvalue()


@pytest.fixture(scope="module")
def port_tool():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = KM.run(KM.parse_args(["--device", "cpu", *SMALL]))
    return {r["name"]: r for r in results}, buf.getvalue()


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_kernel_microbench_matches_jax_tool(jax_tool, port_tool, i):
    ref = np.asarray(jax_tool[0][i]["out"])
    got = port_tool[0][NAMES[i]]["out"]
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))


def test_kernel_microbench_prints_the_jax_tools_lines(jax_tool, port_tool):
    def variants(text):
        return [ln.split(":")[0] for ln in text.splitlines() if ln.split(":")[0] in NAMES]

    assert variants(port_tool[1]) == variants(jax_tool[1]) == NAMES
    lines = port_tool[1].splitlines()
    assert lines[0].startswith("device: cpu") and lines[1].startswith("dims: in=288 mid=992 WN=288")
    assert lines[-1].startswith("theory: dot") and "67TF/s" in lines[-1] and "495TF/s" in lines[-1]


def test_make_inputs_equal_the_jax_tools_arrays(jax_tool):
    slots = jax_tool[0]
    plan, a = KM.make_inputs(8, 16)
    assert (plan.dim_in, plan.sh_dim, plan.mid_dim, plan.weight_numel) == (288, 9, 992, 288)
    fwd, bwd, fwd_t, bwd_t = (slots[NAMES.index(n)]["args"] for n in
                              ("full HIGHEST", "cgvjp (bwd core)", "full_t DEFAULT", "cgvjp_t (bwd core)"))
    want = {
        "x": fwd[0], "y": fwd[1], "emb": fwd[2], "rel": np.asarray(fwd[3]).reshape(-1), "w1": fwd[4], "w2": fwd[5],
        "g": bwd[2], "w": bwd[3], "x_t": fwd_t[4], "y_t": fwd_t[5], "w_t": fwd_t[6], "w1_t": fwd_t[7],
        "w2_t": fwd_t[8], "g_t": bwd_t[2],
    }
    assert set(a) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert a[k].dtype == v.dtype and np.array_equal(a[k], v), k


def _ops_f64(rows=8, be=16):
    plan, a = KM.make_inputs(rows, be)
    return plan, KM.to_tensors(a, "cpu", torch.float64)


@pytest.mark.parametrize("layout", ["r", "t"])
def test_chunk_bwd_dy_dw_match_autograd_and_jax_f64(layout):
    """dx, dy and dw of T2/T4 (the JAX tool returns dx only) against
    torch.autograd of the port's TP and jax.vjp of the JAX TP, f64."""
    plan, ops = _ops_f64()
    got = MB.chunk_bwd(plan, ops, grid=3, layout=layout)
    t = layout == "t"
    x, y, g, w = (ops[n + ("_t" if t else "")] for n in ("x", "y", "g", "w"))
    x, y, g, w = (a.t() if t else a for a in (x, y, g, w))
    _, vjp = torch.func.vjp(plan.tp, x, y, w)
    feats, sh = JIrreps("32x0e+32x1e+32x2e"), JIrreps.spherical_harmonics(2)
    jtp = JTP(feats, sh, *j_uvu(feats, sh, feats), shared_weights=False)
    _, jvjp = jax.vjp(jtp, *(jnp.asarray(a.numpy()) for a in (x, y, w)))
    for got_i, ref_t, ref_j in zip(got, vjp(g), jvjp(jnp.asarray(g.numpy()))):
        ref_t = ref_t.t() if t else ref_t
        ref_j = np.asarray(ref_j).T if t else np.asarray(ref_j)
        scale = float(ref_t.abs().max())
        torch.testing.assert_close(got_i, ref_t, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(got_i.numpy(), ref_j, rtol=0, atol=1e-12 * scale)


def test_full_equals_full_t_equals_full_t_pre_f64():
    plan, ops = _ops_f64()
    full, full_t, full_t_pre = (MB.chunk_fwd(plan, v, ops, 8, 3) for v in ("full", "full_t", "full_t_pre"))
    scale = float(full.abs().max())
    torch.testing.assert_close(full_t, full, rtol=0, atol=1e-12 * scale)
    torch.testing.assert_close(full_t_pre, full, rtol=0, atol=1e-12 * scale)


def test_tf32_round_is_cvt_rna():
    v = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 3.0e-39], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 3.0e-39], dtype=torch.float32)
    got = MB.tf32_round(v)
    assert torch.equal(got[:5], want[:5])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # DEFAULT with TF32 emulated stays within TF32's ~3 digits of f32
    plan, a = KM.make_inputs(8, 16)
    ops = KM.to_tensors(a, "cpu")
    ref = MB.chunk_fwd_plain(plan, "mlp", ops, 8, 3)
    emu = MB.chunk_fwd_plain(plan, "mlp", ops, 8, 3, tf32=True)
    err = float((emu - ref).abs().max()) / float(ref.abs().max())
    assert 0 < err < 1e-2


def test_tools_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KM.run(KM.parse_args(SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GM.run(GM.parse_args(["--rows", "64", "--src-rows", "64"]))


def test_cpu_wrappers_count_no_launches():
    plan, ops = _ops_f64()
    reset_launch_counts()
    MB.chunk_fwd(plan, "full", ops, 8, 2)
    MB.chunk_bwd(plan, ops, 2, layout="t")
    row_gather(ops["x"], torch.arange(4, dtype=torch.int32))
    assert all(KERNELS[k].launches == 0 for k in ("mb_fwd", "mb_fwd_t", "mb_bwd", "mb_bwd_t", "row_gather"))
    with pytest.raises(ValueError, match="precision"):
        MB.chunk_fwd(plan, "full", ops, 8, 2, prec="HIGH")


# ---------------------------------------------------------------------------
# T5: the row gather
# ---------------------------------------------------------------------------
ROWS, SRC_ROWS, DIM, BLOCK_E, N_BUF = 1024, 1000, 40, 128, 8


@pytest.fixture(scope="module")
def jax_gather():
    mod = _load_tool("gather_microbench")
    return mod, jax.jit(functools.partial(mod.pallas_row_gather, block_e=BLOCK_E, n_buf=N_BUF))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("pattern", GM.PATTERNS)
def test_row_gather_equals_pallas_row_gather(jax_gather, pattern, dtype):
    mod, pallas_gather = jax_gather
    idx = GM.make_idx(pattern, ROWS, SRC_ROWS, BLOCK_E, np.random.RandomState(0))
    idx_j = mod.make_idx(pattern, ROWS, SRC_ROWS, BLOCK_E, np.random.RandomState(0))
    assert idx.dtype == np.int32 and np.array_equal(idx, np.asarray(idx_j))
    assert 0 <= idx.min() and idx.max() < SRC_ROWS
    src = torch.as_tensor(np.random.RandomState(1).standard_normal((SRC_ROWS, DIM))).to(GM.DTYPES[dtype])
    src_j = jnp.asarray(src.double().numpy(), dtype=getattr(jnp, dtype))  # exact: the values are representable
    want = np.asarray(pallas_gather(src_j, idx_j).astype(jnp.float64))
    got = row_gather(src, torch.as_tensor(idx), BLOCK_E, N_BUF)
    assert got.dtype == src.dtype and tuple(got.shape) == (ROWS, DIM)
    assert np.array_equal(got.double().numpy(), want)


def test_gather_tool_runs_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = GM.run(GM.parse_args(["--device", "cpu", "--rows", str(ROWS), "--src-rows", str(SRC_ROWS),
                                        "--dim", str(DIM), "--block-e", str(BLOCK_E), "--pattern", "tilewin"]))
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("device: cpu") and lines[-1] == "parity OK"
    assert sum(ln.startswith("index_select[tilewin]  D=") for ln in lines) == 5
    assert sum(ln.startswith("row_gather kernel  :") for ln in lines) == 3
    assert [r["name"] for r in results][-3:] == [f"row_gather n_buf={n}" for n in (8, 16, 32)]
    assert all(r["ms"] > 0 for r in results)
