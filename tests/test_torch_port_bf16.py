"""The bfloat16 fast mode of the port (``enable_bf16_fast_mode``) on the CPU.

* (a) The flagship with the golden's parameters (``tests/torch_port_golden.py``)
  in bf16 on its 108-atom frame, through the port's routes ``"torch"``
  (plain PyTorch in bf16) and ``"fused"`` (the kernels' plain twins) and
  the JAX package's ``xla`` and ``pallas_fused`` (interpret), each against
  the float64 golden at JAX's own bf16 gate: energy rel 1e-3, forces 2e-2
  of max|F| (``tests/integration/test_deploy.py``).  Each route's error is
  printed beside JAX's.
* (b) The plain twins of K1, K2 (both variants), the dW reduction and K3
  on bf16 inputs, against the same function in float64 on the bf16-rounded
  inputs, rounded at the kernels' stated points (K1: w and the output; K2:
  h, w and the outputs, and in the training variant the per-edge factors
  dW_e, h_e and dh_pre_e, whose sums dw1/dw2 are float32; K3: the output),
  within one bf16 ulp of max|out|; and against the JAX Pallas kernels in
  bf16 (interpret mode), the VJP with respect to the radial-MLP weights
  included, within ``JAX_BF16_TOL`` (the JAX kernels round more often:
  they sum chunks of messages, each path's products and dw1/dw2 in bf16
  and round W1 alpha0 and W2 alpha1 to bf16).  K1's bf16 split of
  destinations across tiles (four carry rows a tile) is modelled in numpy,
  as ``test_torch_port_kernels.py`` models f32's.
* (c) A bf16 model's parameters are float32; a JAX bf16 parameter tree
  loads; float32 -> bfloat16 -> float32 through ``modify_model_dtype``
  gives the float32 outputs back bitwise.
* (d) What bf16 refuses: the kernels with no bf16 form (the
  microbenchmarks and the neighbour list: ``build.entry_point`` raises
  ``TypeError``) and the compile self-check (no bf16 tolerance, as in JAX:
  ``KeyError``); what runs now that every conv kernel has a bf16 form
  (``tests/test_torch_port_bf16_tri.py`` holds the training steps to JAX):
  rr training on the ``"fused"`` route (K2's training variant and the dW
  reduction), the ``"fused_tp"`` route, the depth-2 radial MLP and fr over
  edge slices.
* (e) A bf16 calculator request and a few host-loop MD steps run, with
  finite float64 forces.

The card runs the bf16 kernels against these twins
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phase 16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.data import _keys as j_keys
from nequip_tpu.data import batched_from_list as j_batched
from nequip_tpu.data import compute_neighborlist_ as j_nl
from nequip_tpu.data import pad_batch as j_pad
from nequip_tpu.data import to_device as j_to_device
from nequip_tpu.ops.pallas.tp_scatter import pallas_scatter_sum

from nequip_tpu_torch.data import _keys
from nequip_tpu_torch.integrations import MDDriver, NequIPCalculator, VelocityVerlet
from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params
from nequip_tpu_torch.model.jax_params import flatten_tree
from nequip_tpu_torch.model.modify_utils import modify
from nequip_tpu_torch.ops.kernels import build
from nequip_tpu_torch.ops.kernels import tp_scatter as K
from nequip_tpu_torch.utils.dtype import model_tolerance, param_dtype
from test_torch_port_cuda import DENSE_TILE_CASES
from test_torch_port_kernels import _port_stream, _problem
from torch_port_golden import GOLDEN, JITTER, N_ATOMS

BF16 = torch.bfloat16
E_TOL, F_TOL = 1e-3, 2e-2  # JAX's bf16 gate against float64 (tests/integration/test_deploy.py)
# port twin against JAX's Pallas kernel, both bf16, of max|out|: each JAX
# rounding (a bf16 chunk sum, a bf16 path sum, W alpha in bf16) moves an
# output by up to half an ulp of the value it rounds, a few of them a sum;
# measured at most 8.9e-3 (two ulps of max|out|, dx) on this problem
JAX_BF16_TOL = 3e-2
FLAGSHIP = dict(type_names=["Cu"], r_max=4.0, num_layers=3, l_max=2, parity=False, num_features=32,
                avg_num_neighbors=18.0, per_type_energy_shifts={"Cu": -3.5}, per_type_energy_scales={"Cu": 0.5})
SMALL = dict(FLAGSHIP, num_layers=2, num_features=8, radial_mlp_width=16)
EXACT = ("pos", "cell", "pbc", "atomic_numbers")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    z = np.load(GOLDEN)
    return z, {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}


def _unflatten(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        *parents, leaf = k.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _gap(energy, forces, z):
    return (abs(float(energy) - float(z["energy"])) / abs(float(z["energy"])),
            float(np.abs(np.asarray(forces, dtype=np.float64)[:N_ATOMS] - z["forces"]).max())
            / float(np.abs(z["forces"]).max()))


@pytest.fixture(scope="module")
def jax_golden_errors(golden):
    """JAX's own bf16 errors against the golden: xla and pallas_fused
    (interpret), with the golden's parameters as float32, the tree a JAX
    bf16 model keeps."""
    from __graft_entry__ import _fcc_frame, _flagship_model

    z, flat = golden
    params = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), _unflatten(flat))
    nl = j_nl(dict(_fcc_frame(N_ATOMS, seed=0, jitter=JITTER)), 4.0, backend="kdtree")
    n_edges = nl[j_keys.EDGE_INDEX_KEY].shape[1]
    batch = j_to_device(j_pad(j_batched([nl]), 128, ((n_edges + 255) // 256) * 256, 2))
    out = {}
    for impl in ("xla", "pallas_fused"):
        res = jax.jit(_flagship_model("bfloat16", tp_impl=impl))(params, batch)
        out[impl] = _gap(np.asarray(res[j_keys.TOTAL_ENERGY_KEY]).reshape(-1)[0], res[j_keys.FORCE_KEY], z)
    return out


# --- (a) the golden ------------------------------------------------------------------
@pytest.mark.parametrize("tp_impl", ["torch", "fused"])
def test_bf16_flagship_meets_jax_gate_on_golden(golden, jax_golden_errors, tp_impl):
    z, flat = golden
    model = NequIPGNNModel(seed=0, model_dtype="float64", tp_impl=tp_impl, **FLAGSHIP)
    load_jax_params(model, flat)
    model = modify(model, [{"modifier": "enable_bf16_fast_mode"}])
    assert model.metadata["model_dtype"] == "bfloat16"
    res = NequIPCalculator.from_model(model, device="cpu").calculate({k: z[k] for k in EXACT})
    e_err, f_err = _gap(res["energy"], res["forces"], z)
    print(f"bf16 against the f64 golden: port {tp_impl}: E rel {e_err:.2e}, F {f_err:.2e} of max|F|; "
          + "; ".join(f"JAX {k}: E rel {e:.2e}, F {f:.2e}" for k, (e, f) in jax_golden_errors.items()))
    assert e_err <= E_TOL and f_err <= F_TOL
    for e, f in jax_golden_errors.values():
        assert e <= E_TOL and f <= F_TOL


# --- (b) the plain twins on bf16 inputs ---------------------------------------------------
def _ulp(ref: np.ndarray) -> float:
    """One bf16 ulp at max|ref| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _bf16(a) -> np.ndarray:
    """Float64 values rounded to bf16 (the nearest, ties to even)."""
    return K._bf16_nearest(torch.as_tensor(np.asarray(a, dtype=np.float64))).double().numpy()


def _bf16_problem(seed=0):
    """The kernel test problem (``test_torch_port_kernels``) in bf16: its
    port stream, plan, alphas and bf16 operands, and the operands' bf16
    values in float64 for the references."""
    p = _problem(False)
    data, _ = _port_stream(p)
    lay = data[K.LAYOUT_KEY]
    plan = K.TPPlan(p["tp"])
    a0, a1 = p["mlp"].alphas
    b = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64).to(BF16)  # noqa: E731
    ops = dict(x=b(p["x"]), sh=b(data[_keys.EDGE_ATTRS_KEY].numpy()), emb=b(data[_keys.EDGE_EMBEDDING_KEY].numpy()),
               w1=b(p["mlp_params"]["w0"]), w2=b(p["mlp_params"]["w1"]))
    g = b(np.random.RandomState(seed + 9).standard_normal((p["n_nodes"], plan.mid_dim)))
    return p, plan, (a0, a1), lay, ops, g


def _ref_radial(emb, w1, w2, a0, a1, n):
    """h and w in float64 from bf16 values, each rounded where the kernels round."""
    pre = emb[:n] @ (w1 * a0)
    return pre, pre / (1 + np.exp(-pre))


def test_bf16_conv_fwd_twin_rounds_once():
    p, plan, (a0, a1), lay, ops, _ = _bf16_problem()
    got = K.conv_fwd_plain(plan, *ops.values(), a0, a1, lay)
    assert got.dtype == BF16
    v = {k: t.double() for k, t in ops.items()}
    n = lay.n_real
    _, h = _ref_radial(v["emb"].numpy(), v["w1"].numpy(), v["w2"].numpy(), a0, a1, n)
    w = torch.as_tensor(_bf16(h @ (v["w2"].numpy() * a1)))  # K1 rounds w; h stays wide
    tab = plan.device_tables(torch.device("cpu"), torch.float64)
    msg = K._table_tp(tab, v["x"][lay.edge_src[:n].long()], v["sh"][:n], w)
    ref = _bf16(torch.zeros(lay.num_nodes, plan.mid_dim, dtype=torch.float64).index_add_(
        0, K._segment_rows(lay.dst_ptr), msg).numpy())
    assert np.abs(got.double().numpy() - ref).max() <= _ulp(ref)


def test_bf16_conv_bwd_twin_rounds_at_its_points():
    p, plan, (a0, a1), lay, ops, g = _bf16_problem()
    got = K.conv_bwd_plain(plan, *ops.values(), a0, a1, lay, g)
    v = {k: t.double().numpy() for k, t in ops.items()}
    n = lay.n_real
    pre, h = _ref_radial(v["emb"], v["w1"], v["w2"], a0, a1, n)
    w = _bf16(_bf16(h) @ (v["w2"] * a1))  # K2 rounds h and w
    tab = plan.device_tables(torch.device("cpu"), torch.float64)
    src, dst = lay.edge_src[:n].long(), K._segment_rows(lay.dst_ptr)
    dx, dsh, dw = K._table_tp_vjp(tab, torch.as_tensor(v["x"])[src], torch.as_tensor(v["sh"][:n]),
                                  torch.as_tensor(w), g.double()[dst])
    s = 1 / (1 + np.exp(-pre))
    dh = (dw.numpy() @ (v["w2"] * a1).T) * (s * (1 + pre * (1 - s)))
    refs = [dx.numpy(), dsh.numpy(), dh @ (v["w1"] * a0).T]
    for out, ref in zip(got, refs):
        assert out.dtype == BF16
        assert not out[n:].any()
        ref = _bf16(ref)
        assert np.abs(out[:n].double().numpy() - ref).max() <= _ulp(ref)


def test_bf16_conv_bwd_train_twin_rounds_at_its_points():
    """K2's training twin in bf16: its dx, dsh and demb are bitwise the
    inference twin's; its dw1/dw2 are float32 sums of the per-edge factors
    rounded to bf16 where the kernel stores them (h_e, dW_e, dh_pre_e),
    within one bf16 ulp of max|dw| of the same in float64 (a factor near a
    rounding boundary may land one ulp apart) and, for the twin's own
    factors, the float64 sum rounded once to float32."""
    p, plan, (a0, a1), lay, ops, g = _bf16_problem()
    got = K.conv_bwd_train_plain(plan, *ops.values(), a0, a1, lay, g)
    for a, b in zip(got[:3], K.conv_bwd_plain(plan, *ops.values(), a0, a1, lay, g)):
        assert a.dtype == BF16 and torch.equal(a, b)
    v = {k: t.double().numpy() for k, t in ops.items()}
    n = lay.n_real
    pre, h = _ref_radial(v["emb"], v["w1"], v["w2"], a0, a1, n)
    h = _bf16(h)
    w = _bf16(h @ (v["w2"] * a1))
    tab = plan.device_tables(torch.device("cpu"), torch.float64)
    src, dst = lay.edge_src[:n].long(), K._segment_rows(lay.dst_ptr)
    _, _, dw = K._table_tp_vjp(tab, torch.as_tensor(v["x"])[src], torch.as_tensor(v["sh"][:n]),
                               torch.as_tensor(w), g.double()[dst])
    s = 1 / (1 + np.exp(-pre))
    dh_pre = (dw.numpy() @ (v["w2"] * a1).T) * (s * (1 + pre * (1 - s)))
    refs = [a0 * v["emb"][:n].T @ _bf16(dh_pre), a1 * h.T @ _bf16(dw.numpy())]
    for out, ref in zip(got[3:], refs):
        assert out.dtype == torch.float32 and out.shape == ref.shape
        assert np.abs(out.double().numpy() - ref).max() <= _ulp(ref)


@pytest.mark.parametrize("n", [0, 1, 37, 300])
def test_bf16_dw_reduce_twin_rounds_once(n):
    """The dW reduction's twin on bf16 factors: the float64 sum, scaled,
    rounded to float32 once (the kernel sums in float32); float32 zeros for
    n = 0."""
    r = np.random.RandomState(n)
    a, b = (torch.as_tensor(r.standard_normal((300, q))).to(BF16) for q in (8, 40))
    got = K.dw_reduce(a, b, 0.37, n)
    want = (0.37 * (a.double().numpy()[:n].T @ b.double().numpy()[:n])).astype(np.float32)
    assert got.dtype == torch.float32 and got.shape == (8, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0**-23, atol=0)


def test_bf16_scatter_rows_twin_rounds_once():
    r = np.random.RandomState(3)
    vals = torch.as_tensor(r.standard_normal((1000, 96))).to(BF16)
    idx = r.randint(0, 256, 1000)
    perm = np.argsort(idx, kind="stable")
    ptr = np.concatenate([[0], np.cumsum(np.bincount(idx, minlength=256))])
    got = K.scatter_rows(vals, torch.as_tensor(perm, dtype=torch.int32), torch.as_tensor(ptr, dtype=torch.int32))
    ref = np.zeros((256, 96))
    np.add.at(ref, idx, vals.double().numpy())
    ref = _bf16(ref)
    assert got.dtype == BF16 and np.abs(got.double().numpy() - ref).max() <= _ulp(ref)
    want = pallas_scatter_sum(jnp.asarray(vals.float().numpy(), dtype=jnp.bfloat16), jnp.asarray(idx, jnp.int32), 256)
    want = np.asarray(want, dtype=np.float64)
    assert np.abs(got.double().numpy() - want).max() <= JAX_BF16_TOL * np.abs(want).max()


def test_bf16_conv_twins_match_jax_pallas():
    """K1 forward and its gradients in bf16 against the JAX fused call in
    bf16 (its K1 and K2 Pallas kernels, interpret), on the same bf16 values,
    within JAX_BF16_TOL of max|out|: with frozen radial-MLP weights (the
    serving op: K2's inference variant with K3 for dx), and with weights
    that need gradients (FusedConv: K2's training variant and the dW
    reduction), whose dw1/dw2 JAX's kernel_bwd returns in bf16."""
    p, plan, (a0, a1), lay, ops, g = _bf16_problem()
    order = np.argsort(np.where(p["mask"], p["edge_index"][0], p["n_nodes"]), kind="stable")
    inv = np.argsort(order)
    jb = lambda t: jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)  # noqa: E731

    def call(x_, sh_, emb_, w0_, w1_):
        ei = jnp.asarray(p["edge_index"], dtype=jnp.int32)
        from nequip_tpu.ops.pallas.tp_scatter import fused_tp_scatter_mlp as j_fused

        return j_fused(p["jtp"], p["mlp"], x_, sh_, emb_, {"w0": w0_, "w1": w1_}, ei[0], ei[1],
                       jnp.asarray(p["mask"]), p["n_nodes"])

    jx, jsh, jemb = jb(ops["x"]), jb(ops["sh"])[inv], jb(ops["emb"])[inv]  # the JAX stream is the original order
    want, vjp = jax.vjp(call, jx, jsh, jemb, jb(ops["w1"]), jb(ops["w2"]))
    jdx, jdsh, jdemb, jdw1, jdw2 = vjp(jb(g))
    assert jdw1.dtype == jdw2.dtype == jnp.bfloat16
    for train in (False, True):
        x, sh, emb, w1, w2 = (ops[k].clone().requires_grad_(k in ("x", "sh", "emb") or train)
                              for k in ("x", "sh", "emb", "w1", "w2"))
        out = K.fused_tp_scatter_mlp(plan, x, sh, emb, w1, w2, a0, a1, lay)
        grads = torch.autograd.grad(out, (x, sh, emb, w1, w2) if train else (x, sh, emb), g)
        pairs = [(out, want), (grads[0], jdx), (grads[1], jnp.asarray(jdsh)[order]),
                 (grads[2], jnp.asarray(jdemb)[order])]
        if train:
            pairs += [(grads[3], jdw1), (grads[4], jdw2)]
        for got, ref in pairs:
            assert got.dtype == BF16
            ref = np.asarray(ref, dtype=np.float64)
            got = got.detach().double().numpy()
            assert np.isfinite(got).all()
            assert np.abs(got - ref).max() <= JAX_BF16_TOL * np.abs(ref).max()


def _tile_split_sum_bf16(dst_ptr, msg, tile):
    """K1's bf16 split of destinations across tiles (conv_fwd.cu), modelled
    in numpy: each tile sums every segment in edge order; the segment that
    continues into the next tile goes to carry slot 0 of its tile, the
    first segment when it began in an earlier tile to slot 1, every other
    segment to out; then, per node, zero rows where no edge is and carry[t0]
    [0] + ... + carry[t1 - 1][0] + carry[t1][1] where the edges span tiles
    t0 < t1.  Every slot is written at most once, every row once."""
    n_nodes, n_real = len(dst_ptr) - 1, int(dst_ptr[-1])
    out = np.full((n_nodes, msg.shape[1]), np.nan)
    carry = np.full((K.conv_fwd_carry_rows(n_real, tile, BF16) // 4, 2, msg.shape[1]), np.nan)
    dst = np.searchsorted(dst_ptr, np.arange(n_real), side="right") - 1
    for t in range(carry.shape[0]):
        base = t * tile
        cnt = min(tile, n_real - base)
        head = dst_ptr[dst[base]] < base
        ends = [e for e in range(cnt) if e == cnt - 1 or dst[base + e + 1] != dst[base + e]]
        start = 0
        for e in ends:
            run = msg[base + start: base + e + 1].sum(axis=0)
            d = dst[base + e]
            if e == cnt - 1 and dst_ptr[d + 1] > base + cnt:
                slot = carry[t, 0]
            elif e == ends[0] and head:
                slot = carry[t, 1]
            else:
                slot = out[d]
            assert np.isnan(slot).all()
            slot[:] = run
            start = e + 1
    for n in range(n_nodes):
        b, e = dst_ptr[n], dst_ptr[n + 1]
        if b == e:
            out[n] = 0.0
            continue
        t0, t1 = b // tile, (e - 1) // tile
        if t0 != t1:
            assert np.isnan(out[n]).all()
            out[n] = sum(carry[t, 0] for t in range(t0, t1)) + carry[t1, 1]
    return out


@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("case", list(DENSE_TILE_CASES))
def test_conv_fwd_bf16_tile_split_sums_every_segment(case, tile):
    degrees = np.asarray(DENSE_TILE_CASES[case][1] + [0] * 3)
    dst_ptr = np.concatenate([[0], np.cumsum(degrees)])
    msg = np.random.RandomState(4).standard_normal((int(dst_ptr[-1]), 5))
    want = np.zeros((len(degrees), 5))
    np.add.at(want, np.repeat(np.arange(len(degrees)), degrees), msg)
    got = _tile_split_sum_bf16(dst_ptr, msg, tile)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_bf16_nearest_rounds_float64_once():
    """The twins' float64 -> bf16 rounding is correct where a cast through
    float32 rounds twice."""
    x = torch.tensor([1 + 2**-8 + 2**-30, 1 + 2**-8 - 2**-30, 1 + 2**-8, -(1 + 2**-8 + 2**-30), 13.84374975357469],
                     dtype=torch.float64)
    want = [1 + 2**-7, 1.0, 1.0, -(1 + 2**-7), 13.8125]
    assert K._bf16_nearest(x).double().tolist() == want
    assert x.to(BF16).double().tolist()[0] == 1.0  # torch's cast rounds twice


# --- (c) parameters and conversions ------------------------------------------------------
def test_bf16_model_holds_float32_parameters_and_loads_a_jax_bf16_tree():
    from nequip_tpu.model import NequIPGNNModel as JModel

    assert param_dtype("bfloat16") == torch.float32 and param_dtype("float64") == torch.float64
    model = NequIPGNNModel(seed=0, model_dtype="bfloat16", tp_impl="fused", **SMALL)
    assert {t.dtype for _, t in model.jax_named_tensors() if t.dtype != torch.float64} == {torch.float32}
    tree = jax.tree.map(np.asarray, JModel(seed=0, model_dtype="bfloat16", tp_impl="xla", **SMALL).init_params())
    load_jax_params(model, tree)
    got = dict(model.jax_named_tensors())
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(got[k].detach().numpy(), v.astype(got[k].detach().numpy().dtype), err_msg=k)
    # a tree whose float32 leaves were cast to bf16 (ml_dtypes arrays) loads, widened exactly
    flat16 = {k: np.asarray(jnp.asarray(v, dtype=jnp.bfloat16)) if got[k].dtype == torch.float32 else v
              for k, v in flatten_tree(tree).items()}
    load_jax_params(model, flat16)
    for k, v in flat16.items():
        np.testing.assert_array_equal(got[k].detach().numpy(), v.astype(np.float64).astype(got[k].detach().numpy().dtype), err_msg=k)


def _small_frame(reps=2, seed=0):
    r = np.random.RandomState(seed)
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a for i in range(reps) for j in range(reps) for k in range(reps)])
    return {"pos": pos + r.normal(0, 0.1, pos.shape), "cell": np.diag([reps * a] * 3), "pbc": np.array([True] * 3),
            "atomic_numbers": np.full(len(pos), 29)}


def test_float32_bf16_float32_round_trip_is_bitwise():
    f32 = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **SMALL)
    back = modify(f32, [{"modifier": "enable_bf16_fast_mode"},
                        {"modifier": "modify_model_dtype", "model_dtype": "float32"}])
    assert back.metadata["model_dtype"] == "float32"
    for (k, a), (_, b) in zip(f32.jax_named_tensors(), back.jax_named_tensors()):
        assert torch.equal(a, b), k
    frame = _small_frame()
    want = NequIPCalculator.from_model(f32, device="cpu").calculate(frame)
    got = NequIPCalculator.from_model(back, device="cpu").calculate(frame)
    assert got["energy"] == want["energy"]
    for k in ("forces", "stress"):
        np.testing.assert_array_equal(got[k], want[k])


# --- (d) refusals ---------------------------------------------------------------------------
def _bf16_batch(model):
    from nequip_tpu_torch.data import batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
    from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper

    frame = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(_small_frame())), 4.0)
    batch = to_tensors(pad_batch(batched_from_list([frame]), 64, 2048, 2), "cpu")
    return K.relayout_edge_stream(batch) if model.uses_fused_kernels else batch


GRAD_TOL = 0.1  # of a tensor's max|grad|: the bf16 training gate (tests/test_torch_port_bf16_tri.py)


@pytest.mark.parametrize("case", ["fused_tp", "depth2_fused", "training", "fr_chunked"])
def test_bf16_refuses_what_has_no_kernel(case):
    """What bf16 once refused runs now, each on its kernels' twins, within
    a sanity bound of the same model in float32 (forces 5e-2 of max|F|,
    energy 5e-3 eV an atom; the golden tests hold bf16 to JAX's gate): the
    ``"fused_tp"`` route and the depth-2 radial MLP (K4's route) serving
    frozen weights, the forward of fr training over 2 edge slices (K4-acc),
    and ``training``, a rr step on the ``"fused"`` route (K1, K2's training
    variant and the dW reduction, second order through K4 and K5), whose
    float32 gradients of a force and energy loss lie within 0.1 of the
    float32 model's max|grad| for each tensor."""
    kw = dict(SMALL, radial_mlp_depth=2) if case == "depth2_fused" else SMALL
    tp_impl = "fused_tp" if case == "fused_tp" else "fused"
    f32 = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl=tp_impl, **kw)
    model = modify(f32, [{"modifier": "enable_bf16_fast_mode"}])
    batch = _bf16_batch(model)
    routes = {m.route for m in model.modules() if hasattr(m, "route")}
    assert routes == ({"fused"} if case in ("fr_chunked", "training") else {"fused_tp"})
    outs, grads = [], []
    for m in (f32, model):
        if case == "fr_chunked":
            for b in m.modules():
                if hasattr(b, "fr_edge_chunks"):
                    b.fr_edge_chunks = 2
        elif case != "training":
            m.requires_grad_(False)
        res = m(batch)
        if case == "training":
            ((res["forces"] ** 2).sum() + res["total_energy"].sum()).backward()
            grads.append({k: p.grad for k, p in m.named_parameters() if p.grad is not None})
        outs.append({k: v.detach() for k, v in res.items() if k in ("forces", "total_energy")})
    want, got = outs
    n = int(batch["num_atoms"].sum())
    assert got["forces"].dtype == torch.float64 and bool(got["forces"].isfinite().all())
    scale = float(want["forces"][:n].abs().max())
    assert float((got["forces"][:n] - want["forces"][:n]).abs().max()) <= 5e-2 * scale
    assert abs(float(got["total_energy"].sum()) - float(want["total_energy"].sum())) <= 5e-3 * n
    if case == "training":
        want_g, got_g = grads
        assert set(got_g) == set(want_g) and got_g
        for k, gr in got_g.items():
            assert gr.dtype == torch.float32 and bool(gr.isfinite().all()), k
            assert float((gr - want_g[k]).abs().max()) <= GRAD_TOL * float(want_g[k].abs().max()) + 1e-30, k


@pytest.mark.parametrize("name", ["nequip_mb_fwd", "nequip_mb_bwd", "nequip_device_nl"])
def test_entry_point_refuses_bf16_without_a_kernel(name):
    """Raised before the library loads (there is no nvcc here), naming the
    kernels that have bf16 forms: the microbenchmarks run in float32 only
    (the JAX tools build float32 operands), the neighbour list in float32
    or float64."""
    with pytest.raises(TypeError, match=f"{name}: no bfloat16 kernel.*nequip_conv_bwd_train.*nequip_dw_reduce.*"
                                        "microbenchmarks run in float32 only"):
        build.entry_point(name, BF16)
    assert set(build.BF16) == {
        "nequip_conv_fwd", "nequip_conv_fwd_tile", "nequip_conv_bwd", "nequip_conv_bwd_train", "nequip_dw_reduce",
        "nequip_scatter_rows", "nequip_tri_fwd", "nequip_tri_fwd_acc", "nequip_tri_fwd_tile", "nequip_tri_bwd",
        "nequip_jvp_fwd", "nequip_jvp_fwd_acc", "nequip_jvp_fwd_tile", "nequip_jvp_bwd",
    }


@pytest.mark.parametrize("name", ["nequip_conv_bwd_train", "nequip_dw_reduce"])
def test_training_entry_points_have_bf16_forms(name):
    """K2's training variant and the dW reduction are instantiated for bf16
    too (``build.BF16``), with the float32 forms' C signatures: the
    launches of every dtype share their wrappers."""
    assert name in build.BF16 and name in build._SIGNATURES
    assert build._SIGNATURES[name][-1] is build._P and build._D in build._SIGNATURES[name]


@pytest.mark.parametrize("name", ["nequip_tri_fwd", "nequip_tri_fwd_acc", "nequip_tri_fwd_tile", "nequip_tri_bwd",
                                  "nequip_jvp_fwd", "nequip_jvp_fwd_acc", "nequip_jvp_fwd_tile", "nequip_jvp_bwd"])
def test_trilinear_entry_points_have_bf16_forms(name):
    """The trilinear kernels' entry points are instantiated for bf16 too
    (``build.BF16``), with the float32 forms' C signatures: the launches of
    every dtype share their wrappers."""
    assert name in build.BF16 and name in build._SIGNATURES
    sig = build._SIGNATURES[name]
    if name.endswith("_tile"):
        assert sig == [build._I] * 4
    else:
        assert sig[-1] is build._P and all(t in (build._P, build._I) for t in sig)


def test_compile_self_check_has_no_bf16_tolerance():
    """As in JAX (``nequip_tpu/scripts/compile.py:124-126`` looks up
    ``model_tolerance(bfloat16)``, which has no entry): a KeyError, here
    with a message naming ``--no-check``, asked before anything is
    exported."""
    assert model_tolerance("float32") == 5e-5
    with pytest.raises(KeyError, match="no-check"):
        model_tolerance("bfloat16")


# --- (e) serving and MD ---------------------------------------------------------------------
def test_bf16_serves_and_runs_md():
    model = modify(NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **SMALL),
                   [{"modifier": "enable_bf16_fast_mode"}])
    frame = _small_frame()
    res = NequIPCalculator.from_model(model, device="cpu").calculate(frame)
    assert res["forces"].dtype == np.float64 and np.isfinite(res["forces"]).all() and np.isfinite(res["energy"])
    n = len(frame["pos"])
    md_frame = {"pos": frame["pos"], "cell": frame["cell"], "pbc": frame["pbc"], "atom_types": np.zeros(n, dtype=int)}
    driver = MDDriver(model, md_frame, VelocityVerlet(dt_fs=2.0), masses=np.full(n, 63.5), device="cpu",
                      integration="host")
    out = driver.run(5, velocities=0.01 * np.random.RandomState(1).standard_normal((n, 3)))
    for k in ("positions", "velocities", "forces"):
        assert out[k].dtype == np.float64 and np.isfinite(out[k]).all(), k
