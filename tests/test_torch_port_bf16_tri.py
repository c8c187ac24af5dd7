"""The trilinear kernels' bfloat16 forms (K4/K4-acc, K5, K6, K7) on the CPU.

On the CPU the wrappers run their plain twins: bf16 operands widened to
float32, float32 products, sums over edges in float64 (the kernels'
compensated float32 sums agree with that to far below a bf16 ulp) and each
output rounded once; K4-acc and K6-acc add onto float32 accumulators, which
the edge-sliced convolutions round to bf16 once, after the last slice.

* (a) The twins against the JAX package's Pallas kernels in bf16 (interpret
  mode), on the same bf16 values, within ``JAX_BF16_TOL`` of max|out|:
  ``fused_tp_scatter`` and ``fused_tp_scatter_bwd`` (K4, K5 and K3) on the
  small problem of ``test_torch_port_kernels.py``, ``chunked_conv`` (K4-acc,
  K5) and ``chunked_jvp_conv`` (K6, K7) with their VJPs on the fr problem
  of ``test_torch_port_fr_kernels.py`` (3 slices).
* (b) Each twin against the same function in float64 on the bf16 values,
  rounded at the kernel's points: within one bf16 ulp of max|out| (the
  accumulators: 1e-6 of max|out|, a few float32 roundings).
* (c) The edge-sliced conv and dual sweep in bf16 agree at C = 2 and C = 4
  with the unsliced K4 and K6 within two bf16 ulps of max|out|.
* (d) A depth-2 model (the options golden's ``depth2``, K4's route) in bf16
  against its float64 golden at JAX's bf16 gate (E rel 1e-3, F 2e-2 of
  max|F|), beside JAX's own bf16 errors on the frame.
* (e) rr steps on both kernel routes (on ``"fused"`` through K2's training
  variant and the dW reduction, once with ``remat_conv="save_tp"``), an
  unsliced fr step on ``"fused"`` and fr steps over 2 edge slices on both
  routes (one with ``remat_conv="save_tp"``), the flagship in bf16 from the
  float32 parameters of the training golden: loss within 1e-3 (relative)
  and every gradient within 0.1 of its tensor's max|grad| of the float64
  golden and of JAX's bf16 step (XLA), whose own errors meet the same
  gates (measured: loss 2.2e-4, gradients 4.2e-2); the gradients are
  float32.  One EMA-ConFIG step on ``"fused"`` in bf16 (its k rr passes
  through the same kernels) gives a finite float32 direction within 0.1 of
  max|grad| of the same step in float32.
* (f) The registered op of the ``"fused_tp"`` route (a traced program's K4
  and K5) takes float32 term tables for bf16 inputs and agrees with the
  eager route.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nequip_tpu.ops.pallas import tp_scatter as J

from nequip_tpu_torch.data import _keys, batched_from_list, compute_neighborlist_, from_dict, pad_batch
from nequip_tpu_torch.data import round_up, to_tensors
from nequip_tpu_torch.data.transforms import ChemicalSpeciesToAtomTypeMapper
from nequip_tpu_torch.model import NequIPGNNModel, jax_named_grads, load_jax_params
from nequip_tpu_torch.model.modify_utils import modify
from nequip_tpu_torch.nn.interaction_block import InteractionBlock
from nequip_tpu_torch.ops.kernels import tp_scatter as K
from nequip_tpu_torch.ops.mlp import ScalarMLP
from nequip_tpu_torch.train import EnergyForceLoss, NequIPTrainModule
from nequip_tpu_torch.utils.config import instantiate, retarget
from test_torch_port_bf16 import E_TOL, F_TOL, FLAGSHIP, JAX_BF16_TOL, _bf16, _ulp, _unflatten
from test_torch_port_fr_kernels import C, HIDDEN, JVP_INS, N_EMB, N_NODES, _slot_to_port, p  # noqa: F401
from test_torch_port_kernels import _port_stream, _problem
from test_torch_port_train_kernels import _g, _jgraph, _weights
from torch_port_golden import GOLDEN
from torch_port_options_golden import GOLDEN as OPTIONS_GOLDEN
from torch_port_options_golden import MODELS
from torch_port_train_golden import TRAIN_GOLDEN

BF16 = torch.bfloat16
LOSS_TOL, GRAD_TOL = 1e-3, 0.1  # a bf16 step against float64 (rel; of each tensor's max|grad|): JAX's own meets them
ACC_TOL = 1e-6  # a float32 accumulator against float64, of max|out|


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _b(a) -> torch.Tensor:
    """float64 values rounded to bf16."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(BF16)


def _jb(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _within(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# --- (a) the twins against JAX's Pallas kernels in bf16 ------------------------------
def test_bf16_tri_fwd_tri_bwd_match_jax_pallas():
    """K4 and K5 (dx through K3) in bf16 against the JAX kernels in bf16."""
    q = _problem(False)
    data, order = _port_stream(q)
    plan, lay = K.TPPlan(q["tp"]), data[K.LAYOUT_KEY]
    x, sh, w, g = _b(q["x"]), _b(q["sh"]), _b(_weights(q)), _b(_g(q))
    out = K.fused_tp_scatter(plan, x, sh[order], w[order], lay)
    dx, dy, dw = K.fused_tp_scatter_bwd(plan, x, sh[order], w[order], lay, g)
    assert {t.dtype for t in (out, dx, dy, dw)} == {BF16}
    want = J.fused_tp_scatter(q["jtp"], _jb(x), _jb(sh), _jb(w), *_jgraph(q))
    jdx, jdy, jdw = J.fused_tp_scatter_bwd(q["jtp"], _jb(x), _jb(sh), _jb(w), *_jgraph(q), _jb(g))
    _within(out.double(), want, JAX_BF16_TOL)
    _within(dx.double(), jdx, JAX_BF16_TOL)
    _within(dy.double(), np.asarray(jdy, dtype=np.float64)[order], JAX_BF16_TOL)
    _within(dw.double(), np.asarray(jdw, dtype=np.float64)[order], JAX_BF16_TOL)


def _bf16_mlp(p):
    """The fr problem's radial MLP with float32 parameters (a bf16 model's)."""
    mlp = ScalarMLP(N_EMB, p["tp"].weight_numel, hidden_layers_depth=1, hidden_layers_width=HIDDEN)
    with torch.no_grad():
        for k in ("w0", "w1"):
            getattr(mlp, k).data = torch.as_tensor(p["mlp_params"][k], dtype=torch.float32)
    return mlp


def _fr_ins(p, names):
    """The fr problem's operands in bf16: node arrays, and per-edge arrays in
    the port's order and in JAX slot order."""
    port = [_b(p["node"][k]) if k in p["node"] else p["port"][k].to(BF16) for k in names]
    jax_ins = [jnp.asarray(p["node"][k] if k in p["node"] else p["slot"][k], dtype=jnp.bfloat16) for k in names]
    return [t.requires_grad_(True) for t in port], jax_ins


def _check_grads(names, grads, jgrads, p):
    for name, a, b in zip(names, grads, jgrads):
        per_edge = name in ("sh", "tsh", "emb", "temb")
        b = _slot_to_port(p, np.asarray(b, dtype=np.float64)) if per_edge else np.asarray(b, dtype=np.float64)
        a = a.double().numpy()[: p["n_real"]] if per_edge else a.double().numpy()
        _within(a, b, JAX_BF16_TOL)


def test_bf16_chunked_conv_matches_jax(p):
    """ChunkedConv in bf16 (K4-acc onto a float32 accumulator, backward K5,
    K3 and the MLP's VJP per slice) against the JAX chunked_conv in bf16
    and its VJP; the MLP's gradients float32."""
    names = ("x", "sh", "emb")
    ins, jins = _fr_ins(p, names)
    g = _b(p["node"]["g"])
    mp = jax.tree.map(lambda a: jnp.asarray(a, dtype=jnp.float32), p["mlp_params"])

    def f(x, sh, emb, mp):
        return J.chunked_conv(p["jtp"], p["jmlp"], mp, x, sh, emb, p["jsrc"], p["jlay"], N_NODES, C)

    want, jgrads = jax.jit(lambda i, ct: (lambda o, pull: (o, pull(ct)))(*jax.vjp(f, *i)))((*jins, mp), _jb(g))
    mlp = _bf16_mlp(p)
    got = K.chunked_conv(p["plan"], mlp, *ins, p["lay"], C)
    assert got.dtype == BF16
    _within(got.detach().double(), want, JAX_BF16_TOL)
    grads = torch.autograd.grad(got, ins + [mlp.w0, mlp.w1], g)
    assert grads[-1].dtype == grads[-2].dtype == torch.float32
    _check_grads(names + ("w0", "w1"), grads, list(jgrads[:3]) + [jgrads[3]["w0"], jgrads[3]["w1"]], p)


def test_bf16_chunked_jvp_conv_matches_jax(p):
    """ChunkedJvpConv in bf16 (K6 onto float32 accumulators; backward K7, K3
    twice and the reverse of the MLP jvp per slice) against the JAX
    chunked_jvp_conv in bf16 and its VJP."""
    ins, jins = _fr_ins(p, JVP_INS)
    cts = tuple(_b(p["node"][k]) for k in ("g", "gt"))
    mp = jax.tree.map(lambda a: jnp.asarray(a, dtype=jnp.float32), p["mlp_params"])

    def f(x, tx, sh, tsh, emb, temb, mp):
        return J.chunked_jvp_conv(p["jtp"], p["jmlp"], mp, x, tx, sh, tsh, emb, temb, p["jsrc"], p["jlay"],
                                  N_NODES, C)

    want, jgrads = jax.jit(lambda i, ct: (lambda o, pull: (o, pull(ct)))(*jax.vjp(f, *i)))(
        (*jins, mp), tuple(map(_jb, cts)))
    mlp = _bf16_mlp(p)
    got = K.chunked_jvp_conv(p["plan"], mlp, *ins, p["lay"], C)
    for a, b in zip(got, want):
        assert a.dtype == BF16
        _within(a.detach().double(), b, JAX_BF16_TOL)
    grads = torch.autograd.grad(got, ins + [mlp.w0, mlp.w1], cts)
    _check_grads(JVP_INS + ("w0", "w1"), grads, list(jgrads[:6]) + [jgrads[6]["w0"], jgrads[6]["w1"]], p)


# --- (b) each twin against float64 at its rounding points ----------------------------
def _tri_problem():
    """The small kernel problem's stream with random bf16 operands of K4-K7
    (node rows, per-slot rows) and random float32 accumulators."""
    q = _problem(False)
    data, _ = _port_stream(q)
    plan, lay = K.TPPlan(q["tp"]), data[K.LAYOUT_KEY]
    r = np.random.RandomState(21)
    n, e = q["n_nodes"], q["mask"].shape[0]
    ops = dict(x=(n, plan.dim_in), tx=(n, plan.dim_in), y=(e, plan.sh_dim), ty=(e, plan.sh_dim),
               w=(e, plan.weight_numel), dw=(e, plan.weight_numel), g=(n, plan.mid_dim), gt=(n, plan.mid_dim))
    ops = {k: _b(r.standard_normal(s)) for k, s in ops.items()}
    acc = tuple(torch.as_tensor(r.standard_normal((n, plan.mid_dim)), dtype=torch.float32) for _ in range(2))
    return plan, lay, ops, acc


def _wide(ops):
    return {k: v.double() for k, v in ops.items()}


def test_bf16_tri_fwd_twin_rounds_once():
    """K4: the float64 sum of the float64 messages, rounded once; K4-acc:
    added onto the float32 accumulator, rounded to float32 once."""
    plan, lay, ops, acc = _tri_problem()
    v = _wide(ops)
    want = K.tri_fwd_plain(plan, v["x"], v["y"], v["w"], lay)
    got = K.tri_fwd_plain(plan, ops["x"], ops["y"], ops["w"], lay)
    assert got.dtype == BF16
    ref = _bf16(want.numpy())
    assert np.abs(got.double().numpy() - ref).max() <= _ulp(ref)
    got_acc = K.tri_fwd_plain(plan, ops["x"], ops["y"], ops["w"], lay, acc[0].clone())
    assert got_acc.dtype == torch.float32
    _within(got_acc, (acc[0].double() + want).numpy(), ACC_TOL)


def test_bf16_jvp_fwd_twin_rounds_once():
    """K6: msg and tmsg each the float64 sum rounded once (without
    accumulators), or added onto the float32 accumulators (with them)."""
    plan, lay, ops, acc = _tri_problem()
    v = _wide(ops)
    names = ("x", "tx", "y", "ty", "w", "dw")
    want = K.jvp_fwd_plain(plan, *(v[k] for k in names), lay)
    got = K.jvp_fwd_plain(plan, *(ops[k] for k in names), lay)
    for a, b in zip(got, want):
        assert a.dtype == BF16
        ref = _bf16(b.numpy())
        assert np.abs(a.double().numpy() - ref).max() <= _ulp(ref)
    got_acc = K.jvp_fwd_plain(plan, *(ops[k] for k in names), lay, tuple(a.clone() for a in acc))
    for a, b, a0 in zip(got_acc, want, acc):
        assert a.dtype == torch.float32
        _within(a, (a0.double() + b).numpy(), ACC_TOL)


@pytest.mark.parametrize("name", ["tri_bwd", "jvp_bwd"])
def test_bf16_tri_bwd_jvp_bwd_twins_round_once(name):
    """K5's three and K7's six per-edge outputs: the float64 VJP on the bf16
    values, each element rounded once; masked slots zero."""
    plan, lay, ops, _ = _tri_problem()
    v = _wide(ops)
    names = ("x", "y", "w") if name == "tri_bwd" else ("x", "tx", "y", "ty", "w", "dw")
    cts = ("g",) if name == "tri_bwd" else ("g", "gt")
    twin = getattr(K, name + "_plain")
    got = twin(plan, *(ops[k] for k in names), lay, *(ops[k] for k in cts))
    want = twin(plan, *(v[k] for k in names), lay, *(v[k] for k in cts))
    for a, b in zip(got, want):
        assert a.dtype == BF16 and not a[lay.n_real:].any()
        ref = _bf16(b.numpy())
        assert np.abs(a.double().numpy() - ref).max() <= _ulp(ref)


def test_bf16_tri_bwd_op_matches_the_twin():
    """The registered op's CPU kernel (K5 from K1's tables, no autograd) on
    bf16 inputs with float32 tables: the twin's outputs, each rounded once."""
    plan, lay, ops, _ = _tri_problem()
    tables = plan.device_tables(torch.device("cpu"), torch.float32).values()
    got = torch.ops.nequip_torch.tri_bwd(ops["x"], ops["y"], ops["w"], ops["g"], lay.edge_src, lay.dst_ptr, *tables)
    want = K.tri_bwd_plain(plan, ops["x"], ops["y"], ops["w"], lay, ops["g"])
    for a, b in zip(got, want):
        assert a.dtype == BF16
        ref = b.double().numpy()
        assert np.abs(a.double().numpy() - ref).max() <= _ulp(ref)


# --- (c) the slice count ---------------------------------------------------------------
@pytest.mark.parametrize("n_chunks", [2, 4])
def test_bf16_sliced_conv_and_dual_sweep_agree_across_slice_counts(p, n_chunks):
    """The conv over C slices (K4-acc onto one float32 accumulator, rounded
    once) against the unsliced K4, and the dual sweep over C slices (K6-acc)
    against the unsliced K6, on the same bf16 radial weights: within two
    bf16 ulps of max|out|."""
    mlp = _bf16_mlp(p)
    x, tx, sh, tsh, emb, temb = (t.detach() for t in _fr_ins(p, JVP_INS)[0])
    weights = mlp.weights()
    lay = p["lay"]
    w, dw = K._mlp_jvp(mlp, weights, emb, temb)
    with torch.no_grad():
        sliced = K.chunked_conv(p["plan"], mlp, x, sh, emb, lay, n_chunks)
        whole = K.tri_fwd(p["plan"], x, sh, w, lay)
        sliced_jvp = K.chunked_jvp_conv(p["plan"], mlp, x, tx, sh, tsh, emb, temb, lay, n_chunks)
        whole_jvp = K.jvp_fwd(p["plan"], x, tx, sh, tsh, w, dw, lay)
    for a, b in zip((sliced,) + sliced_jvp, (whole,) + whole_jvp):
        assert a.dtype == b.dtype == BF16
        ref = b.double().numpy()
        assert np.abs(a.double().numpy() - ref).max() <= 2 * _ulp(ref)


# --- (d) a depth-2 model against its golden ----------------------------------------------
def test_bf16_depth2_model_meets_jax_gate_on_golden():
    """The options golden's depth-2 model (K4's route) in bf16 against its
    float64 golden: E rel 1e-3, F 2e-2 of max|F|, as JAX's own bf16 model
    meets them on the same frame (xla and pallas_fused in interpret mode)."""
    from __graft_entry__ import _fcc_frame
    from nequip_tpu import model as jax_models
    from nequip_tpu.data import _keys as jk
    from nequip_tpu.data import batched_from_list as j_batched
    from nequip_tpu.data import compute_neighborlist_ as j_nl
    from nequip_tpu.data import pad_batch as j_pad
    from nequip_tpu.data import to_device as j_to_device

    z = np.load(OPTIONS_GOLDEN)
    name = "depth2"
    flat = {k[len(f"{name}/params/"):]: z[k] for k in z.files if k.startswith(f"{name}/params/")}
    model = instantiate(dict(retarget(json.loads(str(z[f"{name}/config"]))), tp_impl="fused"), _recursive_=False)
    load_jax_params(model, flat)
    model = modify(model, [{"modifier": "enable_bf16_fast_mode"}]).requires_grad_(False)
    assert {b.route for b in model.modules() if isinstance(b, InteractionBlock)} == {"fused_tp"}
    frame = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(
        from_dict({k: z[k] for k in ("pos", "cell", "pbc", "atomic_numbers", "charge")})), 4.0)
    out = model(to_tensors(pad_batch(batched_from_list([frame]), 128, round_up(frame["edge_index"].shape[1], 256), 2)))
    e_ref, f_ref = float(z[f"{name}/energy"]), z[f"{name}/forces"]

    def gap(e, f):
        return abs(e - e_ref) / abs(e_ref), float(np.abs(np.asarray(f, dtype=np.float64)[:108] - f_ref).max()
                                                  / np.abs(f_ref).max())

    e_err, f_err = gap(float(out["total_energy"][0, 0]), out["forces"].numpy())
    jframe = _fcc_frame(108, seed=0, jitter=0.1)
    jframe[jk.TOTAL_CHARGE_KEY] = np.array([1])
    nl = j_nl(dict(jframe), 4.0, backend="kdtree")
    jbatch = j_to_device(j_pad(j_batched([nl]), 128, round_up(nl[jk.EDGE_INDEX_KEY].shape[1], 256), 2))
    params = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), _unflatten(flat))
    jax_err = {}
    for impl in ("xla", "pallas_fused"):
        jm = jax_models.NequIPGNNModel(**dict(MODELS[name][1], model_dtype="bfloat16", tp_impl=impl))
        res = jax.jit(jm)(params, jbatch)
        jax_err[impl] = gap(float(np.asarray(res[jk.TOTAL_ENERGY_KEY]).reshape(-1)[0]), res[jk.FORCE_KEY])
    print(f"depth-2 bf16 against the f64 golden: port fused_tp E rel {e_err:.2e}, F {f_err:.2e} of max|F|; "
          + "; ".join(f"JAX {k}: E rel {e:.2e}, F {f:.2e}" for k, (e, f) in jax_err.items()))
    assert e_err <= E_TOL and f_err <= F_TOL
    for e, f in jax_err.values():
        assert e <= E_TOL and f <= F_TOL


# --- (e) training steps ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def train_golden():
    """The training golden (float64 rr loss and gradients of the flagship on
    its 108-atom frame), its parameters, and JAX's bf16 step (XLA) from the
    float32 parameters: (golden, params, JAX bf16 loss, JAX bf16 grads)."""
    from __graft_entry__ import _fcc_frame, _flagship_model
    from nequip_tpu.data import _keys as jk
    from nequip_tpu.data import batched_from_list as j_batched
    from nequip_tpu.data import compute_neighborlist_ as j_nl
    from nequip_tpu.data import pad_batch as j_pad
    from nequip_tpu.data import to_device as j_to_device
    from nequip_tpu.data.dataset import lj_reference
    from nequip_tpu.train import EnergyForceLoss as JLoss
    from torch_port_golden import _flatten

    z, g = np.load(TRAIN_GOLDEN), np.load(GOLDEN)
    params = {k[len("params/"):]: g[k] for k in g.files if k.startswith("params/")}
    frame = _fcc_frame(108, seed=0, jitter=0.1)
    labels = lj_reference(frame[jk.POSITIONS_KEY], frame[jk.CELL_KEY].reshape(3, 3), (True, True, True))
    frame.update({k: labels[k] for k in (jk.TOTAL_ENERGY_KEY, jk.FORCE_KEY)})
    nl = j_nl(dict(frame), 4.0, backend="kdtree")
    batch = j_to_device(j_pad(j_batched([nl]), 128, round_up(nl[jk.EDGE_INDEX_KEY].shape[1], 256), 2))
    loss_mgr, model = JLoss(type_names=["Cu"]), _flagship_model("bfloat16", tp_impl="xla")
    p32 = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), _unflatten(params))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: loss_mgr.values(loss_mgr.batch_state(model(p, batch), batch), loss_mgr.coeff_vector())[0]))(p32)
    return z, params, float(loss), {k: np.asarray(v, dtype=np.float64) for k, v in _flatten(grads).items()}


def _loss_grad_gaps(loss, grads, want_loss, want_grads):
    return (abs(loss - want_loss) / abs(want_loss),
            max(float(np.abs(np.asarray(grads[k], dtype=np.float64) - want_grads[k]).max()
                      / np.abs(want_grads[k]).max()) for k in grads))


def _golden_model(params, tp_impl, remat=False, dtype="bfloat16"):
    """The flagship with the golden's parameters, in ``dtype`` (bf16 through
    enable_bf16_fast_mode, from the float32 parameters)."""
    model = NequIPGNNModel(seed=0, model_dtype="float64", tp_impl=tp_impl,
                           **dict(FLAGSHIP, **({"remat_conv": "save_tp"} if remat else {})))
    load_jax_params(model, params)
    if dtype == "bfloat16":
        return modify(model, [{"modifier": "enable_bf16_fast_mode"}])
    return modify(model, [{"modifier": "modify_model_dtype", "model_dtype": dtype}])


def _golden_batch(z):
    frame = {k: z[k] for k in ("pos", "cell", "pbc", "atomic_numbers", "total_energy", "forces")}
    data = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(frame)), 4.0)
    return to_tensors(pad_batch(batched_from_list([data]), 128, round_up(data["edge_index"].shape[1], 256), 2))


@pytest.mark.parametrize("tp_impl,mode,n_chunks,remat", [("fused_tp", "rr", 0, False), ("fused", "fr", 2, False),
                                                         ("fused", "fr", 2, True), ("fused_tp", "fr", 2, False),
                                                         ("fused", "rr", 0, False), ("fused", "fr", 0, False),
                                                         ("fused", "rr", 0, True)])
def test_bf16_training_step_matches_golden_and_jax(train_golden, tp_impl, mode, n_chunks, remat):
    """A bf16 training step through the kernels' twins from the float32
    parameters: rr on fused_tp (K4, K5, K3 to second order), rr and unsliced
    fr on fused (K1, K2's training variant, the dW reduction and K3, second
    order through K4 and K5), fr over 2 edge slices (K4-acc, K5, K6, K7, K3)
    on both kernel routes, once each on fused with remat_conv="save_tp", as
    JAX's bf16 fr benchmark row runs it."""
    z, params, j_loss, j_grads = train_golden
    golden = {k[len("grads/"):]: z[k] for k in z.files if k.startswith("grads/")}
    model = _golden_model(params, tp_impl, remat)
    batch = _golden_batch(z)
    module = NequIPTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), force_grad_mode=mode,
                               fr_edge_chunks=n_chunks, device="cpu")
    if mode == "rr":
        loss, _, _ = module.compute_loss(batch)
        loss.backward()
    else:
        loss, _, _ = module.compute_grads_fr(batch)
    assert {p.grad.dtype for p in model.parameters() if p.grad is not None} == {torch.float32}
    grads = jax_named_grads(model)
    loss = float(loss.detach())
    gaps = {"golden": _loss_grad_gaps(loss, grads, float(z["loss"]), golden),
            "JAX bf16": _loss_grad_gaps(loss, grads, j_loss, j_grads),
            "JAX bf16 vs golden": _loss_grad_gaps(j_loss, {k: j_grads[k] for k in grads}, float(z["loss"]), golden)}
    print(f"bf16 {mode} step on {tp_impl} ({n_chunks} slices, save_tp {remat}): "
          + "; ".join(f"{k}: loss rel {a:.2e}, grads {b:.2e} of max|grad|" for k, (a, b) in gaps.items()))
    for loss_gap, grad_gap in gaps.values():
        assert loss_gap <= LOSS_TOL and grad_gap <= GRAD_TOL


def test_bf16_ema_config_step_on_fused(train_golden):
    """One EMA-ConFIG step (its two component gradients are rr passes over
    one graph: K2's training variant and the dW reduction, then K4 and K5)
    of the bf16 flagship on ``"fused"`` against the same step in float32:
    the direction it sets as the gradients is finite float32 and within 0.1
    of max|grad| of float32's for each tensor; the averaged weights stay
    finite."""
    from nequip_tpu_torch.train import EMAConFIGTrainModule

    z, params, _, _ = train_golden
    batch = _golden_batch(z)
    steps = []
    for dtype in ("float32", "bfloat16"):
        model = _golden_model(params, "fused", dtype=dtype)
        module = EMAConFIGTrainModule(model, loss=EnergyForceLoss(type_names=["Cu"]), device="cpu",
                                      optimizer={"_target_": "optax.adam", "learning_rate": 1e-3})
        module.training_step(batch)
        steps.append(({k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}, module))
    (want, _), (got, module) = steps
    assert set(got) == set(want) and got
    gaps = {k: float((g - want[k]).abs().max()) / float(want[k].abs().max()) for k, g in got.items()}
    print(f"bf16 EMA-ConFIG step on fused against float32: max gap {max(gaps.values()):.2e} of max|grad|")
    for k, g in got.items():
        assert g.dtype == torch.float32 and bool(g.isfinite().all()), k
        assert gaps[k] <= GRAD_TOL, k
    assert module.ema_step == 1 and all(bool(t.isfinite().all()) for t in module.ema_model.parameters())


# --- (f) the registered op's tables ----------------------------------------------------------
class _OpCalls(TorchDispatchMode):
    """Records the dtypes of the tensors each ``nequip_torch`` op is called with."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("nequip_torch."):
            self.calls[name.split(".")[1]] = [a.dtype for a in args if isinstance(a, torch.Tensor)]
        return func(*args, **(kwargs or {}))


def test_bf16_fused_tp_op_takes_float32_tables():
    """A traced program's K4 (``nequip_torch::tri_fwd``, backward K5 and K3
    as registered ops) in bf16 takes the term tables' coefficients in
    float32 (``acc_dtype``: bf16 coefficients would move about a tenth of
    the outputs by an ulp) and agrees with the eager route (TriConv): fewer
    than 0.1% of the outputs differ, each by at most one bf16 ulp of
    max|out|, forward and backward; ``_check_coefs`` refuses bf16 tables."""
    plan, lay, ops, _ = _tri_problem()
    traced = K.layout_from_fields(K.layout_fields(lay))  # the real-edge count stays on the device
    outs = []
    for layout in (lay, traced):
        x = ops["x"].clone().requires_grad_(True)
        with _OpCalls() as seen:
            out = K.fused_tp_scatter(plan, x, ops["y"], ops["w"], layout, frozen=True)
            (dx,) = torch.autograd.grad(out, x, ops["g"])
        outs.append((out.detach(), dx))
    n_lead = {"tri_fwd": 7, "tri_bwd": 6}  # tensors before the tables
    assert set(n_lead) <= set(seen.calls)
    for op, lead in n_lead.items():
        dtypes = seen.calls[op]
        assert set(dtypes[:4 if op == "tri_bwd" else 3]) == {BF16}
        assert [dtypes[lead + i] for i in K._COEF] == [torch.float32] * len(K._COEF), op
    for a, b in zip(*outs):
        assert a.dtype == b.dtype == BF16
        ref = a.double().numpy()
        assert np.abs(b.double().numpy() - ref).max() <= _ulp(ref)
        assert float((a != b).double().mean()) < 1e-3
    K._check_coefs("tri_fwd", tuple(plan.device_tables(torch.device("cpu"), torch.float32).values()), ops["x"])
    with pytest.raises(ValueError, match="float32"):
        K._check_coefs("tri_fwd", tuple(plan.device_tables(torch.device("cpu"), BF16).values()), ops["x"])


# --- (g) compile -------------------------------------------------------------------------------
def test_bf16_depth2_package_compiles_through_the_registered_ops(tmp_path):
    """A depth-2 model's package compiled with ``--modifiers
    enable_bf16_fast_mode --no-check`` (bf16 has no self-check tolerance,
    as in JAX): the program calls K4 and K5 (inference) once a layer and
    K3 as the registered ops, in bf16 with float32 tables, and gives the
    eager bf16 model's forces to within one bf16 ulp of max|F|."""
    import collections
    import io
    import zipfile

    from nequip_tpu_torch.model.inference_models import load_compiled_model, rung_file
    from nequip_tpu_torch.scripts import compile as port_compile
    from nequip_tpu_torch.scripts import package as port_package
    from test_torch_port_bf16 import SMALL, _small_frame

    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **dict(SMALL, radial_mlp_depth=2))
    frame = compute_neighborlist_(ChemicalSpeciesToAtomTypeMapper(["Cu"])(from_dict(_small_frame())), 4.0)
    example = pad_batch(batched_from_list([frame]), 64, round_up(frame["edge_index"].shape[1], 256), 2)
    pkg, art = str(tmp_path / "pkg.zip"), str(tmp_path / "depth2_bf16.nequip_tpu_torch.zip")
    port_package.package_model(model, pkg, example, "cpu", snapshot=False)
    port_compile.main([pkg, art, "--device", "cpu", "--modifiers", "enable_bf16_fast_mode", "--no-check"])
    with zipfile.ZipFile(art) as zf:
        program = torch.export.load(io.BytesIO(zf.read(rung_file(0))))
    ours = collections.Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function"
                               and isinstance(n.target, torch._ops.OpOverload) and n.target.namespace == "nequip_torch")
    assert ours["nequip_torch.tri_fwd.default"] == 2 and ours["nequip_torch.tri_bwd.default"] == 2
    assert ours["nequip_torch.scatter_rows.default"] >= 1 and "nequip_torch.conv_fwd.default" not in ours
    compiled = load_compiled_model(art, device="cpu")
    assert compiled.metadata["model_dtype"] == "bfloat16"
    got = compiled(to_tensors(example))[_keys.FORCE_KEY]
    eager = modify(model, [{"modifier": "enable_bf16_fast_mode"}]).requires_grad_(False)
    want = eager(K.relayout_edge_stream(to_tensors(example)))[_keys.FORCE_KEY]
    assert got.dtype == want.dtype == torch.float64
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2.0 ** (np.floor(np.log2(scale)) - 7)
