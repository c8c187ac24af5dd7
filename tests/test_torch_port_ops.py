"""The port's constants and plain-PyTorch ops against the JAX package.

Same inputs (numpy, seeded) into the JAX function and its port; both in
float64 on the CPU.  Tolerances: the SH and CG tables are built by the same
exact algebra (1e-14 / 1e-13 leave room for one rounding per entry and
for the SVD); the ops run the same float64 arithmetic in another order
(1e-12).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.ops import cg as jcg
from nequip_tpu.ops import spherical as jsph
from nequip_tpu.ops.activations import second_moment as j_second_moment
from nequip_tpu.ops.gate import Gate as JGate
from nequip_tpu.ops.irreps import Irreps as JIrreps
from nequip_tpu.ops.layout import ir_mul_to_mul_ir as j_to_mul_ir
from nequip_tpu.ops.linear import Linear as JLinear
from nequip_tpu.ops.mlp import ScalarMLP as JScalarMLP
from nequip_tpu.ops.tensor_product import TensorProduct as JTP
from nequip_tpu.ops.tensor_product import fully_connected_tensor_product as j_fctp
from nequip_tpu.ops.tensor_product import uvu_instructions as j_uvu

from nequip_tpu_torch.ops import cg as pcg
from nequip_tpu_torch.ops import spherical as psph
from nequip_tpu_torch.ops.activations import second_moment as p_second_moment
from nequip_tpu_torch.ops.gate import Gate as PGate
from nequip_tpu_torch.ops.irreps import Irreps
from nequip_tpu_torch.ops.layout import ir_mul_to_mul_ir, mul_ir_to_ir_mul
from nequip_tpu_torch.ops.linear import Linear as PLinear
from nequip_tpu_torch.ops.mlp import ScalarMLP as PScalarMLP
from nequip_tpu_torch.ops.tensor_product import TensorProduct as PTP
from nequip_tpu_torch.ops.tensor_product import fully_connected_tensor_product as p_fctp
from nequip_tpu_torch.ops.tensor_product import uvu_instructions as p_uvu

FEATS = "8x0e+8x1o+8x2e"


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _load(module, params):
    with torch.no_grad():
        for k, v in params.items():
            getattr(module, k).copy_(torch.as_tensor(np.array(v), dtype=torch.float64))


@pytest.mark.parametrize("lmax", [0, 1, 2, 3, 4])
def test_sh_tables_match_jax(lmax):
    """The sympy-free tables equal the JAX package's sympy tables."""
    mp, cp = psph._sh_coeff_tables(lmax)
    mj, cj = jsph._sh_coeff_tables(lmax)
    assert mp == mj
    np.testing.assert_allclose(cp, cj, rtol=0, atol=1e-14)


def test_sh_evaluation_matches_jax():
    r = np.random.RandomState(0)
    v = r.standard_normal((64, 3))
    v[0] = 0.0  # padded-edge zero vector: finite and identical
    want = np.asarray(jsph.spherical_harmonics(3, jnp.asarray(v)))
    got = psph.spherical_harmonics(3, _t(v)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize(
    "l1,l2,l3",
    [t for t in itertools.product(range(3), repeat=3) if abs(t[0] - t[1]) <= t[2] <= t[0] + t[1]],
)
def test_clebsch_gordan_matches_jax(l1, l2, l3):
    np.testing.assert_allclose(
        pcg.real_clebsch_gordan(l1, l2, l3), jcg.real_clebsch_gordan(l1, l2, l3), rtol=0, atol=1e-13
    )


def test_wigner_d_matches_jax():
    R = jcg.random_rotation(np.random.RandomState(3))
    for l in range(4):
        np.testing.assert_allclose(pcg.wigner_D(l, R), jcg.wigner_D(l, R), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["silu", "tanh", "gelu", "ssp", "sigmoid"])
def test_activation_constants_match_jax(name):
    assert p_second_moment(name) == pytest.approx(j_second_moment(name), rel=1e-15)


def test_linear_matches_jax():
    irreps_in, irreps_out = "8x0e+8x1o+4x2e", "4x0e+6x1o+2x2e+3x1e"
    jl = JLinear(irreps_in, irreps_out)
    params = jl.init(jax.random.PRNGKey(0))
    pl = PLinear(irreps_in, irreps_out).double()
    _load(pl, params)
    x = np.random.RandomState(1).standard_normal((10, Irreps(irreps_in).dim))
    np.testing.assert_allclose(
        pl(_t(x)).detach().numpy(), np.asarray(jl(params, jnp.asarray(x))), rtol=0, atol=1e-12
    )


def test_gate_matches_jax():
    args = dict(
        irreps_scalars="8x0e+4x0o", act_scalars=["silu", "tanh"],
        irreps_gates="8x0e", act_gates=["silu"], irreps_gated="4x1o+4x2e",
    )
    jg, pg = JGate(**args), PGate(**args)
    x = np.random.RandomState(2).standard_normal((10, Irreps(pg.irreps_in).dim))
    np.testing.assert_allclose(pg(_t(x)).numpy(), np.asarray(jg(jnp.asarray(x))), rtol=0, atol=1e-12)


@pytest.mark.parametrize("depth", [0, 1])
def test_scalar_mlp_matches_jax(depth):
    args = dict(input_dim=8, output_dim=20, hidden_layers_depth=depth,
                hidden_layers_width=16 if depth else None, nonlinearity="silu")
    jm = JScalarMLP(**args)
    params = jm.init(jax.random.PRNGKey(1))
    pm = PScalarMLP(**args).double()
    _load(pm, params)
    x = np.random.RandomState(3).standard_normal((12, 8))
    np.testing.assert_allclose(
        pm(_t(x)).detach().numpy(), np.asarray(jm(params, jnp.asarray(x))), rtol=0, atol=1e-12
    )


def _conv_tps():
    feats, sh = FEATS, "1x0e+1x1o+1x2e"
    target = Irreps(FEATS) + Irreps("8x1e+8x2o")
    jmid, jins = j_uvu(JIrreps(feats), JIrreps(sh), JIrreps(str(target)))
    pmid, pins = p_uvu(Irreps(feats), Irreps(sh), target)
    assert str(jmid) == str(pmid) and jins == pins
    return JTP(feats, sh, str(jmid), jins), PTP(feats, sh, pmid, pins)


def test_uvu_tp_matches_jax():
    jtp, ptp = _conv_tps()
    assert jtp.weight_numel == ptp.weight_numel
    r = np.random.RandomState(4)
    x = r.standard_normal((20, ptp.irreps_in1.dim))
    y = r.standard_normal((20, ptp.irreps_in2.dim))
    w = r.standard_normal((20, ptp.weight_numel))
    want = jtp(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_allclose(ptp(_t(x), _t(y), _t(w)).numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_uvw_tp_matches_jax():
    """The self-connection TP with its flat shared weight vector."""
    args = (FEATS, "4x0e", "8x0e+8x0e+4x1o+4x2e")
    jtp, ptp = j_fctp(*args), p_fctp(*args)
    assert jtp.weight_numel == ptp.weight_numel
    r = np.random.RandomState(5)
    x = r.standard_normal((15, ptp.irreps_in1.dim))
    a = r.standard_normal((15, 4))
    w = r.standard_normal(ptp.weight_numel)
    want = jtp(jnp.asarray(x), jnp.asarray(a), jnp.asarray(w))
    np.testing.assert_allclose(ptp(_t(x), _t(a), _t(w)).numpy(), np.asarray(want), rtol=0, atol=1e-12)


def _block_rotation(irreps, R):
    blocks = []
    for mi in Irreps(irreps):
        D = pcg.irrep_D(mi.ir.l, mi.ir.p, R)
        # ir_mul: each chunk is (2l+1, mul), m-major
        blocks.append(np.kron(D, np.eye(mi.mul)))
    out = np.zeros((sum(b.shape[0] for b in blocks),) * 2)
    o = 0
    for b in blocks:
        out[o : o + b.shape[0], o : o + b.shape[0]] = b
        o += b.shape[0]
    return out


def test_ported_tp_is_equivariant():
    _, ptp = _conv_tps()
    r = np.random.RandomState(6)
    R = pcg.random_rotation(r)
    x = r.standard_normal((7, ptp.irreps_in1.dim))
    y = r.standard_normal((7, ptp.irreps_in2.dim))
    w = r.standard_normal((7, ptp.weight_numel))
    D1, D2, D3 = (_block_rotation(i, R) for i in (ptp.irreps_in1, ptp.irreps_in2, ptp.irreps_out))
    rotated_out = ptp(_t(x @ D1.T), _t(y @ D2.T), _t(w)).numpy()
    np.testing.assert_allclose(rotated_out, ptp(_t(x), _t(y), _t(w)).numpy() @ D3.T, rtol=0, atol=1e-10)


def test_layout_converters_match_jax():
    x = np.random.RandomState(7).standard_normal((3, Irreps(FEATS).dim))
    np.testing.assert_array_equal(ir_mul_to_mul_ir(x, FEATS), j_to_mul_ir(x, FEATS))
    np.testing.assert_array_equal(mul_ir_to_ir_mul(ir_mul_to_mul_ir(_t(x), FEATS), FEATS).numpy(), x)
