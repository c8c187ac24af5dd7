"""The port's MD driver, integrators and batched inference against the JAX package.

The JAX model runs at ``tp_impl="xla"`` (its plain reference) and the port's
at ``tp_impl="fused"`` (the kernels' plain twins on the CPU), one
module-scoped flagship-shaped model (2 layers, l_max=2, 8 features) with the
JAX parameters loaded through ``load_jax_params``, in float64.  The MD
cases are twins of ``tests/integration/test_deploy.py``'s, built from the
models directly (the port has no checkpoints yet); each holds the port's
driver against the JAX driver in the same integration mode, at the JAX
suite's tolerances: positions atol 1e-9, forces 1e-8, aux 1e-10, thermo
rows rel 1e-10; capacities exactly.  Each driver runs once per test: the
JAX driver writes positions back only at a rebuild, so a second ``run()``
starts elsewhere in the two packages (the port continues from where the
last run ended, ``test_second_run_continues``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.data.dataset import LJTestDataset
from nequip_tpu.integrations import MDDriver as JMDDriver
from nequip_tpu.integrations import NequIPBatchedInference as JBatched
from nequip_tpu.integrations import NoseHoover as JNoseHoover
from nequip_tpu.integrations import VelocityVerlet as JVelocityVerlet
from nequip_tpu.integrations import maxwell_boltzmann_velocities as j_mb
from nequip_tpu.model import NequIPGNNModel as JModel

from nequip_tpu_torch.data import compute_neighborlist_, from_dict
from nequip_tpu_torch.integrations import (
    MDDriver,
    NequIPBatchedInference,
    NoseHoover,
    VelocityVerlet,
    maxwell_boltzmann_velocities,
)
from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params
from nequip_tpu_torch.ops.kernels.tp_scatter import LAYOUT_KEY

CONFIG = dict(
    seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=2,
    parity=False, num_features=8, radial_mlp_width=16, avg_num_neighbors=18.0,
    per_type_energy_shifts={"Cu": -3.5}, per_type_energy_scales={"Cu": 0.5},
)
MASS = 63.5
MODES = ["host", "block"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The MD loops run thousands of tiny ops: with one intra-op thread they
    do not wait on each other's threads when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jmodel = JModel(tp_impl="xla", **CONFIG)
    params = jmodel.init_params()
    port = NequIPGNNModel(tp_impl="fused", **CONFIG)
    load_jax_params(port, jax.tree.map(np.asarray, params))
    return jmodel, params, port


def _frame(seed, supercell=(2, 2, 2)):
    f = LJTestDataset(supercell=supercell, num_frames=1, seed=seed).frames[0]
    n = f["pos"].shape[0]
    return {"pos": f["pos"], "cell": f["cell"], "pbc": np.array([True] * 3), "atom_types": np.zeros(n, dtype=int)}


def _drivers(models, frame, make_integrators, **kw):
    """The JAX and the port driver on one frame with the same settings."""
    jmodel, params, port = models
    n = frame["pos"].shape[0]
    j_int, p_int = make_integrators()
    jd = JMDDriver(jmodel, params, dict(frame), integrator=j_int, masses=np.full(n, MASS), **kw)
    pd = MDDriver(port, dict(frame), integrator=p_int, masses=np.full(n, MASS), device="cpu", **kw)
    return jd, pd


def _nose_hoover(dt_fs):
    return lambda: (JNoseHoover(dt_fs=dt_fs, temperature_K=300.0), NoseHoover(dt_fs=dt_fs, temperature_K=300.0))


def _verlet(dt_fs):
    return lambda: (JVelocityVerlet(dt_fs=dt_fs), VelocityVerlet(dt_fs=dt_fs))


def _check_state(got, want):
    np.testing.assert_allclose(got["positions"], np.asarray(want["positions"]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["velocities"], np.asarray(want["velocities"]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["forces"], np.asarray(want["forces"]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["aux"], np.asarray(want["aux"]), rtol=0, atol=1e-10)
    assert got["kinetic_energy"] == pytest.approx(want["kinetic_energy"], rel=1e-10)


def test_maxwell_boltzmann_is_bitwise_jax():
    masses = np.linspace(1.0, 200.0, 57)
    for seed, zero in ((0, True), (4, True), (9, False)):
        got = maxwell_boltzmann_velocities(masses, 300.0, seed=seed, zero_momentum=zero)
        want = j_mb(masses, 300.0, seed=seed, zero_momentum=zero)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("form", ["make_step", "half_steps"])
@pytest.mark.parametrize("integrator", ["verlet", "nose_hoover"])
def test_one_integrator_step_matches_jax(integrator, form):
    """One step on a harmonic force, from the same random state, to 1e-14."""
    r = np.random.RandomState(5)
    n = 17
    pos, vel, forces = (r.standard_normal((n, 3)) for _ in range(3))
    anchor, k = r.standard_normal((n, 3)), 0.7
    masses = r.uniform(1.0, 64.0, n)
    zeta = 0.013 if integrator == "nose_hoover" else 0.0
    j_int, p_int = (_nose_hoover(1.5) if integrator == "nose_hoover" else _verlet(1.5))()

    def run(make, force_fn, m, state):
        if form == "make_step":
            return make.make_step(force_fn, m)(state)
        half_a, half_b = make.make_half_steps(m)
        p, carry = half_a(state)
        return half_b(p, carry, force_fn(p))

    want = run(j_int, lambda p: -k * (p - jnp.asarray(anchor)), jnp.asarray(masses),
               tuple(jnp.asarray(a) for a in (pos, vel, forces, zeta)))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    got = run(p_int, lambda p: -k * (p - t(anchor)), t(masses), tuple(t(a) for a in (pos, vel, forces, zeta)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-14)


@pytest.mark.parametrize("integration", MODES)
def test_md_driver(models, integration):
    """Twin of test_deploy.py::test_md_driver: Nose-Hoover from rest."""
    frame = _frame(88)
    jd, pd = _drivers(models, frame, _nose_hoover(1.0), steps_per_block=5, integration=integration)
    want, got = jd.run(10), pd.run(10)
    _check_state(got, want)
    assert np.all(np.isfinite(got["positions"])) and np.all(np.isfinite(got["forces"]))
    assert got["kinetic_energy"] > 0  # the thermostat heats the frame from rest
    assert not np.allclose(got["positions"], frame["pos"])
    assert pd.step_count == jd.step_count == 10 and pd._cap == jd._cap


@pytest.mark.parametrize("integration", MODES)
def test_md_skin_rebuild_uses_fresh_edges(models, integration):
    """Twin of test_deploy.py::test_md_skin_rebuild_uses_fresh_edges: with a
    tiny skin every block (or step) rebuilds; the last forces equal forces
    from a fresh neighbour list at the final positions, and the block
    program, made once, ran on every refilled layout."""
    frame = _frame(17)
    jd, pd = _drivers(models, frame, _verlet(2.0), skin=1e-6, steps_per_block=5, integration=integration)
    v0 = 0.02 * np.random.RandomState(0).standard_normal((32, 3))
    want, got = jd.run(15, velocities=v0), pd.run(15, velocities=v0)
    _check_state(got, want)
    assert len(pd.rebuild_timings) == 1 + (3 if integration == "block" else 15)
    assert pd.captures == (1 if integration == "block" else 0)

    _, _, port = models
    fresh = MDDriver(port, dict(frame, pos=got["positions"]), VelocityVerlet(dt_fs=2.0), skin=pd.skin, device="cpu")
    np.testing.assert_allclose(got["forces"], fresh.forces(torch.as_tensor(got["positions"])).numpy(),
                               rtol=1e-8, atol=1e-10)


def test_md_rebuild_refills_the_block_tensors(models):
    """A same-capacity rebuild copies the new build into the tensors a block
    program was made over (a CUDA graph reads them by address): afterwards
    they equal a build from scratch at the rebuild's positions, and the
    program is kept; a capacity change makes new tensors and a new program."""
    _, _, port = models
    frame = _frame(17)
    pd = MDDriver(port, dict(frame), VelocityVerlet(dt_fs=2.0), masses=np.full(32, MASS), skin=1e-6,
                  steps_per_block=5, device="cpu")
    static = {k: v for k, v in pd._batch.items() if isinstance(v, torch.Tensor)}
    pd.run(10, velocities=0.03 * np.random.RandomState(1).standard_normal((32, 3)))
    assert pd.captures == 1 and pd.replays == 2 and len(pd.rebuild_timings) == 3
    assert all(pd._batch[k] is v for k, v in static.items())

    data = compute_neighborlist_(from_dict(dict(frame, pos=pd._nl_pos)), pd.r_max + pd.skin)
    ref = MDDriver(port, dict(frame, pos=pd._nl_pos), VelocityVerlet(dt_fs=2.0), skin=1e-6, device="cpu")
    assert ref._batch[LAYOUT_KEY].n_real == pd._batch[LAYOUT_KEY].n_real == data["edge_index"].shape[1]
    for k, v in ref._batch.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(pd._batch[k], v), k
    for name in ("edge_src", "dst_ptr", "src_perm", "src_ptr"):
        assert torch.equal(getattr(pd._batch[LAYOUT_KEY], name), getattr(ref._batch[LAYOUT_KEY], name)), name
    assert torch.equal(pd._nl_pos_dev, torch.as_tensor(pd._nl_pos))

    program = pd._program
    pd._build_neighborlist()
    assert pd._program is program
    pd._frame["cell"] = 0.9 * np.asarray(pd._frame["cell"])
    pd._frame["pos"] = 0.9 * np.asarray(pd._frame["pos"])
    pd._build_neighborlist()  # denser: outgrows the edge capacity
    assert pd._program is None and pd._batch["edge_index"] is not static["edge_index"]


@pytest.mark.parametrize("integration", MODES)
def test_md_thermo_and_trajectory(models, integration, tmp_path):
    """Twin of test_deploy.py::test_md_thermo_and_trajectory."""
    frame = _frame(55)
    jd, pd = _drivers(models, frame, _nose_hoover(1.0), steps_per_block=5, integration=integration)
    v0 = maxwell_boltzmann_velocities(np.full(32, MASS), 300.0, seed=4)
    paths = tmp_path / "jax.xyz", tmp_path / "port.xyz"
    want = jd.run(15, log_every_blocks=1, traj_path=str(paths[0]), velocities=v0)
    got = pd.run(15, log_every_blocks=1, traj_path=str(paths[1]), velocities=v0)
    _check_state(got, want)
    t_sampled = 2 * (0.5 * np.sum(MASS * v0**2)) / (3 * 32 * 8.617330337217213e-05)
    assert got["thermo"][0]["temperature_K"] == pytest.approx(t_sampled, rel=1e-10)
    assert [r["step"] for r in got["thermo"]] == [r["step"] for r in want["thermo"]] == [0, 5, 10, 15]
    for g, w in zip(got["thermo"], want["thermo"]):
        for k in ("potential_energy", "kinetic_energy", "total_energy", "temperature_K"):
            assert g[k] == pytest.approx(w[k], rel=1e-10), k
    lines = [p.read_text().strip().splitlines() for p in paths]
    assert len(lines[1]) == len(lines[0]) == 4 * 34
    for g, w in zip(*reversed(lines)):
        gs, ws = g.split(), w.split()
        if len(ws) == 4:  # "<type> x y z"
            assert gs[0] == ws[0] == "Cu"
            np.testing.assert_allclose(np.array(gs[1:], float), np.array(ws[1:], float), rtol=0, atol=2e-8)
        else:
            assert g == w


def test_md_host_integration_matches_block(models):
    """Twin of test_deploy.py::test_md_host_integration_matches_block: the
    two modes agree through skin rebuilds, and each agrees with JAX's."""
    frame = _frame(31, supercell=(3, 3, 3))
    v0 = 0.02 * np.random.RandomState(3).standard_normal((108, 3))
    got = {}
    for integration in MODES:
        jd, pd = _drivers(models, frame, _nose_hoover(2.0), skin=1e-6, steps_per_block=5, integration=integration)
        want, got[integration] = jd.run(10, velocities=v0), pd.run(10, velocities=v0)
        _check_state(got[integration], want)
        assert pd.step_count == 10
    _check_state(got["host"], got["block"])


def test_md_edge_headroom_absorbs_rebuild_growth(models):
    """Twin of test_deploy.py::test_md_edge_headroom_absorbs_rebuild_growth:
    capacities equal the JAX driver's at the first build, after a
    same-density rebuild and after a rebuild that outgrows the headroom."""
    frame = _frame(31, supercell=(3, 3, 3))
    jd, pd = _drivers(models, frame, _verlet(1.0), skin=0.5, edge_headroom=1.1)
    e0 = int(pd._batch["edge_mask"].sum())
    assert pd._cap == jd._cap and pd._cap[1] >= 1.1 * e0 - 256
    for d in (jd, pd):
        d._build_neighborlist()
    assert pd._cap == jd._cap
    for d in (jd, pd):
        d._frame["cell"] = 0.9 * np.asarray(d._frame["cell"])
        d._frame["pos"] = 0.9 * np.asarray(d._frame["pos"])
        d._build_neighborlist()
    e1 = int(pd._batch["edge_mask"].sum())
    assert e1 > 1.1 * e0 and pd._cap == jd._cap and pd._cap[1] >= 1.1 * e1 - 256


def test_second_run_continues(models):
    """The port's own semantics: a second run() starts where the first ended."""
    _, _, port = models
    frame = _frame(17)
    v0 = 0.02 * np.random.RandomState(0).standard_normal((32, 3))
    kw = dict(masses=np.full(32, MASS), steps_per_block=5, integration="host", device="cpu")
    split = MDDriver(port, dict(frame), VelocityVerlet(dt_fs=2.0), **kw)
    first = split.run(5, velocities=v0)
    second = split.run(5, velocities=first["velocities"])
    whole = MDDriver(port, dict(frame), VelocityVerlet(dt_fs=2.0), **kw).run(10, velocities=v0)
    for k in ("positions", "velocities", "forces"):
        np.testing.assert_allclose(second[k], whole[k], rtol=0, atol=1e-12, err_msg=k)
    assert split.step_count == 10


def test_driver_options(models):
    _, _, port = models
    frame = _frame(17)
    with pytest.raises(ValueError, match="integration='host' pairs with nl_backend='host'"):
        MDDriver(port, frame, VelocityVerlet(dt_fs=1.0), nl_backend="device", integration="host", device="cpu")
    with pytest.raises(ValueError, match="integration"):
        MDDriver(port, frame, VelocityVerlet(dt_fs=1.0), integration="graph", device="cpu")
    with pytest.raises(ValueError, match="atom_types"):
        MDDriver(port, {k: v for k, v in frame.items() if k != "atom_types"}, VelocityVerlet(dt_fs=1.0), device="cpu")


def test_batched_inference_matches_jax(models):
    """Three frames of different sizes in one padded batch."""
    jmodel, params, port = models
    frames = [_frame(s, supercell=c) for s, c in ((1, (2, 2, 2)), (2, (3, 2, 2)), (3, (3, 3, 2)))]
    want = JBatched(jmodel, params)(frames)
    batched = NequIPBatchedInference(port, device="cpu")
    got = batched(frames)
    assert batched._caps == {"n_nodes": 256, "n_edges": batched._caps["n_edges"], "n_frames": 4}
    assert len(got) == len(want) == 3
    for g, w, f in zip(got, want, frames):
        assert g["energy"] == pytest.approx(w["energy"], rel=1e-10)
        assert g["forces"].shape == (len(f["pos"]), 3)
        np.testing.assert_allclose(g["forces"], np.asarray(w["forces"]), rtol=0, atol=1e-9)
        np.testing.assert_allclose(g["stress"], np.asarray(w["stress"]), rtol=0, atol=1e-9)
    # a smaller population reuses the grown capacities
    small = batched(frames[:1])
    assert small[0]["energy"] == pytest.approx(got[0]["energy"], rel=1e-12)
    assert batched._caps["n_frames"] == 4
