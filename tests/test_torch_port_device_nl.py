"""The port's device neighbour list and device-list MD against the JAX package.

``nequip_tpu_torch/ops/device_nl.py`` runs its plain twin here (CPU
tensors), in float64, against the JAX ``device_neighbor_list`` on
``tests/unit/ops/test_device_nl.py``'s 256-atom fcc boxes (r_max 3.0, raw
positions inside and far outside the cell) and a triclinic cell: the edge
sets (dst, src, integer shift) must be equal, with equal overflow flags,
also under capacities small enough to overflow (the JAX semantics keep the
lowest-index atoms of a bucket and the nearest neighbours of an atom).
The stream form and the device layout builder are held against the slot
form and ``build_edge_layout``.  The MD case is a twin of
``tests/integration/test_deploy.py``'s device-list test in float64 (4x4x4
box, skin 1e-6 so that every block rebuilds, 5-step blocks, 15 steps):
positions atol 1e-9, forces 1e-8 against the JAX device driver and the
port's host driver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nequip_tpu.data.dataset import LJTestDataset
from nequip_tpu.integrations import MDDriver as JMDDriver
from nequip_tpu.integrations import VelocityVerlet as JVelocityVerlet
from nequip_tpu.model import NequIPGNNModel as JModel
from nequip_tpu.ops.device_nl import device_neighbor_list as jax_device_neighbor_list
from nequip_tpu.ops.device_nl import suggest_grid_dims as jax_suggest_grid_dims

from nequip_tpu_torch.data import _keys, neighbor_list, round_up
from nequip_tpu_torch.integrations import MDDriver, VelocityVerlet
from nequip_tpu_torch.model import NequIPGNNModel, load_jax_params
from nequip_tpu_torch.ops import device_nl as D
from nequip_tpu_torch.ops.kernels import tp_scatter as K

CONFIG = dict(
    seed=0, model_dtype="float64", type_names=["Cu"], r_max=4.0, num_layers=2, l_max=2,
    parity=False, num_features=8, radial_mlp_width=16, avg_num_neighbors=18.0,
    per_type_energy_shifts={"Cu": -3.5}, per_type_energy_scales={"Cu": 0.5},
)
MASS = 63.5
R_MAX = 3.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bulk(n_rep, seed, triclinic=False):
    """tests/unit/ops/test_device_nl.py's fcc box (jitter 0.08 A), or the
    same fractional coordinates in a sheared cell."""
    r = np.random.RandomState(seed)
    a = 3.61
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]) * a
    pos = np.concatenate([base + np.array([i, j, k]) * a
                          for i in range(n_rep) for j in range(n_rep) for k in range(n_rep)])
    pos = pos + r.normal(0, 0.08, pos.shape)
    cube = np.diag([n_rep * a] * 3)
    if not triclinic:
        return pos, cube
    cell = cube + np.array([[0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [0.7, -1.1, 0.0]])
    return pos @ np.linalg.inv(cube) @ cell, cell


def _edge_set(edge_index, shifts, mask):
    ei, sh, m = np.asarray(edge_index), np.rint(np.asarray(shifts)).astype(int), np.asarray(mask)
    return {(int(ei[0, k]), int(ei[1, k]), *map(int, sh[k])) for k in np.nonzero(m)[0]}


def _both(pos, cell, cell_cap, k_max):
    dims = D.suggest_grid_dims(cell, R_MAX)
    want = jax_device_neighbor_list(jnp.asarray(pos), jnp.asarray(cell), R_MAX, dims, cell_cap=cell_cap, k_max=k_max)
    got = D.device_neighbor_list(torch.as_tensor(pos), cell, R_MAX, dims, cell_cap, k_max)
    return got, want


@pytest.mark.parametrize("case", ["inside", "outside", "triclinic"])
def test_device_nl_matches_jax_and_host(case):
    pos, cell = _bulk(4, 0, triclinic=case == "triclinic")
    if case == "outside":  # raw positions far outside the cell: the wraps must cancel
        pos = pos + np.array([2.0, -1.0, 3.0]) @ cell
    assert D.suggest_grid_dims(cell, R_MAX) == jax_suggest_grid_dims(cell, R_MAX)
    (ei, sh, mask, overflow), want = _both(pos, cell, 16, 48)
    assert not bool(overflow) and not bool(want[3])
    got = _edge_set(ei, sh, mask)
    assert got == _edge_set(*want[:3])
    ei_h, sh_h = neighbor_list(pos, R_MAX, cell=cell, pbc=(True,) * 3, backend="kdtree")
    assert got == _edge_set(ei_h, sh_h, np.ones(ei_h.shape[1], bool))
    dst = ei[0][mask].numpy()
    assert np.all(np.diff(dst) >= 0)  # dst-major: the kernels' order
    assert np.all(ei[0].numpy() == np.repeat(np.arange(len(pos)), 48))


@pytest.mark.parametrize("cell_cap,k_max", [(16, 2), (1, 48), (16, 5), (3, 48)])
def test_overflow_flags_and_kept_edges_match_jax(cell_cap, k_max):
    """Small capacities raise the flag, as in JAX, and keep the same edges:
    a bucket's lowest-index atoms, an atom's nearest neighbours."""
    pos, cell = _bulk(4, 1)
    (ei, sh, mask, overflow), want = _both(pos, cell, cell_cap, k_max)
    assert bool(overflow) and bool(want[3])
    assert _edge_set(ei, sh, mask) == _edge_set(*want[:3])


def test_thin_box_raises():
    pos, cell = _bulk(4, 2)
    with pytest.raises(AssertionError):
        jax_suggest_grid_dims(cell, 6.0)  # ~2.4 buckets thick
    with pytest.raises(ValueError, match=">= 3 grid cells"):
        D.suggest_grid_dims(cell, 6.0)


@pytest.mark.parametrize("e_cap_factor", [1.0, 0.5])
def test_stream_form_and_device_layout(e_cap_factor):
    """The stream form: the slot form's real edges compacted in kernel
    order, padding after them, the flag when the stream is too short; the
    layout builder equals build_edge_layout on the stream."""
    pos, cell = _bulk(4, 3)
    n = len(pos)
    dims = D.suggest_grid_dims(cell, R_MAX)
    grid = D.cell_grid(cell, R_MAX, dims, torch.float64, "cpu")
    flag = torch.zeros(1, dtype=torch.int32)
    slots = D.device_nl(torch.as_tensor(pos), grid, 16, 48, flag)
    n_real = int(slots.count.sum())
    e_cap = round_up(int(n_real * e_cap_factor), 256)
    pad = n + 5
    ei, sh, mask = torch.empty(2, e_cap, dtype=torch.int64), torch.empty(e_cap, 3, dtype=torch.float64), \
        torch.empty(e_cap, dtype=torch.bool)
    D.device_nl(torch.as_tensor(pos), grid, 16, 48, flag, out=(ei, sh, mask), pad_index=pad)
    assert int(flag.item()) == (1 if e_cap < n_real else 0)
    kept = min(n_real, e_cap)
    assert bool(mask[:kept].all()) and not bool(mask[kept:].any())
    assert bool((ei[:, kept:] == pad).all()) and bool((sh[kept:] == 0).all())
    slot_dst = np.repeat(np.arange(n), 48)[(np.arange(48)[None] < slots.count.numpy()[:, None]).reshape(-1)]
    slot_src = slots.src.numpy()[np.arange(48)[None] < slots.count.numpy()[:, None]]
    np.testing.assert_array_equal(ei[0, :kept].numpy(), slot_dst[:kept])
    np.testing.assert_array_equal(ei[1, :kept].numpy(), slot_src[:kept])

    want = K.build_edge_layout(ei, mask, n + 6)
    static = K.EdgeLayout(*(torch.full_like(t, -7) for t in (want.edge_src, want.dst_ptr)),
                          torch.full((e_cap,), -7, dtype=torch.int32), torch.full_like(want.src_ptr, -7), None)
    got = K.fill_edge_layout_(static, ei, mask)
    assert got.n_real is None and got.edge_src is static.edge_src and got.src_perm is static.src_perm
    for name in ("edge_src", "dst_ptr", "src_ptr"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.src_perm[:kept], want.src_perm)
    assert int(got.dst_ptr[-1]) == kept


# ---------------------------------------------------------------------------
# MD with the device list
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jmodel = JModel(tp_impl="xla", **CONFIG)
    params = jmodel.init_params()
    port = NequIPGNNModel(tp_impl="fused", **CONFIG)
    load_jax_params(port, jax.tree.map(np.asarray, params))
    return jmodel, params, port


def _box_frame(seed=31):
    """A box at least 3 * (r_max + skin) = 12 A thick (14.44 A)."""
    f = LJTestDataset(supercell=(4, 4, 4), num_frames=1, seed=seed).frames[0]
    n = f["pos"].shape[0]
    return {"pos": f["pos"], "cell": f["cell"], "pbc": np.array([True] * 3), "atom_types": np.zeros(n, dtype=int)}


def test_md_device_list_matches_jax_device_driver(models):
    """Twin of tests/integration/test_deploy.py's device-list case: a rebuild
    after every block (skin 1e-6), against the JAX device driver and the
    port's host-list driver."""
    jmodel, params, port = models
    frame = _box_frame()
    n = len(frame["pos"])
    v0 = 0.02 * np.random.RandomState(3).standard_normal((n, 3))
    kw = dict(masses=np.full(n, MASS), skin=1e-6, steps_per_block=5)
    want = JMDDriver(jmodel, params, dict(frame), integrator=JVelocityVerlet(dt_fs=2.0), nl_backend="device",
                     **kw).run(15, velocities=v0.copy())
    driver = MDDriver(port, dict(frame), VelocityVerlet(dt_fs=2.0), nl_backend="device", device="cpu", **kw)
    got = driver.run(15, velocities=v0.copy())
    host_driver = MDDriver(port, dict(frame), VelocityVerlet(dt_fs=2.0), device="cpu", **kw)
    host = host_driver.run(15, velocities=v0.copy())
    for ref in (want, host):
        np.testing.assert_allclose(got["positions"], ref["positions"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["forces"], ref["forces"], rtol=0, atol=1e-8)
    assert driver.rebuilds == 3
    # the sizing host build, the first device build, then one a block
    assert [sorted(t) for t in driver.rebuild_timings] == [["neighbor_list_s", "relayout_s"]] + \
        [["device_nl_ms"]] * 4
    assert driver._cap == host_driver._cap  # the first host build's capacities, headroom included
    layout = driver._batch[K.LAYOUT_KEY]
    assert layout.n_real is None and int(layout.dst_ptr[-1]) == int(driver._batch[_keys.EDGE_MASK_KEY].sum())


def test_force_call_on_a_device_layout_takes_the_registered_ops(models, monkeypatch):
    """The force call on the device-built layout runs the registered ops
    (K1, K2's inference variant, K3) and never reads the real-edge count on
    the host: the autograd-Function routes raise, and so does n_real."""
    _, _, port = models
    frame = _box_frame(7)
    kw = dict(masses=np.full(len(frame["pos"]), MASS), device="cpu")
    driver = MDDriver(port, dict(frame), VelocityVerlet(dt_fs=2.0), nl_backend="device", **kw)
    host = MDDriver(port, dict(frame), VelocityVerlet(dt_fs=2.0), **kw)
    pos = torch.as_tensor(frame["pos"], dtype=torch.float64)
    want = host.forces(pos)

    class NoHostCount(K.EdgeLayout):
        def __getattribute__(self, name):
            if name == "n_real":
                raise AssertionError("the force call read the layout's n_real")
            return super().__getattribute__(name)

    lay = driver._batch[K.LAYOUT_KEY]
    driver._batch[K.LAYOUT_KEY] = NoHostCount(lay.edge_src, lay.dst_ptr, lay.src_perm, lay.src_ptr, None)

    def refuse(*args, **kwargs):
        raise AssertionError("an autograd-Function route ran")

    for fn in (K.FusedConv, K.FusedConvBwd, K.TriConv, K.TriConvBwd):
        monkeypatch.setattr(fn, "forward", staticmethod(refuse))
    torch.testing.assert_close(driver.forces(pos), want, rtol=0, atol=1e-10)


def test_device_driver_options(models):
    _, _, port = models
    frame = _box_frame()
    v = VelocityVerlet(dt_fs=1.0)
    with pytest.raises(ValueError, match="integration='host' pairs with nl_backend='host'"):
        MDDriver(port, frame, v, nl_backend="device", integration="host", device="cpu")
    with pytest.raises(ValueError, match="fully periodic"):
        MDDriver(port, {**frame, "pbc": np.array([True, True, False])}, v, nl_backend="device", device="cpu")
    with pytest.raises(ValueError, match=">= 3 grid cells"):
        MDDriver(port, frame, v, nl_backend="device", skin=1.0, device="cpu")
    with pytest.raises(ValueError, match="nl_backend"):
        MDDriver(port, frame, v, nl_backend="gpu", device="cpu")
    with pytest.raises(ValueError, match="use tp_impl 'fused' or 'torch'"):
        MDDriver(NequIPGNNModel(tp_impl="fused_tp", **CONFIG), frame, v, nl_backend="device", device="cpu")


def test_device_driver_raises_on_overflow(models):
    """A capacity outgrown at a rebuild raises the JAX message at the next
    read-back: a captured graph's capacities cannot grow."""
    _, _, port = models
    frame = _box_frame()
    n = len(frame["pos"])
    driver = MDDriver(port, dict(frame), VelocityVerlet(dt_fs=2.0), masses=np.full(n, MASS), skin=1e-6,
                      steps_per_block=5, nl_backend="device", device="cpu")
    driver._nl_caps = (driver._nl_caps[0], 4)  # fewer neighbours an atom than fcc has
    with pytest.raises(RuntimeError, match=r"rebuild the MDDriver \(or use nl_backend='host'\)"):
        driver.run(15, velocities=0.02 * np.random.RandomState(3).standard_normal((n, 3)))
