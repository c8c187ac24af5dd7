"""The model test suite for downstream model packages, in the port.

Port of ``nequip_tpu/utils/unittests/model_tests.py``.  A package
subclasses ``BaseEnergyModelTests`` and gives a ``model_config`` fixture
(a config with a ``_target_``, as its ``@model_builder`` takes it):

.. code-block:: python

    from nequip_tpu_torch.utils.unittests import BaseEnergyModelTests

    class TestMyModel(BaseEnergyModelTests):
        @pytest.fixture(scope="class", params=[...])
        def model_config(self, request):
            return request.param

The ``device`` fixture is ``"cpu"`` (the kernels' plain twins); override it
with ``"cuda"`` to run the suite on the card, through the kernels.  The
``frame_fields`` fixture (none by default) adds per-frame inputs that a
model reads (a total charge for a categorical embedding) to every frame.

Gates: the forward contract, padding invariance, batched against single
frames, O(3) and permutation equivariance, numeric against autodiff
forces, isolated-atom energies, the cross-frame gradient, partial forces,
force smoothness at the cutoff and the embedding cutoff.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ...data import _keys, batched_from_list, compute_neighborlist_, from_dict, pad_batch, to_tensors
from ...nn.grad_output import ForceStressOutput, PartialForceOutput
from ..config import instantiate
from ..test_utils import assert_O3_equivariant, assert_permutation_equivariant

_CAPS = (128, 2048, 3)


def _box_frame(seed: int, n: int, n_types: int, r_max: float, fields: dict) -> dict:
    rng = np.random.RandomState(seed)
    f = from_dict({
        **fields,
        _keys.POSITIONS_KEY: rng.uniform(0, 7.0, (n, 3)),
        _keys.CELL_KEY: np.diag([7.0, 7.0, 7.0]),
        _keys.PBC_KEY: np.array([True] * 3),
        _keys.ATOM_TYPE_KEY: rng.randint(0, n_types, n),
        _keys.ATOMIC_NUMBERS_KEY: np.full(n, 29),
    })
    return compute_neighborlist_(f, r_max)


def _energy_graph(model, data: dict, pos: torch.Tensor) -> dict:
    """The outputs of the energy graph (inside ``ForceStressOutput``) at
    positions ``pos``, differentiable with respect to them."""
    return model.model.func(model._inputs(dict(data, **{_keys.POSITIONS_KEY: pos})))


class BaseEnergyModelTests:
    """Subclass and give a ``model_config`` fixture (a config with ``_target_``)."""

    @pytest.fixture(scope="class")
    def device(self):
        return "cpu"

    @pytest.fixture(scope="class")
    def frame_fields(self):
        return {}

    @pytest.fixture(scope="class")
    def r_max(self, model_config):
        return float(model_config.get("r_max", 4.0))

    @pytest.fixture(scope="class")
    def n_types(self, model_config):
        return len(model_config.get("type_names", ["Cu"]))

    @pytest.fixture(scope="class")
    def model(self, model_config, device):
        return instantiate(model_config).to(device).requires_grad_(False)

    @pytest.fixture(scope="class")
    def padded(self, device):
        def _padded(frames, caps=_CAPS):
            return to_tensors(pad_batch(batched_from_list(frames), *caps), device)

        return _padded

    @pytest.fixture(scope="class")
    def frame(self, r_max, n_types, frame_fields):
        return _box_frame(7, 24, n_types, r_max, frame_fields)

    def test_forward_contract(self, model, padded, frame):
        out = model(padded([frame]))
        assert _keys.TOTAL_ENERGY_KEY in out and _keys.PER_ATOM_ENERGY_KEY in out
        assert np.isfinite(float(out[_keys.TOTAL_ENERGY_KEY][0, 0]))

    def test_padding_invariance(self, model, padded, frame):
        e1 = float(model(padded([frame]))[_keys.TOTAL_ENERGY_KEY][0, 0])
        e2 = float(model(padded([frame], caps=(256, 4096, 4)))[_keys.TOTAL_ENERGY_KEY][0, 0])
        assert e1 == pytest.approx(e2, rel=1e-9)

    def test_batched_vs_single(self, model, padded, frame, r_max, n_types, frame_fields):
        f2 = _box_frame(8, 10, n_types, r_max, frame_fields)
        eb = float(model(padded([frame, f2]))[_keys.TOTAL_ENERGY_KEY][0, 0])
        e1 = float(model(padded([frame]))[_keys.TOTAL_ENERGY_KEY][0, 0])
        assert eb == pytest.approx(e1, rel=1e-9)

    def test_equivariance(self, model, frame, device):
        assert_O3_equivariant(model, frame, capacities=_CAPS, tol=1e-7, device=device)
        assert_permutation_equivariant(model, frame, capacities=_CAPS, tol=1e-8, device=device)

    def test_numeric_gradient(self, model, padded, frame):
        data = padded([frame])
        out = model(data)
        if _keys.FORCE_KEY not in out:
            pytest.skip("model has no force output")
        forces = out[_keys.FORCE_KEY].cpu().numpy()
        h = 1e-5
        for atom, axis in [(0, 0), (3, 2)]:
            es = []
            for sgn in (+h, -h):
                pos = data[_keys.POSITIONS_KEY].clone()
                pos[atom, axis] += sgn
                es.append(float(model(dict(data, **{_keys.POSITIONS_KEY: pos}))[_keys.TOTAL_ENERGY_KEY][0, 0]))
            assert forces[atom, axis] == pytest.approx(-(es[0] - es[1]) / (2 * h), rel=1e-4, abs=1e-6)

    def test_isolated_atom_energies(self, model, padded, model_config, r_max, n_types, frame_fields):
        """Isolated atoms give exactly the configured per-type energy shifts,
        and no force.  With ``learnable_shift`` the first layer's
        self-connection adds a learned per-type energy (JAX
        ``nequip_models.py``): two isolated atoms of one type then have
        equal energies."""

        def isolated(types):
            f = compute_neighborlist_(from_dict({
                **frame_fields,
                _keys.POSITIONS_KEY: np.array([[0.0, 0.0, 0.0], [100.0, 0.0, 0.0]]),
                _keys.ATOM_TYPE_KEY: np.array(types),
                _keys.ATOMIC_NUMBERS_KEY: np.array([29, 29]),
            }), r_max)
            return model(padded([f]))

        out = isolated([0, min(1, n_types - 1)])
        e_pair = out[_keys.PER_ATOM_ENERGY_KEY][:2].reshape(-1).cpu().numpy()
        if _keys.FORCE_KEY in out:
            np.testing.assert_allclose(out[_keys.FORCE_KEY][:2].cpu().numpy(), 0.0, atol=1e-10)
        assert np.all(np.isfinite(e_pair))
        shifts = model_config.get("per_type_energy_shifts")
        if model_config.get("learnable_shift"):
            e_same = isolated([0, 0])[_keys.PER_ATOM_ENERGY_KEY][:2].reshape(-1).cpu().numpy()
            assert e_same[0] == pytest.approx(e_same[1], rel=1e-12) and e_same[0] == pytest.approx(e_pair[0], rel=1e-12)
        elif isinstance(shifts, dict):
            names = model_config["type_names"]
            np.testing.assert_allclose(e_pair, [shifts[names[0]], shifts[names[min(1, n_types - 1)]]],
                                       rtol=1e-10, atol=1e-12)

    def test_cross_frame_grad(self, model, padded, frame, r_max, n_types, frame_fields):
        """The gradient of one frame's energy with respect to another frame's
        positions is exactly zero."""
        f2 = _box_frame(21, 12, n_types, r_max, frame_fields)
        data = padded([frame, f2])
        pos = data[_keys.POSITIONS_KEY].clone().requires_grad_(True)
        with torch.enable_grad():
            (grads,) = torch.autograd.grad(_energy_graph(model, data, pos)[_keys.TOTAL_ENERGY_KEY][1].sum(), pos)
        batch = data[_keys.BATCH_KEY].reshape(-1)
        in_frame, cross = grads[batch == 1], grads[batch != 1]
        assert float(cross.abs().max()) == 0.0, "cross-frame gradient leak"
        assert float(in_frame.abs().max()) > 0.0, "in-frame gradient vanished"
        assert in_frame.shape[0] >= 12 and cross.shape[0] >= frame[_keys.POSITIONS_KEY].shape[0]

    def test_partial_forces(self, model, padded, frame):
        """Partial forces: the ``[E_j, pos_i]`` jacobian sums to the forces,
        with exact cross-frame sparsity."""
        if not isinstance(getattr(model, "model", None), ForceStressOutput):
            pytest.skip("model is not ForceStressOutput-wrapped")
        data = padded([frame])
        out = model(data)
        partial_out = PartialForceOutput(model.model.func)(model._inputs(data))
        np.testing.assert_allclose(partial_out[_keys.PER_ATOM_ENERGY_KEY].cpu().numpy(),
                                   out[_keys.PER_ATOM_ENERGY_KEY].cpu().numpy(), atol=1e-10)
        n_cap = data[_keys.POSITIONS_KEY].shape[0]
        partial = partial_out[_keys.PARTIAL_FORCE_KEY].cpu().numpy()
        assert partial.shape == (n_cap, n_cap, 3)
        np.testing.assert_allclose(partial.sum(axis=0), out[_keys.FORCE_KEY].cpu().numpy(), atol=1e-9)
        batch = data[_keys.BATCH_KEY].reshape(-1).cpu().numpy()
        assert np.all(partial[batch[:, None] != batch[None, :]] == 0.0)

    @pytest.fixture(scope="class")
    def pair_force(self, model, padded, r_max, frame_fields):
        """Forces ``[2, 3]`` of two atoms of the given types at distance ``d``."""

        def _pair_force(t1: int, t2: int, d: float):
            f = compute_neighborlist_(from_dict({
                **frame_fields,
                _keys.POSITIONS_KEY: np.array([[0.0, 0.0, 0.0], [d, 0.0, 0.0]]),
                _keys.ATOM_TYPE_KEY: np.array([t1, t2]),
                _keys.ATOMIC_NUMBERS_KEY: np.array([29, 1]),
            }), r_max)
            out = model(padded([f]))
            if _keys.FORCE_KEY not in out:
                pytest.skip("model has no force output")
            return out[_keys.FORCE_KEY][:2].cpu().numpy()

        return _pair_force

    def test_force_smoothness(self, model_config, pair_force, r_max, n_types):
        """Forces vanish at and beyond the cutoff and not inside it, for
        every type pair."""
        if model_config.get("per_edge_type_cutoff") is not None:
            pytest.skip("per-edge-type cutoffs")
        for t1 in range(n_types):
            for t2 in range(n_types):
                assert np.abs(pair_force(t1, t2, 0.5 * r_max)).sum() > 1e-4, f"no force inside the cutoff ({t1},{t2})"
                np.testing.assert_allclose(pair_force(t1, t2, r_max), 0.0, atol=1e-8)
                np.testing.assert_allclose(pair_force(t1, t2, 1.1 * r_max), 0.0, atol=1e-12)

    def test_embedding_cutoff(self, model, padded, r_max, frame_fields):
        """Edge embeddings go to zero at the cutoff, and an atom exactly at
        the cutoff leaves the other atoms' energies with zero gradient."""

        def three_atom(y2):
            return padded([from_dict({
                **frame_fields,
                _keys.POSITIONS_KEY: np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, y2, 0.0]]),
                _keys.ATOM_TYPE_KEY: np.array([0, 0, 0]),
                _keys.ATOMIC_NUMBERS_KEY: np.array([29, 29, 29]),
                # a fixed edge set, the 0<->2 pair included even at the cutoff
                _keys.EDGE_INDEX_KEY: np.array([[0, 1, 0, 2], [1, 0, 2, 0]], dtype=np.int32),
            })], caps=(8, 8, 2))

        out_in, out_at = model(three_atom(0.5 * r_max)), model(three_atom(r_max))
        if _keys.EDGE_EMBEDDING_KEY in out_in:
            # the model may reorder edges (the kernels' order): find them by pair
            def by_pair(out):
                ei = out[_keys.EDGE_INDEX_KEY].cpu().numpy()
                rows = {(int(d), int(s)): i for i, (d, s) in enumerate(ei.T[:4])}
                emb = out[_keys.EDGE_EMBEDDING_KEY].cpu().numpy()
                return np.stack([emb[rows[p]] for p in ((0, 1), (1, 0), (0, 2), (2, 0))])

            emb_in, emb_at = by_pair(out_in), by_pair(out_at)
            np.testing.assert_allclose(emb_at[:2], emb_in[:2], atol=1e-10)
            assert np.abs(emb_in[2:4]).sum() > 1e-6
            np.testing.assert_allclose(emb_at[2:4], 0.0, atol=1e-12)
        data = three_atom(r_max)
        pos = data[_keys.POSITIONS_KEY].clone().requires_grad_(True)
        with torch.enable_grad():
            e01 = _energy_graph(model, data, pos)[_keys.PER_ATOM_ENERGY_KEY][:2].sum()
            (grads,) = torch.autograd.grad(e01, pos)
        np.testing.assert_allclose(grads[2].cpu().numpy(), 0.0, atol=1e-10)
