"""The optimizer golden file that ``chip_smoke.py`` (phase 15a) holds the
card against.

``test_optim_golden_file_is_fresh`` rewrites the data with the JAX package
and requires the stored file to be unchanged (float64 recomputed on the
CPU at rtol 1e-12, Muon's case at 1e-7 of max: its Newton-Schulz runs in
float32).  ``test_port_matches_optim_golden`` runs phase 15a's check on the
CPU through ``chip_smoke.optim_golden_case`` (the kernels' plain twins):
three steps of each case, the weights and evaluation weights within 1e-8
of their max (Muon + Adam: 1e-5), and ConFIG with ``lsqr=True`` against
EMA-ConFIG's weights.
"""

import numpy as np
import pytest
import torch
from torch_port_optim_golden import CASES, OPTIM_GOLDEN, make_optim_golden

import chip_smoke

EXACT = ("pos", "cell", "pbc", "atomic_numbers", "config", "cases")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_optim_golden_file_is_fresh():
    stored = np.load(OPTIM_GOLDEN)
    fresh = make_optim_golden()
    assert sorted(stored.files) == sorted(fresh)
    for k, v in fresh.items():
        if k in EXACT or k.startswith("init/"):
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
        elif k.startswith("muon_adam/"):
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-7 * np.abs(v).max(), err_msg=k)
        else:
            np.testing.assert_allclose(stored[k], v, rtol=1e-12, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("run", chip_smoke.OPTIM_GOLDEN_RUNS, ids=lambda r: r[0] if r[1] is None else f"{r[0]}-{r[1]}")
def test_port_matches_optim_golden(run):
    name, module_name = run
    assert set(CASES) == {n for n, _ in chip_smoke.OPTIM_GOLDEN_RUNS}
    z = np.load(OPTIM_GOLDEN)
    params, evaluation = chip_smoke.optim_golden_case(z, name, "cpu", module_name)
    assert (evaluation is not None) == (name in ("ema_config_lsqr", "schedule_free") and module_name is None)
    p_err, e_err = chip_smoke.optim_golden_errors(z, name, params, evaluation)
    tol = chip_smoke.MUON_GOLDEN_TOL if name == "muon_adam" else chip_smoke.OPTIM_GOLDEN_TOL
    assert p_err <= tol and e_err <= tol, (p_err, e_err)
