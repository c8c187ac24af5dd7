"""The port's optax optimizers, schedules and transforms against optax 0.2.6,
float64 on the CPU.

* Every optimizer of ``optim.ALIASES`` that ``test_torch_port_optim.py``
  does not already hold (26 of optax's, ``noisy_sgd`` below) and
  ``optax.contrib.reduce_on_plateau``, from its config, at optax's defaults
  and at one other argument set, for 10 updates on a small tree (1-D, 2-D
  and 3-D leaves, and a 2-D leaf that Adafactor factors at
  ``min_dim_size_to_factor=4``) with the same numpy gradients and loss
  values: every tensor within 1e-12 of its max |value|.  The gradients are
  normal draws, so no update of a sign-based rule (``lion``, ``sign_sgd``,
  ``rprop``, ``fromage``'s trust ratio) sits at an exact zero, where a
  rounding could flip its sign.  optax runs eagerly (a ``jit`` per case
  would cost more than the updates).
* Each of the 14 schedules as an optimizer's ``learning_rate`` (the 7 of
  ``SCHEDULE_ARGS`` and the ones ``test_torch_port_optim.py`` holds as
  ``lr_scheduler``).  optax's ``scale_by_schedule`` counts in int32, where
  some schedules compute in float32; the reference evaluates them at an
  int64 count (float64), as the port does.
* A ``polyak_sgd`` and a ``reduce_on_plateau`` whose scale moves within the
  run, read from the loss the module hands over; a dict ``mask``; the
  state dtypes; ``noisy_sgd``; a checkpoint's round trip.
"""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import optax.contrib
import pytest
import torch

from nequip_tpu_torch.train import transforms as T
from nequip_tpu_torch.train.optim import ALIASES, build_optimizer, param_groups, step_optimizer
from nequip_tpu_torch.train.schedules import SCHEDULES

SHAPES = {"layer.w": (3, 7), "layer.b": (4,), "t": (2, 3, 4), "f": (5, 6)}
STEPS = 10
VALUES = [3.0, 2.5, 2.6, 2.7, 2.4, 2.45, 2.5, 2.55, 2.6, 2.65]  # the loss handed to each update
MASK = {"layer": {"w": True, "b": False}, "t": True, "f": False}

# name: (optax's defaults, another argument set)
CASES = {
    "adabelief": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "b1": 0.8, "eps": 1e-8, "nesterov": True}),
    "adadelta": ({}, {"learning_rate": 0.5, "rho": 0.8, "weight_decay": 0.1, "weight_decay_mask": MASK}),
    "adafactor": ({}, {"learning_rate": 0.05, "min_dim_size_to_factor": 4, "decay_rate": 0.7, "decay_offset": -1,
                       "clipping_threshold": 0.5, "momentum": 0.9, "dtype_momentum": "float64",
                       "weight_decay_rate": 0.01}),
    "adagrad": ({"learning_rate": 0.01}, {"learning_rate": 0.1, "initial_accumulator_value": 0.5, "eps": 1e-4}),
    "adamax": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "b1": 0.8, "b2": 0.9, "eps": 1e-4}),
    "adamaxw": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "weight_decay": 0.1, "mask": MASK}),
    "adan": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "b1": 0.9, "b2": 0.8, "b3": 0.95, "eps_root": 1e-6,
                                       "weight_decay": 0.05}),
    "amsgrad": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "b1": 0.8, "b2": 0.9, "eps_root": 1e-8}),
    "fromage": ({"learning_rate": 0.01}, {"learning_rate": 0.3, "min_norm": 1e-3}),
    "lamb": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "b1": 0.8, "weight_decay": 0.1, "mask": MASK}),
    "lars": ({"learning_rate": 0.01}, {"learning_rate": 0.5, "weight_decay": 0.1, "weight_decay_mask": MASK,
                                       "trust_coefficient": 0.01, "eps": 1e-6,
                                       "trust_ratio_mask": {"layer": True, "t": False, "f": True},
                                       "momentum": 0.8, "nesterov": True}),
    "lion": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "b1": 0.8, "b2": 0.95, "weight_decay": 0.1,
                                       "mask": MASK}),
    "nadam": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "b1": 0.8, "eps_root": 1e-8}),
    "nadamw": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "weight_decay": 0.1, "mask": MASK}),
    "novograd": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "b1": 0.8, "b2": 0.5, "eps_root": 1e-8,
                                           "weight_decay": 0.1}),
    "optimistic_adam": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "optimism": 0.05, "b1": 0.8,
                                                  "nesterov": False}),
    "optimistic_adam_v2": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "alpha": 0.7, "beta": 0.4,
                                                     "nesterov": False}),
    "optimistic_gradient_descent": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "alpha": 0.6, "beta": 0.3}),
    "polyak_sgd": ({}, {"max_learning_rate": 0.05, "scaling": 0.5, "f_min": 1.0, "eps": 1e-3, "variant": "sps+"}),
    "radam": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "b2": 0.9, "threshold": 4.5, "nesterov": True}),
    "rmsprop": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "decay": 0.8, "initial_scale": 0.1,
                                          "eps_in_sqrt": False, "centered": True, "momentum": 0.9, "nesterov": True,
                                          "bias_correction": True}),
    "rprop": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "eta_minus": 0.4, "eta_plus": 1.5,
                                        "min_step_size": 0.015, "max_step_size": 0.05}),
    "sign_sgd": ({"learning_rate": 0.01}, {"learning_rate": 0.003}),
    "sm3": ({"learning_rate": 0.01}, {"learning_rate": 0.05, "momentum": 0.5}),
    "yogi": ({"learning_rate": 0.01}, {"learning_rate": 0.02, "b1": 0.8, "b2": 0.9, "eps": 1e-4}),
    "contrib.reduce_on_plateau": ({}, {"factor": 0.5, "patience": 1, "rtol": 0.0, "atol": 0.01, "cooldown": 1,
                                       "accumulation_size": 2, "min_scale": 0.3}),
}
# the rmsprop non-default set takes the centered path; the plain one with every other option:
CASES["rmsprop_plain"] = ({"learning_rate": 0.01, "momentum": 0.5}, {"learning_rate": 0.02, "decay": 0.8,
                                                                     "initial_scale": 0.1, "bias_correction": True})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nest(flat: dict) -> dict:
    out = {}
    for path, v in flat.items():
        node = out
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _problem(seed=0, steps=STEPS):
    rng = np.random.RandomState(seed)
    p0 = {k: rng.standard_normal(s) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s) for k, s in SHAPES.items()} for _ in range(steps)]
    return p0, grads


def run_optax(tx, p0, grads, values=VALUES):
    p = _nest({k: jnp.asarray(v) for k, v in p0.items()})
    state = tx.init(p)
    for g, v in zip(grads, values):
        u, state = tx.update(_nest({k: jnp.asarray(x) for k, x in g.items()}), state, p, value=jnp.asarray(v))
        p = optax.apply_updates(p, u)
    return {k: np.asarray(x) for k, x in _flatten(p).items()}, state


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def run_port(cfg, p0, grads, values=VALUES, dtype=torch.float64):
    ps = {k: torch.nn.Parameter(torch.tensor(v, dtype=dtype)) for k, v in p0.items()}
    opt = build_optimizer(param_groups(cfg, list(ps.values()), list(ps)))
    for g, v in zip(grads, values):
        for k, p in ps.items():
            p.grad = torch.tensor(g[k], dtype=dtype)
        step_optimizer(opt, torch.tensor(v, dtype=torch.float64))
    return {k: p.detach().numpy() for k, p in ps.items()}, opt


def assert_close(got, want, rel=1e-12):
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= rel * np.abs(want[k]).max(), (k, err)


def _optax_fn(name):
    mod, _, attr = name.rpartition(".")
    return getattr(optax.contrib if mod == "contrib" else optax, attr)


@pytest.mark.parametrize("which", ["defaults", "other"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_optax(name, which):
    kwargs = CASES[name][which == "other"]
    alias = name.removesuffix("_plain")
    p0, grads = _problem()
    want, _ = run_optax(_optax_fn(alias)(**copy.deepcopy(kwargs)), p0, grads)
    got, opt = run_port({"_target_": f"optax.{alias}", **kwargs}, p0, grads)
    assert type(opt).__name__ in ("OptaxChain", "Adam"), type(opt)
    assert_close(got, want)


def test_every_alias_is_held():
    """Every alias of the port is held here or in test_torch_port_optim.py
    (adam, adamw, sgd) and noisy_sgd's tests below."""
    assert set(ALIASES) == {n.removesuffix("_plain") for n in CASES} | {"adam", "adamw", "sgd", "noisy_sgd"}


@pytest.mark.parametrize("name", ["scale_by_param_block_norm", "scale_by_param_block_rms"])
def test_param_block_scales(name):
    """The two parameter-scale blocks (Adafactor chains the second) against
    optax's, with a leaf below ``min_scale`` (1e-3) and one above."""
    p0, grads = _problem(seed=10)
    p0["layer.b"] = p0["layer.b"] * 1e-5
    tx = getattr(optax, name)()
    want = tx.update(_nest({k: jnp.asarray(v) for k, v in grads[0].items()}), tx.init(None),
                     _nest({k: jnp.asarray(v) for k, v in p0.items()}))[0]
    got, _ = getattr(T, name)().update([torch.tensor(grads[0][k]) for k in SHAPES], {},
                                       [torch.tensor(p0[k]) for k in SHAPES])
    assert_close(dict(zip(SHAPES, (t.numpy() for t in got))), {k: np.asarray(v) for k, v in _flatten(want).items()})


def test_adafactor_factors_the_wide_leaf():
    p0, grads = _problem()
    _, opt = run_port({"_target_": "optax.adafactor", **CASES["adafactor"][1]}, p0, grads)
    factored = opt.chains[0].transforms[0]
    assert [factored.dims(s) is not None for s in SHAPES.values()] == [False, False, False, True]
    state = opt.chain_states[0]["states"][0]
    assert [tuple(t.shape) for t in state["v_row"]][-1] == (5,) and tuple(state["v_col"][-1].shape) == (6,)


def test_plateau_scale_moves_within_the_run():
    p0, grads = _problem()
    kwargs = CASES["contrib.reduce_on_plateau"][1]
    _, state = run_optax(optax.contrib.reduce_on_plateau(**kwargs), p0, grads)
    _, opt = run_port({"_target_": "optax.contrib.reduce_on_plateau", **kwargs}, p0, grads)
    ours = opt.chain_states[0]["states"][0]
    assert float(state.scale) < 1.0 and float(ours["scale"]) == float(state.scale)
    for k in ("best_value", "plateau_count", "cooldown_count", "avg_value"):
        assert float(ours[k]) == float(getattr(state, k)), k


SCHEDULE_LRS = {
    "lion": ("warmup_cosine_decay_schedule", {"init_value": 0.0, "peak_value": 0.02, "warmup_steps": 3,
                                              "decay_steps": 9, "end_value": 0.001}),
    "rmsprop": ("exponential_decay", {"init_value": 0.02, "transition_steps": 2, "decay_rate": 0.7}),
    "polyak_sgd": ("sgdr_schedule", {"cosine_kwargs": [
        {"init_value": 0.1, "peak_value": 0.5, "warmup_steps": 2, "decay_steps": 4},
        {"init_value": 0.2, "peak_value": 0.4, "warmup_steps": 1, "decay_steps": 6}]}),
    "fromage": ("linear_onecycle_schedule", {"transition_steps": 8, "peak_value": 0.3}),
    "adam": ("cosine_onecycle_schedule", {"transition_steps": 9, "peak_value": 0.02}),
}


def _int64_count(schedule):
    return lambda count: schedule(jnp.asarray(count, dtype=jnp.int64))


@pytest.mark.parametrize("name", sorted(SCHEDULE_LRS))
def test_schedule_as_learning_rate(name):
    sched, kwargs = SCHEDULE_LRS[name]
    key = "scaling" if name == "polyak_sgd" else "learning_rate"
    p0, grads = _problem(seed=4)
    want, _ = run_optax(getattr(optax, name)(**{key: _int64_count(getattr(optax.schedules, sched)(**kwargs))}),
                        p0, grads)
    got, opt = run_port({"_target_": f"optax.{name}", key: {"_target_": f"optax.{sched}", **kwargs}}, p0, grads)
    assert type(opt).__name__ == "OptaxChain"
    assert_close(got, want)


def _schedules():
    from test_torch_port_optim import SCHEDULE_ARGS, optax_schedule

    return SCHEDULE_ARGS, optax_schedule


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_every_schedule_as_sgd_learning_rate(sched):
    """SGD's update is -lr(count) * g: each schedule's values at counts 0-9
    through the chain's own count."""
    args, optax_schedule = _schedules()
    kwargs = args[sched]
    p0, grads = _problem(seed=5)
    want, _ = run_optax(optax.sgd(_int64_count(optax_schedule(sched, copy.deepcopy(kwargs)))), p0, grads)
    got, _ = run_port({"_target_": "optax.sgd", "learning_rate": {"_target_": f"optax.schedules.{sched}", **kwargs}},
                      p0, grads)
    assert_close(got, want)


# the moments a state dtype rounds: (optimizer, its arguments, the dtype argument)
DTYPE_CASES = {
    "adam": ({"learning_rate": 0.01}, "mu_dtype"),
    "adamw": ({"learning_rate": 0.01, "weight_decay": 0.1}, "mu_dtype"),
    "nadam": ({"learning_rate": 0.01}, "mu_dtype"),
    "amsgrad": ({"learning_rate": 0.01}, "mu_dtype"),
    "lion": ({"learning_rate": 0.01}, "mu_dtype"),
    "optimistic_adam_v2": ({"learning_rate": 0.01}, "mu_dtype"),
    "sgd": ({"learning_rate": 0.01, "momentum": 0.9, "nesterov": True}, "accumulator_dtype"),
    "adafactor": ({"learning_rate": 0.05, "momentum": 0.9}, "dtype_momentum"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DTYPE_CASES))
def test_state_dtype(name, dtype):
    """A moment stored in float32 or bfloat16, float64 parameters.  optax
    and the port round the same values at the same points, so they agree
    to float64's rounding (1e-12 of max |p|); a bfloat16 moment ties
    between two bf16 values only where float64 rounding could move it, which
    these draws never hit.  Lion's update is the sign of a bf16-rounded mix,
    the others scale by the moment."""
    kwargs, key = DTYPE_CASES[name]
    kwargs = {**kwargs, key: dtype}
    p0, grads = _problem(seed=6)
    want, _ = run_optax(getattr(optax, name)(**{**kwargs, key: getattr(jnp, dtype)}), p0, grads)
    got, opt = run_port({"_target_": f"optax.{name}", **kwargs}, p0, grads)
    assert_close(got, want)
    stored = [t.dtype for t in _state_tensors(opt) if t.dtype != torch.float64 and t.is_floating_point()]
    assert stored and set(stored) == {getattr(torch, dtype)}


def _state_tensors(opt):
    if isinstance(opt, torch.optim.Optimizer) and not hasattr(opt, "chain_states"):
        return [t for s in opt.state.values() for t in s.values() if isinstance(t, torch.Tensor)]
    out = []
    T.map_tensors(opt.chain_states, lambda t: out.append(t) or t)
    return out


@pytest.mark.parametrize("name", ["adamw", "nadamw"])
def test_dict_mask_on_adamw(name):
    """A masked adamw takes optax's chain, where every alias's mask lives."""
    p0, grads = _problem(seed=7)
    kwargs = {"learning_rate": 0.01, "weight_decay": 0.2, "mask": MASK}
    want, _ = run_optax(getattr(optax, name)(**kwargs), p0, grads)
    got, opt = run_port({"_target_": f"optax.{name}", **kwargs}, p0, grads)
    assert type(opt) is T.OptaxChain
    assert_close(got, want)


def test_mask_errors():
    ps = [torch.nn.Parameter(torch.zeros(2)) for _ in range(2)]
    with pytest.raises(ValueError, match="callable mask"):
        param_groups({"_target_": "optax.lion", "learning_rate": 0.1,
                      "mask": {"_target_": "my.mask_fn", "_partial_": True}}, ps, ["a", "b"])
    with pytest.raises(ValueError, match="no entry for parameter 'b'"):
        build_optimizer(param_groups({"_target_": "optax.lamb", "learning_rate": 0.1, "weight_decay": 0.1,
                                      "mask": {"a": True}}, ps, ["a", "b"]))


def test_noisy_sgd_without_noise_is_optax():
    p0, grads = _problem(seed=8)
    want, _ = run_optax(optax.noisy_sgd(0.01, eta=0.0, key=3), p0, grads)
    got, _ = run_port({"_target_": "optax.noisy_sgd", "learning_rate": 0.01, "eta": 0.0, "key": 3}, p0, grads)
    assert_close(got, want)


def test_noisy_sgd_noise_variance():
    """With zero gradients the update is -lr times the noise: per step, a
    draw of 20,000 numbers has the variance eta / (1 + count)**gamma within
    5 standard errors, and the same seed draws the same numbers."""
    eta, gamma, lr, n, steps = 0.5, 0.55, 2.0, 20000, 4
    cfg = {"_target_": "optax.noisy_sgd", "learning_rate": lr, "eta": eta, "gamma": gamma, "key": 11}
    runs = []
    for _ in range(2):
        p = torch.nn.Parameter(torch.zeros(n, dtype=torch.float64))
        opt = build_optimizer(param_groups(cfg, [p], ["p"]))
        moves = []
        for _ in range(steps):
            before = p.detach().clone()
            p.grad = torch.zeros_like(p)
            step_optimizer(opt)
            moves.append((p.detach() - before) / -lr)
        runs.append(moves)
    for count, noise in enumerate(runs[0]):
        var = eta / (1 + count) ** gamma
        assert abs(float(noise.var()) - var) <= 5 * var * np.sqrt(2 / n), count
        assert abs(float(noise.mean())) <= 5 * np.sqrt(var / n), count
        assert torch.equal(noise, runs[1][count])


def test_chain_state_round_trips():
    """Five updates, a state_dict through torch.save, five more against ten
    straight, bitwise (lion in bf16, a plateau, adafactor factored)."""
    cfgs = [{"_target_": "optax.lion", "learning_rate": 0.01, "mu_dtype": "bfloat16"},
            {"_target_": "optax.contrib.reduce_on_plateau", **CASES["contrib.reduce_on_plateau"][1]},
            {"_target_": "optax.adafactor", **CASES["adafactor"][1]},
            {"_target_": "optax.adam", "learning_rate": 0.01, "mu_dtype": "bfloat16"},
            {"_target_": "optax.noisy_sgd", "learning_rate": 0.01, "key": 2}]
    p0, grads = _problem(seed=9)
    for cfg in cfgs:
        straight, _ = run_port(cfg, p0, grads)
        half, opt = run_port(cfg, p0, grads[:5], VALUES[:5])
        buf = __import__("io").BytesIO()
        torch.save(opt.state_dict(), buf)
        ps = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in half.items()}
        again = build_optimizer(param_groups(cfg, list(ps.values()), list(ps)))
        buf.seek(0)
        again.load_state_dict(torch.load(buf, weights_only=False))
        for g, v in zip(grads[5:], VALUES[5:]):
            for k, p in ps.items():
                p.grad = torch.tensor(g[k])
            step_optimizer(again, torch.tensor(v, dtype=torch.float64))
        for k in straight:
            np.testing.assert_array_equal(ps[k].detach().numpy(), straight[k], err_msg=f"{cfg['_target_']} {k}")


def test_adam_state_of_earlier_checkpoints_loads():
    """``optim.Adam``'s groups gained ``mu_dtype``: a state dict written
    without it (by earlier versions, e.g. for ``eps_root``) loads and steps
    as before."""
    cfg = {"_target_": "optax.adam", "learning_rate": 0.01, "eps_root": 1e-8}
    p0, grads = _problem(seed=12)
    straight, _ = run_port(cfg, p0, grads)
    half, opt = run_port(cfg, p0, grads[:5])
    sd = opt.state_dict()
    for g in sd["param_groups"]:
        del g["mu_dtype"]
    ps = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in half.items()}
    again = build_optimizer(param_groups(cfg, list(ps.values()), list(ps)))
    again.load_state_dict(sd)
    for g in grads[5:]:
        for k, p in ps.items():
            p.grad = torch.tensor(g[k])
        step_optimizer(again)
    for k in straight:
        np.testing.assert_array_equal(ps[k].detach().numpy(), straight[k], err_msg=k)
