"""optax's gradient transformations over one parameter group, and the
optimizer that runs an optax alias's chain of them.

The port never imports optax: each block below is written from optax
0.2.6's definition (``optax/_src/transform.py``, ``factorized.py``,
``transforms/_accumulation.py``, ``_adding.py``, ``_masking.py``,
``_clipping.py``, ``contrib/_reduce_on_plateau.py``) and held against it in
float64 by ``tests/test_torch_port_optax.py``.  A block is an object with

    init(params, paths) -> state
    update(updates, state, params, value=None) -> (updates, state)

over the group's list of tensors (``paths`` are their JAX dotted paths,
which masks read); ``value`` is the loss, which ``scale_by_polyak`` and the
plateau scale read (``needs_value``).  A state is a dict of tensors, lists
of tensors and Python numbers, so ``torch.save`` stores it.

Quantities that span tensors (``scale_by_polyak``'s norm, the plateau
scale) span the group, which is the tensors one optax transform sees under
the JAX trainer's ``multi_transform``: a ``param_groups`` entry or the
base, frozen leaves outside.  Counts that only grow are Python ints; the
plateau's data-dependent counters stay tensors on the parameters' device,
so no step waits for the card.

``mu_dtype``/``accumulator_dtype`` store a moment in that dtype, cast where
optax casts it; a moment's decay multiplies a bfloat16 moment in bfloat16
with the decay rounded to bfloat16 first, as JAX multiplies by a weakly
typed Python float.  ``add_noise`` draws from a ``torch.Generator`` seeded
by ``seed`` (optax draws from JAX's threefry stream, which the port cannot
reproduce): the same variance, other numbers.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Tensors = List[torch.Tensor]
Rate = Union[float, Callable[[int], float]]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
           "float64": torch.float64}
_EPS_F64 = float(np.finfo(np.float64).eps)  # jnp.finfo(float).eps, which scale_by_polyak compares with


def canonical_dtype(name) -> Optional[torch.dtype]:
    """A state dtype named as optax's configs name it (``bfloat16``,
    ``jnp.float32``, ...), or None."""
    if name is None or isinstance(name, torch.dtype):
        return name
    key = str(name).rpartition(".")[2]
    if key not in _DTYPES:
        raise ValueError(f"state dtype {name!r} is not supported; use one of {', '.join(_DTYPES)}")
    return _DTYPES[key]


def _scaled(t: torch.Tensor, c: float) -> torch.Tensor:
    """``c * t`` as JAX computes it: in ``t``'s dtype, with ``c`` rounded to
    it first where that dtype is narrower than float32."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t * torch.tensor(c, dtype=t.dtype, device=t.device)
    return c * t


def moment(g: torch.Tensor, t: torch.Tensor, decay: float, order: int) -> torch.Tensor:
    """``optax.tree.update_moment``: ``(1 - decay) * g**order + decay * t``."""
    return (1 - decay) * (g if order == 1 else g**order) + _scaled(t, decay)


def _debias(t: torch.Tensor, decay: float, count: int) -> torch.Tensor:
    """``optax.tree.bias_correction``."""
    return t / (1 - decay**count)


def _nesterov_hat(mu: torch.Tensor, g: torch.Tensor, b1: float, count: int) -> torch.Tensor:
    return b1 * _debias(mu, b1, count + 1) + (1 - b1) * _debias(g, b1, count)


def _cast(ts: Tensors, dtype: Optional[torch.dtype]) -> Tensors:
    return ts if dtype is None else [t.to(dtype) for t in ts]


def _zeros(params: Tensors, dtype=None) -> Tensors:
    return [torch.zeros_like(p, dtype=dtype) for p in params]


def _full(params: Tensors, value: float) -> Tensors:
    return [torch.full_like(p, value) for p in params]


def _safe_norm(x: torch.Tensor, min_norm: float) -> torch.Tensor:
    """``numerics.safe_norm``: the 2-norm of the flattened tensor, ``min_norm`` at or below it."""
    norm = torch.linalg.vector_norm(x)
    return torch.where(norm <= min_norm, torch.full_like(norm, min_norm), norm)


@functools.lru_cache(maxsize=None)
def _libm_powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype, libm.powf.argtypes = ctypes.c_float, (ctypes.c_float, ctypes.c_float)
    return libm.powf


def _powf(x: float, y: float) -> np.float32:
    """``x ** y`` in float32 as XLA's CPU backend computes it, by the C
    library's ``powf`` (numpy's and torch's float32 pow round some
    arguments the other way)."""
    return np.float32(_libm_powf()(float(np.float32(x)), float(np.float32(y))))


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Transform:
    """The identity; the base of every block."""

    needs_value = False

    def init(self, params: Tensors, paths: Sequence[str]) -> dict:
        return {}

    def update(self, u: Tensors, state: dict, params: Tensors, value=None) -> Tuple[Tensors, dict]:
        return u, state


class Chain(Transform):
    """``optax.chain``: the blocks in order, each with its own state."""

    def __init__(self, *transforms: Transform):
        self.transforms = [t for t in transforms if type(t) is not Transform]
        self.needs_value = any(t.needs_value for t in self.transforms)

    def init(self, params, paths):
        return {"states": [t.init(params, paths) for t in self.transforms]}

    def update(self, u, state, params, value=None):
        states = []
        for t, s in zip(self.transforms, state["states"]):
            u, s = t.update(u, s, params, value)
            states.append(s)
        return u, {"states": states}


class Elementwise(Transform):
    """A stateless block ``u -> fn(u, p)`` a tensor at a time."""

    def __init__(self, fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
        self.fn = fn

    def update(self, u, state, params, value=None):
        return [self.fn(ui, p) for ui, p in zip(u, params)], state


def scale(step_size: float) -> Transform:
    return Elementwise(lambda u, p: step_size * u)


def scale_by_sign() -> Transform:
    return Elementwise(lambda u, p: torch.sign(u))


def scale_by_param_block_norm(min_scale: float = 1e-3) -> Transform:
    return Elementwise(lambda u, p: u * _safe_norm(p, min_scale))


def scale_by_param_block_rms(min_scale: float = 1e-3) -> Transform:
    def fn(u, p):
        rms = _rms(p)
        return u * torch.where(rms <= min_scale, torch.full_like(rms, min_scale), rms)

    return Elementwise(fn)


def clip_by_block_rms(threshold: float) -> Transform:
    return Elementwise(lambda u, p: u / torch.clamp(_rms(u) / threshold, min=1.0))


def scale_by_trust_ratio(min_norm: float = 0.0, trust_coefficient: float = 1.0, eps: float = 0.0) -> Transform:
    def fn(u, p):
        param_norm, update_norm = _safe_norm(p, min_norm), _safe_norm(u, min_norm)
        ratio = trust_coefficient * param_norm / (update_norm + eps)
        zero = (param_norm == 0.0) | (update_norm == 0.0)
        return u * torch.where(zero, torch.ones_like(ratio), ratio)

    return Elementwise(fn)


class ScaleBySchedule(Transform):
    """``scale_by_schedule``: ``fn(count) * u``, count 0 at the first update."""

    def __init__(self, fn: Callable[[int], float]):
        self.fn = fn

    def init(self, params, paths):
        return {"count": 0}

    def update(self, u, state, params, value=None):
        step = float(self.fn(state["count"]))
        return [step * ui for ui in u], {"count": state["count"] + 1}


def scale_by_learning_rate(learning_rate: Optional[Rate], *, flip_sign: bool = True) -> Transform:
    if learning_rate is None:
        return Transform()
    m = -1 if flip_sign else 1
    if callable(learning_rate):
        return ScaleBySchedule(lambda count: m * learning_rate(count))
    return scale(m * learning_rate)


class AddDecayedWeights(Transform):
    """``u + weight_decay * p``.  A scheduled weight decay is read at count 0
    on every update: optax's state keeps its count at 0 (``fromage`` with a
    scheduled rate is the alias that gives one)."""

    def __init__(self, weight_decay: Rate = 0.0):
        self.weight_decay = weight_decay

    def update(self, u, state, params, value=None):
        s = float(self.weight_decay(0)) if callable(self.weight_decay) else self.weight_decay
        return [ui + s * p for ui, p in zip(u, params)], state


def mask_of(spec, path: str) -> bool:
    """The entry of a nested-dict mask (a JAX parameter tree's layout, a
    bool at any level standing for its whole subtree) for a dotted path."""
    node = spec
    for key in path.split("."):
        if isinstance(node, bool):
            return node
        if not isinstance(node, dict) or key not in node:
            raise ValueError(f"the mask has no entry for parameter {path!r}")
        node = node[key]
    if not isinstance(node, bool):
        raise ValueError(f"the mask entry of parameter {path!r} is not a bool: {node!r}")
    return node


def check_mask(spec) -> None:
    """Refuse a mask the port cannot match to its tensors."""
    if isinstance(spec, dict) and ("_target_" in spec or "_partial_" in spec) or callable(spec):
        raise ValueError("a callable mask (a _target_/_partial_ config) is not supported: give the mask as a nested "
                         "dict of bools in the JAX parameter tree's layout")
    if not isinstance(spec, (bool, dict)):
        raise ValueError(f"a mask must be a bool or a nested dict of bools, got {spec!r}")


class Masked(Transform):
    """``optax.masked``: ``inner`` on the tensors the mask selects, the rest
    passed through."""

    def __init__(self, inner: Transform, mask):
        check_mask(mask)
        self.inner, self.mask, self.keep = inner, mask, None
        self.needs_value = inner.needs_value

    def init(self, params, paths):
        self.keep = [mask_of(self.mask, path) for path in paths]
        return {"inner": self.inner.init(self._pick(params), self._pick(list(paths)))}

    def _pick(self, xs):
        return [x for x, k in zip(xs, self.keep) if k]

    def update(self, u, state, params, value=None):
        new, inner = self.inner.update(self._pick(u), state["inner"], self._pick(params), value)
        it = iter(new)
        return [next(it) if k else ui for ui, k in zip(u, self.keep)], {"inner": inner}


def masked(inner: Transform, mask) -> Transform:
    return inner if mask is None else Masked(inner, mask)


def add_decayed_weights(weight_decay: Rate = 0.0, mask=None) -> Transform:
    return masked(AddDecayedWeights(weight_decay), mask)


class Trace(Transform):
    """``optax.trace``: ``t = u + decay * t``; Nesterov ``u + decay * t``."""

    def __init__(self, decay: float, nesterov: bool = False, accumulator_dtype=None):
        self.decay, self.nesterov, self.dtype = decay, nesterov, canonical_dtype(accumulator_dtype)

    def init(self, params, paths):
        return {"trace": _zeros(params, self.dtype)}

    def update(self, u, state, params, value=None):
        t = [ui + _scaled(ti, self.decay) for ui, ti in zip(u, state["trace"])]
        out = [ui + self.decay * ti for ui, ti in zip(u, t)] if self.nesterov else t
        return out, {"trace": _cast(t, self.dtype)}


class Ema(Transform):
    def __init__(self, decay: float, debias: bool = True, accumulator_dtype=None):
        self.decay, self.debias, self.dtype = decay, debias, canonical_dtype(accumulator_dtype)

    def init(self, params, paths):
        return {"count": 0, "ema": _zeros(params, self.dtype)}

    def update(self, u, state, params, value=None):
        ema = [moment(ui, ti, self.decay, 1) for ui, ti in zip(u, state["ema"])]
        count = state["count"] + 1
        out = [_debias(e, self.decay, count) for e in ema] if self.debias else ema
        return out, {"count": count, "ema": _cast(ema, self.dtype)}


class AddNoise(Transform):
    """``u + sqrt(eta / count**gamma) * N(0, 1)``, count 1 at the first
    update, the noise from a ``torch.Generator`` seeded by ``seed``."""

    def __init__(self, eta: float, gamma: float, seed: int = 0):
        self.eta, self.gamma, self.seed = eta, gamma, int(seed)

    def init(self, params, paths):
        gen = torch.Generator(device=params[0].device)
        gen.manual_seed(self.seed)
        return {"count": 0, "rng": gen.get_state()}

    def update(self, u, state, params, value=None):
        count = state["count"] + 1
        std = math.sqrt(self.eta / count**self.gamma)
        gen = torch.Generator(device=u[0].device)
        gen.set_state(state["rng"])
        out = [ui + std * torch.randn(ui.shape, generator=gen, dtype=ui.dtype, device=ui.device) for ui in u]
        return out, {"count": count, "rng": gen.get_state()}


class ScaleByRss(Transform):
    def __init__(self, initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        self.iav, self.eps = initial_accumulator_value, eps

    def init(self, params, paths):
        return {"sum_of_squares": _full(params, self.iav)}

    def update(self, u, state, params, value=None):
        sums = [g * g + t for g, t in zip(u, state["sum_of_squares"])]
        out = [torch.where(s > 0, torch.rsqrt(s + self.eps), torch.zeros_like(s)) * g for s, g in zip(sums, u)]
        return out, {"sum_of_squares": sums}


class ScaleByRms(Transform):
    """``scale_by_rms``, and ``scale_by_stddev`` with ``centered``."""

    def __init__(self, decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0, eps_in_sqrt: bool = True,
                 bias_correction: bool = False, centered: bool = False):
        self.decay, self.eps, self.initial_scale = decay, eps, initial_scale
        self.eps_in_sqrt, self.bias_correction, self.centered = eps_in_sqrt, bias_correction, centered

    def init(self, params, paths):
        state = {"count": 0, "nu": _full(params, self.initial_scale)}
        if self.centered:
            state["mu"] = _zeros(params)
        return state

    def update(self, u, state, params, value=None):
        d = self.decay
        nu = [moment(g, t, d, 2) for g, t in zip(u, state["nu"])]
        mu = [moment(g, t, d, 1) for g, t in zip(u, state["mu"])] if self.centered else None
        count = state["count"] + 1 if self.bias_correction else 0
        nu_hat = [_debias(n, d, count) for n in nu] if self.bias_correction else nu
        if self.centered:
            mu_hat = [_debias(m, d, count) for m in mu] if self.bias_correction else mu
            nu_hat = [n - m * m for n, m in zip(nu_hat, mu_hat)]
        if self.eps_in_sqrt:
            out = [torch.rsqrt(n + self.eps) * g for n, g in zip(nu_hat, u)]
        else:
            out = [1 / (torch.sqrt(n) + self.eps) * g for n, g in zip(nu_hat, u)]
        new = {"count": count, "nu": nu}
        if self.centered:
            new["mu"] = mu
        return out, new


class ScaleByAdam(Transform):
    """``scale_by_adam`` (``nesterov``, ``mu_dtype``); ``amsgrad`` divides by
    the running maximum of the bias-corrected second moment instead."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0, mu_dtype=None,
                 nesterov: bool = False, amsgrad: bool = False):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu_dtype, self.nesterov, self.amsgrad = canonical_dtype(mu_dtype), nesterov, amsgrad

    def init(self, params, paths):
        state = {"count": 0, "mu": _zeros(params, self.mu_dtype), "nu": _zeros(params)}
        if self.amsgrad:
            state["nu_max"] = _zeros(params)
        return state

    def update(self, u, state, params, value=None):
        b1, b2 = self.b1, self.b2
        mu = [moment(g, t, b1, 1) for g, t in zip(u, state["mu"])]
        nu = [moment(g, t, b2, 2) for g, t in zip(u, state["nu"])]
        count = state["count"] + 1
        if self.nesterov:
            mu_hat = [_nesterov_hat(m, g, b1, count) for m, g in zip(mu, u)]
        else:
            mu_hat = [_debias(m, b1, count) for m in mu]
        nu_hat = [_debias(n, b2, count) for n in nu]
        new = {"count": count, "mu": _cast(mu, self.mu_dtype), "nu": nu}
        if self.amsgrad:
            nu_hat = new["nu_max"] = [torch.maximum(a, b) for a, b in zip(state["nu_max"], nu_hat)]
        return [m / (torch.sqrt(v + self.eps_root) + self.eps) for m, v in zip(mu_hat, nu_hat)], new


class ScaleByAdamax(Transform):
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params, paths):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(self, u, state, params, value=None):
        count = state["count"] + 1
        mu = [moment(g, t, self.b1, 1) for g, t in zip(u, state["mu"])]
        nu = [torch.maximum(torch.abs(g) + self.eps, self.b2 * t) for g, t in zip(u, state["nu"])]
        return [_debias(m, self.b1, count) / n for m, n in zip(mu, nu)], {"count": count, "mu": mu, "nu": nu}


class ScaleByLion(Transform):
    def __init__(self, b1: float = 0.9, b2: float = 0.99, mu_dtype=None):
        self.b1, self.b2, self.mu_dtype = b1, b2, canonical_dtype(mu_dtype)

    def init(self, params, paths):
        return {"count": 0, "mu": _zeros(params, self.mu_dtype)}

    def update(self, u, state, params, value=None):
        out = [torch.sign((1.0 - self.b1) * g + _scaled(m, self.b1)) for g, m in zip(u, state["mu"])]
        mu = [moment(g, m, self.b2, 1) for g, m in zip(u, state["mu"])]
        return out, {"count": state["count"] + 1, "mu": _cast(mu, self.mu_dtype)}


class ScaleByAdadelta(Transform):
    def __init__(self, rho: float = 0.9, eps: float = 1e-6):
        self.rho, self.eps = rho, eps

    def init(self, params, paths):
        return {"e_g": _zeros(params), "e_x": _zeros(params)}

    def update(self, u, state, params, value=None):
        e_g = [moment(g, t, self.rho, 2) for g, t in zip(u, state["e_g"])]
        out = [torch.sqrt(x + self.eps) / torch.sqrt(eg + self.eps) * g for g, eg, x in zip(u, e_g, state["e_x"])]
        e_x = [moment(o, t, self.rho, 2) for o, t in zip(out, state["e_x"])]
        return out, {"e_g": e_g, "e_x": e_x}


class ScaleByAdan(Transform):
    def __init__(self, b1: float = 0.98, b2: float = 0.92, b3: float = 0.99, eps: float = 1e-8, eps_root: float = 0.0):
        self.b1, self.b2, self.b3, self.eps, self.eps_root = b1, b2, b3, eps, eps_root

    def init(self, params, paths):
        return {"m": _zeros(params), "v": _zeros(params), "n": _zeros(params), "g": _zeros(params), "t": 0}

    def update(self, u, state, params, value=None):
        b1, b2, b3 = self.b1, self.b2, self.b3
        diff = [torch.zeros_like(g) if state["t"] == 0 else g - pg for g, pg in zip(u, state["g"])]
        m = [moment(g, t, b1, 1) for g, t in zip(u, state["m"])]
        v = [moment(d, t, b2, 1) for d, t in zip(diff, state["v"])]
        n = [moment(g + (1 - b2) * d, t, b3, 2) for g, d, t in zip(u, diff, state["n"])]
        t = state["t"] + 1
        out = [(_debias(mi, b1, t) + (1 - b2) * _debias(vi, b2, t))
               / (torch.sqrt(_debias(ni, b3, t) + self.eps_root) + self.eps) for mi, vi, ni in zip(m, v, n)]
        return out, {"m": m, "v": v, "n": n, "g": [g.clone() for g in u], "t": t}


class ScaleByBelief(Transform):
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16, eps_root: float = 1e-16,
                 nesterov: bool = False):
        self.b1, self.b2, self.eps, self.eps_root, self.nesterov = b1, b2, eps, eps_root, nesterov

    def init(self, params, paths):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(self, u, state, params, value=None):
        b1, b2 = self.b1, self.b2
        mu = [moment(g, t, b1, 1) for g, t in zip(u, state["mu"])]
        nu = [moment(g - m, t, b2, 2) + self.eps_root for g, m, t in zip(u, mu, state["nu"])]
        count = state["count"] + 1
        if self.nesterov:
            mu_hat = [_nesterov_hat(m, g, b1, count) for m, g in zip(mu, u)]
        else:
            mu_hat = [_debias(m, b1, count) for m in mu]
        out = [m / (torch.sqrt(_debias(v, b2, count)) + self.eps) for m, v in zip(mu_hat, nu)]
        return out, {"count": count, "mu": mu, "nu": nu}


class ScaleByYogi(Transform):
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3, eps_root: float = 0.0,
                 initial_accumulator_value: float = 1e-6):
        self.b1, self.b2, self.eps, self.eps_root, self.iav = b1, b2, eps, eps_root, initial_accumulator_value

    def init(self, params, paths):
        return {"count": 0, "mu": _full(params, self.iav), "nu": _full(params, self.iav)}

    def update(self, u, state, params, value=None):
        mu = [moment(g, t, self.b1, 1) for g, t in zip(u, state["mu"])]
        nu = [v - (1 - self.b2) * torch.sign(v - g * g) * (g * g) for g, v in zip(u, state["nu"])]
        count = state["count"] + 1
        out = [_debias(m, self.b1, count) / (torch.sqrt(_debias(v, self.b2, count) + self.eps_root) + self.eps)
               for m, v in zip(mu, nu)]
        return out, {"count": count, "mu": mu, "nu": nu}


class ScaleByRadam(Transform):
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 threshold: float = 5.0, nesterov: bool = False):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.threshold, self.nesterov = threshold, nesterov

    def init(self, params, paths):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(self, u, state, params, value=None):
        b1, b2 = self.b1, self.b2
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        mu = [moment(g, t, b1, 1) for g, t in zip(u, state["mu"])]
        nu = [moment(g, t, b2, 2) for g, t in zip(u, state["nu"])]
        count = state["count"] + 1
        b2t = b2**count
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        if self.nesterov:
            mu_hat = [_nesterov_hat(m, g, b1, count) for m, g in zip(mu, u)]
        else:
            mu_hat = [_debias(m, b1, count) for m in mu]
        if ro >= self.threshold:
            with np.errstate(invalid="ignore"):
                r = float(np.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)))
            out = [r * m / (torch.sqrt(_debias(v, b2, count) + self.eps_root) + self.eps) for m, v in zip(mu_hat, nu)]
        else:
            out = mu_hat
        return out, {"count": count, "mu": mu, "nu": nu}


class ScaleByRprop(Transform):
    def __init__(self, learning_rate: float, eta_minus: float = 0.5, eta_plus: float = 1.2,
                 min_step_size: float = 1e-6, max_step_size: float = 50.0):
        self.lr, self.eta_minus, self.eta_plus = learning_rate, eta_minus, eta_plus
        self.min_step, self.max_step = min_step_size, max_step_size

    def init(self, params, paths):
        return {"step_sizes": _full(params, self.lr), "prev_updates": _zeros(params)}

    def update(self, u, state, params, value=None):
        steps, prevs = [], []
        for g, step, prev in zip(u, state["step_sizes"], state["prev_updates"]):
            s = g * prev
            grown = torch.clamp(torch.where(s > 0, step * self.eta_plus, step * self.eta_minus), self.min_step,
                                self.max_step)
            step = torch.where(s == 0, step, grown)
            steps.append(step)
            prevs.append(torch.where(s < 0, torch.zeros_like(g), step * torch.sign(g)))
        # optax returns the previous update (zeroed where the sign flipped), so the first update is zero
        out = [torch.where(g * prev < 0, torch.zeros_like(prev), prev) for g, prev in zip(u, state["prev_updates"])]
        return out, {"step_sizes": steps, "prev_updates": prevs}


class ScaleBySM3(Transform):
    def __init__(self, b1: float = 0.9, b2: float = 1.0, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params, paths):
        return {"mu": [[p.new_zeros(s) for s in p.shape] for p in params], "nu": _zeros(params)}

    def update(self, u, state, params, value=None):
        c0, c1 = ((1.0 - self.b2) if self.b2 != 1.0 else 1.0), self.b2
        accums = []
        for g, v in zip(u, state["mu"]):
            shaped = [vi.reshape([1] * i + [g.shape[i]] + [1] * (g.ndim - i - 1)) for i, vi in enumerate(v)]
            accums.append(c0 * g**2 + c1 * (shaped[0] if g.ndim < 2 else functools.reduce(torch.minimum, shaped)))
        up = [g * torch.where(a > 0, torch.rsqrt(a + self.eps), torch.zeros_like(a)) for g, a in zip(u, accums)]
        nu = [moment(x, t, self.b1, 1) for x, t in zip(up, state["nu"])]
        mu = [[a] if a.ndim < 2 else [torch.amax(a, dim=[j for j in range(a.ndim) if j != i]) for i in range(a.ndim)]
              for a in accums]
        return nu, {"mu": mu, "nu": nu}


class ScaleByNovograd(Transform):
    def __init__(self, b1: float = 0.9, b2: float = 0.25, eps: float = 1e-8, eps_root: float = 0.0,
                 weight_decay: float = 0.0):
        self.b1, self.b2, self.eps, self.eps_root, self.weight_decay = b1, b2, eps, eps_root, weight_decay

    def init(self, params, paths):
        return {"count": 0, "mu": _zeros(params), "nu": [p.new_zeros(()) for p in params]}

    def update(self, u, state, params, value=None):
        count = state["count"] + 1
        sq = [torch.linalg.vector_norm(g) ** 2 for g in u]
        nu = sq if count == 1 else [moment(s, n, self.b2, 1) for s, n in zip(sq, state["nu"])]
        add = [g / (torch.sqrt(n + self.eps_root) + self.eps) + self.weight_decay * p
               for g, n, p in zip(u, nu, params)]
        mu = add if count == 1 else [self.b1 * m + a for m, a in zip(state["mu"], add)]
        return list(mu), {"count": count, "mu": mu, "nu": nu}


class ScaleByOptimisticGradient(Transform):
    def __init__(self, alpha: float = 1.0, beta: float = 1.0):
        self.alpha, self.beta = alpha, beta

    def init(self, params, paths):
        return {"is_initial_step": True, "previous_gradient": _zeros(params)}

    def update(self, u, state, params, value=None):
        prev = u if state["is_initial_step"] else state["previous_gradient"]
        out = [(self.alpha + self.beta) * g - self.beta * pg for g, pg in zip(u, prev)]
        return out, {"is_initial_step": False, "previous_gradient": [g.clone() for g in u]}


class ScaleByPolyak(Transform):
    """``scale_by_polyak``: the update times ``min((value - f_min) /
    (||u||^2 + eps), max_learning_rate)`` over the group, 0 where ``||u||^2
    + eps`` is at most float64's epsilon."""

    needs_value = True

    def __init__(self, f_min: float = 0.0, max_learning_rate: float = 1.0, eps: float = 0.0, variant: str = "sps"):
        if variant not in ("sps", "sps+"):
            raise ValueError(f"Invalid argument value for Polyak SGD: variant={variant!r}")
        self.f_min, self.max_lr, self.eps, self.variant = f_min, max_learning_rate, eps, variant

    def update(self, u, state, params, value=None):
        if value is None:
            raise ValueError("polyak_sgd needs the loss value of the step")
        sq = sum(torch.sum(g * g) for g in u)
        gap = (torch.as_tensor(value, device=sq.device) - self.f_min).to(sq.dtype)
        if self.variant == "sps+":
            gap = torch.relu(gap)
        den = sq + self.eps
        step = torch.where(den <= _EPS_F64, torch.zeros_like(den), torch.clamp(gap / den, max=self.max_lr))
        return [step * g for g in u], state


class ScaleByFactoredRms(Transform):
    """Adafactor's ``scale_by_factored_rms``: a tensor whose second-largest
    dimension reaches ``min_dim_size_to_factor`` keeps row and column
    means of ``g**2`` (over its two largest dimensions), any other the full
    moment.  The decay ``1 - (count + 1)**-decay_rate`` is float32, as in
    optax (``_powf``)."""

    def __init__(self, factored: bool = True, decay_rate: float = 0.8, step_offset: int = 0,
                 min_dim_size_to_factor: int = 128, epsilon: float = 1e-30):
        self.factored, self.decay_rate, self.step_offset = factored, decay_rate, step_offset
        self.min_dim, self.epsilon = min_dim_size_to_factor, epsilon

    def dims(self, shape) -> Optional[Tuple[int, int]]:
        if not self.factored or len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.min_dim:
            return None
        return int(order[-2]), int(order[-1])

    def init(self, params, paths):
        rows, cols, full = [], [], []
        for p in params:
            dims = self.dims(tuple(p.shape))
            if dims is None:
                rows.append(p.new_zeros((1,))), cols.append(p.new_zeros((1,))), full.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                shape = list(p.shape)
                rows.append(p.new_zeros(shape[:d0] + shape[d0 + 1:]))
                cols.append(p.new_zeros(shape[:d1] + shape[d1 + 1:]))
                full.append(p.new_zeros((1,)))
        return {"count": 0, "v_row": rows, "v_col": cols, "v": full}

    def update(self, u, state, params, value=None):
        decay = np.float32(1.0) - _powf(state["count"] - self.step_offset + 1, -self.decay_rate)
        d, one_minus = float(decay), float(np.float32(1.0) - decay)
        out, rows, cols, full = [], [], [], []
        for g, v_row, v_col, v in zip(u, state["v_row"], state["v_col"], state["v"]):
            sq = g * g + self.epsilon
            dims = self.dims(tuple(g.shape))
            if dims is None:
                v = (d * v + one_minus * sq).to(g.dtype)
                out.append(g * v**-0.5)
            else:
                d1, d0 = dims
                v_row = (d * v_row + one_minus * torch.mean(sq, dim=d0)).to(g.dtype)
                v_col = (d * v_col + one_minus * torch.mean(sq, dim=d1)).to(g.dtype)
                row_mean = torch.mean(v_row, dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
                out.append(g * torch.unsqueeze((v_row / row_mean) ** -0.5, d0) * torch.unsqueeze(v_col**-0.5, d1))
            rows.append(v_row), cols.append(v_col), full.append(v)
        return out, {"count": state["count"] + 1, "v_row": rows, "v_col": cols, "v": full}


class ReduceOnPlateau(Transform):
    """``optax.contrib.reduce_on_plateau``: the updates times a scale that
    drops by ``factor`` after ``patience`` averages of ``accumulation_size``
    loss values without a relative improvement of ``rtol`` (and ``atol``),
    then waits ``cooldown`` averages.  The loss averages and the best value
    are float64 (optax's default float under x64), the scale has the
    group's lowest-precision parameter dtype."""

    needs_value = True

    def __init__(self, factor: float = 0.1, patience: int = 10, rtol: float = 1e-4, atol: float = 0.0,
                 cooldown: int = 0, accumulation_size: int = 1, min_scale: float = 0.0):
        if factor <= 0.0 or factor >= 1.0:
            raise ValueError(f"Factor must be in the range (0, 1), got factor = {factor}.")
        if rtol < 0.0 or atol < 0.0:
            raise ValueError(f"Both rtol and atol must be non-negative, got rtol = {rtol} and atol = {atol}.")
        if rtol == 0.0 and atol == 0.0:
            raise ValueError(f"At least one of rtol or atol must be positive, got rtol = {rtol} and atol = {atol}.")
        if rtol > 1.0:
            raise ValueError(f"rtol must be less than or equal to 1.0, got rtol = {rtol}.")
        self.factor, self.patience, self.rtol, self.atol = factor, patience, rtol, atol
        self.cooldown, self.accumulation_size, self.min_scale = cooldown, accumulation_size, min_scale

    def init(self, params, paths):
        device = params[0].device
        dtype = min((p.dtype for p in params), key=lambda t: torch.finfo(t).bits)
        f64 = dict(dtype=torch.float64, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return {"scale": torch.ones((), dtype=dtype, device=device), "best_value": torch.full((), math.inf, **f64),
                "plateau_count": torch.zeros((), **i32), "cooldown_count": torch.zeros((), **i32), "count": 0,
                "avg_value": torch.zeros((), **f64)}

    def update(self, u, state, params, value=None):
        if value is None:
            raise ValueError("reduce_on_plateau needs the loss value of the step")
        state = dict(state)
        count = state["count"] + 1
        avg = state["avg_value"]
        state["avg_value"] = (state["count"] * avg + torch.as_tensor(value, device=avg.device).to(avg.dtype)) / count
        state["count"] = count
        if count == self.accumulation_size:
            state = self._update_scale(state)
        return [state["scale"] * g for g in u], state

    def _update_scale(self, s: dict) -> dict:
        avg, best, scale = s["avg_value"], s["best_value"], s["scale"]
        improved = avg < (1 - self.rtol) * best - self.atol
        plateau = torch.where(improved, torch.zeros_like(s["plateau_count"]), s["plateau_count"] + 1)
        hit = plateau == self.patience
        cooling = s["cooldown_count"] > 0
        reduced = torch.clamp(torch.where(hit, scale * self.factor, scale), min=self.min_scale)
        zero = torch.zeros_like(plateau)
        return {
            "scale": torch.where(cooling, scale, reduced),
            "best_value": torch.where(improved, avg, best),
            "plateau_count": torch.where(cooling | hit, zero, plateau),
            "cooldown_count": torch.where(cooling, s["cooldown_count"] - 1,
                                          torch.where(hit, torch.full_like(zero, self.cooldown), zero)),
            "count": 0,
            "avg_value": torch.zeros_like(avg),
        }


def map_tensors(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


def _to_device(device):
    # generator states (uint8) stay on the CPU, where torch.Generator keeps them
    return lambda t: t if t.dtype == torch.uint8 else t.to(device)


class OptaxChain(torch.optim.Optimizer):
    """Runs one optax alias's chain per param group.

    Each group is ``{params, paths, chain, lr}``: ``chain`` a ``Transform``,
    ``paths`` its tensors' JAX dotted paths, ``lr`` a factor on the final
    update (1.0; the training module sets it to the epoch LR scale times
    the per-step schedule, which the JAX trainer applies after the
    optimizer).  A parameter without a gradient takes zeros, as in JAX.
    ``step(value=loss)`` hands the loss to the blocks that read it.
    ``state_dict()`` holds every chain's state under ``chains``."""

    def __init__(self, groups: Sequence[dict]):
        groups = [dict(g) for g in groups]
        chains = [g.pop("chain") for g in groups]
        paths = [g.pop("paths") for g in groups]
        super().__init__(groups, {"lr": 1.0})
        self.chains: List[Transform] = chains
        self.chain_states = [c.init(list(g["params"]), p) for c, g, p in zip(chains, self.param_groups, paths)]

    @property
    def needs_value(self) -> bool:
        return any(c.needs_value for c in self.chains)

    @torch.no_grad()
    def step(self, closure=None, value=None):
        for i, (group, chain) in enumerate(zip(self.param_groups, self.chains)):
            params = group["params"]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            updates, self.chain_states[i] = chain.update(grads, self.chain_states[i], params, value)
            for p, u in zip(params, updates):
                p.add_(u, alpha=group["lr"])

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        sd["chains"] = [map_tensors(s, lambda t: t.detach().to("cpu", copy=True)) for s in self.chain_states]
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        super().load_state_dict({k: v for k, v in state_dict.items() if k != "chains"})
        if len(state_dict["chains"]) != len(self.chains):
            raise ValueError("the checkpoint's optimizer has another number of param groups")
        self.chain_states = [map_tensors(s, _to_device(g["params"][0].device))
                             for s, g in zip(state_dict["chains"], self.param_groups)]
