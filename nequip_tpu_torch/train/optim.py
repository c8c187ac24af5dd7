"""Optimizers of a training module, built from the JAX package's optax configs.

An optimizer config is ``{_target_: <name>, <optax arguments>}``; the port
never imports optax and maps each name onto a ``torch.optim.Optimizer``
whose update is optax 0.2.6's:

* ``optax.adam`` / ``optax.nadam`` (``learning_rate``, ``b1``, ``b2``,
  ``eps``, ``eps_root``, ``mu_dtype``, ``nesterov``): ``torch.optim.Adam``
  when ``eps_root == 0``, without Nesterov and ``mu_dtype`` (its state
  layout, ``step``/``exp_avg``/``exp_avg_sq``, is what checkpoints hold),
  else ``Adam`` below;
* ``optax.adamw`` / ``optax.nadamw`` (the same and ``weight_decay``, whose
  default is optax's 1e-4): the update ``-lr * (adam + wd * p)``, which
  ``torch.optim.AdamW`` computes when ``eps_root == 0``, without Nesterov
  and ``mu_dtype``, else ``Adam``; with a ``mask``, optax's chain (below);
* ``optax.sgd`` (``learning_rate``, ``momentum`` (None: none),
  ``nesterov``): ``torch.optim.SGD``, whose buffer ``m * buf + g`` and
  Nesterov ``g + m * buf`` are optax's ``trace``; with
  ``accumulator_dtype``, optax's chain (below);
* the other 24 optax optimizers (``ALIASES``), ``optax.contrib.reduce_on_plateau``,
  and ``adam``/``adamw``/``sgd``/``nadam``/``nadamw`` with a schedule as
  ``learning_rate`` (``adamw``/``nadamw`` also with a ``mask``): ``transforms.OptaxChain`` running optax's chain of
  that alias (``transforms.py``).  A rate optax takes as a schedule may be
  a ``{_target_: optax.<schedule>, ...}`` config (``schedules.rate``);
  ``mask``, ``weight_decay_mask`` and ``trust_ratio_mask`` are a bool or a
  nested dict of bools in the JAX parameter tree's layout, matched to the
  tensors by their JAX dotted paths;
* ``nequip_tpu_torch.train.muon`` and ``nequip_tpu_torch.train.muon_adam``
  (what ``retarget`` makes of the JAX package's names): ``muon.Muon``, and
  for ``muon_adam`` Muon on the 2-D parameters and ``torch.optim.Adam`` on
  the rest.  The names are read, not called;
* ``torch.optim.Adam`` with torch's ``lr``/``betas``/``eps``.

Refused by name: ``optax.lbfgs`` (its line search needs the loss function,
which the JAX trainer never passes), a callable mask (``_target_`` /
``_partial_``), and an unknown name or argument.

Each group's ``lr`` is a rate the training module scales (the epoch LR
scale and a per-step schedule): the learning rate of a torch class, whose
update is proportional to it, and a factor on the final update (base 1.0)
of an ``OptaxChain`` group, which is where the JAX trainer applies both.
``build_optimizer`` turns a list of ``(kind, param group)`` pairs into one
optimizer, or an ``OptimizerList`` when they need more than one class.
"""

from __future__ import annotations

import inspect
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from . import transforms as T
from .muon import Muon
from .schedules import rate

MUON_NAMES = ("nequip_tpu_torch.train.muon", "nequip_tpu_torch.train.muon.muon")
MUON_ADAM_NAMES = ("nequip_tpu_torch.train.muon_adam", "nequip_tpu_torch.train.muon.muon_adam")


class Adam(torch.optim.Optimizer):
    """optax's ``scale_by_adam`` (optionally Nesterov, optionally with
    ``eps_root``), then ``add_decayed_weights(weight_decay)``, then
    ``-lr``: ``optax.adam`` and ``optax.adamw`` where torch's classes differ."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, nesterov: bool = False, weight_decay: float = 0.0, mu_dtype=None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root, nesterov=nesterov,
                                      weight_decay=weight_decay, mu_dtype=T.canonical_dtype(mu_dtype)))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, b1, b2, eps, eps_root = (group[k] for k in ("lr", "b1", "b2", "eps", "eps_root"))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                mu_dtype = group.get("mu_dtype")  # absent from the groups of earlier checkpoints
                if not state:
                    state.update(count=0, mu=torch.zeros_like(p, dtype=mu_dtype), nu=torch.zeros_like(p))
                mu = T.moment(g, state["mu"], b1, 1)
                state["mu"] = mu if mu_dtype is None else mu.to(mu_dtype)
                nu = state["nu"] = (1 - b2) * g * g + b2 * state["nu"]
                t = state["count"] = state["count"] + 1
                if group["nesterov"]:
                    mu_hat = b1 * (mu / (1 - b1 ** (t + 1))) + (1 - b1) * (g / (1 - b1**t))
                else:
                    mu_hat = mu / (1 - b1**t)
                u = mu_hat / (torch.sqrt(nu / (1 - b2**t) + eps_root) + eps)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.add_(u, alpha=-lr)

    def load_state_dict(self, state_dict) -> None:
        # torch casts floating state to the parameter's dtype: a mu_dtype moment goes back to its own
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                if group.get("mu_dtype") is not None and "mu" in self.state[p]:
                    self.state[p]["mu"] = self.state[p]["mu"].to(group["mu_dtype"])


class OptimizerList:
    """Several optimizers stepped as one (their groups in order)."""

    def __init__(self, optimizers: Sequence[torch.optim.Optimizer]):
        self.optimizers = list(optimizers)

    @property
    def param_groups(self) -> List[dict]:
        return [g for o in self.optimizers for g in o.param_groups]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for o in self.optimizers:
            o.zero_grad(set_to_none=set_to_none)

    def step(self, value=None) -> None:
        for o in self.optimizers:
            step_optimizer(o, value)

    def state_dict(self) -> dict:
        return {"optimizers": [o.state_dict() for o in self.optimizers]}

    def load_state_dict(self, sd: dict) -> None:
        for o, s in zip(self.optimizers, sd["optimizers"], strict=True):
            o.load_state_dict(s)


_CLASSES = {
    "adam": lambda groups: torch.optim.Adam(groups, foreach=False),
    "adamw": lambda groups: torch.optim.AdamW(groups, foreach=False),
    "sgd": lambda groups: torch.optim.SGD(groups, foreach=False),
    "optax_adam": Adam,
    "muon": Muon,
    "optax": T.OptaxChain,
}


def needs_value(optimizer) -> bool:
    """Whether an optimizer's update reads the loss value (``polyak_sgd``,
    ``reduce_on_plateau``)."""
    return any(getattr(o, "needs_value", False) for o in getattr(optimizer, "optimizers", [optimizer]))


def step_optimizer(optimizer, value=None) -> None:
    """One update, handing the loss ``value`` to the optimizers that read it."""
    if isinstance(optimizer, (T.OptaxChain, OptimizerList)):
        optimizer.step(value=value)
    else:
        optimizer.step()


def _rate(value, name: str) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"{name} must be a number, got {value!r}")
    return float(value)


def _number(value, name: str, alias: str) -> float:
    if isinstance(value, dict):
        raise ValueError(f"optax.{alias} takes {name} as a number, not a schedule")
    return _rate(value, name)


def _lr(learning_rate, flip_sign: bool = True):
    return T.scale_by_learning_rate(None if learning_rate is None else rate(learning_rate), flip_sign=flip_sign)


def _checked(mask):
    if mask is not None:
        T.check_mask(mask)
    return mask


# optax's aliases over the port's transforms: optax 0.2.6's arguments, defaults and chains
def adabelief(learning_rate, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, *, nesterov=False):
    return T.Chain(T.ScaleByBelief(b1, b2, eps, eps_root, nesterov), _lr(learning_rate))


def adadelta(learning_rate=None, rho=0.9, eps=1e-6, weight_decay=0.0, weight_decay_mask=None):
    return T.Chain(T.add_decayed_weights(weight_decay, _checked(weight_decay_mask)), T.ScaleByAdadelta(rho, eps),
                   _lr(learning_rate))


def adafactor(learning_rate=None, min_dim_size_to_factor=128, decay_rate=0.8, decay_offset=0,
              multiply_by_parameter_scale=True, clipping_threshold=1.0, momentum=None, dtype_momentum="float32",
              weight_decay_rate=None, eps=1e-30, factored=True, weight_decay_mask=None):
    return T.Chain(
        T.ScaleByFactoredRms(factored, decay_rate, decay_offset, min_dim_size_to_factor, eps),
        T.clip_by_block_rms(clipping_threshold) if clipping_threshold is not None else T.Transform(),
        _lr(learning_rate, flip_sign=False),
        T.scale_by_param_block_rms() if multiply_by_parameter_scale else T.Transform(),
        T.Ema(momentum, debias=False, accumulator_dtype=dtype_momentum) if momentum is not None else T.Transform(),
        (T.add_decayed_weights(weight_decay_rate, _checked(weight_decay_mask)) if weight_decay_rate is not None
         else T.Transform()),
        T.scale(-1))


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    return T.Chain(T.ScaleByRss(initial_accumulator_value, eps), _lr(learning_rate))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, *, nesterov=False):
    return T.Chain(T.ScaleByAdam(b1, b2, eps, eps_root, mu_dtype, nesterov), _lr(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, weight_decay=1e-4, mask=None,
          *, nesterov=False):
    return T.Chain(T.ScaleByAdam(b1, b2, eps, eps_root, mu_dtype, nesterov),
                   T.add_decayed_weights(weight_decay, _checked(mask)), _lr(learning_rate))


def nadam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, *, nesterov=True):
    return adam(learning_rate, b1, b2, eps, eps_root, mu_dtype, nesterov=nesterov)


def nadamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, weight_decay=1e-4, mask=None,
           *, nesterov=True):
    return adamw(learning_rate, b1, b2, eps, eps_root, mu_dtype, weight_decay, mask, nesterov=nesterov)


def adamax(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    return T.Chain(T.ScaleByAdamax(b1, b2, eps), _lr(learning_rate))


def adamaxw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4, mask=None):
    return T.Chain(T.ScaleByAdamax(b1, b2, eps), T.add_decayed_weights(weight_decay, _checked(mask)),
                   _lr(learning_rate))


def adan(learning_rate, b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8, weight_decay=0.0, mask=None):
    return T.Chain(T.ScaleByAdan(b1, b2, b3, eps, eps_root), T.add_decayed_weights(weight_decay, _checked(mask)),
                   _lr(learning_rate))


def amsgrad(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None):
    return T.Chain(T.ScaleByAdam(b1, b2, eps, eps_root, mu_dtype, amsgrad=True), _lr(learning_rate))


def fromage(learning_rate, min_norm=1e-6):
    lr = rate(learning_rate)
    if not callable(lr):
        mult = 1 / math.sqrt(1 + lr**2)
        return T.Chain(T.scale_by_trust_ratio(min_norm), T.scale_by_learning_rate(lr * mult),
                       T.add_decayed_weights(mult - 1))
    mult_lr = lambda count: 1 / math.sqrt(1 + lr(count) ** 2)  # noqa: E731
    return T.Chain(T.scale_by_trust_ratio(min_norm), T.scale_by_learning_rate(lambda c: mult_lr(c) * lr(c)),
                   T.add_decayed_weights(lambda c: mult_lr(c) - 1))


def lamb(learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0, mask=None):
    return T.Chain(T.ScaleByAdam(b1, b2, eps, eps_root), T.add_decayed_weights(weight_decay, _checked(mask)),
                   T.scale_by_trust_ratio(), _lr(learning_rate))


def lars(learning_rate, weight_decay=0.0, weight_decay_mask=True, trust_coefficient=0.001, eps=0.0,
         trust_ratio_mask=True, momentum=0.9, nesterov=False):
    return T.Chain(T.add_decayed_weights(weight_decay, _checked(weight_decay_mask)),
                   T.Masked(T.scale_by_trust_ratio(trust_coefficient=trust_coefficient, eps=eps), trust_ratio_mask),
                   _lr(learning_rate), T.Trace(momentum, nesterov))


def lion(learning_rate, b1=0.9, b2=0.99, mu_dtype=None, weight_decay=1e-3, mask=None):
    return T.Chain(T.ScaleByLion(b1, b2, mu_dtype), T.add_decayed_weights(weight_decay, _checked(mask)),
                   _lr(learning_rate))


def noisy_sgd(learning_rate, eta=0.01, gamma=0.55, key=None, *, seed=None):
    if key is not None and seed is not None:
        raise ValueError("Only one of seed or key can be specified.")
    seed = key if key is not None else seed
    if seed is not None and (isinstance(seed, bool) or not isinstance(seed, int)):
        raise ValueError(f"noisy_sgd takes an int key or seed, got {seed!r}")
    return T.Chain(T.AddNoise(eta, gamma, seed or 0), _lr(learning_rate))


def novograd(learning_rate, b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0, weight_decay=0.0):
    return T.Chain(T.ScaleByNovograd(b1, b2, eps, eps_root, weight_decay), _lr(learning_rate))


def optimistic_gradient_descent(learning_rate, alpha=1.0, beta=1.0):
    alpha, beta = (_number(v, k, "optimistic_gradient_descent") for k, v in (("alpha", alpha), ("beta", beta)))
    return T.Chain(T.ScaleByOptimisticGradient(alpha, beta), _lr(learning_rate))


def optimistic_adam(learning_rate, optimism=None, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None, *,
                    nesterov=True):
    lr = _number(learning_rate, "learning_rate", "optimistic_adam")
    return T.Chain(T.ScaleByAdam(b1, b2, eps, eps_root, mu_dtype, nesterov),
                   T.ScaleByOptimisticGradient(lr, lr if optimism is None else optimism), T.scale(-1.0))


def optimistic_adam_v2(learning_rate, *, alpha=1.0, beta=1.0, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                       mu_dtype=None, nesterov=True):
    return T.Chain(T.ScaleByAdam(b1, b2, eps, eps_root, mu_dtype, nesterov), T.ScaleByOptimisticGradient(alpha, beta),
                   _lr(learning_rate))


def polyak_sgd(max_learning_rate=1.0, scaling=1.0, f_min=0.0, eps=0.0, variant="sps"):
    return T.Chain(_lr(scaling), T.ScaleByPolyak(f_min, max_learning_rate, eps, variant))


def radam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0, *, nesterov=False):
    return T.Chain(T.ScaleByRadam(b1, b2, eps, eps_root, threshold, nesterov), _lr(learning_rate))


def rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True, centered=False, momentum=None,
            nesterov=False, bias_correction=False):
    return T.Chain(T.ScaleByRms(decay, eps, initial_scale, eps_in_sqrt, bias_correction, centered),
                   _lr(learning_rate), T.Trace(momentum, nesterov) if momentum is not None else T.Transform())


def rprop(learning_rate, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6, max_step_size=50.0):
    lr = _number(learning_rate, "learning_rate", "rprop")
    return T.Chain(T.ScaleByRprop(lr, eta_minus, eta_plus, min_step_size, max_step_size), T.scale(-1.0))


def sgd(learning_rate, momentum=None, nesterov=False, accumulator_dtype=None):
    return T.Chain(T.Trace(momentum, nesterov, accumulator_dtype) if momentum is not None else T.Transform(),
                   _lr(learning_rate))


def sign_sgd(learning_rate):
    return T.Chain(T.scale_by_sign(), _lr(learning_rate))


def sm3(learning_rate, momentum=0.9):
    return T.Chain(T.ScaleBySM3(momentum), T.scale(-_number(learning_rate, "learning_rate", "sm3")))


def yogi(learning_rate, b1=0.9, b2=0.999, eps=1e-3):
    return T.Chain(T.ScaleByYogi(b1, b2, eps), _lr(learning_rate))


def reduce_on_plateau(factor=0.1, patience=10, rtol=1e-4, atol=0.0, cooldown=0, accumulation_size=1, min_scale=0.0):
    return T.Chain(T.ReduceOnPlateau(factor, patience, rtol, atol, cooldown, accumulation_size, min_scale))


ALIASES = {f.__name__: f for f in (
    adabelief, adadelta, adafactor, adagrad, adam, adamax, adamaxw, adamw, adan, amsgrad, fromage, lamb, lars, lion,
    nadam, nadamw, noisy_sgd, novograd, optimistic_adam, optimistic_adam_v2, optimistic_gradient_descent, polyak_sgd,
    radam, rmsprop, rprop, sgd, sign_sgd, sm3, yogi)}
ALIASES["contrib.reduce_on_plateau"] = reduce_on_plateau
SUPPORTED = tuple(f"optax.{name}" for name in ALIASES) + ("torch.optim.Adam",) + MUON_NAMES + MUON_ADAM_NAMES
REFUSED = {"optax.lbfgs": "its line search needs the loss function, which the JAX trainer never passes to the "
                          "optimizer (so the JAX package cannot run it either)"}


def _adam_kind(target: str, cfg: dict) -> Optional[Tuple[str, dict]]:
    """The class and hyperparameters of adam/adamw/nadam/nadamw with a number
    as rate and no mask (torch's classes or ``Adam``); None where the config
    needs optax's chain."""
    name = target.rpartition(".")[2]
    w = name.endswith("w")
    kw = dict(cfg)
    lr = kw.pop("learning_rate", 1e-3)
    if isinstance(lr, dict) or (w and kw.pop("mask", None) is not None):
        return None
    hp = dict(b1=float(kw.pop("b1", 0.9)), b2=float(kw.pop("b2", 0.999)), eps=float(kw.pop("eps", 1e-8)),
              eps_root=float(kw.pop("eps_root", 0.0)), nesterov=bool(kw.pop("nesterov", name.startswith("n"))),
              weight_decay=float(kw.pop("weight_decay", 1e-4)) if w else 0.0,
              mu_dtype=T.canonical_dtype(kw.pop("mu_dtype", None)))
    if kw:
        raise ValueError(f"unknown arguments {sorted(kw)} for optimizer {target!r}")
    lr = _rate(lr, "learning_rate")
    if hp["eps_root"] or hp["nesterov"] or hp["mu_dtype"] is not None:
        return "optax_adam", dict(lr=lr, **hp)
    torch_hp = dict(betas=(hp["b1"], hp["b2"]), eps=hp["eps"])
    if w:
        torch_hp["weight_decay"] = hp["weight_decay"]
    return "adamw" if w else "adam", dict(lr=lr, **torch_hp)


def param_groups(cfg: dict, params: Sequence[torch.Tensor],
                 paths: Optional[Sequence[str]] = None) -> List[Tuple[str, dict]]:
    """``(kind, param group)`` pairs of one optimizer config over ``params``
    (the groups may be empty); ``paths``, the tensors' JAX dotted paths,
    match masks (default: their positions)."""
    cfg = dict(cfg)
    target = cfg.pop("_target_", "optax.adam")
    params = list(params)
    paths = [str(i) for i in range(len(params))] if paths is None else list(paths)
    if target in REFUSED:
        raise ValueError(f"optimizer {target!r} is not supported: {REFUSED[target]}")
    name = target[len("optax."):] if target.startswith("optax.") else None
    if name in ("adam", "adamw", "nadam", "nadamw") and (kind := _adam_kind(target, cfg)):
        return [(kind[0], dict(params=params, **kind[1]))]
    if target == "optax.sgd" and not isinstance(cfg.get("learning_rate"), dict) \
            and cfg.get("accumulator_dtype") is None:
        lr = _rate(cfg.pop("learning_rate"), "learning_rate")
        momentum = cfg.pop("momentum", None)
        nesterov = bool(cfg.pop("nesterov", False)) and momentum is not None
        cfg.pop("accumulator_dtype", None)
        groups = [("sgd", dict(params=params, lr=lr, momentum=float(momentum or 0.0), nesterov=nesterov))]
    elif name in ALIASES:
        try:
            chain = ALIASES[name](**cfg)
        except TypeError as e:
            raise ValueError(f"unknown arguments for optimizer {target!r} ({e}); it takes optax's arguments "
                             f"{list(inspect.signature(ALIASES[name]).parameters)}") from e
        return [("optax", dict(params=params, paths=paths, chain=chain, lr=1.0))]
    elif target == "torch.optim.Adam":
        lr = _rate(cfg.pop("lr", 1e-3), "lr")
        groups = [("adam", dict(params=params, lr=lr, betas=tuple(float(b) for b in cfg.pop("betas", (0.9, 0.999))),
                                eps=float(cfg.pop("eps", 1e-8))))]
    elif target in MUON_NAMES:
        groups = [("muon", dict(params=params, lr=_rate(cfg.pop("learning_rate", 0.02), "learning_rate"),
                                momentum=float(cfg.pop("momentum", 0.95)), nesterov=bool(cfg.pop("nesterov", True)),
                                ns_steps=int(cfg.pop("ns_steps", 5))))]
    elif target in MUON_ADAM_NAMES:
        b1, b2 = (float(b) for b in cfg.pop("adam_betas", (0.9, 0.999)))
        groups = [
            ("muon", dict(params=[p for p in params if p.ndim == 2],
                          lr=_rate(cfg.pop("muon_lr", 0.02), "muon_lr"), momentum=float(cfg.pop("momentum", 0.95)),
                          nesterov=bool(cfg.pop("nesterov", True)), ns_steps=int(cfg.pop("ns_steps", 5)))),
            ("adam", dict(params=[p for p in params if p.ndim != 2], lr=_rate(cfg.pop("adam_lr", 1e-3), "adam_lr"),
                          betas=(b1, b2), eps=float(cfg.pop("adam_eps", 1e-8)))),
        ]
    else:
        raise ValueError(f"optimizer {target!r} is not supported; the supported optimizers are {', '.join(SUPPORTED)}")
    if cfg:
        raise ValueError(f"unknown arguments {sorted(cfg)} for optimizer {target!r}")
    return groups


def build_optimizer(groups: Iterable[Tuple[str, dict]]):
    """One optimizer over the non-empty groups, per kind in order of first
    appearance; an ``OptimizerList`` when there is more than one kind."""
    by_kind: Dict[str, List[dict]] = {}
    for kind, group in groups:
        if group["params"]:
            by_kind.setdefault(kind, []).append(group)
    if not by_kind:
        raise ValueError("the optimizer has no trainable parameters")
    optimizers = [_CLASSES[kind](gs) for kind, gs in by_kind.items()]
    return optimizers[0] if len(optimizers) == 1 else OptimizerList(optimizers)
