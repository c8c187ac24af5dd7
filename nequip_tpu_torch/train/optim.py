"""Optimizers of a training module, built from the JAX package's optax configs.

An optimizer config is ``{_target_: <name>, <optax arguments>}``; the port
never imports optax and maps each name onto a ``torch.optim.Optimizer``
whose update is optax's:

* ``optax.adam`` (``learning_rate``, ``b1``, ``b2``, ``eps``, ``eps_root``,
  ``nesterov``): ``torch.optim.Adam`` when ``eps_root == 0`` and without
  Nesterov (its state layout, ``step``/``exp_avg``/``exp_avg_sq``, is what
  checkpoints hold), else ``Adam`` below;
* ``optax.adamw`` (the same, and ``weight_decay``, whose default is optax's
  1e-4): the update ``-lr * (adam + wd * p)``, which ``torch.optim.AdamW``
  computes when ``eps_root == 0`` and without Nesterov, else ``Adam``;
* ``optax.sgd`` (``learning_rate``, ``momentum`` (None: none),
  ``nesterov``): ``torch.optim.SGD``, whose buffer ``m * buf + g`` and
  Nesterov ``g + m * buf`` are optax's ``trace``;
* ``nequip_tpu_torch.train.muon`` and ``nequip_tpu_torch.train.muon_adam``
  (what ``retarget`` makes of the JAX package's names): ``muon.Muon``, and
  for ``muon_adam`` Muon on the 2-D parameters and ``torch.optim.Adam`` on
  the rest.  The names are read, not called;
* ``torch.optim.Adam`` with torch's ``lr``/``betas``/``eps``.

Every update is proportional to its group's ``lr``, so a training module
scales a step by scaling the rates (the epoch LR scale and a per-step
schedule).  ``build_optimizer`` turns a list of ``(kind, param group)``
pairs into one optimizer, or an ``OptimizerList`` when they need more than
one class.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from .muon import Muon

MUON_NAMES = ("nequip_tpu_torch.train.muon", "nequip_tpu_torch.train.muon.muon")
MUON_ADAM_NAMES = ("nequip_tpu_torch.train.muon_adam", "nequip_tpu_torch.train.muon.muon_adam")
SUPPORTED = ("optax.adam", "optax.adamw", "optax.sgd", "torch.optim.Adam") + MUON_NAMES + MUON_ADAM_NAMES
# optax arguments the port has no counterpart for (their defaults, None, are accepted)
_UNSUPPORTED_ARGS = ("mask", "mu_dtype", "accumulator_dtype")


class Adam(torch.optim.Optimizer):
    """optax's ``scale_by_adam`` (optionally Nesterov, optionally with
    ``eps_root``), then ``add_decayed_weights(weight_decay)``, then
    ``-lr``: ``optax.adam`` and ``optax.adamw`` where torch's classes differ."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, nesterov: bool = False, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root, nesterov=nesterov,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, b1, b2, eps, eps_root = (group[k] for k in ("lr", "b1", "b2", "eps", "eps_root"))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state.update(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                mu = state["mu"] = (1 - b1) * g + b1 * state["mu"]
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

    def step(self) -> None:
        for o in self.optimizers:
            o.step()

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
}


def _rate(value, name: str) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"{name} must be a number, got {value!r}: a per-step schedule goes in the training "
                         f"module's lr_scheduler")
    return float(value)


def param_groups(cfg: dict, params: Sequence[torch.Tensor]) -> List[Tuple[str, dict]]:
    """``(kind, param group)`` pairs of one optimizer config over ``params``
    (the groups may be empty)."""
    cfg = dict(cfg)
    target = cfg.pop("_target_", "optax.adam")
    for k in _UNSUPPORTED_ARGS:
        if cfg.pop(k, None) is not None:
            raise ValueError(f"optimizer argument {k!r} is not supported; the supported optimizers are "
                             f"{', '.join(SUPPORTED)} with their optax arguments")
    params = list(params)
    if target in ("optax.adam", "optax.adamw"):
        lr = _rate(cfg.pop("learning_rate", 1e-3), "learning_rate")
        hp = dict(b1=float(cfg.pop("b1", 0.9)), b2=float(cfg.pop("b2", 0.999)), eps=float(cfg.pop("eps", 1e-8)),
                  eps_root=float(cfg.pop("eps_root", 0.0)), nesterov=bool(cfg.pop("nesterov", False)),
                  weight_decay=float(cfg.pop("weight_decay", 1e-4)) if target == "optax.adamw" else 0.0)
        if hp["eps_root"] or hp["nesterov"]:
            group = ("optax_adam", dict(params=params, lr=lr, **hp))
        else:
            torch_hp = dict(betas=(hp["b1"], hp["b2"]), eps=hp["eps"])
            if target == "optax.adamw":
                torch_hp["weight_decay"] = hp["weight_decay"]
            group = ("adam" if target == "optax.adam" else "adamw", dict(params=params, lr=lr, **torch_hp))
        groups = [group]
    elif target == "torch.optim.Adam":
        lr = _rate(cfg.pop("lr", 1e-3), "lr")
        groups = [("adam", dict(params=params, lr=lr, betas=tuple(float(b) for b in cfg.pop("betas", (0.9, 0.999))),
                                eps=float(cfg.pop("eps", 1e-8))))]
    elif target == "optax.sgd":
        lr = _rate(cfg.pop("learning_rate"), "learning_rate")
        momentum = cfg.pop("momentum", None)
        nesterov = bool(cfg.pop("nesterov", False)) and momentum is not None
        groups = [("sgd", dict(params=params, lr=lr, momentum=float(momentum or 0.0), nesterov=nesterov))]
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
