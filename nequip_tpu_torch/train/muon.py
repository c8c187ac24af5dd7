"""Muon: momentum orthogonalised by a Newton-Schulz iteration.

Port of ``nequip_tpu/train/muon.py`` as ``torch.optim`` optimizers:

* ``zeropower_via_newtonschulz5(G)``: the quintic iteration (3.4445,
  -4.7750, 2.0315) on ``G / (||G||_F + 1e-7)``, on the transpose when ``G``
  has more rows than columns, computed in float32 and cast back, as the JAX
  package computes it whatever the model's dtype;
* ``Muon``: the buffer ``m * buf + g``, Nesterov ``g + m * buf``, then
  ``-lr * sqrt(max(1, rows / cols)) * NS(.)`` for a 2-D parameter and
  ``-lr * (.)`` for any other;
* ``muon(params, ...)`` and ``muon_adam(params, ...)`` (Muon for the 2-D
  parameters, Adam for the rest), over the given parameters.  A training
  config names them (``nequip_tpu_torch.train.muon_adam``, what
  ``retarget`` makes of the JAX name) with the JAX functions' arguments.

"2-D" is the tensor's shape, which is the JAX leaf's (``load_jax_params``
checks that the shapes agree).
"""

from __future__ import annotations

from typing import Iterable

import torch


def zeropower_via_newtonschulz5(G: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """Approximate ``U V^T`` of a 2-D ``G`` (Muon's quintic Newton-Schulz)."""
    if G.ndim != 2:
        raise ValueError(f"zeropower_via_newtonschulz5 needs a 2-D tensor, got shape {tuple(G.shape)}")
    a, b, c = 3.4445, -4.7750, 2.0315
    X = G.to(torch.float32)
    transpose = G.shape[0] > G.shape[1]
    if transpose:
        X = X.T
    X = X / (torch.linalg.vector_norm(X) + 1e-7)
    for _ in range(steps):
        A = X @ X.T
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    if transpose:
        X = X.T
    return X.to(G.dtype)


class Muon(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 0.02, momentum: float = 0.95, nesterov: bool = True, ns_steps: int = 5):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov, ns_steps=ns_steps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, m = group["lr"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                buf = state.get("momentum_buffer")
                buf = state["momentum_buffer"] = g.clone() if buf is None else m * buf + g
                eff = g + m * buf if group["nesterov"] else buf
                if p.ndim == 2:
                    scale = max(1.0, p.shape[0] / p.shape[1]) ** 0.5
                    p.add_(zeropower_via_newtonschulz5(eff, group["ns_steps"]), alpha=-lr * scale)
                else:
                    p.add_(eff, alpha=-lr)


def muon(params: Iterable[torch.Tensor], learning_rate: float = 0.02, momentum: float = 0.95, nesterov: bool = True,
         ns_steps: int = 5) -> Muon:
    """Muon over ``params``."""
    return Muon(list(params), lr=learning_rate, momentum=momentum, nesterov=nesterov, ns_steps=ns_steps)


def muon_adam(params: Iterable[torch.Tensor], muon_lr: float = 0.02, adam_lr: float = 1e-3, momentum: float = 0.95,
              nesterov: bool = True, ns_steps: int = 5, adam_betas=(0.9, 0.999), adam_eps: float = 1e-8):
    """Muon for the 2-D tensors of ``params``, ``optax.adam`` for the rest."""
    from .optim import MUON_ADAM_NAMES, build_optimizer, param_groups

    return build_optimizer(param_groups(
        dict(_target_=MUON_ADAM_NAMES[0], muon_lr=muon_lr, adam_lr=adam_lr, momentum=momentum, nesterov=nesterov,
             ns_steps=ns_steps, adam_betas=adam_betas, adam_eps=adam_eps), list(params)))
