"""ConFIG: conflict-free updates for multitask (energy, forces, stress) loss.

Port of ``nequip_tpu/train/config_module.py`` (method of arXiv:2408.11104).
One step:

* one forward, and the k loss components: the entries whose coefficient is
  not None, in entry order, at the loss manager's own coefficients (the
  logged values are those);
* k gradients, ``torch.autograd.grad(component_i, params, retain_graph=i <
  k - 1)``: k reverse passes over one graph, each through the kernels'
  double backward (where the JAX package takes one ``jacrev``);
* ``A_raw`` (k x P, flattened), ``A`` its rows over their norms (``+
  norm_eps``), ``b`` the trainer's loss coefficients of those entries (the
  module's when none are given) over their norm;
* ``x`` the minimum-norm least-squares solution of ``A x = b`` (``lsqr``,
  ``jnp.linalg.lstsq``'s cutoff) or ``pinv(A) b`` (``jnp.linalg.pinv``'s),
  both from one SVD of ``A`` (``torch.linalg.lstsq`` takes only
  overdetermined systems on CUDA), over its norm;
* the gradient ``sum(A_raw x) x``, unflattened onto the parameters;
* the module's clip (``gradient_clip_algorithm``): ``"norm"`` scales by
  ``min(1, c / (||g|| + 1e-12))``, ``"value"`` clamps to ``[-c, c]``; then,
  as the JAX module's optimizer chain has it, the base module's global-norm
  clip at the same value, the optimizer and the EMA.  The optimizer is
  handed no loss value, as in the JAX package, so the ones that read it
  (``polyak_sgd``, ``reduce_on_plateau``) are refused.

With a process ``group`` (data parallel) the loss sums are merged over its
ranks before the k passes (``psum_batch``: the value global, the gradient
through this rank's term) and the k x P rows are all-reduced before the
SVD, so every rank solves the same system, that of the global batch: the
step is the single-device step over the same frames.  (The JAX package's
data-parallel ConFIG step merges the sums but not the rows, so each of its
devices solves with its own micro-batch's gradients.)

As in the JAX package ``force_grad_mode`` is not used: the gradients are
always reverse over reverse.  ``A`` spans the trainable parameters; the JAX
package's spans every leaf of its tree, the frozen per-type scales and
shifts and Bessel weights included, so the two agree when every leaf is
trainable.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .optim import needs_value
from .training_module import EMATrainModule, NequIPTrainModule


def _min_norm_solve(A: torch.Tensor, b: torch.Tensor, lsqr: bool) -> torch.Tensor:
    """``pinv(A) b`` through one SVD, with ``jnp.linalg.lstsq``'s cutoff
    (``lsqr``) or ``jnp.linalg.pinv``'s."""
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    eps = torch.finfo(A.dtype).eps * max(A.shape)
    if lsqr:
        keep = (S > 0) & (S >= eps * S[0])
    else:
        keep = S > 10.0 * eps * S[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)), torch.zeros_like(S))
    return Vh.T @ (s_inv * (U.T @ b))


def config_direction(A_raw: torch.Tensor, b: torch.Tensor, lsqr: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """The flattened ConFIG gradient of the component gradients ``A_raw``
    (k x P) and the coefficients ``b`` (k)."""
    A = A_raw / (torch.linalg.vector_norm(A_raw, dim=1, keepdim=True) + eps)
    b = b / (torch.linalg.vector_norm(b) + eps)
    x = _min_norm_solve(A, b, lsqr)
    x = x / (torch.linalg.vector_norm(x) + eps)
    return torch.sum(A_raw @ x) * x


class ConFIGTrainModule(NequIPTrainModule):
    def __init__(self, *args, gradient_clip_val: Optional[float] = None, gradient_clip_algorithm: str = "norm",
                 lsqr: bool = True, norm_eps: float = 1e-8, **kwargs):
        super().__init__(*args, gradient_clip_val=gradient_clip_val, **kwargs)
        if gradient_clip_algorithm not in ("norm", "value"):
            raise ValueError(f"gradient_clip_algorithm must be 'norm' or 'value', got {gradient_clip_algorithm!r}")
        self.gradient_clip_algorithm = gradient_clip_algorithm
        self.lsqr = bool(lsqr)
        self.norm_eps = float(norm_eps)
        if self.loss is None:
            raise ValueError("ConFIG needs a loss")
        self._component_index = [i for i, e in enumerate(self.loss.entries) if self.loss.coeffs[e["name"]] is not None]
        if not self._component_index:
            raise ValueError("ConFIG needs at least one loss entry with a coefficient")
        if needs_value(self.optimizer):
            raise ValueError("ConFIG's update hands the optimizer no loss value (as in the JAX package), so it cannot "
                             "run optax.polyak_sgd or optax.contrib.reduce_on_plateau")

    def component_grads(self, batch: dict, group=None):
        """``(A_raw, batch loss sums, loss values)``: the k components'
        gradients over the trainable parameters, flattened, as rows (summed
        over the ranks of ``group``)."""
        from ..parallel._collectives import all_reduce

        batch = self._prepare(batch)
        out = self.model(batch)
        bs = self._merge(self.loss, self.loss.batch_state(out, batch), group)
        _, values = self.loss.values(bs)
        params = [p for _, p in self.named_trainable()]
        names = [self.loss.entries[i]["name"] for i in self._component_index]
        rows = []
        for i, name in enumerate(names):
            grads = torch.autograd.grad(values[name], params, retain_graph=i < len(names) - 1, allow_unused=True)
            rows.append(torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                                   for g, p in zip(grads, params)]))
        A_raw = torch.stack(rows)
        return (A_raw if group is None else all_reduce(A_raw, group)), bs, values

    def training_step(self, batch: dict, loss_coeffs: Optional[Sequence[float]] = None,
                      group=None) -> Dict[str, torch.Tensor]:
        self._check_sole_model()
        self.optimizer.zero_grad(set_to_none=True)
        A_raw, bs, values = self.component_grads(batch, group)
        coeffs = ([float(loss_coeffs[i]) for i in self._component_index] if loss_coeffs is not None
                  else [self.loss.coeffs[self.loss.entries[i]["name"]] for i in self._component_index])
        flat = config_direction(A_raw, torch.tensor(coeffs, dtype=A_raw.dtype, device=A_raw.device), self.lsqr,
                                self.norm_eps)
        params = [p for _, p in self.named_trainable()]
        c = self.gradient_clip_val
        if c is not None:
            if self.gradient_clip_algorithm == "norm":
                flat = flat * torch.clamp(c / (torch.linalg.vector_norm(flat) + 1e-12), max=1.0)
            else:
                flat = torch.clamp(flat, -c, c)
        for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
            p.grad = g.view_as(p).to(p.dtype).clone()
        return self._apply_update(bs, values)

    def hyperparameters(self) -> dict:
        return {**super().hyperparameters(), "gradient_clip_algorithm": self.gradient_clip_algorithm,
                "lsqr": self.lsqr, "norm_eps": self.norm_eps}


class EMAConFIGTrainModule(EMATrainModule, ConFIGTrainModule):
    """The ConFIG update with an EMA of the weights, which evaluation runs."""


ConFIGLightningModule = ConFIGTrainModule
EMAConFIGLightningModule = EMAConFIGTrainModule
