"""Training modules: a model, its loss and metrics, and its optimizer.

Port of ``nequip_tpu/train/training_module.py`` in PyTorch's idiom: the
model is an ``nn.Module`` updated in place by a ``torch.optim.Adam``
(``optax.adam``'s update: the same bias correction, ``eps`` added to the
bias-corrected root of the second moment), and a step is

    out = model(batch)            # forces = -dE/dpos with create_graph=True
    loss = loss_manager(out, batch)
    loss.backward()               # reverse over reverse through the kernels
    optimizer.step()

Parameters are named by their JAX dotted paths (``model.jax_named_tensors``)
for param groups.  The JAX package's frozen leaves (``frozen_param_paths``:
fixed per-type scales and shifts, fixed Bessel weights) are persistent
buffers here, so no optimizer sees them; ``frozen_paths`` lists them.

``force_grad_mode="rr"`` (the default) is the step above.
``force_grad_mode="fr"`` (reverse over forward, JAX ``_make_train_step_fr``)
computes the same gradients to float associativity in two passes:

    out = model(batch)                      # weights frozen: E+F, no graph
    v = dL/dout                             # the loss's output cotangents
    model.loss_surrogate(batch, v).backward()   # one reverse pass over a jvp

so no residual of a force VJP is ever kept.  With ``fr_edge_chunks = C > 1``
(any ``2 <= C <=`` the batch's real edges; a kernel ``tp_impl``) both
passes run each conv over C slices of the edge stream (``ChunkedConv``,
``ChunkedJvpConv``), so the ``[E, *]`` transients shrink to 1/C.
Not ported yet: LR schedulers, gradient clipping, optimizers other
than Adam, multi-model modules.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional, Sequence

import torch

from ..nn.interaction_block import InteractionBlock
from ..ops.kernels.tp_scatter import LAYOUT_KEY, check_edge_chunks, relayout_edge_stream
from .ema import ema_update
from .metrics_manager import MetricsManager

_ADAM_NAMES = ("optax.adam", "torch.optim.Adam", "adam")


def _path_matches(path: str, patterns: Sequence[str]) -> bool:
    return any(path == p or path.startswith(p + ".") for p in patterns)


def _adam_kwargs(cfg: dict) -> dict:
    """torch.optim.Adam arguments from an optax.adam-style or torch-style dict."""
    cfg = dict(cfg)
    target = cfg.pop("_target_", "adam")
    if target not in _ADAM_NAMES:
        raise NotImplementedError(f"optimizer {target!r} is not ported; Adam is ({', '.join(_ADAM_NAMES)})")
    out = {"lr": float(cfg.pop("learning_rate", cfg.pop("lr", 1e-3)))}
    if "betas" in cfg:
        out["betas"] = tuple(cfg.pop("betas"))
    elif "b1" in cfg or "b2" in cfg:
        out["betas"] = (float(cfg.pop("b1", 0.9)), float(cfg.pop("b2", 0.999)))
    out["eps"] = float(cfg.pop("eps", 1e-8))
    if cfg.pop("eps_root", 0.0):
        raise NotImplementedError("Adam with eps_root != 0 is not ported")
    if cfg:
        raise ValueError(f"unknown optimizer arguments {sorted(cfg)}")
    return out


@contextlib.contextmanager
def frozen_weights(model: torch.nn.Module):
    """Evaluate without weight gradients (serving kernels, no training
    variant), restoring ``requires_grad`` afterwards."""
    trainable = [p for p in model.parameters() if p.requires_grad]
    for p in trainable:
        p.requires_grad_(False)
    try:
        yield model
    finally:
        for p in trainable:
            p.requires_grad_(True)


@contextlib.contextmanager
def edge_chunks(model: torch.nn.Module, n_chunks: int):
    """Hand ``n_chunks`` edge slices to every interaction block of the
    model for the duration of an fr step (0 afterwards)."""
    blocks = [m for m in model.modules() if isinstance(m, InteractionBlock)]
    for b in blocks:
        b.fr_edge_chunks = n_chunks
    try:
        yield model
    finally:
        for b in blocks:
            b.fr_edge_chunks = 0


class NequIPTrainModule:
    def __init__(
        self,
        model: torch.nn.Module,
        loss: MetricsManager,
        val_metrics: Optional[MetricsManager] = None,
        optimizer: Optional[dict] = None,
        force_grad_mode: str = "rr",
        fr_edge_chunks: int = 0,
    ):
        if force_grad_mode not in ("rr", "fr"):
            raise ValueError(f"force_grad_mode must be 'rr' or 'fr', got {force_grad_mode!r}")
        if fr_edge_chunks != 0 and (force_grad_mode != "fr" or not isinstance(fr_edge_chunks, int)
                                    or fr_edge_chunks < 2):
            raise ValueError("fr_edge_chunks requires force_grad_mode='fr' and an int >= 2 (0 turns it off)")
        if fr_edge_chunks and not getattr(model, "uses_fused_kernels", False):
            raise ValueError("fr_edge_chunks needs a kernel tp_impl ('fused' or 'fused_tp')")
        if force_grad_mode == "fr" and not hasattr(model, "loss_surrogate"):
            raise ValueError("force_grad_mode='fr' needs a GraphModel wrapping a ForceStressOutput")
        self.force_grad_mode = force_grad_mode
        self.fr_edge_chunks = fr_edge_chunks
        self.model = model
        self.loss = loss
        self.val_metrics = val_metrics
        self.optimizer = self._build_optimizer(optimizer or {"_target_": "optax.adam", "learning_rate": 1e-3})
        self.loss_state = loss.init_state()

    # --- parameters and optimizer ----------------------------------------
    def named_trainable(self) -> List[tuple]:
        return [(k, t) for k, t in self.model.jax_named_tensors() if isinstance(t, torch.nn.Parameter) and t.requires_grad]

    @property
    def frozen_paths(self) -> List[str]:
        trainable = {k for k, _ in self.named_trainable()}
        return sorted(k for k, _ in self.model.jax_named_tensors() if k not in trainable)

    def _build_optimizer(self, cfg: dict) -> torch.optim.Optimizer:
        cfg = dict(cfg)
        group_cfgs = [dict(g) for g in cfg.pop("param_groups", None) or []]
        base = _adam_kwargs(cfg)
        groups: List[Dict] = [{"params": [], **base}]
        for g in group_cfgs:  # first matching group wins; the rest take the base config
            paths = tuple(g.pop("paths"))
            groups.append({"params": [], "paths": paths, **_adam_kwargs({**cfg, **g})})
        for path, p in self.named_trainable():
            target = next((g for g in groups[1:] if _path_matches(path, g["paths"])), groups[0])
            target["params"].append(p)
        groups = [{k: v for k, v in g.items() if k != "paths"} for g in groups if g["params"]]
        return torch.optim.Adam(groups, foreach=False)

    # --- steps ------------------------------------------------------------
    def _prepare(self, batch: dict) -> dict:
        if getattr(self.model, "uses_fused_kernels", False):
            batch = relayout_edge_stream(batch)
        return batch

    def compute_loss(self, batch: dict):
        """``(loss, batch loss sums, loss values)`` of the model on a padded
        batch, with the graph for ``loss.backward()``."""
        batch = self._prepare(batch)
        out = self.model(batch)
        bs = self.loss.batch_state(out, batch)
        loss, values = self.loss.values(bs, self.loss.coeff_vector())
        return loss, bs, values

    def _loss_output_fields(self, out: dict) -> List[str]:
        """Float output fields the loss reads (through each entry's modifier)."""
        fields = []
        for e in self.loss.entries:
            mod = e["mod"]
            f = getattr(mod, "mapped_field", None) or getattr(mod, "field", None)
            if f and f in out and isinstance(out[f], torch.Tensor) and out[f].is_floating_point() \
                    and f not in fields:
                fields.append(f)
        return fields

    def compute_grads_fr(self, batch: dict):
        """fr: ``(loss, batch loss sums, loss values)`` with the parameter
        gradients of the loss accumulated into ``.grad`` (JAX
        ``_make_train_step_fr``)."""
        batch = self._prepare(batch)
        if self.fr_edge_chunks:
            check_edge_chunks(self.fr_edge_chunks, batch[LAYOUT_KEY].n_real)
        with edge_chunks(self.model, self.fr_edge_chunks):
            # pass 1: the model's own first-order E+F (serving kernels unchunked)
            with frozen_weights(self.model) as model:
                out = model(batch)
            # the output cotangents v = dL/dout (a small elementwise graph)
            fields = {f: out[f].detach().requires_grad_(True) for f in self._loss_output_fields(out)}
            with torch.enable_grad():
                bs = self.loss.batch_state(dict(out, **fields), batch)
                loss, values = self.loss.values(bs, self.loss.coeff_vector())
            grads = torch.autograd.grad(loss, list(fields.values()), allow_unused=True)
            v = {f: g for f, g in zip(fields, grads) if g is not None}
            # pass 2: one reverse pass over the jvp-augmented energy graph
            self.model.loss_surrogate(batch, v).backward()
        return loss.detach(), bs, values

    def training_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """One step on a padded batch (``force_grad_mode``); returns the
        step's loss values."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.force_grad_mode == "fr":
            loss, bs, values = self.compute_grads_fr(batch)
        else:
            loss, bs, values = self.compute_loss(batch)
            loss.backward()
        self.optimizer.step()
        self.loss_state = self.loss.accumulate(self.loss_state, bs)
        self._post_optimizer_step()
        return {f"train_loss_step/{k}": v.detach() for k, v in values.items()}

    def _post_optimizer_step(self) -> None:
        pass

    def evaluation_model(self) -> torch.nn.Module:
        return self.model

    def evaluation_step(self, metrics: MetricsManager, state, batch: dict):
        """Accumulate ``metrics`` of the evaluation model on a batch."""
        batch = self._prepare(batch)
        with frozen_weights(self.evaluation_model()) as model, torch.no_grad():
            out = model(batch)
        return metrics.update_state(state, out, batch), out


class EMATrainModule(NequIPTrainModule):
    """Keeps an exponential moving average of the weights; evaluation runs
    the EMA weights."""

    def __init__(self, *args, ema_decay: float = 0.999, **kwargs):
        super().__init__(*args, **kwargs)
        self.ema_decay = float(ema_decay)
        self.ema_model = copy.deepcopy(self.model).requires_grad_(False)
        self.ema_step = 0

    def _post_optimizer_step(self) -> None:
        self.ema_step = ema_update(
            self.ema_model.parameters(), self.model.parameters(), self.ema_step, self.ema_decay
        )

    def evaluation_model(self) -> torch.nn.Module:
        return self.ema_model
