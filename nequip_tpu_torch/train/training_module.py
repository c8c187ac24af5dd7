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

``force_grad_mode="rr"`` (reverse over reverse) is the only mode ported;
``"fr"`` needs the dual-sweep kernels K6/K7 and ``InteractionBlock.jvp`` and
raises.  Not ported yet: LR schedulers, gradient clipping, optimizers other
than Adam, multi-model modules.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional, Sequence

import torch

from ..ops.kernels.tp_scatter import relayout_edge_stream
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


class NequIPTrainModule:
    def __init__(
        self,
        model: torch.nn.Module,
        loss: MetricsManager,
        val_metrics: Optional[MetricsManager] = None,
        optimizer: Optional[dict] = None,
        force_grad_mode: str = "rr",
    ):
        if force_grad_mode == "fr":
            raise NotImplementedError(
                "force_grad_mode='fr' (reverse over forward) needs the dual-sweep kernels K6/K7 "
                "(_jvp_forward, _jvp_backward_kernel_call) and InteractionBlock.jvp, not ported yet; "
                "use force_grad_mode='rr'"
            )
        if force_grad_mode != "rr":
            raise ValueError(f"force_grad_mode must be 'rr' or 'fr', got {force_grad_mode!r}")
        self.force_grad_mode = force_grad_mode
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

    def training_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """One rr step on a padded batch; returns the step's loss values."""
        self.optimizer.zero_grad(set_to_none=True)
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
