"""Training modules: a model, its loss and metrics, and its optimizer.

Port of ``nequip_tpu/train/training_module.py`` in PyTorch's idiom: the
model is an ``nn.Module`` updated in place by a torch optimizer (for
``optax.adam`` a ``torch.optim.Adam``: the same bias correction, ``eps``
added to the bias-corrected root of the second moment), and a step is

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

A bfloat16 model (``enable_bf16_fast_mode``) trains as the JAX package
trains one: its parameters, their gradients and the optimizer state are
float32, the model casts the weights to bf16 where it uses them, and the
loss reads the float64 energy and forces.  rr runs on ``"fused_tp"``, fr
on it and, over edge slices, on ``"fused"`` too; rr and unsliced fr on
``"fused"`` raise (``nn/interaction_block.py``).

Built from a config (the training CLI), ``model`` is a ``_target_`` dict
built without recursion and ``loss``/``*_metrics`` are dicts too; the
module puts the model on ``device`` (the card by default).  The epoch form
of ``lr_scheduler`` (``{scheduler, monitor, interval: epoch, frequency}``)
steps a host-side scheduler at each epoch's end, and the trainer sets each
parameter group's rate to its base rate times the scale rounded to
float32 (``set_lr_scale``), which for Adam is the JAX package's scaled
update.  ``gradient_clip_val`` clips by the global norm as
``optax.clip_by_global_norm`` does (``g / ||g|| * c`` when ``||g|| >= c``, no
epsilon), over the trainable parameters only (the JAX module's norm also
counts its frozen leaves' gradients).

The optimizer config is the JAX package's (any optax optimizer,
``optax.contrib.reduce_on_plateau``, ``muon``/``muon_adam``; ``optim.py``),
with ``param_groups`` (``[{paths: [dotted prefix, ...], <overrides>}, ...]``,
first match wins): each group's merged config builds its own torch groups,
which are the JAX ``multi_transform``'s transforms (one per entry and the
base, frozen leaves outside).  The update is composed as the JAX trainer's:
the global-norm clip, the optimizer (which reads the step's loss where it
needs it: ``polyak_sgd``, ``reduce_on_plateau``), a per-step optax schedule
given as ``lr_scheduler`` (``{_target_: optax.<schedule>, ...}``,
``schedules.py``), whose value at update ``count`` (0 first) multiplies
the update, and the epoch scale.  The module sets every group's rate to its
base rate times both before each update: the learning rate of a torch
class, whose update is proportional to it, and the factor on the final
update of an optax chain.  Under data parallel and on the 2-D mesh the
loss handed over is the one formed from the sums merged over the ranks.
A mapping ``name -> model config`` as
``model`` builds ``models`` (one ``type_names``); ``model`` is the first,
the state holds every model's tensors by name, and the training step
refuses, as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..model.jax_params import load_jax_params
from ..model.utils import init_weights
from ..nn.interaction_block import InteractionBlock
from ..ops.kernels.tp_scatter import LAYOUT_KEY, check_edge_chunks, relayout_edge_stream
from ..utils.config import instantiate
from ..utils.device import resolve_device
from .ema import ema_update
from .lr_scheduler import LRScheduler, build_scheduler
from .metrics_manager import MetricsManager
from .optim import build_optimizer, param_groups, step_optimizer
from .schedules import build_step_schedule

# the reference's single-model key (the JAX package's SOLE_MODEL_KEY)
SOLE_MODEL_KEY = "sole_model"


def _path_matches(path: str, patterns: Sequence[str]) -> bool:
    return any(path == p or path.startswith(p + ".") for p in patterns)


def named_tensors_cpu(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy on the CPU of the model's tensors under their JAX dotted paths."""
    return {k: t.detach().to("cpu", copy=True) for k, t in model.jax_named_tensors()}


@torch.no_grad()
def clip_grad_global_norm_(params: Sequence[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` on the parameters' gradients in place:
    each becomes ``g / ||g|| * max_norm`` when ``||g|| >= max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _build_metrics(cfg) -> Optional[MetricsManager]:
    return instantiate(cfg) if isinstance(cfg, dict) else cfg


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
        model: Union[dict, torch.nn.Module],
        loss: Union[dict, MetricsManager, None] = None,
        val_metrics: Union[dict, MetricsManager, None] = None,
        train_metrics: Union[dict, MetricsManager, None] = None,
        test_metrics: Union[dict, MetricsManager, None] = None,
        optimizer: Optional[dict] = None,
        lr_scheduler: Optional[dict] = None,
        gradient_clip_val: Optional[float] = None,
        seed: Optional[int] = None,
        force_grad_mode: str = "rr",
        fr_edge_chunks: int = 0,
        device="cuda",
    ):
        if force_grad_mode not in ("rr", "fr"):
            raise ValueError(f"force_grad_mode must be 'rr' or 'fr', got {force_grad_mode!r}")
        self.device = resolve_device(device)
        self.model_config = model if isinstance(model, dict) else None
        if isinstance(model, dict) and "_target_" not in model:
            # each model keeps the weights of its own seed
            self.models = {name: self._build_model(m, None) for name, m in model.items()}
        else:
            self.models = {SOLE_MODEL_KEY: self._build_model(model, seed)}
        if len({tuple(getattr(m, "type_names", None) or ()) for m in self.models.values()}) != 1:
            raise ValueError("the models of a training module must have the same type_names")
        # the sole or first model: the one the steps and evaluation run
        model = next(iter(self.models.values()))
        model_seed = getattr(model, "model_config", {}).get("seed", 0)
        self.seed = int(seed) if seed is not None else model_seed
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
        self.metric_configs = {
            name: cfg for name, cfg in (("loss", loss), ("val_metrics", val_metrics),
                                        ("train_metrics", train_metrics), ("test_metrics", test_metrics))
            if isinstance(cfg, dict)
        }
        self.loss = _build_metrics(loss)
        self.val_metrics = _build_metrics(val_metrics)
        self.train_metrics = _build_metrics(train_metrics)
        self.test_metrics = _build_metrics(test_metrics) or self.val_metrics
        self.optimizer_config = optimizer
        self.optimizer = self._build_optimizer(optimizer or {"_target_": "optax.adam", "learning_rate": 1e-3})
        self._base_lrs = [g["lr"] for g in self.optimizer.param_groups]
        self._lr_scale = 1.0
        self.update_count = 0  # optimizer updates so far: the per-step schedule's count
        self.gradient_clip_val = None if gradient_clip_val is None else float(gradient_clip_val)

        self.lr_scheduler_config = lr_scheduler
        self.lr_scheduler_obj: Optional[LRScheduler] = None
        self.lr_monitor: Optional[str] = None
        self.lr_frequency = 1
        self._step_schedule = None
        if isinstance(lr_scheduler, dict) and "scheduler" in lr_scheduler:
            if lr_scheduler.get("interval", "epoch") != "epoch":
                raise ValueError(
                    "an lr_scheduler with a 'scheduler' entry steps at epoch ends (interval: epoch), as in the JAX "
                    "package; a per-step schedule is an optax schedule given as lr_scheduler itself, e.g. "
                    "{_target_: optax.warmup_cosine_decay_schedule, ...}"
                )
            self.lr_scheduler_obj = build_scheduler(lr_scheduler["scheduler"])
            self.lr_monitor = lr_scheduler.get("monitor")
            self.lr_frequency = int(lr_scheduler.get("frequency", 1))
        elif lr_scheduler is not None:
            self._step_schedule = build_step_schedule(lr_scheduler)
        self.loss_state = self.loss.init_state() if self.loss is not None else None

    def _build_model(self, model, seed: Optional[int]) -> torch.nn.Module:
        if isinstance(model, dict):
            # not recursive: the model function builds its nested configs itself
            model = instantiate(model, _recursive_=False)
        if seed is not None and int(seed) != getattr(model, "model_config", {}).get("seed", 0):
            init_weights(model, int(seed))  # the JAX module draws the weights from its own seed
        return model.to(self.device)

    # --- parameters and optimizer ----------------------------------------
    def named_tensors(self) -> List[tuple]:
        """Every model tensor by JAX dotted path (under the model's name
        when the module holds several)."""
        if len(self.models) == 1:
            return list(self.model.jax_named_tensors())
        return [(f"{name}.{k}", t) for name, m in self.models.items() for k, t in m.jax_named_tensors()]

    def named_trainable(self) -> List[tuple]:
        return [(k, t) for k, t in self.named_tensors() if isinstance(t, torch.nn.Parameter) and t.requires_grad]

    @property
    def frozen_paths(self) -> List[str]:
        trainable = {k for k, _ in self.named_trainable()}
        return sorted(k for k, _ in self.named_tensors() if k not in trainable)

    def _build_optimizer(self, cfg: dict):
        """One optimizer over the trainable parameters: the base config's
        groups, and each ``param_groups`` entry's (its ``paths``' parameters,
        the first matching entry winning) from the base config updated by
        the entry."""
        cfg = dict(cfg)
        entries = [dict(g) for g in cfg.pop("param_groups", None) or []]
        paths = [tuple(g.pop("paths")) for g in entries]
        members: List[List[tuple]] = [[] for _ in range(len(entries) + 1)]
        for path, p in self.named_trainable():
            members[next((i + 1 for i, ps in enumerate(paths) if _path_matches(path, ps)), 0)].append((path, p))
        specs = [cfg] + [{**cfg, **g} for g in entries]
        return build_optimizer([group for spec, named in zip(specs, members)
                                for group in param_groups(spec, [p for _, p in named], [k for k, _ in named])])

    def set_lr_scale(self, scale: float) -> None:
        """Set the epoch LR scale, rounded to float32 (the JAX trainer's
        scale, which multiplies the update)."""
        self._lr_scale = float(np.float32(scale))
        self._set_rates()

    def _rate_factor(self) -> float:
        """What every group's base rate is multiplied by for the next update."""
        factor = self._lr_scale
        if self._step_schedule is not None:
            factor = factor * float(self._step_schedule(self.update_count))
        return factor

    def _set_rates(self) -> None:
        factor = self._rate_factor()
        for g, base in zip(self.optimizer.param_groups, self._base_lrs):
            g["lr"] = base * factor

    def lr_scheduler_epoch_end(self, epoch: int, metrics: Dict[str, float]) -> Optional[float]:
        """Step the epoch scheduler; the new LR scale, or None without one."""
        if self.lr_scheduler_obj is None:
            return None
        if (epoch + 1) % self.lr_frequency != 0:
            return self.lr_scheduler_obj.scale
        metric = metrics.get(self.lr_monitor) if self.lr_monitor else None
        return self.lr_scheduler_obj.step(metric)

    # --- steps ------------------------------------------------------------
    def _prepare(self, batch: dict) -> dict:
        if getattr(self.model, "uses_fused_kernels", False):
            batch = relayout_edge_stream(batch)
        return batch

    def compute_loss(self, batch: dict, loss_coeffs: Optional[Sequence[float]] = None, group=None):
        """``(loss, batch loss sums, loss values)`` of the model on a padded
        batch, with the graph for ``loss.backward()``; ``loss_coeffs`` (one
        per loss entry) default to the loss manager's.  With a process
        ``group`` (data parallel) the sums are merged over its ranks before
        the loss is formed (``MetricsManager.psum_batch``)."""
        batch = self._prepare(batch)
        out = self.model(batch)
        bs = self._merge(self.loss, self.loss.batch_state(out, batch), group)
        loss, values = self.loss.values(bs, self._coeffs(loss_coeffs))
        return loss, bs, values

    @staticmethod
    def _merge(mgr: MetricsManager, bs, group):
        return bs if group is None else mgr.psum_batch(bs, group)

    def _coeffs(self, loss_coeffs):
        return self.loss.coeff_vector() if loss_coeffs is None else list(loss_coeffs)

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

    def compute_grads_fr(self, batch: dict, loss_coeffs: Optional[Sequence[float]] = None, group=None):
        """fr: ``(loss, batch loss sums, loss values)`` with the parameter
        gradients of the loss accumulated into ``.grad`` (JAX
        ``_make_train_step_fr``); ``group`` as in ``compute_loss``."""
        batch = self._prepare(batch)
        if self.fr_edge_chunks:
            check_edge_chunks(self.fr_edge_chunks, batch[LAYOUT_KEY].n_real)
        coeffs = self._coeffs(loss_coeffs)
        with edge_chunks(self.model, self.fr_edge_chunks):
            # pass 1: the model's own first-order E+F (serving kernels unchunked)
            with frozen_weights(self.model) as model:
                out = model(batch)
            # the output cotangents v = dL/dout (a small elementwise graph)
            fields = {f: out[f].detach().requires_grad_(True) for f in self._loss_output_fields(out)}
            with torch.enable_grad():
                bs = self._merge(self.loss, self.loss.batch_state(dict(out, **fields), batch), group)
                loss, values = self.loss.values(bs, coeffs)
            grads = torch.autograd.grad(loss, list(fields.values()), allow_unused=True)
            v = {f: g for f, g in zip(fields, grads) if g is not None}
            # pass 2: one reverse pass over the jvp-augmented energy graph
            self.model.loss_surrogate(batch, v).backward()
        return loss.detach(), bs, values

    def training_step(self, batch: dict, loss_coeffs: Optional[Sequence[float]] = None,
                      group=None) -> Dict[str, torch.Tensor]:
        """One step on a padded batch (``force_grad_mode``); returns the
        step's loss values.  With a process ``group`` (data parallel, JAX's
        step under ``axis_name``) each rank passes its own micro-batch: the
        loss sums are merged before the loss and the gradients all-reduced
        after the backward, so every rank takes the global-batch step."""
        self._check_sole_model()
        self.optimizer.zero_grad(set_to_none=True)
        if self.force_grad_mode == "fr":
            loss, bs, values = self.compute_grads_fr(batch, loss_coeffs, group)
        else:
            loss, bs, values = self.compute_loss(batch, loss_coeffs, group)
            loss.backward()
        if group is not None:
            self._all_reduce_grads(group)
        return self._apply_update(bs, values, loss.detach())

    def _all_reduce_grads(self, group) -> None:
        """Sum every trainable parameter's ``.grad`` over ``group`` in place
        (one collective; a missing gradient counts as zeros)."""
        from ..parallel._collectives import all_reduce_grads

        params = [p for _, p in self.named_trainable()]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for p, g in zip(params, all_reduce_grads([p.grad for p in params], group)):
            p.grad.copy_(g)

    def _check_sole_model(self) -> None:
        if len(self.models) > 1:
            raise RuntimeError("the training step serves the sole model; a module of several models needs a "
                               "step of its own, as in the JAX package")

    def _apply_update(self, bs, values, loss=None) -> Dict[str, torch.Tensor]:
        """The global-norm clip, the optimizer's update (handed the step's
        ``loss``), the running loss sums and the post-update hook, on the
        gradients in ``.grad``."""
        if self.gradient_clip_val is not None:
            clip_grad_global_norm_([p for _, p in self.named_trainable()], self.gradient_clip_val)
        self._optimizer_step(loss)
        self.loss_state = self.loss.accumulate(self.loss_state, bs)
        self._post_optimizer_step()
        return {f"train_loss_step/{k}": v.detach() for k, v in values.items()}

    def _optimizer_step(self, loss=None) -> None:
        if self._step_schedule is not None:
            self._set_rates()
        step_optimizer(self.optimizer, loss)
        self.update_count += 1

    def _post_optimizer_step(self) -> None:
        pass

    def evaluation_model(self) -> torch.nn.Module:
        return self.model

    def evaluation_step(self, metrics: MetricsManager, state, batch: dict, group=None):
        """Accumulate ``metrics`` of the evaluation model on a batch (merged
        over the ranks of ``group`` under data parallel)."""
        batch = self._prepare(batch)
        out = self.predict_step(batch)
        return metrics.accumulate(state, self._merge(metrics, metrics.batch_state(out, batch), group)), out

    def predict_step(self, batch: dict) -> dict:
        """The evaluation model's outputs on a padded batch (serving kernels)."""
        batch = self._prepare(batch)
        with frozen_weights(self.evaluation_model()) as model, torch.no_grad():
            return model(batch)

    # --- persistence -------------------------------------------------------
    def hyperparameters(self) -> dict:
        """The module's resolved config, which a checkpoint stores."""
        return {
            "model": self.model_config or (
                dict(getattr(self.model, "model_config", {})) if len(self.models) == 1
                else {name: dict(getattr(m, "model_config", {})) for name, m in self.models.items()}),
            **self.metric_configs,
            "optimizer": self.optimizer_config,
            "lr_scheduler": self.lr_scheduler_config,
            "gradient_clip_val": self.gradient_clip_val,
            "seed": self.seed,
            "force_grad_mode": self.force_grad_mode,
            **({"fr_edge_chunks": self.fr_edge_chunks} if self.fr_edge_chunks else {}),
            "_target_": f"{type(self).__module__}.{type(self).__name__}",
        }

    def state_dict(self) -> Dict[str, Any]:
        """Model tensors by JAX dotted path (by model name first when the
        module holds several), optimizer state, update count and running
        loss sums, on the CPU."""
        if len(self.models) == 1:
            params = named_tensors_cpu(self.model)
        else:
            params = {name: named_tensors_cpu(m) for name, m in self.models.items()}
        return {
            "params": params,
            "optimizer": self.optimizer.state_dict(),
            "update_count": self.update_count,
            "loss_state": self.loss_state,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if len(self.models) == 1:
            load_jax_params(self.model, sd["params"])
        else:
            for name, m in self.models.items():
                load_jax_params(m, sd["params"][name])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.update_count = int(sd.get("update_count", 0))
        self.loss_state = sd["loss_state"]


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

    def hyperparameters(self) -> dict:
        return {**super().hyperparameters(), "ema_decay": self.ema_decay}

    def state_dict(self) -> Dict[str, Any]:
        return {**super().state_dict(), "ema_params": named_tensors_cpu(self.ema_model), "ema_step": self.ema_step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        super().load_state_dict(sd)
        load_jax_params(self.ema_model, sd["ema_params"])
        self.ema_step = int(sd["ema_step"])
