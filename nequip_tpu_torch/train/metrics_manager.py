"""Loss and metrics engine.

Port of ``nequip_tpu/train/metrics_manager.py`` in PyTorch:

* entries = {name, field (a field name or modifier), metric
  (mse|mae|rmse|maxabserr), coeff, per_type, per_type_coeffs, ignore_nan};
* coefficients are normalised to sum to 1;
* per-batch values are exact masked means (padding node/edge/frame masks
  and optional NaN-target masking);
* epoch accumulation keeps (sum of |err|, sum of err^2, count, max) in
  float64, batch-size invariant.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed

from ..data import _keys
from ..data.modifier import BaseModifier, PerAtomModifier

_METRIC_KINDS = ("mse", "mae", "rmse", "maxabserr")
_MASKS = {"node": _keys.NODE_MASK_KEY, "edge": _keys.EDGE_MASK_KEY, "graph": _keys.FRAME_MASK_KEY}
_SUMS = ("abs", "sq", "count", "max")


def _as_modifier(field) -> BaseModifier:
    if isinstance(field, BaseModifier):
        return field
    if isinstance(field, str):
        return BaseModifier(field)
    raise TypeError(f"cannot interpret metric field {field!r}")


class MetricsManager:
    def __init__(self, metrics: List[Dict[str, Any]], type_names: Optional[Sequence[str]] = None):
        self.type_names = list(type_names) if type_names else None
        self.entries = []
        for m in metrics:
            mod = _as_modifier(m["field"])
            metric = m.get("metric", "mse").lower()
            if metric not in _METRIC_KINDS:
                raise ValueError(f"unknown metric {metric!r}")
            per_type_coeffs = m.get("per_type_coeffs")
            per_type = bool(m.get("per_type", False)) or per_type_coeffs is not None
            if per_type and not self.type_names:
                raise ValueError("per_type metrics require type_names")
            self.entries.append({
                "name": m.get("name") or f"{mod.name}_{metric}",
                "mod": mod,
                "metric": metric,
                "coeff": m.get("coeff", None),
                "per_type": per_type,
                "per_type_coeffs": per_type_coeffs,
                "ignore_nan": bool(m.get("ignore_nan", False)),
                "ftype": mod.field_type,
            })
        names = [e["name"] for e in self.entries]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate metric names: {names}")
        self.set_coeffs({e["name"]: e["coeff"] for e in self.entries})

    def set_coeffs(self, coeffs: Dict[str, Optional[float]]) -> None:
        """Normalise the (non-None) coefficients to sum to 1."""
        total = sum(c for c in coeffs.values() if c is not None)
        self.coeffs: Dict[str, Optional[float]] = {}
        for e in self.entries:
            c = coeffs.get(e["name"], e["coeff"])
            self.coeffs[e["name"]] = None if c is None else (float(c) / total if total else 0.0)

    def coeff_vector(self) -> List[float]:
        """Normalised coefficients per entry (0 for metric-only entries),
        rounded to float32 as the JAX trainer passes them to its step."""
        return [float(np.float32(self.coeffs[e["name"]] or 0.0)) for e in self.entries]

    # --- batch level ---------------------------------------------------
    def _batch_sums(self, entry, output: dict, target: dict) -> Dict[str, torch.Tensor]:
        pred = entry["mod"](output)
        tgt = entry["mod"](target).to(pred.dtype)
        err = pred - tgt
        shape = (err.shape[0],) + (1,) * (err.ndim - 1)
        mask_key = _MASKS.get(entry["ftype"])
        if mask_key in target:
            m = target[mask_key].reshape(shape)
        else:
            m = torch.ones(shape, dtype=torch.bool, device=err.device)
        if entry["ignore_nan"]:
            m = m & torch.isfinite(tgt)
        err = torch.where(m, err, torch.zeros_like(err))
        mfull = m.to(err.dtype).expand_as(err)
        if entry["per_type"]:
            n_types = len(self.type_names)
            types = target[_keys.ATOM_TYPE_KEY].reshape(-1)
            flat_err, flat_m = err.reshape(err.shape[0], -1), mfull.reshape(err.shape[0], -1)

            def seg(v):
                return v.new_zeros(n_types).index_add_(0, types, v)

            mx = torch.full((n_types,), -float("inf"), dtype=err.dtype, device=err.device)
            mx = mx.scatter_reduce(0, types, flat_err.detach().abs().amax(dim=1), reduce="amax")
            return {
                "abs": seg(flat_err.abs().sum(dim=1)),
                "sq": seg((flat_err**2).sum(dim=1)),
                "count": seg(flat_m.sum(dim=1)),
                "max": mx,
            }
        return {
            "abs": err.abs().sum(),
            "sq": (err**2).sum(),
            "count": mfull.sum(),
            "max": err.detach().abs().max(),
        }

    @staticmethod
    def _value_from_sums(metric: str, sums):
        count = torch.clamp(sums["count"], min=1.0)
        if metric == "mae":
            return sums["abs"] / count
        if metric == "mse":
            return sums["sq"] / count
        if metric == "rmse":
            return torch.sqrt(sums["sq"] / count)
        # absent types keep the -inf fill: zero them
        return torch.where(sums["count"] > 0, sums["max"], torch.zeros_like(sums["max"]))

    def _entry_value(self, entry, sums):
        v = self._value_from_sums(entry["metric"], sums)
        if not entry["per_type"]:
            return v
        if entry["per_type_coeffs"]:
            w = torch.as_tensor(
                [float(entry["per_type_coeffs"].get(t, 0.0)) for t in self.type_names], dtype=v.dtype, device=v.device
            )
            w = w / w.sum()
        else:  # unweighted mean over the types present
            present = (sums["count"] > 0).to(v.dtype)
            w = present / torch.clamp(present.sum(), min=1.0)
        return (w * v).sum()

    def batch_state(self, output: dict, target: dict) -> Dict[str, Dict[str, torch.Tensor]]:
        return {e["name"]: self._batch_sums(e, output, target) for e in self.entries}

    def psum_batch(self, bs, group):
        """Merge the batch sums over the ranks of ``group`` (JAX ``psum_batch``).

        The parameter-dependent sums are linearised: the value is the sum
        over the ranks, the gradient flows through this rank's term only,
        so the gradients all-reduced after the backward are the exact
        global-batch gradient (differentiating an all-reduced loss and
        all-reducing again would count every term world-size times).
        """
        from ..parallel._collectives import all_reduce

        def lin(x):
            return x + (all_reduce(x, group) - x).detach()

        return {
            name: {
                "abs": lin(s["abs"]),
                "sq": lin(s["sq"]),
                "count": all_reduce(s["count"], group),
                "max": all_reduce(s["max"], group, op=torch.distributed.ReduceOp.MAX),
            }
            for name, s in bs.items()
        }

    def values(self, bs, coeffs: Optional[Sequence[float]] = None):
        """``(weighted_loss, values)`` of a batch state; ``coeffs`` (one per
        entry) overrides the stored normalised coefficients."""
        values: Dict[str, torch.Tensor] = {}
        loss = 0.0
        for i, e in enumerate(self.entries):
            v = self._entry_value(e, bs[e["name"]])
            values[e["name"]] = v
            c = coeffs[i] if coeffs is not None else self.coeffs[e["name"]]
            if c is not None:
                loss = loss + c * v
            if e["per_type"]:
                per_type_v = self._value_from_sums(e["metric"], bs[e["name"]])
                for t, pv in zip(self.type_names, per_type_v):
                    values[f"{e['name']}_{t}"] = pv
        values["weighted_sum"] = loss
        return loss, values

    def __call__(self, output: dict, target: dict, coeffs=None):
        return self.values(self.batch_state(output, target), coeffs)

    # --- epoch accumulation (host, float64) ------------------------------
    def init_state(self) -> Dict[str, Dict[str, np.ndarray]]:
        state = {}
        for e in self.entries:
            shape = (len(self.type_names),) if e["per_type"] else ()
            state[e["name"]] = {
                "abs": np.zeros(shape), "sq": np.zeros(shape), "count": np.zeros(shape),
                "max": np.full(shape, -np.inf),
            }
        return state

    def accumulate(self, state, bs):
        new = {}
        for e in self.entries:
            s = state[e["name"]]
            d = {k: v.detach().to("cpu", torch.float64).numpy() for k, v in bs[e["name"]].items()}
            new[e["name"]] = {
                "abs": s["abs"] + d["abs"], "sq": s["sq"] + d["sq"], "count": s["count"] + d["count"],
                "max": np.maximum(s["max"], d["max"]),
            }
        return new

    def update_state(self, state, output: dict, target: dict):
        return self.accumulate(state, self.batch_state(output, target))

    def compute(self, state) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.entries:
            sums = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in state[e["name"]].items()}
            out[e["name"]] = float(self._entry_value(e, sums))
            if e["per_type"]:
                for t, pv in zip(self.type_names, self._value_from_sums(e["metric"], sums)):
                    out[f"{e['name']}_{t}"] = float(pv)
        comps = [(self.coeffs[e["name"]], out[e["name"]]) for e in self.entries if self.coeffs[e["name"]] is not None]
        if comps:
            out["weighted_sum"] = float(sum(c * v for c, v in comps))
        return out

    # --- checkpoint state ------------------------------------------------
    def state_dict(self) -> dict:
        return {"coeffs": dict(self.coeffs)}

    def load_state_dict(self, sd: dict) -> None:
        self.set_coeffs(sd.get("coeffs", {}))


# ---------------------------------------------------------------------------
# canned managers (the JAX package's EnergyForce(Stress)Loss/Metrics)
# ---------------------------------------------------------------------------
def EnergyForceLoss(
    coeffs: Optional[Dict[str, float]] = None,
    per_atom_energy: bool = True,
    per_type_forces_coeffs: Optional[Dict[str, float]] = None,
    type_names: Optional[List[str]] = None,
    extra_metrics: Optional[List[Dict]] = None,
) -> MetricsManager:
    coeffs = coeffs or {_keys.TOTAL_ENERGY_KEY: 1.0, _keys.FORCE_KEY: 1.0}
    forces_entry: Dict[str, Any] = {
        "name": "forces_mse", "field": _keys.FORCE_KEY, "coeff": coeffs[_keys.FORCE_KEY], "metric": "mse",
    }
    if per_type_forces_coeffs is not None:
        forces_entry.update(per_type=True, per_type_coeffs=per_type_forces_coeffs)
    metrics = [
        {
            "name": "per_atom_energy_mse" if per_atom_energy else "total_energy_mse",
            "field": PerAtomModifier(_keys.TOTAL_ENERGY_KEY) if per_atom_energy else _keys.TOTAL_ENERGY_KEY,
            "coeff": coeffs[_keys.TOTAL_ENERGY_KEY],
            "metric": "mse",
        },
        forces_entry,
    ]
    return MetricsManager(metrics + list(extra_metrics or []), type_names=type_names)


def EnergyForceStressLoss(
    coeffs: Optional[Dict[str, float]] = None,
    per_atom_energy: bool = True,
    type_names: Optional[List[str]] = None,
    extra_metrics: Optional[List[Dict]] = None,
) -> MetricsManager:
    coeffs = coeffs or {_keys.TOTAL_ENERGY_KEY: 1.0, _keys.FORCE_KEY: 1.0, _keys.STRESS_KEY: 1.0}
    stress = {"name": "stress_mse", "field": _keys.STRESS_KEY, "coeff": coeffs[_keys.STRESS_KEY],
              "metric": "mse", "ignore_nan": True}
    return EnergyForceLoss(
        {k: coeffs[k] for k in (_keys.TOTAL_ENERGY_KEY, _keys.FORCE_KEY)}, per_atom_energy,
        type_names=type_names, extra_metrics=[stress] + list(extra_metrics or []),
    )


def _ef_metric_entries(coeffs: Dict[str, Optional[float]]):
    field_map = {
        "total_energy": _keys.TOTAL_ENERGY_KEY,
        "per_atom_energy": PerAtomModifier(_keys.TOTAL_ENERGY_KEY),
        "forces": _keys.FORCE_KEY,
        "stress": _keys.STRESS_KEY,
    }
    entries = []
    for name, coeff in coeffs.items():
        base, _, metric = name.rpartition("_")
        if metric not in _METRIC_KINDS or base not in field_map:
            raise ValueError(f"unknown metric name {name!r}")
        entries.append({"name": name, "field": field_map[base], "coeff": coeff, "metric": metric,
                        "ignore_nan": base == "stress"})
    return entries


def EnergyForceMetrics(
    coeffs: Optional[Dict[str, Optional[float]]] = None,
    type_names: Optional[List[str]] = None,
    extra_metrics: Optional[List[Dict]] = None,
) -> MetricsManager:
    coeffs = coeffs or {
        "total_energy_rmse": 1.0, "per_atom_energy_rmse": None, "forces_rmse": 1.0,
        "total_energy_mae": None, "per_atom_energy_mae": None, "forces_mae": None,
    }
    return MetricsManager(_ef_metric_entries(coeffs) + list(extra_metrics or []), type_names=type_names)


def EnergyForceStressMetrics(
    coeffs: Optional[Dict[str, Optional[float]]] = None,
    type_names: Optional[List[str]] = None,
    extra_metrics: Optional[List[Dict]] = None,
) -> MetricsManager:
    coeffs = coeffs or {
        "total_energy_rmse": 1.0, "forces_rmse": 1.0, "stress_rmse": 1.0,
        "total_energy_mae": None, "forces_mae": None, "stress_mae": None,
    }
    return MetricsManager(_ef_metric_entries(coeffs) + list(extra_metrics or []), type_names=type_names)
