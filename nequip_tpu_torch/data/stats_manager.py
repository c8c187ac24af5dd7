"""Dataset statistics: single-pass streaming statistics over a dataloader.

Port of ``nequip_tpu/data/stats_manager.py``.  The names it produces
(``num_neighbors_mean``, ``per_atom_energy_mean``, ``per_type_forces_rms``,
...) are what a model builder takes for ``avg_num_neighbors`` and the
per-type energy shifts and scales.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from . import _keys
from .modifier import BaseModifier, NumNeighbors, PerAtomModifier
from .stats import STAT_CLASSES


class DataStatisticsManager:
    """``metrics``: dicts with ``name``, ``field`` (a field name or a
    modifier), ``metric`` (``mean|rms|std|max|min|count``) and optionally
    ``per_type`` (node fields only)."""

    def __init__(
        self,
        metrics: List[Dict[str, Any]],
        dataloader_kwargs: Optional[dict] = None,
        type_names: Optional[List[str]] = None,
    ):
        self.type_names = list(type_names) if type_names else None
        self.dataloader_kwargs = dict(dataloader_kwargs or {})
        self.specs = []
        for m in metrics:
            field = BaseModifier(m["field"]) if isinstance(m["field"], str) else m["field"]
            metric = m["metric"].lower()
            if metric not in STAT_CLASSES:
                raise ValueError(f"unknown statistic {metric!r}")
            if m.get("per_type") and self.type_names is None:
                raise ValueError(f"per_type statistic {m.get('name')} requires type_names")
            self.specs.append({
                "name": m.get("name") or f"{field.name}_{metric}",
                "field": field,
                "metric": metric,
                "per_type": bool(m.get("per_type", False)),
            })

    def get_statistics(self, dataloader) -> Dict[str, Union[float, Dict[str, float]]]:
        accs: Dict[str, Any] = {}
        for spec in self.specs:
            new = STAT_CLASSES[spec["metric"]]
            accs[spec["name"]] = {t: new() for t in self.type_names} if spec["per_type"] else new()
        for batch in dataloader.host_batches():
            for spec in self.specs:
                values = np.asarray(spec["field"](batch), dtype=np.float64)
                if spec["per_type"]:
                    types = np.asarray(batch[_keys.ATOM_TYPE_KEY]).reshape(-1)
                    if values.shape[0] != types.shape[0]:
                        raise ValueError(f"per_type statistic {spec['name']} needs a node field")
                    for ti, tname in enumerate(self.type_names):
                        sel = values[types == ti]
                        if sel.size:
                            accs[spec["name"]][tname].update(sel)
                else:
                    accs[spec["name"]].update(values)
        return {
            spec["name"]: (
                {t: a.compute() for t, a in accs[spec["name"]].items()}
                if spec["per_type"]
                else accs[spec["name"]].compute()
            )
            for spec in self.specs
        }


def CommonDataStatisticsManager(
    dataloader_kwargs: Optional[dict] = None,
    type_names: Optional[List[str]] = None,
) -> DataStatisticsManager:
    """num_neighbors_mean, per_type_num_neighbors_mean, per_atom_energy_mean,
    forces_rms, per_type_forces_rms."""
    metrics = [
        {"name": "num_neighbors_mean", "field": NumNeighbors(), "metric": "mean"},
        {"name": "per_type_num_neighbors_mean", "field": NumNeighbors(), "metric": "mean", "per_type": True},
        {"name": "per_atom_energy_mean", "field": PerAtomModifier(_keys.TOTAL_ENERGY_KEY), "metric": "mean"},
        {"name": "forces_rms", "field": _keys.FORCE_KEY, "metric": "rms"},
        {"name": "per_type_forces_rms", "field": _keys.FORCE_KEY, "metric": "rms", "per_type": True},
    ]
    return DataStatisticsManager(metrics, dataloader_kwargs, type_names)


def EnergyOnlyDataStatisticsManager(
    dataloader_kwargs: Optional[dict] = None,
    type_names: Optional[List[str]] = None,
) -> DataStatisticsManager:
    metrics = [
        {"name": "num_neighbors_mean", "field": NumNeighbors(), "metric": "mean"},
        {"name": "per_atom_energy_mean", "field": PerAtomModifier(_keys.TOTAL_ENERGY_KEY), "metric": "mean"},
        {"name": "per_atom_energy_std", "field": PerAtomModifier(_keys.TOTAL_ENERGY_KEY), "metric": "std"},
        {"name": "total_energy_std", "field": _keys.TOTAL_ENERGY_KEY, "metric": "std"},
    ]
    return DataStatisticsManager(metrics, dataloader_kwargs, type_names)
