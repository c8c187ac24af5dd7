"""The port's epoch LR schedulers against the JAX package's: each of the
nine gives the same scale sequence over 12 epochs from the same config and
monitored metric, with a state round trip (``state_dict`` into a freshly
built scheduler) after epoch 6 on both sides.  Pure Python: the sequences
must be equal to the last bit."""

import pytest

from nequip_tpu.train.lr_scheduler import build_scheduler as jax_build_scheduler
from nequip_tpu_torch.train.lr_scheduler import build_scheduler

METRICS = [1.0, 0.9, 0.9, 0.95, 0.89, 0.9, 0.9, 0.9, 0.7, 0.71, 0.72, 0.73]
ROUND_TRIP_AT = 6

SCHEDULERS = {
    "ConstantLR": {"factor": 0.5, "total_iters": 4},
    "StepLR": {"step_size": 3, "gamma": 0.5},
    "MultiStepLR": {"milestones": [2, 5, 9], "gamma": 0.3},
    "ExponentialLR": {"gamma": 0.9},
    "LinearLR": {"start_factor": 0.2, "end_factor": 1.0, "total_iters": 6},
    "CosineAnnealingLR": {"T_max": 5, "eta_min_factor": 0.1},
    "ReduceLROnPlateau": {"factor": 0.5, "patience": 1, "threshold": 0.01, "cooldown": 1, "min_lr_factor": 0.05},
    "SequentialLR": {
        "schedulers": [{"_target_": "{pkg}.train.LinearLR", "start_factor": 0.25, "total_iters": 4},
                       {"_target_": "{pkg}.train.ExponentialLR", "gamma": 0.8}],
        "milestones": [4],
    },
    "ChainedScheduler": {
        "schedulers": [{"_target_": "{pkg}.train.StepLR", "step_size": 2, "gamma": 0.5},
                       {"_target_": "{pkg}.train.ConstantLR", "factor": 0.5, "total_iters": 3}],
    },
}


def _config(name: str, pkg: str) -> dict:
    cfg = {"_target_": f"{pkg}.train.{name}", **SCHEDULERS[name]}
    if "schedulers" in cfg:
        cfg["schedulers"] = [{**s, "_target_": s["_target_"].format(pkg=pkg)} for s in cfg["schedulers"]]
    return cfg


def _scales(build, name: str, pkg: str, round_trip: bool):
    sched = build(_config(name, pkg))
    out = []
    for epoch, metric in enumerate(METRICS):
        if round_trip and epoch == ROUND_TRIP_AT:
            fresh = build(_config(name, pkg))
            fresh.load_state_dict(sched.state_dict())
            sched = fresh
        out.append(sched.step(metric))
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax(name):
    for round_trip in (False, True):
        got = _scales(build_scheduler, name, "nequip_tpu_torch", round_trip)
        want = _scales(jax_build_scheduler, name, "nequip_tpu", round_trip)
        assert got == want, (name, round_trip)
    straight = _scales(build_scheduler, name, "nequip_tpu_torch", False)
    assert len(set(straight)) > 1, "the sequence should move"
    assert _scales(build_scheduler, name, "nequip_tpu_torch", True) == straight
