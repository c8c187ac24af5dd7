"""Per-step learning-rate schedules: the port's copies of optax's.

A training module's ``lr_scheduler`` may name one of these instead of the
epoch form (``{scheduler, monitor, interval: epoch}``): the schedule's
value at the optimizer's update count (0 at the first update, one more per
update, as ``optax.scale_by_schedule`` counts) multiplies that update, on
top of the epoch scheduler's scale.  Each function takes optax's arguments
and defaults and returns ``count -> float``; the arithmetic is optax's in
Python floats (float64).  A config names them as ``optax.<name>`` or
``optax.schedules.<name>``; ``build_step_schedule`` maps both spellings
here without importing optax.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def polynomial_schedule(init_value: float, end_value: float, power: float, transition_steps: int,
                        transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        count = min(max(count - transition_begin, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * (frac**power) + end_value

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int, transition_begin: int = 0) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps, transition_begin)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0, exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        count = min(float(count), float(decay_steps))
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay**exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0, exponent: float = 1.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)
    return lambda count: warmup(count) if count < warmup_steps else decay(count - warmup_steps)


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float, transition_begin: int = 0,
                      staircase: bool = False, end_value: Optional[float] = None) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        decreased = count - transition_begin
        p = decreased / transition_steps
        if staircase:
            p = math.floor(p)
        value = init_value if decreased <= 0 else init_value * decay_rate**p
        if end_value is not None:
            value = max(value, end_value) if decay_rate < 1.0 else min(value, end_value)
        return value

    return schedule


def piecewise_constant_schedule(init_value: float, boundaries_and_scales: Optional[Dict[int, float]] = None) -> Schedule:
    if boundaries_and_scales is not None and not all(s >= 0.0 for s in boundaries_and_scales.values()):
        raise ValueError("`piecewise_constant_schedule` expects non-negative scale factors")
    steps = sorted((int(k), float(v)) for k, v in (boundaries_and_scales or {}).items())

    def schedule(count):
        v = init_value
        for threshold, scale in steps:
            if count >= threshold:
                v = scale * v
        return v

    return schedule


SCHEDULES = {f.__name__: f for f in (constant_schedule, linear_schedule, polynomial_schedule, cosine_decay_schedule,
                                     warmup_cosine_decay_schedule, exponential_decay, piecewise_constant_schedule)}


def build_step_schedule(cfg: dict) -> Schedule:
    """The schedule a ``{_target_: optax[.schedules].<name>, ...}`` config names."""
    cfg = dict(cfg)
    target = str(cfg.pop("_target_", ""))
    module, _, name = target.rpartition(".")
    if module not in ("optax", "optax.schedules") or name not in SCHEDULES:
        raise ValueError(f"per-step lr_scheduler {target!r} is not supported; the supported schedules are "
                         f"optax[.schedules].{{{', '.join(SCHEDULES)}}}")
    return SCHEDULES[name](**cfg)
