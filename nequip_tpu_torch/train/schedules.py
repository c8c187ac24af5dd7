"""Learning-rate schedules: the port's copies of optax's fourteen.

A training module's ``lr_scheduler`` may name one of these instead of the
epoch form (``{scheduler, monitor, interval: epoch}``): the schedule's
value at the optimizer's update count (0 at the first update, one more per
update, as ``optax.scale_by_schedule`` counts) multiplies that update, on
top of the epoch scheduler's scale.  An optimizer's rate (``learning_rate``,
``polyak_sgd``'s ``scaling``) may be one too: its count is that
transform's own update count (``rate``).  Each function takes optax's
arguments and defaults and returns ``count -> float``; the arithmetic is
optax's in Python floats (float64).  A config names them as
``optax.<name>`` or ``optax.schedules.<name>``; ``build_step_schedule``
maps both spellings here without importing optax, and builds the nested
schedule configs of ``join_schedules``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

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


def join_schedules(schedules: Sequence, boundaries: Sequence[int]) -> Schedule:
    """``schedules[i + 1]`` from ``boundaries[i]`` on, counted from there;
    each schedule may be a ``{_target_: ...}`` config."""
    schedules = [build_step_schedule(f) if isinstance(f, dict) else f for f in schedules]

    def schedule(count):
        out = schedules[0](count)
        for boundary, f in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = f(count - boundary)
        return out

    return schedule


def piecewise_interpolate_schedule(interpolate_type: str, init_value: float,
                                   boundaries_and_scales: Optional[Dict[int, float]] = None) -> Schedule:
    if interpolate_type == "linear":
        interpolate = lambda start, end, pct: (end - start) * pct + start  # noqa: E731
    elif interpolate_type == "cosine":
        interpolate = lambda start, end, pct: end + (start - end) / 2.0 * (np.cos(np.pi * pct) + 1)  # noqa: E731
    else:
        raise ValueError("`interpolate_type` must be either 'cosine' or 'linear'")
    if boundaries_and_scales:
        boundaries, scales = zip(*sorted((int(k), float(v)) for k, v in boundaries_and_scales.items()))
        if not all(s >= 0.0 for s in scales):
            raise ValueError("`piecewise_interpolate_schedule` expects non-negative scale factors")
    else:
        boundaries, scales = (), ()
    bounds = np.stack((0,) + boundaries)
    values = np.cumprod(np.stack((init_value,) + scales))
    sizes = bounds[1:] - bounds[:-1]

    def schedule(count):
        with np.errstate(divide="ignore", invalid="ignore"):
            indicator = (bounds[:-1] <= count) & (count < bounds[1:])
            values_between = interpolate(values[:-1], values[1:], (count - bounds[:-1]) / sizes)
            return float(indicator.dot(values_between) + (bounds[-1] <= count) * values[-1])

    return schedule


def linear_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             pct_final: float = 0.85, div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Schedule:
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a non-positive `transition_steps`")
    return piecewise_interpolate_schedule("linear", peak_value / div_factor, {
        int(pct_start * transition_steps): div_factor, int(pct_final * transition_steps): 1.0 / div_factor,
        transition_steps: 1.0 / final_div_factor})


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a non-positive `transition_steps`")
    return piecewise_interpolate_schedule("cosine", peak_value / div_factor, {
        int(pct_start * transition_steps): div_factor,
        int(transition_steps): 1.0 / (div_factor * final_div_factor)})


def warmup_constant_schedule(init_value: float, peak_value: float, warmup_steps: int) -> Schedule:
    return linear_schedule(init_value, peak_value, warmup_steps)


def warmup_exponential_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                      transition_steps: int, decay_rate: float, transition_begin: int = 0,
                                      staircase: bool = False, end_value: Optional[float] = None) -> Schedule:
    return join_schedules([linear_schedule(init_value, peak_value, warmup_steps),
                           exponential_decay(peak_value, transition_steps, decay_rate, transition_begin, staircase,
                                             end_value)], [warmup_steps])


def sgdr_schedule(cosine_kwargs: Sequence[dict]) -> Schedule:
    """Warmup-cosine cycles back to back (each a ``warmup_cosine_decay_schedule``'s arguments)."""
    schedules, boundaries, step = [], [], 0
    for kwargs in cosine_kwargs:
        schedules.append(warmup_cosine_decay_schedule(**kwargs))
        step += kwargs["decay_steps"]
        boundaries.append(step)
    return join_schedules(schedules, boundaries[:-1])


SCHEDULES = {f.__name__: f for f in (
    constant_schedule, linear_schedule, polynomial_schedule, cosine_decay_schedule, warmup_cosine_decay_schedule,
    exponential_decay, piecewise_constant_schedule, cosine_onecycle_schedule, join_schedules,
    linear_onecycle_schedule, piecewise_interpolate_schedule, sgdr_schedule, warmup_constant_schedule,
    warmup_exponential_decay_schedule)}


def build_step_schedule(cfg: dict) -> Schedule:
    """The schedule a ``{_target_: optax[.schedules].<name>, ...}`` config names."""
    cfg = dict(cfg)
    target = str(cfg.pop("_target_", ""))
    module, _, name = target.rpartition(".")
    if module not in ("optax", "optax.schedules") or name not in SCHEDULES:
        raise ValueError(f"schedule {target!r} is not supported; the supported schedules are "
                         f"optax[.schedules].{{{', '.join(SCHEDULES)}}}")
    return SCHEDULES[name](**cfg)


def rate(value, name: str = "learning_rate") -> Union[float, Schedule]:
    """A rate an optax argument takes as a number or a schedule: a float,
    or the schedule a ``{_target_: ...}`` config names."""
    if isinstance(value, dict):
        return build_step_schedule(value)
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"{name} must be a number or a schedule config, got {value!r}")
    return float(value)
