"""Time-schedulable hyperparameters: values that evaluate as p(t) over
training time (env-steps), with min/max clamps.

The port's own copy of ``drl_tetris_tpu/config/parameter.py`` (reference:
tools/parameter.py:8-66).  The trainer evaluates the learning-rate
schedule on the host once per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union


@dataclasses.dataclass(frozen=True)
class Parameter:
    """constant_parameter (tools/parameter.py:66)."""
    value: float

    def __call__(self, t: float = 0.0) -> float:
        return self.value


@dataclasses.dataclass(frozen=True)
class LinearParameter:
    """linear_parameter (tools/parameter.py:55-63).  With ``time_horizon``
    set, interpolate init -> final over [0, horizon]; otherwise the slope
    form init + decay * t."""
    init_val: float
    decay: float = 0.0
    min_val: Optional[float] = None
    max_val: Optional[float] = None
    final_val: Optional[float] = None
    time_horizon: Optional[float] = None

    def __call__(self, t: float) -> float:
        if self.time_horizon is not None:
            frac = max(min(t, self.time_horizon), 0.0) / self.time_horizon
            x = frac * self.final_val + (1.0 - frac) * self.init_val
        else:
            x = self.init_val + self.decay * t
        if self.min_val is not None:
            x = max(self.min_val, x)
        if self.max_val is not None:
            x = min(self.max_val, x)
        return x


@dataclasses.dataclass(frozen=True)
class ExpParameter:
    """exp_parameter (tools/parameter.py:35-53): init * base^(decay*t)."""
    init_val: float
    base: float = 10.0
    decay: float = 0.0
    min_val: Optional[float] = None
    max_val: Optional[float] = None

    def __call__(self, t: float) -> float:
        x = self.init_val * self.base ** (self.decay * t)
        if self.min_val is not None:
            x = max(self.min_val, x)
        if self.max_val is not None:
            x = min(self.max_val, x)
        return x


ParamLike = Union[float, int, Parameter, LinearParameter, ExpParameter]


def param_eval(p: ParamLike, t: float = 0.0) -> float:
    """Numbers pass through, parameters are evaluated at t."""
    if callable(p):
        return float(p(t))
    return float(p)
