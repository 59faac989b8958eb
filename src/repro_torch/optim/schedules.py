"""Learning-rate schedules (pure functions of the step counter).

Port of ``repro/optim/schedules.py``.  Each schedule takes the step as
an int or a 0-d tensor and returns a Python float, computed in float32
as the JAX schedules compute it.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant_lr(base: float):
    return lambda step: float(_F(base))


def cosine_lr(base: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = np.clip(_F(int(step)) / _F(total_steps), _F(0), _F(1))
        cos = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * t))
        return float(_F(base) * (_F(final_frac) + _F(1 - final_frac) * cos))
    return f


def linear_warmup_cosine(base: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_lr(base, max(total_steps - warmup, 1), final_frac)

    def f(step):
        step = int(step)
        if step < warmup:
            return float(_F(base) * _F(step) / _F(max(warmup, 1)))
        return cos(step - warmup)
    return f
