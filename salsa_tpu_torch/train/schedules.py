"""Learning-rate and momentum schedules (counterpart of `salsa_tpu.train.schedules`).

The reference interpolates both the learning rate and Adam's beta1 piecewise-
linearly over milestone fractions of the total training steps. Each schedule is a
function of the step count computing `jnp.interp`'s arithmetic in float32, whose
last multiply-add XLA fuses (here the product is exact in float64, then rounded
with the sum).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def piecewise_linear_interp(milestone_steps: Sequence[float], values: Sequence[float]):
    """Returns schedule(step) -> np.float32, np.interp over the milestones with
    jnp.interp's float32 arithmetic (constant outside them)."""
    xs = np.asarray(milestone_steps, dtype=np.float32)
    ys = np.asarray(values, dtype=np.float32)
    tiny = np.spacing(np.finfo(np.float32).eps)

    def schedule(step) -> np.float32:
        x = np.float32(step)
        i = int(np.clip(np.searchsorted(xs, x, side="right"), 1, len(xs) - 1))
        dx = xs[i] - xs[i - 1]
        if abs(dx) <= tiny:
            f = ys[i - 1]
        else:
            q = np.float32((x - xs[i - 1]) / dx)
            f = np.float64(ys[i - 1]) + np.float64(q) * np.float64(ys[i] - ys[i - 1])
        if x < xs[0]:
            f = ys[0]
        if x > xs[-1]:
            f = ys[-1]
        return np.float32(f)

    return schedule


def make_lr_momentum_schedules(
    total_steps: int,
    milestones: Sequence[float] = (0.0, 0.1, 0.7, 1.0),
    lrs: Sequence[float] = (3e-4, 3e-4, 3e-4, 1e-4),
    moms: Sequence[float] = (0.9, 0.9, 0.9, 0.9),
):
    steps = [m * total_steps for m in milestones]
    return piecewise_linear_interp(steps, lrs), piecewise_linear_interp(steps, moms)
