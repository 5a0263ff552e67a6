"""What the world must do with the ego, for the check of the states that
follow a command: the ego's speed update (SUMO speedMode 22, the paper's
control.py:160-171 command reaching the car accel- and decel-limited) and
the start-speed draw of an episode (control.py:198-204), keyed as the
program's documented counter-based draws are: a 32-bit hash of (seed,
scenario, world step, stream).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ego_speed_after", "start_speeds"]

_MASK32 = 0xFFFFFFFF
_START_A, _START_B = 5, 6       # the start draw's two streams


def ego_speed_after(speed, command, p):
    """The ego's speed one tick after ``command`` (B,) from ``speed``."""
    dt = p.TICK_LENGTH
    lo = speed + p.MAX_NEGATIVE_ACCELERATION * dt
    hi = speed + p.MAX_POSITIVE_ACCELERATION * dt
    return torch.minimum(torch.maximum(command.to(speed.dtype), lo),
                         hi).clamp(0.0, 40.0)


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & _MASK32
    return x ^ (x >> 16)


def _uniform(seed: int, steps, stream: int):
    steps = steps.to(torch.int64)
    scen = torch.arange(steps.shape[0], dtype=torch.int64,
                        device=steps.device)
    h = _mix32(torch.full_like(steps, int(seed) & _MASK32) ^ stream)
    h = _mix32(h ^ (scen & _MASK32))
    h = _mix32(h ^ (steps & _MASK32))
    h = _mix32(h ^ (steps >> 32))
    return (h >> 8).to(torch.float64) * (2.0 ** -24)


def start_speeds(seed: int, steps, p, dtype=torch.float32):
    """Each scenario's start speed when its world has taken ``steps`` (B,)
    steps: START_SPEED + START_SPEED_VARIANCE * N(0, 1) (Box-Muller in
    float64), clamped to [MIN_START_SPEED, MAX_START_SPEED]."""
    if not p.RANDOMIZE_START_SPEED:
        return torch.full(steps.shape, p.START_SPEED, dtype=dtype,
                          device=steps.device)
    u1 = 1.0 - _uniform(seed, steps, _START_A)
    u2 = _uniform(seed, steps, _START_B)
    z = (torch.sqrt(-2.0 * torch.log(u1))
         * torch.cos(2.0 * np.pi * u2)).to(dtype)
    v = p.START_SPEED + p.START_SPEED_VARIANCE * z
    return v.clamp(p.MIN_START_SPEED, p.MAX_START_SPEED)
