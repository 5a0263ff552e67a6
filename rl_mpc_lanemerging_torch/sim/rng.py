"""Random draws of the merge world, from an explicit source object.

The JAX package carries a PRNG key inside every world and splits it each
tick.  Here ``world_step`` and ``run_episode_batch`` take their random
numbers from a source object instead, asking for the draws of scenario i at
that scenario's own world-step count ``WorldState.steps[i]``.  A scenario
that is frozen (its episode over, the others still running) does not
advance its count, so it asks for the same draws again next tick.

:class:`CounterRandom`, the default, is counter-based: each draw is a hash
of (seed, scenario index, step, stream), so scenario i's stream does not
depend on the batch size or on the device.  The scenario index is global:
a source made with ``offset=k`` hashes ``k + i`` for row i of its batch, so
the rank that holds scenarios k.. of a sharded batch draws exactly what
rows k.. of the whole batch draw in one process (the JAX package splits
its keys over the global batch before it shards them, tasks.py:44, :89).
A test can plug in any object with the same two methods, for example one
that replays another implementation's draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["StepDraws", "CounterRandom"]


class StepDraws(NamedTuple):
    """One world step's draws for B scenarios (world.py:290-330)."""

    vary: torch.Tensor          # (B,) U[0,1): spawn-interval jitter, or
    #                              the alternate flow's insertion Bernoulli
    type_idx: torch.Tensor      # (B,) int64: alternate-flow vType index
    speed_factor: torch.Tensor  # (B,) N(0,1): alternate-flow speedFactor
    depart: torch.Tensor        # (B,) U[0,1): cautious vType depart speed


_MASK32 = 0xFFFFFFFF
# stream ids of the distinct draws
_VARY, _TYPE, _SF_A, _SF_B, _DEP, _START_A, _START_B = range(7)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche hash on int64 tensors holding values in [0, 2^32).
    The multipliers are below 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & _MASK32
    return x ^ (x >> 16)


class CounterRandom:
    """Counter-based draws keyed by (seed, scenario index, step, stream);
    row i of a batch is scenario ``offset + i``."""

    def __init__(self, seed: int, offset: int = 0):
        self.seed = int(seed) & _MASK32
        self.offset = int(offset)

    def _bits(self, steps: torch.Tensor, stream: int) -> torch.Tensor:
        steps = steps.to(torch.int64)
        scen = torch.arange(self.offset, self.offset + steps.shape[0],
                            dtype=torch.int64, device=steps.device)
        h = _mix32(torch.full_like(steps, self.seed) ^ stream)
        h = _mix32(h ^ (scen & _MASK32))
        h = _mix32(h ^ (steps & _MASK32))
        return _mix32(h ^ (steps >> 32))

    def _uniform(self, steps, stream, dtype):
        """U[0, 1) with 24 random bits (exact in every float dtype)."""
        return (self._bits(steps, stream) >> 8).to(dtype) * (2.0 ** -24)

    def _normal(self, steps, stream_a, stream_b, dtype):
        """Box-Muller N(0, 1), computed in float64."""
        u1 = 1.0 - self._uniform(steps, stream_a, torch.float64)   # (0, 1]
        u2 = self._uniform(steps, stream_b, torch.float64)
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * np.pi * u2)
        return z.to(dtype)

    def step_draws(self, steps: torch.Tensor, dtype) -> StepDraws:
        from .world import IDM_TYPE_PROBS
        cdf = torch.as_tensor(np.cumsum(IDM_TYPE_PROBS),
                              device=steps.device)
        u_type = self._uniform(steps, _TYPE, torch.float64) * cdf[-1]
        type_idx = torch.searchsorted(cdf, u_type, right=True).clamp_max(
            cdf.shape[0] - 1)
        return StepDraws(
            vary=self._uniform(steps, _VARY, dtype),
            type_idx=type_idx,
            speed_factor=self._normal(steps, _SF_A, _SF_B, dtype),
            depart=self._uniform(steps, _DEP, dtype))

    def start_normal(self, steps: torch.Tensor, dtype) -> torch.Tensor:
        """N(0, 1) for the episode's random start speed
        (episode.py:98-104)."""
        return self._normal(steps, _START_A, _START_B, dtype)
