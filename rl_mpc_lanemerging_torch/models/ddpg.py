"""DDPG actor-critic networks.

Port of ``rl_mpc_lanemerging_tpu/models/ddpg.py``: a deterministic
tanh-squashed actor over the continuous jerk range and a state-action Q
critic, both small fully connected ReLU nets sized for the 20-d
observation.  The layers are named ``Dense_0..2`` after the Flax modules
whose parameters they take (``convert.ddpg_actor_from_numpy``).

A fresh net starts as Flax's ``nn.Dense`` does: a LeCun-normal kernel
(``variance_scaling(1.0, "fan_in", "truncated_normal")``) and a zero bias,
drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["DDPGActor", "DDPGCritic", "lecun_normal_"]

# standard deviation of a unit normal truncated to [-2, 2]; Flax divides by
# it so that the truncated draws keep the requested variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """Fill an ``nn.Linear`` weight (out, in) as Flax's ``lecun_normal``
    fills the (in, out) kernel: a normal truncated at +-2 standard
    deviations, scaled to a standard deviation of sqrt(1 / fan_in).  The
    draw is the inverse CDF of uniforms from ``generator``."""
    fan_in = weight.shape[1]
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    with torch.no_grad():
        u = torch.rand(weight.shape, generator=generator, dtype=torch.float64)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (1.0 - 2.0 * lo) * u)
                                          - 1.0)
        weight.copy_(z.clamp(-2.0, 2.0) * std)
    return weight


def _mlp(in_dim: int, hidden: int, generator: Optional[torch.Generator]
         ) -> nn.ModuleDict:
    layers = nn.ModuleDict({"Dense_0": nn.Linear(in_dim, hidden),
                            "Dense_1": nn.Linear(hidden, hidden),
                            "Dense_2": nn.Linear(hidden, 1)})
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for layer in layers.values():
        lecun_normal_(layer.weight, generator)
        nn.init.zeros_(layer.bias)
    return layers


def _forward(layers: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(layers["Dense_0"](x))
    x = torch.relu(layers["Dense_1"](x))
    return layers["Dense_2"](x)


class DDPGActor(nn.Module):
    """obs (B, obs_dim) -> action (B, 1) in [action_low, action_high]
    (jerk).  ``generator`` draws the initial kernels (seed 0 when None)."""

    def __init__(self, obs_dim: int = 20, action_low: float = -5.0,
                 action_high: float = 5.0, hidden: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = _mlp(obs_dim, hidden, generator)
        self.mid = 0.5 * (action_high + action_low)
        self.half = 0.5 * (action_high - action_low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mid + self.half * torch.tanh(_forward(self.layers, x))


class DDPGCritic(nn.Module):
    """(obs (B, obs_dim), action (B, 1)) -> Q (B,).  ``generator`` draws
    the initial kernels (seed 0 when None)."""

    def __init__(self, obs_dim: int = 20, hidden: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = _mlp(obs_dim + 1, hidden, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor
                ) -> torch.Tensor:
        return _forward(self.layers, torch.cat([obs, action], dim=-1))[..., 0]
