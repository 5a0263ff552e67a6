"""DDPG actor-critic networks.

Port of ``rl_mpc_lanemerging_tpu/models/ddpg.py``: a deterministic
tanh-squashed actor over the continuous jerk range and a state-action Q
critic, both small fully connected ReLU nets sized for the 20-d
observation.  The layers are named ``Dense_0..2`` after the Flax modules
whose parameters they take (``convert.ddpg_actor_from_numpy``).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["DDPGActor", "DDPGCritic"]


def _mlp(in_dim: int, hidden: int) -> nn.ModuleDict:
    return nn.ModuleDict({"Dense_0": nn.Linear(in_dim, hidden),
                          "Dense_1": nn.Linear(hidden, hidden),
                          "Dense_2": nn.Linear(hidden, 1)})


def _forward(layers: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(layers["Dense_0"](x))
    x = torch.relu(layers["Dense_1"](x))
    return layers["Dense_2"](x)


class DDPGActor(nn.Module):
    """obs (B, obs_dim) -> action (B, 1) in [action_low, action_high]
    (jerk)."""

    def __init__(self, obs_dim: int = 20, action_low: float = -5.0,
                 action_high: float = 5.0, hidden: int = 256):
        super().__init__()
        self.layers = _mlp(obs_dim, hidden)
        self.mid = 0.5 * (action_high + action_low)
        self.half = 0.5 * (action_high - action_low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mid + self.half * torch.tanh(_forward(self.layers, x))


class DDPGCritic(nn.Module):
    """(obs (B, obs_dim), action (B, 1)) -> Q (B,)."""

    def __init__(self, obs_dim: int = 20, hidden: int = 256):
        super().__init__()
        self.layers = _mlp(obs_dim + 1, hidden)

    def forward(self, obs: torch.Tensor, action: torch.Tensor
                ) -> torch.Tensor:
        return _forward(self.layers, torch.cat([obs, action], dim=-1))[..., 0]
