"""Q-network MLP of the custom DQN trainer.

Port of ``rl_mpc_lanemerging_tpu/models/mlp.py`` (reference dqn.py:566-658
``DQN``): input = the observation vector, one 256-unit hidden layer at the
default ``num_hidden=2`` (the reference builds ``num_hidden - 2`` middle
layers, dqn.py:578), ReLU activations, a linear head over the discrete
jerk actions, optional dropout (dqn.py:580-591).  The layers are named
``Dense_0..`` after the Flax modules whose parameters they take
(``convert.dqn_from_numpy``), and a fresh net starts as Flax's ``nn.Dense``
does (``models.ddpg.lecun_normal_``, zero biases).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .ddpg import lecun_normal_

__all__ = ["DQNNet"]


class DQNNet(nn.Module):
    """obs (B, obs_dim) -> Q values (B, num_outputs).  ``generator`` draws
    the initial kernels (seed 0 when None)."""

    def __init__(self, obs_dim: int = 20, num_outputs: int = 5,
                 hidden_size: int = 256, num_hidden: int = 2,
                 dropout: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [obs_dim] + [hidden_size] * (num_hidden - 1) + [num_outputs]
        self.layers = nn.ModuleDict({
            f"Dense_{i}": nn.Linear(widths[i], widths[i + 1])
            for i in range(len(widths) - 1)})
        self.dropout = dropout
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for layer in self.layers.values():
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        *hidden, head = self.layers.values()
        for layer in hidden:
            x = layer(x)
            if self.dropout:
                x = nn.functional.dropout(x, 0.5, training=not deterministic)
            x = torch.relu(x)
        return head(x)
