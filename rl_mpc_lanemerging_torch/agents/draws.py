"""The trainers' draw source.

Every random draw a trainer makes outside the world (exploration noise,
epsilon uniforms and random actions, NoisyNet noise, replay uniforms) comes
from a draw source, so that a test can feed another implementation's draws
(the JAX key chains) and hold a whole round to it.  ``GeneratorDraws``, the
default, makes them from one ``torch.Generator`` in the order the trainer
asks for them.  The world's own draws come from its source in
``sim/rng.py``.
"""

from __future__ import annotations

import torch

from ..models.rainbow import sample_noise

__all__ = ["GeneratorDraws"]


class GeneratorDraws:
    """The draws of the DDPG, Rainbow and custom DQN trainers from one
    ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device) -> "GeneratorDraws":
        """The trainers' default: a generator on ``device`` from ``seed``."""
        return cls(torch.Generator(device=device).manual_seed(seed))

    def action_noise(self, shape, dtype, device) -> torch.Tensor:
        """Standard normals for DDPG's exploration noise of one tick."""
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=device)

    def explore(self, batch: int, device, dtype=torch.float64
                ) -> torch.Tensor:
        """U[0, 1) per scenario, held against epsilon."""
        return torch.rand((batch,), generator=self.generator, dtype=dtype,
                          device=device)

    def random_action(self, batch: int, num_actions: int, device
                      ) -> torch.Tensor:
        return torch.randint(0, num_actions, (batch,),
                             generator=self.generator, device=device)

    def replay_uniform(self, batch: int, dtype, device) -> torch.Tensor:
        """U[0, 1) per row of one replay draw."""
        return torch.rand((batch,), generator=self.generator, dtype=dtype,
                          device=device)

    def tick_noise(self, net):
        """The NoisyNet noise of a collect tick."""
        return sample_noise(net, self.generator)

    def step_noise(self, net):
        """The NoisyNet noise of a grad step's online forward pass."""
        return sample_noise(net, self.generator)
