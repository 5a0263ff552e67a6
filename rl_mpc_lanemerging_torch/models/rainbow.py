"""Rainbow network: NoisyNet linear layers + C51 distributional head.

Port of ``rl_mpc_lanemerging_tpu/models/rainbow.py`` (reference
rainbow.py:46-49): C51 categorical value distribution, factorized-Gaussian
NoisyNets for exploration, dueling aggregation.  PER and multi-step targets
are the trainer's (``agents/rainbow.py`` on ``rl/replay.py``).

Parameters keep the Flax layout and names: ``NoisyDense_i`` holds ``w_mu``
and ``w_sigma`` (in, out) and ``b_mu`` and ``b_sigma`` (out,), and a layer
computes ``x @ w + b`` as the JAX layer does.  A fresh layer starts as the
JAX one: ``w_mu`` and ``b_mu`` from ``nn.initializers.uniform(scale=2 /
sqrt(in))``, which draws U[0, 2 / sqrt(in)) (the published recipe draws
U[-1 / sqrt(in), 1 / sqrt(in)); the port follows the JAX package), and
the sigmas at sigma0 / sqrt(in).

The noise is an explicit argument: ``forward(x, noise)`` with one
``(eps_in, eps_out)`` pair per layer, already passed through f(e) =
sign(e) sqrt(|e|); ``sample_noise`` draws them from a generator.  With
``noise=None`` the net uses the means only, as the JAX net does with
``rng=None``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = ["NoisyDense", "RainbowNet", "atom_support", "sample_noise"]

Noise = Sequence[Tuple[torch.Tensor, torch.Tensor]]


class NoisyDense(nn.Module):
    """Factorized-Gaussian noisy linear layer (Fortunato et al. 2018)."""

    def __init__(self, in_features: int, features: int, sigma0: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        bound = 1.0 / math.sqrt(in_features)
        sigma_init = sigma0 / math.sqrt(in_features)
        self.w_mu = nn.Parameter(torch.rand((in_features, features),
                                            generator=generator)
                                 * (2 * bound))
        self.b_mu = nn.Parameter(torch.rand((features,), generator=generator)
                                 * (2 * bound))
        self.w_sigma = nn.Parameter(torch.full((in_features, features),
                                               sigma_init))
        self.b_sigma = nn.Parameter(torch.full((features,), sigma_init))

    def forward(self, x: torch.Tensor, eps=None) -> torch.Tensor:
        if eps is None:
            return x @ self.w_mu + self.b_mu
        eps_in, eps_out = eps
        w = self.w_mu + self.w_sigma * torch.outer(eps_in, eps_out)
        b = self.b_mu + self.b_sigma * eps_out
        return x @ w + b


class RainbowNet(nn.Module):
    """Dueling C51 head over discrete jerk actions: obs (..., obs_dim) ->
    logits (..., actions, atoms)."""

    def __init__(self, obs_dim: int = 20, num_actions: int = 5,
                 num_atoms: int = 51, hidden: int = 256, sigma0: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_actions, self.num_atoms = num_actions, num_atoms
        self.layers = nn.ModuleDict({
            "NoisyDense_0": NoisyDense(obs_dim, hidden, sigma0, generator),
            "NoisyDense_1": NoisyDense(hidden, num_atoms, sigma0, generator),
            "NoisyDense_2": NoisyDense(hidden, num_actions * num_atoms,
                                       sigma0, generator)})

    def forward(self, x: torch.Tensor, noise: Optional[Noise] = None
                ) -> torch.Tensor:
        eps = list(noise) if noise is not None else [None] * 3
        layers = self.layers
        x = torch.relu(layers["NoisyDense_0"](x, eps[0]))
        value = layers["NoisyDense_1"](x, eps[1])
        adv = layers["NoisyDense_2"](x, eps[2])
        adv = adv.reshape(x.shape[:-1] + (self.num_actions, self.num_atoms))
        return value[..., None, :] + adv - adv.mean(dim=-2, keepdim=True)


def sample_noise(net: RainbowNet, generator: torch.Generator) -> Noise:
    """One ``(eps_in, eps_out)`` pair per layer of ``net``, f(e) = sign(e)
    sqrt(|e|) of standard normals from ``generator`` (on the net's
    device, in its dtype)."""
    def f(e):
        return torch.sign(e) * torch.sqrt(torch.abs(e))

    out = []
    for layer in net.layers.values():
        n_in, n_out = layer.w_mu.shape
        like = dict(generator=generator, dtype=layer.w_mu.dtype,
                    device=layer.w_mu.device)
        out.append((f(torch.randn((n_in,), **like)),
                    f(torch.randn((n_out,), **like))))
    return out


def atom_support(v_min: float = -10.0, v_max: float = 10.0,
                 num_atoms: int = 51, dtype=torch.float32,
                 device="cpu") -> torch.Tensor:
    return torch.linspace(v_min, v_max, num_atoms, dtype=dtype,
                          device=device)
