"""State carried across from the JAX package to the port.

What crosses is configuration, simulator state and the trained DDPG,
Rainbow and custom DQN networks.  Inputs are plain numpy (dicts of arrays keyed by field name, e.g.
``jax.tree.map(np.asarray, state)._asdict()`` on the JAX side; the Flax
parameter tree as nested dicts of arrays), so this module imports nothing
of JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import Settings
from .prediction import HighwayState
from .sim.world import WorldState

__all__ = ["settings_from_json", "highway_state_from_numpy",
           "world_state_from_numpy", "ddpg_actor_from_numpy",
           "ddpg_critic_from_numpy", "rainbow_from_numpy",
           "dqn_from_numpy", "tree_from_state_dict", "layer_names",
           "DENSE_LAYERS", "NOISY_LAYERS"]

# the Flax modules of the JAX package's DDPGActor and DDPGCritic, in order
DENSE_LAYERS = ("Dense_0", "Dense_1", "Dense_2")
# the Flax modules of the JAX package's RainbowNet: hidden, value, advantage
NOISY_LAYERS = ("NoisyDense_0", "NoisyDense_1", "NoisyDense_2")
NOISY_LEAVES = ("w_mu", "b_mu", "w_sigma", "b_sigma")


def settings_from_json(path: str) -> Settings:
    """The port's ``Settings`` from a ``configs/*.json`` file."""
    return Settings.load_from_file(path)


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x)).to(device)


def highway_state_from_numpy(d: Mapping[str, np.ndarray],
                             device) -> HighwayState:
    """Batched ``HighwayState`` from arrays with a leading scenario axis."""
    return HighwayState(**{f: _tensor(d[f], device)
                           for f in HighwayState._fields})


def world_state_from_numpy(d: Mapping[str, np.ndarray], device,
                           steps=None) -> WorldState:
    """Batched ``WorldState`` from the JAX world's arrays.  The JAX PRNG key
    (``rng``) is not carried: draws come from a source object keyed by
    ``steps`` (zeros unless given)."""
    fields = {f: _tensor(d[f], device)
              for f in WorldState._fields if f != "steps"}
    batch = fields["ego_arc"].shape[0]
    fields["steps"] = torch.zeros((batch,), dtype=torch.int64,
                                  device=device) if steps is None \
        else _tensor(steps, device).to(torch.int64)
    return WorldState(**fields)


def layer_names(params, kind: str = "Dense") -> tuple:
    """``<kind>_0 .. <kind>_{n-1}`` (``kind`` a Flax module name such as
    ``Dense`` or ``NoisyDense``) when those are exactly the layers of a
    Flax parameter dict, else ()."""
    names = tuple(f"{kind}_{i}" for i in range(len(params)))
    return names if sorted(params) == sorted(names) else ()


def _dense_state_dict(tree, layers=DENSE_LAYERS) -> Dict[str, torch.Tensor]:
    """Flax ``{'params': {'Dense_i': {'kernel' (in, out), 'bias'}}}`` as the
    ``state_dict`` of the port's module: ``nn.Linear.weight`` is (out, in),
    so ``weight = kernel.T``."""
    params = tree["params"]
    if sorted(params) != sorted(layers) or not layers:
        raise ValueError(f"expected layers {layers}, got {sorted(params)}")
    out = {}
    for name in layers:
        kernel = np.asarray(params[name]["kernel"])
        bias = np.asarray(params[name]["bias"])
        if kernel.ndim != 2 or bias.shape != (kernel.shape[1],):
            raise ValueError(f"{name}: kernel {kernel.shape} and bias "
                             f"{bias.shape} do not fit a dense layer")
        out[f"layers.{name}.weight"] = torch.as_tensor(kernel.T.copy())
        out[f"layers.{name}.bias"] = torch.as_tensor(bias.copy())
    return out


def ddpg_actor_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """``DDPGActor.state_dict()`` from the JAX actor's parameter tree."""
    return _dense_state_dict(tree)


def ddpg_critic_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """``DDPGCritic.state_dict()`` from the JAX critic's parameter tree
    (its first kernel has obs_dim + 1 rows: the action is the last input
    column on both sides)."""
    return _dense_state_dict(tree)


def dqn_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """``DQNNet.state_dict()`` from the JAX ``q`` parameter tree of the
    custom DQN (``Dense_0 .. Dense_{num_hidden-1}``)."""
    layers = layer_names(tree["params"])
    if len(layers) < 2:
        raise ValueError(f"expected layers Dense_0 .. Dense_k (k >= 1), got "
                         f"{sorted(tree['params'])}")
    return _dense_state_dict(tree, layers)


def rainbow_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """``RainbowNet.state_dict()`` from the JAX ``q_dist`` parameter tree:
    the port's noisy layers keep the Flax layout, so every leaf crosses
    as it is."""
    params = tree["params"]
    if sorted(params) != list(NOISY_LAYERS):
        raise ValueError(f"expected layers {NOISY_LAYERS}, got "
                         f"{sorted(params)}")
    return {f"layers.{name}.{leaf}": torch.as_tensor(
        np.array(params[name][leaf]))
        for name in NOISY_LAYERS for leaf in NOISY_LEAVES}


def tree_from_state_dict(state_dict: Mapping[str, torch.Tensor]):
    """The Flax parameter tree ``{"params": {layer: {leaf: array}}}`` of a
    port network's ``state_dict`` (``DDPGActor``, ``DDPGCritic``,
    ``RainbowNet`` or ``DQNNet``), as numpy: the inverse of the ``*_from_numpy``
    functions above."""
    params: Dict[str, dict] = {}
    for key, value in state_dict.items():
        _, layer, leaf = key.split(".")
        value = value.detach().cpu().numpy()
        if leaf == "weight":                 # nn.Linear (out, in)
            leaf, value = "kernel", value.T
        params.setdefault(layer, {})[leaf] = np.ascontiguousarray(value)
    return {"params": params}
