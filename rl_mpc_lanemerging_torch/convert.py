"""State carried across from the JAX package to the port.

The ST slice has no learned weights; what crosses is configuration and
simulator state.  Inputs are plain numpy (dicts of arrays keyed by field
name, e.g. ``jax.tree.map(np.asarray, state)._asdict()`` on the JAX side),
so this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import Settings
from .prediction import HighwayState
from .sim.world import WorldState

__all__ = ["settings_from_json", "highway_state_from_numpy",
           "world_state_from_numpy"]


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
