"""Loading of the trained actors.

The JAX package keeps its trained networks as orbax checkpoints under
``runs/<name>/params`` (``rl_mpc_lanemerging_tpu/checkpoint.py``).  The port
reads neither orbax nor JAX: ``scripts/export_ddpg_actors.py`` converts a
checkpoint's actor once into ``weights/<name>.npz`` inside this package (six
float32 arrays in the Flax layout, ``Dense_i/kernel`` (in, out) and
``Dense_i/bias``), and ``load_actor`` reads that file.
"""

from __future__ import annotations

import os

import numpy as np

from . import convert
from .models.ddpg import DDPGActor

__all__ = ["WEIGHTS_DIR", "EXPORT_SCRIPT", "weights_path", "load_actor_tree",
           "load_actor"]

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "weights")
EXPORT_SCRIPT = "scripts/export_ddpg_actors.py"


def weights_path(model_name: str) -> str:
    """``weights/<basename of MODEL_NAME>.npz``."""
    base = os.path.basename(os.path.normpath(model_name))
    return os.path.join(WEIGHTS_DIR, base + ".npz")


def load_actor_tree(model_name: str):
    """The actor's Flax parameter tree as numpy, from its ``.npz``."""
    path = weights_path(model_name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no converted actor at {path}: run `python {EXPORT_SCRIPT} "
            f"{model_name}` where orbax is installed to convert "
            f"{model_name}/params")
    with np.load(path) as data:
        return {"params": {
            name: {"kernel": data[f"{name}/kernel"],
                   "bias": data[f"{name}/bias"]}
            for name in convert.DENSE_LAYERS}}


def load_actor(model_name: str, device, action_low: float = -5.0,
               action_high: float = 5.0) -> DDPGActor:
    """The trained actor of ``MODEL_NAME`` on ``device``, in eval mode and
    with no gradients."""
    state = convert.ddpg_actor_from_numpy(load_actor_tree(model_name))
    hidden, obs_dim = state["layers.Dense_0.weight"].shape
    actor = DDPGActor(obs_dim, action_low, action_high, hidden)
    actor.load_state_dict(state)
    return actor.to(device).eval().requires_grad_(False)
