"""Parameter checkpoints of the port, and the converted JAX networks.

The JAX package keeps its networks as orbax checkpoints under
``runs/<name>/params`` (``rl_mpc_lanemerging_tpu/checkpoint.py``).  The port
reads neither orbax nor JAX.  Its checkpoints are ``.npz`` files of float32
arrays in the Flax layout, one key per leaf: ``<net>/<layer>/<leaf>``, e.g.
``actor/Dense_0/kernel`` (in, out), ``critic/Dense_2/bias`` or
``q_dist/NoisyDense_1/w_sigma``.  ``load_params`` returns them as the JAX
package's ``load_params`` does, ``{net: {"params": {layer: {leaf:
array}}}}``, and ``convert.py`` turns such a tree into a module's
``state_dict``.  Two places hold them:

* ``runs_torch/<name>/params.npz``: written by the port's trainers
  (``save_params``), parameters only, as the JAX trainers save no
  optimiser state;
* ``rl_mpc_lanemerging_torch/weights/<name>.npz``: the JAX package's trained
  networks, converted once by ``scripts/export_ddpg_actors.py``.

A ``MODEL_NAME`` ``runs/<name>`` resolves to the first that exists, so a
run of the port shadows the converted network of the same name; with
``committed=True`` the loaders read the converted network alone.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from . import convert
from .models.ddpg import DDPGActor
from .rundir import RUNS_ROOT

__all__ = ["WEIGHTS_DIR", "EXPORT_SCRIPT", "weights_path", "params_path",
           "write_npz", "save_params", "load_params", "load_actor_tree",
           "load_actor"]

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "weights")
EXPORT_SCRIPT = "scripts/export_ddpg_actors.py"
PARAMS_FILE = "params.npz"


def _base(model_name: str) -> str:
    return os.path.basename(os.path.normpath(model_name))


def weights_path(model_name: str) -> str:
    """``weights/<basename of MODEL_NAME>.npz``."""
    return os.path.join(WEIGHTS_DIR, _base(model_name) + ".npz")


def params_path(model_name: str, committed: bool = False) -> str:
    """The file ``MODEL_NAME`` resolves to: the port's own run
    ``runs_torch/<name>/params.npz`` when it exists and ``committed`` is
    false, else the converted ``weights/<name>.npz``."""
    run = os.path.join(RUNS_ROOT, _base(model_name), PARAMS_FILE)
    if not committed and os.path.exists(run):
        return run
    return weights_path(model_name)


def write_npz(path: str, tree: Dict[str, dict]) -> str:
    """Write ``{net: {"params": {layer: {leaf: array}}}}`` to ``path``,
    one array per leaf under ``<net>/<layer>/<leaf>``."""
    arrays = {}
    for net, variables in tree.items():
        for layer, leaves in variables["params"].items():
            for leaf, value in leaves.items():
                arrays[f"{net}/{layer}/{leaf}"] = np.asarray(value)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    return path


def save_params(run_dir: str, tree: Dict[str, dict]) -> str:
    """Write a parameter tree to ``<run_dir>/params.npz``; returns the
    path."""
    return write_npz(os.path.join(run_dir, PARAMS_FILE), tree)


def load_params(model_name: str, committed: bool = False
                ) -> Dict[str, dict]:
    """``{net: {"params": {layer: {leaf: array}}}}`` of ``MODEL_NAME``
    (``params_path``)."""
    path = params_path(model_name, committed)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no converted network at {path}: run `python {EXPORT_SCRIPT} "
            f"{model_name}` where orbax is installed to convert "
            f"{model_name}/params")
    tree: Dict[str, dict] = {}
    with np.load(path) as data:
        for key in data.files:
            net, layer, leaf = key.split("/")
            tree.setdefault(net, {"params": {}})["params"].setdefault(
                layer, {})[leaf] = data[key]
    return tree


def load_actor_tree(model_name: str, committed: bool = False):
    """The actor's Flax parameter tree as numpy."""
    return load_params(model_name, committed)["actor"]


def load_actor(model_name: str, device, action_low: float = -5.0,
               action_high: float = 5.0, committed: bool = False
               ) -> DDPGActor:
    """The trained actor of ``MODEL_NAME`` on ``device``, in eval mode and
    with no gradients."""
    state = convert.ddpg_actor_from_numpy(
        load_actor_tree(model_name, committed))
    hidden, obs_dim = state["layers.Dense_0.weight"].shape
    actor = DDPGActor(obs_dim, action_low, action_high, hidden)
    actor.load_state_dict(state)
    return actor.to(device).eval().requires_grad_(False)
