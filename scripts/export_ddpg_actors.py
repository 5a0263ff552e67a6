"""Convert trained networks from orbax checkpoints to plain ``.npz`` files
for the PyTorch port.

    python scripts/export_ddpg_actors.py [runs/<name> ...]

With no arguments it converts the five DDPG runs that serve every
``combined_*_1``, ``combined_*_1b``, ``cross_*_1`` and ``cross_*_1b``
configuration, the Rainbow run ``runs/rainbow_default1_extended`` and the
custom DQN run ``runs/dqn_custom_default1``.  For each run directory it
restores ``<run>/params`` with the JAX package's ``checkpoint.load_params``
and writes every network in it (a DDPG run's ``actor`` and ``critic``, a
Rainbow run's ``q_dist``, a custom DQN run's ``q``; any net whose layers
are ``Dense_0 .. Dense_k`` or ``NoisyDense_0 .. NoisyDense_k``) to
``rl_mpc_lanemerging_torch/weights/<name>.npz``, one float32 array per leaf
under ``<net>/<layer>/<leaf>`` in the Flax layout (``Dense_i/kernel`` is
(in, out)), the layout ``rl_mpc_lanemerging_torch/checkpoint.py`` reads.
The values are copied bit for bit.  This script is the only place outside
the tests where the port meets orbax: it needs ``jax`` and ``orbax``
installed, the port does not.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rl_mpc_lanemerging_torch.checkpoint import (weights_path,  # noqa: E402
                                                 write_npz)
from rl_mpc_lanemerging_torch.convert import layer_names  # noqa: E402
DEFAULT_RUNS = tuple(f"runs/ddpg_{name}1_extended" for name in
                     ("default", "fast", "low", "medium", "moderate")) \
    + ("runs/rainbow_default1_extended", "runs/dqn_custom_default1")
LAYER_KINDS = ("Dense", "NoisyDense")


def export(run_dir: str) -> str:
    import numpy as np
    from rl_mpc_lanemerging_tpu.checkpoint import load_params
    restored = load_params(os.path.join(REPO, run_dir))
    for net, variables in restored.items():
        params = variables["params"]
        if len(params) < 2 or not any(layer_names(params, kind)
                                      for kind in LAYER_KINDS):
            raise ValueError(f"{run_dir}: unexpected {net} layers "
                             f"{sorted(params)}")
        for layer, leaves in params.items():
            for leaf, value in leaves.items():
                if np.asarray(value).dtype != np.float32:
                    raise ValueError(f"{run_dir}: {net}/{layer}/{leaf} is "
                                     f"{np.asarray(value).dtype}, expected "
                                     f"float32")
    return write_npz(weights_path(run_dir), restored)


def main(argv) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    for run_dir in argv or DEFAULT_RUNS:
        path = export(run_dir)
        print(f"{run_dir}/params -> {os.path.relpath(path, REPO)} "
              f"({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main(sys.argv[1:])
