"""Convert trained DDPG actors from orbax checkpoints to plain ``.npz`` files
for the PyTorch port.

    python scripts/export_ddpg_actors.py [runs/<name> ...]

With no arguments it converts the five actors that serve every
``combined_*_1``, ``combined_*_1b``, ``cross_*_1`` and ``cross_*_1b``
configuration.  For each run directory it restores ``<run>/params`` with the
JAX package's ``checkpoint.load_params`` and writes the actor's six float32
arrays, in the Flax layout (``Dense_i/kernel`` (in, out), ``Dense_i/bias``),
to ``rl_mpc_lanemerging_torch/weights/<name>.npz``.  The values are copied
bit for bit.  This script is the only place outside the tests where the port
meets orbax: it needs ``jax`` and ``orbax`` installed, the port does not.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rl_mpc_lanemerging_torch.checkpoint import weights_path  # noqa: E402
from rl_mpc_lanemerging_torch.convert import DENSE_LAYERS  # noqa: E402

DEFAULT_RUNS = tuple(f"runs/ddpg_{name}1_extended" for name in
                     ("default", "fast", "low", "medium", "moderate"))


def export(run_dir: str) -> str:
    from rl_mpc_lanemerging_tpu.checkpoint import load_params
    actor = load_params(os.path.join(REPO, run_dir))["actor"]["params"]
    if sorted(actor) != list(DENSE_LAYERS):
        raise ValueError(f"{run_dir}: unexpected actor layers "
                         f"{sorted(actor)}")
    arrays = {}
    for layer in DENSE_LAYERS:
        for leaf in ("kernel", "bias"):
            value = np.asarray(actor[layer][leaf])
            if value.dtype != np.float32:
                raise ValueError(f"{run_dir}: {layer}/{leaf} is "
                                 f"{value.dtype}, expected float32")
            arrays[f"{layer}/{leaf}"] = value
    path = weights_path(run_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **arrays)
    return path


def main(argv) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    for run_dir in argv or DEFAULT_RUNS:
        path = export(run_dir)
        print(f"{run_dir}/params -> {os.path.relpath(path, REPO)} "
              f"({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main(sys.argv[1:])
