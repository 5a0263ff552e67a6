"""One rank of a multi-process sharded evaluation with the PyTorch port.

The port's counterpart of ``scripts/multihost_worker.py``.  Each process
joins the process group that torchrun's variables describe (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``; the port's
``parallel.sharded.maybe_initialize_distributed``), builds only its own
shard of ``--batch`` seeded scenarios (global scenarios ``[r * b, (r + 1) *
b)``, with their own draws) and runs the episodes of a constant 10 m/s
controller through ``tasks.evaluate_controller`` on the scenario mesh.
Every rank's stats reach rank 0, which writes the per-episode columns and
their means as JSON to ``--out``.  The device is the card unless
``--device cpu``; on the CPU the backend is ``gloo``.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=29500 \\
        python scripts/multihost_worker_torch.py --device cpu --out m.json

(or ``torchrun --nproc_per_node=2 scripts/multihost_worker_torch.py ...``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SETTINGS = dict(MAX_CARS=32, MAX_SENSED_CARS=16, SEED=42)
MAX_EPISODE_LENGTH = 60.0
WAIT_BEFORE_START = 30.0
COLUMNS = ("crashed", "merged", "time_taken", "mean_speed", "mean_abs_jerk")


def evaluate(batch: int, device, mesh="auto"):
    """The worker's evaluation: its StatsAggregator on rank 0 (and in a
    one-process run), None on the other ranks."""
    import torch
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch.config import Settings

    cfg = Settings().replace(**SETTINGS)
    return tasks.evaluate_controller(
        cfg, lambda st: torch.full_like(st.ego_speed, 10.0),
        num_episodes=batch, batch=batch, device=device,
        max_episode_length=MAX_EPISODE_LENGTH,
        wait_before_start=WAIT_BEFORE_START, verbose=False, mesh=mesh)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args()

    import numpy as np
    import torch.distributed as dist
    from rl_mpc_lanemerging_torch.parallel import sharded

    if not sharded.maybe_initialize_distributed(
            None if args.device.startswith("cuda") else "gloo"):
        raise SystemExit("multihost_worker_torch: needs RANK and WORLD_SIZE "
                         "of a run of more than one rank")
    try:
        agg = evaluate(args.batch, args.device)
        if agg is not None and args.out:
            cols = {k: np.asarray(agg.columns[k], np.float64).tolist()
                    for k in COLUMNS}
            with open(args.out, "w") as fh:
                json.dump({"world_size": dist.get_world_size(),
                           "columns": cols,
                           "means": {k: float(np.mean(v))
                                     for k, v in cols.items()}}, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
