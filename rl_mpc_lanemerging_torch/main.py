"""CLI: ``python -m rl_mpc_lanemerging_torch.main configs/x.json``.

Port of the ST task of ``rl_mpc_lanemerging_tpu/main.py`` (reference
main.py:16-40, 84-102): load a JSON config and run its TASK.  Runs on the
card unless ``--device cpu`` is given, and writes a CSV row only to the
file named by ``--csv``.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional

from .config import Settings

# TASKs of the JAX package that later slices of the port bring over, with
# the ROADMAP.md item that ports them.
_LATER = {
    "EVALUATE_COMBINED_DQN": "Queue 1 item 12 (slice 2)",
    "EVALUATE_COMBINED_DDPG": "Queue 1 item 12 (slice 2)",
    "TRAIN_DDPG": "Queue 1 item 13 (slice 3)",
    "RESUME_DDPG": "Queue 1 item 13 (slice 3)",
    "EVALUATE_DDPG": "Queue 1 item 13 (slice 3)",
    "TRAIN_DQN": "Queue 1 item 14 (slice 3)",
    "RESUME_DQN": "Queue 1 item 14 (slice 3)",
    "EVALUATE_DQN": "Queue 1 item 14 (slice 3)",
}


def do_task(cfg: Settings, device: str = "cuda",
            csv_path: Optional[str] = None) -> None:
    task = cfg.TASK
    if task != "ST":
        if task in _LATER:
            raise NotImplementedError(
                f"TASK={task} is not ported to PyTorch yet: ROADMAP.md "
                f"{_LATER[task]}")
        raise ValueError(f"Unknown TASK: {task}")
    from . import tasks
    from .rundir import setup_run_dir
    setup_run_dir(cfg, snapshot_src=False)
    agg = tasks.evaluate_st(cfg, device=device)
    if csv_path:
        agg.add_csv_data(csv_path)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="RL+MPC lane merging, PyTorch/CUDA port")
    parser.add_argument("config", nargs="?", default=None,
                        help="JSON settings file (reference format)")
    parser.add_argument("--episodes", type=int, default=None,
                        help="override NUM_EPISODES")
    parser.add_argument("--batch", type=int, default=None,
                        help="override BATCH_SCENARIOS")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain PyTorch paths)")
    parser.add_argument("--csv", default=None, metavar="PATH",
                        help="append the run's stats row to this CSV")
    args = parser.parse_args(argv)

    cfg = Settings() if args.config is None \
        else Settings.load_from_file(args.config)
    if args.episodes is not None:
        cfg = cfg.replace(NUM_EPISODES=args.episodes)
    if args.batch is not None:
        cfg = cfg.replace(BATCH_SCENARIOS=args.batch)
    logging.basicConfig(level=cfg.LOG_LEVEL)
    do_task(cfg, device=args.device, csv_path=args.csv)


if __name__ == "__main__":
    main()
