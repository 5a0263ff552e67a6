"""CLI: ``python -m rl_mpc_lanemerging_torch.main configs/x.json``.

Port of ``rl_mpc_lanemerging_tpu/main.py`` (reference main.py:16-40,
84-102): load a JSON config and run its TASK.  Runs on the card unless
``--device cpu`` is given, and writes a CSV row only to the file named by
``--csv``.  Quirks of the reference dispatcher are kept
(EVALUATE_COMBINED_DQN loads the DDPG agent, main.py:35-37).

Under ``torchrun --nproc_per_node=N -m rl_mpc_lanemerging_torch.main ...``
the ranks join one process group (``parallel.sharded``) and the evaluation
tasks split their scenario batch over them; rank 0 alone prints the stats,
draws the plots and appends the ``--csv`` row.  The training tasks run in
one process (data-parallel training is ``make_sharded_train`` in
``agents/ddpg.py`` and ``agents/dqn.py``).
"""

from __future__ import annotations

import argparse
import itertools
import logging
from typing import Optional

import torch.distributed as dist

from . import tracing
from .config import Settings
from .parallel.sharded import maybe_initialize_distributed

_TRAINING_TASKS = ("TRAIN_DQN", "RESUME_DQN", "TRAIN_DDPG", "RESUME_DDPG")


def do_task(cfg: Settings, device: str = "cuda",
            csv_path: Optional[str] = None, num_frames: float = 1e6) -> None:
    """Run ``cfg.TASK``; a training task trains ``num_frames`` frames per
    stage and ends with the evaluation whose row ``csv_path`` receives."""
    task = cfg.TASK
    from .rundir import setup_run_dir
    if task in _TRAINING_TASKS and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise ValueError(f"TASK={task} runs in one process; data-parallel "
                         f"training is make_sharded_train in agents/ddpg.py "
                         f"and agents/dqn.py")
    if task == "ST":
        from . import tasks
        run = tasks.evaluate_st
    elif task in ("TRAIN_DQN", "RESUME_DQN"):
        from .agents import rainbow

        def run(cfg, device):
            return rainbow.train(cfg, num_frames=num_frames,
                                 resume=(task == "RESUME_DQN"),
                                 device=device)[1]
    elif task in ("TRAIN_DDPG", "RESUME_DDPG"):
        from .agents import ddpg

        def run(cfg, device):
            return ddpg.train(cfg, num_frames=num_frames,
                              resume=(task == "RESUME_DDPG"),
                              device=device)[1]
    elif task == "EVALUATE_DQN":
        from .agents import rainbow
        run = rainbow.evaluate
    elif task == "EVALUATE_DDPG":
        from .agents import ddpg
        run = ddpg.evaluate
    elif task in ("EVALUATE_COMBINED_DQN", "EVALUATE_COMBINED_DDPG"):
        # reference quirk: both load the DDPG agent (main.py:35-40)
        from .agents import ddpg
        run = ddpg.evaluate_combined
    else:
        raise ValueError(f"Unknown TASK: {task}")
    setup_run_dir(cfg, snapshot_src=False)
    agg = run(cfg, device=device)
    if csv_path and agg is not None:        # rank 0 alone holds the stats
        agg.add_csv_data(csv_path)


def do_grid_search_st(cfg: Settings, **kw) -> None:
    """ST-weight grid search (reference main.py:43-59): every combination
    of solver weights runs the configured task."""
    search_grid = {
        "V_WEIGHT": [0.5, 1.0],
        "A_WEIGHT": [0.0, 10.0],
        "J_WEIGHT": [0.0, 10.0, 50.0],
        "D_WEIGHT": [0.0, 10.0, 100.0, 1000.0],
        "MIN_ALLOWED_DISTANCE": [5, 6],
        "CRASH_MIN_S": [10, 15, 20],
    }
    for values in itertools.product(*search_grid.values()):
        do_task(cfg.replace(**dict(zip(search_grid.keys(), values))), **kw)


def do_grid_search_combined(cfg: Settings, **kw) -> None:
    """Combination-hyperparameter grid search (reference main.py:62-81),
    including the reference's pruning rules."""
    search_grid = {
        "ROLLOUT_LENGTH": [3, 5, 10, 20],
        "ST_TEST_ROLLOUTS": [2, 5, 10],
        "TEST_ROLLOUT_STATE": [True, False],
    }
    for values in itertools.product(*search_grid.values()):
        c = cfg.replace(**dict(zip(search_grid.keys(), values)))
        if not c.TEST_ROLLOUT_STATE and c.ST_TEST_ROLLOUTS != 2:
            continue
        if c.ROLLOUT_LENGTH == 1 and c.ST_TEST_ROLLOUTS != 2:
            continue
        if c.ST_TEST_ROLLOUTS > c.ROLLOUT_LENGTH:
            continue
        do_task(c, **kw)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="RL+MPC lane merging, PyTorch/CUDA port")
    parser.add_argument("config", nargs="?", default=None,
                        help="JSON settings file (reference format)")
    parser.add_argument("--episodes", type=int, default=None,
                        help="override NUM_EPISODES")
    parser.add_argument("--batch", type=int, default=None,
                        help="override BATCH_SCENARIOS")
    parser.add_argument("--frames", type=float, default=1e6,
                        help="frame budget per training stage (TRAIN_* "
                             "tasks; the reference trains 1e6 + 1e6 "
                             "extended, reference ddpg.py:96-102)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain PyTorch paths)")
    parser.add_argument("--csv", default=None, metavar="PATH",
                        help="append the run's stats row to this CSV")
    parser.add_argument("--grid-search", choices=["st", "combined"],
                        default=None,
                        help="sweep the reference's ST-weight or "
                             "combination grids around the loaded config "
                             "(reference main.py:43-81)")
    parser.add_argument("--trace-out", default=None, metavar="PATH",
                        help="trace the task (the spans and counters of "
                             "tracing.py) and write them to PATH as "
                             "Chrome-trace JSON when it ends; each rank of "
                             "a run of several writes PATH.rank<r>")
    args = parser.parse_args(argv)

    cfg = Settings() if args.config is None \
        else Settings.load_from_file(args.config)
    if args.episodes is not None:
        cfg = cfg.replace(NUM_EPISODES=args.episodes)
    if args.batch is not None:
        cfg = cfg.replace(BATCH_SCENARIOS=args.batch)
    logging.basicConfig(level=cfg.LOG_LEVEL)
    # joins the ranks of a torchrun launch (JAX main.py:121-126)
    maybe_initialize_distributed(
        None if args.device.startswith("cuda") else "gloo")
    run = {"st": do_grid_search_st, "combined": do_grid_search_combined,
           None: do_task}[args.grid_search]
    if args.trace_out:
        tracing.enable()
    try:
        run(cfg, device=args.device, csv_path=args.csv,
            num_frames=args.frames)
    finally:
        if args.trace_out:
            tracing.disable()
            path = args.trace_out
            if dist.is_initialized() and dist.get_world_size() > 1:
                path = f"{path}.rank{dist.get_rank()}"
            tracing.write_chrome_trace(path)
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
