"""Train and evaluate the tabular Q-learning legacy path with the PyTorch port.

The port's counterpart of ``scripts/train_tabular.py`` (reference rl.py:218-304
``learn_q_model``): rounds of B synchronized episodes under uniformly random
actions (epsilon = 1) on the JERK env with the plain Slotted reward, each
scenario's first episode kept, then the backward per-episode Q updates
folded over the B episodes in order, each in reverse
(``rl.tabular.fold_episodes``); STEP_SIZE halves every
STEP_SIZE_HALF_PER_EPISODES episodes.  Writes ``q.npy`` and ``visits.npy``
under ``runs_torch/<log_dir>/`` and evaluates the greedy policy at the
evaluation tick with AVOID_UNVISITED_STATES.  Runs on the card unless
``--device cpu``; appends the evaluation's row to ``--csv PATH`` when given.

    python scripts/train_tabular_torch.py [--episodes 30000] [--batch 256]
        [--eval-episodes 2000] [--log-dir tabular_q_default] [--seed 0]
        [--device cuda] [--csv PATH]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=30000,
                    help="training episodes (reference default 150000; the "
                         "table has 16.2k states and saturates far earlier "
                         "at batched throughput)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--eval-episodes", type=int, default=2000)
    ap.add_argument("--log-dir", default="tabular_q_default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--csv", default=None, metavar="PATH")
    args = ap.parse_args()

    import numpy as np
    import torch

    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch._device import resolve_device
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.rl import tabular
    from rl_mpc_lanemerging_torch.rundir import RUNS_ROOT, setup_run_dir
    from rl_mpc_lanemerging_torch.sim import CounterRandom, init_world

    dev = resolve_device(args.device)
    # the reference tabular path requires the plain Slotted reward
    # (rl.py:269-274); the JERK env actuates through JERK_VALUES_DQN while
    # the table's actions are JERK_VALUES (rl.py:177-187): pin them equal
    base = Settings()
    cfg = base.replace(
        TASK="TRAIN_Q", REWARD_FUNCTION="Slotted", LOG_DIR=args.log_dir,
        TICK_LENGTH=base.TRAINING_TICK_LENGTH,
        JERK_VALUES_DQN=base.JERK_VALUES,
        NUM_EPISODES=args.eval_episodes, BATCH_SCENARIOS=args.batch)
    run = setup_run_dir(cfg, snapshot_src=False)
    run_dir = os.path.join(RUNS_ROOT, cfg.LOG_DIR)

    max_ticks = int(cfg.MAX_EPISODE_LENGTH / cfg.TICK_LENGTH)
    warm = int(20.0 / cfg.TICK_LENGTH)
    ticks = max_ticks + warm + 2
    q = tabular.initialize_q(cfg, device=dev)
    visits = tabular.initialize_q(cfg, device=dev)
    rounds = (args.episodes + args.batch - 1) // args.batch
    seeds = np.random.SeedSequence(args.seed).generate_state(2 * rounds)
    step_size = float(cfg.STEP_SIZE)
    episodes_done = 0
    t0 = time.time()
    for r in range(rounds):
        worlds = init_world(cfg, args.batch, torch.float32, dev)
        gen = torch.Generator(device=dev).manual_seed(int(seeds[2 * r]))
        rec = tabular.collect_random_round(
            cfg, worlds, CounterRandom(int(seeds[2 * r + 1])), ticks, gen)
        tabular.fold_episodes(q, visits, rec.states6, rec.actions,
                              rec.rewards, rec.valid, cfg.GAMMA, step_size)
        episodes_done += args.batch
        # STEP_SIZE halving cadence (rl.py:300-301)
        halvings = episodes_done // cfg.STEP_SIZE_HALF_PER_EPISODES
        step_size = float(cfg.STEP_SIZE) / (2.0 ** halvings)
        if (r + 1) % 10 == 0 or r == rounds - 1:
            nz = int(torch.count_nonzero(visits))
            print(f"round {r + 1}/{rounds} episodes={episodes_done} "
                  f"visited_sa={nz}/{visits.numel()} "
                  f"({time.time() - t0:.0f}s)", flush=True)
            run.log_scalars(episodes_done,
                            {"visited_sa": nz, "step_size": step_size})

    np.save(os.path.join(run_dir, "q.npy"), q.cpu().numpy())
    np.save(os.path.join(run_dir, "visits.npy"), visits.cpu().numpy())
    print(f"saved Q table -> {run_dir}/q.npy")

    # greedy evaluation at the evaluation tick (rl.py:245-260)
    eval_cfg = cfg.replace(TICK_LENGTH=cfg.EVALUATION_TICK_LENGTH)
    agg = tasks.evaluate_controller(
        eval_cfg, tabular.greedy_tabular_controller(q, visits, eval_cfg),
        num_episodes=args.eval_episodes, device=dev,
        max_episode_length=cfg.EVALUATION_EPISODE_LENGTH)
    agg.print_stats()
    agg.save_plots(run_dir)
    if args.csv:
        agg.add_csv_data(args.csv)


if __name__ == "__main__":
    main()
