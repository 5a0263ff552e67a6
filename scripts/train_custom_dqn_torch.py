"""Train and evaluate the custom Double-DQN/PER trainer with the PyTorch port.

The port's counterpart of ``scripts/train_custom_dqn.py``: train
``rl_mpc_lanemerging_torch.agents.dqn`` on ``configs/train_default_1.json``
under LOG_DIR ``dqn_custom_default1`` (``runs_torch/dqn_custom_default1/
params.npz``, which then shadows the converted network of that name), then
evaluate the greedy policy over ``--episodes-eval`` episodes at ``--batch``
scenarios per round.  Runs on the card unless ``--device cpu``; appends the
evaluation's row to ``--csv PATH`` when given.

    python scripts/train_custom_dqn_torch.py [--episodes-train 20000]
        [--episodes-eval 4000] [--batch 512] [--device cuda] [--csv PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes-train", type=int, default=20000)
    ap.add_argument("--episodes-eval", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--csv", default=None, metavar="PATH")
    args = ap.parse_args()

    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch._device import resolve_device
    from rl_mpc_lanemerging_torch.agents import dqn
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.rundir import RUNS_ROOT

    dev = resolve_device(args.device)
    cfg = Settings.load_from_file(os.path.join(
        REPO, "configs/train_default_1.json")).replace(
        TASK="TRAIN_DQN", LOG_DIR="dqn_custom_default1",
        NUM_EPISODES=args.episodes_eval)
    state = dqn.train(cfg, num_episodes=args.episodes_train, device=dev)

    eval_cfg = cfg.replace(BATCH_SCENARIOS=args.batch)
    agg = tasks.evaluate_controller(
        eval_cfg, dqn.greedy_controller(state.net.to(dev), eval_cfg),
        device=dev)
    agg.print_stats()
    agg.save_plots(os.path.join(RUNS_ROOT, cfg.LOG_DIR))
    if args.csv:
        agg.add_csv_data(args.csv)


if __name__ == "__main__":
    main()
