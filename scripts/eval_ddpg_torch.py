"""Re-record an EVALUATE_DDPG row for a trained policy with the PyTorch port.

The port's counterpart of ``scripts/eval_ddpg.py``: build the evaluation
config from the matching train config (the reference's in-distribution
DDPG rows come from the training pipeline's final ``agent.evaluate`` call,
reference ddpg.py:114-117), point MODEL_NAME at
``runs/ddpg_<family><seed>_extended`` (its converted network under
``rl_mpc_lanemerging_torch/weights/``) and run ``agents.ddpg.evaluate``.
Runs on the card unless ``--device cpu``; appends the row to ``--csv PATH``
when given.

    python scripts/eval_ddpg_torch.py <family> <seed> [--episodes 4000]
        [--batch 1024] [--log-dir NAME] [--device cuda] [--csv PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def eval_config(family: str, seed: int, episodes: int, batch: int,
                log_dir=None):
    """The EVALUATE_DDPG settings of ``ddpg_<family><seed>_extended``."""
    from rl_mpc_lanemerging_torch.config import Settings
    cfg = Settings.load_from_file(os.path.join(
        REPO, "configs", f"train_{family}_{seed}.json"))
    name = f"ddpg_{family}{seed}_extended"
    return cfg.replace(TASK="EVALUATE_DDPG", MODEL_NAME=f"runs/{name}",
                       LOG_DIR=log_dir or name, NUM_EPISODES=episodes,
                       BATCH_SCENARIOS=batch)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("family")
    ap.add_argument("seed", type=int)
    ap.add_argument("--episodes", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--log-dir", default=None,
                    help="override the recorded LOG_DIR (e.g. the "
                         "reference's oddball ddpg_evaluate_low_2_4000)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--csv", default=None, metavar="PATH")
    args = ap.parse_args()

    from rl_mpc_lanemerging_torch.agents import ddpg
    cfg = eval_config(args.family, args.seed, args.episodes, args.batch,
                      args.log_dir)
    agg = ddpg.evaluate(cfg, device=args.device)
    if args.csv:
        agg.add_csv_data(args.csv)


if __name__ == "__main__":
    main()
