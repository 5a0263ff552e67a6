"""Crash forensics of a combined-arbiter configuration with the PyTorch port.

The port's counterpart of ``scripts/combined_crash_forensics.py``: run the
combined RL+MPC arbiter (the DDPG actor of the config's ``MODEL_NAME``, the
controller carry when the config remembers the last choice) with every
tick's sensed state recorded and each crashing episode dumped, then replay
every dump through the float64 dense DP to classify the crash: did the
solver condemn a pre-crash state (an arbiter-gate miss), or does it see a
feasible path to the end (the policy steers into a situation the forecaster
cannot see)?  Dumps and plots go to ``runs_torch/<LOG_DIR>/forensics``.
Runs on the card unless ``--device cpu``; returns the per-dump summary.

    python scripts/combined_crash_forensics_torch.py
        [--config cross_moderate_network_slow_traffic_2] [--episodes 2000]
        [--batch 512] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run(cfg, device="cuda", verbose: bool = True):
    """Evaluate ``cfg``'s arbiter with crash capture, then replay each dump.
    Returns (the StatsAggregator, [(dump path, doomed flags)])."""
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch._device import resolve_device
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.agents.combined import combined_controller
    from rl_mpc_lanemerging_torch.forensics import replay_crash
    from rl_mpc_lanemerging_torch.rundir import RUNS_ROOT

    dev = resolve_device(device)
    out_dir = os.path.join(RUNS_ROOT, cfg.LOG_DIR, "forensics")
    os.makedirs(out_dir, exist_ok=True)
    for old in glob.glob(os.path.join(out_dir, "*.pkl")):
        os.remove(old)              # this run's dumps only
    policy = ddpg.actor_jerk(ddpg._actor_on(cfg, None, dev), cfg)
    controller, init_carry, takeover_stats = combined_controller(policy, cfg)
    carry = init_carry(cfg.BATCH_SCENARIOS, dev) if init_carry else None
    agg = tasks.evaluate_controller(
        cfg, controller, device=dev, custom_stats=takeover_stats,
        controller_carry=carry, save_state_on_crash=True, run_dir=out_dir,
        verbose=verbose)
    replays = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.pkl"))):
        doomed, _ = replay_crash(path, cfg, out_dir=out_dir, device=dev)
        replays.append((path, doomed))
        if verbose:
            first = next((i for i, x in enumerate(doomed) if x), None)
            print(f"  {os.path.basename(path)}: {len(doomed)} pre-crash "
                  f"states; solver-condemned from state "
                  f"{'NEVER' if first is None else first} "
                  f"({sum(doomed)}/{len(doomed)} condemned)", flush=True)
    return agg, replays


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    default="cross_moderate_network_slow_traffic_2")
    ap.add_argument("--episodes", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from rl_mpc_lanemerging_torch.config import Settings
    cfg = Settings.load_from_file(os.path.join(
        REPO, "configs", f"{args.config}.json")).replace(
        NUM_EPISODES=args.episodes, BATCH_SCENARIOS=args.batch)
    agg, replays = run(cfg, args.device)
    avg = agg.get_stat_averages()
    print(f"eval: crash={avg['crashed']:.4f} merge={avg['merged']:.4f} "
          f"episodes={args.episodes}; {len(replays)} crash dumps")


if __name__ == "__main__":
    main()
