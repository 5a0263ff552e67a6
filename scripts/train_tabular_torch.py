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
    python scripts/train_tabular_torch.py --compare LOG [--csv PATH]
        [--acceptance ACCEPTANCE_TORCH.md]

``--compare`` (no card) holds a run's printed log ``LOG`` and its row in
``--csv`` (the newest ``tabular_q_default`` row; ``run_data_torch.csv`` by
default) to the JAX package's run: ``visited_sa`` at each point from
10,240 episodes on that ``runs/tabular_q_default/scalars.csv`` also logs
within 3% of JAX's, and the greedy evaluation's crash and merge each within
0.01 of ``run_data.csv`` line 175's, or within 3 SEM of the difference,
whichever is wider.  It writes the section "Tabular Q at 30,000 episodes"
of ``--acceptance`` (the rest of the file as it is).
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

SECTION = "## Tabular Q at 30,000 episodes"
JAX_LOG = os.path.join(REPO, "runs", "tabular_q_default", "scalars.csv")
JAX_LINE = 175                # the JAX run's greedy evaluation
FIRST_POINT = 10_240          # visited_sa is held from here on ...
VISITED_TOLERANCE = 0.03      # ... within 3% of JAX's
RATE_TOLERANCE = 0.01


def logged_points(log: str) -> dict:
    """{episodes: visited_sa} of a run's printed progress lines."""
    points = re.findall(r"episodes=(\d+) visited_sa=(\d+)/", open(log).read())
    return {int(e): int(v) for e, v in points}


def jax_points(path: str = JAX_LOG) -> dict:
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    return {int(r["step"]): float(r["visited_sa"]) for r in rows}


def compare(log: str, csv_path: str, acceptance: str) -> str:
    """Write the tabular section into ``acceptance``; returns its
    verdict."""
    import paper_table_torch as pt
    port = logged_points(log)
    jax = jax_points()
    row = pt.newest_rows(pt.read_rows(csv_path))["tabular_q_default"]
    line = next(r for r in pt.read_rows(pt.JAX_CSV) if r["_line"] == JAX_LINE)
    lines = [
        SECTION, "",
        "Generated by `python scripts/train_tabular_torch.py --compare "
        f"{os.path.relpath(os.path.abspath(log), REPO)}` from that run's "
        "printed log and its row in `run_data_torch.csv` (`--episodes 30000 "
        "--batch 256 --eval-episodes 2000` on the card), against the JAX "
        "run's `runs/tabular_q_default/scalars.csv` and `run_data.csv` line "
        f"{JAX_LINE}. **The rule, written before the run:** `visited_sa` at "
        f"each point from {FIRST_POINT:,} episodes on that both log within "
        f"{VISITED_TOLERANCE:.0%} of JAX's; the greedy evaluation's crash and "
        f"merge each within {RATE_TOLERANCE} of line {JAX_LINE}'s, or within "
        "3 SEM of the difference, whichever is wider.", "",
        "| episodes | port visited_sa | JAX visited_sa | difference | "
        "holds |", "| --- " * 5 + "|"]
    held = []
    for episodes in sorted(set(port) & set(jax)):
        if episodes < FIRST_POINT:
            continue
        gap = (port[episodes] - jax[episodes]) / jax[episodes]
        held.append(abs(gap) <= VISITED_TOLERANCE)
        lines.append(f"| {episodes:,} | {port[episodes]} | "
                     f"{jax[episodes]:.0f} | {gap:+.2%} | "
                     f"{'yes' if held[-1] else 'no'} |")
    lines += ["", "| greedy evaluation | port | JAX | allowed | holds |",
              "| --- " * 5 + "|"]
    for metric in ("crashed", "merged"):
        p, j = pt._value(row, metric), pt._value(line, metric)
        sem = math.hypot(pt._value(row, metric + "_std") or 0.0,
                         pt._value(line, metric + "_std") or 0.0)
        allowed = max(RATE_TOLERANCE, 3 * sem)
        held.append(abs(p - j) <= allowed)
        lines.append(f"| {metric} over {pt._episodes(row)} episodes | "
                     f"{p:.4f} | {j:.4f} | {allowed:.4f} | "
                     f"{'yes' if held[-1] else 'no'} |")
    verdict = "agrees" if held and all(held) else "differs"
    lines += ["", f"**Verdict: the port's tabular Q at 30,000 episodes "
              f"{verdict} with the JAX package's.**", ""]
    pt.put_section(acceptance, SECTION, "\n".join(lines) + "\n")
    return verdict


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare", default=None, metavar="LOG",
                    help="hold a run's printed log and its --csv row to the "
                    "JAX run and write the section (no card)")
    ap.add_argument("--acceptance", default=os.path.join(
        REPO, "ACCEPTANCE_TORCH.md"), metavar="PATH")
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
    if args.compare:
        verdict = compare(args.compare, args.csv or os.path.join(
            REPO, "run_data_torch.csv"), args.acceptance)
        print(f"the tabular Q {verdict} with the JAX package's")
        return

    import numpy as np
    import torch

    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch._device import resolve_device
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.ops import st_kernel
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
    print(f"K1 launches {st_kernel.launches} (training and evaluation)")


if __name__ == "__main__":
    main()
