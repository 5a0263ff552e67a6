"""The port's DDPG or Rainbow selections through the JAX package's
evaluator, on the CPU: do the JAX side's evaluations score the networks
the port trained as the port's own evaluations did?

    python scripts/jax_eval_port_selections.py
        [--out scripts/jax_eval_port_selections.json]

Each committed selection ``scripts/curve_ddpg_stage<s>/seed<k>_stage<s>.npz``
(s = 1, 2; k = 0-3; ``train_curve_torch.save_selection``'s file, its actor
in the Flax layout under ``actor/Dense_<i>/<leaf>``) is loaded into the JAX
actor and evaluated as ``scripts/jax_train_curve.py`` evaluates a
selection: ``ddpg._eval_actor``'s call of ``tasks.evaluate_controller``
(kept whole for its SEMs) over ``EVAL_EPISODES`` (2048) episodes of
``configs/train_default_1.json`` at ``SEED`` k and ``BATCH_SCENARIOS``
128, at the evaluation tick; the stage-2 selections also over the final
``FINAL_EPISODES`` (1024) at the config's own tick, as
``tasks.evaluate_controller`` runs EVALUATE_DDPG.  Each evaluation keeps
crash, merge, |jerk| and time to merge with their SEMs
(``train_curve_torch.final_stats``) and the selection score
(``budget.snapshot_score``).  ``--out`` gets one record per (seed, stage),
written as each ends; a (seed, stage) already there is skipped.  Run it
from a copy of the tree (``git archive``); it writes nothing else.
``scripts/train_curve_torch.py --compare --trainer ddpg`` puts these beside
the port's own evaluations.

    python scripts/jax_eval_port_selections.py --trainer rainbow
        [--seeds 4 5 6 7] [--selections runs_torch/curve_rainbow]
        [--out scripts/jax_eval_port_rainbow.json]

``--trainer rainbow`` does the same for the port's Rainbow selections,
``<selections>/seed<k>_stage<s>.npz`` (``train_curve_torch.save_stage1``'s
file, its network under ``q_dist/NoisyDense_<i>/<leaf>``): each loaded
into the JAX Rainbow network and evaluated as ``scripts/jax_train_curve.py``
evaluates a Rainbow selection, ``rainbow._eval_greedy``'s call of
``tasks.evaluate_controller`` (kept whole) over ``RAINBOW_EPISODES`` (1024)
episodes of ``configs/train_dqn_default_1.json`` at ``SEED`` k and B=128
at the evaluation tick; the stage-2 selections also over the final 1024 at
the config's own tick, as ``rainbow.evaluate`` runs EVALUATE_DQN.
``scripts/train_curve_torch.py --compare --trainer rainbow`` puts these
beside the port's own evaluations.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from rl_mpc_lanemerging_tpu import tasks  # noqa: E402
from rl_mpc_lanemerging_tpu.agents import ddpg, rainbow  # noqa: E402
from rl_mpc_lanemerging_tpu.agents.budget import snapshot_score  # noqa: E402
from rl_mpc_lanemerging_tpu.config import Settings  # noqa: E402
# the sizes and the selection files that both sides share; the port's
# script imports no JAX
from train_curve_torch import (  # noqa: E402
    BATCH, CONFIG, EVAL_EPISODES, FINAL_EPISODES, JAX_RAINBOW_SELECTIONS,
    PORT_SELECTIONS, RAINBOW_CONFIG, RAINBOW_EPISODES, SEEDS, SNAPSHOTS,
    final_stats, load_selection)

OUT = os.path.join(REPO, "scripts", "jax_eval_port_selections.json")
RAINBOW_SEEDS = (4, 5, 6, 7)


def selection_path(seed: int, stage: int) -> str:
    return os.path.join(PORT_SELECTIONS[stage],
                        f"seed{seed}_stage{stage}.npz")


def actor_params(path: str) -> dict:
    """The actor of a selection file as the JAX actor's parameters,
    ``{"params": {"Dense_<i>": {"kernel", "bias"}}}``; raises unless its
    layers are exactly ``Dense_0`` .. ``Dense_<n-1>``."""
    import jax.numpy as jnp
    trees, _ = load_selection(path)
    params = trees["actor"]["params"]
    names = [f"Dense_{i}" for i in range(len(params))]
    if sorted(params) != sorted(names):
        raise ValueError(f"{path}: actor layers {sorted(params)}, not "
                         f"{names}")
    return {"params": {name: {leaf: jnp.asarray(value) for leaf, value in
                              params[name].items()} for name in names}}


def rainbow_params(path: str) -> dict:
    """The network of a Rainbow selection file as the JAX Rainbow
    network's parameters, ``{"params": {"NoisyDense_<i>": {...}}}``;
    raises unless its layers are exactly those of the JAX network."""
    import jax.numpy as jnp
    trees, _ = load_selection(path)
    params = trees["q_dist"]["params"]
    names = [f"NoisyDense_{i}" for i in range(3)]
    if sorted(params) != names:
        raise ValueError(f"{path}: layers {sorted(params)}, not {names}")
    return {"params": {name: {leaf: jnp.asarray(value) for leaf, value in
                              params[name].items()} for name in names}}


def evaluate_rainbow(seed: int, stage: int, selections: str = SNAPSHOTS,
                     batch: int = BATCH,
                     episodes: int = RAINBOW_EPISODES) -> dict:
    """One Rainbow selection's record: its evaluation as a selection
    evaluation (``rainbow._eval_greedy``'s call), and for stage 2 also as
    the final one (``rainbow.evaluate``'s)."""
    cfg = Settings.load_from_file(os.path.join(REPO, RAINBOW_CONFIG)).replace(
        SEED=seed, BATCH_SCENARIOS=batch)
    path = os.path.join(selections, f"seed{seed}_stage{stage}.npz")
    params = rainbow_params(path)
    t0 = time.perf_counter()
    eval_cfg = cfg.replace(TICK_LENGTH=cfg.EVALUATION_TICK_LENGTH)
    agg = tasks.evaluate_controller(
        eval_cfg, jax.jit(rainbow.greedy_controller(params, eval_cfg)),
        num_episodes=episodes,
        max_episode_length=cfg.EVALUATION_EPISODE_LENGTH, verbose=False)
    record = {"trainer": "rainbow", "seed": seed, "stage": stage,
              "config": RAINBOW_CONFIG, "batch": batch,
              "selection": os.path.basename(path),
              "eval": _with_score(final_stats(agg, episodes)),
              "eval_s": time.perf_counter() - t0}
    if stage == 2:
        t1 = time.perf_counter()
        agg = tasks.evaluate_controller(
            cfg, jax.jit(rainbow.greedy_controller(params, cfg)),
            num_episodes=episodes, verbose=False)
        record.update(final=_with_score(final_stats(agg, episodes)),
                      final_s=time.perf_counter() - t1)
    return {**record, "platform": "cpu",
            "cpu_count": len(os.sched_getaffinity(0)),
            "jax": jax.__version__}


def _with_score(stats: dict) -> dict:
    stats["score"] = list(snapshot_score(stats["crash"], stats["merge"],
                                         stats["jerk"], stats["t_merge"]))
    return stats


def evaluate(seed: int, stage: int, batch: int = BATCH,
             eval_episodes: int = EVAL_EPISODES,
             final_episodes: int = FINAL_EPISODES) -> dict:
    """One selection's record: its evaluation as a selection evaluation,
    and for stage 2 also as the final one."""
    cfg = Settings.load_from_file(os.path.join(REPO, CONFIG)).replace(
        SEED=seed, BATCH_SCENARIOS=batch)
    path = selection_path(seed, stage)
    params = actor_params(path)
    t0 = time.perf_counter()
    eval_cfg = cfg.replace(TICK_LENGTH=cfg.EVALUATION_TICK_LENGTH)
    agg = tasks.evaluate_controller(
        eval_cfg, jax.jit(ddpg.actor_controller(params, eval_cfg)),
        num_episodes=eval_episodes,
        max_episode_length=cfg.EVALUATION_EPISODE_LENGTH, verbose=False)
    record = {"seed": seed, "stage": stage, "config": CONFIG,
              "batch": batch, "selection": os.path.relpath(path, REPO),
              "eval": _with_score(final_stats(agg, eval_episodes)),
              "eval_s": time.perf_counter() - t0}
    if stage == 2:
        t1 = time.perf_counter()
        agg = tasks.evaluate_controller(
            cfg, jax.jit(ddpg.actor_controller(params, cfg)),
            num_episodes=final_episodes, verbose=False)
        record.update(final=_with_score(final_stats(agg, final_episodes)),
                      final_s=time.perf_counter() - t1)
    return {**record, "platform": "cpu", "cpu_count": os.cpu_count(),
            "jax": jax.__version__}


def read(path: str) -> dict:
    if not os.path.exists(path):
        return {"records": []}
    with open(path) as fh:
        return json.load(fh)


def add(path: str, record: dict) -> None:
    """Add ``record`` to ``path`` in place of an older one of its (seed,
    stage), through a temporary file."""
    data = read(path)
    data["records"] = [r for r in data["records"]
                       if (r["seed"], r["stage"]) !=
                       (record["seed"], record["stage"])] + [record]
    data["records"].sort(key=lambda r: (r["stage"], r["seed"]))
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(data, fh, indent=1)
    os.replace(tmp, path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trainer", choices=("ddpg", "rainbow"),
                    default="ddpg")
    ap.add_argument("--seeds", type=int, nargs="+", default=None)
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--selections", default=SNAPSHOTS, metavar="DIR",
                    help="rainbow: where the selection files are")
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    rainbow_run = args.trainer == "rainbow"
    seeds = args.seeds or list(RAINBOW_SEEDS if rainbow_run else SEEDS)
    out = args.out or (JAX_RAINBOW_SELECTIONS if rainbow_run else OUT)
    done = {(r["seed"], r["stage"]) for r in read(out)["records"]}
    for stage in args.stages:
        for seed in seeds:
            if (seed, stage) in done:
                continue
            record = evaluate_rainbow(seed, stage, args.selections) \
                if rainbow_run else evaluate(seed, stage)
            add(out, record)
            e = record["eval"]
            print(f"seed {seed} stage {stage}: crash {e['crash']:.4f} merge "
                  f"{e['merge']:.4f} |jerk| {e['jerk']:.4f} time to merge "
                  f"{e['t_merge']} score {e['score'][0]:.4f} "
                  f"({record['eval_s']:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
