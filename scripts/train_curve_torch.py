"""The port's learning curves on the card, seed by seed, and their
comparison with the JAX package's curves on the CPU: DDPG (the default)
and, with ``--trainer rainbow``, Rainbow.

    python scripts/train_curve_torch.py --run [--seeds 0 1 2 3]
        [--frames 4e5] [--out run_data_torch_train.jsonl]
    python scripts/train_curve_torch.py --compare
        [--out run_data_torch_train.jsonl]
        [--yardsticks scripts/jax_train_yardsticks.json]
        [--acceptance ACCEPTANCE_TORCH.md]

``--run`` is the counterpart of ``scripts/jax_train_curve.py`` on the card
(it raises without one).  Each seed trains ``configs/train_default_1.json``
with ``SEED`` = seed and ``BATCH_SCENARIOS`` 128, stage 1 only, at
``LEARNING_RATE``: ``ddpg.make_train_state``, then ``ddpg._train_frames``
for ``--frames`` valid frames with a 2048-episode selection evaluation
every 5 rounds (and one of the final parameters), a recorder standing in
as ``run``; then 1024 episodes of the selected snapshot through
``tasks.evaluate_controller``.  Each seed
appends one JSON line to ``--out``: the card's name and power limit, the
wall time, the seconds of each round (timed to the end of its device work),
K1's launches (training never plans: 0), ``max_memory_allocated``, the
evaluation points and the selected snapshot's statistics.  A seed with a
record in ``--out`` at this budget is skipped, so the seeds can be spread
over calls: copy ``--out`` into a directory the call brings back, run with
``--out`` there, copy it back.  The seeds left run at once, a process each,
on the one card (a learning tick leaves the device ~94% idle), each writing
its log beside ``--out``; the record says how many ran together.

``--compare`` (no card, no JAX) holds the port's seeds to the JAX seeds of
``--yardsticks``.  Over seeds, the difference of the means of each of the
selected snapshot's crash, merge and |jerk| and of the frames of the first
evaluation with crash <= 0.005 and merge >= 0.995 (the budget where none)
must lie within 3 standard errors of the difference (seed-to-seed SEMs),
and the counts of seeds that reach that point may differ by one at most.
It writes the section "DDPG learning curve" of ``--acceptance`` (the rest of
the file is left as it is) and prints the verdict.

    python scripts/train_curve_torch.py --run --trainer rainbow --stage 1|2
        [--seeds 0 1 2 3] [--frames 1e6] [--episodes 1024]
        [--snapshots runs_torch/curve_rainbow] [--out ...]
    python scripts/train_curve_torch.py --compare --trainer rainbow
        [--yardsticks scripts/jax_rainbow_yardsticks.json]

``--trainer rainbow`` runs one stage of ``rainbow.train`` on
``configs/train_dqn_default_1.json`` a call (two do not fit one chip call):
stage 1 at ``LEARNING_RATE`` from epsilon 1, stage 2 at a tenth of it at
``EPS_END`` from stage 1's selected snapshot, each to ``--frames`` valid
frames with an ``--episodes``-episode selection evaluation every 10 rounds,
the selection carried from stage 1 into stage 2 through
``<snapshots>/seed<k>_stage1.npz`` (the snapshot in ``convert``'s layout,
and its score and frames).  Stage 2 then evaluates the final selected
snapshot over ``--episodes`` episodes as EVALUATE_DQN does.  Each (seed,
stage) appends one record, with ``"trainer": "rainbow"`` and its
``"stage"``, to ``--out``; a (seed, stage) recorded at this budget is
skipped.  ``--compare --trainer rainbow`` holds the final snapshot's crash,
merge, |jerk|, time to merge and selection score, and stage 1's selection
score, to 3 standard errors of the difference, and the counts of seeds no
worse than ``rainbow_default1_extended`` to one, and writes the section
"Rainbow learning curve".
"""

from __future__ import annotations

import argparse
import csv
import fcntl
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from paper_table_torch import (ACCEPTANCE, CURVE_SECTION,  # noqa: E402
                               RAINBOW_SECTION, card_line, flagged,
                               put_section)

CONFIG = "configs/train_default_1.json"
OUT = os.path.join(REPO, "run_data_torch_train.jsonl")
YARDSTICKS = os.path.join(REPO, "scripts", "jax_train_yardsticks.json")
LOGGED = os.path.join(REPO, "runs", "ddpg_default1")
# the curve: seeds, budget (valid frames, stage 1) and evaluations
SEEDS = (0, 1, 2, 3)
FRAMES = 4e5
BATCH = 128
EVAL_EVERY = 5               # rounds between selection evaluations
EVAL_EPISODES = 2048
FINAL_EPISODES = 1024        # the selected snapshot's evaluation
# the point that decides "learned": crash <= 0.005 and merge >= 0.995
REACH_CRASH, REACH_MERGE = 0.005, 0.995
FINAL_METRICS = (("crash", "crash"), ("merge", "merge"),
                 ("jerk", "mean abs jerk"))


def _num(x) -> Optional[float]:
    """A float, or None where it is not finite (a time to merge with no
    merge), so that the JSON stays standard."""
    x = float(x)
    return x if math.isfinite(x) else None


class Recorder:
    """The ``run`` of ``_train_frames``: keeps its scalar rows."""

    def __init__(self):
        self.rows: List[dict] = []

    def log_scalars(self, step, values) -> None:
        self.rows.append({"frames": int(step),
                          **{k: _num(v) for k, v in values.items()}})

    def evals(self) -> List[dict]:
        """The selection evaluations: frames, crash, merge, |jerk|, time
        to merge."""
        return [{"frames": r["frames"], "crash": r["eval_crash"],
                 "merge": r["eval_merge"], "jerk": r["eval_jerk"],
                 "t_merge": r["eval_t_merge"]}
                for r in self.rows if "eval_crash" in r]

    def progress(self) -> List[dict]:
        return [{"frames": r["frames"], "episodes": r["episodes"],
                 "avg_return": r["avg_return"]}
                for r in self.rows if "avg_return" in r]


def timed_rounds(module, sync, name: str = "train_round",
                 frames: Optional[List[int]] = None):
    """Wrap ``module.<name>`` (``train_round`` by default) so that each call
    is timed to the end of its work (``sync`` waits for it), and, where
    ``frames`` is a list, the state's frames after each call go to it;
    returns the list the seconds go to and the function that puts the real
    one back."""
    real = getattr(module, name)
    seconds: List[float] = []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = sync(real(*a, **kw))
        seconds.append(time.perf_counter() - t0)
        if frames is not None:
            frames.append(int(out.frames))
        return out

    setattr(module, name, timed)

    def restore():
        setattr(module, name, real)
    return seconds, restore


def final_stats(agg, episodes: int) -> dict:
    """Crash, merge, |jerk| and time to merge, each with its SEM."""
    avg, sem = agg.get_stat_averages(report_stds=True)
    out = {"episodes": episodes}
    for key, name in (("crashed", "crash"), ("merged", "merge"),
                      ("mean_abs_jerk", "jerk"),
                      ("time_to_merge", "t_merge")):
        out[name], out[name + "_sem"] = _num(avg[key]), _num(sem[key])
    return out


def curve_record(seed: int, batch: int, frames_budget: float, state,
                 seconds: List[float], run: Recorder, best: dict,
                 final: dict, eval_every: int, eval_episodes: int) -> dict:
    """The fields both sides record for a seed."""
    return {
        "seed": seed, "config": CONFIG, "batch": batch,
        "frames_budget": frames_budget, "frames": int(state.frames),
        "episodes": int(state.episodes), "rounds": len(seconds),
        "s_per_round": seconds,
        # the first round compiles (JAX) or warms the caches (the card)
        "s_per_round_median": statistics.median(seconds[1:] or seconds),
        "eval_every_rounds": eval_every, "eval_episodes": eval_episodes,
        "evals": run.evals(), "progress": run.progress(),
        "selected": {"frames": best["frames"],
                     "score": [_num(x) for x in best["score"]]},
        "final": final,
    }


def seed_config(seed: int, batch: int, overrides=None, config=CONFIG):
    from rl_mpc_lanemerging_torch.config import Settings
    return Settings.load_from_file(os.path.join(REPO, config)).replace(
        SEED=seed, BATCH_SCENARIOS=batch, **(overrides or {}))


def run_seed(seed: int, frames: float, batch: int = BATCH,
             eval_every: int = EVAL_EVERY, eval_episodes: int = EVAL_EPISODES,
             final_episodes: int = FINAL_EPISODES, device="cuda",
             overrides=None) -> dict:
    """Train one seed to ``frames`` on ``device`` and evaluate its selected
    snapshot; returns its record (without the card's fields)."""
    import torch
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch._device import (pin_fp32_matmul,
                                                  resolve_device)
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.ops import st_kernel
    dev = resolve_device(device)
    pin_fp32_matmul()
    cfg = seed_config(seed, batch, overrides)
    st_kernel.launches = 0
    t0 = time.perf_counter()
    worlds, world_rng = tasks.make_worlds(cfg, device=dev)
    state = ddpg.make_train_state(cfg, worlds, world_rng, tasks.seed_of(cfg),
                                  lr=cfg.LEARNING_RATE)
    run, best = Recorder(), {}

    def sync(out):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    seconds, restore = timed_rounds(ddpg, sync)
    try:
        state = ddpg._train_frames(cfg, state, frames, cfg.LEARNING_RATE,
                                   verbose=True, run=run,
                                   eval_every_rounds=eval_every,
                                   eval_episodes=eval_episodes, best=best)
    finally:
        restore()
    train_s = time.perf_counter() - t0
    actor = ddpg._actor_from(cfg, best["params"][0], dev)
    agg = tasks.evaluate_controller(cfg, ddpg.actor_controller(actor, cfg),
                                    num_episodes=final_episodes, device=dev,
                                    verbose=False)
    return {**curve_record(seed, batch, frames, state, seconds, run, best,
                           final_stats(agg, final_episodes), eval_every,
                           eval_episodes),
            "train_s": train_s, "wall_s": time.perf_counter() - t0,
            "k1_launches": st_kernel.launches, "torch": torch.__version__}


def _lines(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def read_records(path: str) -> Dict[int, dict]:
    """The newest DDPG record of each seed in a JSONL file (a Rainbow
    record carries ``"trainer": "rainbow"``)."""
    return {int(r["seed"]): r for r in _lines(path)
            if r.get("trainer", "ddpg") == "ddpg"}


def pending(seeds: List[int], path: str, frames: float) -> List[int]:
    """The seeds without a record in ``path`` at a budget of ``frames``."""
    done = read_records(path)
    return [s for s in seeds
            if s not in done or done[s]["frames_budget"] < frames]


def append_record(path: str, record: dict) -> None:
    """One line, under a lock: several seeds may end at once."""
    with open(path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        fh.write(json.dumps(record) + "\n")
        fh.flush()
        fcntl.flock(fh, fcntl.LOCK_UN)


def run_one(seed: int, frames: float, out: str, concurrent: int,
            rainbow_args: Optional[dict] = None) -> dict:
    """One seed on the card (one Rainbow stage where ``rainbow_args``
    holds ``run_rainbow_stage``'s stage, episodes and snapshots),
    ``concurrent`` seeds sharing it; appends and returns its record."""
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // concurrent))
    torch.cuda.reset_peak_memory_stats()
    record = run_seed(seed, frames) if rainbow_args is None \
        else run_rainbow_stage(seed, frames, **rainbow_args)
    record.update(card=card_line(), device=torch.cuda.get_device_name(0),
                  concurrent_seeds=concurrent,
                  max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    append_record(out, record)
    stage = f" stage {record['stage']}" if "stage" in record else ""
    line = (f"seed {seed}{stage}: {record['card']}; {record['frames']} "
            f"frames in {record['rounds']} rounds, "
            f"{record['s_per_round_median']:.2f} s per round ({concurrent} "
            f"seeds at once); selected @ {record['selected']['frames']}")
    f = record.get("final")
    if f:
        line += (f": crash {f['crash']:.4f} merge {f['merge']:.4f} |jerk| "
                 f"{f['jerk']:.4f} over {f['episodes']} episodes")
    print(f"{line}; K1 launches {record['k1_launches']}", flush=True)
    if record["k1_launches"]:
        raise RuntimeError(f"seed {seed}: K1 launched "
                           f"{record['k1_launches']} times in training")
    return record


def spawn(seeds: List[int], frames: float, out: str,
          extra: Optional[List[str]] = None, log: str = "train_curve") -> None:
    """Every seed at once, each in a process of its own (``extra``: more
    arguments) that logs to ``<log>_seed<seed>.log`` beside ``out``."""
    out_dir = os.path.dirname(os.path.abspath(out))
    procs = []
    try:
        for seed in seeds:
            fh = open(os.path.join(out_dir, f"{log}_seed{seed}.log"), "w")
            procs.append((seed, fh, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--run",
                 "--seeds", str(seed), "--frames", str(frames), "--out", out,
                 "--concurrent", str(len(seeds))] + (extra or []),
                stdout=fh, stderr=subprocess.STDOUT, cwd=REPO)))
        failed = [seed for seed, _, proc in procs if proc.wait()]
    finally:
        for _, fh, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()
    if failed:
        raise RuntimeError(f"seeds {failed} failed; see their logs in "
                           f"{out_dir}")


def run(seeds: List[int], frames: float, out: str, concurrent: int,
        rainbow_args: Optional[dict] = None) -> None:
    """The seeds without a record in ``out``: one in this process, several
    at once in processes of their own (``concurrent`` is set in those)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("--run trains on the card: "
                           "torch.cuda.is_available() is False")
    if rainbow_args is None:
        todo, extra, log = pending(seeds, out, frames), [], "train_curve"
    else:
        stage = rainbow_args["stage"]
        todo = pending_stage(seeds, out, frames, stage)
        if stage == 2:          # refuse before any seed starts
            for seed in todo:
                snapshot_path(rainbow_args["snapshots"], seed, check=True)
        extra = ["--trainer", "rainbow", "--stage", str(stage), "--episodes",
                 str(rainbow_args["episodes"]), "--snapshots",
                 rainbow_args["snapshots"]]
        log = f"train_curve_rainbow_stage{stage}"
    print(f"{card_line()}; {len(seeds) - len(todo)} of {len(seeds)} seeds "
          f"already in {out}", flush=True)
    if len(todo) > 1:
        spawn(todo, frames, out, extra, log)
    elif todo:
        run_one(todo[0], frames, out, concurrent, rainbow_args)


# --- Rainbow: TRAIN_DQN's two stages, each in a chip call of its own -------

RAINBOW_CONFIG = "configs/train_dqn_default_1.json"
RAINBOW_YARDSTICKS = os.path.join(REPO, "scripts",
                                  "jax_rainbow_yardsticks.json")
RAINBOW_LOGGED = (os.path.join(REPO, "runs", "rainbow_default1"),
                  os.path.join(REPO, "runs", "rainbow_default1_extended"))
SNAPSHOTS = os.path.join(REPO, "runs_torch", "curve_rainbow")
RAINBOW_FRAMES = 1e6          # valid frames per stage, as rainbow.train
RAINBOW_EVAL_EVERY = 10       # rounds between selection evaluations
RAINBOW_EPISODES = 1024       # each selection evaluation, and the final one
# the network of the paper's DQN row: its LOG_DIR in the port's table
# (run_data_torch.csv, EVALUATE_DQN of runs/rainbow_default1_extended)
REFERENCE_LOG_DIR = "rainbow_default1"


def stage_schedule(cfg, stage: int, eps_end: float):
    """(lr, eps_start) of a stage of ``rainbow.train``: stage 1 at
    ``LEARNING_RATE`` from epsilon 1, stage 2 at a tenth of it from
    ``EPS_END``."""
    if stage == 1:
        return cfg.LEARNING_RATE, 1.0
    return cfg.LEARNING_RATE / 10.0, eps_end


def rainbow_record(seed: int, stage: int, batch: int, frames_budget: float,
                   state, lr: float, eps_start: float, seconds: List[float],
                   frames_after: List[int], eval_seconds: List[float],
                   run: Recorder, best: dict, selected_stage: int,
                   eval_every: int, eval_episodes: int) -> dict:
    """The fields both sides record for a (seed, stage)."""
    return {
        "trainer": "rainbow", "stage": stage, "seed": seed,
        "config": RAINBOW_CONFIG, "batch": batch,
        "frames_budget": frames_budget, "frames": int(state.frames),
        "episodes": int(state.episodes), "lr": lr, "eps_start": eps_start,
        "rounds": len(seconds), "s_per_round": seconds,
        # the first round compiles (JAX) or warms the caches (the card)
        "s_per_round_median": statistics.median(seconds[1:] or seconds),
        "frames_per_round": [b - a for a, b in zip([0] + frames_after,
                                                   frames_after)],
        "eval_every_rounds": eval_every, "eval_episodes": eval_episodes,
        "s_per_eval": eval_seconds,
        "evals": run.evals(), "progress": run.progress(),
        "selected": {"stage": selected_stage, "frames": best.get("frames"),
                     "score": None if best.get("score") is None
                     else [_num(x) for x in best["score"]]},
    }


def snapshot_path(snapshots: str, seed: int, check: bool = False) -> str:
    """``<snapshots>/seed<seed>_stage1.npz``; with ``check``, raises where
    it is missing."""
    path = os.path.join(snapshots, f"seed{seed}_stage1.npz")
    if check and not os.path.exists(path):
        raise FileNotFoundError(
            f"stage 2 of seed {seed} starts from stage 1's selected "
            f"snapshot, and {path} is missing: run --stage 1 first, or copy "
            "its snapshots there")
    return path


def save_stage1(path: str, state_dict: dict, best: dict) -> None:
    """Stage 1's selected ``state_dict`` under ``q_dist/<layer>/<leaf>``
    (the Flax layout of ``convert.tree_from_state_dict``), with the
    selection's score and frames under ``best/``."""
    import numpy as np
    from rl_mpc_lanemerging_torch import convert
    tree = convert.tree_from_state_dict(state_dict)["params"]
    arrays = {f"q_dist/{layer}/{leaf}": value
              for layer, leaves in tree.items()
              for leaf, value in leaves.items()}
    if best.get("score") is not None:
        arrays["best/score"] = np.asarray(best["score"], dtype=np.float64)
        arrays["best/frames"] = np.asarray(best["frames"], dtype=np.int64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_stage1(path: str):
    """(``state_dict``, ``best``) of ``save_stage1``'s file: the selected
    snapshot through ``convert.rainbow_from_numpy``, and the selection
    that stage 2 carries on, whose ``params`` is that snapshot."""
    import numpy as np
    from rl_mpc_lanemerging_torch import convert
    params: Dict[str, dict] = {}
    best: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key.startswith("q_dist/"):
                _, layer, leaf = key.split("/")
                params.setdefault(layer, {})[leaf] = data[key]
        if "best/score" in data.files:
            best = {"score": tuple(float(x) for x in data["best/score"]),
                    "frames": int(data["best/frames"])}
    init = convert.rainbow_from_numpy({"params": params})
    if best:
        best["params"] = init
    return init, best


def run_rainbow_stage(seed: int, frames: float, stage: int = 1,
                      batch: int = BATCH,
                      eval_every: int = RAINBOW_EVAL_EVERY,
                      episodes: int = RAINBOW_EPISODES,
                      snapshots: str = SNAPSHOTS, device="cuda",
                      overrides=None) -> dict:
    """One stage of ``rainbow.train`` for one seed on ``device``, to
    ``frames`` valid frames with an ``episodes``-episode selection
    evaluation every ``eval_every`` rounds.  Stage 1 saves its selected
    snapshot and selection to ``snapshot_path(snapshots, seed)``; stage 2
    starts from there (it raises where the file is missing) and evaluates
    the final selected snapshot over ``episodes`` episodes as
    ``rainbow.evaluate`` does.  Returns the record (without the card's
    fields)."""
    import torch
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch._device import (pin_fp32_matmul,
                                                  resolve_device)
    from rl_mpc_lanemerging_torch.agents import rainbow
    from rl_mpc_lanemerging_torch.agents.ddpg import derive_seed
    from rl_mpc_lanemerging_torch.ops import st_kernel
    dev = resolve_device(device)
    pin_fp32_matmul()
    cfg = seed_config(seed, batch, overrides, RAINBOW_CONFIG)
    lr, eps_start = stage_schedule(cfg, stage, rainbow.EPS_END)
    path = snapshot_path(snapshots, seed, check=stage == 2)
    init, best = load_stage1(path) if stage == 2 else (None, {})
    if stage == 2:
        cfg = cfg.replace(LOG_DIR=cfg.LOG_DIR + "_extended")
    st_kernel.launches = 0
    t0 = time.perf_counter()
    worlds, world_rng = tasks.make_worlds(cfg, device=dev)
    seed0 = tasks.seed_of(cfg)
    state = rainbow.make_train_state(
        cfg, worlds, world_rng, seed0 if stage == 1 else derive_seed(seed0),
        lr=lr, init_params=init)
    run = Recorder()

    def sync(out):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    frames_after: List[int] = []
    seconds, restore = timed_rounds(rainbow, sync, frames=frames_after)
    eval_seconds, restore_eval = timed_rounds(rainbow, sync, "_eval_greedy")
    try:
        state = rainbow._train_frames(
            cfg, state, frames, lr, verbose=True, run=run,
            eps_start=eps_start, eval_every_rounds=eval_every,
            eval_episodes=episodes, best=best)
    finally:
        restore()
        restore_eval()
    train_s = time.perf_counter() - t0
    selected = best.get("params") or rainbow._snapshot(state.net)
    record = rainbow_record(
        seed, stage, batch, frames, state, lr, eps_start, seconds,
        frames_after, eval_seconds, run, best,
        1 if stage == 1 or selected is init else 2, eval_every, episodes)
    if stage == 1:
        save_stage1(path, selected, best)
    else:
        t1 = time.perf_counter()
        net = rainbow._net_from(cfg, selected, dev)
        agg = tasks.evaluate_controller(cfg, rainbow.greedy_controller(
            net, cfg), num_episodes=episodes, device=dev, verbose=False)
        record.update(final=final_stats(agg, episodes),
                      final_s=time.perf_counter() - t1)
    return {**record, "train_s": train_s,
            "wall_s": time.perf_counter() - t0,
            "k1_launches": st_kernel.launches, "torch": torch.__version__}


def read_stages(records: List[dict]) -> Dict[tuple, dict]:
    """The newest Rainbow record of each (seed, stage)."""
    return {(int(r["seed"]), int(r["stage"])): r for r in records
            if r.get("trainer") == "rainbow"}


def pending_stage(seeds: List[int], path: str, frames: float,
                  stage: int) -> List[int]:
    """The seeds without a Rainbow record of ``stage`` in ``path`` at a
    budget of ``frames``."""
    done = read_stages(_lines(path))
    return [s for s in seeds if (s, stage) not in done
            or done[(s, stage)]["frames_budget"] < frames]


# --- the comparison --------------------------------------------------------

def first_reach(evals: List[dict], budget: float) -> float:
    """The frames of the first evaluation with crash <= 0.005 and merge >=
    0.995, or the budget where there is none."""
    return next((float(e["frames"]) for e in evals if _learned(e)),
                float(budget))


def _learned(evaluation: dict) -> bool:
    return evaluation["crash"] <= REACH_CRASH \
        and evaluation["merge"] >= REACH_MERGE


def _mean_sem(values: List[float]):
    mean = statistics.fmean(values)
    sem = statistics.stdev(values) / math.sqrt(len(values)) \
        if len(values) > 1 else 0.0
    return mean, sem


def summarize(records: Dict[int, dict]) -> dict:
    """Per quantity of the rule, (mean, SEM) over the seeds; and how many
    seeds reached the point."""
    out = {name: _mean_sem([r["final"][name] for r in records.values()])
           for name, _ in FINAL_METRICS}
    out["reach_frames"] = _mean_sem([first_reach(r["evals"],
                                                 r["frames_budget"])
                                     for r in records.values()])
    out["reached"] = sum(map(_reached, records.values()))
    out["n"] = len(records)
    return out


def _reached(record: dict) -> bool:
    return any(_learned(e) for e in record["evals"])


def decide(port: dict, jax: dict):
    """The rule's rows (quantity, port, JAX, |difference|, 3 SEM of it,
    holds) and its verdict."""
    rows = []
    for name, label in FINAL_METRICS + (("reach_frames",
                                         "frames to crash <= 0.005 and "
                                         "merge >= 0.995"),):
        (pm, ps), (jm, js) = port[name], jax[name]
        rows.append((label, port[name], jax[name], abs(pm - jm),
                     3.0 * math.sqrt(ps ** 2 + js ** 2),
                     not flagged(pm, ps, jm, js)))
    counts_hold = abs(port["reached"] - jax["reached"]) <= 1
    agrees = all(r[-1] for r in rows) and counts_hold
    return rows, counts_hold, "agrees" if agrees else "differs"


def logged_runs(folder: str = LOGGED) -> Dict[str, List[dict]]:
    """The JAX package's own selection evaluations, logged on the TPU in
    ``runs/ddpg_default1``: ``scalars.1.csv`` holds two runs (A, then B,
    where the frames start again), ``scalars.csv`` a third (C;
    ``scalars.2.csv`` is C without the time to merge).  Under the progress
    header (step, avg_return, episodes, lr) an evaluation row is (step,
    crash, |jerk|, merge[, time to merge]); a progress row has the learning
    rate, 0.0002, as its fourth value."""
    runs: Dict[str, List[dict]] = {}
    for fname, names in (("scalars.1.csv", "AB"), ("scalars.csv", "C")):
        with open(os.path.join(folder, fname), newline="") as fh:
            rows = list(csv.reader(fh))[1:]
        block, last = 0, -1
        for row in rows:
            step = int(row[0])
            if step < last:
                block += 1
            last = step
            if row[3] == "0.0002":
                continue
            runs.setdefault(names[block], []).append({
                "frames": step, "crash": float(row[1]),
                "jerk": float(row[2]), "merge": float(row[3])})
    return runs


def _pm(mean_sem, digits=4) -> str:
    m, s = mean_sem
    return f"{m:.{digits}f} ± {s:.{digits}f}"


def _stat(final: dict, name: str) -> str:
    v, s = final.get(name), final.get(name + "_sem")
    if v is None:
        return "-"
    return f"{v:.4f} ± {s:.4f}" if s is not None else f"{v:.4f}"


def section(port: Dict[int, dict], jax: Dict[int, dict], budget: float
            ) -> str:
    """The "DDPG learning curve" section of the acceptance file."""
    ps, js = summarize(port), summarize(jax)
    rows, counts_hold, verdict = decide(ps, js)
    any_rec = next(iter(port.values()))
    lines = [
        CURVE_SECTION, "",
        "Generated by `python scripts/train_curve_torch.py --compare` from "
        "`run_data_torch_train.jsonl` (the port on the card, "
        "`train_curve_torch.py --run`) and `scripts/jax_train_yardsticks."
        "json` (the JAX package on the CPU, `scripts/jax_train_curve.py`). "
        f"Both train `{CONFIG}` (stage 1, `LEARNING_RATE`) at B="
        f"{any_rec['batch']} to {budget:.0f} valid frames per seed, with a "
        f"{any_rec['eval_episodes']}-episode selection evaluation every "
        f"{any_rec['eval_every_rounds']} rounds and of the final "
        "parameters, then evaluate the selected snapshot over "
        f"{any_rec['final']['episodes']} episodes. Seeds: port "
        f"{sorted(port)}, JAX {sorted(jax)}.", "",
        "### Selection evaluations", "",
        "| side | seed | frames | crash | merge | mean abs jerk | time to "
        "merge (s) |", "| --- " * 7 + "|"]
    for side, recs in (("port (card)", port), ("JAX (CPU)", jax)):
        for seed in sorted(recs):
            for e in recs[seed]["evals"]:
                t = "-" if e["t_merge"] is None else f"{e['t_merge']:.2f}"
                lines.append(f"| {side} | {seed} | {e['frames']} | "
                             f"{e['crash']:.4f} | {e['merge']:.4f} | "
                             f"{e['jerk']:.4f} | {t} |")
    lines += ["", "### Selected snapshots", "",
              "| side | seed | selected at (frames) | crash | merge | mean "
              "abs jerk | time to merge (s) | first at crash <= 0.005, "
              "merge >= 0.995 (frames) | s per round (median) | where |",
              "| --- " * 10 + "|"]
    for side, recs in (("port", port), ("JAX", jax)):
        for seed in sorted(recs):
            r = recs[seed]
            f = r["final"]
            where = r.get("card") or f"CPU, {r.get('cpu_count')} cores"
            if r.get("concurrent_seeds", 1) > 1:
                where += f", {r['concurrent_seeds']} seeds at once"
            reach = f"{first_reach(r['evals'], r['frames_budget']):.0f}" \
                if _reached(r) else "never"
            lines.append(
                f"| {side} | {seed} | {r['selected']['frames']} | "
                + " | ".join(_stat(f, n) for n in
                             ("crash", "merge", "jerk", "t_merge"))
                + f" | {reach} | {r['s_per_round_median']:.2f} | {where} |")
    lines += ["", "### Decision rule", "",
              "Over seeds, |mean_port - mean_JAX| must not exceed 3 "
              "sqrt(SEM_port^2 + SEM_JAX^2) (seed-to-seed SEMs) for each "
              "quantity; frames count the budget where a seed never reaches "
              "the point; and the counts of seeds that reach it may differ "
              "by one at most.", "",
              "| quantity | port mean ± SEM | JAX mean ± SEM | difference | "
              "3 SEM of the difference | holds |", "| --- " * 6 + "|"]
    for label, p, j, diff, bar, holds in rows:
        digits = 0 if label.startswith("frames") else 4
        lines.append(f"| {label} | {_pm(p, digits)} | {_pm(j, digits)} | "
                     f"{diff:.{digits}f} | {bar:.{digits}f} | "
                     f"{'yes' if holds else 'no'} |")
    lines += [f"| seeds that reach crash <= 0.005, merge >= 0.995 | "
              f"{ps['reached']} of {ps['n']} | {js['reached']} of {js['n']} "
              f"| {abs(ps['reached'] - js['reached'])} | at most 1 | "
              f"{'yes' if counts_hold else 'no'} |", "",
              f"**Verdict: the port's curve {verdict} with the JAX "
              "package's.**", "",
              "### The JAX package's logged runs on the TPU (context)", "",
              "Selection evaluations of 2048 episodes that the JAX package "
              "logged on the TPU in `runs/ddpg_default1/scalars*.csv` "
              "(stage 1, lr 2e-4, B=128). They predate today's code and are "
              "not the yardstick; the JAX rows above are.", "",
              "| run | evaluations up to 4.5e5 frames: crash / merge @ "
              "frames |", "| --- | --- |"]
    for name, evals in logged_runs().items():
        lines.append(f"| {name} | " + "; ".join(
            f"{e['crash']:.3f} / {e['merge']:.3f} @ {e['frames']:,}"
            for e in evals if e["frames"] <= 450_000) + " |")
    return "\n".join(lines) + "\n"


def compare(out: str, yardsticks: str, acceptance: str) -> str:
    """Write the section into ``acceptance``; returns the verdict."""
    port = read_records(out)
    with open(yardsticks) as fh:
        jax = {int(k): v for k, v in json.load(fh)["seeds"].items()}
    if not port or not jax:
        raise SystemExit(f"no records: port {sorted(port)}, JAX "
                         f"{sorted(jax)}")
    budget = next(iter(port.values()))["frames_budget"]
    text = section(port, jax, budget)
    put_section(acceptance, CURVE_SECTION, text)
    return text.split("**Verdict: the port's curve ")[1].split(" ")[0]


# --- the Rainbow comparison ------------------------------------------------

# the quantities of the rule: the final selected snapshot's evaluation,
# its selection score, and stage 1's selection score
RAINBOW_METRICS = (("crash", "crash"), ("merge", "merge"),
                   ("jerk", "mean abs jerk"),
                   ("t_merge", "time to merge (s)"),
                   ("score", "selection score of the final snapshot"),
                   ("stage1_score", "stage 1's selection score"))


def _score(final: dict) -> float:
    """``snapshot_score``'s weighted term of an evaluation's statistics."""
    from rl_mpc_lanemerging_torch.agents.budget import snapshot_score
    t = final["t_merge"]
    return snapshot_score(final["crash"], final["merge"], final["jerk"],
                          math.nan if t is None else t)[0]


def reference_score() -> float:
    """The score of the paper's DQN network, ``rainbow_default1_extended``,
    under the final evaluation: the newest row of its LOG_DIR in the
    port's table (``run_data_torch.csv``)."""
    from paper_table_torch import PORT_CSV, newest_rows, read_rows
    row = newest_rows(read_rows(PORT_CSV))[REFERENCE_LOG_DIR]
    return _score({"crash": float(row["crashed"]),
                   "merge": float(row["merged"]),
                   "jerk": float(row["mean_abs_jerk"]),
                   "t_merge": float(row["time_to_merge"])})


def seeds_of(stages: Dict[tuple, dict]) -> Dict[int, tuple]:
    """(stage 1, stage 2) of each seed that has both."""
    return {seed: (stages[(seed, 1)], stages[(seed, 2)])
            for seed, stage in sorted(stages) if stage == 2
            and (seed, 1) in stages}


def quantities(stage1: dict, stage2: dict) -> dict:
    """The rule's quantities of one seed."""
    final = stage2["final"]
    return {"crash": final["crash"], "merge": final["merge"],
            "jerk": final["jerk"], "t_merge": final["t_merge"],
            "score": stage2["selected"]["score"][0],
            "stage1_score": stage1["selected"]["score"][0],
            "final_score": _score(final)}


def summarize_rainbow(seeds: Dict[int, tuple], reference: float) -> dict:
    """Per quantity of the rule, (mean, SEM) over the seeds (a time to
    merge counts where the seed merged at all); and how many seeds' final
    snapshot scores no worse than ``reference``."""
    qs = [quantities(*pair) for pair in seeds.values()]
    out = {name: _mean_sem([q[name] for q in qs if q[name] is not None])
           for name, _ in RAINBOW_METRICS}
    out["no_worse"] = sum(q["final_score"] <= reference for q in qs)
    out["n"] = len(qs)
    return out


def decide_rainbow(port: dict, jax: dict):
    """The rule's rows (quantity, port, JAX, |difference|, 3 SEM of it,
    holds) and its verdict."""
    rows = []
    for name, label in RAINBOW_METRICS:
        (pm, ps), (jm, js) = port[name], jax[name]
        rows.append((label, port[name], jax[name], abs(pm - jm),
                     3.0 * math.sqrt(ps ** 2 + js ** 2),
                     not flagged(pm, ps, jm, js)))
    counts_hold = abs(port["no_worse"] - jax["no_worse"]) <= 1
    agrees = all(r[-1] for r in rows) and counts_hold
    return rows, counts_hold, "agrees" if agrees else "differs"


def logged_rainbow(folders=RAINBOW_LOGGED) -> Dict[str, List[dict]]:
    """The JAX package's selection evaluations of ``rainbow.train``,
    logged on the TPU: stage 1 in ``runs/rainbow_default1/scalars.csv``,
    stage 2 in ``runs/rainbow_default1_extended/scalars.csv``.  Under the
    progress header (step, episodes, lr) an evaluation row is (step,
    crash, |jerk|, merge, time to merge)."""
    out: Dict[str, List[dict]] = {}
    for name, folder in zip(("stage 1", "stage 2"), folders):
        with open(os.path.join(folder, "scalars.csv"), newline="") as fh:
            out[name] = [{"frames": int(row[0]), "crash": float(row[1]),
                          "jerk": float(row[2]), "merge": float(row[3]),
                          "t_merge": _num(row[4])}
                         for row in list(csv.reader(fh))[1:]
                         if len(row) == 5]
    return out


def _where(r: dict) -> str:
    where = r.get("card") or f"CPU, {r.get('cpu_count')} cores"
    if r.get("concurrent_seeds", 1) > 1:
        where += f", {r['concurrent_seeds']} seeds at once"
    return where


def section_rainbow(port: Dict[int, tuple], jax: Dict[int, tuple],
                    reference: float) -> str:
    """The "Rainbow learning curve" section of the acceptance file."""
    ps, js = summarize_rainbow(port, reference), summarize_rainbow(
        jax, reference)
    rows, counts_hold, verdict = decide_rainbow(ps, js)
    s1, s2 = next(iter(port.values()))
    lines = [
        RAINBOW_SECTION, "",
        "Generated by `python scripts/train_curve_torch.py --compare "
        "--trainer rainbow` from `run_data_torch_train.jsonl` (the port on "
        "the card, `train_curve_torch.py --run --trainer rainbow --stage 1`, "
        "then `--stage 2` in another call) and "
        "`scripts/jax_rainbow_yardsticks.json` (the JAX package on the CPU, "
        "`scripts/jax_train_curve.py --trainer rainbow`). Both run the two "
        f"stages of `rainbow.train` on `{RAINBOW_CONFIG}` at B={s1['batch']}"
        f": stage 1 at lr {s1['lr']:g} from epsilon {s1['eps_start']:g}, "
        f"stage 2 at lr {s2['lr']:g} from stage 1's selected snapshot at "
        f"epsilon {s2['eps_start']:g}, each to {s1['frames_budget']:.0f} "
        f"valid frames with a {s1['eval_episodes']}-episode selection "
        f"evaluation every {s1['eval_every_rounds']} rounds (and of the "
        "final parameters), the selection carried into stage 2; then the "
        "final selected snapshot is evaluated over "
        f"{s2['final']['episodes']} episodes as EVALUATE_DQN does. Seeds: "
        f"port {sorted(port)}, JAX {sorted(jax)}.", "",
        "### Selection evaluations", "",
        "| side | seed | stage | frames | crash | merge | mean abs jerk | "
        "time to merge (s) |", "| --- " * 8 + "|"]
    for side, recs in (("port (card)", port), ("JAX (CPU)", jax)):
        for seed in sorted(recs):
            for r in recs[seed]:
                for e in r["evals"]:
                    t = "-" if e["t_merge"] is None else f"{e['t_merge']:.2f}"
                    lines.append(
                        f"| {side} | {seed} | {r['stage']} | {e['frames']} "
                        f"| {e['crash']:.4f} | {e['merge']:.4f} | "
                        f"{e['jerk']:.4f} | {t} |")
    lines += ["", "### Selected snapshots", "",
              "| side | seed | stage 1 selected at (frames), score | final "
              "selected (stage, frames), score | crash | merge | mean abs "
              "jerk | time to merge (s) | score of this evaluation | s per "
              "round (median, stage 1 / 2) | s per selection evaluation "
              "(median) | where |", "| --- " * 12 + "|"]
    for side, recs in (("port", port), ("JAX", jax)):
        for seed in sorted(recs):
            r1, r2 = recs[seed]
            f = r2["final"]
            sel1, sel2 = r1["selected"], r2["selected"]
            evals = [x for r in (r1, r2) for x in r["s_per_eval"]]
            lines.append(
                f"| {side} | {seed} | {sel1['frames']}, "
                f"{sel1['score'][0]:.4f} | {sel2['stage']}, "
                f"{sel2['frames']}, {sel2['score'][0]:.4f} | "
                + " | ".join(_stat(f, n) for n in
                             ("crash", "merge", "jerk", "t_merge"))
                + f" | {_score(f):.4f} | {r1['s_per_round_median']:.2f} / "
                f"{r2['s_per_round_median']:.2f} | "
                f"{statistics.median(evals):.2f} | {_where(r2)} |")
    lines += ["", "### Decision rule", "",
              "Over seeds, |mean_port - mean_JAX| must not exceed 3 "
              "sqrt(SEM_port^2 + SEM_JAX^2) (seed-to-seed SEMs) for each "
              "quantity; the score is `agents/budget.py`'s `snapshot_score` "
              "(lower is better); and the counts of seeds whose final "
              "snapshot scores no worse than `rainbow_default1_extended` "
              f"under the same evaluation ({reference:.4f}: the port's row "
              f"of LOG_DIR `{REFERENCE_LOG_DIR}` in `run_data_torch.csv`) may "
              "differ by one at most.", "",
              "| quantity | port mean ± SEM | JAX mean ± SEM | difference | "
              "3 SEM of the difference | holds |", "| --- " * 6 + "|"]
    for label, p, j, diff, bar, holds in rows:
        lines.append(f"| {label} | {_pm(p)} | {_pm(j)} | {diff:.4f} | "
                     f"{bar:.4f} | {'yes' if holds else 'no'} |")
    lines += [f"| seeds no worse than rainbow_default1_extended | "
              f"{ps['no_worse']} of {ps['n']} | {js['no_worse']} of "
              f"{js['n']} | {abs(ps['no_worse'] - js['no_worse'])} | at most "
              f"1 | {'yes' if counts_hold else 'no'} |", "",
              f"**Verdict: the port's Rainbow curve {verdict} with the JAX "
              "package's.**", "",
              "### The JAX package's logged run on the TPU (context)", "",
              "Selection evaluations of 1024 episodes that the JAX package "
              "logged on the TPU in `runs/rainbow_default1/scalars.csv` "
              "(stage 1) and `runs/rainbow_default1_extended/scalars.csv` "
              "(stage 2), B=128. They predate today's code and are not the "
              "yardstick; the JAX rows above are.", "",
              "| stage | crash / merge @ frames |", "| --- | --- |"]
    for name, evals in logged_rainbow().items():
        lines.append(f"| {name} | " + "; ".join(
            f"{e['crash']:.3f} / {e['merge']:.3f} @ {e['frames']:,}"
            for e in evals) + " |")
    return "\n".join(lines) + "\n"


def compare_rainbow(out: str, yardsticks: str, acceptance: str) -> str:
    """Write the Rainbow section into ``acceptance``; returns the
    verdict."""
    port = seeds_of(read_stages(_lines(out)))
    with open(yardsticks) as fh:
        jax = seeds_of(read_stages(json.load(fh)["records"]))
    if not port or not jax:
        raise SystemExit(f"no seed with both stages: port {sorted(port)}, "
                         f"JAX {sorted(jax)}")
    text = section_rainbow(port, jax, reference_score())
    put_section(acceptance, RAINBOW_SECTION, text)
    return text.split("**Verdict: the port's Rainbow curve ")[1].split()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--run", action="store_true",
                      help="train the seeds on the card")
    mode.add_argument("--compare", action="store_true",
                      help="apply the decision rule and write its section")
    ap.add_argument("--trainer", choices=("ddpg", "rainbow"), default="ddpg")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--frames", type=float, default=None,
                    help="valid frames (per stage): 4e5 (ddpg), 1e6 "
                    "(rainbow)")
    ap.add_argument("--stage", type=int, choices=(1, 2), default=1,
                    help="rainbow: the stage to run")
    ap.add_argument("--episodes", type=int, default=RAINBOW_EPISODES,
                    help="rainbow: episodes of each selection evaluation "
                    "and of the final one")
    ap.add_argument("--snapshots", default=SNAPSHOTS, metavar="DIR",
                    help="rainbow: where stage 1 leaves its selected "
                    "snapshots and stage 2 finds them")
    ap.add_argument("--concurrent", type=int, default=1,
                    help=argparse.SUPPRESS)   # set in a spawned seed
    ap.add_argument("--out", default=OUT, metavar="PATH")
    ap.add_argument("--yardsticks", default=None, metavar="PATH")
    ap.add_argument("--acceptance", default=ACCEPTANCE, metavar="PATH")
    args = ap.parse_args(argv)
    rainbow = args.trainer == "rainbow"
    if args.compare:
        yardsticks = args.yardsticks or (RAINBOW_YARDSTICKS if rainbow
                                         else YARDSTICKS)
        verdict = (compare_rainbow if rainbow else compare)(
            args.out, yardsticks, args.acceptance)
        print(f"wrote the section of {args.acceptance}: the port's "
              f"{args.trainer} curve {verdict} with the JAX package's")
    else:
        frames = args.frames or (RAINBOW_FRAMES if rainbow else FRAMES)
        run(args.seeds, frames, args.out, args.concurrent,
            dict(stage=args.stage, episodes=args.episodes,
                 snapshots=os.path.abspath(args.snapshots))
            if rainbow else None)


if __name__ == "__main__":
    main()
