"""The port's learning curves on the card, seed by seed, and their
comparison with the JAX package's curves on the CPU: DDPG (the default),
and, with ``--trainer rainbow`` or ``dqn``, Rainbow or the custom DQN.

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
and its score and frames).  Stage 2 then writes the final selection to
``<snapshots>/seed<k>_stage2.npz`` and evaluates it over ``--episodes``
episodes as EVALUATE_DQN does.  Each (seed, stage) appends one record,
with ``"trainer": "rainbow"`` and its ``"stage"``, to ``--out``; a (seed,
stage) recorded at this budget is skipped.  ``--compare --trainer
rainbow``, over the seeds both sides have, holds the final snapshot's
crash, merge, |jerk|, time to merge and selection score, and stage 1's
selection score, to 3 standard errors of the difference, and the counts of
seeds no worse than ``rainbow_default1_extended`` and of seeds whose final
snapshot merges below 0.9 each to one in four seeds; it writes the section
"Rainbow learning curve", with the port's selections under JAX's evaluator
(``scripts/jax_eval_port_rainbow.json``) where they are there.

    python scripts/train_curve_torch.py --run --trainer ddpg --stage 1|2
        [--seeds 0 1 2 3] [--frames 1e6] [--episodes 2048]
        [--handoffs runs_torch/curve_ddpg] [--time-limit SECONDS]
        [--handoff-after-blocks N] [--out ...]
    python scripts/train_curve_torch.py --compare --trainer ddpg --stage both
        [--yardsticks scripts/jax_ddpg_yardsticks.json]

``--trainer ddpg --stage`` runs one stage of ``ddpg.train`` on
``configs/train_default_1.json``: stage 1 at ``LEARNING_RATE``, stage 2
as ``ddpg.train`` runs it (``_extended``, ``derive_seed``, a tenth of the
rate, from stage 1's selection in ``<handoffs>/seed<k>_stage1.npz``, the
selection carried on), each to ``--frames`` valid frames with a
2048-episode selection evaluation every 5 rounds.  A stage does not fit a
run's time limit, so it runs in segments: a segment ends at the start of a
block of 5 rounds (the previous block's evaluation done) once the next
block would pass ``--time-limit`` or after ``--handoff-after-blocks``
blocks, and writes ``<handoffs>/seed<k>_stage<s>_handoff.pt``, everything
the stage needs to go on bit for bit; the next run with the same arguments
resumes from it.  Each (seed, stage) appends one record, with its
segments, when it ends, and writes its selection to
``<handoffs>/seed<k>_stage<s>.npz``; stage 2 then evaluates the final
selection over 1024 episodes, and the run evaluates
``ddpg_default1_extended`` once beside the seeds.  ``--compare --trainer
ddpg --stage both`` holds both stages by the Rainbow rule, the counts of
seeds no worse than ``ddpg_default1_extended`` to one, and writes "DDPG
learning curve, 1e6 + 1e6 frames" (stage 1 alone, by its own rule, until
stage 2 has run).

    python scripts/train_curve_torch.py --run --trainer dqn
        [--seeds 0 1 2 3] [--train-episodes 150000] [--episodes 512]
        [--handoffs runs_torch/curve_dqn] [--resume-from DIR]
        [--time-limit SECONDS] [--handoff-after-evals N] [--out ...]
    python scripts/train_curve_torch.py --compare --trainer dqn

``--trainer dqn`` runs the custom Double-DQN's loop, ``dqn.train``'s
(``dqn.train_episodes``), on ``configs/train_default_1.json`` as
TRAIN_DQN, B=128, rounds of 200 ticks, to ``--train-episodes`` episodes
with a 512-episode greedy evaluation every ``EVALUATION_PERIOD`` episodes.
It runs in segments: a segment ends at the start of a round right after
an evaluation, once the next evaluation period would pass ``--time-limit``
or after ``--handoff-after-evals`` evaluations, in
``<handoffs>/seed<k>_dqn_handoff<n>.pt`` (network, target, Adam state,
the packed ring with its priorities, env and world, the draw generator,
the loop's counters, the selection so far, the log), and appends a record
of its progress (``"partial": true``) to ``--out``; the next run resumes
from the last handoff in ``--resume-from`` bit for bit.  At the stage's
end each seed writes ``<handoffs>/seed<k>.npz`` and evaluates it over
4000 episodes at B=512, as ``run_data.csv`` line 218 was made.
Each record keeps each segment's PER scan on the card (``"per_scan"``),
and a seed's newest record replaces its older partial ones.
``--compare --trainer dqn`` writes "Custom DQN, 150,000 episodes": the
rule for the four seeds against the one JAX run (prediction intervals),
decided once every seed's stage has ended, and each seed's evaluations
beside JAX's 73.  ``--peek --trainer dqn [--resume-from DIR]`` (no card)
loads each seed's last handoff into a train state on the CPU and prints
where its stage stands.

    python scripts/train_curve_torch.py --export [--seeds 0 1 2 3]

``--export`` writes the actor and critic of each seed's stage-2 selection
(``scripts/curve_ddpg_stage2/seed<k>_stage2.npz``) to
``runs_torch/curve_ddpg_seed<k>_extended/params.npz``, where the
``MODEL_NAME`` ``runs/curve_ddpg_seed<k>_extended`` finds them
(``scripts/paper_table_torch.py --run combined_default_1 --model ...``).
"""

from __future__ import annotations

import argparse
import csv
import fcntl
import hashlib
import json
import lzma
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from paper_table_torch import (ACCEPTANCE, CURVE_MODEL,  # noqa: E402
                               CURVE_SECTION, DDPG_SECTION, RAINBOW_SECTION,
                               card_line, flagged, put_section)

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
    """The ``run`` of ``_train_frames`` (or of ``dqn.train_episodes``,
    whose step counts ``episodes``): keeps its scalar rows."""

    def __init__(self, step: str = "frames"):
        self.rows: List[dict] = []
        self.step = step

    def log_scalars(self, step, values) -> None:
        self.rows.append({self.step: int(step),
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
                 frames: Optional[List[int]] = None, count: str = "frames"):
    """Wrap ``module.<name>`` (``train_round`` by default) so that each call
    is timed to the end of its work (``sync`` waits for it), and, where
    ``frames`` is a list, the state's ``count`` (its frames by default)
    after each call goes to it; returns the list the seconds go to and the
    function that puts the real one back."""
    real = getattr(module, name)
    seconds: List[float] = []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = sync(real(*a, **kw))
        seconds.append(time.perf_counter() - t0)
        if frames is not None:
            frames.append(int(getattr(out, count)))
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
    """The newest stage-1 DDPG curve record of each seed in a JSONL file (a
    Rainbow record carries ``"trainer": "rainbow"``, a record of a stage of
    ``ddpg.train`` its ``"stage"``)."""
    return {int(r["seed"]): r for r in _lines(path)
            if r.get("trainer", "ddpg") == "ddpg" and "stage" not in r}


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


def put_record(path: str, record: dict, drop) -> None:
    """Append ``record`` to ``path`` in place of the records for which
    ``drop(r)`` holds, under the same lock as ``append_record``."""
    with open(path, "a+") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        fh.seek(0)
        kept = [line for line in fh.read().splitlines()
                if line.strip() and not drop(json.loads(line))]
        fh.seek(0)
        fh.truncate()
        fh.write("".join(line + "\n" for line in kept + [json.dumps(record)]))
        fh.flush()
        fcntl.flock(fh, fcntl.LOCK_UN)


def dqn_partials_of(seed: int):
    """``put_record``'s ``drop`` for a custom-DQN seed's partial records:
    the newest record keeps every segment."""
    return lambda r: (r.get("trainer") == "dqn" and r.get("partial")
                      and int(r["seed"]) == seed)


def run_one(seed: int, frames: float, out: str, concurrent: int,
            rainbow_args: Optional[dict] = None,
            ddpg_args: Optional[dict] = None,
            dqn_args: Optional[dict] = None) -> Optional[dict]:
    """One seed on the card (one Rainbow stage where ``rainbow_args``
    holds ``run_rainbow_stage``'s stage, episodes and snapshots; one
    segment of a DDPG stage where ``ddpg_args`` holds ``run_ddpg_stage``'s
    stage, episodes, handoffs, deadline and blocks; one segment of the
    custom DQN's stage, to ``frames`` episodes, where ``dqn_args`` holds
    ``run_dqn_stage``'s other arguments), ``concurrent`` seeds sharing it;
    appends and returns its record (None where a segment ended before its
    stage)."""
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // concurrent))
    torch.cuda.reset_peak_memory_stats()
    if dqn_args is not None:
        record = run_dqn_stage(seed, int(frames), **dqn_args)
        if record is None:          # the segment's progress, as a record
            progress = {**dqn_progress(dqn_args["handoffs"], [seed])[seed],
                        "card": card_line(),
                        "device": torch.cuda.get_device_name(0),
                        "concurrent_seeds": concurrent,
                        "max_memory_allocated_bytes":
                        torch.cuda.max_memory_allocated()}
            put_record(out, progress, dqn_partials_of(seed))
            print(f"seed {seed}: {progress['card']}; max_memory_allocated "
                  f"{progress['max_memory_allocated_bytes']} bytes",
                  flush=True)
            return None
    elif ddpg_args is not None:
        record = run_ddpg_stage(seed, frames, **ddpg_args)
        if record is None:
            print(f"seed {seed}: {card_line()}; max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
            return None
    elif rainbow_args is not None:
        record = run_rainbow_stage(seed, frames, **rainbow_args)
    else:
        record = run_seed(seed, frames)
    record.update(card=card_line(), device=torch.cuda.get_device_name(0),
                  concurrent_seeds=concurrent,
                  max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    if dqn_args is not None:
        put_record(out, record, dqn_partials_of(seed))
    else:
        append_record(out, record)
    stage = f" stage {record['stage']}" if "stage" in record else ""
    count = "episodes" if dqn_args is not None else "frames"
    line = (f"seed {seed}{stage}: {record['card']}; {record[count]} "
            f"{count} in {record['rounds']} rounds, "
            f"{record['s_per_round_median']:.2f} s per round ({concurrent} "
            f"seeds at once); selected @ {record['selected'][count]}")
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
          extra: Optional[List[str]] = None, log: str = "train_curve",
          meanwhile=None, budget: str = "--frames") -> None:
    """Every seed at once, each in a process of its own (``extra``: more
    arguments; ``frames`` goes to its ``budget`` option) that logs to
    ``<log>_seed<seed>.log`` beside ``out``; ``meanwhile()``, where given,
    runs in this process while they do."""
    out_dir = os.path.dirname(os.path.abspath(out))
    procs = []
    try:
        for seed in seeds:
            fh = open(os.path.join(out_dir, f"{log}_seed{seed}.log"), "w")
            procs.append((seed, fh, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--run",
                 "--seeds", str(seed), budget, str(frames), "--out", out,
                 "--concurrent", str(len(seeds))] + (extra or []),
                stdout=fh, stderr=subprocess.STDOUT, cwd=REPO)))
        if meanwhile is not None:
            try:
                meanwhile()
            except Exception:           # the seeds run on regardless
                traceback.print_exc()
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
        rainbow_args: Optional[dict] = None,
        ddpg_args: Optional[dict] = None,
        dqn_args: Optional[dict] = None) -> None:
    """The seeds without a record in ``out``: one in this process, several
    at once in processes of their own (``concurrent`` is set in those)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("--run trains on the card: "
                           "torch.cuda.is_available() is False")
    meanwhile = None
    if dqn_args is not None:
        todo = pending_stage(seeds, out, int(frames), 1, "dqn")
        extra = ["--trainer", "dqn", "--episodes",
                 str(dqn_args["eval_episodes"]), "--handoffs",
                 dqn_args["handoffs"]]
        for flag, name in (("--resume-from", "resume_from"),
                           ("--deadline", "deadline"),
                           ("--handoff-after-evals", "evals")):
            if dqn_args.get(name) is not None:
                extra += [flag, str(dqn_args[name])]
        log = "train_curve_dqn"
    elif ddpg_args is not None:
        stage = ddpg_args["stage"]
        todo = pending_stage(seeds, out, frames, stage, "ddpg")
        if stage == 2:          # refuse before any seed starts
            for seed in todo:
                snapshot_path(ddpg_args["resume_from"] or
                              ddpg_args["handoffs"], seed, check=True)
            # once, in the run that spawns the seeds, not in each seed
            if todo and reference_record(out) is None and concurrent == 1:
                def meanwhile():
                    evaluate_reference(out)
        extra = ["--trainer", "ddpg", "--stage", str(stage), "--episodes",
                 str(ddpg_args["eval_episodes"]), "--handoffs",
                 ddpg_args["handoffs"]]
        if ddpg_args.get("resume_from") is not None:
            extra += ["--resume-from", ddpg_args["resume_from"]]
        if ddpg_args.get("deadline") is not None:
            extra += ["--deadline", repr(ddpg_args["deadline"])]
        if ddpg_args.get("blocks") is not None:
            extra += ["--handoff-after-blocks", str(ddpg_args["blocks"])]
        log = f"train_curve_ddpg_stage{stage}"
    elif rainbow_args is None:
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
        budget = ("--train-episodes",) if dqn_args is not None else ()
        spawn(todo, frames, out, extra, log, meanwhile, *budget)
    elif todo:
        if meanwhile is not None:
            meanwhile()
        run_one(todo[0], frames, out, concurrent, rainbow_args, ddpg_args,
                dqn_args)


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


def stage_lr(cfg, stage: int) -> float:
    """The learning rate of a stage of ``ddpg.train`` or ``rainbow.train``:
    ``LEARNING_RATE``, then a tenth of it."""
    return cfg.LEARNING_RATE if stage == 1 else cfg.LEARNING_RATE / 10.0


def stage_schedule(cfg, stage: int, eps_end: float):
    """(lr, eps_start) of a stage of ``rainbow.train``: stage 1 at
    ``LEARNING_RATE`` from epsilon 1, stage 2 at a tenth of it from
    ``EPS_END``."""
    return stage_lr(cfg, stage), 1.0 if stage == 1 else eps_end


def rainbow_record(seed: int, stage: int, batch: int, frames_budget: float,
                   state, lr: float, eps_start: float, seconds: List[float],
                   frames_after: List[int], eval_seconds: List[float],
                   run: Recorder, best: dict, selected_stage: int,
                   eval_every: int, eval_episodes: int) -> dict:
    """The fields both sides record for a Rainbow (seed, stage)."""
    return {**stage_record("rainbow", RAINBOW_CONFIG, seed, stage, batch,
                           frames_budget, state, lr, seconds, frames_after,
                           eval_seconds, run, best, selected_stage,
                           eval_every, eval_episodes),
            "eps_start": eps_start}


def stage_record(trainer: str, config: str, seed: int, stage: int,
                 batch: int, frames_budget: float, state, lr: float,
                 seconds: List[float], frames_after: List[int],
                 eval_seconds: List[float], run: Recorder, best: dict,
                 selected_stage: int, eval_every: int, eval_episodes: int
                 ) -> dict:
    """The fields both sides record for a (seed, stage) of ``trainer``."""
    return {
        "trainer": trainer, "stage": stage, "seed": seed,
        "config": config, "batch": batch,
        "frames_budget": frames_budget, "frames": int(state.frames),
        "episodes": int(state.episodes), "lr": lr,
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


def snapshot_path(snapshots: str, seed: int, check: bool = False,
                  stage: int = 1) -> str:
    """``<snapshots>/seed<seed>_stage<stage>.npz``; with ``check``, raises
    where it is missing."""
    path = os.path.join(snapshots, f"seed{seed}_stage{stage}.npz")
    if check and not os.path.exists(path):
        raise FileNotFoundError(
            f"stage 2 of seed {seed} starts from stage 1's selected "
            f"snapshot, and {path} is missing: run --stage 1 first, or copy "
            "its snapshots there")
    return path


def save_selection(path: str, nets: Dict[str, dict], best: dict) -> None:
    """A stage's selected ``state_dict`` of each net under
    ``<net>/<layer>/<leaf>`` (the Flax layout of
    ``convert.tree_from_state_dict``), with the selection's score and
    frames (or episodes) under ``best/``."""
    from rl_mpc_lanemerging_torch import convert
    arrays = {f"{net}/{layer}/{leaf}": value
              for net, state_dict in nets.items()
              for layer, leaves in convert.tree_from_state_dict(
                  state_dict)["params"].items()
              for leaf, value in leaves.items()}
    if best.get("score") is not None:
        arrays["best/score"] = np.asarray(best["score"], dtype=np.float64)
        for count in ("frames", "episodes"):
            if count in best:
                arrays[f"best/{count}"] = np.asarray(best[count],
                                                     dtype=np.int64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_selection(path: str):
    """(each net's Flax parameter tree, the selection's score and frames)
    of ``save_selection``'s file."""
    trees: Dict[str, dict] = {}
    best: dict = {}
    with np.load(path) as data:
        for key in data.files:
            net, layer, leaf = key.split("/") if key.count("/") == 2 \
                else (None, None, None)
            if net is not None:
                trees.setdefault(net, {}).setdefault(layer, {})[leaf] = \
                    data[key]
        if "best/score" in data.files:
            best = {"score": tuple(float(x) for x in data["best/score"])}
            for count in ("frames", "episodes"):
                if f"best/{count}" in data.files:
                    best[count] = int(data[f"best/{count}"])
    return {net: {"params": tree} for net, tree in trees.items()}, best


def save_stage1(path: str, state_dict: dict, best: dict) -> None:
    """Stage 1's selected Rainbow ``state_dict`` under ``q_dist/``."""
    save_selection(path, {"q_dist": state_dict}, best)


def load_stage1(path: str):
    """(``state_dict``, ``best``) of ``save_stage1``'s file: the selected
    snapshot through ``convert.rainbow_from_numpy``, and the selection
    that stage 2 carries on, whose ``params`` is that snapshot."""
    from rl_mpc_lanemerging_torch import convert
    trees, best = load_selection(path)
    init = convert.rainbow_from_numpy(trees["q_dist"])
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
    starts from there (it raises where the file is missing), saves the
    final selection beside it (``seed<k>_stage2.npz``) and evaluates it
    over ``episodes`` episodes as ``rainbow.evaluate`` does.  Returns the
    record (without the card's fields)."""
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
        save_stage1(snapshot_path(snapshots, seed, stage=2), selected, best)
        t1 = time.perf_counter()
        net = rainbow._net_from(cfg, selected, dev)
        agg = tasks.evaluate_controller(cfg, rainbow.greedy_controller(
            net, cfg), num_episodes=episodes, device=dev, verbose=False)
        record.update(final=final_stats(agg, episodes),
                      final_s=time.perf_counter() - t1)
    return {**record, "train_s": train_s,
            "wall_s": time.perf_counter() - t0,
            "k1_launches": st_kernel.launches, "torch": torch.__version__}


def read_stages(records: List[dict], trainer: str = "rainbow",
                partial: bool = False) -> Dict[tuple, dict]:
    """The newest record of each (seed, stage) of ``trainer`` (the custom
    DQN's one stage is stage 1): of the stage, or with ``partial``, of its
    last segment."""
    return {(int(r["seed"]), int(r.get("stage", 1))): r for r in records
            if r.get("trainer") == trainer
            and bool(r.get("partial")) == partial}


def pending_stage(seeds: List[int], path: str, budget: float,
                  stage: int, trainer: str = "rainbow") -> List[int]:
    """The seeds without a record of ``stage`` of ``trainer`` in ``path``
    at a budget of ``budget`` frames (episodes for the custom DQN)."""
    done = read_stages(_lines(path), trainer)
    key = "episodes_budget" if trainer == "dqn" else "frames_budget"
    return [s for s in seeds if (s, stage) not in done
            or done[(s, stage)][key] < budget]


# --- DDPG: TRAIN_DDPG's two stages, each carried across runs by handoffs -

DDPG_YARDSTICKS = os.path.join(REPO, "scripts", "jax_ddpg_yardsticks.json")
DDPG_FRAMES = 1e6             # valid frames per stage, as ddpg.train
HANDOFFS = os.path.join(REPO, "runs_torch", "curve_ddpg")
# the committed stage-2 selections (``seed<k>_stage2.npz``)
SELECTIONS = os.path.join(REPO, "scripts", "curve_ddpg_stage2")
# the committed selections of each stage
PORT_SELECTIONS = {1: os.path.join(REPO, "scripts", "curve_ddpg_stage1"),
                   2: SELECTIONS}
# their evaluations by the JAX package's evaluator
# (scripts/jax_eval_port_selections.py), and the section that holds them
JAX_SELECTIONS = os.path.join(REPO, "scripts",
                              "jax_eval_port_selections.json")
SELECTIONS_SECTION = "## The port's selections under JAX's evaluator"
DDPG_LOGGED = (LOGGED, os.path.join(REPO, "runs", "ddpg_default1_extended"))
# the network of the paper's combined rows, evaluated beside the seeds
DDPG_REFERENCE = "ddpg_default1_extended"
LOG_BLOCK = 5                 # _train_frames logs every 5th round
HANDOFF_RESERVE_S = 90.0      # a segment's save, beyond its last block
# the handoff's replay streams: 4-byte words, compressed byte plane by plane
_WORD = np.dtype("<u4")


class SegmentEnd(Exception):
    """Ends a segment at the start of a block of rounds: the run's time
    limit would not hold the block, or the segment has run its blocks."""


def _stage_label(stage) -> str:
    """``stage<s>`` of a stage of ``ddpg.train``; a label such as ``dqn``
    as it is."""
    return f"stage{stage}" if isinstance(stage, int) else stage


def handoff_path(handoffs: str, seed: int, stage, segment: int) -> str:
    """The handoff that ends ``segment`` (1, 2, ...) of a seed's stage
    (``stage``: a stage of ``ddpg.train``, or ``DQN_STAGE``)."""
    return os.path.join(handoffs, f"seed{seed}_{_stage_label(stage)}_"
                        f"handoff{segment}.pt")


def handoff_files(folder: str, seed: int, stage) -> List[str]:
    """A seed's handoffs of a stage in ``folder`` (each with its ``.json``
    beside it), the last segment's last."""
    pattern = re.compile(
        rf"seed{seed}_{_stage_label(stage)}_handoff(\d+)\.pt$")
    found = [(int(m.group(1)), name) for name in (
        os.listdir(folder) if os.path.isdir(folder) else [])
        for m in [pattern.match(name)] if m]
    return [os.path.join(folder, name) for _, name in sorted(found)]


def _planes(words) -> bytes:
    """The bytes of 4-byte words, byte plane by byte plane, compressed."""
    words = np.ascontiguousarray(words, dtype=_WORD)
    return lzma.compress(np.ascontiguousarray(
        words.view(np.uint8).reshape(-1, 4).T).tobytes())


def _words(blob, count: int):
    planes = np.frombuffer(lzma.decompress(bytes(blob)), np.uint8)
    return np.ascontiguousarray(planes.reshape(4, count).T).view(
        _WORD).reshape(count)


def _successors(obs, next_obs):
    """For each row, the first row whose observation equals its next
    observation bit for bit, or -1."""
    first: Dict[bytes, int] = {}
    for i, row in enumerate(obs):
        first.setdefault(row.tobytes(), i)
    return np.fromiter((first.get(row.tobytes(), -1) for row in next_obs),
                       np.int64, len(next_obs))


def _chain_order(succ):
    """The rows chain by chain (row, its successor, ...), heads first: an
    order in which one scenario's observations follow each other."""
    n = len(succ)
    nxt = succ.tolist()
    headed = np.ones(n, bool)
    headed[succ[succ >= 0]] = False
    seen = bytearray(n)
    order: List[int] = []
    for start in np.flatnonzero(headed).tolist() + list(range(n)):
        i = start
        while i >= 0 and not seen[i]:
            seen[i] = 1
            order.append(i)
            i = nxt[i]
    return np.asarray(order, np.int64)


RING = ("obs", "next_obs", "action", "reward", "terminal", "discount",
        "priority")


def ring_arrays(replay) -> dict:
    """The replay ring's buffers, every row (the scratch row too), as
    numpy arrays on the host."""
    return {name: getattr(replay, name).cpu().numpy() for name in RING}


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for name in RING:
        h.update(np.ascontiguousarray(arrays[name]).view(np.uint8).data)
    return h.hexdigest()


def _blob(data: bytes):
    import torch
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def _pack_rows(arrays: dict) -> dict:
    """Rows of the ring, losslessly, in about a sixth of their bytes: each
    next observation that is another row's observation as that row's
    offset, the observations chain by chain as differences of their bit
    patterns, and every stream compressed byte plane by byte plane."""
    obs, nxt = arrays["obs"], arrays["next_obs"]
    n, dim = obs.shape
    succ = _successors(obs, nxt)
    order = _chain_order(succ)
    cols = obs.view(_WORD)[order].T.copy()          # (dim, n) chain order
    cols[:, 1:] -= cols[:, :-1].copy()
    offsets = np.where(succ >= 0, succ - np.arange(n), -2 ** 31)
    packed = {"rows": n, "dim": dim,
              "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
              "obs": _blob(_planes(cols.reshape(-1))),
              "offsets": _blob(_planes(offsets.astype(np.int32)
                                       .view(_WORD))),
              "orphans": _blob(_planes(nxt[succ < 0].view(_WORD)
                                       .reshape(-1))),
              "terminal": _blob(lzma.compress(
                  arrays["terminal"].view(np.uint8).tobytes()))}
    for name in ("action", "reward", "discount", "priority"):
        packed[name] = _blob(_planes(arrays[name].view(_WORD)))
    return packed


def _unpack_rows(packed: dict) -> dict:
    n, dim = packed["rows"], packed["dim"]
    dt = {k: np.dtype(v) for k, v in packed["dtypes"].items()}
    offsets = _words(packed["offsets"].numpy(), n).view(np.int32)
    succ = np.where(offsets == -2 ** 31, -1,
                    np.arange(n) + offsets.astype(np.int64))
    order = _chain_order(succ)
    wdim = dim * dt["obs"].itemsize // _WORD.itemsize     # words a row
    cols = np.cumsum(_words(packed["obs"].numpy(), n * wdim).reshape(wdim, n),
                     axis=1, dtype=_WORD)
    obs = np.empty((n, wdim), _WORD)
    obs[order] = cols.T
    obs = obs.view(dt["obs"])
    nxt = obs[np.maximum(succ, 0)].copy()
    orphans = succ < 0
    nxt[orphans] = _words(packed["orphans"].numpy(),
                          int(orphans.sum()) * wdim).view(
        dt["next_obs"]).reshape(-1, dim)
    out = {"obs": obs, "next_obs": nxt,
           "terminal": np.frombuffer(lzma.decompress(bytes(
               packed["terminal"].numpy())), np.uint8).view(
               dt["terminal"]).copy()}
    for name in ("action", "reward", "discount", "priority"):
        out[name] = _words(packed[name].numpy(),
                           n * dt[name].itemsize // _WORD.itemsize).view(
            dt[name]).copy()
    return out


def pack_replay(replay, base: Optional[dict] = None) -> dict:
    """The replay ring, losslessly (``_pack_rows``).  With ``base``
    (``{"name": a handoff file, "ring": its ring_arrays}``, the ring this
    segment resumed from) only the rows that differ from it, so that a
    handoff written after fewer new rows than the ring holds is smaller.
    Checked: unpacked, it equals the ring bit for bit."""
    arrays = ring_arrays(replay)
    packed = {"pos": int(replay.pos), "size": int(replay.size),
              "digest": _digest(arrays)}
    if base is None:
        packed.update(_pack_rows(arrays))
    else:
        old = base["ring"]
        changed = np.zeros(len(arrays["priority"]), bool)
        for name in RING:
            a, b = arrays[name], old[name]
            changed |= (a.view(np.uint8).reshape(len(a), -1)
                        != b.view(np.uint8).reshape(len(b), -1)).any(axis=1)
        rows = np.flatnonzero(changed)
        packed.update(base=base["name"], base_digest=_digest(old),
                      changed=_blob(_planes(rows.astype(np.uint32))),
                      **_pack_rows({k: v[rows] for k, v in arrays.items()}))
    unpack_arrays(packed, None if base is None else base["ring"])
    return packed


def unpack_arrays(packed: dict, base: Optional[dict] = None) -> dict:
    """``pack_replay``'s ring as numpy arrays (``base``: the ring_arrays
    of the handoff a packed delta names).  Raises unless they are the ring
    it was packed from, bit for bit."""
    rows = _unpack_rows(packed)
    if "base" in packed:
        if base is None or _digest(base) != packed["base_digest"]:
            raise ValueError(f"the ring of {packed['base']} is not the one "
                             "this handoff was written against")
        index = _words(packed["changed"].numpy(), packed["rows"]).astype(
            np.int64)
        out = {k: v.copy() for k, v in base.items()}
        for k in RING:
            out[k][index] = rows[k]
    else:
        out = rows
    if packed.get("digest", _digest(out)) != _digest(out):
        raise ValueError("a packed replay ring does not unpack to the ring "
                         "it was written from")
    return out


def replay_like(arrays: dict, packed: dict, like):
    """A ``Replay`` of copies of ``arrays`` and ``packed``'s cursor and
    size on the device of ``like`` (``arrays`` stay as they are: the
    next handoff's base)."""
    import torch
    dev = like.obs.device
    return like._replace(
        **{name: torch.from_numpy(arrays[name]).to(dev, copy=True)
           for name in RING},
        pos=torch.tensor(packed["pos"], dtype=like.pos.dtype, device=dev),
        size=torch.tensor(packed["size"], dtype=like.size.dtype,
                          device=dev))


def _to_host(tree):
    """Nested dicts, lists and tuples of tensors with every tensor on the
    CPU (a named tuple becomes a dict of its fields)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _to_host(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _like(template, saved):
    """``saved`` (``_to_host``'s form of a named tuple of tensors) in the
    named tuple type, dtypes and devices of ``template``."""
    import torch
    if isinstance(template, torch.Tensor):
        if saved.shape != template.shape or saved.dtype != template.dtype:
            raise ValueError(f"a handoff tensor is {saved.dtype} "
                             f"{tuple(saved.shape)}, the state's "
                             f"{template.dtype} {tuple(template.shape)}")
        return saved.to(template.device)
    return type(template)(**{k: _like(v, saved[k]) for k, v in
                             zip(template._fields, template)})


def _squeeze(tree):
    """``tree`` with each float32 tensor of more than 256 values as its
    ``_planes`` and shape (networks and moments: about three quarters of
    their bytes); ``_unsqueeze`` undoes it."""
    import torch
    if isinstance(tree, torch.Tensor):
        if tree.dtype != torch.float32 or tree.numel() <= 256:
            return tree
        blob = _planes(tree.numpy().reshape(-1).view(_WORD))
        return {"planes": torch.frombuffer(bytearray(blob),
                                           dtype=torch.uint8),
                "shape": list(tree.shape)}
    if isinstance(tree, dict):
        return {k: _squeeze(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_squeeze(v) for v in tree)
    return tree


def _unsqueeze(tree):
    import torch
    if isinstance(tree, dict):
        if tree.keys() == {"planes", "shape"}:
            count = math.prod(tree["shape"])
            return torch.from_numpy(_words(tree["planes"].numpy(), count)
                                    .view(np.float32).reshape(
                                        tree["shape"]).copy())
        return {k: _unsqueeze(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unsqueeze(v) for v in tree)
    return tree


# the fields of a trainer's state that a handoff carries: its modules and
# optimisers (``state_dict``s), its counter tensors, and its plain values
DDPG_FIELDS = {"nets": ("actor", "critic", "target_actor", "target_critic"),
               "opts": ("actor_opt", "critic_opt"),
               "counters": ("episodes", "frames", "ret_acc", "ep_ret_sum",
                            "ep_ret_n"),
               "plain": (("learning", bool), ("updates", int))}
DQN_FIELDS = {"nets": ("net", "target_net"), "opts": ("opt",),
              "counters": ("episodes", "loss_sum"),
              "plain": (("grad_steps", int),)}


def train_state_tree(state, fields: dict = DDPG_FIELDS) -> dict:
    """Everything of a trainer's state (a ``DDPGTrainState`` by default,
    ``DQN_FIELDS`` a ``DQNTrainState``) that a handoff carries, on the
    CPU, the replay as it stands (``world_rng`` is rebuilt from the
    config)."""
    return {
        "nets": {name: _to_host(getattr(state, name).state_dict())
                 for name in fields["nets"]},
        "opts": {name: _to_host(getattr(state, name).state_dict())
                 for name in fields["opts"]},
        "replay": _to_host(state.replay), "env": _to_host(state.env),
        "draws": state.draws.generator.get_state().clone(),
        "counters": {name: _to_host(getattr(state, name))
                     for name in fields["counters"]},
        **{name: kind(getattr(state, name))
           for name, kind in fields["plain"]}}


def handoff_key(seed: int, stage: int, batch: int, frames_budget: float,
                eval_every: int, eval_episodes: int, overrides=None) -> dict:
    """What a handoff was written for; a load refuses any other."""
    return {"config": CONFIG, "seed": seed, "stage": stage, "batch": batch,
            "frames_budget": float(frames_budget), "eval_every": eval_every,
            "eval_episodes": eval_episodes,
            "overrides": json.dumps(overrides or {}, sort_keys=True)}


def save_handoff(path: str, state, key: dict, extra: dict,
                 base: Optional[dict] = None,
                 fields: dict = DDPG_FIELDS) -> tuple:
    """Write ``state`` (its ``fields``; its ring packed, as a delta against
    ``base`` where given: see ``pack_replay``), ``key`` and ``extra`` to
    ``path`` through a temporary file, so that a run cut mid-write leaves
    the previous file whole; returns (seconds, bytes)."""
    import torch
    t0 = time.perf_counter()
    tree = train_state_tree(state, fields)
    replay = pack_replay(state.replay, base)
    tree = _squeeze({**tree, "replay": None})
    tree["replay"] = replay
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"key": key, "state": tree, **_squeeze(extra)}, tmp)
    os.replace(tmp, path)
    return time.perf_counter() - t0, os.path.getsize(path)


def _read(path: str, key: dict) -> dict:
    import torch
    data = torch.load(path, map_location="cpu", weights_only=True)
    if data["key"] != key:
        raise ValueError(f"{path} was written for {data['key']}, not for "
                         f"{key}")
    return data


def load_handoff(path: str, state, key: dict,
                 fields: dict = DDPG_FIELDS) -> dict:
    """Overwrite ``state`` (a fresh ``make_train_state`` of the same config
    and trainer as ``fields``) from ``save_handoff``'s file (a delta with
    the file it names,
    beside it); returns the file's other fields, and under ``ring`` the
    loaded ring as a ``base`` for ``save_handoff`` (None where the file
    was a delta).  Raises where a file was written for another ``key``."""
    data = _read(path, key)
    tree = data.pop("state")
    replay = tree.pop("replay")
    older = None
    if "base" in replay:
        older = _read(os.path.join(os.path.dirname(path), replay["base"]),
                      key)["state"]["replay"]
        older = unpack_arrays(older)
    ring = unpack_arrays(replay, older)
    tree, data = _unsqueeze(tree), _unsqueeze(data)
    for name, sd in tree["nets"].items():
        getattr(state, name).load_state_dict(sd)
    for name, sd in tree["opts"].items():
        getattr(state, name).load_state_dict(sd)
    state.replay = replay_like(ring, replay, state.replay)
    state.env = _like(state.env, tree["env"])
    state.draws.generator.set_state(tree["draws"])
    for name, value in tree["counters"].items():
        setattr(state, name, _like(getattr(state, name), value))
    for name, _ in fields["plain"]:
        setattr(state, name, tree[name])
    data["ring"] = None if older is not None else {
        "name": os.path.basename(path), "ring": ring}
    return data


def _host_best(best: dict) -> dict:
    """A selection so far (its ``params`` a ``state_dict``, or a tuple of
    them) as a handoff carries it."""
    out = {k: v for k, v in best.items() if k != "params"}
    if "score" in out:
        out["score"] = [float(x) for x in out["score"]]
    if best.get("params") is not None:
        out["params"] = _to_host(best["params"])
    return out


def _device_best(saved: dict, dev) -> dict:
    """``_host_best``'s selection with its ``params`` on ``dev``."""
    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return tuple(to(v) for v in tree)
        return tree.to(dev)

    best = dict(saved)
    if "score" in best:
        best["score"] = tuple(best["score"])
    if "params" in best:
        best["params"] = to(best["params"])
    return best


def _ddpg_selection(path: str):
    """(init, best) of stage 1's selection: (actor, critic)
    ``state_dict``s, and the selection stage 2 carries on, whose
    ``params`` is ``init``."""
    from rl_mpc_lanemerging_torch import convert
    trees, best = load_selection(path)
    init = (convert.ddpg_actor_from_numpy(trees["actor"]),
            convert.ddpg_critic_from_numpy(trees["critic"]))
    if best:
        best["params"] = init
    return init, best


def segment_end(seconds: List[float], eval_seconds: List[float], boundary,
                deadline: Optional[float], periods: Optional[int],
                counted: str, period: str, clock=time.time):
    """The check made before each round of a segment: why the segment
    ends there, or None.  ``boundary()`` gives the rounds of the period
    just run where the next round starts a period (after a block of rounds,
    or after an evaluation), else 0.  At such a boundary, after at least
    one period of this segment, the segment ends where ``periods`` periods
    of it have run ("<periods> <counted> run") or where the clock would pass
    ``deadline`` before the next ``period`` (its rounds at the slowest of
    the last period's), its evaluation, one more evaluation (the stage's
    last) and the save are done."""
    start = len(seconds)
    seen = [0]

    def check() -> Optional[str]:
        rounds = boundary() if len(seconds) > start else 0
        if not rounds:
            return None
        seen[0] += 1
        if periods is not None and seen[0] >= periods:
            return f"{periods} {counted} run"
        if deadline is not None:
            need = rounds * max(seconds[-rounds:]) \
                + 2 * max(eval_seconds[-1:] or [0.0]) + HANDOFF_RESERVE_S
            if clock() + need > deadline:
                return f"the next {period} would pass the run's time limit"
        return None
    return check


def segment_guard(module, seconds: List[float], eval_seconds: List[float],
                  block: int, deadline: Optional[float],
                  blocks: Optional[int], clock=time.time):
    """Wrap ``module.train_round`` so that it raises ``SegmentEnd`` where
    ``segment_end`` ends a segment at a boundary of ``block`` rounds
    (``blocks`` of them, or ``deadline``); returns the function that puts
    the real one back."""
    check = segment_end(
        seconds, eval_seconds,
        lambda: block if len(seconds) % block == 0 else 0, deadline, blocks,
        "blocks", "block", clock)
    real = module.train_round

    def guarded(*a, **kw):
        why = check()
        if why is not None:
            raise SegmentEnd(why)
        return real(*a, **kw)

    module.train_round = guarded

    def restore():
        module.train_round = real
    return restore


def run_ddpg_stage(seed: int, frames: float, stage: int = 1,
                   batch: int = BATCH, eval_every: int = EVAL_EVERY,
                   eval_episodes: int = EVAL_EPISODES,
                   final_episodes: int = FINAL_EPISODES,
                   handoffs: str = HANDOFFS, device="cuda", overrides=None,
                   deadline: Optional[float] = None,
                   blocks: Optional[int] = None,
                   resume_from: Optional[str] = None) -> Optional[dict]:
    """One segment of a stage of ``ddpg.train`` for one seed on
    ``device``: stage 1 at ``LEARNING_RATE`` from the seed's networks,
    stage 2 as ``ddpg.train`` runs it (``LOG_DIR`` + ``_extended``, fresh
    worlds, ``derive_seed``, a tenth of the rate, stage 1's selection as
    its start and its best so far), each to ``frames`` valid frames with an
    ``eval_episodes``-episode selection evaluation every ``eval_every``
    rounds.  A seed with a handoff in ``resume_from`` (``handoffs`` by
    default; stage 2 finds stage 1's selection there too) resumes from its
    last.  The segment ends at a block boundary (``segment_guard``:
    ``deadline``, on the ``time.time`` clock, or ``blocks``); it then
    writes its handoff to ``handoffs`` (a delta against the one it resumed
    from, where that was whole: the two must travel together) and returns
    None.  At the stage's end it writes its selection to
    ``snapshot_path(handoffs, seed, stage=stage)``, and stage 2 evaluates
    the final selection over ``final_episodes`` episodes; the handoff files
    go, and the (seed, stage) record (without the card's fields) is
    returned."""
    import torch
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch._device import (pin_fp32_matmul,
                                                  resolve_device)
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.ops import st_kernel
    dev = resolve_device(device)
    pin_fp32_matmul()
    cfg = seed_config(seed, batch, overrides)
    lr = stage_lr(cfg, stage)
    key = handoff_key(seed, stage, batch, frames, eval_every, eval_episodes,
                      overrides)
    resume_from = resume_from or handoffs
    init, best = _ddpg_selection(snapshot_path(resume_from, seed,
                                               check=True)) \
        if stage == 2 else (None, {})
    scfg = cfg if stage == 1 else cfg.replace(
        LOG_DIR=cfg.LOG_DIR + "_extended")
    seed0 = tasks.seed_of(cfg)
    st_kernel.launches = 0
    t0 = time.perf_counter()
    worlds, world_rng = tasks.make_worlds(scfg, device=dev)
    state = ddpg.make_train_state(
        scfg, worlds, world_rng,
        seed0 if stage == 1 else ddpg.derive_seed(seed0), lr=lr,
        init_params=init)
    found = handoff_files(resume_from, seed, stage)
    run = Recorder()
    saved = {"frames0": int(state.frames), "seconds": [], "frames_after": [],
             "eval_seconds": [], "segments": [], "ring": None}
    load_s = None
    if found:
        t1 = time.perf_counter()
        saved = load_handoff(found[-1], state, key)
        load_s = time.perf_counter() - t1
        if os.path.exists(found[-1] + ".json"):
            with open(found[-1] + ".json") as fh:
                saved["segments"][-1].update(json.load(fh))
        run.rows = saved["rows"]
        best = _device_best(saved["best"], dev)
        if best.get("selected_stage1"):       # stage 1's snapshot, as init
            best.pop("selected_stage1")
            init = best["params"]

    def sync(out):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    frames_after = list(saved["frames_after"])
    seconds, restore = timed_rounds(ddpg, sync, frames=frames_after)
    seconds.extend(saved["seconds"])
    eval_seconds, restore_eval = timed_rounds(ddpg, sync, "_eval_actor")
    eval_seconds.extend(saved["eval_seconds"])
    restore_guard = segment_guard(ddpg, seconds, eval_seconds,
                                  math.lcm(LOG_BLOCK, eval_every), deadline,
                                  blocks)
    frames0 = saved["frames0"]
    left = frames - (int(state.frames) - frames0)
    segment = {"rounds_from": len(seconds), "load_s": load_s}
    try:
        state = ddpg._train_frames(scfg, state, left, lr, verbose=True,
                                   run=run, eval_every_rounds=eval_every,
                                   eval_episodes=eval_episodes, best=best)
        ended = None
    except SegmentEnd as stop:
        ended = str(stop)
    finally:
        restore_guard()
        restore_eval()
        restore()
    segment.update(rounds_to=len(seconds), frames=int(state.frames),
                   wall_s=time.perf_counter() - t0,
                   k1_launches=st_kernel.launches)
    segments = saved["segments"] + [segment]
    if ended is not None:
        host_best = _host_best(best)
        if stage == 2 and best.get("params") is init:
            host_best["selected_stage1"] = True
        segment["ended"] = ended
        path = handoff_path(handoffs, seed, stage, len(segments))
        save_s, size = save_handoff(path, state, key, {
            "frames0": frames0, "seconds": seconds,
            "frames_after": frames_after, "eval_seconds": eval_seconds,
            "rows": run.rows, "best": host_best, "segments": segments},
            saved["ring"])
        with open(path + ".json", "w") as fh:      # the save, measured
            json.dump({"save_s": save_s, "handoff_bytes": size}, fh)
        print(f"seed {seed} stage {stage}: segment {len(segments)} ended "
              f"after {len(seconds)} rounds at {int(state.frames)} frames "
              f"({ended}); handoff {size} bytes in {save_s:.2f} s; K1 "
              f"launches {st_kernel.launches}", flush=True)
        return None
    train_s = sum(s["wall_s"] for s in segments)
    selected = best.get("params") or ddpg._snapshot(state.actor,
                                                    state.critic)
    record = stage_record(
        "ddpg", CONFIG, seed, stage, batch, frames, state, lr, seconds,
        frames_after, eval_seconds, run, best,
        1 if stage == 1 or selected is init else 2, eval_every,
        eval_episodes)
    save_selection(snapshot_path(handoffs, seed, stage=stage),
                   {"actor": selected[0], "critic": selected[1]}, best)
    if stage == 2:
        t1 = time.perf_counter()
        actor = ddpg._actor_from(cfg, selected[0], dev)
        agg = tasks.evaluate_controller(cfg, ddpg.actor_controller(
            actor, cfg), num_episodes=final_episodes, device=dev,
            verbose=False)
        record.update(final=final_stats(agg, final_episodes),
                      final_s=time.perf_counter() - t1)
    for done in found + handoff_files(handoffs, seed, stage):
        for name in (done, done + ".json"):
            if os.path.exists(name):
                os.remove(name)
    segment["wall_s"] = time.perf_counter() - t0
    return {**record, "segments": segments, "train_s": train_s,
            "wall_s": sum(s["wall_s"] for s in segments),
            "k1_launches": sum(s.get("k1_launches") or 0 for s in segments),
            "torch": torch.__version__}


def export_selection(path: str, model: str) -> str:
    """Write the actor and critic of a DDPG selection file
    (``save_selection``'s) as the port's checkpoint of ``MODEL_NAME``
    ``model``, ``runs_torch/<name>/params.npz`` (``checkpoint.save_params``;
    the ``best/`` keys stay out, as ``checkpoint.load_params`` splits every
    key into ``<net>/<layer>/<leaf>``); returns its path."""
    from rl_mpc_lanemerging_torch import checkpoint
    from rl_mpc_lanemerging_torch.rundir import RUNS_ROOT
    trees, _ = load_selection(path)
    return checkpoint.save_params(
        os.path.join(RUNS_ROOT, os.path.basename(os.path.normpath(model))),
        {net: trees[net] for net in ("actor", "critic")})


def reference_record(out: str) -> Optional[dict]:
    """The newest evaluation of ``DDPG_REFERENCE`` in ``out``."""
    found = [r for r in _lines(out) if r.get("trainer") == "reference"
             and r.get("network") == DDPG_REFERENCE]
    return found[-1] if found else None


def evaluate_reference(out: str, episodes: int = FINAL_EPISODES,
                       batch: int = BATCH, device="cuda",
                       overrides=None) -> dict:
    """The committed ``DDPG_REFERENCE`` actor over the final evaluation's
    ``episodes`` episodes of ``CONFIG`` at its own ``SEED`` (those of seed
    0), as a record of ``"trainer": "reference"`` appended to ``out``."""
    import torch
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch._device import resolve_device
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.checkpoint import load_actor
    dev = resolve_device(device)
    from rl_mpc_lanemerging_torch.config import Settings
    own_seed = tasks.seed_of(Settings.load_from_file(os.path.join(REPO,
                                                                  CONFIG)))
    cfg = seed_config(own_seed, batch, overrides)
    t0 = time.perf_counter()
    actor = load_actor(DDPG_REFERENCE, dev, cfg.MINIMUM_NEGATIVE_JERK,
                       cfg.MAXIMUM_POSITIVE_JERK, committed=True)
    agg = tasks.evaluate_controller(cfg, ddpg.actor_controller(actor, cfg),
                                    num_episodes=episodes, device=dev,
                                    verbose=False)
    record = {"trainer": "reference", "network": DDPG_REFERENCE,
              "config": CONFIG, "seed": cfg.SEED, "batch": batch,
              "final": final_stats(agg, episodes),
              "final_s": time.perf_counter() - t0,
              "torch": torch.__version__}
    if dev.type == "cuda":
        record.update(card=card_line(),
                      device=torch.cuda.get_device_name(0))
    append_record(out, record)
    f = record["final"]
    print(f"{DDPG_REFERENCE}: crash {f['crash']:.4f} merge {f['merge']:.4f} "
          f"|jerk| {f['jerk']:.4f} over {episodes} episodes in "
          f"{record['final_s']:.2f} s", flush=True)
    return record


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


def _rule(port: dict, jax: dict, metrics, count: str):
    """A rule's rows (quantity, port, JAX, |difference|, 3 SEM of it,
    holds) over ``metrics`` (name, label), whether the seed counts under
    ``count`` differ by one at most, and its verdict."""
    rows = []
    for name, label in metrics:
        (pm, ps), (jm, js) = port[name], jax[name]
        rows.append((label, port[name], jax[name], abs(pm - jm),
                     3.0 * math.sqrt(ps ** 2 + js ** 2),
                     not flagged(pm, ps, jm, js)))
    counts_hold = abs(port[count] - jax[count]) <= 1
    agrees = all(r[-1] for r in rows) and counts_hold
    return rows, counts_hold, "agrees" if agrees else "differs"


def decide(port: dict, jax: dict):
    """The 4e5-frame curve's rule (``_rule``)."""
    return _rule(port, jax, FINAL_METRICS + (
        ("reach_frames", "frames to crash <= 0.005 and merge >= 0.995"),),
        "reached")


def logged_runs(folder: str = LOGGED, lr: str = "0.0002"
                ) -> Dict[str, List[dict]]:
    """The JAX package's own selection evaluations, logged on the TPU in
    ``runs/ddpg_default1`` (stage 2: ``runs/ddpg_default1_extended``, lr
    "2e-05"): ``scalars.1.csv`` holds two runs (A, then B, where the
    frames start again), ``scalars.csv`` a third (C; ``scalars.2.csv`` is C
    without the time to merge).  Under the progress header (step,
    avg_return, episodes, lr) an evaluation row is (step, crash, |jerk|,
    merge[, time to merge]); a progress row has the learning rate ``lr``
    as its fourth value."""
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
            if row[3] == lr:
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


WEAK_MERGE = 0.9              # a final selection merging below it is weak
RAINBOW_COUNTS = ("no_worse", "weak")
# the port's Rainbow selections evaluated by the JAX package's evaluator
# (scripts/jax_eval_port_selections.py --trainer rainbow)
JAX_RAINBOW_SELECTIONS = os.path.join(REPO, "scripts",
                                      "jax_eval_port_rainbow.json")


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
    merge counts where the seed merged at all); how many seeds' final
    snapshot scores no worse than ``reference``, and how many merge below
    ``WEAK_MERGE`` at their final evaluation."""
    qs = [quantities(*pair) for pair in seeds.values()]
    out = {name: _mean_sem([q[name] for q in qs if q[name] is not None])
           for name, _ in RAINBOW_METRICS}
    out["no_worse"] = sum(q["final_score"] <= reference for q in qs)
    out["weak"] = sum(q["merge"] < WEAK_MERGE for q in qs)
    out["n"] = len(qs)
    return out


def decide_rainbow(port: dict, jax: dict):
    """The two-stage rule (``_rule``), of DDPG."""
    return _rule(port, jax, RAINBOW_METRICS, "no_worse")


def decide_rainbow_seeds(port: dict, jax: dict):
    """Rainbow's rule over its seeds: each quantity of ``_rule``, and the
    counts of seeds no worse than the reference and of weak seeds (a final
    merge below ``WEAK_MERGE``) each within one in four of the fewer seeds
    (one at four seeds a side, two at eight).  Returns the quantities'
    rows, whether each count holds, the allowance and the verdict."""
    rows, _, _ = _rule(port, jax, RAINBOW_METRICS, "no_worse")
    allow = max(1, min(port["n"], jax["n"]) // 4)
    counts = {name: abs(port[name] - jax[name]) <= allow
              for name in RAINBOW_COUNTS}
    agrees = all(r[-1] for r in rows) and all(counts.values())
    return rows, counts, allow, "agrees" if agrees else "differs"


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


def _stage_evals(port: Dict[int, tuple], jax: Dict[int, tuple]
                 ) -> List[str]:
    """The table of every selection evaluation of both sides' stages."""
    lines = ["| side | seed | stage | frames | crash | merge | mean abs jerk "
             "| time to merge (s) |", "| --- " * 8 + "|"]
    for side, recs in (("port (card)", port), ("JAX (CPU)", jax)):
        for seed in sorted(recs):
            for r in recs[seed]:
                for e in r["evals"]:
                    t = "-" if e["t_merge"] is None else f"{e['t_merge']:.2f}"
                    lines.append(
                        f"| {side} | {seed} | {r['stage']} | {e['frames']} "
                        f"| {e['crash']:.4f} | {e['merge']:.4f} | "
                        f"{e['jerk']:.4f} | {t} |")
    return lines


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
    rows, counts, allow, verdict = decide_rainbow_seeds(ps, js)
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
        "### Selection evaluations", ""] + _stage_evals(port, jax)
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
              f"of LOG_DIR `{REFERENCE_LOG_DIR}` in `run_data_torch.csv`), and "
              "of seeds whose final snapshot merges below "
              f"{WEAK_MERGE:g} at its final evaluation, may each differ by "
              "one in four seeds at most (one at four seeds a side, two at "
              "eight).", "",
              "| quantity | port mean ± SEM | JAX mean ± SEM | difference | "
              "3 SEM of the difference | holds |", "| --- " * 6 + "|"]
    for label, p, j, diff, bar, holds in rows:
        lines.append(f"| {label} | {_pm(p)} | {_pm(j)} | {diff:.4f} | "
                     f"{bar:.4f} | {'yes' if holds else 'no'} |")
    for name, label in (("no_worse", "seeds no worse than "
                         "rainbow_default1_extended"),
                        ("weak", "seeds whose final snapshot merges below "
                         f"{WEAK_MERGE:g}")):
        lines.append(
            f"| {label} | {ps[name]} of {ps['n']} | {js[name]} of "
            f"{js['n']} | {abs(ps[name] - js[name])} | at most {allow} | "
            f"{'yes' if counts[name] else 'no'} |")
    lines += ["", f"**Verdict: the port's Rainbow curve {verdict} with the "
              "JAX package's.**", "",
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


def compare_rainbow(out: str, yardsticks: str, acceptance: str,
                    jax_selections: str = JAX_RAINBOW_SELECTIONS) -> str:
    """Write the Rainbow section into ``acceptance`` over every seed with
    both stages on both sides, and in it, where ``jax_selections``
    (``scripts/jax_eval_port_selections.py --trainer rainbow``'s file) is
    there, the port's selections under JAX's evaluator; returns the
    verdict."""
    stages = read_stages(_lines(out))
    port = seeds_of(stages)
    with open(yardsticks) as fh:
        jax = seeds_of(read_stages(json.load(fh)["records"]))
    both = set(port) & set(jax)
    if not both:
        raise SystemExit(f"no seed with both stages on both sides: port "
                         f"{sorted(port)}, JAX {sorted(jax)}")
    text = section_rainbow({s: port[s] for s in sorted(both)},
                           {s: jax[s] for s in sorted(both)},
                           reference_score())
    if os.path.exists(jax_selections):
        with open(jax_selections) as fh:
            text += "\n" + section_selections(
                stages, json.load(fh)["records"], "rainbow")[0]
    put_section(acceptance, RAINBOW_SECTION, text)
    return text.split("**Verdict: the port's Rainbow curve ")[1].split()[0]


# --- the DDPG comparison at the reference's budget ------------------------

def jax_reference_rows() -> List[dict]:
    """The JAX package's EVALUATE_DDPG rows of ``DDPG_REFERENCE`` in
    ``run_data.csv``, with their line numbers."""
    from paper_table_torch import JAX_CSV, read_rows
    return [r for r in read_rows(JAX_CSV)
            if r.get("LOG_DIR") == DDPG_REFERENCE
            and r.get("TASK") == "EVALUATE_DDPG"]


def _boundaries(record: dict) -> str:
    """A record's segments: the rounds and frames where each ended."""
    return "; ".join(f"{s['rounds_to']} rounds, {s['frames']:,} frames"
                     for s in record.get("segments", [])) or "-"


def section_ddpg(port: Dict[int, tuple], jax: Dict[int, tuple],
                 reference: dict) -> str:
    """The "DDPG learning curve, 1e6 + 1e6 frames" section."""
    score = _score(reference["final"])
    ps, js = summarize_rainbow(port, score), summarize_rainbow(jax, score)
    rows, counts_hold, verdict = decide_rainbow(ps, js)
    s1, s2 = next(iter(port.values()))
    lines = [
        DDPG_SECTION, "",
        "Generated by `python scripts/train_curve_torch.py --compare "
        "--trainer ddpg --stage both` from `run_data_torch_train.jsonl` "
        "(the port on the card, `train_curve_torch.py --run --trainer ddpg "
        "--stage 1`, then `--stage 2`, each stage carried across runs by "
        "handoffs) and `scripts/jax_ddpg_yardsticks.json` (the JAX package "
        "on the CPU, `scripts/jax_train_curve.py --trainer ddpg --stage "
        "both`). Both run the two stages of `ddpg.train` on "
        f"`{CONFIG}` at B={s1['batch']}: stage 1 at lr {s1['lr']:g}, stage "
        f"2 at lr {s2['lr']:g} from stage 1's selected snapshot, each to "
        f"{s1['frames_budget']:.0f} valid frames with a "
        f"{s1['eval_episodes']}-episode selection evaluation every "
        f"{s1['eval_every_rounds']} rounds (and of the final parameters), "
        "the selection carried into stage 2; then the final selected actor "
        f"is evaluated over {s2['final']['episodes']} episodes. Seeds: port "
        f"{sorted(port)}, JAX {sorted(jax)}.", "",
        "### Selection evaluations", ""] + _stage_evals(port, jax)
    lines += ["", "### Selected snapshots", "",
              "| side | seed | stage 1 selected at (frames), score | final "
              "selected (stage, frames), score | crash | merge | mean abs "
              "jerk | time to merge (s) | score of this evaluation | rounds "
              "(stage 1 / 2) | s per round (median, stage 1 / 2) | s per "
              "selection evaluation (median) | segments ended at (stage 1 "
              "/ 2) | where |", "| --- " * 14 + "|"]
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
                + f" | {_score(f):.4f} | {r1['rounds']} / {r2['rounds']} | "
                f"{r1['s_per_round_median']:.2f} / "
                f"{r2['s_per_round_median']:.2f} | "
                f"{statistics.median(evals):.2f} | {_boundaries(r1)} / "
                f"{_boundaries(r2)} | {_where(r2)} |")
    ref = reference["final"]
    lines += ["", "### Decision rule", "",
              "Over seeds, |mean_port - mean_JAX| must not exceed 3 "
              "sqrt(SEM_port^2 + SEM_JAX^2) (seed-to-seed SEMs) for each "
              "quantity; the score is `agents/budget.py`'s `snapshot_score` "
              "(lower is better); and the counts of seeds whose final "
              f"snapshot scores no worse than `{DDPG_REFERENCE}` may differ "
              f"by one at most. That network (the committed "
              f"`rl_mpc_lanemerging_torch/weights/{DDPG_REFERENCE}.npz`) "
              f"scores {score:.4f} over {ref['episodes']} episodes of "
              f"`{CONFIG}` at its own seed, {reference['seed']} (crash "
              f"{_stat(ref, 'crash')}, merge {_stat(ref, 'merge')}, |jerk| "
              f"{_stat(ref, 'jerk')}, time to merge {_stat(ref, 't_merge')} "
              f"s; {reference.get('card', 'CPU')}).", "",
              "| quantity | port mean ± SEM | JAX mean ± SEM | difference | "
              "3 SEM of the difference | holds |", "| --- " * 6 + "|"]
    for label, p, j, diff, bar, holds in rows:
        lines.append(f"| {label} | {_pm(p)} | {_pm(j)} | {diff:.4f} | "
                     f"{bar:.4f} | {'yes' if holds else 'no'} |")
    lines += [f"| seeds no worse than {DDPG_REFERENCE} | "
              f"{ps['no_worse']} of {ps['n']} | {js['no_worse']} of "
              f"{js['n']} | {abs(ps['no_worse'] - js['no_worse'])} | at most "
              f"1 | {'yes' if counts_hold else 'no'} |", "",
              f"**Verdict: the port's two-stage DDPG curve {verdict} with "
              "the JAX package's.**", "",
              "### The JAX package's own records of this network (context)",
              "",
              f"Its EVALUATE_DDPG rows of `{DDPG_REFERENCE}` in "
              "`run_data.csv` (they disagree with each other, and can "
              "predate the network's recommit), and the selection "
              "evaluations of 2048 episodes it logged on the TPU in "
              "`runs/ddpg_default1/scalars*.csv` (stage 1) and "
              "`runs/ddpg_default1_extended/scalars*.csv` (stage 2), B=128. "
              "None is the yardstick; the JAX rows above are.", "",
              "| run_data.csv line | episodes | crash | merge | mean abs "
              "jerk | time to merge (s) |", "| --- " * 6 + "|"]
    for row in jax_reference_rows():
        lines.append(
            f"| {row['_line']} | {row['NUM_EPISODES']} | "
            f"{float(row['crashed']):.4f} | {float(row['merged']):.4f} | "
            f"{float(row['mean_abs_jerk']):.4f} | "
            f"{float(row['time_to_merge']):.2f} |")
    lines += ["", "| stage, run | crash / merge @ frames |", "| --- | --- |"]
    for stage, (folder, lr) in enumerate(zip(DDPG_LOGGED,
                                             ("0.0002", "2e-05")), 1):
        for name, evals in logged_runs(folder, lr).items():
            lines.append(f"| {stage}, {name} | " + "; ".join(
                f"{e['crash']:.3f} / {e['merge']:.3f} @ {e['frames']:,}"
                for e in evals) + " |")
    return "\n".join(lines) + "\n"


# the quantities of stage 1 alone: its selection (score, and the crash and
# |jerk| of the evaluation that selected it) and the frames of the first
# evaluation with crash <= 0.005 and merge >= 0.995
STAGE1_METRICS = (("score", "stage 1's selection score"),
                  ("crash", "crash of the selecting evaluation"),
                  ("jerk", "mean abs jerk of the selecting evaluation"),
                  ("reach_frames", "frames to crash <= 0.005 and merge >= "
                   "0.995"))


def summarize_stage1(records: Dict[int, dict]) -> dict:
    """Per quantity of ``STAGE1_METRICS``, (mean, SEM) over the seeds; and
    how many seeds reached crash <= 0.005, merge >= 0.995."""
    cols = {"score": 0, "crash": 1, "jerk": 2}
    out = {name: _mean_sem([r["selected"]["score"][i]
                            for r in records.values()])
           for name, i in cols.items()}
    out["reach_frames"] = _mean_sem([first_reach(r["evals"],
                                                 r["frames_budget"])
                                     for r in records.values()])
    out["reached"] = sum(map(_reached, records.values()))
    out["n"] = len(records)
    return out


def section_ddpg_stage1(port: Dict[int, dict], jax: Dict[int, dict]) -> str:
    """The section while only stage 1 has run on the card: stage 1 of both
    sides under ``STAGE1_METRICS``."""
    ps, js = summarize_stage1(port), summarize_stage1(jax)
    rows, counts_hold, verdict = _rule(ps, js, STAGE1_METRICS, "reached")
    r0 = next(iter(port.values()))
    lines = [
        DDPG_SECTION, "",
        "Generated by `python scripts/train_curve_torch.py --compare "
        "--trainer ddpg --stage both` from `run_data_torch_train.jsonl` "
        "(the port on the card, `train_curve_torch.py --run --trainer ddpg "
        "--stage 1`, carried across runs by handoffs) and "
        "`scripts/jax_ddpg_yardsticks.json` (the JAX package on the CPU, "
        "`scripts/jax_train_curve.py --trainer ddpg --stage both`). "
        "**Stage 1 only**: stage 2 has not run on the card yet, so the "
        "two-stage rule (the final snapshot's crash, merge, |jerk|, time "
        "to merge and score, stage 1's score, the seeds no worse than "
        f"`{DDPG_REFERENCE}`) waits for it; until then stage 1 is held "
        "by the rule below. Both sides train "
        f"`{CONFIG}` at B={r0['batch']}, lr {r0['lr']:g}, to "
        f"{r0['frames_budget']:.0f} valid frames with a "
        f"{r0['eval_episodes']}-episode selection evaluation every "
        f"{r0['eval_every_rounds']} rounds (and of the final parameters). "
        f"Seeds: port {sorted(port)}, JAX {sorted(jax)}.", "",
        "### Selection evaluations, stage 1", "",
        "| side | seed | frames | crash | merge | mean abs jerk | time to "
        "merge (s) |", "| --- " * 7 + "|"]
    for side, recs in (("port (card)", port), ("JAX (CPU)", jax)):
        for seed in sorted(recs):
            for e in recs[seed]["evals"]:
                t = "-" if e["t_merge"] is None else f"{e['t_merge']:.2f}"
                lines.append(f"| {side} | {seed} | {e['frames']} | "
                             f"{e['crash']:.4f} | {e['merge']:.4f} | "
                             f"{e['jerk']:.4f} | {t} |")
    lines += ["", "### Stage 1's selections", "",
              "| side | seed | selected at (frames) | score | crash | mean "
              "abs jerk | first at crash <= 0.005, merge >= 0.995 (frames) "
              "| rounds | s per round (median) | s per selection "
              "evaluation (median) | segments ended at | where |",
              "| --- " * 12 + "|"]
    for side, recs in (("port", port), ("JAX", jax)):
        for seed in sorted(recs):
            r = recs[seed]
            score = r["selected"]["score"]
            reach = f"{first_reach(r['evals'], r['frames_budget']):.0f}" \
                if _reached(r) else "never"
            lines.append(
                f"| {side} | {seed} | {r['selected']['frames']} | "
                f"{score[0]:.4f} | {score[1]:.4f} | {score[2]:.4f} | {reach} "
                f"| {r['rounds']} | {r['s_per_round_median']:.2f} | "
                f"{statistics.median(r['s_per_eval']):.2f} | "
                f"{_boundaries(r)} | {_where(r)} |")
    lines += ["", "### Decision rule, stage 1", "",
              "Over seeds, |mean_port - mean_JAX| must not exceed 3 "
              "sqrt(SEM_port^2 + SEM_JAX^2) (seed-to-seed SEMs) for each "
              "quantity; the score is `agents/budget.py`'s `snapshot_score` "
              "(lower is better); frames count the budget where a seed "
              "never reaches the point; and the counts of seeds that reach "
              "it may differ by one at most.", "",
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
              f"**Verdict (stage 1): the port's DDPG stage 1 {verdict} with "
              "the JAX package's.**", ""]
    return "\n".join(lines) + "\n"


def compare_ddpg(out: str, yardsticks: str, acceptance: str,
                 jax_selections: str = JAX_SELECTIONS) -> str:
    """Write the two-stage DDPG section into ``acceptance`` (stage 1 alone
    while the port has no seed with both stages), and after it, once both
    stages have run, the port's selections under JAX's evaluator where
    ``jax_selections`` (``scripts/jax_eval_port_selections.py``'s file)
    is there; returns the verdict."""
    stages = read_stages(_lines(out), "ddpg")
    port = seeds_of(stages)
    with open(yardsticks) as fh:
        jax_stages = read_stages(json.load(fh)["records"], "ddpg")
    jax = seeds_of(jax_stages)
    reference = reference_record(out)
    selections = None
    if port and jax and reference is not None:
        text = section_ddpg(port, jax, reference)
        marker = "**Verdict: the port's two-stage DDPG curve "
        if os.path.exists(jax_selections):
            with open(jax_selections) as fh:
                selections = section_selections(
                    stages, json.load(fh)["records"])[0]
    else:
        port1 = {s: r for (s, st), r in stages.items() if st == 1}
        jax1 = {s: r for (s, st), r in jax_stages.items() if st == 1}
        if not port1 or not jax1:
            raise SystemExit(f"no stage-1 records: port {sorted(port1)}, "
                             f"JAX {sorted(jax1)}")
        text = section_ddpg_stage1(port1, jax1)
        marker = "**Verdict (stage 1): the port's DDPG stage 1 "
    put_section(acceptance, DDPG_SECTION, text)
    if selections is not None:
        put_section(acceptance, SELECTIONS_SECTION, selections)
    return text.split(marker)[1].split()[0]


# --- The custom DQN: dqn.train's 150,000 episodes, by handoffs --------------

DQN_OVERRIDES = {"TASK": "TRAIN_DQN", "LOG_DIR": "dqn_custom_default1"}
DQN_EPISODES = 150_000        # NUM_TRAINING_EPISODES
DQN_EVAL_EPISODES = 512       # max(NUM_EVALUATION_EPISODES, 512)
DQN_FINAL_EPISODES = 4000     # run_data.csv line 218's evaluation ...
DQN_FINAL_BATCH = 512         # ... at its batch
DQN_TICKS = 200               # env ticks a round, as dqn.train
DQN_STAGE = "dqn"             # the handoffs' label: seed<k>_dqn_handoff<n>
DQN_HANDOFFS = os.path.join(REPO, "runs_torch", "curve_dqn")
DQN_LOGGED = os.path.join(REPO, "runs", "dqn_custom_default1")
DQN_LINE = 218                # the selected network's row in run_data.csv
DQN_SECTION = "## Custom DQN, 150,000 episodes"
# how ``rl/replay.py::sample`` scans the PER priorities on a card, kept in
# each segment of a record: segments of "float32" came from a scan whose
# order of additions can change from call to call, and cannot be rerun bit
# for bit.  A segment saved before segments kept their scan ran under the
# float32 scan (``OLD_PER_SCAN``).
DQN_PER_SCAN = "float64"
OLD_PER_SCAN = "float32"


def segment_scans(record: dict) -> List[str]:
    """The PER scan of each segment of a custom-DQN record (a record made
    before segments kept it holds one ``per_scan`` for all)."""
    return [g.get("per_scan") or record.get("per_scan") or OLD_PER_SCAN
            for g in record["segments"]]


def _seconds(values: List[float]) -> List[float]:
    """Seconds as the records print them (to the hundredth)."""
    return [round(float(v), 2) for v in values]


def dqn_config(seed: int, batch: int, overrides=None):
    """``configs/train_default_1.json`` as
    ``scripts/train_custom_dqn_torch.py`` trains it (TASK TRAIN_DQN,
    LOG_DIR dqn_custom_default1) at ``SEED`` ``seed`` and
    ``BATCH_SCENARIOS`` ``batch``."""
    return seed_config(seed, batch, {**DQN_OVERRIDES, **(overrides or {})})


def dqn_handoff_key(seed: int, batch: int, episodes_budget: int,
                    eval_episodes: int, env_ticks: int,
                    overrides=None) -> dict:
    """What a custom-DQN handoff was written for; a load refuses any
    other."""
    return {"trainer": "dqn", "config": CONFIG, **DQN_OVERRIDES,
            "seed": seed, "batch": batch,
            "episodes_budget": int(episodes_budget),
            "eval_episodes": eval_episodes, "env_ticks": env_ticks,
            "overrides": json.dumps(overrides or {}, sort_keys=True)}


def dqn_evals(rows: List[dict], stats: List[dict]) -> List[dict]:
    """Each selection evaluation: ``final_stats`` of it, with the episodes
    trained when it ran in place of its own."""
    steps = [r["episodes"] for r in rows if "eval_crash" in r]
    return [{**s, "episodes": e} for e, s in zip(steps, stats)]


def dqn_selection_path(folder: str, seed: int) -> str:
    return os.path.join(folder, f"seed{seed}.npz")


def run_dqn_stage(seed: int, episodes: int = DQN_EPISODES,
                  batch: int = BATCH, eval_episodes: int = DQN_EVAL_EPISODES,
                  final_episodes: int = DQN_FINAL_EPISODES,
                  final_batch: int = DQN_FINAL_BATCH,
                  env_ticks: int = DQN_TICKS, handoffs: str = DQN_HANDOFFS,
                  device="cuda", overrides=None,
                  deadline: Optional[float] = None,
                  evals: Optional[int] = None,
                  resume_from: Optional[str] = None) -> Optional[dict]:
    """One segment of ``dqn.train``'s loop (``dqn.train_episodes``) for
    one seed on ``device``, to ``episodes`` episodes with an
    ``eval_episodes``-episode selection evaluation every
    ``EVALUATION_PERIOD`` episodes.  A seed with a handoff in
    ``resume_from`` (``handoffs`` by default) resumes from its last.  The
    segment ends at the start of a round right after an evaluation
    (``segment_end``: ``deadline``, on the ``time.time`` clock, or
    ``evals``); it then writes its handoff, whole, to ``handoffs`` and
    returns None.  At the stage's end it writes the selection to
    ``<handoffs>/seed<k>.npz``, evaluates it over ``final_episodes``
    episodes at ``final_batch`` scenarios as ``run_data.csv`` line 218 was
    made, removes its handoffs from ``handoffs`` and returns the record
    (without the card's fields)."""
    import torch
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch._device import (pin_fp32_matmul,
                                                  resolve_device)
    from rl_mpc_lanemerging_torch.agents import dqn
    from rl_mpc_lanemerging_torch.agents.budget import grad_steps_per_round
    from rl_mpc_lanemerging_torch.ops import st_kernel
    dev = resolve_device(device)
    pin_fp32_matmul()
    cfg = dqn_config(seed, batch, overrides)
    key = dqn_handoff_key(seed, batch, episodes, eval_episodes, env_ticks,
                          overrides)
    resume_from = resume_from or handoffs
    st_kernel.launches = 0
    t0 = time.perf_counter()
    worlds, world_rng = tasks.make_worlds(cfg, device=dev)
    state = dqn.make_train_state(cfg, worlds, world_rng, tasks.seed_of(cfg))
    grad_steps = grad_steps_per_round(cfg.TRAINING_STEPS_PER_EPISODE, batch,
                                      env_ticks)
    found = handoff_files(resume_from, seed, DQN_STAGE)
    run = Recorder("episodes")
    saved = {"loop": dqn.new_loop(), "seconds": [], "episodes_after": [],
             "eval_seconds": [], "eval_rounds": [], "eval_stats": [],
             "rows": [], "best": {}, "segments": []}
    load_s = None
    if found:
        t1 = time.perf_counter()
        saved = load_handoff(found[-1], state, key, DQN_FIELDS)
        load_s = time.perf_counter() - t1
        if os.path.exists(found[-1] + ".json"):
            with open(found[-1] + ".json") as fh:
                saved["segments"][-1].update(json.load(fh))
        for g in saved["segments"]:
            g.setdefault("per_scan", OLD_PER_SCAN)
    run.rows = saved["rows"]
    best = _device_best(saved["best"], dev)
    loop = saved["loop"]

    def sync(out):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    episodes_after = list(saved["episodes_after"])
    seconds, restore = timed_rounds(dqn, sync, frames=episodes_after,
                                    count="episodes")
    seconds.extend(saved["seconds"])
    eval_seconds, eval_rounds, eval_stats = (list(saved[k]) for k in (
        "eval_seconds", "eval_rounds", "eval_stats"))

    def evaluate(*a):
        """``dqn.eval_greedy``, timed to the end of its work, with the
        rounds done so far and its statistics kept."""
        t1 = time.perf_counter()
        agg = sync(dqn.eval_greedy(*a))
        eval_seconds.append(time.perf_counter() - t1)
        eval_rounds.append(len(seconds))
        eval_stats.append(final_stats(agg, eval_episodes))
        return agg

    def after_eval() -> int:
        """The rounds since the evaluation before, where the last round
        ran one."""
        if not eval_rounds or eval_rounds[-1] != len(seconds):
            return 0
        return eval_rounds[-1] - (eval_rounds[-2] if len(eval_rounds) > 1
                                  else 0)

    check = segment_end(seconds, eval_seconds, after_eval, deadline, evals,
                        "evaluations", "evaluation period")
    why: List[Optional[str]] = [None]

    def stop() -> bool:
        if len(seconds) > segment["rounds_from"]:   # each round, logged
            print(f"  round {len(seconds)}: {seconds[-1]:.3f} s", flush=True)
        why[0] = check()
        return why[0] is not None

    segment = {"rounds_from": len(seconds),
               "episodes_from": int(state.episodes), "load_s": load_s,
               "per_scan": DQN_PER_SCAN}
    try:
        state = dqn.train_episodes(cfg, state, episodes, grad_steps,
                                   eval_episodes, dev, run, best, loop,
                                   env_ticks=env_ticks, stop=stop,
                                   evaluate=evaluate)
    finally:
        restore()
    ended = why[0]
    segment.update(rounds_to=len(seconds), episodes=int(state.episodes),
                   wall_s=time.perf_counter() - t0,
                   k1_launches=st_kernel.launches)
    segments = saved["segments"] + [segment]
    if ended is not None:
        segment["ended"] = ended
        path = handoff_path(handoffs, seed, DQN_STAGE, len(segments))
        save_s, size = save_handoff(path, state, key, {
            "loop": loop, "seconds": seconds,
            "episodes_after": episodes_after, "eval_seconds": eval_seconds,
            "eval_rounds": eval_rounds, "eval_stats": eval_stats,
            "rows": run.rows, "best": _host_best(best),
            "segments": segments}, fields=DQN_FIELDS)
        with open(path + ".json", "w") as fh:      # the save, measured
            json.dump({"save_s": save_s, "handoff_bytes": size}, fh)
        print(f"seed {seed} dqn: segment {len(segments)} ended after "
              f"{len(seconds)} rounds at {int(state.episodes)} episodes "
              f"({ended}); handoff {size} bytes in {save_s:.2f} s; K1 "
              f"launches {st_kernel.launches}", flush=True)
        return None
    selected = best.get("params") or {
        k: v.detach().clone() for k, v in state.net.state_dict().items()}
    save_selection(dqn_selection_path(handoffs, seed), {"q": selected}, best)
    t1 = time.perf_counter()
    net = dqn._net(cfg).to(dev)
    net.load_state_dict(selected)
    fcfg = cfg.replace(BATCH_SCENARIOS=final_batch,
                       NUM_EPISODES=final_episodes)
    agg = tasks.evaluate_controller(fcfg, dqn.greedy_controller(net, fcfg),
                                    device=dev, verbose=False)
    final = {**final_stats(agg, final_episodes), "batch": final_batch}
    final_s = time.perf_counter() - t1
    for done in handoff_files(handoffs, seed, DQN_STAGE):
        for name in (done, done + ".json"):
            if os.path.exists(name):
                os.remove(name)
    return {
        "trainer": "dqn", "seed": seed, "config": CONFIG, **DQN_OVERRIDES,
        "batch": batch, "episodes_budget": episodes,
        "episodes": int(state.episodes), "rounds": len(seconds),
        "s_per_round": _seconds(seconds),
        "s_per_round_median": statistics.median(seconds[1:] or seconds),
        "episodes_per_round": [b - a for a, b in zip([0] + episodes_after,
                                                     episodes_after)],
        "env_ticks": env_ticks, "grad_steps_per_round": grad_steps,
        "grad_steps": state.grad_steps, "eval_episodes": eval_episodes,
        "s_per_eval": _seconds(eval_seconds),
        "evals": dqn_evals(run.rows, eval_stats),
        "progress": [r for r in run.rows if "epsilon" in r],
        "selected": {"episodes": best.get("episodes"),
                     "score": None if best.get("score") is None
                     else [_num(x) for x in best["score"]]},
        "final": final, "final_s": final_s, "segments": segments,
        "train_s": sum(s["wall_s"] for s in segments),
        "wall_s": sum(s["wall_s"] for s in segments) + final_s,
        "k1_launches": sum(s.get("k1_launches") or 0
                           for s in segments[:-1]) + st_kernel.launches,
        "torch": torch.__version__}


def peek_handoff(path: str) -> dict:
    """A custom-DQN handoff's fields other than the train state (its key,
    loop counters, seconds, evaluations, log, selection and segments) and
    the state's grad steps, without a state to load it into."""
    import torch
    data = torch.load(path, map_location="cpu", weights_only=True)
    state = data.pop("state")
    data["grad_steps"] = state["grad_steps"]
    data["state_draws_bytes"] = int(state["draws"].numel())
    return _unsqueeze(data)


CARD_GENERATOR_BYTES = 16     # a CUDA generator's state: seed, offset


class _HeldGeneratorState:
    """Stands in for a card's ``torch.Generator`` on the CPU: keeps the
    state it is given."""

    def set_state(self, state) -> None:
        self.state = state


def check_handoffs(folder: str, seeds=SEEDS, batch: int = BATCH,
                   episodes: int = DQN_EPISODES,
                   eval_episodes: int = DQN_EVAL_EPISODES,
                   env_ticks: int = DQN_TICKS) -> Dict[int, dict]:
    """Each seed's last custom-DQN handoff in ``folder``, read by
    ``peek_handoff`` and loaded by ``load_handoff`` (with this seed's
    ``dqn_handoff_key``) into a train state on the CPU: where the stage
    stands (episodes, rounds, grad steps, the loop's counters, the
    selection so far, the ring's fill, each segment's end).  Raises where
    a seed has no handoff or its file refuses to load."""
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch.agents import dqn
    out = {}
    for seed in seeds:
        found = handoff_files(folder, seed, DQN_STAGE)
        if not found:
            raise FileNotFoundError(f"seed {seed}: no handoff in {folder}")
        peek = peek_handoff(found[-1])
        cfg = dqn_config(seed, batch)
        worlds, world_rng = tasks.make_worlds(cfg, device="cpu")
        state = dqn.make_train_state(cfg, worlds, world_rng,
                                     tasks.seed_of(cfg))
        if peek["state_draws_bytes"] == CARD_GENERATOR_BYTES:
            # a card's Philox state, which only a card's generator takes
            state.draws.generator = _HeldGeneratorState()
        saved = load_handoff(found[-1], state, dqn_handoff_key(
            seed, batch, episodes, eval_episodes, env_ticks), DQN_FIELDS)
        best = saved["best"]
        out[seed] = {
            "handoff": os.path.basename(found[-1]),
            "episodes": int(state.episodes),
            "rounds": len(saved["seconds"]),
            "grad_steps": int(state.grad_steps),
            **{k: int(v) for k, v in saved["loop"].items()},
            "best_score": best.get("score"),
            "best_episodes": best.get("episodes"),
            "ring_fill": int(state.replay.size),
            "draws_bytes": peek["state_draws_bytes"],
            "segments": [(g["rounds_to"], g["episodes"])
                         for g in peek["segments"]]}
    return out


def dqn_progress(folder: str, seeds=SEEDS) -> Dict[int, dict]:
    """Each seed's last handoff in ``folder`` as a partial record
    (``"partial": true``): the episodes and rounds so far, the seconds of
    each round and evaluation, the evaluations, the selection so far and
    the segments."""
    out = {}
    for seed in seeds:
        found = handoff_files(folder, seed, DQN_STAGE)
        if not found:
            continue
        data = peek_handoff(found[-1])
        segments = data["segments"]
        if os.path.exists(found[-1] + ".json"):
            with open(found[-1] + ".json") as fh:
                segments[-1].update(json.load(fh))
        for g in segments:
            g.setdefault("per_scan", OLD_PER_SCAN)
        best = data["best"]
        out[seed] = {"trainer": "dqn", "partial": True, "seed": seed,
                     **{k: data["key"][k] for k in ("config", "TASK",
                                                    "batch",
                                                    "episodes_budget")},
                     "episodes": segments[-1]["episodes"],
                     "rounds": len(data["seconds"]),
                     "s_per_round": _seconds(data["seconds"]),
                     "s_per_round_median": statistics.median(
                         data["seconds"][1:] or data["seconds"]),
                     "episodes_per_round": [b - a for a, b in zip(
                         [0] + data["episodes_after"],
                         data["episodes_after"])],
                     "grad_steps": data["grad_steps"],
                     "s_per_eval": _seconds(data["eval_seconds"]),
                     "evals": dqn_evals(data["rows"], data["eval_stats"]),
                     "progress": [r for r in data["rows"] if "epsilon" in r],
                     "selected": {"episodes": best.get("episodes"),
                                  "score": best.get("score")},
                     "segments": segments,
                     "handoff": os.path.basename(found[-1]),
                     "k1_launches": sum(g.get("k1_launches") or 0
                                        for g in segments)}
    return out


def logged_dqn(folder: str = DQN_LOGGED) -> List[dict]:
    """The JAX package's selection evaluations of ``dqn.train`` at
    150,000 episodes, logged on the TPU in ``scalars.csv``: under the
    progress header (step, epsilon, loss) an evaluation row is (episodes,
    crash, |jerk|, merge), its keys sorted."""
    with open(os.path.join(folder, "scalars.csv"), newline="") as fh:
        return [{"episodes": int(row[0]), "crash": float(row[1]),
                 "jerk": float(row[2]), "merge": float(row[3])}
                for row in list(csv.reader(fh))[1:] if len(row) == 4]


def jax_dqn_row() -> dict:
    """``run_data.csv`` line 218: the JAX package's selected custom DQN
    over 4000 episodes at B=512."""
    from paper_table_torch import JAX_CSV, read_rows
    return next(r for r in read_rows(JAX_CSV) if r["_line"] == DQN_LINE)


def first_clean(evals: List[dict]) -> Optional[int]:
    """The episodes of the first evaluation with crash 0 and merge 1."""
    return next((int(e["episodes"]) for e in evals
                 if e["crash"] == 0.0 and e["merge"] == 1.0), None)


def prediction_interval(values: List[float], k: float = 3.0) -> tuple:
    """mean ± k SD sqrt(1 + 1/n) of ``values`` (sample SD): where one more
    draw of the same kind falls."""
    n = len(values)
    mean = statistics.fmean(values)
    half = k * statistics.stdev(values) * math.sqrt(1 + 1 / n)
    return mean - half, mean + half


def decide_dqn(finals: List[dict], reach: List[Optional[int]],
               line: dict, jax_reach: int) -> dict:
    """The rule for the custom DQN's four port seeds against the one JAX
    run: (1) at least 3 of 4 final evaluations reach crash <= 0.005 and
    merge >= 0.995; (2) line 218's |jerk| and time to merge lie within the
    port seeds' prediction intervals; (3) JAX's first episode of crash 0
    and merge 1 lies within the port seeds' interval of theirs, reported
    and not decided where fewer than 2 port seeds reach it.  Returns each
    part and the verdict."""
    learned = sum(1 for f in finals if _learned(f))
    parts = {"learned": {"count": learned, "of": len(finals),
                         "holds": learned >= len(finals) - 1}}
    for name, metric in (("jerk", "mean_abs_jerk"),
                         ("t_merge", "time_to_merge")):
        values = [f[name] for f in finals if f.get(name) is not None]
        lo, hi = prediction_interval(values) if len(values) > 1 \
            else (math.nan, math.nan)
        jax = float(line[metric])
        parts[name] = {"jax": jax, "interval": [lo, hi],
                       "holds": lo <= jax <= hi}
    reached = [r for r in reach if r is not None]
    if len(reached) >= 2:
        lo, hi = prediction_interval(reached)
        parts["reach"] = {"jax": jax_reach, "interval": [lo, hi],
                          "reached": len(reached),
                          "holds": lo <= jax_reach <= hi}
    else:
        parts["reach"] = {"jax": jax_reach, "interval": None,
                          "reached": len(reached), "holds": None}
    agrees = all(p["holds"] is not False for p in parts.values())
    return {**parts, "verdict": "agrees" if agrees else "differs"}


def _span(first: int, last: int) -> str:
    return f"segment {first}" if first == last else \
        f"segments {first}-{last}"


def _yes(holds: Optional[bool]) -> str:
    return "-" if holds is None else "yes" if holds else "no"


def _eval_cell(e: Optional[dict]) -> str:
    if e is None:
        return "-"
    return f"{e['episodes']:,}: {e['crash']:.4f} / {e['merge']:.4f} / " \
        f"{e['jerk']:.3f}"


def section_dqn(records: Dict[int, dict], progress: Dict[int, dict],
                jax: List[dict], line: dict) -> tuple:
    """The "Custom DQN, 150,000 episodes" section, and its verdict (None
    while the stage has not ended for every seed)."""
    seeds = sorted(set(records) | set(progress))
    sides = {s: records.get(s) or progress[s] for s in seeds}
    jax_reach = first_clean(jax)
    ended = bool(seeds) and all(s in records for s in seeds) \
        and len(seeds) == len(SEEDS)
    lines = [
        DQN_SECTION, "",
        "Generated by `python scripts/train_curve_torch.py --compare "
        "--trainer dqn` from the port's custom-DQN records in "
        "`run_data_torch_train.jsonl` (seeds 0-3 of "
        "`configs/train_default_1.json` with TASK TRAIN_DQN at B=128, "
        f"rounds of {DQN_TICKS} ticks, `dqn.train_episodes` on the card, "
        "carried across chip calls by handoffs), or, while a seed's stage "
        "runs, from the record of its last segment; and from the "
        "JAX package's one run of `dqn.train` to 150,000 episodes "
        f"(`runs/dqn_custom_default1/scalars.csv`, {len(jax)} evaluations "
        "of 512 episodes on a TPU; its selected network is "
        f"`run_data.csv` line {DQN_LINE}, 4000 episodes at B=512).", "",
        "**The rule, written before the first segment.** The JAX side is "
        "one run, so the port's four seeds give a prediction interval, mean "
        "± 3 SD sqrt(1 + 1/4): (1) at least 3 of 4 port seeds' final "
        "4000-episode evaluations (B=512) reach crash <= 0.005 and merge "
        f">= 0.995; (2) line {DQN_LINE}'s |jerk| and time to merge lie "
        "within the port seeds' intervals; (3) the episode at which JAX "
        "first evaluates crash 0 and merge 1 lies within the port seeds' "
        "interval of the same, reported and not decided where fewer than 2 "
        "port seeds reach it.", "",
        "| seed | episodes | rounds | segments (rounds, episodes) | s per "
        "round (median) | s per evaluation (median) | first crash 0, merge "
        "1 | selected @ episodes | final crash | final merge | final "
        "\\|jerk\\| | final time to merge (s) | card |",
        "| --- " * 13 + "|"]
    for s in seeds:
        r = sides[s]
        final = r.get("final") or {}
        segs = "; ".join(f"{g['rounds_to']}, {g['episodes']:,}"
                         for g in r["segments"])
        lines.append(
            f"| {s} | {r['episodes']:,} | {r['rounds']} | {segs} | "
            f"{r['s_per_round_median']:.2f} | "
            f"{statistics.median(r['s_per_eval']):.2f} | "
            f"{first_clean(r['evals']) or '-'} | "
            f"{(r.get('selected') or {}).get('episodes') or '-'} | "
            f"{_stat(final, 'crash')} | {_stat(final, 'merge')} | "
            f"{_stat(final, 'jerk')} | {_stat(final, 't_merge')} | "
            f"{r.get('card', '-')} |")
    scans = {s: segment_scans(sides[s]) for s in seeds}
    old_scan = [s for s in seeds if set(scans[s]) == {OLD_PER_SCAN}]
    if old_scan:
        lines += ["", "Seeds " + ", ".join(map(str, old_scan)) + ": records "
                  "made while `rl/replay.py::sample` scanned the PER "
                  "priorities in float32 on the card, in an order of "
                  "additions that can change from call to call: their "
                  "segments cannot be rerun bit for bit (`\"per_scan\": "
                  "\"float32\"`; the scan is float64 on the card since)."]
    stitched: Dict[tuple, List[int]] = {}   # (float32 segments, all): seeds
    for s in seeds:
        if OLD_PER_SCAN in scans[s] and s not in old_scan:
            stitched.setdefault((scans[s].count(OLD_PER_SCAN),
                                 len(scans[s])), []).append(s)
    if stitched:
        lines += ["", "The stage stitches two scans of the PER priorities on "
                  "the card (each segment's `\"per_scan\"`): " + "; ".join(
                      f"seed{'s' if len(ss) > 1 else ''} "
                      f"{', '.join(map(str, ss))}, {_span(1, n)} float32 and "
                      f"{_span(n + 1, total)} float64"
                      for (n, total), ss in stitched.items()) + ". The float32 "
                  "scan added in an order that can change from call to call, so "
                  "those segments cannot be rerun bit for bit; each later "
                  "segment resumed from the handoff before it and, its scan "
                  "exact, reruns bit for bit from there. The stage as a whole "
                  "cannot be rerun bit for bit."]
    lines += ["", f"JAX: first crash 0, merge 1 at {jax_reach:,} episodes; "
              f"line {DQN_LINE}: crash {float(line['crashed']):.4f}, merge "
              f"{float(line['merged']):.4f}, |jerk| "
              f"{float(line['mean_abs_jerk']):.4f} ± "
              f"{float(line['mean_abs_jerk_std']):.4f}, time to merge "
              f"{float(line['time_to_merge']):.3f} ± "
              f"{float(line['time_to_merge_std']):.3f} s.", ""]
    verdict = None
    if ended:
        finals = [records[s]["final"] for s in seeds]
        d = decide_dqn(finals, [first_clean(records[s]["evals"])
                                for s in seeds], line, jax_reach)
        verdict = d["verdict"]
        iv = {k: d[k]["interval"] for k in ("jerk", "t_merge", "reach")}
        lines += [
            "| part | JAX | port | holds |", "| --- | --- | --- | --- |",
            f"| (1) seeds with crash <= 0.005, merge >= 0.995 | 1 of 1 | "
            f"{d['learned']['count']} of {d['learned']['of']} | "
            f"{_yes(d['learned']['holds'])} |",
            f"| (2) \\|jerk\\| | {d['jerk']['jax']:.4f} | "
            f"{iv['jerk'][0]:.4f} to {iv['jerk'][1]:.4f} | "
            f"{_yes(d['jerk']['holds'])} |",
            f"| (2) time to merge (s) | {d['t_merge']['jax']:.3f} | "
            f"{iv['t_merge'][0]:.3f} to {iv['t_merge'][1]:.3f} | "
            f"{_yes(d['t_merge']['holds'])} |",
            f"| (3) first crash 0, merge 1 (episodes) | {jax_reach:,} | "
            + (f"{iv['reach'][0]:,.0f} to {iv['reach'][1]:,.0f}"
               if iv["reach"] else
               f"{d['reach']['reached']} of 4 reach: not decided")
            + f" | {_yes(d['reach']['holds'])} |",
            "", f"**Verdict: the port's custom DQN {verdict} with the JAX "
            "package's.**", ""]
    else:
        lines += ["**Not decided: the stage has not ended for every seed "
                  "(the rule is decided in the run that ends it).**", ""]
    evals = {s: sides[s]["evals"] for s in seeds}
    n = max([len(jax)] + [len(v) for v in evals.values()])
    lines += ["Each evaluation, in order (episodes: crash / merge / "
              "\\|jerk\\|, 512 episodes at the evaluation tick):", "",
              "| # | JAX | " + " | ".join(f"port seed {s}" for s in seeds)
              + " |", "| --- " * (2 + len(seeds)) + "|"]
    for i in range(n):
        cells = [_eval_cell(jax[i] if i < len(jax) else None)] + [
            _eval_cell(evals[s][i] if i < len(evals[s]) else None)
            for s in seeds]
        lines.append(f"| {i + 1} | " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n", verdict


def compare_dqn(out: str, acceptance: str) -> str:
    """Write the custom-DQN section into ``acceptance``; returns its
    verdict ("is not decided yet" while a seed's stage runs)."""
    records = {s: r for (s, _), r in read_stages(_lines(out), "dqn").items()}
    progress = {s: p for (s, _), p in read_stages(_lines(out), "dqn",
                                                  partial=True).items()
                if s not in records}
    if not records and not progress:
        raise SystemExit(f"no custom-DQN record in {out}")
    text, verdict = section_dqn(records, progress, logged_dqn(),
                                jax_dqn_row())
    put_section(acceptance, DQN_SECTION, text)
    return verdict or "is not decided yet"


# --- DDPG: the port's selections under JAX's evaluator ---------------------

SELECTION_METRICS = ("crash", "merge", "jerk", "t_merge", "score")


def _rate_sem(p: float, n: int) -> float:
    """The aggregator's SEM of a rate ``p`` over ``n`` episodes (sample
    SD over sqrt(n))."""
    return math.sqrt(p * (1 - p) * n / (n - 1) / n) if n > 1 else 0.0


def _score_sem(e: dict, n: int) -> float:
    """The SEM of ``snapshot_score``'s first term, from its parts'
    (timeouts a rate of their own)."""
    timeout = max(1.0 - e["merge"] - e["crash"], 0.0)
    return math.sqrt(e["crash_sem"] ** 2 + 0.04 * _rate_sem(timeout, n) ** 2
                     + 1e-4 * e["jerk_sem"] ** 2
                     + 4e-6 * (e["t_merge_sem"] or 0.0) ** 2)


def port_selection_eval(stages: Dict[tuple, dict], seed: int,
                        stage: int) -> Optional[dict]:
    """The port's own evaluation of a seed's stage selection: the record's
    evaluation at the selection's frames (stage 1's, where stage 2 kept
    stage 1's selection), or None where there is none."""
    sel = stages[(seed, stage)]["selected"]
    record = stages.get((seed, sel["stage"]), {})
    return next((e for e in record.get("evals", [])
                 if e["frames"] == sel["frames"]), None)


def hold_selection(port: dict, jax: dict, n: int) -> dict:
    """Per metric of ``SELECTION_METRICS``: port, JAX, the difference's SEM
    (the port's records keep means alone: rates take their binomial SEM,
    |jerk| and time to merge the JAX evaluation's) and whether |port -
    JAX| <= 3 SEM."""
    p = {"crash": port["crash"], "merge": port["merge"],
         "jerk": port["jerk"], "t_merge": port["t_merge"]}
    p.update(crash_sem=_rate_sem(p["crash"], n),
             merge_sem=_rate_sem(p["merge"], n), jerk_sem=jax["jerk_sem"],
             t_merge_sem=jax["t_merge_sem"])
    from rl_mpc_lanemerging_torch.agents.budget import snapshot_score
    p["score"] = snapshot_score(p["crash"], p["merge"], p["jerk"],
                                p["t_merge"])[0]
    out = {}
    for m in SELECTION_METRICS:
        if m == "score":
            pv, jv = p["score"], jax["score"][0]
            sem = math.hypot(_score_sem(p, n), _score_sem(jax, n))
        else:
            pv, jv = p[m], jax[m]
            sem = math.hypot(p[m + "_sem"] or 0.0, jax[m + "_sem"] or 0.0)
        out[m] = {"port": pv, "jax": jv, "sem": sem,
                  "holds": abs(pv - jv) <= 3 * sem}
    return out


# each trainer's text around the table of ``section_selections``: its
# heading, what generated it, and its two verdicts
SELECTIONS_TEXT = {
    "ddpg": (SELECTIONS_SECTION, (
        "Generated by `python scripts/train_curve_torch.py --compare "
        "--trainer ddpg` from `scripts/jax_eval_port_selections.json` "
        "(`python scripts/jax_eval_port_selections.py`: each committed "
        "selection `scripts/curve_ddpg_stage<s>/seed<k>_stage<s>.npz` loaded "
        "into the JAX actor and evaluated on the CPU by JAX's evaluator as a "
        "selection is, 2048 episodes at B=128 and `SEED` k) and the port's "
        "own evaluation of the same network in its stage record. A network "
        "holds where each of crash, merge, \\|jerk\\|, time to merge and the "
        "selection score lies within 3 SEM of the difference, SEM = "
        "sqrt(SEM_JAX^2 + SEM_port^2); the port's records keep means alone, "
        "so its crash and merge take their binomial SEM and its \\|jerk\\| "
        "and time to merge the JAX evaluation's, and a score's SEM combines "
        "its parts' by `snapshot_score`'s weights. At least 7 of 8 holding "
        "puts DDPG's \"differs\" on the selection at four seeds; fewer, on "
        "the port's evaluation path. Cells: port / JAX."),
        ("selection at four seeds: JAX's evaluator scores the port's "
         "networks as the port's does",
         "the port's evaluation path differs from JAX's")),
    "rainbow": ("### The port's selections under JAX's evaluator", (
        "From `scripts/jax_eval_port_rainbow.json` (`python "
        "scripts/jax_eval_port_selections.py --trainer rainbow`: each of the "
        "port's selections `runs_torch/curve_rainbow/seed<k>_stage<s>.npz` "
        "loaded into the JAX Rainbow network and evaluated on the CPU by "
        "JAX's evaluator as a selection is, 1024 episodes at B=128 and "
        "`SEED` k) and the port's own evaluation of the same network in its "
        "stage record, by DDPG's rule: a network holds where each of crash, "
        "merge, \\|jerk\\|, time to merge and the selection score lies "
        "within 3 SEM of the difference (the port's crash and merge take "
        "their binomial SEM, its \\|jerk\\| and time to merge the JAX "
        "evaluation's). At least 7 of 8 holding puts a difference of the "
        "curves on training and selection; fewer, on the port's evaluation "
        "path. Cells: port / JAX."),
        ("JAX's evaluator scores the port's networks as the port's does",
         "the port's evaluation path differs from JAX's")),
}


def section_selections(stages: Dict[tuple, dict], jax: List[dict],
                       trainer: str = "ddpg") -> tuple:
    """The section (for Rainbow, the subsection) "The port's selections
    under JAX's evaluator" of ``trainer`` and the count of networks that
    hold."""
    heading, intro, verdicts = SELECTIONS_TEXT[trainer]
    lines = [
        heading, "", intro, "",
        "| seed | stage | selected (stage, frames) | crash | merge | "
        "\\|jerk\\| | time to merge (s) | score | holds |",
        "| --- " * 9 + "|"]
    held = total = 0
    for r in sorted(jax, key=lambda r: (r["stage"], r["seed"])):
        seed, stage = r["seed"], r["stage"]
        port = port_selection_eval(stages, seed, stage) \
            if (seed, stage) in stages else None
        if port is None:
            continue
        total += 1
        h = hold_selection(port, r["eval"], r["eval"]["episodes"])
        ok = all(v["holds"] for v in h.values())
        held += ok
        sel = stages[(seed, stage)]["selected"]
        lines.append(
            f"| {seed} | {stage} | {sel['stage']}, {sel['frames']:,} | "
            + " | ".join(f"{h[m]['port']:.4f} / {h[m]['jax']:.4f}"
                         + ("" if h[m]["holds"] else " (flagged)")
                         for m in SELECTION_METRICS)
            + f" | {'yes' if ok else 'no'} |")
    finals = [r for r in jax if "final" in r and (r["seed"], 2) in stages]
    if finals:
        lines += ["", "The stage-2 selections' final evaluations, 1024 "
                  "episodes at the config's tick, reported (port / JAX, "
                  "mean ± SEM):", "",
                  "| seed | crash | merge | \\|jerk\\| | time to merge (s) |",
                  "| --- " * 5 + "|"]
        for r in sorted(finals, key=lambda r: r["seed"]):
            f = stages[(r["seed"], 2)]["final"]
            lines.append(f"| {r['seed']} | " + " | ".join(
                f"{_stat(f, m)} / {_stat(r['final'], m)}"
                for m in ("crash", "merge", "jerk", "t_merge")) + " |")
    verdict = verdicts[0] if held >= total - 1 else verdicts[1]
    lines += ["", f"**{held} of {total} networks hold: {verdict}.**", ""]
    return "\n".join(lines) + "\n", held


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--run", action="store_true",
                      help="train the seeds on the card")
    mode.add_argument("--compare", action="store_true",
                      help="apply the decision rule and write its section")
    mode.add_argument("--peek", action="store_true",
                      help="dqn: read each seed's last handoff in "
                      "--resume-from (runs_torch/curve_dqn) into a train "
                      "state on the CPU and print where its stage stands")
    mode.add_argument("--export", action="store_true",
                      help="write each seed's DDPG stage-2 selection "
                      "(scripts/curve_ddpg_stage2) as the network of "
                      "MODEL_NAME runs/curve_ddpg_seed<k>_extended")
    ap.add_argument("--trainer", choices=("ddpg", "rainbow", "dqn"),
                    default="ddpg")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--frames", type=float, default=None,
                    help="valid frames (per stage): 4e5 (ddpg stage 1 "
                    "alone), 1e6 (ddpg --stage, rainbow)")
    ap.add_argument("--stage", choices=("1", "2", "both"), default=None,
                    help="rainbow: the stage to run (1 by default); ddpg: "
                    "the stage of ddpg.train to run, carried across runs "
                    "by handoffs (without it, the 4e5-frame stage-1 "
                    "curve); --compare --trainer ddpg --stage both: the "
                    "two-stage comparison")
    ap.add_argument("--episodes", type=int, default=None,
                    help="rainbow: episodes of each selection evaluation "
                    "and of the final one (1024); ddpg --stage: of each "
                    "selection evaluation (2048); dqn: of each selection "
                    "evaluation (512)")
    ap.add_argument("--train-episodes", type=int, default=DQN_EPISODES,
                    help="dqn: the stage's training episodes (150000)")
    ap.add_argument("--snapshots", default=SNAPSHOTS, metavar="DIR",
                    help="rainbow: where stage 1 leaves its selected "
                    "snapshots and stage 2 finds them")
    ap.add_argument("--handoffs", default=None, metavar="DIR",
                    help="ddpg --stage: where each seed's handoff and stage "
                    "1's selection are written and found "
                    "(runs_torch/curve_ddpg); dqn: where each seed's "
                    "handoff and selection are written "
                    "(runs_torch/curve_dqn)")
    ap.add_argument("--resume-from", default=None, metavar="DIR",
                    help="ddpg --stage, dqn: where each seed's handoffs "
                    "(and, for DDPG's stage 2, stage 1's selection) are "
                    "found, if not in --handoffs: a run can then bring back "
                    "only what it writes")
    ap.add_argument("--time-limit", type=float, default=None,
                    metavar="SECONDS",
                    help="ddpg --stage, dqn: end each seed's segment, with "
                    "a handoff, before this many seconds from the start")
    ap.add_argument("--handoff-after-blocks", type=int, default=None,
                    metavar="N", help="ddpg --stage: end each seed's "
                    "segment, with a handoff, after N blocks of 5 rounds")
    ap.add_argument("--handoff-after-evals", type=int, default=None,
                    metavar="N", help="dqn: end each seed's segment, with a "
                    "handoff, after N selection evaluations")
    ap.add_argument("--deadline", type=float, default=None,
                    help=argparse.SUPPRESS)   # set in a spawned seed
    ap.add_argument("--concurrent", type=int, default=1,
                    help=argparse.SUPPRESS)   # set in a spawned seed
    ap.add_argument("--out", default=OUT, metavar="PATH")
    ap.add_argument("--yardsticks", default=None, metavar="PATH")
    ap.add_argument("--acceptance", default=ACCEPTANCE, metavar="PATH")
    args = ap.parse_args(argv)
    if args.export:
        for seed in args.seeds:
            model = CURVE_MODEL.format(seed)
            path = export_selection(snapshot_path(
                SELECTIONS, seed, check=True, stage=2), model)
            print(f"seed {seed}: MODEL_NAME {model} -> {path}")
        return
    rainbow = args.trainer == "rainbow"
    staged = args.trainer == "ddpg" and args.stage is not None
    deadline = args.deadline
    if deadline is None and args.time_limit is not None:
        deadline = time.time() + args.time_limit
    if args.peek:
        if args.trainer != "dqn":
            ap.error("--peek reads custom-DQN handoffs: --trainer dqn")
        folder = args.resume_from or args.handoffs or DQN_HANDOFFS
        for seed, seen in check_handoffs(folder, args.seeds).items():
            print(f"seed {seed}: " + json.dumps(seen), flush=True)
        return
    if args.trainer == "dqn":
        if args.compare:
            verdict = compare_dqn(args.out, args.acceptance)
            print(f"wrote the section of {args.acceptance}: the port's "
                  f"custom DQN {verdict} with the JAX package's")
        else:
            run(args.seeds, args.train_episodes, args.out, args.concurrent,
                dqn_args=dict(
                    eval_episodes=args.episodes or DQN_EVAL_EPISODES,
                    handoffs=os.path.abspath(args.handoffs or DQN_HANDOFFS),
                    deadline=deadline, evals=args.handoff_after_evals,
                    resume_from=args.resume_from and os.path.abspath(
                        args.resume_from)))
        return
    if args.compare:
        if staged and args.stage != "both":
            ap.error("--compare --trainer ddpg takes --stage both or none")
        yardsticks = args.yardsticks or (
            RAINBOW_YARDSTICKS if rainbow
            else DDPG_YARDSTICKS if staged else YARDSTICKS)
        verdict = (compare_rainbow if rainbow else compare_ddpg if staged
                   else compare)(args.out, yardsticks, args.acceptance)
        print(f"wrote the section of {args.acceptance}: the port's "
              f"{args.trainer} curve {verdict} with the JAX package's")
        return
    if args.stage == "both":
        ap.error("--run takes --stage 1 or 2")
    if rainbow:
        run(args.seeds, args.frames or RAINBOW_FRAMES, args.out,
            args.concurrent,
            dict(stage=int(args.stage or 1),
                 episodes=args.episodes or RAINBOW_EPISODES,
                 snapshots=os.path.abspath(args.snapshots)))
    elif staged:
        run(args.seeds, args.frames or DDPG_FRAMES, args.out,
            args.concurrent, ddpg_args=dict(
                stage=int(args.stage),
                eval_episodes=args.episodes or EVAL_EPISODES,
                handoffs=os.path.abspath(args.handoffs or HANDOFFS),
                deadline=deadline,
                blocks=args.handoff_after_blocks,
                resume_from=args.resume_from and os.path.abspath(
                    args.resume_from)))
    else:
        run(args.seeds, args.frames or FRAMES, args.out, args.concurrent)


if __name__ == "__main__":
    main()
