"""The port's DDPG learning curve on the card, seed by seed, and its
comparison with the JAX package's curve on the CPU.

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


def timed_rounds(module, sync):
    """Wrap ``module.train_round`` so that each call is timed to the end of
    its work (``sync`` waits for it); returns the list the seconds go to and
    the function that puts the real one back."""
    real = module.train_round
    seconds: List[float] = []

    def train_round(*a, **kw):
        t0 = time.perf_counter()
        out = sync(real(*a, **kw))
        seconds.append(time.perf_counter() - t0)
        return out

    module.train_round = train_round

    def restore():
        module.train_round = real
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


def seed_config(seed: int, batch: int, overrides=None):
    from rl_mpc_lanemerging_torch.config import Settings
    return Settings.load_from_file(os.path.join(REPO, CONFIG)).replace(
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


def read_records(path: str) -> Dict[int, dict]:
    """The newest record of each seed in a JSONL file."""
    out: Dict[int, dict] = {}
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                if line.strip():
                    r = json.loads(line)
                    out[int(r["seed"])] = r
    return out


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


def run_one(seed: int, frames: float, out: str, concurrent: int) -> dict:
    """One seed on the card, ``concurrent`` seeds sharing it; appends and
    returns its record."""
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // concurrent))
    torch.cuda.reset_peak_memory_stats()
    record = run_seed(seed, frames)
    record.update(card=card_line(), device=torch.cuda.get_device_name(0),
                  concurrent_seeds=concurrent,
                  max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    append_record(out, record)
    f = record["final"]
    print(f"seed {seed}: {record['card']}; {record['frames']} frames in "
          f"{record['rounds']} rounds, {record['s_per_round_median']:.2f} s "
          f"per round ({concurrent} seeds at once); selected @ "
          f"{record['selected']['frames']}: crash {f['crash']:.4f} merge "
          f"{f['merge']:.4f} |jerk| {f['jerk']:.4f} over {f['episodes']} "
          f"episodes; K1 launches {record['k1_launches']}", flush=True)
    if record["k1_launches"]:
        raise RuntimeError(f"seed {seed}: K1 launched "
                           f"{record['k1_launches']} times in training")
    return record


def spawn(seeds: List[int], frames: float, out: str) -> None:
    """Every seed at once, each in a process of its own that logs to
    ``train_curve_seed<seed>.log`` beside ``out``."""
    out_dir = os.path.dirname(os.path.abspath(out))
    procs = []
    try:
        for seed in seeds:
            log = open(os.path.join(out_dir, f"train_curve_seed{seed}.log"),
                       "w")
            procs.append((seed, log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--run",
                 "--seeds", str(seed), "--frames", str(frames), "--out", out,
                 "--concurrent", str(len(seeds))],
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO)))
        failed = [seed for seed, _, proc in procs if proc.wait()]
    finally:
        for _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        raise RuntimeError(f"seeds {failed} failed; see their logs in "
                           f"{out_dir}")


def run(seeds: List[int], frames: float, out: str, concurrent: int) -> None:
    """The seeds without a record in ``out``: one in this process, several
    at once in processes of their own (``concurrent`` is set in those)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("--run trains on the card: "
                           "torch.cuda.is_available() is False")
    todo = pending(seeds, out, frames)
    print(f"{card_line()}; {len(seeds) - len(todo)} of {len(seeds)} seeds "
          f"already in {out}", flush=True)
    if len(todo) > 1:
        spawn(todo, frames, out)
    elif todo:
        run_one(todo[0], frames, out, concurrent)


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--run", action="store_true",
                      help="train the seeds on the card")
    mode.add_argument("--compare", action="store_true",
                      help="apply the decision rule and write its section")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--frames", type=float, default=FRAMES)
    ap.add_argument("--concurrent", type=int, default=1,
                    help=argparse.SUPPRESS)   # set in a spawned seed
    ap.add_argument("--out", default=OUT, metavar="PATH")
    ap.add_argument("--yardsticks", default=YARDSTICKS, metavar="PATH")
    ap.add_argument("--acceptance", default=ACCEPTANCE, metavar="PATH")
    args = ap.parse_args(argv)
    if args.compare:
        verdict = compare(args.out, args.yardsticks, args.acceptance)
        print(f"wrote the section of {args.acceptance}: the port's curve "
              f"{verdict} with the JAX package's")
    else:
        run(args.seeds, args.frames, args.out, args.concurrent)


if __name__ == "__main__":
    main()
