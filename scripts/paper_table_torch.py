"""Run the paper's result table through the PyTorch port on the card, and
compare it with the JAX package's rows.

The port's counterpart of the JAX side's table scripts
(``scripts/queue_r*.sh``, ``scripts/compare_baseline.py``).

    python scripts/paper_table_torch.py --run [NAME ...] [--family F ...]
        [--episodes 1024] [--csv run_data_torch.csv]
    python scripts/paper_table_torch.py --compare [--csv run_data_torch.csv]
        [--out ACCEPTANCE_TORCH.md]
    python scripts/paper_table_torch.py --dqn-chain [--frames 2e4]
        [--episodes 256]

``--run`` evaluates each named configuration (``configs/<NAME>.json``; a
family names all of its own, no name and no family the whole table) through
the port's entry point, ``rl_mpc_lanemerging_torch.main.do_task``, on the
card; it raises without one.  Each runs at the ``BATCH_SCENARIOS`` of its
JAX row (the newest row of ``run_data.csv`` with the same ``LOG_DIR`` and at
least 1000 episodes) over ``--episodes`` episodes, and appends its stats row
to ``--csv`` through ``StatsAggregator.add_csv_data``.  Beside the row it
appends one JSON line to the CSV's ``.jsonl`` twin: the card's name and
power limit, the wall time, the evaluation's control ticks, K1's launches
and the dense DP's calls inside the controller, and
``torch.cuda.max_memory_allocated()``; it prints the same.  A configuration
whose row is already in ``--csv`` with at least the episodes asked is
skipped, so a run that is cut loses only the configuration it was in.  K1
must launch once per control tick on ST, twice on the combined and cross
configurations (``1 + TEST_ROLLOUT_STATE``), never on EVALUATE_DDPG and
EVALUATE_DQN, and the dense DP must never run in the controller while
``USE_FAST_ST_SOLVER`` is True; otherwise the run stops with an error after
recording the row.

``--compare`` matches each configuration's newest port row to its JAX row
and writes ``--out``: per family, crash, merge, mean |jerk|, time to merge
and the MPC's share of ticks, each with both SEMs, and a flag where
|port - JAX| > 3 sqrt(SEM_port^2 + SEM_JAX^2).  A JAX row recorded before
2026-08-21T09:40 (the TPU backend's fix for torn spawns at batch 1024) is
stale and not used: those configurations are held to the JAX code's own
figures on the CPU (``python scripts/jax_st_round.py 48 0 1
configs/<NAME>.json``), read from ``scripts/jax_cpu_yardsticks.json``.  It
needs no card and runs no JAX.

``--dqn-chain`` runs ``configs/train_dqn_default_1.json`` through the CLI
(``python -m rl_mpc_lanemerging_torch.main``) as TRAIN_DQN at ``--frames``
valid frames per stage, then RESUME_DQN from its extended stage, then
EVALUATE_DQN of the resumed network, each over ``--episodes`` evaluation
episodes, under LOG_DIRs of their own (``chain_rainbow_default1*``) that
shadow no converted network.  The derived configs go to
``runs_torch/chain/``.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

JAX_CSV = os.path.join(REPO, "run_data.csv")
PORT_CSV = os.path.join(REPO, "run_data_torch.csv")
ACCEPTANCE = os.path.join(REPO, "ACCEPTANCE_TORCH.md")
YARDSTICKS = os.path.join(REPO, "scripts", "jax_cpu_yardsticks.json")
MIN_JAX_EPISODES = 1000
# 0ff911c fixed the TPU backend's torn spawns at batch 1024 at this time;
# rows recorded before it are stale
STALE_BEFORE = "2026-08-21T09:40"
EPISODES = 1024

REGIMES = ("default", "fast", "low", "medium", "moderate")
FAMILIES: Dict[str, List[str]] = {
    "st": [f"st_{r}" for r in REGIMES],
    "combined": [f"combined_{r}_1{b}" for r in REGIMES for b in ("", "b")],
    "cross": [f"cross_medium_network_{t}_traffic_1"
              for t in ("fast", "heavy", "low", "moderate")]
    + [f"cross_moderate_network_{t}_traffic_1" for t in ("fast", "slow")],
    # the 17 EVALUATE_DDPG configurations that have a >= 1000-episode row
    "ddpg": [f"ddpg_moderate_network_{t}" for t in (
        "fast_traffic_1", "fast_traffic_2", "fast_traffic_3",
        "slow_traffic_1", "slow_traffic_2", "slow_traffic_3",
        "heavy_traffic_1", "low_traffic_1", "medium_traffic_1")]
    + [f"ddpg_medium_network_{t}" for t in (
        "moderate_traffic_1", "fast_traffic_1", "heavy_traffic_1",
        "heavy_traffic_2", "heavy_traffic_3", "low_traffic_1",
        "low_traffic_2", "low_traffic_3")],
    "dqn": ["train_dqn_default_1"],
}
# train_dqn_default_1's row (LOG_DIR rainbow_default1) is its TRAIN_DQN
# task's final evaluation of the extended network; the port evaluates the
# converted network of that name
OVERRIDES = {"train_dqn_default_1": dict(
    TASK="EVALUATE_DQN", MODEL_NAME="runs/rainbow_default1_extended")}
METRICS = (("crashed", "crash"), ("merged", "merge"),
           ("mean_abs_jerk", "mean abs jerk"),
           ("time_to_merge", "time to merge (s)"),
           ("percent st solver", "percent st solver"))
# the headings of the sections that scripts/train_curve_torch.py writes
CURVE_SECTION = "## DDPG learning curve"
RAINBOW_SECTION = "## Rainbow learning curve"
DDPG_SECTION = "## DDPG learning curve, 1e6 + 1e6 frames"
CHAIN_DIR = os.path.join("runs_torch", "chain")
CHAIN_LOG_DIR = "chain_rainbow_default1"


def read_rows(path: str) -> List[dict]:
    """The rows of a stats CSV, each with its line number under ``_line``
    (the header is line 1)."""
    if not os.path.exists(path):
        return []
    with open(path, newline="") as fh:
        return [dict(row, _line=i + 2)
                for i, row in enumerate(csv.DictReader(fh))]


def _episodes(row: dict) -> int:
    return int(float(row.get("NUM_EPISODES") or 0))


def newest_rows(rows: List[dict], min_episodes: int = 0) -> Dict[str, dict]:
    """The newest row (by ``TIME``) of each ``LOG_DIR`` among those with
    at least ``min_episodes`` episodes."""
    out: Dict[str, dict] = {}
    for row in rows:
        if _episodes(row) < min_episodes:
            continue
        key = row["LOG_DIR"]
        if key not in out or row["TIME"] > out[key]["TIME"]:
            out[key] = row
    return out


def is_stale(row: dict) -> bool:
    return row["TIME"] < STALE_BEFORE


def _value(row: dict, metric: str) -> Optional[float]:
    text = row.get(metric, "")
    if text in ("", None):
        return None
    v = float(text)
    return None if math.isnan(v) else v


def flagged(port: float, port_sem: float, jax: float, jax_sem: float
            ) -> bool:
    """|port - JAX| beyond 3 standard errors of the difference."""
    return abs(port - jax) > 3.0 * math.sqrt(port_sem ** 2 + jax_sem ** 2)


def config_path(name: str) -> str:
    return os.path.join(REPO, "configs", f"{name}.json")


def table_config(name: str, episodes: int, jax_rows: Dict[str, dict]):
    """The settings of one table configuration at its JAX row's batch."""
    from rl_mpc_lanemerging_torch.config import Settings
    cfg = Settings.load_from_file(config_path(name))
    cfg = cfg.replace(**OVERRIDES.get(name, {}))
    row = jax_rows.get(cfg.LOG_DIR)
    if row is None:
        raise KeyError(f"{name}: run_data.csv has no row of LOG_DIR "
                       f"{cfg.LOG_DIR} with >= {MIN_JAX_EPISODES} episodes")
    return cfg.replace(NUM_EPISODES=episodes,
                       BATCH_SCENARIOS=int(float(row["BATCH_SCENARIOS"])))


def pending(names: List[str], episodes: int, csv_path: str) -> List[str]:
    """The names whose row is not yet in ``csv_path`` with at least
    ``episodes`` episodes."""
    from rl_mpc_lanemerging_torch.config import Settings
    done = {row["LOG_DIR"] for row in read_rows(csv_path)
            if _episodes(row) >= episodes}
    return [n for n in names if Settings.load_from_file(config_path(n))
            .replace(**OVERRIDES.get(n, {})).LOG_DIR not in done]


def expected_k1_per_tick(cfg) -> int:
    if not cfg.USE_FAST_ST_SOLVER:
        return 0
    if cfg.TASK == "ST":
        return 1
    if cfg.TASK.startswith("EVALUATE_COMBINED"):
        return 1 + int(cfg.TEST_ROLLOUT_STATE)
    return 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def instrumented():
    """Counts, over the evaluation run inside: its control ticks (the
    controller's calls), its seconds, and the K1 launches and dense DP
    calls its controller made."""
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch.ops import st_dp, st_kernel
    counts = {"control_ticks": 0, "evaluation_s": 0.0, "k1_launches": 0,
              "dense_dp_calls": 0}
    real_evaluate = tasks.evaluate_controller
    real_dense = (st_dp.solve_st_fast, st_dp.solve_st_no_jerk_fast)

    def counted_dense(fn):
        def call(*a, **kw):
            counts["dense_dp_calls"] += 1
            return fn(*a, **kw)
        return call

    def evaluate_controller(cfg, controller, *a, **kw):
        def counted(*args):
            counts["control_ticks"] += 1
            return controller(*args)

        st_dp.solve_st_fast, st_dp.solve_st_no_jerk_fast = map(
            counted_dense, real_dense)
        st_kernel.launches = 0
        t0 = time.perf_counter()
        try:
            return real_evaluate(cfg, counted, *a, **kw)
        finally:
            counts["evaluation_s"] += time.perf_counter() - t0
            counts["k1_launches"] += st_kernel.launches
            st_dp.solve_st_fast, st_dp.solve_st_no_jerk_fast = real_dense

    tasks.evaluate_controller = evaluate_controller
    try:
        yield counts
    finally:
        tasks.evaluate_controller = real_evaluate


def run_one(name: str, episodes: int, csv_path: str,
            jax_rows: Dict[str, dict], card: str) -> dict:
    """Evaluate one configuration on the card through ``do_task``; append
    its row and its run record.  Returns the record."""
    import torch
    from rl_mpc_lanemerging_torch.main import do_task
    cfg = table_config(name, episodes, jax_rows)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with instrumented() as counts:
        do_task(cfg, device="cuda", csv_path=csv_path)
    wall = time.perf_counter() - t0
    row = newest_rows(read_rows(csv_path))[cfg.LOG_DIR]
    ticks = counts["control_ticks"]
    record = {
        "config": name, "LOG_DIR": cfg.LOG_DIR, "TIME": row["TIME"],
        "card": card, "batch": cfg.BATCH_SCENARIOS, "episodes": episodes,
        "wall_s": wall, **counts,
        "s_per_control_tick": counts["evaluation_s"] / max(ticks, 1),
        "k1_per_tick": counts["k1_launches"] / max(ticks, 1),
        "expected_k1_per_tick": expected_k1_per_tick(cfg),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    with open(os.path.splitext(csv_path)[0] + ".jsonl", "a") as fh:
        fh.write(json.dumps(record) + "\n")
    print(f"{name}: {card}; B={cfg.BATCH_SCENARIOS} x {episodes} episodes "
          f"in {wall:.2f} s; {ticks} control ticks, "
          f"{record['s_per_control_tick']:.4f} s per tick; K1 "
          f"{counts['k1_launches']} launches = {record['k1_per_tick']:.3f} "
          f"per tick (expected {record['expected_k1_per_tick']}); dense DP "
          f"calls in the controller {counts['dense_dp_calls']}; "
          f"max_memory_allocated "
          f"{record['max_memory_allocated_bytes'] / 2 ** 30:.3f} GiB; crash "
          f"{float(row['crashed']):.4f} merge {float(row['merged']):.4f}",
          flush=True)
    if ticks == 0 or counts["k1_launches"] != \
            record["expected_k1_per_tick"] * ticks:
        raise RuntimeError(f"{name}: {counts['k1_launches']} K1 launches in "
                           f"{ticks} control ticks")
    if cfg.USE_FAST_ST_SOLVER and counts["dense_dp_calls"]:
        raise RuntimeError(f"{name}: the dense DP ran in the controller")
    return record


def run(names: List[str], episodes: int, csv_path: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("--run evaluates on the card: "
                           "torch.cuda.is_available() is False")
    jax_rows = newest_rows(read_rows(JAX_CSV), MIN_JAX_EPISODES)
    todo = pending(names, episodes, csv_path)
    card = card_line()
    print(f"{card}; {len(names) - len(todo)} of {len(names)} configurations "
          f"already in {csv_path}", flush=True)
    for name in todo:
        run_one(name, episodes, csv_path, jax_rows, card)


def dqn_chain(frames: float, episodes: int) -> None:
    """TRAIN_DQN -> RESUME_DQN -> EVALUATE_DQN through the CLI."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("--dqn-chain trains on the card: "
                           "torch.cuda.is_available() is False")
    with open(config_path("train_dqn_default_1")) as fh:
        base = json.load(fh)
    os.makedirs(os.path.join(REPO, CHAIN_DIR), exist_ok=True)
    stages = (
        ("TRAIN_DQN", CHAIN_LOG_DIR, None),
        ("RESUME_DQN", f"{CHAIN_LOG_DIR}_resumed",
         f"runs/{CHAIN_LOG_DIR}_extended"),
        ("EVALUATE_DQN", f"{CHAIN_LOG_DIR}_evaluated",
         f"runs/{CHAIN_LOG_DIR}_resumed"))
    for task, log_dir, model in stages:
        settings = dict(base, TASK=task, LOG_DIR=log_dir)
        if model:
            settings["MODEL_NAME"] = model
        path = os.path.join(CHAIN_DIR, f"{task.lower()}.json")
        with open(os.path.join(REPO, path), "w") as fh:
            json.dump(settings, fh, indent=1)
        cmd = [sys.executable, "-m", "rl_mpc_lanemerging_torch.main", path,
               "--frames", str(frames), "--episodes", str(episodes)]
        print("$ " + " ".join(cmd[1:]), flush=True)
        t0 = time.perf_counter()
        subprocess.run(cmd, cwd=REPO, check=True)
        print(f"{task}: {time.perf_counter() - t0:.2f} s", flush=True)


def put_section(path: str, heading: str, text: str) -> None:
    """Write ``text``, a section that starts with the line ``heading``, in
    place of that section's earlier text, or at the end of the file at
    ``path`` where it has none; the rest of the file stays as it is."""
    old = ""
    if os.path.exists(path):
        with open(path) as fh:
            old = fh.read()
    after = ""
    line = heading + "\n"           # the whole line: one heading may start
    if old.startswith(line) or "\n" + line in old:   # another
        start = 0 if old.startswith(line) else old.index("\n" + line) + 1
        end = old.find("\n## ", start + len(heading))
        old, after = old[:start], "" if end < 0 else old[end + 1:]
    with open(path, "w") as fh:
        fh.write((old.rstrip("\n") + "\n\n" + text if old else text)
                 + ("\n" + after if after else ""))


def _kept_sections(path: str) -> str:
    """The sections that other scripts put at the end of ``path``
    (``scripts/train_curve_torch.py``: "DDPG learning curve", "Rainbow
    learning curve", "DDPG learning curve, 1e6 + 1e6 frames")."""
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        old = fh.read()
    starts = [old.index(h) for h in (CURVE_SECTION, RAINBOW_SECTION,
                                     DDPG_SECTION) if h in old]
    return old[min(starts):] if starts else ""


def _cell(v: Optional[float], sem: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v:.4f} ± {sem:.4f}" if sem is not None else f"{v:.4f}"


def compare_rows(port: dict, jax: Optional[dict]) -> tuple:
    """((label, port cell, JAX cell, flag) per metric present on both
    sides) of one port row against its yardstick."""
    out = []
    for metric, label in METRICS:
        p = _value(port, metric)
        if p is None:
            continue
        ps = _value(port, metric + "_std") or 0.0
        j = _value(jax, metric) if jax else None
        js = (_value(jax, metric + "_std") or 0.0) if jax else None
        flag = j is not None and flagged(p, ps, j, js)
        out.append((label, _cell(p, ps), _cell(j, js), flag))
    return tuple(out)


def compare(csv_path: str, out_path: str) -> str:
    """Write the port-vs-JAX acceptance table; returns its text."""
    port_rows = newest_rows(read_rows(csv_path))
    jax_rows = newest_rows(read_rows(JAX_CSV), MIN_JAX_EPISODES)
    with open(YARDSTICKS) as fh:
        yardsticks = json.load(fh)
    records = {}
    jsonl = os.path.splitext(csv_path)[0] + ".jsonl"
    if os.path.exists(jsonl):
        with open(jsonl) as fh:
            for line in fh:
                r = json.loads(line)
                records[(r["LOG_DIR"], r["TIME"])] = r
    from rl_mpc_lanemerging_torch.config import Settings
    lines = [
        "# Acceptance of the PyTorch port against the JAX package's rows",
        "",
        "Generated by `python scripts/paper_table_torch.py --compare` from "
        "`run_data_torch.csv` (the port on the card, written by `--run`) "
        "and `run_data.csv` (the JAX package). Each port row is held to "
        "the newest JAX row of its `LOG_DIR` with at least "
        f"{MIN_JAX_EPISODES} episodes. Cells are mean ± SEM, port / JAX; "
        "a metric is flagged where |port - JAX| > 3 sqrt(SEM_port^2 + "
        "SEM_JAX^2). A JAX row recorded before "
        f"{STALE_BEFORE} (the TPU backend's fix for torn spawns at batch "
        "1024) is stale: those configurations are held to the JAX code "
        "run on the CPU (`scripts/jax_cpu_yardsticks.json`, "
        "`python scripts/jax_st_round.py 48 0 1 configs/<config>.json`). "
        "Times are the port's, on the card named beside them; no JAX or "
        "TPU time appears here.", ""]
    cuts, missing = [], []
    flags_total = 0
    for family, names in FAMILIES.items():
        lines += [f"## {family}", "",
                  "| config | JAX yardstick | episodes (port) | batch | "
                  + " | ".join(label for _, label in METRICS)
                  + " | flagged |",
                  "| --- " * (len(METRICS) + 5) + "|"]
        timing = []
        for name in names:
            log_dir = Settings.load_from_file(config_path(name)).replace(
                **OVERRIDES.get(name, {})).LOG_DIR
            port = port_rows.get(log_dir)
            if port is None:
                missing.append(name)
                continue
            jax = jax_rows.get(log_dir)
            if jax is None:
                source = "none"
            elif is_stale(jax):
                jax = yardsticks.get(name)
                source = (f"line {jax_rows[log_dir]['_line']} stale; JAX "
                          f"on the CPU, {jax['NUM_EPISODES']} episodes"
                          if jax else
                          f"line {jax_rows[log_dir]['_line']} stale; none")
            else:
                source = f"line {jax['_line']}"
            cells = compare_rows(port, jax)
            by_label = {c[0]: c for c in cells}
            row_flags = [c[0] for c in cells if c[3]]
            flags_total += len(row_flags)
            lines.append(
                f"| {name} | {source} | {_episodes(port)} | "
                f"{port['BATCH_SCENARIOS']} | " + " | ".join(
                    f"{by_label[label][1]} / {by_label[label][2]}"
                    if label in by_label else "-" for _, label in METRICS)
                + f" | {', '.join(row_flags) or '-'} |")
            if _episodes(port) < EPISODES:
                cuts.append(f"{name}: {_episodes(port)} episodes")
            rec = records.get((log_dir, port["TIME"]))
            timing.append(
                f"| {name} | {rec['card'] if rec else 'not recorded'} | "
                f"{float(port['clock_time_per_step']):.6g} | "
                + (f"{rec['control_ticks']} | "
                   f"{rec['s_per_control_tick']:.4f} | "
                   f"{rec['k1_per_tick']:.3f} | "
                   f"{rec['dense_dp_calls']} | "
                   f"{rec['max_memory_allocated_bytes'] / 2 ** 30:.3f} | "
                   f"{rec['wall_s']:.1f} |" if rec else
                   "- | - | - | - | - | - |"))
        if timing:
            lines += ["", "| config | card, power limit | "
                      "clock_time_per_step (s) | control ticks | s per "
                      "control tick | K1 launches per tick | dense DP "
                      "calls | max_memory_allocated (GiB) | wall (s) |",
                      "| --- " * 9 + "|"] + timing
        lines.append("")
    lines += ["## Depth cuts", "",
              *(f"- {c}" for c in cuts or ["none: every row has "
                                           f">= {EPISODES} episodes"]), "",
              "## Not yet run on the card", "",
              *(f"- {m}" for m in missing or ["none"]), "",
              f"Flagged metrics: {flags_total}.", ""]
    text = "\n".join(lines)
    kept = _kept_sections(out_path)
    with open(out_path, "w") as fh:
        fh.write(text + ("\n" + kept if kept else ""))
    return text


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--run", nargs="*", metavar="NAME",
                      help="evaluate these configurations on the card")
    mode.add_argument("--compare", action="store_true",
                      help="write the acceptance table")
    mode.add_argument("--dqn-chain", action="store_true",
                      help="TRAIN_DQN -> RESUME_DQN -> EVALUATE_DQN "
                           "through the CLI on the card")
    ap.add_argument("--family", nargs="*", choices=sorted(FAMILIES),
                    default=[])
    ap.add_argument("--episodes", type=int, default=None,
                    help=f"default {EPISODES} (--run), 256 (--dqn-chain)")
    ap.add_argument("--frames", type=float, default=2e4)
    ap.add_argument("--csv", default=PORT_CSV, metavar="PATH")
    ap.add_argument("--out", default=ACCEPTANCE, metavar="PATH")
    args = ap.parse_args(argv)
    if args.compare:
        compare(args.csv, args.out)
        print(f"wrote {args.out}")
    elif args.dqn_chain:
        dqn_chain(args.frames, args.episodes or 256)
    else:
        names = list(args.run) + [n for f in args.family
                                  for n in FAMILIES[f]]
        if not names:
            names = [n for f in FAMILIES.values() for n in f]
        unknown = [n for n in names if not os.path.exists(config_path(n))]
        if unknown:
            raise SystemExit(f"no config for {unknown}")
        run(names, args.episodes or EPISODES, args.csv)


if __name__ == "__main__":
    main()
