"""Run the paper's result table through the PyTorch port on the card, and
compare it with the JAX package's rows.

The port's counterpart of the JAX side's table scripts
(``scripts/queue_r*.sh``, ``scripts/compare_baseline.py``).

    python scripts/paper_table_torch.py --run [NAME ...] [--family F ...]
        [--episodes 1024] [--model runs/NAME] [--csv run_data_torch.csv]
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
and the dense DP's calls inside the controller,
``torch.cuda.max_memory_allocated()``, and each round's episodes and the
count, mean and SEM of its crash, merge, |jerk|, time to merge and MPC
share (``round_stats``, from the aggregator the evaluation builds); it
prints the same.  ``--model`` runs that network in place of each
configuration's ``MODEL_NAME``, under a ``LOG_DIR`` of its own
(``model_log_dir``) that the table below does not hold.  A configuration
whose row is already in ``--csv`` with at least the episodes asked is
skipped, so a run that is cut loses only the configuration it was in.  K1
must launch once per control tick on ST, twice on the combined and cross
configurations (``1 + TEST_ROLLOUT_STATE``), never on EVALUATE_DDPG and
EVALUATE_DQN, and the dense DP must never run in the controller while
``USE_FAST_ST_SOLVER`` is True; otherwise the run stops with an error after
recording the row.  ``--family custom_dqn`` runs, beside the 39-row
table, ``dqn_custom_default1``: ``configs/train_default_1.json`` as
TRAIN_DQN with its committed network evaluated greedily through
``tasks.evaluate_controller`` at B=512 (``evaluate_custom_dqn``), as
``run_data.csv`` line 218 was made.

``--compare`` matches each configuration's newest port row to its JAX row
and writes ``--out``: per family, crash, merge, mean |jerk|, time to merge
and the MPC's share of ticks, each with both SEMs, and a flag where
|port - JAX| > 3 sqrt(SEM_port^2 + SEM_JAX^2).  A JAX row recorded before
2026-08-21T09:40 (the TPU backend's fix for torn spawns at batch 1024) is
stale and not used: those configurations are held to the JAX code's own
figures on the CPU (``python scripts/jax_st_round.py 48 0 1
configs/<NAME>.json``), read from ``scripts/jax_cpu_yardsticks.json``.
Once their runs are in ``--csv``, two sections follow the table: the
combined lean decided at the JAX rows' own 4000 episodes (``lean_section``)
and combined_default_1 with the port-trained DDPG actors
(``actors_section``).  It needs no card and runs no JAX.

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
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

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
# beside the paper's 39 rows: the custom Double-DQN's committed network,
# evaluated as run_data.csv line 218 was made (``CUSTOM_DQN``)
CUSTOM_FAMILIES: Dict[str, List[str]] = {
    "custom_dqn": ["dqn_custom_default1"]}
ALL_FAMILIES = {**FAMILIES, **CUSTOM_FAMILIES}
# train_dqn_default_1's row (LOG_DIR rainbow_default1) is its TRAIN_DQN
# task's final evaluation of the extended network; the port evaluates the
# converted network of that name
OVERRIDES = {"train_dqn_default_1": dict(
    TASK="EVALUATE_DQN", MODEL_NAME="runs/rainbow_default1_extended")}
# a table name with no config file of its own: the config it is made from
# and its settings.  dqn_custom_default1 is ``scripts/train_custom_dqn.py``'s
# run: configs/train_default_1.json as TRAIN_DQN, its selected network
# evaluated greedily (``dqn.greedy_controller``) through
# ``tasks.evaluate_controller`` at B=512 over NUM_EPISODES
CUSTOM_DQN = {"dqn_custom_default1": ("train_default_1", dict(
    TASK="TRAIN_DQN", LOG_DIR="dqn_custom_default1",
    MODEL_NAME="runs/dqn_custom_default1"))}
METRICS = (("crashed", "crash"), ("merged", "merge"),
           ("mean_abs_jerk", "mean abs jerk"),
           ("time_to_merge", "time to merge (s)"),
           ("percent st solver", "percent st solver"))
# the per-round statistics of a run's record (``round_stats``)
ROUND_METRICS = ("crashed", "merged", "mean_abs_jerk", "time_to_merge",
                 "percent st solver")
# the per-episode columns ``run_one`` can keep (``time_taken`` of every
# episode: ``time_to_merge`` is the merged episodes' alone)
EPISODE_COLUMNS = ("crashed", "merged", "mean_abs_jerk", "time_taken",
                   "percent st solver")
# the headings of the sections that scripts/train_curve_torch.py writes
CURVE_SECTION = "## DDPG learning curve"
RAINBOW_SECTION = "## Rainbow learning curve"
DDPG_SECTION = "## DDPG learning curve, 1e6 + 1e6 frames"
CHAIN_DIR = os.path.join("runs_torch", "chain")
# the combined lean: the rows run at their JAX row's own 4000 episodes
LEAN_CONFIGS = ("combined_default_1", "cross_medium_network_low_traffic_1")
LEAN_SECTION = "## Combined lean at the JAX rows' 4000 episodes"
ACTORS_SECTION = "## Combined arbiter with the port-trained DDPG actors"
ACTORS_CONFIG = "combined_default_1"
# scripts/train_curve_torch.py: the stage-2 records, and the MODEL_NAME of
# seed k's exported stage-2 selection (its --export)
TRAIN_JSONL = os.path.join(REPO, "run_data_torch_train.jsonl")
CURVE_MODEL = "runs/curve_ddpg_seed{}_extended"
CURVE_MODEL_SEED = re.compile(r"runs/curve_ddpg_seed(\d+)_extended$")
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


def model_log_dir(log_dir: str, model: str) -> str:
    """The ``LOG_DIR`` of a configuration's row run with the network
    ``model`` in place of its ``MODEL_NAME``: its own, suffixed with the
    network's name, so that it is not the row ``--compare`` holds to the
    JAX row."""
    return f"{log_dir}_{os.path.basename(os.path.normpath(model))}"


def name_config(name: str, model: Optional[str] = None):
    """The settings of ``configs/<name>.json`` with ``OVERRIDES``, and with
    ``model`` as its ``MODEL_NAME`` under ``model_log_dir``."""
    from rl_mpc_lanemerging_torch.config import Settings
    base, custom = CUSTOM_DQN.get(name, (name, {}))
    cfg = Settings.load_from_file(config_path(base)).replace(
        **OVERRIDES.get(name, {}), **custom)
    if model:
        cfg = cfg.replace(MODEL_NAME=model,
                          LOG_DIR=model_log_dir(cfg.LOG_DIR, model))
    return cfg


def table_config(name: str, episodes: int, jax_rows: Dict[str, dict],
                 model: Optional[str] = None):
    """The settings of one table configuration at its JAX row's batch
    (``model``: as in ``name_config``)."""
    log_dir = name_config(name).LOG_DIR
    row = jax_rows.get(log_dir)
    if row is None:
        raise KeyError(f"{name}: run_data.csv has no row of LOG_DIR "
                       f"{log_dir} with >= {MIN_JAX_EPISODES} episodes")
    return name_config(name, model).replace(
        NUM_EPISODES=episodes,
        BATCH_SCENARIOS=int(float(row["BATCH_SCENARIOS"])))


def pending(names: List[str], episodes: int, csv_path: str,
            model: Optional[str] = None) -> List[str]:
    """The names whose row is not yet in ``csv_path`` with at least
    ``episodes`` episodes."""
    done = {row["LOG_DIR"] for row in read_rows(csv_path)
            if _episodes(row) >= episodes}
    return [n for n in names if name_config(n, model).LOG_DIR not in done]


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


def _mean_sem(values) -> dict:
    """The count, mean and SEM (the aggregator's: sample standard deviation
    over sqrt(n); None below two values) of ``values``."""
    v = np.asarray(values, np.float64)
    return {"n": int(v.size), "mean": float(v.mean()) if v.size else None,
            "sem": float(v.std(ddof=1) / math.sqrt(v.size))
            if v.size > 1 else None}


def round_stats(agg, ends: List[Dict[str, int]]) -> List[dict]:
    """Per round of an evaluation, from its aggregator ``agg``: the episode
    count and ``_mean_sem`` of each of ``ROUND_METRICS`` that ``agg`` holds
    over that round's values.  ``ends`` holds each column's length after
    each round (the aggregator appends a round's values to every column at
    once; ``time_to_merge`` holds the merged episodes' alone)."""
    data = {**agg.columns, **agg.custom}
    out, start = [], {}
    for end in ends:
        r = {"episodes": end["crashed"] - start.get("crashed", 0)}
        for metric in ROUND_METRICS:
            if metric in data:
                r[metric] = _mean_sem(
                    data[metric][start.get(metric, 0):end.get(metric, 0)])
        out.append(r)
        start = end
    return out


@contextlib.contextmanager
def instrumented():
    """Counts, over the evaluation run inside: its control ticks (the
    controller's calls), its seconds, the K1 launches and dense DP calls
    its controller made, and its statistics round by round
    (``round_stats``); under ``episode_columns``, each of
    ``EPISODE_COLUMNS`` that the aggregator holds, episode by episode."""
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch.ops import st_dp, st_kernel
    from rl_mpc_lanemerging_torch.stats import StatsAggregator
    counts = {"control_ticks": 0, "evaluation_s": 0.0, "k1_launches": 0,
              "dense_dp_calls": 0, "rounds": [], "episode_columns": {}}
    real_evaluate = tasks.evaluate_controller
    real_add = StatsAggregator.add_batch
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

        ends = []

        def add_batch(agg, *args, **kwargs):
            real_add(agg, *args, **kwargs)
            ends.append({k: len(v) for k, v in {**agg.columns,
                                                **agg.custom}.items()})

        st_dp.solve_st_fast, st_dp.solve_st_no_jerk_fast = map(
            counted_dense, real_dense)
        StatsAggregator.add_batch = add_batch
        st_kernel.launches = 0
        t0 = time.perf_counter()
        try:
            agg = real_evaluate(cfg, counted, *a, **kw)
        finally:
            counts["evaluation_s"] += time.perf_counter() - t0
            counts["k1_launches"] += st_kernel.launches
            st_dp.solve_st_fast, st_dp.solve_st_no_jerk_fast = real_dense
            StatsAggregator.add_batch = real_add
        counts["rounds"] += round_stats(agg, ends)
        data = {**agg.columns, **agg.custom}
        for k in EPISODE_COLUMNS:
            if k in data:
                counts["episode_columns"].setdefault(k, []).extend(
                    np.asarray(data[k], np.float64).tolist())
        return agg

    tasks.evaluate_controller = evaluate_controller
    try:
        yield counts
    finally:
        tasks.evaluate_controller = real_evaluate


def run_one(name: str, episodes: int, csv_path: str,
            jax_rows: Dict[str, dict], card: str,
            model: Optional[str] = None,
            log_dir: Optional[str] = None,
            episodes_out: Optional[str] = None) -> dict:
    """Evaluate one configuration on the card through ``do_task``; append
    its row and its run record (under ``log_dir`` in place of the
    configuration's ``LOG_DIR``, where given; with ``episodes_out``, the
    per-episode columns to that ``.npz``).  Returns the record."""
    import torch
    from rl_mpc_lanemerging_torch.main import do_task
    cfg = table_config(name, episodes, jax_rows, model)
    if log_dir:
        cfg = cfg.replace(LOG_DIR=log_dir)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with instrumented() as counts:
        if name in CUSTOM_DQN:
            evaluate_custom_dqn(cfg, csv_path)
        else:
            do_task(cfg, device="cuda", csv_path=csv_path)
    wall = time.perf_counter() - t0
    columns = counts.pop("episode_columns")
    if episodes_out:
        np.savez_compressed(episodes_out, **columns)
    row = newest_rows(read_rows(csv_path))[cfg.LOG_DIR]
    ticks = counts["control_ticks"]
    record = {
        "config": name, "LOG_DIR": cfg.LOG_DIR, "TIME": row["TIME"],
        "model": cfg.MODEL_NAME, "card": card,
        "batch": cfg.BATCH_SCENARIOS, "episodes": episodes,
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
    for i, r in enumerate(record["rounds"]):
        print(f"  round {i + 1}: {r['episodes']} episodes; " + "; ".join(
            f"{m} {r[m]['mean']:.4f} ± {r[m]['sem'] or 0.0:.4f}"
            for m in ROUND_METRICS if m in r and r[m]["mean"] is not None),
            flush=True)
    if ticks == 0 or counts["k1_launches"] != \
            record["expected_k1_per_tick"] * ticks:
        raise RuntimeError(f"{name}: {counts['k1_launches']} K1 launches in "
                           f"{ticks} control ticks")
    if cfg.USE_FAST_ST_SOLVER and counts["dense_dp_calls"]:
        raise RuntimeError(f"{name}: the dense DP ran in the controller")
    return record


def evaluate_custom_dqn(cfg, csv_path: str, device="cuda") -> None:
    """The committed custom DQN of ``MODEL_NAME`` (``checkpoint.load_dqn``)
    through ``dqn.greedy_controller`` over ``NUM_EPISODES`` at
    ``BATCH_SCENARIOS``, its row appended to ``csv_path``: the
    evaluation of ``scripts/train_custom_dqn.py``, without the training."""
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch.agents import dqn
    from rl_mpc_lanemerging_torch.checkpoint import load_dqn
    net = load_dqn(cfg.MODEL_NAME, device, committed=True)
    agg = tasks.evaluate_controller(cfg, dqn.greedy_controller(net, cfg),
                                    device=device, verbose=False)
    agg.add_csv_data(csv_path)


def run(names: List[str], episodes: int, csv_path: str,
        model: Optional[str] = None) -> None:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("--run evaluates on the card: "
                           "torch.cuda.is_available() is False")
    jax_rows = newest_rows(read_rows(JAX_CSV), MIN_JAX_EPISODES)
    todo = pending(names, episodes, csv_path, model)
    card = card_line()
    print(f"{card}; {len(names) - len(todo)} of {len(names)} configurations "
          f"already in {csv_path}", flush=True)
    for name in todo:
        run_one(name, episodes, csv_path, jax_rows, card, model)


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


def compare(csv_path: str, out_path: str,
            train_jsonl: str = TRAIN_JSONL) -> str:
    """Write the port-vs-JAX acceptance table, and the sections of the
    combined lean (``lean_section``) and of the port-trained actors
    (``actors_section``) where their runs are there; returns its text."""
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
    for family, names in ALL_FAMILIES.items():
        lines += [f"## {family}", "",
                  "| config | JAX yardstick | episodes (port) | batch | "
                  + " | ".join(label for _, label in METRICS)
                  + " | flagged |",
                  "| --- " * (len(METRICS) + 5) + "|"]
        timing = []
        for name in names:
            log_dir = name_config(name).LOG_DIR
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
            card = "not recorded" if rec is None else rec["card"] + (
                f"; the card shared with {rec['shared_with']}"
                if rec.get("shared_with") else "")
            timing.append(
                f"| {name} | {card} | "
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
    all_rows = read_rows(csv_path)
    lean = lean_section(all_rows, records, jax_rows)
    actors = actors_section(all_rows, records, jax_rows, train_jsonl)
    text = "\n".join(lines + [x for x in (lean, actors) if x])
    kept = _kept_sections(out_path)
    with open(out_path, "w") as fh:
        fh.write(text + ("\n" + kept if kept else ""))
    return text


def pooled(parts: List[dict]) -> dict:
    """``_mean_sem`` of the union of the parts' values, from each part's
    count, mean and SEM alone (the squares within each part and about the
    common mean)."""
    parts = [p for p in parts if p["n"]]
    n = sum(p["n"] for p in parts)
    if not n:
        return {"n": 0, "mean": None, "sem": None}
    mean = sum(p["n"] * p["mean"] for p in parts) / n
    squares = sum((p["sem"] or 0.0) ** 2 * p["n"] * (p["n"] - 1)
                  + p["n"] * (p["mean"] - mean) ** 2 for p in parts)
    return {"n": n, "mean": mean,
            "sem": math.sqrt(squares / (n - 1) / n) if n > 1 else None}


def _pooled_rounds(rounds: List[dict]) -> dict:
    out = {"episodes": sum(r["episodes"] for r in rounds)}
    for metric in ROUND_METRICS:
        if all(metric in r for r in rounds):
            out[metric] = pooled([r[metric] for r in rounds])
    return out


def _row_stat(row: dict, metric: str) -> dict:
    return {"mean": _value(row, metric), "sem": _value(row, metric + "_std")}


def _ms(stat: Optional[dict]) -> str:
    if not stat or stat.get("mean") is None:
        return "-"
    return _cell(stat["mean"], stat.get("sem") or 0.0)


def _gap(a: dict, b: dict) -> dict:
    """a - b, with the standard error of the difference."""
    return {"mean": a["mean"] - b["mean"],
            "sem": math.sqrt((a["sem"] or 0.0) ** 2 + (b["sem"] or 0.0) ** 2)}


def _sems(gap: dict) -> str:
    return (f"{gap['mean']:+.4f} ± {gap['sem']:.4f} "
            f"({abs(gap['mean']) / gap['sem']:.1f} SEM)" if gap["sem"]
            else f"{gap['mean']:+.4f}")


def lean_verdict(jax: dict, short: dict, whole: dict, early: dict,
                 late: dict) -> dict:
    """The lean's rule for one row's time to merge (``mean``/``sem``
    dicts): the JAX row, the port's 1024-episode row, its 4000-episode
    run, and that run's rounds 1-2 and 3-8 pooled.  "depth" holds where the
    run lies within 3 SEM of the difference from the JAX row, its gap is
    under a third of the short row's or of the other sign, and rounds 3-8
    sit on the side of rounds 1-2 that closes the short row's gap."""
    gap_short, gap_whole = _gap(short, jax), _gap(whole, jax)
    within = abs(gap_whole["mean"]) <= 3.0 * gap_whole["sem"]
    shrinks = abs(gap_whole["mean"]) < abs(gap_short["mean"]) / 3.0 \
        or gap_whole["mean"] * gap_short["mean"] < 0
    shift = _gap(late, early)
    closes = shift["mean"] * gap_short["mean"] < 0
    return {"gap_short": gap_short, "gap_whole": gap_whole, "shift": shift,
            "within": within, "shrinks": shrinks, "closes": closes,
            "depth": within and shrinks and closes}


def _lean_run(rows: List[dict], records: dict, log_dir: str):
    """(the newest row of ``log_dir`` with a record that has its rounds,
    that record, the newest row of ``log_dir`` with fewer episodes)."""
    runs = [r for r in rows if r["LOG_DIR"] == log_dir
            and records.get((log_dir, r["TIME"]), {}).get("rounds")]
    if not runs:
        return None, None, None
    run = max(runs, key=lambda r: r["TIME"])
    shorter = [r for r in rows if r["LOG_DIR"] == log_dir
               and _episodes(r) < _episodes(run)]
    return (run, records[(log_dir, run["TIME"])],
            max(shorter, key=lambda r: r["TIME"]) if shorter else None)


def lean_section(rows: List[dict], records: dict,
                 jax_rows: Dict[str, dict]) -> str:
    """The combined lean, decided at the JAX rows' own depth: for each of
    ``LEAN_CONFIGS`` with a run that recorded its rounds and a shorter row
    before it, the rounds, rounds 1-2 against the shorter row, and the
    lean's rule (``lean_verdict``) on time to merge; "" before such runs."""
    found = {n: _lean_run(rows, records, name_config(n).LOG_DIR)
             for n in LEAN_CONFIGS}
    if not all(run and short for run, _, short in found.values()):
        return ""
    labels = dict(METRICS)
    head = ("| rounds | episodes | " + " | ".join(
        labels[m] for m in ROUND_METRICS) + " |")
    lines = [LEAN_SECTION, "",
             "Generated by `python scripts/paper_table_torch.py --compare` "
             "from the runs of `--run " + " ".join(LEAN_CONFIGS)
             + " --episodes 4000` (each round's statistics in "
             "`run_data_torch.jsonl`): the JAX rows' own `NUM_EPISODES` "
             "at their batch, so the same rounds of the persisting world "
             "(a row's episodes are its `NUM_EPISODES`; 8 rounds of 512 run "
             "4096). Cells are mean ± SEM. The rule (written in PERF.md "
             "before the runs), on time to merge: \"depth\" where, in "
             "every row, the run lies within 3 SEM of the difference from "
             "the JAX row, its gap to it is "
             "under a third of the shorter row's or of the other sign, and "
             "rounds 3-8 sit on the side of rounds 1-2 that closes that "
             "gap; otherwise \"persists\".", ""]
    verdicts = []
    for name, (run, rec, short) in found.items():
        jax = jax_rows[name_config(name).LOG_DIR]
        rounds = rec["rounds"]
        early, late = (_pooled_rounds(rounds[:2]),
                       _pooled_rounds(rounds[2:]))
        table = [head, "| --- " * (len(ROUND_METRICS) + 2) + "|"]
        for i, r in enumerate(rounds):
            table.append(f"| {i + 1} | {r['episodes']} | " + " | ".join(
                _ms(r.get(m)) for m in ROUND_METRICS) + " |")
        for label, r in (("1-2", early), (f"3-{len(rounds)}", late)):
            table.append(f"| {label} | {r['episodes']} | " + " | ".join(
                _ms(r.get(m)) for m in ROUND_METRICS) + " |")
        for label, row in (
                (f"all (port, line {run['_line']})", run),
                (f"port, line {short['_line']}", short),
                (f"JAX, run_data.csv line {jax['_line']}", jax)):
            table.append(f"| {label} | {_episodes(row)} | " + " | ".join(
                _ms(_row_stat(row, m)) for m in ROUND_METRICS) + " |")
        same = max(abs(early[m]["mean"] - _value(short, m))
                   for m in ROUND_METRICS
                   if m in early and _value(short, m) is not None)
        v = lean_verdict(*(_row_stat(r, "time_to_merge") for r in (
            jax, short, run)), early["time_to_merge"], late["time_to_merge"])
        verdicts.append(v["depth"])
        lines += [f"### {name}", "",
                  f"{rec['card']}; B={rec['batch']}; {rec['wall_s']:.1f} s "
                  f"({rec['s_per_control_tick']:.4f} s per control tick, "
                  f"{rec['control_ticks']} ticks); K1 "
                  f"{rec['k1_per_tick']:.3f} launches per tick.", "",
                  *table, "",
                  f"- Rounds 1-2 against the {_episodes(short)}-episode "
                  f"row: the largest difference of a mean is {same:.3g}"
                  + (" (they reproduce it)." if same <= 1e-9 else "."),
                  f"- Time to merge, port - JAX: {_sems(v['gap_short'])} at "
                  f"{_episodes(short)} episodes, {_sems(v['gap_whole'])} at "
                  f"{_episodes(run)}; rounds 3-{len(rounds)} - rounds 1-2: "
                  f"{_sems(v['shift'])}.",
                  f"- Within 3 SEM: {'yes' if v['within'] else 'no'}; gap "
                  f"under a third or of the other sign: "
                  f"{'yes' if v['shrinks'] else 'no'}; the later rounds "
                  f"close it: {'yes' if v['closes'] else 'no'}.", ""]
    word = "depth" if all(verdicts) else "persists"
    lines += [f"**Verdict: \"{word}\".**", ""]
    return "\n".join(lines)


def _final_cells(final: dict) -> str:
    return " | ".join(_cell(final[k], final.get(k + "_sem"))
                      for k in ("crash", "merge", "jerk", "t_merge"))


def actors_section(rows: List[dict], records: dict,
                   jax_rows: Dict[str, dict], train_jsonl: str) -> str:
    """``ACTORS_CONFIG`` run with each seed's exported stage-2 selection
    (``--model runs/curve_ddpg_seed<k>_extended``) beside the committed
    actor's row of the same episodes, the seed's RL-only final evaluation
    (``train_jsonl``) and the JAX row; the rule holds crash and merge to
    3 SEM of the difference from the committed actor's row, one seed
    outside at most.  "" before such a row."""
    log_dir = name_config(ACTORS_CONFIG).LOG_DIR
    newest = newest_rows(rows)
    seeds = {}
    for row in newest.values():
        found = CURVE_MODEL_SEED.match(row.get("MODEL_NAME") or "")
        if found and row["LOG_DIR"] == model_log_dir(log_dir,
                                                     row["MODEL_NAME"]):
            seeds[int(found.group(1))] = row
    if not seeds:
        return ""
    finals = {}
    if os.path.exists(train_jsonl):
        with open(train_jsonl) as fh:
            for line in fh:
                r = json.loads(line)
                if r.get("trainer") == "ddpg" and r.get("stage") == 2 \
                        and r.get("final"):
                    finals[int(r["seed"])] = r["final"]
    jax = jax_rows[log_dir]
    decided, labels = ("crashed", "merged"), dict(METRICS)
    lines = [ACTORS_SECTION, "",
             "Generated by `python scripts/paper_table_torch.py --compare` "
             f"from the runs of `--run {ACTORS_CONFIG} --model "
             "runs/curve_ddpg_seed<k>_extended` (each seed's stage-2 "
             "selection of `scripts/train_curve_torch.py --trainer ddpg`, "
             "written by its `--export`). Each row is held to the port's "
             f"`{ACTORS_CONFIG}` row with the committed "
             f"`{name_config(ACTORS_CONFIG).MODEL_NAME}` at the same "
             "episodes and `SEED` (the same rounds of the world). The rule "
             "(written in PERF.md before the runs): crash and merge within "
             "3 SEM of the difference, one seed outside at most; |jerk|, "
             "time to merge and the MPC's share are reported, not "
             "decided. The RL-only "
             "column is the seed's final evaluation in stage 2 "
             "(`run_data_torch_train.jsonl`, "
             "`configs/train_default_1.json`); the JAX row is context.", "",
             "| seed | row | episodes | " + " | ".join(
                 label for _, label in METRICS) + " | outside 3 SEM |",
             "| --- " * (len(METRICS) + 4) + "|"]
    timing, outside = [], 0
    for seed, row in sorted(seeds.items()):
        same = [r for r in rows if r["LOG_DIR"] == log_dir
                and _episodes(r) == _episodes(row)]
        base = max(same, key=lambda r: r["TIME"]) if same else None
        off = [labels[m] for m in decided if base is not None and flagged(
            _value(row, m), _value(row, m + "_std") or 0.0,
            _value(base, m), _value(base, m + "_std") or 0.0)]
        outside += bool(off) or base is None
        lines.append(f"| {seed} | port-trained (line {row['_line']}) | "
                     f"{_episodes(row)} | " + " | ".join(
                         _ms(_row_stat(row, m)) for m, _ in METRICS)
                     + f" | {', '.join(off) or '-'} |")
        rec = records.get((row["LOG_DIR"], row["TIME"]))
        if rec:
            timing.append(f"| {seed} | {rec['card']} | "
                          f"{rec['control_ticks']} | "
                          f"{rec['s_per_control_tick']:.4f} | "
                          f"{rec['k1_per_tick']:.3f} | "
                          f"{rec['max_memory_allocated_bytes'] / 2 ** 30:.3f}"
                          f" | {rec['wall_s']:.1f} |")
    if base is not None:
        lines.append(f"| - | committed (line {base['_line']}) | "
                     f"{_episodes(base)} | " + " | ".join(
                         _ms(_row_stat(base, m)) for m, _ in METRICS)
                     + " | - |")
    lines.append(f"| - | JAX, run_data.csv line {jax['_line']} | "
                 f"{_episodes(jax)} | " + " | ".join(
                     _ms(_row_stat(jax, m)) for m, _ in METRICS) + " | - |")
    lines += ["", "RL alone (stage 2's final evaluation, 1024 episodes):", "",
              "| seed | crash | merge | mean abs jerk | time to merge (s) |",
              "| --- " * 5 + "|"]
    lines += [f"| {seed} | {_final_cells(finals[seed])} |"
              if seed in finals else f"| {seed} | - | - | - | - |"
              for seed in sorted(seeds)]
    if timing:
        lines += ["", "| seed | card, power limit | control ticks | s per "
                  "control tick | K1 launches per tick | "
                  "max_memory_allocated (GiB) | wall (s) |",
                  "| --- " * 7 + "|"] + timing
    word = "holds" if outside <= 1 else "fails"
    lines += ["", f"**Verdict: the rule {word}** ({outside} of {len(seeds)} "
              "seeds outside 3 SEM on crash or merge).", ""]
    return "\n".join(lines)


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
    ap.add_argument("--family", nargs="*", choices=sorted(ALL_FAMILIES),
                    default=[])
    ap.add_argument("--episodes", type=int, default=None,
                    help=f"default {EPISODES} (--run), 256 (--dqn-chain)")
    ap.add_argument("--frames", type=float, default=2e4)
    ap.add_argument("--model", default=None, metavar="runs/NAME",
                    help="--run: this network in place of each "
                    "configuration's MODEL_NAME, its rows under a LOG_DIR "
                    "of their own (model_log_dir)")
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
                                  for n in ALL_FAMILIES[f]]
        if not names:
            names = [n for f in FAMILIES.values() for n in f]
        unknown = [n for n in names if not os.path.exists(
            config_path(CUSTOM_DQN.get(n, (n,))[0]))]
        if unknown:
            raise SystemExit(f"no config for {unknown}")
        run(names, args.episodes or EPISODES, args.csv, args.model)


if __name__ == "__main__":
    main()
