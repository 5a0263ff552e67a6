"""The port's table runner, ``scripts/paper_table_torch.py``, on the CPU with
synthetic CSVs: the row matcher (the newest >= 1000-episode row of each
LOG_DIR, stale rows by their TIME), the 3-SEM flag, resuming, the
acceptance table, the counts its runs are held to, and that ``--run``
needs the card; each round's statistics and their pooling, ``--model``,
and the sections of the combined lean and of the port-trained actors."""

import csv
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from rl_mpc_lanemerging_torch.config import Settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "paper_table_torch", os.path.join(REPO, "scripts", "paper_table_torch.py"))
pt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pt)


def _write_csv(path, rows):
    keys = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def _row(log_dir, time, episodes=4000, batch=512, **metrics):
    return dict(LOG_DIR=log_dir, TIME=time, NUM_EPISODES=episodes,
                BATCH_SCENARIOS=batch, **metrics)


def test_matcher_takes_the_newest_row_with_enough_episodes(tmp_path):
    path = tmp_path / "rows.csv"
    _write_csv(path, [
        _row("a", "2026-08-21T10:00:00", crashed=0.1),
        _row("a", "2026-08-21T12:00:00", episodes=128, crashed=0.2),
        _row("a", "2026-08-21T11:00:00", crashed=0.3),
        _row("b", "2026-08-20T09:00:00", episodes=999),
        _row("c", "2026-08-21T08:00:00", episodes=1000, crashed=0.4),
    ])
    rows = pt.read_rows(str(path))
    assert [r["_line"] for r in rows] == [2, 3, 4, 5, 6]
    newest = pt.newest_rows(rows, pt.MIN_JAX_EPISODES)
    assert sorted(newest) == ["a", "c"]
    assert newest["a"]["crashed"] == "0.3" and newest["a"]["_line"] == 4
    assert pt.newest_rows(rows)["a"]["crashed"] == "0.2"


@pytest.mark.parametrize("time, stale", [
    ("2026-08-21T00:26:48.671237", True),
    ("2026-08-21T09:39:59.999999", True),
    ("2026-08-21T09:40:00.000001", False),
    ("2026-08-21T11:03:25.303633", False),
    ("2026-08-20T23:59:59", True),
])
def test_rows_before_the_backend_fix_are_stale(time, stale):
    assert pt.is_stale({"TIME": time}) is stale


@pytest.mark.parametrize("port, port_sem, jax, jax_sem, flag", [
    (1.0, 0.1, 1.0, 0.1, False),
    (1.3, 0.1, 1.0, 0.0, False),      # exactly 3 SEM: not beyond
    (1.31, 0.1, 1.0, 0.0, True),
    (0.0, 0.0, 0.0, 0.0, False),
    (0.001, 0.0, 0.0, 0.0, True),     # no spread at all: any gap flags
    (26.0, 0.3, 27.0, 0.2, False),    # 1.0 <= 3 * 0.3606
    (26.0, 0.2, 27.0, 0.1, True),     # 1.0 > 3 * 0.2236
])
def test_flag_is_three_sems_of_the_difference(port, port_sem, jax, jax_sem,
                                              flag):
    assert pt.flagged(port, port_sem, jax, jax_sem) is flag


def test_the_table_is_39_configurations_at_their_rows_batch():
    """Every configuration has a config file and a JAX row; the batch is
    that row's; the stale rows are exactly the five ST rows."""
    names = [n for f in pt.FAMILIES.values() for n in f]
    assert len(names) == len(set(names)) == 39
    assert {f: len(n) for f, n in pt.FAMILIES.items()} == {
        "st": 5, "combined": 10, "cross": 6, "ddpg": 17, "dqn": 1}
    jax_rows = pt.newest_rows(pt.read_rows(pt.JAX_CSV), pt.MIN_JAX_EPISODES)
    batches, stale = {}, []
    for family, members in pt.FAMILIES.items():
        for name in members:
            cfg = pt.table_config(name, 1024, jax_rows)
            row = jax_rows[cfg.LOG_DIR]
            assert cfg.NUM_EPISODES == 1024
            assert cfg.BATCH_SCENARIOS == int(row["BATCH_SCENARIOS"])
            batches.setdefault(family, set()).add(cfg.BATCH_SCENARIOS)
            if pt.is_stale(row):
                stale.append((name, row["_line"]))
    assert batches == {"st": {1024}, "combined": {512}, "cross": {512},
                       "ddpg": {512, 1024}, "dqn": {128}}
    assert sorted(stale) == [("st_default", 21), ("st_fast", 27),
                             ("st_low", 24), ("st_medium", 25),
                             ("st_moderate", 26)]
    dqn = pt.table_config("train_dqn_default_1", 1024, jax_rows)
    assert dqn.TASK == "EVALUATE_DQN" and jax_rows[dqn.LOG_DIR]["_line"] == 217


@pytest.mark.parametrize("name, per_tick", [
    ("st_fast", 1), ("combined_low_1b", 2),
    ("cross_moderate_network_slow_traffic_1", 2),
    ("ddpg_medium_network_low_traffic_3", 0), ("train_dqn_default_1", 0)])
def test_k1_launches_expected_per_control_tick(name, per_tick):
    cfg = Settings.load_from_file(pt.config_path(name)).replace(
        **pt.OVERRIDES.get(name, {}))
    assert pt.expected_k1_per_tick(cfg) == per_tick
    assert pt.expected_k1_per_tick(cfg.replace(USE_FAST_ST_SOLVER=False)) \
        == 0


def test_resuming_skips_configurations_already_done(tmp_path):
    path = str(tmp_path / "port.csv")
    names = ["st_default", "st_fast", "combined_default_1", "st_low"]
    assert pt.pending(names, 1024, path) == names       # no file yet
    _write_csv(path, [_row("st_default", "2026-10-17T09:00:00", 1024),
                      _row("st_fast", "2026-10-17T09:10:00", 512),
                      _row("combined_default_1", "2026-10-17T09:20:00",
                           2048)])
    assert pt.pending(names, 1024, path) == ["st_fast", "st_low"]
    assert pt.pending(names, 512, path) == ["st_low"]
    assert pt.pending(["train_dqn_default_1"], 1024, path) == [
        "train_dqn_default_1"]


def test_run_and_dqn_chain_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "port.csv")
    with pytest.raises(RuntimeError, match="card"):
        pt.main(["--run", "st_default", "--csv", path])
    with pytest.raises(RuntimeError, match="card"):
        pt.main(["--dqn-chain"])
    assert not os.path.exists(path)
    with pytest.raises(SystemExit):
        pt.main(["--run", "no_such_config", "--csv", path])


def test_compare_writes_every_family_with_both_sems_and_flags(tmp_path):
    """A port row within its JAX row's SEMs, one beyond them, and an ST row
    held to the JAX code on the CPU in place of its stale row."""
    port = str(tmp_path / "port.csv")
    out = str(tmp_path / "ACCEPTANCE.md")
    time = "2026-10-17T09:00:00"
    _write_csv(port, [
        _row("combined_default_1", time, 1024, crashed=0.0, crashed_std=0.0,
             merged=1.0, merged_std=0.0, mean_abs_jerk=0.676,
             mean_abs_jerk_std=0.004, time_to_merge=26.5,
             time_to_merge_std=0.05, clock_time_per_step=0.001,
             **{"percent st solver": 0.026,
                "percent st solver_std": 0.001}),
        _row("combined_fast_1", time, 512, crashed=0.0, crashed_std=0.0,
             merged=1.0, merged_std=0.0, mean_abs_jerk=0.9,
             mean_abs_jerk_std=0.001, time_to_merge=14.72,
             time_to_merge_std=0.05, clock_time_per_step=0.001),
        _row("st_default", time, 1024, 1024, crashed=0.0, crashed_std=0.0,
             merged=1.0, merged_std=0.0, mean_abs_jerk=1.1445,
             mean_abs_jerk_std=0.0035, time_to_merge=31.17,
             time_to_merge_std=0.04, clock_time_per_step=0.002)])
    with open(str(tmp_path / "port.jsonl"), "w") as fh:
        fh.write(json.dumps({
            "LOG_DIR": "st_default", "TIME": time, "card": "GPU, 700.00 W",
            "control_ticks": 178, "s_per_control_tick": 0.5,
            "k1_per_tick": 1.0, "dense_dp_calls": 0,
            "max_memory_allocated_bytes": 3 << 30, "wall_s": 90.0}) + "\n")
    text = pt.compare(port, out)
    assert open(out).read() == text
    for family in pt.FAMILIES:
        assert f"## {family}" in text
    line = {ln.split(" | ")[0][2:]: ln for ln in text.splitlines()
            if ln.startswith("| ") and " | line " in ln or "stale" in ln}
    ok = line["combined_default_1"]
    assert "line 239" in ok and ok.endswith("| - |")
    assert "0.6760 ± 0.0040 / 0.6763 ± 0.0025" in ok
    bad = line["combined_fast_1"]
    assert "line 257" in bad and bad.endswith("| mean abs jerk |")
    st = line["st_default"]
    assert "line 21 stale; JAX on the CPU, 48 episodes" in st
    assert "31.1700 ± 0.0400 / 31.1790 ± 0.1830" in st
    assert "| st_default | GPU, 700.00 W | 0.002 | 178 | 0.5000 | 1.000 | " \
        "0 | 3.000 | 90.0 |" in text
    assert "- combined_fast_1: 512 episodes" in text
    assert "- st_fast" in text and "Flagged metrics: 1." in text


def test_instrumented_counts_ticks_launches_and_dense_calls():
    """Around an evaluation on the CPU: every controller call is a tick, the
    dense DP runs once per tick there, and no kernel launches."""
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch.ops import st_dp
    from rl_mpc_lanemerging_torch.planner import mpc
    cfg = Settings.load_from_file(pt.config_path("st_default")).replace(
        FUTURE_S=3.0, FUTURE_T=1.5, MAX_CARS=16, MAX_SENSED_CARS=12,
        QP_ITERATIONS=5)
    real = tasks.evaluate_controller, st_dp.solve_st_fast
    with pt.instrumented() as counts:
        tasks.evaluate_controller(
            cfg, mpc.make_batched_controller(cfg), num_episodes=2, batch=2,
            device="cpu", max_episode_length=2.0, wait_before_start=1.0,
            verbose=False, mesh=None)
    assert (tasks.evaluate_controller, st_dp.solve_st_fast) == real
    assert counts["control_ticks"] == counts["dense_dp_calls"] == 10
    assert counts["k1_launches"] == 0 and counts["evaluation_s"] > 0


CURVE_MODEL = "runs/curve_ddpg_seed{}_extended"


def test_model_replaces_model_name_and_gives_the_row_its_own_log_dir(
        tmp_path):
    jax_rows = pt.newest_rows(pt.read_rows(pt.JAX_CSV), pt.MIN_JAX_EPISODES)
    plain = pt.table_config("combined_default_1", 1024, jax_rows)
    cfg = pt.table_config("combined_default_1", 1024, jax_rows,
                          CURVE_MODEL.format(2))
    assert cfg.MODEL_NAME == CURVE_MODEL.format(2)
    assert cfg.LOG_DIR == "combined_default_1_curve_ddpg_seed2_extended"
    assert cfg.replace(MODEL_NAME=plain.MODEL_NAME,
                       LOG_DIR=plain.LOG_DIR) == plain
    assert (cfg.BATCH_SCENARIOS, cfg.NUM_EPISODES) == (512, 1024)
    path = str(tmp_path / "port.csv")
    _write_csv(path, [_row("combined_default_1", "2026-10-17T09:00:00",
                           1024)])
    assert pt.pending(["combined_default_1"], 1024, path) == []
    assert pt.pending(["combined_default_1"], 1024, path,
                      CURVE_MODEL.format(2)) == ["combined_default_1"]


def _metrics(crash=0.0, merge=1.0, jerk=0.676, ttm=26.6, st=0.026,
             sem=0.05):
    return dict(crashed=crash, crashed_std=0.001, merged=merge,
                merged_std=0.001, mean_abs_jerk=jerk,
                mean_abs_jerk_std=0.004, time_to_merge=ttm,
                time_to_merge_std=sem, clock_time_per_step=0.001,
                **{"percent st solver": st, "percent st solver_std": 0.001})


def _actor_rows(crashes):
    time = "2026-10-18T0{}:00:00"
    rows = [dict(_row("combined_default_1", time.format(1), 1024,
                      **_metrics()),
                 MODEL_NAME="runs/ddpg_default1_extended")]
    for seed, crash in enumerate(crashes):
        model = CURVE_MODEL.format(seed)
        rows.append(dict(_row(pt.model_log_dir("combined_default_1", model),
                              time.format(seed + 2), 1024,
                              **_metrics(crash=crash, merge=1.0 - crash,
                                         jerk=0.5 + seed / 10)),
                         MODEL_NAME=model))
    return rows


def _bf16_script():
    spec = importlib.util.spec_from_file_location(
        "lean_bf16_actor_torch",
        os.path.join(REPO, "scripts", "lean_bf16_actor_torch.py"))
    bf16 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bf16)
    return bf16


@pytest.mark.parametrize("paired", [False, True])
def test_the_bf16_actor_run_is_run_one_under_its_own_log_dir(
        tmp_path, monkeypatch, paired):
    """``scripts/lean_bf16_actor_torch.py`` evaluates through ``run_one``
    with the bfloat16 forward in place for that call alone, under its own
    ``LOG_DIR``; ``--paired`` runs the float32 actor first and writes the
    episode-by-episode difference of the two runs' columns."""
    from rl_mpc_lanemerging_torch.models import ddpg as models
    bf16 = _bf16_script()
    monkeypatch.setitem(sys.modules, "paper_table_torch", pt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pt, "card_line", lambda: "a card, 700.00 W")
    real, calls = models._forward, []

    def run_one(name, episodes, csv_path, jax_rows, card, model=None,
                log_dir=None, episodes_out=None):
        calls.append((name, episodes, card, model, log_dir, models._forward,
                      episodes_out))
        rows = pt.read_rows(csv_path) if os.path.exists(csv_path) else []
        _write_csv(csv_path, [{k: v for k, v in r.items() if k != "_line"}
                              for r in rows] + [_row(
            log_dir, f"2026-10-18T0{len(calls)}:00:00", episodes,
            **_metrics())])
        if episodes_out:
            shift = float(models._forward is bf16.bf16_forward)
            np.savez(episodes_out, crashed=[0.0, 0.0, 0.0],
                     merged=[1.0, 1.0 - shift, 1.0],
                     mean_abs_jerk=[0.6, 0.7, 0.8 + shift],
                     time_taken=[26.0, 27.0 - shift, 28.0 - 2 * shift])
        return {"LOG_DIR": log_dir}

    monkeypatch.setattr(pt, "run_one", run_one)
    csv_path = str(tmp_path / "bf16" / "run_data_torch.csv")
    record = bf16.run(1024, csv_path, paired)
    base = str(tmp_path / "bf16" / "run_data_torch")
    want = [("combined_default_1", 1024, "a card, 700.00 W", None,
             bf16.LOG_DIR, bf16.bf16_forward,
             base + "_bf16.npz" if paired else None)]
    if paired:
        want.insert(0, ("combined_default_1", 1024, "a card, 700.00 W", None,
                        bf16.F32_LOG_DIR, real, base + "_f32.npz"))
    assert calls == want
    assert record == {"LOG_DIR": bf16.LOG_DIR} and models._forward is real
    assert os.path.exists(base + "_paired.json") == paired
    if paired:
        with open(base + "_paired.json") as fh:
            diff = json.load(fh)["bf16_minus_f32"]
        assert diff["mean_abs_jerk"]["n"] == 3
        assert diff["mean_abs_jerk"]["mean"] == pytest.approx(1 / 3)
        assert diff["merged"]["mean"] == pytest.approx(-1 / 3)
        # the second episode did not merge on the bfloat16 side
        assert diff["time_to_merge"] == pt._mean_sem([0.0, -2.0])


def test_instrumented_keeps_each_episode_of_every_round():
    """The per-episode columns ``run_one`` can keep are the aggregator's,
    every round's episodes in order."""
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch.planner import mpc
    cfg = Settings.load_from_file(pt.config_path("st_default")).replace(
        FUTURE_S=3.0, FUTURE_T=1.5, MAX_CARS=16, MAX_SENSED_CARS=12,
        QP_ITERATIONS=5)
    with pt.instrumented() as counts:
        agg = tasks.evaluate_controller(
            cfg, mpc.make_batched_controller(cfg), num_episodes=3,
            batch=2, device="cpu", max_episode_length=2.0,
            wait_before_start=1.0, verbose=False, mesh=None)
    columns = counts["episode_columns"]
    assert sorted(columns) == sorted(
        k for k in pt.EPISODE_COLUMNS if k in agg.columns)
    for k, v in columns.items():
        assert len(v) == 4 and v == [float(x) for x in agg.columns[k]]


def test_rows_of_another_model_leave_the_table_as_it_was(tmp_path):
    """The 39-row table is the same text, byte for byte, with the
    port-trained actors' rows in the CSV; their section comes after it."""
    port, out = str(tmp_path / "port.csv"), str(tmp_path / "ACC.md")
    rows = _actor_rows([0.0, 0.0, 0.0, 0.0])
    _write_csv(port, rows[:1])
    before = pt.compare(port, out, str(tmp_path / "none.jsonl"))
    _write_csv(port, rows)
    after = pt.compare(port, out, str(tmp_path / "none.jsonl"))
    assert after.startswith(before)
    assert after[len(before):].startswith("\n" + pt.ACTORS_SECTION + "\n")
    assert pt.ACTORS_SECTION not in before


@pytest.mark.parametrize("crashes, word, outside", [
    ([0.0, 0.0, 0.0, 0.0], "holds", 0),
    ([0.0, 0.05, 0.0, 0.0], "holds", 1),
    ([0.0, 0.05, 0.0, 0.05], "fails", 2),
])
def test_the_port_trained_actors_rule(tmp_path, crashes, word, outside):
    """Crash and merge of each seed's row within 3 SEM of the difference
    from the committed actor's row, one seed outside at most; each seed's
    RL-only final evaluation beside it."""
    port, out = str(tmp_path / "port.csv"), str(tmp_path / "ACC.md")
    _write_csv(port, _actor_rows(crashes))
    train = str(tmp_path / "train.jsonl")
    with open(train, "w") as fh:
        for seed in range(4):
            fh.write(json.dumps({
                "trainer": "ddpg", "stage": 2, "seed": seed, "final": dict(
                    episodes=1024, crash=0.0, crash_sem=0.0, merge=1.0,
                    merge_sem=0.0, jerk=0.4 + seed / 100, jerk_sem=0.001,
                    t_merge=27.0, t_merge_sem=0.05)}) + "\n")
    text = pt.compare(port, out, train)
    section = text[text.index(pt.ACTORS_SECTION):]
    assert f"**Verdict: the rule {word}** ({outside} of 4 seeds" in section
    assert section.count("| crash, merge |") == outside
    assert "| 3 | 0.0000 ± 0.0000 | 1.0000 ± 0.0000 | 0.4300 ± 0.0010 | " \
        "27.0000 ± 0.0500 |" in section
    assert "| - | committed (line 2) | 1024 |" in section
    assert "JAX, run_data.csv line 239" in section


def test_pooled_rounds_equal_the_whole_run():
    """Parts of uneven size, pooled from their counts, means and SEMs
    alone, give the mean and SEM of all their values."""
    gen = np.random.default_rng(5)
    values = gen.normal(26.5, 1.9, 1000)
    cuts = [0, 3, 250, 251, 700, 1000]
    parts = [pt._mean_sem(values[a:b]) for a, b in zip(cuts, cuts[1:])]
    whole = pt.pooled(parts + [pt._mean_sem([])])
    want = pt._mean_sem(values)
    assert whole["n"] == 1000
    assert whole["mean"] == pytest.approx(want["mean"], rel=1e-13)
    assert whole["sem"] == pytest.approx(want["sem"], rel=1e-12)


def test_round_statistics_of_an_evaluation_pool_to_its_row():
    """``instrumented`` records each round's statistics from the
    aggregator that ``evaluate_controller`` builds; weighted by their
    counts, they are the whole run's row."""
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch.planner import mpc
    cfg = Settings.load_from_file(pt.config_path("st_default")).replace(
        FUTURE_S=3.0, FUTURE_T=1.5, MAX_CARS=16, MAX_SENSED_CARS=12,
        QP_ITERATIONS=5)
    with pt.instrumented() as counts:
        agg = tasks.evaluate_controller(
            cfg, mpc.make_batched_controller(cfg), num_episodes=5,
            batch=2, device="cpu", max_episode_length=3.0,
            wait_before_start=1.0, verbose=False, mesh=None)
    rounds = counts["rounds"]
    assert [r["episodes"] for r in rounds] == [2, 2, 2]
    avg, sem = agg.get_stat_averages(report_stds=True)
    for metric in ("crashed", "merged", "mean_abs_jerk"):
        whole = pt.pooled([r[metric] for r in rounds])
        assert whole["n"] == 6
        assert whole["mean"] == pytest.approx(avg[metric], abs=1e-12)
        assert whole["sem"] == pytest.approx(sem[metric], abs=1e-12)


JAX_T, JAX_SEM = 26.4830, 0.0288


@pytest.mark.parametrize("short, whole, early, late, depth", [
    (26.6629, 26.50, 26.6629, 26.45, True),    # closes to under a third
    (26.6629, 26.45, 26.6629, 26.40, True),    # changes sign
    (26.6629, 26.62, 26.6629, 26.60, False),   # beyond 3 SEM
    (26.6629, 26.55, 26.6629, 26.51, False),   # within, not under a third
    (26.6629, 26.45, 26.40, 26.46, False),     # the later rounds do not
    (26.40, 26.47, 26.40, 26.50, True),        # a gap below JAX closes
])
def test_the_lean_rule(short, whole, early, late, depth):
    s = dict(mean=JAX_T, sem=JAX_SEM)
    v = pt.lean_verdict(s, dict(mean=short, sem=0.0601),
                        dict(mean=whole, sem=0.030),
                        dict(mean=early, sem=0.0601),
                        dict(mean=late, sem=0.034))
    assert v["depth"] is depth


class _Agg:
    def __init__(self, columns):
        self.columns, self.custom = columns, {}


@pytest.mark.parametrize("late_shift, word", [(-0.25, "depth"),
                                              (0.0, "persists")])
def test_the_lean_section_decides_synthetic_runs(tmp_path, late_shift,
                                                 word):
    """Per-episode values in 8 rounds of 64: the 1024-episode row is rounds
    1-2, the 4000-episode run all eight; rounds 3-8 merge ``late_shift``
    sooner."""
    gen = np.random.default_rng(12)
    rows, records = [], []
    for name, jax_line in zip(pt.LEAN_CONFIGS, (239, 300)):
        jax = pt.newest_rows(pt.read_rows(pt.JAX_CSV))[name]
        base = float(jax["time_to_merge"]) + 0.18
        ttm = [gen.normal(base + (late_shift if r >= 2 else 0.0), 0.3, 64)
               for r in range(8)]
        cols = {"crashed": [], "merged": [], "mean_abs_jerk": [],
                "time_to_merge": []}
        ends = []
        for t in ttm:
            cols["crashed"] += [0.0] * 64
            cols["merged"] += [1.0] * 64
            cols["mean_abs_jerk"] += list(gen.normal(0.67, 0.05, 64))
            cols["time_to_merge"] += list(t)
            ends.append({k: len(v) for k, v in cols.items()})
        rounds = pt.round_stats(_Agg(cols), ends)

        def row(rs, time, episodes):
            out = _row(name, time, episodes, clock_time_per_step=0.001)
            for m in ("crashed", "merged", "mean_abs_jerk",
                      "time_to_merge"):
                p = pt.pooled([r[m] for r in rs])
                out[m], out[m + "_std"] = p["mean"], p["sem"]
            return out
        rows += [row(rounds[:2], "2026-10-17T08:00:00", 1024),
                 row(rounds, "2026-10-18T08:00:00", 4000)]
        records.append({"LOG_DIR": name, "TIME": "2026-10-18T08:00:00",
                        "card": "GPU, 700.00 W", "batch": 512,
                        "wall_s": 900.0, "s_per_control_tick": 0.4,
                        "control_ticks": 1800, "k1_per_tick": 2.0,
                        "rounds": rounds, "dense_dp_calls": 0,
                        "max_memory_allocated_bytes": 1 << 30})
    port, out = str(tmp_path / "port.csv"), str(tmp_path / "ACC.md")
    _write_csv(port, rows)
    with open(str(tmp_path / "port.jsonl"), "w") as fh:
        fh.writelines(json.dumps(r) + "\n" for r in records)
    text = pt.compare(port, out, str(tmp_path / "none.jsonl"))
    section = text[text.index(pt.LEAN_SECTION):]
    assert f'**Verdict: "{word}".**' in section
    assert section.count("(they reproduce it).") == 2
    assert "| 3-8 | 384 |" in section and "| 1-2 | 128 |" in section
    assert "JAX, run_data.csv line 239" in section \
        and "JAX, run_data.csv line 300" in section
