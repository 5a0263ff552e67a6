"""The port's table runner, ``scripts/paper_table_torch.py``, on the CPU with
synthetic CSVs: the row matcher (the newest >= 1000-episode row of each
LOG_DIR, stale rows by their TIME), the 3-SEM flag, resuming, the
acceptance table, the counts its runs are held to, and that ``--run``
needs the card."""

import csv
import importlib.util
import json
import os

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
