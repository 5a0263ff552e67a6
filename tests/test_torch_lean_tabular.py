"""The combined lean's decision (``scripts/lean_bf16_actor_torch.py
--decide``) and the tabular Q's comparison (``scripts/train_tabular_torch.py
--compare``), on the committed runs and on hand-made ones; no card."""

import csv
import importlib.util
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bf16 = _load("lean_bf16_actor_torch")
tab = _load("train_tabular_torch")
PAIRED = os.path.join(REPO, "scripts", "lean_bf16_actor", "paired4000")


def test_the_lean_rule_on_the_committed_4000_episode_run(tmp_path):
    """The committed paired run at 4000 episodes: its float32 row equals
    the port's row 41 on every statistic, and JAX row 239 lies between the
    two rows on every leg; the section goes after the file's others."""
    acc = tmp_path / "ACCEPTANCE_TORCH.md"
    acc.write_text("# Acceptance\n\n## ddpg\n\nkept\n")
    assert bf16.decide(PAIRED, str(acc)) == "closed: TPU numerics"
    text = acc.read_text()
    assert text.startswith("# Acceptance\n\n## ddpg\n\nkept\n\n"
                           + bf16.SECTION)
    assert "The float32 row equals line 41 on all 150 statistics: yes." \
        in text
    assert "| time to merge (s) | 26.5672 ± 0.0285 | 26.4700 ± 0.0286 | " \
        "26.4830 ± 0.0288 | -0.09717 ± 0.03007 | yes | yes | yes |" in text


def _rewrite(folder, log_dir, **values):
    path = os.path.join(folder, "run_data_torch.csv")
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    for row in rows:
        if row["LOG_DIR"] == log_dir:
            row.update(values)
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


@pytest.mark.parametrize("change", ["float32 row", "bfloat16 leg"])
def test_the_lean_rule_refuses(tmp_path, change):
    """A float32 row that is not the port's row decides nothing; a
    bfloat16 row that stops short of the JAX row on one leg and sits more
    than 3 SEM from it does not close the lean."""
    folder = str(tmp_path / "paired")
    shutil.copytree(PAIRED, folder)
    if change == "float32 row":
        _rewrite(folder, bf16.F32_LOG_DIR, crashed="0.001")
    else:
        _rewrite(folder, bf16.LOG_DIR, mean_abs_jerk="0.6650")
    acc = tmp_path / "acc.md"
    assert bf16.decide(folder, str(acc)).startswith("not closed")
    assert bf16.leg_holds(0.6647, 0.6650, 0.0024, 0.6763, 0.0025) == \
        (False, False)
    assert bf16.leg_holds(0.6647, 0.6898, 0.0024, 0.6763, 0.0025) == \
        (True, False)


def test_the_tabular_run_against_the_jax_run(tmp_path):
    """The committed card run's log and its row: every held point within
    3% and the greedy evaluation's crash and merge as line 175's; a run
    whose table stays a tenth smaller differs."""
    log = os.path.join(REPO, "scripts", "tabular_torch",
                       "train_tabular_torch.log")
    points = tab.logged_points(log)
    assert points[10_240] == 1916 and points[30_208] == 2022
    assert tab.jax_points()[10_240] == 1901
    acc = tmp_path / "acc.md"
    assert tab.compare(log, os.path.join(REPO, "run_data_torch.csv"),
                       str(acc)) == "agrees"
    text = acc.read_text()
    assert text.startswith(tab.SECTION) and text.count("| yes |") == 10
    small = tmp_path / "small.log"
    small.write_text("".join(
        f"round {i} episodes={e} visited_sa={int(v * 0.9)}/81000 (1s)\n"
        for i, (e, v) in enumerate(sorted(points.items()))))
    assert tab.compare(str(small), os.path.join(REPO, "run_data_torch.csv"),
                       str(acc)) == "differs"
    assert acc.read_text().count(tab.SECTION) == 1


def test_the_custom_dqn_at_bfloat16_rounds_both_matmuls():
    """``bf16_network("dqn_custom_default1")``: inside, the Q network's two
    matmuls take bfloat16-rounded operands (the products summed and the
    bias added in float32), as a TPU runs JAX's default precision; its
    greedy actions can change; outside, the float32 network is back."""
    import torch
    from rl_mpc_lanemerging_torch.models.mlp import DQNNet
    net = DQNNet(20, 5, generator=torch.Generator().manual_seed(4))
    x = torch.randn(4096, 20, generator=torch.Generator().manual_seed(5))
    exact = net(x)
    w0, w1 = (layer.weight.bfloat16().float() for layer in
              net.layers.values())
    b0, b1 = (layer.bias for layer in net.layers.values())
    hidden = torch.relu(x.bfloat16().float() @ w0.T + b0)
    want = hidden.bfloat16().float() @ w1.T + b1
    with bf16.bf16_network(bf16.DQN_NAME):
        got = net(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert not torch.equal(got, exact) and torch.equal(net(x), exact)
    assert (got.argmax(-1) != exact.argmax(-1)).any()


def test_the_custom_dqn_flags_are_filed_against_the_tpu_precision(
        tmp_path):
    """The committed paired run of the custom DQN: its float32 row equals
    the port's row 48 on every statistic with a value (the column a wider
    CSV pads with empty values aside), and line 218 lies within 3 SEM of
    the bfloat16 row on crash, merge, time to merge and |jerk|."""
    folder = os.path.join(REPO, "scripts", "lean_bf16_actor", "dqn_custom")
    acc = tmp_path / "acc.md"
    assert bf16.decide(folder, str(acc), bf16.DQN_NAME) == \
        "filed: TPU numerics"
    text = acc.read_text()
    assert text.startswith(bf16.DQN_SECTION)
    assert "The float32 row equals line 48 on all 148 statistics: yes." \
        in text
    assert "| mean abs jerk | 0.3309 ± 0.0012 | 0.3597 ± 0.0012 | 0.3602 ± " \
        "0.0012 | +0.02875 ± 0.00156 | no | yes | yes |" in text
    assert bf16._statistics({"a": "1", "b": "", "TIME": "t"}) == {"a": "1"}
